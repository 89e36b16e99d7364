"""RANSAC pose (`models/motion_tracker.py::estimate_pose`) and its two
kernels' plain twins (`ops/pose.py`: K8 `ransac_counts_plain`, K9
`pose_gn_normal_equations_plain`) on the CPU, each input made from a numpy
seed (`tests/pose_cases.py`):

  - the singular case: 2 valid quads of 64, integer-valued; the refinement
    solve is exactly singular, JAX drops the step and returns a finite
    pose, and so does the port (`success` and `inlier_count` equal to
    JAX's, R and t within 1e-4);
  - K8's twin against a float64 numpy projection and against JAX's
    scoring expression: counts equal after leaving out the pairs that lie
    within 1e-4 px of the threshold or within 1e-9 of the depth gate;
    gate, index and chunking;
  - K9's twin's H, b and sum(w) against float64 numpy sums (within 1e-5
    of the sums of the terms' magnitudes; sum(w) exactly), over quad counts
    around its block size, and its layout sum;
  - `estimate_pose` on the twins with JAX's draws injected against JAX's
    `estimate_pose`: R and t within 1e-4, inliers within 2;
  - CPU tensors never build or launch a kernel.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from edge_based_visual_odometry_tpu.config import VOConfig as JVOConfig
from edge_based_visual_odometry_tpu.io import synthetic as JS
from edge_based_visual_odometry_tpu.models import motion_tracker as JMT
from edge_based_visual_odometry_tpu.models.types import RigArrays as JRig
from edge_based_visual_odometry_tpu_torch.io import synthetic as S
from edge_based_visual_odometry_tpu_torch.models import motion_tracker as MT
from edge_based_visual_odometry_tpu_torch.models import types as TY
from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.ops import pose as POSE
from tests import pose_cases as PC

SMALL = dict(max_edges=1024, max_candidates=8, gather_slots=64,
             max_mates=512, max_refine_pairs=1024, max_quad_candidates=8,
             quad_gather_slots=144, ransac_max_iterations=256, gn_max_iter=4)
THR = PC.THRESH


@pytest.fixture(scope="module")
def rigs():
    return (TY.rig_arrays_from_rig(S.default_rig(120, 160), "cpu"),
            JRig.from_rig(JS.default_rig(120, 160)))


def _pq(d):
    return MT.PoseQuads(**{k: torch.as_tensor(np.array(v))
                           for k, v in d.items()})


def _jpq(d):
    return JMT.PoseQuads(**{k: jnp.asarray(v) for k, v in d.items()})


def _both(d, rigs, fields, seed):
    """The port's estimate_pose on JAX's draws, and JAX's."""
    jcfg = JVOConfig(**fields)
    cfg = TY.config_from_fields(dataclasses.asdict(jcfg))
    jpq = _jpq(d)
    idx1, idx2, _ = JMT._sample_quad_pairs(jpq, jcfg, seed,
                                           jcfg.ransac_max_iterations)
    ref = JMT.estimate_pose(jpq, rigs[1], jcfg, seed)
    res = MT.estimate_pose(_pq(d), rigs[0], cfg,
                           idx=(np.asarray(idx1), np.asarray(idx2)))
    return res, jax.tree_util.tree_map(np.asarray, ref)


@pytest.mark.parametrize("seed", PC.SINGULAR_SEEDS)
def test_singular_refinement_returns_jax_pose(rigs, seed):
    """The 6 x 6 solve of a refinement step is exactly singular here; the
    port used to raise (torch.linalg.solve) where JAX returns a pose."""
    res, ref = _both(PC.singular_quads(seed), rigs, PC.SINGULAR_CFG,
                     42)
    assert bool(ref.success) and np.isfinite(ref.R).all()
    assert bool(res.success) == bool(ref.success)
    assert int(res.inlier_count) == int(ref.inlier_count) == 2
    assert torch.isfinite(res.R).all() and torch.isfinite(res.t).all()
    np.testing.assert_allclose(res.R.numpy(), ref.R, atol=1e-4)
    np.testing.assert_allclose(res.t.numpy(), ref.t, atol=1e-4)


def test_singular_step_is_dropped(rigs):
    """From either pair pose of the singular case, the step's solve is not
    finite and only 2 quads weigh in, so the pose stays as it was."""
    pq = _pq(PC.singular_quads(PC.SINGULAR_SEEDS[0]))
    cfg = TY.config_from_fields(PC.SINGULAR_CFG)
    draws = np.arange(64) % 2
    _, R, t, _, _ = MT._hypotheses(pq, rigs[0], cfg, 0, (draws, 1 - draws))
    for h in (0, 1):
        s = POSE.pose_gn_normal_equations(R[h], t[h], pq.gamma, pq.cf_left,
                                          pq.valid, rigs[0].K_left, THR)
        assert float(s[27]) == 2.0
        Hm = POSE.normal_matrix(s) + 1e-6 * torch.eye(6)
        dp, info = torch.linalg.solve_ex(Hm, s[21:27])
        assert int(info) > 0 and not torch.isfinite(dp).all()
        Rr, tr = MT._refine_step(R[h], t[h], pq, rigs[0].K_left, THR)
        assert torch.equal(Rr, R[h]) and torch.equal(tr, t[h])


# ---------------------------------------------------------------- K8 ----

def _pairs64(KG, Kt, gamma, cf, valid, thr=THR):
    """float64 decisions (K, Q) and the pairs too close to call."""
    uvw = (np.einsum("kij,qj->kqi", KG.astype(np.float64),
                     gamma.astype(np.float64)) + Kt[:, None, :])
    err = np.linalg.norm(uvw[..., :2] / uvw[..., 2:3] - cf[None], axis=-1)
    w = uvw[..., 2]
    close = (np.abs(err - thr) < 1e-4) | (np.abs(w - 1e-6) < 1e-9)
    return (err < thr) & valid[None] & (w > 1e-6), close


@jax.jit
def _jax_score(KG, Kt, gamma, cf_left, valid):
    """The body of JAX's `make_score` (`estimate_pose`'s nested
    `score_chunk`, which cannot be imported), per pair."""
    uvw = jnp.einsum("kij,qj->kqi", KG, gamma) + Kt[:, None, :]
    uv = uvw[..., :2] / uvw[..., 2:3]
    err = jnp.linalg.norm(uv - cf_left[None], axis=-1)
    return (err < THR) & valid[None] & (uvw[..., 2] > 1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k8_twin_against_float64_and_jax(seed):
    d = PC.scene_quads(seed, 400, 330)
    KG, Kt, gate = PC.hypotheses(seed, 48)
    g, cf, v = d["gamma"], d["cf_left"], d["valid"]
    dec, close = _pairs64(KG, Kt, g, cf, v)
    jdec = np.asarray(_jax_score(KG, Kt, g, cf, v))
    n_close = int(close.sum())
    assert n_close < 0.01 * close.size
    t = {k: torch.from_numpy(a) for k, a in
         (("KG", KG), ("Kt", Kt), ("g", g), ("cf", cf))}
    got = []
    for h in range(KG.shape[0]):
        keep = torch.from_numpy(v & ~close[h])
        got.append(int(POSE.ransac_counts_plain(
            t["KG"][h:h + 1], t["Kt"][h:h + 1], t["g"], t["cf"], keep,
            THR)[0]))
    want = (dec & ~close).sum(1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (jdec & ~close).sum(1))
    # both sides of the threshold and of the depth gate are exercised
    assert want.max() > 100 and want.min() == 0
    assert (np.einsum("kj,qj->kq", KG[:, 2], g) + Kt[:, 2:3] < 0).any()

    # the gate writes -1, the counts elsewhere are the ungated ones
    full = POSE.ransac_counts_plain(t["KG"], t["Kt"], t["g"], t["cf"],
                                    torch.from_numpy(v), THR)
    gated = POSE.ransac_counts_plain(t["KG"], t["Kt"], t["g"], t["cf"],
                                     torch.from_numpy(v), THR,
                                     gate=torch.from_numpy(gate))
    assert full.dtype == gated.dtype == torch.int32
    np.testing.assert_array_equal(gated.numpy(),
                                  np.where(gate, full.numpy(), -1))


def test_k8_twin_index_gate_and_chunks(monkeypatch):
    d = PC.scene_quads(5, 700, 650)
    KG, Kt, gate = (torch.from_numpy(a) for a in PC.hypotheses(5, 90))
    args = (torch.from_numpy(d["gamma"]), torch.from_numpy(d["cf_left"]),
            torch.from_numpy(d["valid"]), THR)
    full = POSE.ransac_counts_plain(KG, Kt, *args, gate=gate)
    idx = torch.from_numpy(np.random.default_rng(5).permutation(90)[:37])
    sub = POSE.ransac_counts_plain(KG, Kt, *args, gate=gate, index=idx)
    assert torch.equal(sub, full[idx])
    monkeypatch.setattr(POSE, "CHUNK_PAIRS", 1000)     # one row a chunk
    assert torch.equal(POSE.ransac_counts_plain(KG, Kt, *args, gate=gate),
                       full)
    empty = POSE.ransac_counts_plain(KG[:0], Kt[:0], *args)
    assert empty.shape == (0,) and empty.dtype == torch.int32


# ---------------------------------------------------------------- K9 ----

def _gn64(R, t, gamma, cf, valid, K, thr=THR):
    """JAX's gn_step in float64 numpy: H, b and sum(w), the scales of
    their float32 rounding (the sums of the terms' magnitudes; for b with
    the projection's in place of the residual's, since r = uv - cf rounds
    at the size of uv), and the quads whose error lies within 1e-3 px of
    the threshold."""
    g = gamma.astype(np.float64)
    X = g @ R.astype(np.float64).T + t
    z = np.maximum(X[:, 2], 1e-6)
    fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                      float(K[1, 2]))
    uv = np.stack([fx * X[:, 0] / z + cx, fy * X[:, 1] / z + cy], -1)
    r = uv - cf
    e = np.linalg.norm(r, axis=-1)
    w = ((e < thr) & valid).astype(np.float64)
    iz = 1.0 / z
    zz = np.zeros_like(z)
    Jp = np.stack([np.stack([fx * iz, zz, -fx * X[:, 0] * iz * iz], -1),
                   np.stack([zz, fy * iz, -fy * X[:, 1] * iz * iz], -1)], 1)
    Sx = np.zeros((len(z), 3, 3))
    Sx[:, 0, 1], Sx[:, 0, 2], Sx[:, 1, 2] = -X[:, 2], X[:, 1], -X[:, 0]
    Sx = Sx - Sx.transpose(0, 2, 1)
    J = np.concatenate([-Jp @ Sx, Jp], -1)
    H = np.einsum("q,qia,qib->ab", w, J, J)
    b = -np.einsum("q,qia,qi->a", w, J, r)
    mag = (np.einsum("q,qia,qib->ab", w, np.abs(J), np.abs(J)),
           np.einsum("q,qia,qi->a", w, np.abs(J), np.abs(uv)))
    return H, b, w.sum(), mag, np.abs(e - thr) < 1e-3


@pytest.mark.parametrize("Q", [0, 1, 511, 512, 513, 3000])
def test_k9_twin_against_float64(Q):
    d = PC.scene_quads(Q, Q, (4 * Q) // 5)
    R, t = PC.gn_pose(Q)
    K = PC.K_LEFT
    *_, close = _gn64(R, t, d["gamma"], d["cf_left"], d["valid"], K)
    valid = d["valid"] & ~close
    H, b, sw, (H_mag, b_mag), _ = _gn64(R, t, d["gamma"], d["cf_left"],
                                        valid, K)
    s = POSE.pose_gn_normal_equations_plain(
        torch.from_numpy(R), torch.from_numpy(t),
        torch.from_numpy(d["gamma"]), torch.from_numpy(d["cf_left"]),
        torch.from_numpy(valid), torch.from_numpy(K), THR)
    assert s.shape == (28,) and s.dtype == torch.float32
    Hs = POSE.normal_matrix(s)[:, :].numpy()
    np.testing.assert_array_equal(Hs, Hs.T)
    # float32 rounding is within ~n ulp of the scales
    assert (np.abs(Hs - H) <= 1e-5 * H_mag).all()
    assert (np.abs(s[21:27].numpy() - b) <= 1e-5 * b_mag).all()
    assert float(s[27]) == sw
    if Q >= 511:
        assert 0 < sw < valid.sum()         # outliers weigh nothing


def test_k9_layout_sum_order():
    """Thread slots in order, the butterfly, the warps, the blocks; -0.0
    pads add nothing."""
    rng = np.random.default_rng(0)
    Q = 2 * POSE.K9_THREADS * POSE.K9_PER_THREAD + 77
    T = torch.from_numpy(rng.normal(size=(Q, 3)).astype(np.float32))
    B = POSE._k9_blocks(Q)
    pad = np.zeros((B * POSE.K9_THREADS * POSE.K9_PER_THREAD, 3), np.float32)
    pad[Q:] = -0.0
    pad[:Q] = T.numpy()
    want = None
    for b in range(B):
        run = pad[b * 512:(b + 1) * 512].reshape(POSE.K9_PER_THREAD,
                                                 POSE.K9_THREADS, 3)
        acc = run[0].copy()
        for k in range(1, POSE.K9_PER_THREAD):
            acc = acc + run[k]
        lanes = acc.reshape(POSE.K9_THREADS // 32, 32, 3)
        for h in (16, 8, 4, 2, 1):
            lanes = lanes[:, :h] + lanes[:, h:2 * h]
        blk = lanes[0, 0]
        for wp in range(1, POSE.K9_THREADS // 32):
            blk = blk + lanes[wp, 0]
        want = blk if want is None else want + blk
    got = POSE._k9_layout_sum(T)
    assert got.numpy().tobytes() == want.astype(np.float32).tobytes()
    # sums of only zeros keep the sign the kernel's -0.0 start gives them
    z = POSE._k9_layout_sum(torch.tensor([[-0.0, 0.0]]))
    assert [str(float(x)) for x in z] == ["-0.0", "0.0"]


def test_normal_matrix_is_the_symmetric_triangle():
    s = torch.arange(28, dtype=torch.float32)
    H = POSE.normal_matrix(s)
    for k, (a, b) in enumerate(POSE.H_TRIANGLE):
        assert H[a, b] == H[b, a] == k


# ------------------------------------------------------- estimate_pose ----

@pytest.mark.parametrize("seed,prescore", [(0, 0), (1, 0), (2, 512),
                                           (3, 512)])
def test_estimate_pose_on_twins_against_jax(rigs, seed, prescore):
    """JAX's draws injected; with `prescore` the first 512 quads rank the
    hypotheses and the best 64 are counted on all 2,048."""
    fields = dict(SMALL)
    if prescore:
        fields.update(ransac_prescore_quads=prescore,
                      ransac_prescore_keep=64)
    res, ref = _both(PC.scene_quads(seed, 2048, 1700), rigs, fields, 7)
    assert bool(res.success) and bool(ref.success)
    assert int(ref.inlier_count) > 800
    np.testing.assert_allclose(res.R.numpy(), ref.R, atol=1e-4)
    np.testing.assert_allclose(res.t.numpy(), ref.t, atol=1e-4)
    assert abs(int(res.inlier_count) - int(ref.inlier_count)) <= 2


def test_cpu_tensors_never_build_or_launch(monkeypatch, rigs):
    def no_build():
        raise AssertionError("CPU tensors must not build or launch a kernel")

    monkeypatch.setattr(CB, "lib", no_build)
    before = dict(CB.LAUNCHES)
    d = PC.scene_quads(0, 256, 200)
    cfg = TY.config_from_fields(dict(SMALL, ransac_prescore_quads=64,
                                     ransac_prescore_keep=16))
    res = MT.estimate_pose(_pq(d), rigs[0], cfg, seed=3)
    assert bool(res.success)
    assert CB.LAUNCHES == before
    pq = _pq(d)
    KG, Kt, _ = (torch.from_numpy(a) for a in PC.hypotheses(0, 8))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        POSE.ransac_counts_cuda(KG, Kt, pq.gamma, pq.cf_left, pq.valid, THR)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        POSE.pose_gn_normal_equations_cuda(torch.eye(3), torch.zeros(3),
                                           pq.gamma, pq.cf_left, pq.valid,
                                           rigs[0].K_left, THR)
