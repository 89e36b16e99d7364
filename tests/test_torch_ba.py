"""Windowed bundle adjustment, port vs the JAX reference on the CPU:

  - `run_ba` on one seeded problem (built inside the test from
    np.random.default_rng), with and without the edge normals `obs_n` and
    the landmark prior: poses within 1e-4, `cost_history` rtol 1e-3 (the
    cases without the prior at damping 1.0, see the test);
  - `WindowBA.run` on the same three keyframes: same landmark and
    observation census, poses within 1e-4; on a mesh of one rank, the
    single solve's poses within 1e-5;
  - `VOPipeline(ba_window=3)` over 3 frames, `every_frame` and `adaptive`:
    trajectories within 0.1 deg / 5 mm of the reference's (the RANSAC draws
    differ), and the write-back under sparse keyframes;
  - the 24-keyframe corridor chain of tests/test_window_ba_drift.py
    (tests/torch_ranks.py): the port's BA at least 30% below the raw
    chain's ATE.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from edge_based_visual_odometry_tpu import geometry as JGEO
from edge_based_visual_odometry_tpu.config import VOConfig as JVOConfig
from edge_based_visual_odometry_tpu.io import synthetic as JS
from edge_based_visual_odometry_tpu.models import ba as JBA
from edge_based_visual_odometry_tpu.models import pipeline as JPL
from edge_based_visual_odometry_tpu.models import window_ba as JWBA
from edge_based_visual_odometry_tpu_torch import geometry as GEO
from edge_based_visual_odometry_tpu_torch.config import VOConfig
from edge_based_visual_odometry_tpu_torch.models import ba as BA
from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
from edge_based_visual_odometry_tpu_torch.models import window_ba as WBA

pytestmark = pytest.mark.heavy
torch.set_num_threads(2)

K_CAM = np.array([[300.0, 0.0, 160.0], [0.0, 300.0, 120.0], [0.0, 0.0, 1.0]],
                 np.float32)
SMALL = dict(max_edges=1024, max_candidates=8, gather_slots=64,
             max_mates=512, max_refine_pairs=1024, max_quad_candidates=8,
             quad_gather_slots=144, ransac_max_iterations=256, gn_max_iter=4)


def _rot(w):
    return np.asarray(JGEO.so3_exp(jnp.asarray(w, jnp.float32)), np.float64)


def _scene(seed, n_kf=4, n_lm=80):
    """GT poses stepping forward, landmarks ahead, noisy pixel
    observations (slot == landmark id) and noisy initial poses / points."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n_lm), rng.uniform(-2, 2, n_lm),
                  rng.uniform(4, 12, n_lm)], 1)
    Rs, ts, uvs = [], [], []
    for k in range(n_kf):
        R = _rot([0.0, 0.02 * k, 0.01 * k])
        t = -R @ np.array([0.1 * k, 0.0, 0.3 * k])
        Xc = X @ R.T + t
        uv = (Xc @ K_CAM.T.astype(np.float64))
        uvs.append(uv[:, :2] / uv[:, 2:3] + rng.normal(0, 0.3, (n_lm, 2)))
        Rs.append(R)
        ts.append(t)
    return rng, X, np.stack(Rs), np.stack(ts), np.stack(uvs)


def _problem(seed, with_normals, with_prior, n_pad=16):
    rng, X, Rs, ts, uvs = _scene(seed)
    n_kf, n_lm = uvs.shape[:2]
    R0 = np.stack([_rot(rng.normal(0, 0.004, 3)) @ R if k else R
                   for k, R in enumerate(Rs)])
    t0 = ts + np.where(np.arange(n_kf)[:, None] > 0,
                       rng.normal(0, 0.02, ts.shape), 0.0)
    X0 = X + rng.normal(0, 0.05, X.shape)
    kf, lm = np.divmod(np.arange(n_kf * n_lm), n_lm)
    w = np.ones(kf.size + n_pad, np.float32)
    w[-n_pad:] = 0.0                                  # inactive padding
    pad = np.zeros(n_pad, np.int32)
    th = rng.uniform(0, np.pi, kf.size + n_pad)
    f = dict(
        R=R0.astype(np.float32), t=t0.astype(np.float32),
        X=X0.astype(np.float32),
        obs_kf=np.concatenate([kf, pad]).astype(np.int32),
        obs_lm=np.concatenate([lm, pad]).astype(np.int32),
        obs_uv=np.concatenate([uvs.reshape(-1, 2),
                               np.zeros((n_pad, 2))]).astype(np.float32),
        obs_w=w, K_cam=K_CAM)
    if with_prior:
        f.update(X_prior=X0.astype(np.float32), prior_w=np.float32(25.0))
    if with_normals:
        f.update(obs_n=np.stack([-np.sin(th), np.cos(th)], -1).astype(
            np.float32))
    return f, (Rs, ts)


def _to(f, conv):
    return {k: conv(v) for k, v in f.items()}


def _t(v):
    v = np.asarray(v)
    return torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                            else v.copy())


@pytest.mark.parametrize("with_normals,with_prior", [
    (False, False), (True, False), (False, True), (True, True)])
def test_run_ba_matches_jax(with_normals, with_prior):
    f, (Rs, ts) = _problem(11, with_normals, with_prior)
    # without the landmark prior the Schur system is close to singular (the
    # reference's own note), and two float32 solvers then part ways by
    # more than 1e-4; a damping of 1.0 conditions it for both
    kw = dict(n_iters=6, damping=1e-3 if with_prior else 1.0, huber=2.0)
    res = BA.run_ba(BA.BAProblem(**_to(f, _t)), **kw)
    ref = JBA.run_ba(JBA.BAProblem(**_to(f, jnp.asarray)), **kw)
    assert res.cost_history.shape == (7,)
    cost, jcost = res.cost_history.numpy(), np.asarray(ref.cost_history)
    assert np.isfinite(cost).all()
    np.testing.assert_allclose(cost, jcost, rtol=1e-3)
    np.testing.assert_allclose(res.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(ref.t), atol=1e-4)
    np.testing.assert_allclose(res.X.numpy(), np.asarray(ref.X), atol=2e-3)
    assert cost[-1] < 0.5 * cost[0]                  # it converged
    # pose 0 is gauge-fixed
    np.testing.assert_allclose(res.R[0].numpy(), f["R"][0], atol=1e-5)
    np.testing.assert_allclose(res.t[0].numpy(), f["t"][0], atol=1e-5)
    if with_prior and not with_normals:
        # full 2D residuals + the prior: the poses move towards the truth
        e0 = np.abs(f["t"] - ts).max()
        assert np.abs(res.t.numpy() - ts).max() < e0


@pytest.mark.parametrize("unobserved", ["landmark", "keyframe"])
def test_singular_ba_iteration_matches_jax(unobserved):
    """Damping 0 with a landmark (the H_ll inverse) or a keyframe (the
    Schur solve) that no observation constrains: JAX's inv and solve give
    non-finite values, and so does the port, where it used to raise."""
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-2, 2, 6), rng.uniform(-2, 2, 6),
                  rng.uniform(4, 8, 6)], 1).astype(np.float32)
    t = np.array([[0, 0, 0], [-0.2, 0, 0]], np.float32)
    kf, lm = np.divmod(np.arange(2 * 5), 5)          # landmark 5 unobserved
    if unobserved == "keyframe":                      # keyframe 1 too
        kf, lm = kf[kf == 0], lm[kf == 0]
    uv = (X[lm] + t[kf]) @ K_CAM.T
    f = dict(R=np.stack([np.eye(3, dtype=np.float32)] * 2), t=t, X=X,
             obs_kf=kf, obs_lm=lm,
             obs_uv=(uv[:, :2] / uv[:, 2:3]).astype(np.float32),
             obs_w=np.ones(kf.size, np.float32), K_cam=K_CAM)
    if unobserved == "keyframe":
        f.update(X_prior=X, prior_w=np.float32(1.0))
    p, cost = BA.ba_iteration(BA.BAProblem(**_to(f, _t)), 0.0, 2.0)
    jp, jcost = JBA.ba_iteration(JBA.BAProblem(**_to(f, jnp.asarray)),
                                 0.0, 2.0)
    assert not np.isfinite(np.asarray(jp.t)).all()
    for a, b in ((p.R, jp.R), (p.t, jp.t), (p.X, jp.X)):
        np.testing.assert_array_equal(np.isfinite(a.numpy()),
                                      np.isfinite(np.asarray(b)))
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-4)


def test_ba_iteration_matches_jax():
    f, _ = _problem(5, True, True)
    p, cost = BA.ba_iteration(BA.BAProblem(**_to(f, _t)), 1e-3, 2.0)
    jp, jcost = JBA.ba_iteration(JBA.BAProblem(**_to(f, jnp.asarray)),
                                 1e-3, 2.0)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-4)
    np.testing.assert_allclose(p.R.numpy(), np.asarray(jp.R), atol=2e-5)
    np.testing.assert_allclose(p.t.numpy(), np.asarray(jp.t), atol=2e-5)
    r, Jp, Jl = BA._residuals_and_jacobians(BA.BAProblem(**_to(f, _t)))
    jr, jJp, jJl = JBA._residuals_and_jacobians(
        JBA.BAProblem(**_to(f, jnp.asarray)))
    assert tuple(Jp.shape) == tuple(jJp.shape) == (f["obs_w"].size, 1, 6)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-3)
    np.testing.assert_allclose(Jp.numpy(), np.asarray(jJp), rtol=1e-4,
                               atol=1e-2)
    np.testing.assert_allclose(Jl.numpy(), np.asarray(jJl), rtol=1e-4,
                               atol=1e-3)


class FakeMates:
    """The StereoMates fields add_keyframe reads."""

    def __init__(self, uv, theta, gamma, valid):
        self.left_x = np.asarray(uv[:, 0], np.float32)
        self.left_y = np.asarray(uv[:, 1], np.float32)
        self.left_theta = np.asarray(theta, np.float32)
        self.gamma = np.asarray(gamma, np.float32)
        self.valid = np.asarray(valid, bool)


def _keyframes(seed=3, n_kf=3, n_lm=200):
    rng, X, Rs, ts, uvs = _scene(seed, n_kf, n_lm)
    theta = rng.uniform(0, np.pi, n_lm)
    out = []
    for k in range(n_kf):
        Xc = X @ Rs[k].T + ts[k]
        valid = ((uvs[k, :, 0] > 5) & (uvs[k, :, 0] < 315)
                 & (uvs[k, :, 1] > 5) & (uvs[k, :, 1] < 235))
        valid[rng.integers(0, n_lm, 10)] = False
        gamma = Xc + rng.normal(0, 0.03, Xc.shape)
        gamma[3] = [0.0, 0.0, 1e5]            # degenerate depth: dropped
        R = _rot(rng.normal(0, 0.003, 3)) @ Rs[k] if k else Rs[k]
        t = ts[k] + (rng.normal(0, 0.02, 3) if k else 0.0)
        out.append((FakeMates(uvs[k], theta, gamma, valid), R, t))
    return out


def test_window_ba_run_matches_jax():
    cfg_kw = dict(window=3, max_landmarks=256, max_obs=1024, n_iters=6)
    wba = WBA.WindowBA(K_CAM, WBA.WindowBAConfig(**cfg_kw), device="cpu")
    jwba = JWBA.WindowBA(K_CAM, JWBA.WindowBAConfig(**cfg_kw))
    links = np.arange(200)
    links[::17] = -1                                   # some tracks end
    for k, (mates, R, t) in enumerate(_keyframes()):
        lk = links if k else None
        wba.add_keyframe(mates, GEO.Pose(torch.from_numpy(R.copy()),
                                         torch.from_numpy(np.asarray(t))), lk)
        jwba.add_keyframe(mates, JGEO.Pose(jnp.asarray(R), jnp.asarray(t)), lk)
        if k == 0:
            assert wba.run() is None and jwba.run() is None
    for a, b in zip(wba.kf_tid, jwba.kf_tid):
        np.testing.assert_array_equal(a, b)
    (poses, info), (jposes, jinfo) = wba.run(), jwba.run()
    assert info["n_landmarks"] == jinfo["n_landmarks"] > 100
    assert info["n_obs"] == jinfo["n_obs"] > 300
    assert info["solve_s"] > 0 and info["host_assembly_s"] > 0
    np.testing.assert_allclose(info["cost"], jinfo["cost"], rtol=1e-3)
    assert info["cost"][-1] < info["cost"][0]
    assert len(poses) == 3
    for p, jp, T in zip(poses, jposes, wba.kf_poses):
        assert p.R.dtype == torch.float32
        np.testing.assert_allclose(p.R.numpy(), np.asarray(jp.R), atol=1e-4)
        np.testing.assert_allclose(p.t.numpy(), np.asarray(jp.t), atol=1e-4)
        np.testing.assert_allclose(T[:3, 3], p.t.numpy(), atol=1e-7)
    # the same window on a mesh of one rank (the sharded solve's path:
    # broadcast, one landmark block, all-reduced sums) gives the same poses
    import torch.distributed as dist
    from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM
    mesh = PM.init_distributed(device="cpu")
    try:
        mwba = WBA.WindowBA(K_CAM, WBA.WindowBAConfig(**cfg_kw), mesh=mesh,
                            device="cpu")
        for k, (mates, R, t) in enumerate(_keyframes()):
            mwba.add_keyframe(mates, GEO.Pose(torch.from_numpy(R.copy()),
                                              torch.from_numpy(np.asarray(t))),
                              links if k else None)
        mposes, minfo = mwba.run()
    finally:
        dist.destroy_process_group()
    assert (minfo["n_landmarks"], minfo["n_obs"]) == (info["n_landmarks"],
                                                      info["n_obs"])
    np.testing.assert_allclose(minfo["cost"], info["cost"], rtol=1e-5)
    for p, mp in zip(poses, mposes):
        np.testing.assert_allclose(mp.R.numpy(), p.R.numpy(), atol=1e-5)
        np.testing.assert_allclose(mp.t.numpy(), p.t.numpy(), atol=1e-5)


def test_best_links_from_quads_matches_jax():
    import types
    rng = np.random.default_rng(8)
    cmask = rng.uniform(size=(40, 6)) < 0.3
    cmask[5] = False
    q = dict(cmask=cmask, ncc_l=rng.uniform(-1, 1, (40, 6)).astype(np.float32),
             cf_idx=rng.integers(0, 99, (40, 6)))
    tr_t = types.SimpleNamespace(quads=types.SimpleNamespace(
        **{k: torch.from_numpy(v) for k, v in q.items()}))
    tr_j = types.SimpleNamespace(quads=types.SimpleNamespace(**q))
    links = WBA.best_links_from_quads(tr_t)
    np.testing.assert_array_equal(links, JWBA.best_links_from_quads(tr_j))
    assert links[5] == -1 and links.dtype == np.int64


def _u8(a):
    return np.round(a).clip(0, 255).astype(np.uint8)


def _rot_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T)
         - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


@pytest.mark.parametrize("policy", ["every_frame", "adaptive"])
def test_pipeline_with_window_ba_matches_jax(policy):
    """`adaptive` with the quality gate forced (min inlier ratio > 1)
    re-keyframes every frame through the adaptive branch."""
    seq = JS.make_sequence(3, 120, 160)
    kw = dict(ba_window=3, keyframe_policy=policy)
    if policy == "adaptive":
        kw["rekeyframe_min_inlier_ratio"] = 1.01
    jpipe = JPL.VOPipeline(rig=seq.rig, cfg=JVOConfig(**SMALL), **kw)
    tpipe = PL.VOPipeline(seq.rig, VOConfig(**SMALL), device="cpu", **kw)
    for f in seq.frames:
        jpipe.run_frame(_u8(f.left), _u8(f.right))
        tpipe.run_frame(_u8(f.left), _u8(f.right))
    assert tpipe._ba_kf_frames == jpipe._ba_kf_frames == [0, 1, 2]
    assert len(tpipe.ba_info_log) == len(jpipe.ba_info_log) == 2
    for a, b in zip(tpipe.ba_info_log, jpipe.ba_info_log):
        assert abs(a["n_landmarks"] - b["n_landmarks"]) \
            <= 0.1 * b["n_landmarks"] + 5
        assert np.isfinite(a["cost"]).all()
        assert a["cost"][-1] <= a["cost"][0] * (1 + 1e-3)
    tids = np.concatenate([t[t >= 0] for t in tpipe.wba.kf_tid])
    assert int((np.unique(tids, return_counts=True)[1] >= 2).sum()) > 50
    for k, (p, jp, f) in enumerate(zip(tpipe.trajectory, jpipe.trajectory,
                                       seq.frames)):
        assert _rot_deg(p.R.numpy(), jp.R) <= 0.1
        assert np.linalg.norm(p.t.numpy() - np.asarray(jp.t)) <= 0.005
        assert _rot_deg(p.R.numpy(), f.R) < 0.5
        assert np.linalg.norm(p.t.numpy() - f.t) < 0.03
    np.testing.assert_array_equal(tpipe.kf_pose_est.R.numpy(),
                                  tpipe.trajectory[-1].R.numpy())


def test_ba_writeback_under_sparse_keyframes():
    """Refined keyframe poses land at the keyframes' own frame indices,
    aligned from the end; the frames between keep their estimates."""
    seq = JS.make_sequence(5, 120, 160)
    pipe = PL.VOPipeline(seq.rig, VOConfig(**SMALL), device="cpu",
                         ba_window=3, keyframe_policy="adaptive")
    pipe._should_rekeyframe = lambda tr: pipe.frame_idx in (2, 4)
    for k, f in enumerate(seq.frames):
        pipe.run_frame(f.left, f.right)
        if k == 3:
            snap = (pipe.trajectory[3].R.clone(), pipe.trajectory[3].t.clone())
    assert pipe._ba_kf_frames == [0, 2, 4] and len(pipe.trajectory) == 5
    assert torch.equal(pipe.trajectory[3].R, snap[0])
    assert torch.equal(pipe.trajectory[3].t, snap[1])
    assert len(pipe.ba_info_log) >= 1
    assert torch.equal(pipe.trajectory[4].t, pipe.kf_pose_est.t)
    # fewer recorded indices than window poses: still newest <-> newest
    pipe._ba_kf_frames = [4]
    pipe.frame_idx = 4
    pipe.trajectory[2] = GEO.Pose.identity()
    pipe._run_window_ba(pipe.keyframe, _NoLinks(pipe), pipe.trajectory[4])
    assert torch.equal(pipe.trajectory[2].R, torch.eye(3))
    for p in pipe.trajectory:
        assert torch.isfinite(p.R).all() and torch.isfinite(p.t).all()
    with pytest.raises(ValueError, match="re-keyframing"):
        PL.VOPipeline(seq.rig, VOConfig(**SMALL), device="cpu", ba_window=3,
                      keyframe_policy="reference")


class _NoLinks:
    """A TemporalResult stand-in whose quads link nothing."""

    def __init__(self, pipe):
        M, Cq = pipe.cfg.max_mates, pipe.cfg.max_quad_candidates
        import types
        self.quads = types.SimpleNamespace(
            cmask=torch.zeros((M, Cq), dtype=torch.bool),
            ncc_l=torch.zeros((M, Cq)),
            cf_idx=torch.zeros((M, Cq), dtype=torch.int64))


def test_window_ba_reduces_drift():
    """The port's counterpart of test_window_ba_drift.py's
    test_window_ba_reduces_drift: sliding-window BA applied as VOPipeline
    applies it must cut the noisy chain's ATE below 0.7x."""
    from tests import torch_ranks as TR
    _, poses_gt, frames, rels = TR.make_corridor()
    raw = TR.run_chain(frames, rels, poses_gt, None)
    wba = WBA.WindowBA(TR.K_CAM, WBA.WindowBAConfig(
        window=6, max_landmarks=512, max_obs=4096, n_iters=6), device="cpu")
    ba = TR.run_chain(frames, rels, poses_gt, wba)
    ate_raw, ate_ba = TR.ate(raw, poses_gt), TR.ate(ba, poses_gt)
    # the raw chain must actually drift for the test to mean anything
    assert ate_raw > 0.05, f"fixture too easy: raw ATE {ate_raw}"
    assert ate_ba < 0.7 * ate_raw, f"BA ATE {ate_ba:.4f} vs raw {ate_raw:.4f}"
