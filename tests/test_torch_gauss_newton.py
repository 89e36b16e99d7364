"""Port Gauss-Newton refiners vs the JAX reference on integer-valued
images (the production PNG path, where the reference's bf16 weight split
is exact to ~0.003 gray):

  - 1-DoF epipolar GN (plain twin of kernel K2 under the two-phase
    loop) vs refine_along_epipolar_batch at production settings (tile
    32, 2 phase-1 iterations, weight split) with a phase-2 budget small
    enough that the over-budget path runs;
  - the same vs the Pallas kernel in interpret mode (tile 48, one phase);
  - 2-DoF GN vs refine_2dof_batch.

Tolerances (cf. tests/test_toed_pallas.py): delta atol 2e-3, score atol
1e-2, `valid` agreement >= 0.98 - f32 sums in another order and the
reference's bf16 split sampling.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from edge_based_visual_odometry_tpu.io import synthetic as JS
from edge_based_visual_odometry_tpu.ops import gauss_newton as JGN
from edge_based_visual_odometry_tpu.ops import gn_pallas as JGNP
from edge_based_visual_odometry_tpu.ops import image as JIMG
from edge_based_visual_odometry_tpu.ops import toed as JT
from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN

pytestmark = pytest.mark.heavy
torch.set_num_threads(2)


@pytest.fixture(scope="module")
def problem():
    """Stereo GN lanes on a 120x160 synthetic pair: left TOED edges, right
    candidates at the GT disparity plus noise (up to ~1.5 px), rectified
    epipolar direction; the last 16 lanes inactive."""
    seq = JS.make_sequence(1, 120, 160)
    f = seq.frames[0]
    left = np.round(f.left).clip(0, 255).astype(np.float32)
    right = np.round(f.right).clip(0, 255).astype(np.float32)
    gx, gy = (np.asarray(a) for a in JIMG.sobel_gradients(jnp.asarray(right)))
    e = JT.detect_edges(jnp.asarray(left), max_edges=1024)
    n = int(e.count)
    rng = np.random.default_rng(3)
    sel = rng.choice(n, 208, replace=False)
    lx = np.asarray(e.x)[sel]
    ly = np.asarray(e.y)[sel]
    lt = np.asarray(e.theta)[sel]
    disp = f.disparity[np.round(ly).astype(int), np.round(lx).astype(int)]
    rx = (lx - disp + rng.uniform(-1.5, 1.5, sel.size)).astype(np.float32)
    ry = ly.copy()
    epi = np.tile(np.array([[1.0, 0.0]], np.float32), (sel.size, 1))
    act = np.ones(sel.size, bool)
    act[-16:] = False
    return dict(imgs=(left, right, gx, gy), lx=lx, ly=ly, lt=lt, rx=rx,
                ry=ry, epi=epi, act=act)


def _port_args(p):
    return [torch.from_numpy(np.array(a)) for a in
            (*p["imgs"], p["lx"], p["ly"], p["lt"], p["rx"], p["ry"], p["epi"])]


def _jax_args(p):
    return [jnp.asarray(a) for a in
            (*p["imgs"], p["lx"], p["ly"], p["lt"], p["rx"], p["ry"], p["epi"])]


def _assert_close(out, ref, act):
    """delta and score on `act` lanes, valid agreement on all active."""
    agree = (out.valid.numpy() == np.asarray(ref.valid))[act].mean()
    assert agree >= 0.98, agree
    np.testing.assert_allclose(out.delta.numpy()[act],
                               np.asarray(ref.delta)[act], atol=2e-3)
    np.testing.assert_allclose(out.score.numpy()[act],
                               np.asarray(ref.score)[act], atol=1e-2)


@pytest.mark.parametrize("budget", [16, 16384])
def test_epipolar_two_phase_matches_jax(problem, budget):
    p = problem
    kw = dict(patch_size=7, max_iter=20, tol=1e-3, huber_delta=1.0, tile=32,
              chunk=8, phase1_iters=2, phase2_budget=budget)
    ref = JGN.refine_along_epipolar_batch(
        *_jax_args(p), active=jnp.asarray(p["act"]), weight_split=True,
        phase1_chunk=64, **kw)
    out = GN.refine_along_epipolar_batch(
        *_port_args(p), active=torch.from_numpy(p["act"]), **kw)
    if budget == 16:
        # the over-budget path ran: some unconverged lanes kept phase 1
        assert (np.asarray(ref.score)[p["act"]] == 1e6).sum() > 0
    _assert_close(out, ref, p["act"])


def test_epipolar_matches_pallas_interpret(problem):
    p = problem
    kw = dict(patch_size=7, max_iter=20, tol=1e-3, huber_delta=1.0)
    ref = JGNP.refine_along_epipolar_pallas(
        *_jax_args(p), tile=48, block_b=8, active=jnp.asarray(p["act"]),
        interpret=True, **kw)
    out = GN.refine_along_epipolar_batch(
        *_port_args(p), tile=48, active=torch.from_numpy(p["act"]), **kw)
    _assert_close(out, ref, p["act"])


def test_two_phase_within_budget_equals_single_phase(problem):
    p = problem
    act = torch.from_numpy(p["act"])
    kw = dict(patch_size=7, max_iter=20, tol=1e-3, huber_delta=1.0, tile=32,
              active=act)
    one = GN.refine_along_epipolar_batch(*_port_args(p), **kw)
    two = GN.refine_along_epipolar_batch(*_port_args(p), chunk=8,
                                         phase1_iters=2, phase2_budget=4096,
                                         **kw)
    for a, b in zip(one[:4], two[:4]):
        torch.testing.assert_close(a[act], b[act], rtol=0, atol=0)


@pytest.mark.parametrize("budget", [16, 16384])
def test_2dof_matches_jax(problem, budget):
    """KF = left image, CF = right image: the 2-DoF refiner moves each
    candidate onto its KF edge's match."""
    p = problem
    left, right, gx, gy = p["imgs"]
    ct = p["lt"]
    kw = dict(patch_size=7, max_iter=20, tol=1e-3, huber_delta=3.0, tile=32,
              chunk=8, phase1_iters=2, phase2_budget=budget)
    jargs = [jnp.asarray(a) for a in (left, right, gx, gy, p["lx"], p["ly"],
                                      p["lt"], p["rx"], p["ry"], ct)]
    ref = JGN.refine_2dof_batch(*jargs, active=jnp.asarray(p["act"]),
                                weight_split=True, phase1_chunk=64, **kw)
    out = GN.refine_2dof_batch(*[torch.from_numpy(np.array(a)) for a in jargs],
                               active=torch.from_numpy(p["act"]), **kw)
    agree = (out.valid.numpy() == np.asarray(ref.valid))[p["act"]].mean()
    assert agree >= 0.98, agree
    # a lane still oscillating at max_iter returns an iteration snapshot,
    # which amplifies the reference's ~0.003 gray split-sampling error
    # (one such lane moves 0.009 px here; without the split all lanes
    # agree to 1e-3): compare deltas on lanes that stopped earlier in both
    settled = (p["act"] & (out.iters.numpy() < kw["max_iter"])
               & (np.asarray(ref.iters) < kw["max_iter"]))
    assert settled.sum() > 0.5 * p["act"].sum()
    _assert_close(out, ref, settled)


def test_cpu_tensors_take_the_twin_and_kernel_wrapper_refuses_them(
        problem, monkeypatch):
    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB

    def no_build():
        raise AssertionError("CPU tensors must not build or launch a kernel")

    monkeypatch.setattr(CB, "lib", no_build)
    args = _port_args(problem)
    act = torch.from_numpy(problem["act"])
    before = dict(CB.LAUNCHES)
    GN.refine_along_epipolar_batch(*args, active=act, tile=32)
    assert CB.LAUNCHES == before
    with pytest.raises(ValueError):
        GN.refine_along_epipolar_cuda(*args, torch.zeros(act.shape[0]), act,
                                      0, 20)
