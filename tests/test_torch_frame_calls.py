"""The recorder of a frame's kernel calls (`tests/frame_calls.py`) on the
CPU: it keeps each call's operands as they were given and gives the
module its names back; every wrapper it records has a plain twin that
takes the wrapper's arguments by name; K3's twin, assembled side by side,
equals what `refine_2dof_pair_batch` gives on the CPU; the check of a
kernel's output against its twin's passes equal outputs (a NaN equal to
a NaN) and fails on a flipped bit. The calls themselves are made on the
card (`tests/test_torch_cuda.py`, marker
`gpu`)."""

import inspect

import numpy as np
import pytest
import torch

from edge_based_visual_odometry_tpu_torch.io import synthetic as S
from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
from edge_based_visual_odometry_tpu_torch.ops import image as IMG
from tests import frame_calls as FC

torch.set_num_threads(2)


def test_recording_keeps_operands_and_restores_names():
    orig = GN.interleave_maps
    img = torch.arange(12.0).reshape(3, 4)
    with FC.Recording([(GN, "interleave_maps")]) as calls:
        out = GN.interleave_maps(img, img + 1, right_gy=img + 2)
        img += 100              # a later write does not reach the call
    assert GN.interleave_maps is orig
    (call,) = calls
    assert call.args[0] is not img and float(call.args[0][0, 0]) == 0.0
    assert sorted(call.bound()) == ["right_gx", "right_gy", "right_img"]
    torch.testing.assert_close(call.run(), out, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(FC.WRAPPERS))
def test_each_wrapper_has_a_twin_taking_its_arguments(name):
    """The twin takes every argument of the wrapper but the kernel's own
    (`KERNEL_ONLY`), and needs none the wrapper lacks."""
    kernel, mod, twin = FC.WRAPPERS[name]
    assert kernel in FC.FRAME_CALLS
    params = set(inspect.signature(getattr(mod, name)).parameters)
    params.discard(FC.KERNEL_ONLY.get(name))
    if twin is None:            # K3: assembled from the one-side twin
        assert kernel == "K3"
        sig = inspect.signature(FC._k3_twin)
    else:
        sig = inspect.signature(getattr(mod, twin))
    assert params <= set(sig.parameters)
    assert {n for n, p in sig.parameters.items()
            if p.default is p.empty} <= params


@pytest.mark.parametrize("phase1_iters,budget", [(0, 0), (2, 16), (2, 4096)])
def test_k3_twin_equals_the_pair_batch_on_the_cpu(phase1_iters, budget):
    """A K3 call's twin (`_two_phase_in_place` over each side, or one
    pass) against `refine_2dof_pair_batch` on CPU tensors (`_two_phase`
    over each side), bit for bit on the active lanes."""
    f = S.make_sequence(1, 120, 160).frames[0]
    imgs = [torch.from_numpy(np.round(a).astype(np.float32))
            for a in (f.left, f.right)]
    rng = np.random.default_rng(7)
    B = 64

    def lanes():
        x = rng.uniform(20, 140, B)
        y = rng.uniform(20, 100, B)
        return np.stack([x, y, rng.uniform(-np.pi, np.pi, B)], -1)
    k = np.concatenate([lanes(), lanes()], -1)
    c = k + np.concatenate([rng.uniform(-2, 2, (B, 2)), np.zeros((B, 1))] * 2,
                           -1)
    kpack, cpack = (torch.from_numpy(a.astype(np.float32)) for a in (k, c))
    active = torch.from_numpy(rng.random(B) > 0.1)
    maps4 = GN.interleave_pair_maps(*(
        (cf, *IMG.sobel_gradients(cf)) for cf in (imgs[1], imgs[0])))
    kw = dict(patch_size=7, max_iter=20, tol=1e-3, huber_delta=3.0, tile=32,
              chunk=8, phase1_iters=phase1_iters, phase2_budget=budget)
    call = FC.Call(GN, "refine_2dof_sides_cuda", GN.refine_2dof_sides_cuda,
                   (imgs, maps4, kpack, cpack, active), kw)
    res, done = call.twin()
    ref = GN.refine_2dof_pair_batch(*imgs, maps4, kpack, cpack, active, **kw)
    assert done.shape == (2, B)
    for r, p in zip(res, ref):
        for a, b in zip(r, p):
            torch.testing.assert_close(a[active], b[active], rtol=0, atol=0,
                                       equal_nan=True)


def _flip(t):
    """`t` with the lowest bit of its first entry flipped."""
    t = t.clone()
    w = t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)
    w.view(-1)[0] ^= 1
    return t


def _k1_fields():
    g = torch.Generator().manual_seed(0)
    ix, iy, th = (torch.rand(1, 8, 8, generator=g) for _ in range(3))
    return ix, iy, 3.0 + ix, th


def _compact_out():
    g = torch.Generator().manual_seed(1)
    return (torch.arange(8).reshape(2, 4), torch.rand(3, 2, 4, generator=g),
            torch.tensor([[True, True, False, False]] * 2))


@pytest.mark.parametrize("name,ref,bad", [
    ("toed_gradient_field_cuda", _k1_fields(),
     lambda f: (f[0] + 0.01, *f[1:])),
    ("toed_gradient_field_cuda", _k1_fields(),
     lambda f: (*f[:3], f[3] + 0.002)),
    ("edge_descriptors_cuda", torch.rand(4, 128).to(torch.bfloat16), _flip),
    ("dense_gates_stereo_cuda",
     (torch.tensor([1.0, float("nan")]), torch.tensor([float("nan"), 0.5])),
     lambda o: (_flip(o[0]), o[1])),
    ("ransac_counts_cuda", torch.arange(6, dtype=torch.int32), _flip),
    ("pose_gn_normal_equations_cuda", torch.rand(28), _flip),
    ("compact_candidates_cuda", _compact_out(),
     lambda o: (o[0], _flip(o[1]), o[2])),
    ("compact_candidates_cuda", _compact_out(),
     lambda o: (o[0], o[1], ~o[2])),
    ("bnb_keep_cuda", torch.tensor([[True, False, True], [False] * 3]),
     lambda o: o ^ (torch.arange(6).reshape(2, 3) == 4))])
def test_twin_check_passes_equal_and_fails_on_a_difference(name, ref, bad):
    """`assert_matches_twin` on outputs in each kernel's form: equal ones
    pass, a difference past the kernel's tolerance fails (K1: Ix past
    rtol 2e-4 / atol 2e-3, the orientation past 1e-3 rad; the others one
    bit, or a flipped flag of the compaction's or the streak filter's
    mask)."""
    call = FC.Call(None, name, lambda *a, **kw: None, (), {})
    FC.assert_matches_twin(call, ref, ref)
    with pytest.raises(AssertionError):
        FC.assert_matches_twin(call, bad(ref), ref)
