"""The hand-kernel calls of one frame, kept with their operands, and the
checks that hold a kernel's output against its plain twin's.

`Recording(targets)` wraps the functions `targets` names (module,
attribute) while it is entered; each call is kept as a `Call` (its
tensors cloned before the call, so that a later write by the frame cannot
touch them) and then made. By default the targets are the `*_cuda`
wrappers of K1-K9, TOED's NMS kernel, the gather windows' compaction and
the best/nearly-best streak filter (`WRAPPERS`). A step graph runs
eagerly while any of them is rebound (`utils/graphs.py`), so a recorded
frame makes every launch through a wrapper.

`frame_calls(pipe, frames)` runs frames[:3] through `pipe` and returns
the calls of frame 2 (the eager stereo step and the prediction-mode
temporal step) and each frame's results. A call's `run()` makes it again
through the module's name (a hook there sees it); `twin()` runs the
kernel's plain twin on the same operands and returns what the kernel
returns; `assert_matches_twin` holds the two equal.
`tests/test_torch_cuda.py` and `chip_smoke.py` both check each call so,
and `chip_smoke.py` times it.
"""

import dataclasses
import inspect

import numpy as np
import torch

from edge_based_visual_odometry_tpu_torch.models import stereo_matcher as SM
from edge_based_visual_odometry_tpu_torch.models import types as TY
from edge_based_visual_odometry_tpu_torch.ops import clustering as CL
from edge_based_visual_odometry_tpu_torch.ops import descriptors as DESC
from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
from edge_based_visual_odometry_tpu_torch.ops import grid as GRID
from edge_based_visual_odometry_tpu_torch.ops import patches as PAT
from edge_based_visual_odometry_tpu_torch.ops import pose as POSE
from edge_based_visual_odometry_tpu_torch.ops import toed
# the graphs' snapshot of the program's functions is taken on import: it
# must see them as the modules define them, before any is rebound here
from edge_based_visual_odometry_tpu_torch.utils import graphs  # noqa: F401

# each wrapper a frame calls: its kernel, its module and its plain twin
WRAPPERS = {
    "toed_gradient_field_cuda": ("K1", toed, "toed_gradient_field_plain"),
    "nms_compact_cuda": ("NMS", toed, "nms_compact_plain"),
    "refine_along_epipolar_cuda": ("K2", GN, "refine_along_epipolar_plain"),
    "refine_2dof_sides_cuda": ("K3", GN, None),
    "cluster_edges_cuda": ("K4", CL, "cluster_edges_plain"),
    "edge_descriptors_cuda": ("K5", DESC, "edge_descriptors_plain"),
    "dense_gates_stereo_cuda": ("K6", PAT, "dense_gates_stereo_plain"),
    "dense_gates_flat_cuda": ("K6", PAT, "dense_gates_flat_plain"),
    "dense_gates_temporal_cuda": ("K6", PAT, "dense_gates_temporal_plain"),
    "edge_patches_cuda": ("K7", PAT, "edge_patches_plain"),
    "ransac_counts_cuda": ("K8", POSE, "ransac_counts_plain"),
    "pose_gn_normal_equations_cuda": ("K9", POSE,
                                      "pose_gn_normal_equations_plain"),
    "compact_candidates_cuda": ("compact", GRID, "compact_candidates_plain"),
    "bnb_keep_cuda": ("BNB", SM, "_bnb_keep"),
}

# the wrappers' arguments the twins do not take: K2's interleaved maps,
# K7's live mask (a dead entry's row is unset by the kernel alone)
KERNEL_ONLY = {"refine_along_epipolar_cuda": "maps4",
               "edge_patches_cuda": "live"}

# the calls of each kernel in one frame of VOConfig() with a temporal
# step, in the order the frame makes them
FRAME_CALLS = {
    "K1": ("both images",), "NMS": ("both images",),
    "K2": ("phase 1", "phase 2"), "K3": ("both sides, two launches",),
    "K4": ("stereo", "temporal"),
    "K5": ("left edges", "right edges", "mates"),
    "K6": ("stereo", "stage-11 flat", "temporal"),
    "K7": ("left edges", "right edges", "stage-11 centres", "mates"),
    "K8": ("prescore", "full count"),
    "K9": ("step 0", "step 1", "step 2", "step 3"),
    "compact": ("stereo", "temporal"),
    "BNB": ("stereo NCC", "stereo SIFT", "temporal NCC", "temporal SIFT"),
}
# the launches of that frame by `cuda_build.LAUNCHES` entry: one a call
# but NMS 2, K3's call 2, K6's stereo and temporal calls 2 each
FRAME_LAUNCHES = {"toed_gradient_field": 1, "toed_nms_compact": 2,
                  "refine_along_epipolar": 2, "refine_2dof": 2,
                  "cluster_edges": 2, "edge_descriptors": 3, "dense_gates": 5,
                  "edge_patches": 4, "ransac_score": 2, "pose_gn": 4,
                  "compact_candidates": 2, "bnb_keep": 4}


def _clone(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


@dataclasses.dataclass
class Call:
    module: object
    name: str
    fn: object           # what the module's name was bound to
    args: tuple
    kwargs: dict

    @property
    def kernel(self):
        return WRAPPERS[self.name][0]

    def bound(self) -> dict:
        """The call's arguments by name, defaults included."""
        b = inspect.signature(self.fn).bind(*self.args, **self.kwargs)
        b.apply_defaults()
        return dict(b.arguments)

    def run(self):
        return getattr(self.module, self.name)(*self.args, **self.kwargs)

    def twin(self):
        """The plain twin on this call's operands, in the kernel's form."""
        kw = self.bound()
        if self.kernel == "K3":
            return _k3_twin(**kw)
        kw.pop(KERNEL_ONLY.get(self.name), None)
        return getattr(self.module, WRAPPERS[self.name][2])(**kw)


def _k3_twin(kf_imgs, maps4, kpack, cpack, active, patch_size, max_iter,
             tol, huber_delta, tile, chunk, phase1_iters, phase2_budget):
    """`refine_2dof_sides_cuda`'s result from the plain twin, side by
    side: one pass of [0, max_iter) from kf - cf, or the two phases in
    place (`_two_phase_in_place`)."""
    kw = dict(patch_size=patch_size, max_iter=max_iter, tol=tol,
              huber_delta=huber_delta, tile=tile)
    res, done = [], []
    for s, kf in enumerate(kf_imgs):
        imgs = (kf, *(maps4[s, ..., k].contiguous() for k in range(3)))
        lanes = tuple(t[:, 3 * s + k].contiguous() for t in (kpack, cpack)
                      for k in range(3))
        d0 = torch.stack([lanes[0] - lanes[3], lanes[1] - lanes[4]], -1)

        def run(a, d, it0, it_stop, act, imgs=imgs):
            return GN.refine_2dof_plain(*imgs, *a, d, act, it0, it_stop, **kw)
        if 0 < phase1_iters < max_iter:
            r, dn = GN._two_phase_in_place(
                run, active.shape[0], lanes, active, d0,
                phase1_iters=phase1_iters, phase2_budget=phase2_budget,
                max_iter=max_iter, chunk=chunk)
        else:
            r, dn = run(lanes, d0, 0, max_iter, active)
        res.append(r)
        done.append(dn)
    return res, torch.stack(done)


class Recording:
    """`with Recording() as calls:` keeps every call of `targets`
    ((module, attribute) pairs; the wrappers of `WRAPPERS` by default) in
    `calls` while entered."""

    def __init__(self, targets=None):
        self.targets = (targets if targets is not None else
                        [(mod, name) for name, (_, mod, _) in
                         WRAPPERS.items()])

    def __enter__(self):
        self.calls, self.saved = [], []
        for mod, name in self.targets:
            fn = getattr(mod, name)

            def rec(*a, _fn=fn, _mod=mod, _name=name, **kw):
                self.calls.append(Call(_mod, _name, _fn, _clone(a),
                                       _clone(kw)))
                return _fn(*a, **kw)
            self.saved.append((mod, name, fn))
            setattr(mod, name, rec)
        return self.calls

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)


def frame_calls(pipe, frames):
    """Frames[:3] ((left, right) each) through `pipe`, every step eager:
    (the wrapper calls of frame 2, [(FrameResult, TemporalResult) of each
    frame])."""
    results = []
    with Recording() as calls:
        for left, right in frames[:3]:
            del calls[:]
            results.append(pipe.run_frame(left, right))
    torch.cuda.synchronize()
    return calls, results


def assert_toed_close(out, ref):
    """K1's fields against the twin's: Ix, Iy and |grad| within rtol 2e-4 /
    atol 2e-3, the orientation's 99.9% quantile (where |grad| > 2) under
    1e-3 rad."""
    for a, b in zip(out[:3], ref[:3]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-3)
    m = ref[2] > 2.0
    d = (out[3] - ref[3]).abs()[m]
    d = torch.minimum(d, 2 * np.pi - d)
    assert float(torch.quantile(d.double().cpu(), 0.999)) < 1e-3


def edges_bit_equal(got, ref, what=""):
    """Two EdgeLists equal bit for bit, every field and the count."""
    for nm, a, b in zip(TY.EdgeList._fields, got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, nm)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), (what, nm)


def assert_same(k, p, act):
    """Kernel and twin (RefineResult, done) bit-equal on the `act` lanes
    (a NaN equals a NaN)."""
    for a, b in zip((*k[0], k[1]), (*p[0], p[1])):
        torch.testing.assert_close(a[act], b[act], rtol=0, atol=0,
                                   equal_nan=True)


def assert_cluster_same(k, p):
    """K4 and its twin: label, mask and members equal, x / y / theta bit
    for bit (a NaN equals a NaN)."""
    for a, b in zip(k, p):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.is_floating_point():
            same = ((a.view(torch.int32) == b.view(torch.int32))
                    | (a.isnan() & b.isnan()))
            assert bool(same.all())
        else:
            assert torch.equal(a, b)


def assert_bf16_same(k, p):
    """K5 and its twin: bf16 bit for bit (a NaN equals a NaN)."""
    assert k.shape == p.shape and k.dtype == p.dtype == torch.bfloat16
    same = ((k.view(torch.int16) == p.view(torch.int16))
            | (k.isnan() & p.isnan()))
    assert bool(same.all())


def same_f32(a, b):
    """Bit-equal float32 tensors, a NaN equal to a NaN."""
    assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
    same = (a.view(torch.int32) == b.view(torch.int32)) | (a.isnan()
                                                           & b.isnan())
    n_bad = int((~same).sum())
    assert n_bad == 0, f"{n_bad} of {a.numel()} values not bit-equal"


def assert_compact_same(got, ref):
    """The compaction's (idx, attrs, mask) and its twin's: idx and mask
    equal, the attributes bit for bit, on every slot."""
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(got[0], ref[0]), "idx differs"
    same_f32(got[1], ref[1])
    assert torch.equal(got[2], ref[2]), "mask differs"


def assert_bnb_same(got, ref):
    """The streak filter's kept slots and its twin's, every slot."""
    assert got.shape == ref.shape and got.dtype == ref.dtype == torch.bool
    n_bad = int((got != ref).sum())
    assert n_bad == 0, f"{n_bad} of {got.numel()} slots differ"


def assert_matches_twin(call, got, ref):
    """One recorded call's kernel output (`got`, from `call.run()`)
    against its twin's (`ref`, from `call.twin()`) on the same operands:
    K1 within rtol 2e-4 / atol 2e-3 and its orientation's 99.9% quantile
    under 1e-3 rad, K5 as bf16 bit patterns, the rest bit for bit (K2 and
    K3 on the active lanes, K7's stage-11 call on its live entries, the
    compaction and the streak filter on every output slot). An
    AssertionError says what differs."""
    k, kw = call.kernel, call.bound()
    if k == "K1":
        assert_toed_close(got, ref)
    elif k == "NMS":
        for b, (e, r) in enumerate(zip(got, ref)):
            edges_bit_equal(e, r, f"image {b}")
    elif k == "K2":
        assert_same(got, ref, kw["active"])
    elif k == "K3":
        for s in range(len(got[0])):
            assert_same((got[0][s], got[1][s]), (ref[0][s], ref[1][s]),
                        kw["active"])
    elif k == "K4":
        assert_cluster_same(got, ref)
    elif k == "K5":
        assert_bf16_same(got, ref)
    elif k == "K6":        # the stereo entry gives (dist, ncc)
        got, ref = (x if isinstance(x, tuple) else (x,) for x in (got, ref))
        for a, b in zip(got, ref):
            same_f32(a, b)
    elif k == "K7":
        live = kw["live"]      # stage 11's call: a dead entry's row is unset
        if live is not None:
            got, ref = [x[live] for x in got], [x[live] for x in ref]
        same_f32(got[0], ref[0])
        assert torch.equal(got[1], ref[1])
    elif k == "K8":
        assert got.dtype == ref.dtype and torch.equal(got, ref)
    elif k == "compact":     # (idx, attrs, mask), every slot
        assert_compact_same(got, ref)
    elif k == "BNB":         # the kept slots
        assert_bnb_same(got, ref)
    else:
        same_f32(got, ref)
