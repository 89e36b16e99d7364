"""The pipeline steps' CUDA graphs (`utils/graphs.py`).

On the CPU, the graph module's host logic: the output arena's packing,
the static inputs' copies, the stale-callable guard, the order of warm-up,
capture and replay with a stand-in for the captured graph, the launch
and step counters; and the step builders on `device="cpu"`, which build
no graph and give what the steps gave before graphs.

On the card (the `gpu` marker; skipped without CUDA): graphed and eager
steps bit-equal over 9 KITTI-size frames under the every-frame and the
adaptive keyframe policies, with the same launches a frame; results
kept across later replays unchanged (the pair step's keyframe result
among them); a wrapper patched after capture is called; a 40-frame
loop replays all but its warm-up calls. The supervised steps (GT maps,
GT pose): graphed and eager bit-equal over the same frames, stage logs
included; a captured frame replays both steps and counts its rows and
map bytes; a 200-frame run's peak memory within 1 GB of a 20-frame
run's, so no logged row holds a replay's result.
"""

import contextlib

import numpy as np
import pytest
import torch

from edge_based_visual_odometry_tpu_torch import geometry as geom
from edge_based_visual_odometry_tpu_torch.config import VOConfig
from edge_based_visual_odometry_tpu_torch.io import synthetic as S
from edge_based_visual_odometry_tpu_torch.models import motion_tracker as MT
from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
from edge_based_visual_odometry_tpu_torch.models import stereo_matcher as SM
from edge_based_visual_odometry_tpu_torch.models import temporal_matcher as TM
from edge_based_visual_odometry_tpu_torch.models.types import (
    FrameData, StereoMates, rig_arrays_from_rig)
from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.ops import image as IMG
from edge_based_visual_odometry_tpu_torch.ops import toed
from edge_based_visual_odometry_tpu_torch.utils import graphs as G

# tests/test_torch_pipeline.py's SMALL
SMALL = dict(max_edges=1024, max_candidates=8, gather_slots=64,
             max_mates=512, max_refine_pairs=1024, max_quad_candidates=8,
             quad_gather_slots=144, ransac_max_iterations=256, gn_max_iter=4)


def _u8(a):
    return np.round(a).clip(0, 255).astype(np.uint8)


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()


def assert_trees_bit_equal(a, b, what=""):
    la, sa = G.flatten(a)
    lb, sb = G.flatten(b)
    assert G._spec_key(sa) == G._spec_key(sb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        np.testing.assert_array_equal(_bytes(x), _bytes(y),
                                      err_msg=f"{what} leaf {i}")


def _random(shape, dtype, g):
    if dtype == torch.bool:
        return torch.rand(shape, generator=g) < 0.5
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g).to(dtype)
    return torch.randint(-1000, 1000, shape, generator=g).to(dtype)


def _frame_result(g, M=37, P=3):
    frame = FrameData(*(_random((5, 7), torch.float32, g) for _ in range(6)))
    f32 = torch.float32
    mates = StereoMates(
        *(_random((M,), f32, g) for _ in range(6)),
        _random((M, 2 * P * P), f32, g), _random((M, 2 * P * P), f32, g),
        _random((M, 2), torch.bool, g), _random((M, 2), torch.bool, g),
        _random((M, 16), torch.bfloat16, g), _random((M, 16), torch.bfloat16, g),
        _random((M, 3), f32, g), _random((0, 3), f32, g),
        _random((M,), f32, g), _random((M,), f32, g),
        _random((M,), torch.bool, g), _random((M,), torch.bool, g),
        _random((), torch.int32, g))
    return PL.FrameResult(frame=frame, mates=mates,
                          stereo_metrics=_random((12, 4), f32, g),
                          n_left_edges=_random((), torch.int32, g),
                          n_right_edges=_random((), torch.int32, g),
                          distributions=None)


def _temporal_result(g, M=23, C=5):
    f32 = torch.float32
    quads = TM.TemporalQuads(
        _random((M,), torch.bool, g), _random((M, 2), f32, g),
        _random((M, 2), f32, g), _random((M,), f32, g), _random((M,), f32, g),
        _random((M,), torch.bool, g), _random((M, C), torch.int64, g),
        *(_random((M, C), f32, g) for _ in range(6)),
        _random((M, C), torch.bool, g), _random((M, C), f32, g),
        _random((M, C), f32, g))
    return PL.TemporalResult(
        quads=quads, temporal_metrics=_random((5, 4), f32, g),
        R=_random((3, 3), f32, g), t=_random((3,), f32, g),
        inlier_count=_random((), torch.int64, g),
        inlier_ratio=_random((), f32, g), n_quads=_random((), torch.int32, g),
        success=_random((), torch.bool, g))


RESULTS = {"frame_result": _frame_result,
           "temporal_result": _temporal_result}


# ---------------------------------------------------------------- CPU ----
@pytest.mark.parametrize("kind", sorted(RESULTS))
def test_arena_round_trip(kind):
    """A result packed into the arena and unpacked from one copy of it
    gives equal tensors and `None` fields, all views of that copy,
    sharing no storage with the arena itself."""
    tree = RESULTS[kind](torch.Generator().manual_seed(3))
    arena = G.Arena(tree)
    assert arena.nbytes % G.ALIGN == 0
    assert all(off % G.ALIGN == 0 for _, _, off, _ in arena.fields)
    out = torch.full((arena.nbytes,), 0xAB, dtype=torch.uint8)
    arena.pack(tree, out)
    back = arena.unpack(out.clone())
    assert type(back) is type(tree)
    assert_trees_bit_equal(back, tree, kind)
    leaves, _ = G.flatten(back)
    ptrs = {t.untyped_storage().data_ptr() for t in leaves}
    assert len(ptrs) == 1 and out.untyped_storage().data_ptr() not in ptrs
    if kind == "frame_result":
        assert back.distributions is None


def _arena_copy(tree):
    """`tree` as the fields of one arena copy, as a replayed step returns
    it."""
    arena = G.Arena(tree)
    out = torch.empty(arena.nbytes, dtype=torch.uint8)
    arena.pack(tree, out)
    return arena.unpack(out.clone())


def test_static_args_one_copy_for_a_shared_storage_group(monkeypatch):
    """A group whose tensors view one storage (a step's result) takes one
    copy of the bytes they cover; a loose group, one copy a tensor; a
    group of the captured layout loaded from loose tensors, one copy a
    tensor; every static tensor then equals its argument."""
    g = torch.Generator().manual_seed(5)
    first = _arena_copy(_frame_result(g))
    rel = (_random((3, 3), torch.float32, g), _random((3,), torch.float32, g))
    static = G.StaticArgs([(first.mates, first.frame), rel], torch.device("cpu"))
    assert static.groups[0][1] is not None and static.groups[1][1] is None

    copies = []
    real = torch.Tensor.copy_

    def counted(self, src, *a, **kw):
        copies.append(src.numel() * src.element_size())
        return real(self, src, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "copy_", counted)
    later = _arena_copy(_frame_result(g))
    rel2 = tuple(_random(t.shape, t.dtype, g) for t in rel)
    trees = static.load([(later.mates, later.frame), rel2])
    assert len(copies) == 1 + 2
    assert copies[0] == static.groups[0][1][1]
    assert_trees_bit_equal(trees[0], (later.mates, later.frame), "shared")
    assert_trees_bit_equal(trees[1], rel2, "loose")

    copies.clear()
    loose = _frame_result(g)          # the same shapes, tensors apart
    trees = static.load([(loose.mates, loose.frame), rel])
    n_leaves = len(G.flatten((loose.mates, loose.frame))[0])
    assert len(copies) == n_leaves + 2
    assert_trees_bit_equal(trees[0], (loose.mates, loose.frame), "fallback")


# the stage functions and K1-K9 wrappers, then dispatchers that tools hook
GUARDED = ("toed.detect_edges", "stereo_matcher.match_stereo",
           "temporal_matcher.match_temporal", "motion_tracker.lift_quads",
           "motion_tracker.estimate_pose", "toed.toed_gradient_field_cuda",
           "gauss_newton._launch_gn", "gauss_newton._k3_launch",
           "clustering.cluster_edges_cuda", "descriptors.edge_descriptors_cuda",
           "patches.dense_gates_stereo_cuda", "patches.dense_gates_flat_cuda",
           "patches.dense_gates_temporal_cuda", "patches.edge_patches_cuda",
           "pose.ransac_counts_cuda", "pose.pose_gn_normal_equations_cuda",
           "patches.edge_patches_flat", "gauss_newton.refine_2dof_pair_batch",
           "gauss_newton.refine_along_epipolar_batch", "pose.ransac_counts")


@pytest.mark.parametrize("name", GUARDED)
def test_guard_sees_a_rebound_callable(name, monkeypatch):
    """A stage function, K1-K9 wrapper or dispatcher rebound at its
    module's name is seen, and so is binding it back."""
    mod, attr = next((m, n) for m, n in G.watched()
                     if f"{m.__name__.rsplit('.', 1)[-1]}.{n}" == name)
    assert G.unchanged(G.PROGRAM)
    real = getattr(mod, attr)
    monkeypatch.setattr(mod, attr, lambda *a, **k: real(*a, **k))
    assert not G.unchanged(G.PROGRAM)
    monkeypatch.setattr(mod, attr, real)
    assert G.unchanged(G.PROGRAM)


def test_reset_launch_counts_resets_graph_steps():
    CB.LAUNCHES["pose_gn"] += 3
    CB.GRAPH_STEPS["stereo_step"]["replay"] += 2
    CB.GRAPH_STEPS["temporal_step"]["eager"] += 1
    CB.reset_launch_counts()
    assert set(CB.GRAPH_STEPS) == {"stereo_step", "temporal_step"}
    assert all(v == 0 for v in CB.LAUNCHES.values())
    assert all(v == 0 for c in CB.GRAPH_STEPS.values() for v in c.values())


class _StandIn:
    """What a captured graph does, on the CPU: its replay runs the
    captured function again (on the static inputs, into a new arena),
    leaving the launch counts as they were; the generators registered
    with it are kept."""

    made = []

    def __init__(self, fn, stream, generator=None):
        self.fn, self.generator, self.replays = fn, generator, 0
        fn()
        _StandIn.made.append(self)

    def replay(self):
        self.replays += 1
        saved = dict(CB.LAUNCHES)
        self.fn()
        CB.LAUNCHES.update(saved)


@pytest.fixture
def stand_in(monkeypatch):
    """The CUDA calls a StepGraph makes, stood in for on the CPU."""
    _StandIn.made = []
    monkeypatch.setattr(G, "capture_graph", _StandIn)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    CB.reset_launch_counts()
    yield
    CB.reset_launch_counts()


def _toy_step(calls):
    """A body of the temporal kind: (kf, cf) groups, a seed and the
    graph's generator; one K1 'launch' a call."""
    def body(kf, rel, seed, generator):
        calls.append(generator)
        CB.LAUNCHES["toed_gradient_field"] += 1
        draw = torch.randint(0, 1 << 30, (4,), generator=generator
                             if generator is not None else
                             torch.Generator().manual_seed(int(seed)))
        return PL.TemporalResult(
            quads=None, temporal_metrics=kf[0] * 2.0, R=rel[0] @ rel[0],
            t=kf[1] + rel[1], inlier_count=draw.sum(),
            inlier_ratio=kf[0].sum(), n_quads=draw.to(torch.int32)[0],
            success=kf[0].sum() > 0)
    return body


def _toy_args(g):
    kf = _arena_copy((_random((4, 3), torch.float32, g),
                      _random((3,), torch.float32, g)))
    rel = (_random((3, 3), torch.float32, g), _random((3,), torch.float32, g))
    return [kf, rel]


def test_step_graph_warms_captures_then_replays(stand_in):
    """Call 1 runs eagerly (no generator), call 2 captures (through the
    graph's generator) and replays, later calls replay: each returns
    what the eager body gives for its own arguments and seed, as a fresh
    arena copy; the K1 count advances once a call; GRAPH_STEPS counts
    1 eager, 1 capture, the rest replays."""
    calls = []
    body = _toy_step(calls)
    step = G.StepGraph("temporal_step", body, torch.device("cpu"),
                       generator=True)
    g = torch.Generator().manual_seed(7)
    kept = []
    for i in range(6):
        args, seed = _toy_args(g), 1000 + i
        out = step(args, seed)
        saved = dict(CB.LAUNCHES)
        want = body(*args, seed, None)
        CB.LAUNCHES.update(saved)
        calls.pop()
        assert_trees_bit_equal(out, want, f"call {i}")
        kept.append((out, want))
    assert calls[0] is None and calls[1] is step.generator
    assert len(calls) == 1 + 1 + 5    # the stand-in's replays run the body
    assert CB.LAUNCHES["toed_gradient_field"] == 6
    assert CB.GRAPH_STEPS["temporal_step"] == {"capture": 1, "replay": 4,
                                               "eager": 1}
    (graph,) = _StandIn.made
    assert graph.generator is step.generator and graph.replays == 5
    assert step.generator.initial_seed() == 1005
    ptrs = {G.flatten(o)[0][0].untyped_storage().data_ptr()
            for o, _ in kept[1:]}
    assert len(ptrs) == 5 and step.out.untyped_storage().data_ptr() not in ptrs
    for i, (out, want) in enumerate(kept):
        assert_trees_bit_equal(out, want, f"kept {i}")


def test_step_graph_runs_eagerly_where_it_must(stand_in, monkeypatch):
    """A watched callable rebound (here before the step is built): eager,
    no capture, until it is bound back; after capture a call of another
    shape, or with a tensor off the step's device, runs eagerly, and the
    graph replays again for the captured signature."""
    calls = []
    body = _toy_step(calls)
    real = MT.estimate_pose
    monkeypatch.setattr(MT, "estimate_pose", lambda *a, **k: real(*a, **k))
    step = G.StepGraph("temporal_step", body, torch.device("cpu"),
                       generator=True)
    g = torch.Generator().manual_seed(9)
    for _ in range(3):
        step(_toy_args(g), 1)
    assert CB.GRAPH_STEPS["temporal_step"]["eager"] == 3 and not _StandIn.made
    monkeypatch.setattr(MT, "estimate_pose", real)
    step(_toy_args(g), 1)      # warms up
    step(_toy_args(g), 1)      # captures
    assert CB.GRAPH_STEPS["temporal_step"]["capture"] == 1
    kf, rel = _toy_args(g)
    wider = [(torch.zeros(5, 3), kf[1]), rel]
    out = step(wider, 2)
    assert_trees_bit_equal(out, body(*wider, 2, None), "wider")
    assert CB.GRAPH_STEPS["temporal_step"]["eager"] == 5
    meta = [kf, (rel[0].to("meta"), rel[1])]
    assert step(meta, 3).R.device.type == "meta"
    assert CB.GRAPH_STEPS["temporal_step"]["eager"] == 6
    step(_toy_args(g), 4)
    assert CB.GRAPH_STEPS["temporal_step"] == {"capture": 1, "replay": 1,
                                               "eager": 6}


def test_cpu_builders_build_no_graph_and_give_the_eager_steps(monkeypatch):
    """On the CPU the builders make no StepGraph, and the steps give,
    bit for bit, what the stages composed as before graphs give."""
    def refuse(*a, **k):
        raise AssertionError("a StepGraph built on the CPU")

    monkeypatch.setattr(PL, "StepGraph", refuse)
    seq = S.make_sequence(2, 120, 160)
    cfg = VOConfig(**SMALL)
    frames = [(_u8(f.left), _u8(f.right)) for f in seq.frames]
    stereo = PL.build_stereo_step(seq.rig, cfg, "cpu")
    temporal = PL.build_temporal_step(seq.rig, cfg, "cpu")
    rig_a = rig_arrays_from_rig(seq.rig, torch.device("cpu"))
    gather_ry = SM.derive_gather_band(seq.rig, cfg)

    def stereo_before(left, right):
        both = torch.stack([torch.as_tensor(a) for a in (left, right)]).to(
            dtype=torch.float32)
        gxs, gys = IMG.sobel_gradients(both)
        frame = FrameData(both[0], both[1], gxs[0], gys[0], gxs[1], gys[1])
        led, red = toed.detect_edges(
            both, kernel_size=cfg.toed_kernel_size, sigma=cfg.toed_sigma,
            grad_mag_min=cfg.toed_grad_mag_min, max_edges=cfg.max_edges,
            border=cfg.toed_border)
        out = SM.match_stereo(led, red, frame, rig_a, cfg,
                              gather_ry=gather_ry)
        return PL.FrameResult(frame, out[0], out[2], led.count, red.count)

    def temporal_before(kf, cf, R, t, seed):
        quads, tm = TM.match_temporal(kf.mates, cf.mates, kf.frame, cf.frame,
                                      geom.Pose(R, t), rig_a, cfg)
        pq = MT.lift_quads(kf.mates, quads, rig_a, cfg)
        res = MT.estimate_pose(pq, rig_a, cfg, seed)
        return PL.TemporalResult(quads, tm, res.R, res.t, res.inlier_count,
                                 res.inlier_ratio, res.n_quads, res.success)

    CB.reset_launch_counts()
    results = [stereo(*f) for f in frames]
    for f, r in zip(frames, results):
        assert_trees_bit_equal(r, stereo_before(*f), "stereo")
    R, t = torch.eye(3), torch.zeros(3)
    tr = temporal(results[0].mates, results[0].frame, results[1].mates,
                  results[1].frame, R, t, 11)
    assert_trees_bit_equal(tr, temporal_before(*results, R, t, 11),
                           "temporal")
    assert all(v == 0 for c in CB.GRAPH_STEPS.values() for v in c.values())


# --------------------------------------------------------------- card ----
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def kitti():
    """9 frames of the KITTI-size synthetic sequence, uint8."""
    seq = S.make_sequence(9, 376, 1241)
    return seq.rig, [(_u8(f.left), _u8(f.right)) for f in seq.frames]


def _eager_everywhere(monkeypatch):
    """Rebind a stage function of each step (to a pass-through): every
    step runs eagerly from here on."""
    for mod, name in ((SM, "match_stereo"), (MT, "estimate_pose")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, _real=real, **k: _real(*a, **k))


def _snapshot(fr, tr):
    """What the frame hands on, copied to the host."""
    keep = [fr.mates, fr.stereo_metrics]
    if fr.right_edges is not None:
        keep.append(fr.right_edges)
    if tr is not None:
        keep += [tr.quads, tr.temporal_metrics, tr.R, tr.t, tr.inlier_count,
                 tr.n_quads, tr.success, tr.inlier_ratio]
    return [t.detach().cpu().clone() for t in G.flatten(tuple(keep))[0]]


def _run(pipe, frames):
    out = []
    for f in frames:
        before = dict(CB.LAUNCHES)
        fr, tr = pipe.run_frame(*f[:2], **f[2] if len(f) > 2 else {})
        torch.cuda.synchronize()
        out.append((_snapshot(fr, tr),
                    {k: v - before[k] for k, v in CB.LAUNCHES.items()}))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["every_frame", "adaptive"])
def test_graphed_steps_bit_equal_to_eager(dev, kitti, policy, monkeypatch):
    """9 KITTI-size frames at VOConfig(): the graphed steps give the
    eager steps' mates, quads, pose, inlier and quad counts and success
    bit for bit, with the same launches a frame; the graphed run replays
    from the third call of each step, the eager one never does."""
    rig, frames = kitti
    kw = dict(keyframe_policy=policy)
    CB.reset_launch_counts()
    graphed = _run(PL.VOPipeline(rig, VOConfig(), device=dev, **kw), frames)
    steps = {k: dict(v) for k, v in CB.GRAPH_STEPS.items()}
    pipe = PL.VOPipeline(rig, VOConfig(), device=dev, **kw)
    _eager_everywhere(monkeypatch)
    CB.reset_launch_counts()
    eager = _run(pipe, frames)
    assert all(c["capture"] == c["replay"] == 0
               for c in CB.GRAPH_STEPS.values())
    assert steps["stereo_step"] == {"eager": 1, "capture": 1, "replay": 7}
    assert steps["temporal_step"]["replay"] >= 5, steps
    for i, ((a, la), (b, lb)) in enumerate(zip(graphed, eager)):
        assert la == lb, (i, la, lb)
        assert len(a) == len(b)
        for j, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_array_equal(_bytes(x), _bytes(y),
                                          err_msg=f"frame {i} field {j}")


@pytest.mark.gpu
def test_kept_results_survive_later_replays(dev, kitti, monkeypatch):
    """A result kept from an earlier replay is unchanged after later
    replays; the pair step (two stereo replays, then the temporal one)
    gives the eager pair step's pose, so its keyframe result survived
    the second stereo replay."""
    from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM
    rig, frames = kitti
    pipe = PL.VOPipeline(rig, VOConfig(), device=dev)
    kept = []
    for f in frames[:6]:
        fr, tr = pipe.run_frame(*f)
        torch.cuda.synchronize()
        kept.append(((fr, tr), _snapshot(fr, tr)))
    assert CB.GRAPH_STEPS["stereo_step"]["replay"] >= 4
    for i, ((fr, tr), snap) in enumerate(kept):
        for j, (x, y) in enumerate(zip(_snapshot(fr, tr), snap)):
            np.testing.assert_array_equal(_bytes(x), _bytes(y),
                                          err_msg=f"frame {i} field {j}")

    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    pairs = [(0, 1), (1, 2), (2, 3), (3, 4)]

    def run_pairs(step):
        return [[t.detach().cpu().clone() for t in step(
            *frames[a], *frames[b], eye, zero, 100 + a)] for a, b in pairs]

    graphed = run_pairs(PM.build_pair_step(rig, VOConfig(), dev))
    eager_step = PM.build_pair_step(rig, VOConfig(), dev)
    _eager_everywhere(monkeypatch)
    eager = run_pairs(eager_step)
    for i, (a, b) in enumerate(zip(graphed, eager)):
        for j, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_array_equal(_bytes(x), _bytes(y),
                                          err_msg=f"pair {i} output {j}")


@pytest.mark.gpu
def test_wrapper_patched_after_capture_is_called(dev, kitti, monkeypatch):
    from edge_based_visual_odometry_tpu_torch.ops import patches as PAT
    rig, frames = kitti
    pipe = PL.VOPipeline(rig, VOConfig(), device=dev)
    for f in frames[:4]:
        pipe.run_frame(*f)
    CB.reset_launch_counts()
    pipe.run_frame(*frames[4])
    assert CB.GRAPH_STEPS["stereo_step"] == {"eager": 0, "capture": 0,
                                             "replay": 1}
    calls = []
    real = PAT.edge_patches_cuda

    def watched(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(PAT, "edge_patches_cuda", watched)
    CB.reset_launch_counts()
    pipe.run_frame(*frames[5])
    assert len(calls) == 4        # K7: four calls a stereo step
    assert CB.GRAPH_STEPS["stereo_step"] == {"eager": 1, "capture": 0,
                                             "replay": 0}
    assert CB.GRAPH_STEPS["temporal_step"]["eager"] == 1
    assert CB.LAUNCHES["edge_patches"] == 4


@pytest.mark.gpu
def test_forty_frames_replay_after_warm_up(dev):
    """Every frame after the warm-up replays both steps: of 40 frames,
    the stereo step runs eagerly once and captures once, the temporal
    step (the bootstrap's call, then the first prediction-mode call)
    runs eagerly twice and captures once."""
    seq = S.make_sequence(40, 120, 160)
    pipe = PL.VOPipeline(seq.rig, VOConfig(**SMALL), device=dev)
    CB.reset_launch_counts()
    for f in seq.frames:
        pipe.run_frame(_u8(f.left), _u8(f.right))
    torch.cuda.synchronize()
    assert CB.GRAPH_STEPS["stereo_step"] == {"eager": 1, "capture": 1,
                                             "replay": 38}
    assert CB.GRAPH_STEPS["temporal_step"] == {"eager": 2, "capture": 1,
                                               "replay": 36}


@pytest.fixture(scope="module")
def kitti_gt():
    """9 frames of the KITTI-size synthetic sequence with their GT: uint8
    images, then `run_frame`'s GT arguments (the disparity, a
    non-occlusion map with its left 24 columns occluded, the world ->
    camera pose) as host arrays."""
    seq = S.make_sequence(9, 376, 1241)
    visible = np.full((376, 1241), 255, np.uint8)
    visible[:, :24] = 0
    return seq.rig, [(_u8(f.left), _u8(f.right), dict(
        disparity=f.disparity, occlusion=visible,
        gt_pose=geom.Pose(f.R.astype(np.float32), f.t.astype(np.float32))))
        for f in seq.frames]


def _supervised(rig, dev):
    return PL.VOPipeline(rig, VOConfig(), device=dev, has_gt_disparity=True,
                         use_gt_pose=True)


@pytest.mark.gpu
def test_supervised_steps_bit_equal_to_eager(dev, kitti_gt, monkeypatch):
    """The GT-supervised stereo step and the GT-pose temporal step, graphed
    and eager, give the same mates (GT locations, `is_tp`, `gamma_gt`),
    stage rows, right edges, quads and pose bit for bit, with the same
    launches a frame, and their stage logs the same numpy rows; the
    graphed run replays from the third call of each step, the eager one
    never does."""
    rig, frames = kitti_gt
    CB.reset_launch_counts()
    graphed_pipe = _supervised(rig, dev)
    graphed = _run(graphed_pipe, frames)
    steps = {k: dict(v) for k, v in CB.GRAPH_STEPS.items()}
    pipe = _supervised(rig, dev)
    _eager_everywhere(monkeypatch)
    CB.reset_launch_counts()
    eager = _run(pipe, frames)
    assert all(c["capture"] == c["replay"] == 0
               for c in CB.GRAPH_STEPS.values())
    assert steps == {"stereo_step": {"eager": 1, "capture": 1, "replay": 7},
                     "temporal_step": {"eager": 1, "capture": 1,
                                       "replay": 6}}
    for i, ((a, la), (b, lb)) in enumerate(zip(graphed, eager)):
        assert la == lb, (i, la, lb)
        assert len(a) == len(b)
        for j, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_array_equal(_bytes(x), _bytes(y),
                                          err_msg=f"frame {i} field {j}")
    for log in ("stereo_metrics_log", "temporal_metrics_log"):
        rows_g, rows_e = (getattr(p, log) for p in (graphed_pipe, pipe))
        assert len(rows_g) == len(rows_e) == (9 if log[0] == "s" else 8)
        for x, y in zip(rows_g, rows_e):
            assert isinstance(x, np.ndarray) and x.shape == y.shape
            np.testing.assert_array_equal(x, y, err_msg=log)
    assert float(graphed_pipe.stereo_metrics_log[-1][-1, 0]) > 0.5


@pytest.mark.gpu
def test_supervised_frame_replays_and_counts_its_rows(dev, kitti_gt):
    """Once both steps are captured, a supervised frame replays each step
    and runs neither eagerly; `EVAL` counts its two stage rows and the
    bytes of its two maps, and is reset with the launch counts."""
    rig, frames = kitti_gt
    pipe = _supervised(rig, dev)
    for f in frames[:3]:
        pipe.run_frame(*f[:2], **f[2])
    CB.reset_launch_counts()
    assert PL.EVAL == {"stereo_rows": 0, "temporal_rows": 0, "gt_bytes": 0}
    f = frames[3]
    pipe.run_frame(*f[:2], **f[2])
    assert CB.GRAPH_STEPS == {
        "stereo_step": {"eager": 0, "capture": 0, "replay": 1},
        "temporal_step": {"eager": 0, "capture": 0, "replay": 1}}
    assert PL.EVAL == {"stereo_rows": 1, "temporal_rows": 1,
                       "gt_bytes": 376 * 1241 * 5}


@pytest.mark.gpu
def test_supervised_logs_hold_no_replay_result(dev, kitti_gt):
    """200 supervised frames (the 9 frames there and back) peak within
    1 GB of 20: each logged row is copied out of its replay's result
    (tens of MB at this size), so no result outlives its frame."""
    rig, frames = kitti_gt
    order = list(range(9)) + list(range(7, 0, -1))
    pipe = _supervised(rig, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    peaks = {}
    for n in range(200):
        f = frames[order[n % len(order)]]
        pipe.run_frame(*f[:2], **f[2])
        if n + 1 in (20, 200):
            torch.cuda.synchronize()
            peaks[n + 1] = torch.cuda.max_memory_allocated(dev)
    assert len(pipe.stereo_metrics_log) == 200
    assert len(pipe.temporal_metrics_log) == 199
    assert peaks[200] - peaks[20] < 1 << 30, peaks
