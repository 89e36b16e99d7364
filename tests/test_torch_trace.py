"""The port's spans (`utils/timing.span`) on the CPU.

Three frames of `io/synthetic.make_sequence(3, 120, 160)` through the
port's VOPipeline with `tests/test_torch_pipeline.py`'s small config,
adaptive keyframes forced to re-keyframe on every frame (so the keyframe
read runs) and a 2-keyframe windowed BA, and one `WindowBA.run` on
`tests/test_torch_ba.py`'s keyframes:

- with spans on under `torch.profiler`, every span of PERF.md's table
  is recorded once a frame where its stage runs, inside the span the
  table names as its parent (stage inside step inside frame); the
  supervised run (GT maps, GT pose) records the maps' upload and the
  stage rows' hand-off too;
- mates, quads and poses are bit-identical with spans on and off;
- with spans off, `span()` makes no profiler call and a profiled frame
  holds no span;
- `device_trace` turns spans on for its block and restores the state,
  and `device_ops` counts the same ops in a frame traced with spans as
  in one profiled without them (on the CPU, and on the card where there
  is one).
"""

import collections
import contextlib
import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from edge_based_visual_odometry_tpu_torch import geometry as GEO
from edge_based_visual_odometry_tpu_torch.config import VOConfig
from edge_based_visual_odometry_tpu_torch.io import synthetic as S
from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
from edge_based_visual_odometry_tpu_torch.models import window_ba as WBA
from edge_based_visual_odometry_tpu_torch.utils import timing as T

pytestmark = pytest.mark.heavy
torch.set_num_threads(2)

# tests/test_torch_pipeline.py's SMALL
SMALL = dict(max_edges=1024, max_candidates=8, gather_slots=64,
             max_mates=512, max_refine_pairs=1024, max_quad_candidates=8,
             quad_gather_slots=144, ransac_max_iterations=256, gn_max_iter=4)
PERF = Path(__file__).resolve().parents[1] / "PERF.md"
ROW = re.compile(r"^\| `vo/([a-z_.]+)` \| (?:`vo/([a-z_.]+)`|-) \|")
# spans that run only in some frames: the temporal step's (not in the
# bootstrap frame) and windowed BA's (on a re-keyframe)
TEMPORAL_ONLY = ("temporal_step", "match_temporal", "lift_quads",
                 "estimate_pose", "temporal.", "pose.", "wait.success",
                 "wait.keyframe", "window_ba", "ba.", "wait.ba_")
# spans that run only on a rig with a distorted camera
DISTORTED_ONLY = ("undistort",)
# spans of the sharded pair step, which no frame runs
# (tests/test_torch_parallel.py holds them)
PAIR_ONLY = ("pair_step", "pair.", "wait.pair_count")
# spans of the supervised modes only: the GT maps' upload, the stage
# rows' hand-off to the logs
GT_ONLY = ("gt_upload", "wait.gt_upload", "eval.rows")


def documented():
    """PERF.md's span table: span name -> its parent's name (None for
    a span at the top)."""
    out = {}
    for line in PERF.read_text().splitlines():
        m = ROW.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


def _u8(a):
    return np.round(a).clip(0, 255).astype(np.uint8)


def _frames():
    seq = S.make_sequence(3, 120, 160)
    return [(_u8(f.left), _u8(f.right)) for f in seq.frames]


def _pipeline():
    return PL.VOPipeline(S.default_rig(120, 160), VOConfig(**SMALL),
                         device="cpu", keyframe_policy="adaptive",
                         rekeyframe_min_quads=10 ** 9, ba_window=2)


def _outputs(pipe, fr, tr):
    """What the frame hands on, as numpy arrays (bfloat16 as its bits)."""
    out = {f"mates.{k}": v for k, v in fr.mates._asdict().items()}
    if tr is not None:
        out.update({f"quads.{k}": v for k, v in tr.quads._asdict().items()})
        out.update(R=tr.R, t=tr.t, inliers=tr.inlier_count)
    pose = pipe.trajectory[-1]
    out.update(pose_R=pose.R, pose_t=pose.t)
    return {k: np.asarray(v.view(torch.int16) if v.dtype == torch.bfloat16
                          else v) for k, v in out.items() if v is not None}


def _run(frames, spans: bool):
    pipe = _pipeline()
    outs = []
    with T.spans_on() if spans else contextlib.nullcontext():
        for left, right in frames:
            fr, tr = pipe.run_frame(left, right)
            outs.append(_outputs(pipe, fr, tr))
    return outs, pipe


def _trace_spans(prof, tmp_path, name):
    """The trace's `vo/` spans as (name, start, end), by start."""
    path = tmp_path / f"{name}.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = [(e["name"][len(T.SPAN_PREFIX):], float(e["ts"]),
            float(e["ts"]) + float(e["dur"])) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e["name"].startswith(T.SPAN_PREFIX)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _parents(spans):
    """Each span's innermost enclosing span (index), or None."""
    out, stack = [], []
    for i, (_, a, b) in enumerate(spans):
        while stack and spans[stack[-1]][2] <= a:
            stack.pop()
        out.append(stack[-1] if stack else None)
        stack.append(i)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trace")
    frames = _frames()
    off, _ = _run(frames, spans=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on, pipe = _run(frames, spans=True)
    return dict(off=off, on=on, pipe=pipe,
                spans=_trace_spans(prof, tmp, "on"), tmp=tmp, frames=frames)


def test_documented_table_is_well_formed():
    doc = documented()
    assert "frame" in doc and doc["frame"] is None
    assert all(p is None or p in doc for p in doc.values())
    waits = {n for n in doc if n.startswith("wait.")}
    assert waits == {"wait.success", "wait.keyframe", "wait.upload",
                     "wait.ba_sync", "wait.ba_readback", "wait.pair_count",
                     "wait.gt_upload"}


def test_every_span_once_a_frame_where_its_stage_runs(runs):
    doc = documented()
    spans = runs["spans"]
    parents = _parents(spans)
    frames = [i for i, s in enumerate(spans) if s[0] == "frame"]
    assert len(frames) == 3
    assert all(parents[i] is None for i in frames)
    assert runs["pipe"].ba_info_log, "the 2-keyframe window was solved"
    for k, fi in enumerate(frames):
        inside = [s for s in spans
                  if spans[fi][1] <= s[1] and s[2] <= spans[fi][2]]
        names = [s[0] for s in inside]
        assert len(names) == len(set(names)), f"frame {k}: {names}"
        expected = {n for n in doc
                    if (k > 0 or not n.startswith(TEMPORAL_ONLY))
                    and not n.startswith(DISTORTED_ONLY + PAIR_ONLY
                                         + GT_ONLY)}
        assert set(names) == expected, (
            k, sorted(set(names) ^ expected))


def test_supervised_frames_record_the_gt_spans(tmp_path):
    """A supervised run (GT disparity and non-occlusion maps, GT poses)
    records, once a frame, the maps' upload inside the stereo step and
    the stage rows' hand-off inside the frame, beside the plain run's
    spans (no windowed BA or keyframe reads here); every span nests as
    the table says."""
    seq = S.make_sequence(3, 120, 160)
    visible = np.full((120, 160), 255, np.uint8)
    pipe = PL.VOPipeline(seq.rig, VOConfig(**SMALL), device="cpu",
                         has_gt_disparity=True, use_gt_pose=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with T.spans_on():
            for f in seq.frames:
                pipe.run_frame(_u8(f.left), _u8(f.right), f.disparity,
                               GEO.Pose(f.R.astype(np.float32),
                                        f.t.astype(np.float32)), visible)
    spans = _trace_spans(prof, tmp_path, "supervised")
    doc = documented()
    parents = _parents(spans)
    for (name, _, _), p in zip(spans, parents):
        assert (None if p is None else spans[p][0]) == doc[name], name
    frames = [s for s in spans if s[0] == "frame"]
    assert len(frames) == 3
    for k, (_, a, b) in enumerate(frames):
        names = [s[0] for s in spans if a <= s[1] and s[2] <= b]
        assert len(names) == len(set(names)), f"frame {k}: {names}"
        expected = {n for n in doc
                    if (k > 0 or not n.startswith(TEMPORAL_ONLY))
                    and not n.startswith(DISTORTED_ONLY + PAIR_ONLY
                                         + ("wait.keyframe", "window_ba",
                                            "ba.", "wait.ba_"))}
        assert set(names) == expected, (k, sorted(set(names) ^ expected))


def test_spans_nest_as_documented(runs):
    doc = documented()
    spans = runs["spans"]
    for (name, _, _), p in zip(spans, _parents(spans)):
        assert name in doc, f"{name} is not in PERF.md's span table"
        assert (None if p is None else spans[p][0]) == doc[name], name


def test_outputs_bit_identical_with_spans_on_and_off(runs):
    assert len(runs["on"]) == len(runs["off"]) == 3
    for a, b in zip(runs["on"], runs["off"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_undistort_span_once_a_frame_on_a_distorted_rig(tmp_path):
    """A rig with a distorted camera records `vo/undistort` once a frame,
    inside `vo/stereo_step`; the undistorted rig above records none."""
    rig = S.default_rig(120, 160)
    cam = dataclasses.replace(rig.left, distortion=(
        -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05))
    pipe = PL.VOPipeline(dataclasses.replace(rig, left=cam, right=cam),
                         VOConfig(**SMALL), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with T.spans_on():
            for left, right in _frames()[:2]:
                pipe.run_frame(left, right)
    spans = _trace_spans(prof, tmp_path, "distorted")
    parents = _parents(spans)
    frames = [s for s in spans if s[0] == "frame"]
    undistort = [i for i, s in enumerate(spans) if s[0] == "undistort"]
    assert len(frames) == 2 and len(undistort) == 2
    for f, i in zip(frames, undistort):
        assert f[1] <= spans[i][1] and spans[i][2] <= f[2]
        assert spans[parents[i]][0] == "stereo_step"


def test_spans_off_call_nothing(runs, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not T._spans
    assert T.span("frame") is T.span("stereo.gates", 3)
    with T.span("frame", 0):
        pass
    pipe = _pipeline()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = [_outputs(pipe, *pipe.run_frame(*f))
                for f in runs["frames"][:2]]
    assert _trace_spans(prof, runs["tmp"], "off") == []
    for a, b in zip(outs, runs["off"]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_spans_on_restores_the_prior_state():
    assert not T._spans
    with T.spans_on():
        assert T._spans
        with T.spans_on():
            assert T._spans
        assert T._spans
    assert not T._spans
    with pytest.raises(RuntimeError):
        with T.spans_on():
            raise RuntimeError
    assert not T._spans


def test_device_trace_turns_spans_on(tmp_path):
    assert not T._spans
    with T.device_trace(str(tmp_path)):
        assert T._spans
        with T.span("frame", 0):
            torch.ones(4).sum()
    assert not T._spans
    with T.spans_on():
        with T.device_trace(str(tmp_path / "again")):
            assert T._spans
        assert T._spans
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "vo/frame" in names


def _op_counts(prof, device_type):
    return collections.Counter({e.key: e.count
                                for e in T.device_ops(prof, device_type)})


@pytest.mark.parametrize("device", [
    pytest.param("cpu", marks=pytest.mark.skipif(
        torch.cuda.is_available(), reason="with a card, device_trace also "
        "profiles it and adds its own CPU rows; the cuda case holds it")),
    pytest.param("cuda", marks=[pytest.mark.gpu, pytest.mark.skipif(
        not torch.cuda.is_available(), reason="needs a CUDA device")])])
def test_device_ops_leave_out_the_spans(runs, tmp_path, device):
    """A frame traced by `device_trace` (spans on) and the same frame
    profiled without spans give `device_ops` the same ops, counts and
    names: the spans' annotations, which each cover the ops beneath
    them, are not among them."""
    kind = (torch.autograd.DeviceType.CUDA if device == "cuda"
            else torch.autograd.DeviceType.CPU)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    frames = runs["frames"]
    pipes = []
    for _ in range(2):      # both warmed before either is profiled
        pipes.append(PL.VOPipeline(S.default_rig(120, 160),
                                   VOConfig(**SMALL), device=device))
        for f in frames[:2]:
            pipes[-1].run_frame(*f)
    with profile(activities=acts) as plain:
        pipes[0].run_frame(*frames[2])
        if device == "cuda":
            torch.cuda.synchronize()
    with T.device_trace(str(tmp_path)) as traced:
        pipes[1].run_frame(*frames[2])
    assert any(e.is_user_annotation and e.key == "vo/frame"
               for e in traced.key_averages())
    ops = _op_counts(traced, kind)
    assert ops and not any(k.startswith(T.SPAN_PREFIX) for k in ops)
    assert ops == _op_counts(plain, kind)


def test_window_ba_spans(tmp_path):
    from tests import test_torch_ba as TBA

    wba = WBA.WindowBA(TBA.K_CAM, WBA.WindowBAConfig(
        window=3, max_landmarks=256, max_obs=1024, n_iters=6), device="cpu")
    links = np.arange(200)
    for k, (mates, R, t) in enumerate(TBA._keyframes()):
        wba.add_keyframe(mates, GEO.Pose(torch.from_numpy(R.copy()),
                                         torch.from_numpy(np.asarray(t))),
                         links if k else None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with T.spans_on():
            poses, info = wba.run()
    assert len(poses) == 3 and info["solve_s"] > 0
    spans = _trace_spans(prof, tmp_path, "ba")
    doc = documented()
    names = [s[0] for s in spans]
    assert sorted(names) == sorted(n for n in doc if n.startswith(
        ("ba.", "wait.ba_")))
    for (name, _, _), p in zip(spans, _parents(spans)):
        if p is not None or doc[name] != "window_ba":
            assert (None if p is None else spans[p][0]) == doc[name], name
