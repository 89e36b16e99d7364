"""The spans reduction (`harness/spans.py`) on hand-built Chrome-trace
events, its readers, and one CPU slice of the port with spans on."""

import contextlib

import numpy as np
import pytest
import torch

from vo_bench.harness import spans as SP
from vo_bench.harness import spec as SPEC

OLD = ("stereo_step_ms", "temporal_step_ms", "ba_solve_ms",
       "kernels_roofline_pct", "launches_per_frame", "device_idle_pct")


def X(name, ts, dur, cat, pid=1, tid=1, **args):
    return dict(ph="X", name=name, ts=ts, dur=dur, cat=cat, pid=pid,
                tid=tid, args=args)


def span(name, ts, dur, tid=1):
    return X("vo/" + name, ts, dur, "user_annotation", tid=tid)


def call(name, ts, dur, corr=None, tid=1):
    args = {} if corr is None else {"correlation": corr}
    return X(name, ts, dur, "cuda_runtime", tid=tid, **args)


def kernel(ts, dur, corr, cat="kernel"):
    return X(f"k{corr}", ts, dur, cat, pid=0, tid=7, correlation=corr)


def test_self_time_is_the_span_less_its_children():
    ps = SP.reduce([span("frame", 0, 100), span("a", 10, 30),
                    span("c", 15, 10), span("b", 50, 10)])
    r = ps["rows"]
    assert ps["frames"] == 1
    assert r["frame"]["wall_s"] == pytest.approx(100e-6)
    assert r["frame"]["self_s"] == pytest.approx(60e-6)
    assert r["a"]["self_s"] == pytest.approx(20e-6)
    assert r["c"]["self_s"] == pytest.approx(10e-6)
    assert ps["parents"] == {"frame": None, "a": "frame", "c": "a",
                             "b": "frame"}


def _gaps_trace():
    return [span("frame", 0, 100), span("s", 10, 40),
            span("frame", 200, 100),
            kernel(0, 5, 1), kernel(30, 5, 2), kernel(80, 5, 3),
            kernel(150, 10, 4), kernel(250, 10, 5, cat="gpu_memcpy")]


def test_idle_gap_goes_to_the_span_open_at_its_middle():
    ps = SP.reduce(_gaps_trace())
    r = ps["rows"]
    assert r["s"]["idle_s"] == pytest.approx(25e-6)          # 5 .. 30
    assert r["frame"]["idle_s"] == pytest.approx((45 + 90) * 1e-6)
    assert r[SP.OUTSIDE]["idle_s"] == pytest.approx(65e-6)   # 85 .. 150
    assert ps["idle"]["in_frames_s"] == pytest.approx(160e-6)
    assert ps["idle"]["frame_self_s"] == pytest.approx(135e-6)
    assert ps["idle"]["outside_s"] == pytest.approx(65e-6)
    assert SP.coverage(ps) == pytest.approx(25 / 160)
    # no host call launched them: their time is not given to a span
    assert ps["unattributed"]["device_ops"] == 5
    assert all(r[k]["device_s"] == 0 for k in r)


def test_a_sync_inside_a_wait_is_declared_and_one_outside_is_hidden():
    ev = [span("frame", 0, 100), span("s", 10, 30), span("wait.x", 50, 20),
          span("inner", 55, 10),
          call("cudaStreamSynchronize", 12, 2),      # in s: hidden
          call("cudaStreamSynchronize", 52, 2),      # in wait.x: declared
          call("cudaMemcpy", 57, 2),                 # under wait.x too
          call("cudaDeviceSynchronize", 80, 2),      # frame's own: hidden
          call("cudaEventSynchronize", 150, 2),      # between frames
          call("cudaLaunchKernel", 20, 1, corr=9),   # not a sync
          span("wait.y", 120, 10),                   # a wait outside
          call("cudaStreamSynchronize", 122, 2)]     # any frame: outside
    ps = SP.reduce(ev)
    assert ps["syncs"] == dict(declared=2, hidden=2, outside=2)
    assert ps["rows"]["s"]["hidden_syncs"] == 1
    assert ps["rows"]["frame"]["hidden_syncs"] == 1
    assert ps["rows"]["wait.x"]["syncs"] == 1
    assert ps["rows"]["wait.x"]["hidden_syncs"] == 0
    assert ps["rows"][SP.OUTSIDE]["syncs"] == 1
    assert ps["wait_s"] == pytest.approx(20e-6)   # waits inside frames
    assert SPEC.load_metric("hidden_syncs_per_frame").read(
        {"program_spans": ps}) == 2
    assert SPEC.load_metric("host_wait_ms").read(
        {"program_spans": ps}) == pytest.approx(0.02)


def test_launches_and_device_time_by_correlation_id():
    ev = [span("frame", 0, 100), span("a", 10, 20), span("b", 40, 20),
          call("cudaLaunchKernel", 12, 1, corr=1),
          call("cudaLaunchKernel", 14, 1, corr=2),
          call("cudaMemcpyAsync", 45, 1, corr=3),
          call("cudaLaunchKernel", 70, 1, corr=4),    # frame's own
          call("cudaLaunchKernel", 41, 1, corr=5, tid=2),  # other thread
          # the device runs them late, under other spans' host time
          kernel(50, 4, 1), kernel(55, 6, 2), kernel(90, 3, 3,
                                                     cat="gpu_memcpy"),
          kernel(95, 2, 4), kernel(98, 1, 5)]
    ps = SP.reduce(ev)
    r = ps["rows"]
    assert r["a"]["launches"] == 2
    assert r["a"]["device_s"] == pytest.approx(10e-6)
    assert r["b"]["launches"] == 1
    assert r["b"]["device_s"] == pytest.approx(3e-6)
    assert r["frame"]["launches"] == 1
    assert r[SP.OUTSIDE]["launches"] == 1
    assert ps["unattributed"]["device_ops"] == 0


@pytest.mark.parametrize("metric", SP.METRICS)
def test_every_new_reader_returns_none_without_program_spans(metric):
    mod = SPEC.load_metric(metric)
    assert (mod.SOURCE, mod.MOVES) == ("program_span", "frames_per_s")
    assert mod.LAYER in ("stage", "frame")
    assert mod.read({}) is None
    assert mod.read({"trace": {"busy_s": 1.0}}) is None
    assert mod.read({"program_spans": SP.reduce([])}) is None
    assert mod.read({"program_spans": SP.reduce(
        [call("cudaStreamSynchronize", 0, 1)])}) is None


def test_stage_readers_read_the_stage_span_a_frame():
    ev = []
    for k in range(2):
        t = 1000 * k
        ev += [span("frame", t, 900), span("stereo_step", t + 10, 400),
               span("detect_edges", t + 20, 100 + 20 * k),
               span("match_stereo", t + 200, 200),
               span("temporal_step", t + 420, 400),
               span("match_temporal", t + 430, 150),
               span("lift_quads", t + 600, 40),
               span("estimate_pose", t + 650, 160)]
    ctx = {"program_spans": SP.reduce(ev)}
    want = dict(detect_edges_ms=0.11, match_stereo_ms=0.2,
                match_temporal_ms=0.15, lift_quads_ms=0.04,
                estimate_pose_ms=0.16, host_wait_ms=0.0,
                hidden_syncs_per_frame=0.0)
    for name, value in want.items():
        assert SPEC.load_metric(name).read(ctx) == pytest.approx(value)
    text = SP.table(ctx["program_spans"])
    assert "  detect_edges" in text and "    match_temporal" in text


def _old_ctx():
    return dict(spans={"stereo_step": [0.012, 0.014],
                       "temporal_step": [0.02, 0.018]},
                ba_infos=[{"solve_s": 0.08, "host_assembly_s": 0.01}],
                window_frames=100,
                trace={"busy_s": 0.35, "window_s": 1.75, "units": 24,
                       "device_ops": 46680, "by_kernel": {"K1": 0.0024}},
                work={"K1": {"bound_s": 0.0007}}, work_units=24)


def test_the_old_readers_read_the_same_with_the_new_key():
    ctx = _old_ctx()
    before = {m: SPEC.load_metric(m).read(ctx) for m in OLD}
    assert all(v is not None for v in before.values())
    ctx["program_spans"] = SP.reduce(_gaps_trace())
    assert {m: SPEC.load_metric(m).read(ctx) for m in OLD} == before


def test_a_cpu_slice_of_the_port():
    """Two frames of the port at 120 x 160 on the CPU, profiled with
    spans on: every stage reader reads, the frames nest their stages,
    and a slice with spans off holds none."""
    from edge_based_visual_odometry_tpu_torch.config import VOConfig
    from edge_based_visual_odometry_tpu_torch.io import synthetic as S
    from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
    from edge_based_visual_odometry_tpu_torch.utils import timing

    seq = S.make_sequence(3, 120, 160)
    imgs = [tuple(np.round(a).clip(0, 255).astype(np.uint8)
                  for a in (f.left, f.right)) for f in seq.frames]
    pipe = PL.VOPipeline(S.default_rig(120, 160), VOConfig(
        max_edges=1024, max_candidates=8, gather_slots=64, max_mates=512,
        max_refine_pairs=1024, max_quad_candidates=8, quad_gather_slots=144,
        ransac_max_iterations=256, gn_max_iter=4), device="cpu")
    torch.set_num_threads(2)
    pipe.run_frame(*imgs[0])

    def two(spans):
        def run():
            with timing.spans_on() if spans else contextlib.nullcontext():
                for left, right in imgs[1:]:
                    pipe.run_frame(left, right)
            return 2
        return run
    events, window_s, units = SP.profile_events(two(False), "cpu")
    assert SP.reduce(events)["frames"] == 0
    events, window_s, units = SP.profile_events(two(True), "cpu")
    ps = SP.reduce(events, window_s, units)
    assert ps["frames"] == units == 2
    ctx = {"program_spans": ps}
    for m in SP.METRICS[:5]:
        assert 0 < SPEC.load_metric(m).read(ctx) < 1e3 * window_s
    assert ps["parents"]["detect_edges"] == "stereo_step"
    assert ps["parents"]["pose.score"] == "estimate_pose"
    assert ps["rows"]["wait.success"]["calls"] == 2
    assert SPEC.load_metric("host_wait_ms").read(ctx) > 0
