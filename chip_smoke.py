#!/usr/bin/env python3
"""Each hand-written kernel of the PyTorch/CUDA port timed alone, beside
the least time its work needs, on one GPU.

    python3 chip_smoke.py

  1. the card: nvidia-smi's name and power limit;
  2. the build: the kernels of csrc/ (nvcc, sm_90a), and what ptxas says
     of each (registers, spills);
  3. the frame replayed: frames 0-4 of `make_sequence(5, 376, 1241)`
     through a fresh VOPipeline(VOConfig(), every_frame); frame 4 replays
     both steps' graphs, and its launches must be those of
     `FRAME_LAUNCHES` (`tests/frame_calls.py`);
  4. the calls: frame 2 through VOPipeline(VOConfig(), every_frame), and
     through the same at patch sizes P = 5 / 9 / 11 (shift 5 / 4 / 2.9
     px), every step eager, each call of a kernel wrapper kept with its
     operands (`tests/frame_calls.py`); each kernel must be called as
     often as `FRAME_CALLS` says;
  5. each call of K1, TOED's NMS kernel, K2-K9, the gather windows'
     compaction and the best/nearly-best streak filter (at every P: K2,
     K3, K6 and K7) made again on its operands and held against its
     plain twin (`frame_calls.assert_matches_twin`: K1 within rtol 2e-4,
     K5 as bf16 bits, the rest bit for bit); its time alone
     (`graph_ms`) and with its wrapper (`cuda_ms`), its bound and the
     share of it reached, and the twin's time; for the compaction also
     the share of rows with more live slots than it keeps
     (`rows_over_capacity`), and rows for its calls in the evaluation
     path's frame (`temporal_gather_mode "reference"`: the temporal
     call's 576 slots), where the kernel must not be slower than the
     twin; then the occupancy the built K3, K5, K6 and K7 report
     (`k*_info`).

It prints a line a call, then one JSON line of the rows, the occupancy
and frame 4's counts, and last {"ok": true, "device": {...}}. It exits 1
where it cannot run, where a count is not the one expected, or where a
call differs from its twin (and then prints no "ok" line). The same
checks on the benchmark's frames, and the paths through the kernels, are
the `gpu` tests' (`python3 -m pytest --noconftest
tests/test_torch_cuda.py`); the frame's time is the benchmark's
(`vo_bench/run.py`).

The bound of a launch is the least time the card could take for its
work: the larger of its operations over the float32 peak and its bytes
(each input read once, each output written once) over the memory rate.
The counts are the benchmark's (`vo_bench/harness/work.py`, re-exported
here), a call's work as the benchmark derives it from the operands
(`vo_bench/harness/kernels.py::WorkRecorder`). K2, K3, K5, K8 and K9
round each multiply and add on its own, to stay bit-equal to their
twins, so they reach at most half the FMA peak: their rows also give the
bound at that rate (`bound_ms_no_fma`). The arithmetic needs no GPU
(tests/test_torch_bounds.py).
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from vo_bench.harness.work import (  # noqa: F401  (re-exported)
    K8_PAIR_FLOPS, K9_QUAD_FLOPS, PEAK_BYTES, PEAK_FLOPS, bound, k1_work,
    k2_work, k3_work, k4_work, k5_work, k6_work, k7_work, k8_work, k9_work)

# the patch sizes timed besides the default's, each with the largest shift
# the reference's coverage guard admits there (`patches.check_coverage`:
# P = 9 <= 4.34 px, P = 11 <= 2.93 px), and the kernels they change
WIDE_PATCHES = ((5, 5.0), (9, 4.0), (11, 2.9))
WIDE_KERNELS = ("K2", "K3", "K6", "K7")
FMA_FREE = ("K2", "K3", "K5", "K8", "K9")


def nms_work(B, H, W, kept, max_edges):
    """(flops, bytes) of TOED's NMS and compaction (csrc/
    toed_nms_compact.cu) on B images of H x W: bytes, Ix, Iy and |grad|
    of each field pixel once, the orientation of each kept pixel, and the
    B EdgeLists (4 floats and a flag a slot, the counts). Its arithmetic
    (comparisons, and the fit only on pixels past NMS) is not counted:
    the bytes bound it."""
    return 0, (B * 4 * H * W * 3 * 4 + sum(kept) * 4
               + B * max_edges * (4 * 4 + 1) + B * 4)


def compact_work(Q, S, A, W, has_priority):
    """(flops, bytes) of the gather windows' compaction (csrc/
    compact_candidates.cu) of (Q, S) slots to (Q, W) with A attribute
    planes: bytes, each slot's mask and priority once (5 B; 1 B with no
    priority), and each output slot's idx, attributes and mask read at its
    source slot and written (2 (8 + 4 A + 1) B). Its comparisons are not
    counted: the bytes bound it."""
    return 0, Q * S * (5 if has_priority else 1) + Q * W * 2 * (9 + 4 * A)


def bnb_work(N, C):
    """(flops, bytes) of the best/nearly-best streak filter (csrc/
    bnb_keep.cu) on (N, C) slots: bytes, each slot's score and mask read
    once and its mask written once (6 B). Its compares are not counted:
    the bytes bound it."""
    return 0, N * C * 6


def with_bound(ms, flops, nbytes, fma_free=False):
    b = bound(flops, nbytes)
    b.update(ms=ms, pct_of_bound=100.0 * b["bound_ms"] / ms)
    if fma_free:
        nf = bound(flops, nbytes, PEAK_FLOPS / 2)["bound_ms"]
        b.update(bound_ms_no_fma=nf, pct_of_bound_no_fma=100.0 * nf / ms)
    return b


def launch_bound(ms, launch_ms, flops, nbytes, fma_free=False):
    """`with_bound` for a kernel timed both with its wrapper (`ms`) and
    as launches alone (`launch_ms`): the % of bound is the launches',
    the wrapper's beside it."""
    b = with_bound(launch_ms, flops, nbytes, fma_free)
    b.update(ms=ms, launch_ms=launch_ms,
             pct_of_bound_with_wrapper=100.0 * b["bound_ms"] / ms)
    return b


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps):
    """Mean device ms per call over `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps):
    """Mean device ms per call of `fn`'s launches alone: `reps` calls
    captured in one CUDA graph, so the wrapper's host work (checks, the
    ctypes call) runs once at capture and not between the launches. `fn`
    is warmed on the capture stream (where K5 keeps its texture maps),
    the graph replayed once to warm, then timed."""
    stream = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / reps
    del g
    return ms


def f32_differ(a, b):
    """Entries of two float32 tensors whose bit patterns differ (a NaN
    equals a NaN)."""
    return int(((a.view(torch.int32) != b.view(torch.int32))
                & ~(a.isnan() & b.isnan())).sum())


def call_work(call, out):
    """(flops, bytes) of one recorded call: what the benchmark counts of
    its launches, `nms_work` for the NMS kernel (`out` its EdgeLists),
    `compact_work` for the compaction or `bnb_work` for the streak
    filter."""
    from vo_bench.harness import kernels as KN

    a = call.bound()
    if call.kernel == "NMS":
        return nms_work(a["Ix"].shape[0], a["img_height"], a["img_width"],
                        [int(e.count) for e in out], a["max_edges"])
    if call.kernel == "compact":
        (Q, S), A = a["mask"].shape, a["attrs"].shape[0]
        return compact_work(Q, S, A, min(a["capacity"], S),
                            a["priority"] is not None)
    if call.kernel == "BNB":
        return bnb_work(*a["mask"].shape)
    with KN.WorkRecorder() as rec:
        call.run()
    (w,) = rec.work().values()
    return w["flops"], w["bytes"]


def rows_over_capacity(call):
    """The share of a compaction call's rows with more live slots than it
    keeps: where the order, and not only the packing, decides."""
    a = call.bound()
    return float((a["mask"].sum(1) > a["capacity"]).float().mean())


def timed_row(call, name, P, card):
    """One recorded call made again and held against its twin on the same
    operands (an AssertionError says what differs), then its times alone
    and with its wrapper, its bound and the twin's time: its row."""
    from tests import frame_calls as FC

    k = call.kernel
    out = call.run()
    FC.assert_matches_twin(call, out, call.twin())
    row = launch_bound(cuda_ms(call.run, 20), graph_ms(call.run, 20),
                       *call_work(call, out), fma_free=k in FMA_FREE)
    row.update(kernel=k, call=name, wrapper=call.name, patch_size=P,
               bound_us=row["bound_ms"] * 1e3,
               plain_ms=cuda_ms(call.twin, 1), card=card)
    extra = ""
    if k in FMA_FREE:
        extra = (f" ({row['pct_of_bound_no_fma']:.1f}% of the FMA-free "
                 f"{row['bound_ms_no_fma'] * 1e3:.1f} us)")
    if k == "compact":
        row.update(slots=tuple(call.bound()["mask"].shape),
                   rows_over_capacity=rows_over_capacity(call))
        extra = (f"; {row['slots']} slots, rows over capacity "
                 f"{row['rows_over_capacity']:.3f}")
    print(f"{k} {name} (P = {P}): {row['launch_ms']:.4f} ms alone, "
          f"{row['ms']:.4f} ms with the wrapper; bound "
          f"{row['bound_us']:.1f} us ({row['bound_by']}: "
          f"{row['flops']} flop, {row['bytes']} B), "
          f"{row['pct_of_bound']:.1f}% of it alone{extra}; twin "
          f"{row['plain_ms']:.3f} ms [{card}]")
    return row


def timed_rows(calls, P, kernels, card, bad):
    """A row for each call of `kernels` (`FC.FRAME_CALLS` names them),
    from `timed_row`. A kernel called another number of times, or a call
    whose output differs from its twin's, is added to `bad` and gets no
    row."""
    from tests import frame_calls as FC

    rows = []
    for k in kernels:
        mine = [c for c in calls if c.kernel == k]
        if len(mine) != len(FC.FRAME_CALLS[k]):
            bad.append(f"P = {P}: {len(mine)} calls of {k}, not "
                       f"{len(FC.FRAME_CALLS[k])}")
            continue
        for name, call in zip(FC.FRAME_CALLS[k], mine):
            try:
                rows.append(timed_row(call, name, P, card))
            except AssertionError as e:
                bad.append(f"{k} {name} (P = {P}) differs from its twin: "
                           f"{e}")
    return rows


def evaluation_compact_rows(rig, frames, card, bad):
    """The compaction's calls on frame 2 in the evaluation path's gather
    (VOConfig(temporal_gather_mode="reference"): the temporal call's
    `quad_gather_slots` = 576 slots a row around the KF edges), each from
    `timed_row`; `bad` gets a call that differs from its twin or is
    slower than it."""
    from edge_based_visual_odometry_tpu_torch.config import VOConfig
    from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
    from edge_based_visual_odometry_tpu_torch.ops import grid as GRID
    from tests import frame_calls as FC

    pipe = PL.VOPipeline(rig, VOConfig(temporal_gather_mode="reference"),
                         device="cuda", keyframe_policy="every_frame")
    with FC.Recording([(GRID, "compact_candidates_cuda")]) as calls:
        for left, right in frames[:3]:
            del calls[:]
            pipe.run_frame(left, right)
    torch.cuda.synchronize()
    names = FC.FRAME_CALLS["compact"]
    if len(calls) != len(names):
        bad.append(f"evaluation: {len(calls)} calls of compact, not "
                   f"{len(names)}")
        return []
    rows = []
    for name, call in zip(names, calls):
        try:
            rows.append(timed_row(call, f"{name} (evaluation)", 7, card))
        except AssertionError as e:
            bad.append(f"compact {name} (evaluation) differs from its twin: "
                       f"{e}")
    slow = [r for r in rows if r["ms"] > r["plain_ms"]]
    if slow:
        bad.append(f"compact slower than its twin at {slow[0]['slots']} "
                   f"slots: {slow[0]['ms']:.4f} against "
                   f"{slow[0]['plain_ms']:.4f} ms")
    return rows


def replayed_frame(rig, frames, bad):
    """frames[:5] through a fresh VOPipeline(VOConfig(), every_frame): the
    prediction-mode temporal step warms on frame 2, is captured on frame 3
    and replays on frame 4. What frame 4 launched (`cuda_build.LAUNCHES`)
    and how its steps ran (`GRAPH_STEPS`); `bad` gets each count other
    than a replay of both steps and `FC.FRAME_LAUNCHES`."""
    from edge_based_visual_odometry_tpu_torch.config import VOConfig
    from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
    from tests import frame_calls as FC

    pipe = PL.VOPipeline(rig, VOConfig(), device="cuda",
                         keyframe_policy="every_frame")
    for left, right in frames[:4]:
        pipe.run_frame(left, right)
    CB.reset_launch_counts()
    pipe.run_frame(*frames[4])
    torch.cuda.synchronize()
    launches = dict(CB.LAUNCHES)
    steps = {s: dict(c) for s, c in CB.GRAPH_STEPS.items()}
    replay = dict(capture=0, replay=1, eager=0)
    if steps != {"stereo_step": replay, "temporal_step": replay}:
        bad.append(f"frame 4's steps did not replay once each: {steps}")
    for k, n in FC.FRAME_LAUNCHES.items():
        if launches[k] != n:
            bad.append(f"frame 4 launched {k} {launches[k]} times, not {n}")
    print(f"frame 4, replayed: launches {json.dumps(launches)}")
    return {"launches": launches, "graph_steps": steps}


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from edge_based_visual_odometry_tpu_torch.config import VOConfig
    from edge_based_visual_odometry_tpu_torch.io import synthetic as S
    from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
    from edge_based_visual_odometry_tpu_torch.ops import descriptors as DESC
    from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
    from edge_based_visual_odometry_tpu_torch.ops import patches as PAT
    from tests import frame_calls as FC

    # ---- 1. the card ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)    # card name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- 2. the build ----
    t0 = time.perf_counter()
    CB.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{CB.library_path().relative_to(CB.BUILD_DIR.parents[1])}")
    for ln in CB.ptxas_log().splitlines():
        if ln.startswith("==") or "entry function" in ln or "spill" in ln \
                or "Used" in ln:
            print("ptxas: " + ln.strip())

    # ---- 3. the frame replayed: its launches ----
    seq = S.make_sequence(n_frames=5, h=376, w=1241)
    frames = [tuple(np.round(a).clip(0, 255).astype(np.uint8)
                    for a in (f.left, f.right)) for f in seq.frames]
    bad = []
    replayed = replayed_frame(seq.rig, frames, bad)

    # ---- 4, 5. frame 2's calls, checked and timed ----
    rows = []
    for P, shift in ((7, None),) + WIDE_PATCHES:
        cfg = (VOConfig() if shift is None else
               VOConfig(patch_size=P, orthogonal_shift_mag=shift))
        pipe = PL.VOPipeline(seq.rig, cfg, device="cuda",
                             keyframe_policy="every_frame")
        calls, _ = FC.frame_calls(pipe, frames)
        rows += timed_rows(calls, P, FC.FRAME_CALLS if shift is None
                           else WIDE_KERNELS, card, bad)
        del pipe, calls
    rows += evaluation_compact_rows(seq.rig, frames, card, bad)
    occupancy = {"K3": GN.k3_info(), "K5": DESC.k5_info(),
                 "K6": PAT.k6_info(), "K7": PAT.k7_info()}
    for k, info in occupancy.items():
        print(f"{k} occupancy: {json.dumps(info)}")
    print(json.dumps({"rows": rows, "occupancy": occupancy, **replayed}))
    if bad:
        fail("; ".join(bad))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
