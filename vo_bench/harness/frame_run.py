"""One run of a `frame` cell: set-up, the measured window, the traced
slices (with `--trace 1`), then the check against the reference."""

from __future__ import annotations

import time

import torch

from vo_bench.harness import check as CHECK
from vo_bench.harness import frames as FR
from vo_bench.harness import kernels as KN
from vo_bench.harness import spec as SPEC
from vo_bench.harness import trace as TR

SLICE_FRAMES = 24        # frames of the profiled slice and the work slice


def device_info(n: int, device) -> dict:
    if device.type != "cuda":            # the CPU tests' runs, no result
        return {"platform": "cpu", "kind": "cpu", "count": n,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": n,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def traced_slices(cell: FR.FrameCell, device):
    """The profiled slice, then, one lap of the scene later, as many
    frames again with the kernels' operands kept (their work)."""
    def profiled():
        for _ in range(SLICE_FRAMES):
            cell.frame()
        return SLICE_FRAMES
    trace = TR.profile(profiled, device)
    for _ in range(max(0, cell.n - SLICE_FRAMES)):
        cell.frame()
    with KN.WorkRecorder() as rec:
        for _ in range(SLICE_FRAMES):
            cell.frame()
    return trace, rec.work()


def run(spec: SPEC.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device=None) -> dict:
    """The result of one run; `device` is the card, cuda:0, unless a CPU
    test passes the CPU (whose runs are never results)."""
    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB

    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cell = FR.FrameCell(spec, seed, dev)
    cell.warm_up()
    if trace:
        cell.time_steps()
    ba0 = len(cell.pipe.ba_info_log)
    CB.reset_launch_counts()
    setup_s = time.perf_counter() - t_start

    times, attempted, failed = cell.window(seconds)

    launches = dict(CB.LAUNCHES)
    ba_infos = cell.pipe.ba_info_log[ba0:]
    ba_solves = list(cell.ba_solves) if cell.pipe.wba is not None else None
    result = {"correct": False, "attempted": attempted, "failed": failed}
    if trace:
        cell.untime_steps()
        tr, work = traced_slices(cell, dev)
        ctx = dict(spans=cell.spans, ba_infos=ba_infos,
                   window_frames=attempted, trace=tr, work=work,
                   work_units=SLICE_FRAMES)
        metrics = SPEC.per_layer_metrics(spec, ctx)
    else:
        metrics = {
            "frames_per_s": {"value": FR.frames_per_window(times, seconds),
                             "unit": "frames/s"},
            "frame_ms_p95": {"value": FR.p95_ms(times), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {k: v for k, v in metrics.items()
                   if any(m["name"] == k for m in spec.end_to_end)}
    device = device_info(1, dev)
    if trace:
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    scene, index = cell.scene, cell.scene_index
    cell.free()

    numbers = CHECK.frame_numbers(scene, cell.records, ba_solves, index, dev,
                                  spec.workload["pose_quantile"])
    correct, checks = CHECK.judge(numbers, spec.workload.get("check", {}),
                                  failed)
    missing = ([k for k, v in launches.items() if v == 0]
               if dev.type == "cuda" else [])
    checks["kernels_not_launched"] = {"value": len(missing), "limit": 0}
    correct = correct and not missing
    result.update(correct=correct, metrics=metrics, device=device)
    if trace:
        result["breakdown"] = tr["breakdown"]
    result["checks"] = checks
    return result
