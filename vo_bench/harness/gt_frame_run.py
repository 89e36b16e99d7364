"""The `gt_frame` entry: the supervised pipeline (`has_gt_disparity`,
`use_gt_pose`) over the periodic scene, in a closed loop, as `cli.run`
drives an ETH3D sequence.

Set-up renders the scene and its ground-truth maps on the card
(`scene/gt_maps.py`: each frame's disparity, float32 with inf where no
plane is hit, and its uint8 non-occlusion map) and moves them to host
memory once. Each frame hands `run_frame` its uint8 images, its world ->
camera GT pose (float32) and its two maps, all as host arrays, as
`cli.run` hands a decoded ETH3D sample. The loop and the window are the
`frame` entry's (`frames.FrameCell`). A traced run times the steps in
the window, as the `frame` entry does, then profiles one slice of the
workload's `trace_frames` frames (24 by default) with the program's
spans on: the device trace (`busy_s`, `breakdown`, read by
`launches_per_frame` and `device_idle_pct`) and the program's spans
(`harness/spans.py`, read by `gt_upload_ms`) from one profile; the
per-span table goes to standard error. A lap later as many frames
again give the kernels' work (`kernels_roofline_pct`).

The check (`harness/gt_check.py`) keeps the frame cells' numbers and
adds the evaluation path's: the GT right locations and the Final rows of
both stage tables against the plain reference
(`reference/eval_rows.py`), and the stage rows logged in the window.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from vo_bench.harness import check as CHECK
from vo_bench.harness import frame_run as FRUN
from vo_bench.harness import frames as FR
from vo_bench.harness import gt_check as GC
from vo_bench.harness import kernels as KN
from vo_bench.harness import spans as SP
from vo_bench.harness import spec as SPEC
from vo_bench.harness import trace as TR
from vo_bench.scene import gt_maps as GM


class GtFrameCell(FR.FrameCell):
    """A `FrameCell` whose frames carry their GT maps and pose; a checked
    frame's record also keeps what the evaluation numbers read."""

    def __init__(self, cell: SPEC.Cell, seed: int, device):
        from edge_based_visual_odometry_tpu_torch import geometry as geom

        super().__init__(cell, seed, device)
        self.disparity, self.visible = GM.scene_maps(self.scene, device)
        self.gt_poses = [geom.Pose(R.astype(np.float32), t.astype(np.float32))
                         for R, t in zip(self.scene.R, self.scene.t)]
        self.frames_run = 0
        self.temporal_steps = 0
        self._last = None
        # the class's function: no cycle through the pipeline outlives `free`
        run = type(self.pipe).run_frame

        def run_frame(left, right):
            k = self.scene_index(self.pipe.frame_idx)
            self._last = run(self.pipe, left, right,
                             disparity=self.disparity[k],
                             gt_pose=self.gt_poses[k],
                             occlusion=self.visible[k])
            return self._last
        self.pipe.run_frame = run_frame

    def warm_up(self):
        """The workload's `min_frames` frames: both steps warmed up and
        captured (with the GT pose the temporal step has no bootstrap or
        prediction variant). A temporal step that fails is not refused
        here: the window's check counts the frames that fail."""
        for _ in range(int(self.cell.workload["warmup"]["min_frames"])):
            self.frame()
        FR.sync(self.device)

    def frame(self, slot=None):
        kf = self.pipe.keyframe
        out = super().frame(slot)
        fr, tr = self._last
        if slot is not None and tr is not None:
            m, q = fr.mates, tr.quads
            red = getattr(fr, "right_edges", None)
            if red is None:        # a step that does not return them
                edges, images = None, (fr.frame.left, fr.frame.right)
            else:
                edges, images = (red.x, red.y, red.theta, red.valid), None
            self.records[slot].update(
                stereo_row=self.frames_run, temporal_row=self.temporal_steps,
                right_edges=edges, images=images,
                lr_mates=(m.left_x, m.left_y, m.left_theta, m.right_x,
                          m.right_y, m.valid),
                gt=(m.left_x, m.left_y, m.gt_x, m.gt_y, m.valid),
                kf_mates=_mates7(kf.mates), cf_mates=_mates7(m),
                quads_lr=(q.lcx, q.lcy, q.rcx, q.rcy, q.cmask))
        self.frames_run += 1
        self.temporal_steps += int(tr is not None)
        return out


def _mates7(m):
    return (m.left_x, m.left_y, m.left_theta, m.right_x, m.right_y,
            m.right_theta, m.valid)


def traced_slice(cell: GtFrameCell, device, frames: int):
    """`frames` frames profiled with the program's spans on, then, one
    lap of the scene later, as many frames again with the kernels'
    operands kept, as `frame_run.traced_slices` does: (the device trace
    as `trace.profile` reduces it, the program's spans, the kernels'
    work, none on the CPU)."""
    from edge_based_visual_odometry_tpu_torch.utils import timing

    def run():
        with timing.spans_on():
            for _ in range(frames):
                cell.frame()
        return frames
    events, window_s, units = SP.profile_events(run, device)
    tr = TR.parse(events)
    tr.update(window_s=window_s, units=units)
    if torch.device(device).type != "cuda":       # no kernel runs
        return tr, SP.reduce(events, window_s, units), {}
    for _ in range(max(0, cell.n - frames)):
        cell.frame()
    with KN.WorkRecorder() as rec:
        for _ in range(frames):
            cell.frame()
    return tr, SP.reduce(events, window_s, units), rec.work()


def run(spec: SPEC.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device=None) -> dict:
    """The result of one run; `device` is the card, cuda:0, unless a CPU
    test passes the CPU (whose runs are never results)."""
    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB

    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cell = GtFrameCell(spec, seed, dev)
    cell.warm_up()
    if trace:
        cell.time_steps()
    CB.reset_launch_counts()
    rows0, frames0 = GC.rows_logged(cell.pipe), cell.frames_run
    setup_s = time.perf_counter() - t_start

    times, attempted, failed = cell.window(seconds)

    launches = dict(CB.LAUNCHES)
    steps = {k: dict(v) for k, v in CB.GRAPH_STEPS.items()}
    missing = (2 * (cell.frames_run - frames0)
               - (GC.rows_logged(cell.pipe) - rows0))
    result = {"correct": False, "attempted": attempted, "failed": failed}
    if trace:
        cell.untime_steps()
        frames = int(spec.workload.get("trace_frames", FRUN.SLICE_FRAMES))
        tr, ps, work = traced_slice(cell, dev, frames)
        print(SP.table(ps), file=sys.stderr)
        ctx = dict(spans=cell.spans, window_frames=attempted, trace=tr,
                   program_spans=ps, work=work, work_units=frames)
        metrics = SPEC.per_layer_metrics(spec, ctx)
    else:
        metrics = {
            "frames_per_s": {"value": FR.frames_per_window(times, seconds),
                             "unit": "frames/s"},
            "frame_ms_p95": {"value": FR.p95_ms(times), "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {k: v for k, v in metrics.items()
                   if any(m["name"] == k for m in spec.end_to_end)}
    device_out = FRUN.device_info(1, dev)
    if trace:
        device_out.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    logs = (cell.pipe.stereo_metrics_log, cell.pipe.temporal_metrics_log)
    cfg = cell.pipe.cfg
    scene, index = cell.scene, cell.scene_index
    cell.free()

    GC.add_right_edges(cell.records, cfg)
    numbers = GC.frame_numbers(scene, cell.records, logs, GC.rules(cfg), None,
                               index, dev, spec.workload["pose_quantile"])
    numbers["eval_rows_missing"] = missing
    correct, checks = CHECK.judge(numbers, spec.workload.get("check", {}),
                                  failed)
    not_launched = ([k for k, v in launches.items() if v == 0]
                    if dev.type == "cuda" else [])
    checks["kernels_not_launched"] = {"value": len(not_launched), "limit": 0}
    print(f"graph steps in the window: {steps}", file=sys.stderr)
    result.update(correct=correct and not not_launched, metrics=metrics,
                  device=device_out, checks=checks)
    if trace:
        result["breakdown"] = tr["breakdown"]
    return result
