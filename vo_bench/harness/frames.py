"""The `frame` entry: `VOPipeline.run_frame` over the periodic scene, in a
closed loop.

Set-up renders the scene on the card, moves its uint8 frames to host
memory once and warms the pipeline up on the scene's first frames (the
bootstrap temporal step, the prediction step and, with windowed BA, a
first solve). The window continues the same pipeline: each frame's
images are handed to `run_frame` as host arrays, as a dataset loader
would hand them, and its time runs until its world -> camera pose is on
the host. The next frame goes in when the pose is back.

A reservoir sample of the window's frames, drawn from the seed, keeps
what the check compares (`check.frame_numbers`): the frame's mates, its
quads and the keyframe's mate rows they align with, its relative pose,
its counts of lifted quads and inliers; and every windowed-BA solve its
refined keyframe poses.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from vo_bench.harness import spec as SPEC
from vo_bench.scene import render as RS

SAMPLE = 32     # window frames checked: a reservoir sample drawn from the
               # seed, so that the records held stay few and the caching
               # allocator reuses what an evicted record frees


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class FrameCell:
    def __init__(self, cell: SPEC.Cell, seed: int, device):
        from edge_based_visual_odometry_tpu_torch.models import pipeline as PL

        self.cell, self.seed, self.device = cell, int(seed), device
        self.rig = RS.Rig.from_config(cell.config["rig"])
        self.scene = RS.make_scene(self.rig, cell.scene, device)
        self.n = self.scene.left.shape[0]
        self.k0 = self.seed % self.n        # the seed's start on the lap
        self.pipe = PL.VOPipeline(
            SPEC.stereo_rig(cell.config), SPEC.vo_config(cell.config, seed),
            device=device, **cell.workload.get("pipeline", {}))
        self.spans = None                 # step spans, traced runs only
        self.ba_solves = []               # (frame indices, poses) a solve
        self.rng = np.random.default_rng(self.seed)
        self.records = []
        if self.pipe.wba is not None:
            self._watch_ba()

    # ---- the loop ----
    def scene_index(self, frame_idx: int) -> int:
        return (self.k0 + frame_idx) % self.n

    def frame(self, slot: Optional[int] = None):
        """One frame through `run_frame`; returns (pose on the host as a
        (12,) float32 array, whether the frame failed). With `slot`, what
        the check compares is kept in that slot of the records."""
        pipe = self.pipe
        i = pipe.frame_idx
        k = self.scene_index(i)
        kf, kf_idx = pipe.keyframe, pipe.kf_index
        fr, tr = pipe.run_frame(self.scene.left[k], self.scene.right[k])
        pose = pipe.trajectory[-1]
        host = torch.cat([pose.R.reshape(-1), pose.t.reshape(-1)]).cpu()
        host = host.numpy()
        failed = (tr is not None and not bool(tr.success)) or not bool(
            np.isfinite(host).all())
        if slot is not None and tr is not None:
            m, q = fr.mates, tr.quads
            rec = dict(
                k=k, kf=self.scene_index(kf_idx),
                mates=(m.left_x, m.left_y, m.right_x, m.right_y, m.valid),
                kf_rows=(kf.mates.left_x, kf.mates.left_y),
                quads=(q.lcx, q.lcy, q.lct, q.cmask, q.ncc_l),
                R=tr.R, t=tr.t, failed=failed,
                ratio=tr.inlier_ratio, n_quads=tr.n_quads,
                inliers=tr.inlier_count)
            if slot < len(self.records):
                self.records[slot] = rec
            else:
                self.records.append(rec)
        return host, failed

    def slot(self, i: int) -> Optional[int]:
        """Window frame i's record slot, or None: a reservoir sample of
        `SAMPLE` frames (each frame of the window equally likely)."""
        if i < SAMPLE:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < SAMPLE else None

    def warm_up(self):
        """Frames until the bootstrap step, the prediction step and (with
        windowed BA) a first solve have run."""
        w = self.cell.workload.get("warmup", {})
        n_min, n_max = int(w.get("min_frames", 4)), int(w.get("max_frames", 4))
        for _ in range(n_max):
            self.frame()
            if (self.pipe.frame_idx >= n_min and self.pipe._have_velocity
                    and (self.pipe.wba is None or self.ba_solves)):
                break
        if not self.pipe._have_velocity:
            raise RuntimeError("warm-up: no temporal step succeeded")
        if self.pipe.wba is not None and not self.ba_solves:
            raise RuntimeError(f"warm-up: no windowed-BA solve in "
                               f"{self.pipe.frame_idx} frames")
        sync(self.device)
        self.ba_solves.clear()

    def window(self, seconds: float):
        """Frames for `seconds`; returns (times of the frames whose pose
        came back inside the window, frames attempted, frames failed)."""
        times: List[float] = []
        failed = attempted = 0
        t_end = time.perf_counter() + seconds
        i = 0
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end:
                break
            _, bad = self.frame(self.slot(i))
            t1 = time.perf_counter()
            i += 1
            if t1 > t_end:
                break
            times.append(t1 - t0)
            attempted += 1
            failed += int(bad)
        return times, attempted, failed

    # ---- what the traced run adds ----
    def time_steps(self):
        """Synchronised spans around the pipeline's step callables (the
        stereo step; both temporal steps, the bootstrap's included)."""
        self.spans = {"stereo_step": [], "temporal_step": []}
        pipe = self.pipe
        dev = self.device
        self._steps = (pipe._stereo_step, pipe._temporal_step,
                       pipe._temporal_step_boot)

        def spanned(fn, name):
            def run(*a, **kw):
                sync(dev)
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                sync(dev)
                self.spans[name].append(time.perf_counter() - t0)
                return out
            return run
        boot_same = pipe._temporal_step_boot is pipe._temporal_step
        pipe._stereo_step = spanned(pipe._stereo_step, "stereo_step")
        pipe._temporal_step = spanned(pipe._temporal_step, "temporal_step")
        pipe._temporal_step_boot = (
            pipe._temporal_step if boot_same else
            spanned(pipe._temporal_step_boot, "temporal_step"))

    def untime_steps(self):
        """The step callables as they were before `time_steps`."""
        p = self.pipe
        p._stereo_step, p._temporal_step, p._temporal_step_boot = self._steps

    def _watch_ba(self):
        wba = self.pipe.wba
        run = wba.run

        def watched():
            out = run()
            if out is not None:
                poses, _ = out
                ks = self.pipe._ba_kf_frames
                m = min(len(ks), len(poses))
                self.ba_solves.append((list(ks[-m:]), poses[-m:]))
            return out
        wba.run = watched

    def free(self):
        """Drop the program's state (the records keep their tensors)."""
        self.pipe = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()


def frames_per_window(times: List[float], seconds: float) -> float:
    return len(times) / seconds


def p95_ms(times: List[float]) -> Optional[float]:
    if not times:
        return None
    return float(np.percentile(np.asarray(times) * 1e3, 95))
