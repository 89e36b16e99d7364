"""Per-stage timing report.

Port of `edge_based_visual_odometry_tpu/utils/timing.py`. CUDA work is
asynchronous: host-side wall timing of a call measures its dispatch
unless the device is waited for. `StageTimer.timed` synchronises the CUDA
device before and after the stage, so stage times are end-to-end wall
clock (including device execution). For kernel-level breakdowns use
`device_trace` (torch.profiler).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List

import torch


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@dataclasses.dataclass
class StageTimer:
    """Accumulates per-stage wall times across frames."""

    times: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def timed(self, name: str, fn, *args, **kwargs):
        """Run fn, wait for the device, record the wall time."""
        _sync()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync()
        self.times.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def report(self) -> str:
        lines = [f"{'Stage':>28} | {'mean ms':>10} | {'total s':>9} | {'n':>5}"]
        total = 0.0
        for name, ts in self.times.items():
            mean = sum(ts) / len(ts)
            tot = sum(ts)
            total += tot
            lines.append(f"{name:>28} | {mean * 1e3:>10.3f} | {tot:>9.3f} | "
                         f"{len(ts):>5}")
        lines.append(f"{'TOTAL':>28} | {'':>10} | {total:>9.3f} |")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the CPU and, where it exists, the CUDA
    device; the Chrome trace is written to <log_dir>/trace.json. Yields
    the profiler (read `key_averages()` after the block)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        _sync()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
