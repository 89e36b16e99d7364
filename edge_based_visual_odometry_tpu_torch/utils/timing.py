"""Per-stage timing report.

Port of `edge_based_visual_odometry_tpu/utils/timing.py`. CUDA work is
asynchronous: host-side wall timing of a call measures its dispatch
unless the device is waited for. `StageTimer.timed` synchronises the CUDA
device before and after the stage, so stage times are end-to-end wall
clock (including device execution). For kernel-level breakdowns use
`device_trace` (torch.profiler).

`span(name)` names a stage of the frame path on the profiler's clock
without waiting for the device: while spans are on (`spans_on()`, and
for the length of `device_trace`) it enters
`torch.profiler.record_function("vo/" + name)`, so a trace holds each
span as a `user_annotation` event beside the kernels it launched; while
they are off (the default) it returns one shared no-op context, which
makes no dispatcher call, reads no clock and allocates nothing. Spans
nest on the calling thread. A span named `wait.<what>` marks a place
where the program deliberately blocks on the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional

import torch

SPAN_PREFIX = "vo/"
_spans = False          # whether span() records; see spans_on()
_NO_SPAN = contextlib.nullcontext()     # what span() returns while off


def span(name: str, args=None):
    """A context naming a stage `vo/<name>` in the profiler's trace while
    spans are on; `args` (e.g. the frame index) goes with the annotation
    as a string. While spans are off, the shared no-op context."""
    if not _spans:
        return _NO_SPAN
    return torch.profiler.record_function(
        SPAN_PREFIX + name, None if args is None else str(args))


@contextlib.contextmanager
def spans_on():
    """Spans on inside the block; the state before it is restored on
    exit."""
    global _spans
    prev, _spans = _spans, True
    try:
        yield
    finally:
        _spans = prev


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
    device, with the program's spans on (`span`); the Chrome trace is
    written to <log_dir>/trace.json. Yields the profiler (read
    `device_ops(prof, ...)` after the block)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    with spans_on():
        prof.start()
        try:
            yield prof
        finally:
            _sync()
            prof.stop()
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_ops(prof, device_type):
    """The rows of `prof.key_averages()` that ran on `device_type` (a
    `torch.autograd.DeviceType`): ops, kernels and copies, without the
    spans' annotations, each of which covers the ops beneath it and
    would count them again."""
    return [e for e in prof.key_averages()
            if e.device_type == device_type and not e.is_user_annotation]
