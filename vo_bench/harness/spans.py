"""The program's own spans in a profiled slice, reduced span by span.

The port names each stage of its frame path with `utils/timing.span`
(`vo/<name>` user annotations in a `torch.profiler` trace, on the same
clock as the kernels; off unless `timing.spans_on()`). The spans slice
runs one lap of the periodic scene after an earlier slice, so that it
sees the same scene frames, under the profiler with spans on
(`spans_slice`). `reduce` turns its Chrome trace into `program_spans`,
the run context's key that the stage and frame readers
(`metrics/detect_edges_ms.py` .. `metrics/hidden_syncs_per_frame.py`)
read:

- each span name's calls, wall time and self time (its time less its
  children's), over its instances;
- the device operations it launched from its self part (kernels,
  memcpys, memsets, joined to the host call that launched them by the
  trace's correlation id; `launches` counts those host calls) and their
  device time;
- the device's idle time: each gap between device operations goes to
  the innermost span open on the program's thread at the gap's middle;
  a gap inside `vo/frame` with no stage open is `frame`'s own; a gap
  outside every span is "outside the program" (the benchmark's loop,
  such as its copy of each pose to the host);
- the synchronising CUDA calls (`SYNC_CALLS`), each inside a declared
  wait (a `wait.*` span or one inside it) or hidden.

A trace of a program without spans reduces to no frames, and every
reader then returns None.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from vo_bench.harness import trace as TR

PREFIX = "vo/"
FRAME = "frame"
OUTSIDE = "outside the program"
HOST_CATS = ("cuda_runtime", "cuda_driver")
# the CUDA calls counted as the host waiting for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
              "cuCtxSynchronize", "cuEventSynchronize")
# the readers of `program_spans` under `metrics/`
METRICS = ("detect_edges_ms", "match_stereo_ms", "match_temporal_ms",
           "lift_quads_ms", "estimate_pose_ms", "host_wait_ms",
           "hidden_syncs_per_frame")
COLUMNS = ("calls", "wall_s", "self_s", "launches", "device_s", "idle_s",
           "syncs", "hidden_syncs")


def profile_events(run, device):
    """Run `run()` (returns its frames) under the profiler, as
    `trace.profile` does; returns (the trace's events, the slice's wall
    seconds, its frames)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    path = os.path.join(tempfile.gettempdir(),
                        f"vo_bench_spans_{os.getpid()}.json")
    with prof_ctx(activities=acts) as prof:
        t0 = time.perf_counter()
        units = run()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return events, window_s, units


def spans_slice(cell, device, skip: int, frames: int) -> dict:
    """`skip` frames of the cell (`frames.FrameCell`), then `frames`
    frames profiled with the program's spans on; returns `reduce`'s
    result."""
    from edge_based_visual_odometry_tpu_torch.utils import timing

    for _ in range(skip):
        cell.frame()

    def run():
        with timing.spans_on():
            for _ in range(frames):
                cell.frame()
        return frames
    events, window_s, units = profile_events(run, device)
    return reduce(events, window_s, units)


class _Span:
    __slots__ = ("name", "t0", "t1", "parent", "child_s", "frame", "wait")

    def __init__(self, e):
        self.name = e["name"][len(PREFIX):]
        self.t0 = float(e["ts"])
        self.t1 = self.t0 + float(e["dur"])
        self.parent = None
        self.child_s = 0.0
        self.frame = False        # inside (or is) a `frame` span
        self.wait = False         # inside (or is) a `wait.*` span


def _nest(spans):
    """Parents (the innermost enclosing span), sorted by start."""
    spans.sort(key=lambda s: (s.t0, -s.t1))
    stack = []
    for s in spans:
        while stack and stack[-1].t1 <= s.t0:
            stack.pop()
        s.parent = stack[-1] if stack else None
        if s.parent is not None:
            s.parent.child_s += s.t1 - s.t0
        p = s.parent
        s.frame = s.name == FRAME or (p is not None and p.frame)
        s.wait = s.name.startswith("wait.") or (p is not None and p.wait)
        stack.append(s)
    return spans


def _innermost(spans, points):
    """For each time in `points` (sorted), the innermost span open at it,
    or None; `spans` nested and sorted by start."""
    out, stack, j = [], [], 0
    for t in points:
        while j < len(spans) and spans[j].t0 <= t:
            while stack and stack[-1].t1 <= spans[j].t0:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1].t1 <= t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def reduce(events, window_s=None, units=None) -> dict:
    """`program_spans` of one slice's Chrome trace events (see the
    module's docstring). Times in seconds; `rows` by span name, with
    `OUTSIDE` for what falls outside every span; `parents` each name's
    parent name where first seen."""
    spans, host, dev = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            spans.append(_Span(e))
        elif cat in HOST_CATS:
            host.append(e)
        elif cat in TR.DEVICE_CATS:
            dev.append(e)
    spans = _nest(spans)
    threads = {(e["pid"], e["tid"]) for e in events
               if e.get("cat") == "user_annotation"
               and e.get("name", "").startswith(PREFIX)}
    rows = defaultdict(lambda: dict.fromkeys(COLUMNS, 0))
    parents = {}
    for s in spans:
        r = rows[s.name]
        r["calls"] += 1
        r["wall_s"] += (s.t1 - s.t0) * 1e-6
        r["self_s"] += (s.t1 - s.t0 - s.child_s) * 1e-6
        parents.setdefault(s.name, None if s.parent is None
                           else s.parent.name)

    def row_of(sp):
        return rows[OUTSIDE] if sp is None else rows[sp.name]

    # host calls on the program's thread, placed at their middle
    host.sort(key=lambda e: e["ts"] + 0.5 * e["dur"])
    mids = [e["ts"] + 0.5 * e["dur"] for e in host]
    owner = _innermost(spans, mids)
    by_corr = {}
    syncs = dict(declared=0, hidden=0, outside=0)
    for e, sp in zip(host, owner):
        if (e.get("pid"), e.get("tid")) not in threads:
            sp = None
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            by_corr.setdefault(corr, sp)
        if e["name"] in SYNC_CALLS:
            r = row_of(sp)
            r["syncs"] += 1
            if sp is None or not sp.frame:
                syncs["outside"] += 1
            elif sp.wait:
                syncs["declared"] += 1
            else:
                syncs["hidden"] += 1
                r["hidden_syncs"] += 1
    unattributed = dict(device_ops=0, device_s=0.0)
    launched = defaultdict(set)
    for e in dev:
        corr = (e.get("args") or {}).get("correlation")
        if corr not in by_corr:
            unattributed["device_ops"] += 1
            unattributed["device_s"] += e["dur"] * 1e-6
            continue
        sp = by_corr[corr]
        key = OUTSIDE if sp is None else sp.name
        rows[key]["device_s"] += e["dur"] * 1e-6
        launched[key].add(corr)
    for key, corrs in launched.items():
        rows[key]["launches"] += len(corrs)

    # the device's idle gaps, each to the span open at its middle
    merged = TR._union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                        for e in dev])
    gaps = [(g0, g1) for (_, g0), (g1, _) in zip(merged, merged[1:])]
    gap_owner = _innermost(spans, [0.5 * (g0 + g1) for g0, g1 in gaps])
    idle = dict(in_frames_s=0.0, frame_self_s=0.0, outside_s=0.0)
    for (g0, g1), sp in zip(gaps, gap_owner):
        s = (g1 - g0) * 1e-6
        row_of(sp)["idle_s"] += s
        if sp is not None and sp.frame:
            idle["in_frames_s"] += s
            if sp.name == FRAME:
                idle["frame_self_s"] += s
        else:
            idle["outside_s"] += s
    waits = [s for s in spans
             if s.name.startswith("wait.") and s.frame
             and not (s.parent is not None and s.parent.wait)]
    return dict(frames=rows[FRAME]["calls"] if FRAME in rows else 0,
                window_s=window_s, units=units, rows=dict(rows),
                parents=parents, idle=idle, syncs=syncs,
                sync_calls=list(SYNC_CALLS), unattributed=unattributed,
                wait_s=sum(s.t1 - s.t0 for s in waits) * 1e-6)


def per_frame(ctx, value):
    """`value(program_spans)` over the slice's frames, or None where the
    context has no spans (or `value` finds nothing)."""
    ps = (ctx or {}).get("program_spans")
    if not ps or not ps.get("frames"):
        return None
    v = value(ps)
    return None if v is None else v / ps["frames"]


def stage_ms(ctx, name):
    """A span's wall time a frame, in ms (None without that span)."""
    def wall(ps):
        row = ps["rows"].get(name)
        return None if row is None else 1e3 * row["wall_s"]
    return per_frame(ctx, wall)


def coverage(ps) -> float | None:
    """The share of the device's idle time inside `vo/frame` that falls
    in a stage, sub-stage or wait rather than in `frame`'s own time."""
    total = ps["idle"]["in_frames_s"]
    if not total:
        return None
    return 1.0 - ps["idle"]["frame_self_s"] / total


def _order(ps):
    """Span names depth first, children in the order first seen, with
    their depth; `OUTSIDE` last."""
    kids = defaultdict(list)
    for name, parent in ps["parents"].items():
        kids[parent].append(name)
    out = []

    def walk(parent, depth):
        for name in kids.get(parent, []):
            out.append((name, depth))
            walk(name, depth + 1)
    walk(None, 0)
    if OUTSIDE in ps["rows"]:
        out.append((OUTSIDE, 0))
    return out


def table(ps) -> str:
    """The per-span table a frame: calls, wall, self, launches, device
    and idle time (ms), synchronising calls (hidden ones apart)."""
    n = ps.get("frames") or 0
    if not n:
        return "program spans: none in the slice"
    head = (f"{'span (a frame)':<32} {'calls':>6} {'wall ms':>8} "
            f"{'self ms':>8} {'launch':>7} {'dev ms':>7} {'idle ms':>8} "
            f"{'syncs':>6} {'hidden':>6}")
    lines = [head]
    for name, depth in _order(ps):
        r = ps["rows"][name]
        lines.append(
            f"{'  ' * depth + name:<32} {r['calls'] / n:>6.2f} "
            f"{1e3 * r['wall_s'] / n:>8.3f} {1e3 * r['self_s'] / n:>8.3f} "
            f"{r['launches'] / n:>7.1f} {1e3 * r['device_s'] / n:>7.3f} "
            f"{1e3 * r['idle_s'] / n:>8.3f} {r['syncs'] / n:>6.2f} "
            f"{r['hidden_syncs'] / n:>6.2f}")
    cov = coverage(ps)
    idle = ps["idle"]
    lines.append(
        f"frames {n}; idle in frames {1e3 * idle['in_frames_s'] / n:.3f} "
        f"ms a frame, {'-' if cov is None else f'{100 * cov:.1f}%'} of it "
        f"in a stage or wait; outside the program "
        f"{1e3 * idle['outside_s'] / n:.3f} ms; syncs a frame: declared "
        f"{ps['syncs']['declared'] / n:.2f}, hidden "
        f"{ps['syncs']['hidden'] / n:.2f}, outside "
        f"{ps['syncs']['outside'] / n:.2f} (counted: "
        f"{', '.join(ps['sync_calls'])}); device ops with no host call "
        f"{ps['unattributed']['device_ops']}")
    return "\n".join(lines)
