"""A `torch.profiler` trace of a short steady slice, reduced to what the
per-layer metrics and the result's `device` and `breakdown` read.

The Chrome trace goes to a file under TMPDIR, is read back and deleted.
Device operations are the trace's kernels, memcpys and memsets; busy
time is the union of their intervals, the window the slice's wall time
on the host clock; an idle gap is named by the host operation (the
longest one open at the gap's middle) the host was in.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

import torch

from vo_bench.harness import kernels as KN

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


def profile(run, device) -> dict:
    """Run `run()` (the slice) under the profiler; returns the parsed
    trace (see `parse`)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx

    torch.cuda.synchronize(device)
    path = os.path.join(tempfile.gettempdir(),
                        f"vo_bench_trace_{os.getpid()}.json")
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        units = run()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = parse(events)
    out.update(window_s=window_s, units=units)
    return out


def _union(iv):
    iv = sorted(iv)
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def parse(events) -> dict:
    """busy_s, device operations (count, seconds by name and by K1-K9,
    NCCL seconds) and the idle gaps named by the host's operation."""
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in HOST_CATS:
            host.append(e)
    by_name = defaultdict(float)
    by_k = defaultdict(float)
    nccl = 0.0
    iv = []
    for e in dev:
        s = e["dur"] * 1e-6
        by_name[e["name"][:120]] += s
        k = KN.kernel_of(e["name"])
        if k is not None:
            by_k[k] += s
        if "nccl" in e["name"].lower():
            nccl += s
        iv.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    merged = _union(iv)
    busy_s = sum(b - a for a, b in merged) * 1e-6
    gaps = defaultdict(float)
    host.sort(key=lambda e: e["ts"])
    open_ops, j = [], 0            # host operations begun by the gap's middle
    for (_, g0), (g1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (g0 + g1)
        while j < len(host) and host[j]["ts"] <= mid:
            open_ops.append(host[j])
            j += 1
        open_ops = [e for e in open_ops if e["ts"] + e["dur"] >= mid]
        name = (max(open_ops, key=lambda e: e["dur"])["name"][:120]
                if open_ops else "no host operation")
        gaps[name] += (g1 - g0) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(   # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(busy_s=busy_s, device_ops=len(dev), by_kernel=dict(by_k),
                nccl_s=nccl, breakdown=dict(device_ops=top(by_name),
                                            idle_gaps=top(gaps)))
