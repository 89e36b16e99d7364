#!/usr/bin/env python
"""Time K4 (csrc/cluster_edges.cu) on the card as it is against copies of
its source with one part changed, to see what each part of its design
buys. Every form is launched alone through its C entry, on operands
prepared once; forms in turns, in rounds.

    python scripts/k4_variants.py

Needs a CUDA device and nvcc (sm_90a). Builds into build/k4_variants/.
Input: the two `cluster_edges` calls (stereo, temporal) of frame 2 of
make_sequence(3, 376, 1241), rounded to uint8, through
VOPipeline(VOConfig()), the operands `chip_smoke.py` times.
Each form says whether its output equals the twin's bit for bit; the
forms marked "(timing only)" compute something else. Last, per call, the
wrapper `cluster_edges_cuda` (which allocates the outputs, checks the
operands and launches) as `chip_smoke.py` times it: its time a
call on the card (CUDA events) and on the host (enqueueing only).
"""

import ctypes
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402

from edge_based_visual_odometry_tpu_torch.config import VOConfig  # noqa: E402
from edge_based_visual_odometry_tpu_torch.io import synthetic as S  # noqa: E402
from edge_based_visual_odometry_tpu_torch.models import pipeline as PL  # noqa: E402
from edge_based_visual_odometry_tpu_torch.ops import clustering as CL  # noqa: E402
from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB  # noqa: E402

SRC = CB.CSRC / "cluster_edges.cu"
OUT = os.path.join(REPO, "build", "k4_variants")
REPS, ROUNDS = 50, 2

BLOCK = "constexpr int kWarps = 4;"
# name -> source patches [(text, replacement)], each text replaced
# wherever it stands (it must stand somewhere)
VARIANTS = {
    "as is": [],
    "every cross-slot loop over all C slots (the earlier trip count)": [
        ("s = act;", "s = all;"), ("groups(act,", "groups(all,"),
        ("const Mask S = plain ? all : act;", "const Mask S = all;"),
        ("adj[h] |= (Mask)e << k;",
         "adj[h] |= (Mask)(e && (act >> k & 1)) << k;")],
    "distances and weights per (group, slot) pair on every row": [
        ("    if (!plain) {", "    if (false) {")],
    "the sums over all C slots (no skipped masked terms)": [
        ("const bool plain = unbounded ||", "const bool plain = true ||")],
    "all rounds (no exit at a fixed point)": [
        ("if (!__any_sync(kAll, moved)) break;   // a fixed point", "")],
    "the cap's centroid and ranks on every row": [
        ("if (__reduce_max_sync(kAll, most) > cap) {",
         "if (__reduce_max_sync(kAll, most) >= 0) {")],
    "empty rows through the whole body": [("  if (act) {", "  if (true) {")],
    "8 warps a block": [(BLOCK, "constexpr int kWarps = 8;")],
    "16 warps a block": [(BLOCK, "constexpr int kWarps = 16;")],
    "no membership stores (timing only)": [
        ("*reinterpret_cast<uint4*>(mrow + b) = bytes16(memb[h], b);",
         "if (N < 0) *reinterpret_cast<uint4*>(mrow + b) = "
         "bytes16(memb[h], b);")],
    "only the loads and the stores (timing only)": [
        ("  if (act) {", "  if (N < 0) {")],
}


def build(name, patches):
    text = SRC.read_text()
    for old, new in patches:
        if old not in text:
            raise SystemExit(f"{name}: {old!r} is not in the source")
        text = text.replace(old, new)
    tag = "v%d" % list(VARIANTS).index(name)
    src = os.path.join(OUT, f"{tag}.cu")
    with open(src, "w") as f:
        f.write(text)
    so = os.path.join(OUT, f"{tag}.so")
    return subprocess.Popen([CB._nvcc(), *CB.NVCC_FLAGS, "-shared", "-o", so,
                             src], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), so


def frame2_calls(dev):
    """{kind: (args, kwargs)} of frame 2's two cluster_edges calls."""
    seq = S.make_sequence(3, 376, 1241)
    pipe = PL.VOPipeline(seq.rig, VOConfig(), device=dev,
                         keyframe_policy="every_frame")
    cluster, calls = CL.cluster_edges, {}

    def recording(*a, **kw):
        calls["temporal" if kw["by_orientation"] else "stereo"] = (a, kw)
        return cluster(*a, **kw)

    CL.cluster_edges = recording
    try:
        for f in seq.frames:
            pipe.run_frame(*(np.round(a).clip(0, 255).astype(np.float32)
                             for a in (f.left, f.right)))
    finally:
        CL.cluster_edges = cluster
    return calls


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    procs = {n: build(n, p) for n, p in VARIANTS.items()}
    calls = frame2_calls(dev)
    fns = {}
    for n, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{n}: nvcc failed\n{log}")
        used = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "Used" in ln]
        print(f"{n}: ptxas {used}")
        f = ctypes.CDLL(so).cluster_edges_launch
        f.argtypes = CB._SIGNATURES["cluster_edges_launch"]
        f.restype = ctypes.c_int
        fns[n] = f
    total = {n: [0.0] * ROUNDS for n in fns}
    for kind in ("stereo", "temporal"):
        (x, y, th, mask), kw = calls[kind]
        N, C = x.shape
        ref = CL.cluster_edges_plain(x, y, th, mask, **kw)
        outs = {n: [torch.empty_like(t) for t in ref] for n in fns}
        thresh, orient_rad, inv_sigma = CL._scalars(
            kw["dist_thresh"], kw["orient_thresh_deg"], kw["gauss_sigma"])

        def run(n):
            err = fns[n](x.data_ptr(), y.data_ptr(), th.data_ptr(),
                         mask.data_ptr(), N, C, thresh,
                         int(kw["by_orientation"]), orient_rad, inv_sigma,
                         kw["max_cluster_size"], CL._rounds(C),
                         *(t.data_ptr() for t in outs[n]), stream)
            if err:
                raise SystemExit(f"{n}: launch failed, CUDA error {err}")

        times = {n: [] for n in fns}
        for r in range(ROUNDS):                # rounds, forms in turn
            for n in fns:
                for _ in range(3):
                    run(n)
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(REPS):
                    run(n)
                t1.record()
                torch.cuda.synchronize()
                times[n].append(t0.elapsed_time(t1) / REPS)
                total[n][r] += times[n][-1]
        wrapped = CL.cluster_edges_cuda
        card_ms = [CS.cuda_ms(lambda: wrapped(x, y, th, mask, **kw), REPS)
                   for _ in range(ROUNDS)]
        t0 = time.perf_counter()
        for _ in range(REPS):
            wrapped(x, y, th, mask, **kw)
        host_ms = (time.perf_counter() - t0) * 1e3 / REPS
        torch.cuda.synchronize()
        base = np.mean(times["as is"])
        for n in fns:
            same = all(
                bool(((a.view(torch.int32) == b.view(torch.int32))
                      | (a.isnan() & b.isnan())).all())
                if a.is_floating_point() else torch.equal(a, b)
                for a, b in zip(outs[n], ref))
            print(f"{kind} call ({N} x {C}, {int(mask.sum())} active slots), "
                  f"{n}: {' / '.join(f'{t:.4f}' for t in times[n])} ms, "
                  f"{100 * np.mean(times[n]) / base:.1f}% of as is; "
                  f"{'bit-equal to' if same else 'differs from'} the twin")
        print(f"{kind} call, the wrapper: "
              f"{' / '.join(f'{t:.4f}' for t in card_ms)} ms a call on the "
              f"card, {host_ms:.4f} ms a call to enqueue on the host")
    base = np.mean(total["as is"])
    for n in fns:
        print(f"a frame's two calls, {n}: "
              f"{' / '.join(f'{t:.4f}' for t in total[n])} ms, "
              f"{100 * np.mean(total[n]) / base:.1f}% of as is")


if __name__ == "__main__":
    main()
