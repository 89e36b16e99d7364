#!/usr/bin/env python
"""Time K7 (csrc/edge_patches.cu) on the card as it is against copies of
its source with one part changed: one sample a thread a step (the
sweep's first form), the twin's floor / ceil ok test, the edges a block,
a register cap. Every form runs through the port's own wrapper
(`edge_patches_cuda`) bound to the form's library, and is timed as
launches alone: 20 calls captured in one CUDA graph
(`chip_smoke.graph_ms`). Forms in turns, in rounds.

    python scripts/k7_variants.py

Needs a CUDA device and nvcc (sm_90a). Builds into build/k7_variants/.
Input: the four `edge_patches` calls of frame 2's stereo step of
make_sequence(3, 376, 1241), rounded to uint8, through
VOPipeline(VOConfig()) (left edges, right edges, stage 11's centres with
its live mask, the final mates), the operands `chip_smoke.py`
times. Each form says whether its outputs equal the twin's bit for bit
(on the live edges).
"""

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402

from edge_based_visual_odometry_tpu_torch.config import VOConfig  # noqa: E402
from edge_based_visual_odometry_tpu_torch.io import synthetic as S  # noqa: E402
from edge_based_visual_odometry_tpu_torch.models import pipeline as PL  # noqa: E402
from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB  # noqa: E402
from edge_based_visual_odometry_tpu_torch.ops import patches as PAT  # noqa: E402

SRC = CB.CSRC / "edge_patches.cu"
OUT = os.path.join(REPO, "build", "k7_variants")
REPS, ROUNDS = 20, 3
NAMES = ("left edges", "right edges", "stage-11 centres", "mates")

EDGES = "constexpr int kEdges = 32;           // edges a block"
BOUNDS = "__global__ void __launch_bounds__(kThreads)\nedge_patches_kernel"
OK_TEST = ("        if (!(px >= 0.0f && py >= 0.0f && px <= xmax && py <= "
           "ymax))")
SWEEP = SRC.read_text()[SRC.read_text().index("  // thread tid takes sample "
                                              "pairs"):
                        SRC.read_text().index("  __syncthreads();\n  if (tid "
                                              "< 2 * n_edges)")]
ONE_A_STEP = """  const int total = n_edges * n2;
  int e = tid / n2, s = tid - e * n2;
  const int step_e = kThreads / n2, step_s = kThreads - step_e * n2;
  float* const base = out + (size_t)e0 * n2;
#pragma unroll 4
  for (int f = tid; f < total; f += kThreads) {
    if (alive[e]) {
      const EdgeTerms& t = edge[e];
      const float oi = off_i[s], oj = off_j[s];
      const bool plus = plus_side[s];
      const float cx = plus ? t.cxp : t.cxm;
      const float cy = plus ? t.cyp : t.cym;
      const float px = sub(add(cx, mul(t.ct, oi)), mul(t.st, oj));
      const float py = add(add(cy, mul(t.st, oi)), mul(t.ct, oj));
      base[f] = gn::read_global(img,
                                gn::make_tap(px, py, t.ox, t.oy, t1, H, W));
      if (!(floorf(px) >= 0.0f && floorf(py) >= 0.0f && ceilf(px) <= xmax
            && ceilf(py) <= ymax))
        atomicOr(&bad[e], plus ? 1u : 2u);
    }
    s += step_s;
    e += step_e;
    if (s >= n2) {
      s -= n2;
      ++e;
    }
  }
"""
# name -> source patches [(text, replacement)], each text replaced
# wherever it stands (it must stand somewhere)
VARIANTS = {
    "as is": [],
    "one sample a thread a step, floor / ceil ok test (the first sweep)": [
        (SWEEP, ONE_A_STEP)],
    "the ok test through floor and ceil (the twin's form)": [
        (OK_TEST, "        if (!(floorf(px) >= 0.0f && floorf(py) >= 0.0f "
                  "&& ceilf(px) <= xmax && ceilf(py) <= ymax))")],
    "16 edges a block": [(EDGES, EDGES.replace("32;", "16;"))],
    "64 edges a block": [(EDGES, EDGES.replace("32;", "64;"))],
    "at most 32 registers (8 blocks an SM)": [
        (BOUNDS, BOUNDS.replace("(kThreads)", "(kThreads, 8)"))],
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
    return subprocess.Popen([CB._nvcc(), *CB.NVCC_FLAGS, f"-I{CB.CSRC}",
                             "-shared", "-o", so, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), so


def load(so):
    """The form's library with K7's entries' argument types."""
    handle = ctypes.CDLL(so)
    for name, argtypes in CB._SIGNATURES.items():
        if name.startswith("edge_patches"):
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return handle


def frame2_calls(dev):
    """(args, kwargs) of the four edge_patches calls of frame 2's stereo
    step."""
    seq = S.make_sequence(3, 376, 1241)
    pipe = PL.VOPipeline(seq.rig, VOConfig(), device=dev,
                         keyframe_policy="every_frame")
    calls, sample = [], PAT.edge_patches_flat

    def recording(*a, **kw):
        calls.append((a, kw))
        return sample(*a, **kw)

    PAT.edge_patches_flat = recording
    try:
        for f in seq.frames:
            calls.clear()
            pipe.run_frame(*(np.round(a).clip(0, 255).astype(np.uint8)
                             for a in (f.left, f.right)))
    finally:
        PAT.edge_patches_flat = sample
    assert len(calls) == 4, len(calls)
    return calls


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    procs = {n: build(n, p) for n, p in VARIANTS.items()}
    calls = frame2_calls(dev)
    libs = {}
    for n, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{n}: nvcc failed\n{log}")
        used = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                if "Used" in ln or "spill" in ln]
        print(f"{n}: ptxas {used}")
        libs[n] = load(so)

    def twin_kw(kw):
        return {k: v for k, v in kw.items() if k != "live"}

    twin = [PAT.edge_patches_plain(*a, **twin_kw(kw)) for a, kw in calls]
    real_lib = CB.lib
    times = {n: [[] for _ in calls] for n in libs}
    same = {}
    try:
        for n, handle in libs.items():
            CB.lib = lambda h=handle: h
            same[n] = True
            for (a, kw), (tp, tk) in zip(calls, twin):
                kp, kk = PAT.edge_patches_cuda(*a, **kw)
                live = kw.get("live")
                if live is not None:
                    kp, kk, tp, tk = kp[live], kk[live], tp[live], tk[live]
                same[n] &= (CS.f32_differ(kp, tp) == 0
                            and bool((kk == tk).all()))
        for _ in range(ROUNDS):                # rounds, forms in turn
            for n, handle in libs.items():
                CB.lib = lambda h=handle: h
                for c, (a, kw) in enumerate(calls):
                    times[n][c].append(CS.graph_ms(
                        lambda: PAT.edge_patches_cuda(*a, **kw), REPS))
    finally:
        CB.lib = real_lib
    torch.cuda.synchronize()
    base = [np.mean(t) for t in times["as is"]]
    for c, (name, (a, kw)) in enumerate(zip(NAMES, calls)):
        live = kw.get("live")
        n_live = a[1].shape[0] if live is None else int(live.sum())
        print(f"{name} call ({a[1].shape[0]} edges, {n_live} live):")
        for n in libs:
            t = times[n][c]
            print(f"  {n}: {' / '.join(f'{x:.4f}' for x in t)} ms alone, "
                  f"{100 * np.mean(t) / base[c]:.1f}% of as is; "
                  f"{'bit-equal to' if same[n] else 'differs from'} the "
                  f"twin")
    for n in libs:
        print(f"a stereo step's four calls, {n}: "
              f"{sum(np.mean(t) for t in times[n]):.4f} ms alone")


if __name__ == "__main__":
    main()
