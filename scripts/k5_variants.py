#!/usr/bin/env python
"""Time K5 (csrc/edge_descriptors.cu) on the card as it is against copies
of its source with one part taken out or laid out otherwise, to see where
a launch spends its time. Every form is launched alone, on operands
prepared once, through its C entry (the {gx, gy} interleave and the
kernel); forms in turns, in rounds.

    python scripts/k5_variants.py

Needs a CUDA device and nvcc (sm_90a). Builds into build/k5_variants/.
Input: the three `edge_descriptors` calls (left edges, right edges, final
mates) of frame 0's stereo step of make_sequence(1, 376, 1241), rounded to
uint8, through VOPipeline(VOConfig()). Each form says whether its output
equals the twin's bit for bit; the forms with a part taken out compute
something else and are timing only.

First it holds the CUDA math library's sinf and cosf, built by this nvcc
with K5's flags, against torch.sin and torch.cos on every float32 bit
pattern: K5 forms its keypoints' cosine and sine itself.
"""

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from edge_based_visual_odometry_tpu_torch.config import VOConfig  # noqa: E402
from edge_based_visual_odometry_tpu_torch.io import synthetic as S  # noqa: E402
from edge_based_visual_odometry_tpu_torch.models import pipeline as PL  # noqa: E402
from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB  # noqa: E402
from edge_based_visual_odometry_tpu_torch.ops import descriptors as DESC  # noqa: E402

SRC = CB.CSRC / "edge_descriptors.cu"
OUT = os.path.join(REPO, "build", "k5_variants")
REPS, ROUNDS = 50, 2

PHASE2 = "  __syncwarp();\n\n  // ---- phase 2"
SAMPLE_LOOP = "  for (int s = lane; s < p.S; s += 32) {"
READ_O = "const int lo = O[tm.x >> 16], hi"
BLOCK = "constexpr int kWarps = 4;"
SAMPLE = "      const float2 v = sample_maps(p.maps, sx, sy, ox[h], oy[h], t1);"
GLOBAL_GATHERS = [
    ("  cudaTextureObject_t maps;              // (H, W) {gx, gy}\n",
     "  cudaTextureObject_t maps;\n  const float *gx, *gy;\n"),
    ("  Params p{tex, H, W,", "  Params p{tex, gx, gy, H, W,"),
    ("  interleave_kernel<<<", "  if (N < 0) interleave_kernel<<<"),
    (SAMPLE, "      const gn::Tap tp = gn::make_tap(sx, sy, ox[h], oy[h], "
             "t1, p.H, p.W);\n      const float2 v = make_float2("
             "gn::read_global(p.gx, tp), gn::read_global(p.gy, tp));")]
STORE_T = ("      sm.t[h][slot] = make_float2(hat(ob, lo, mag),\n"
           "                                  hat(ob, (lo + 1) & "
           "(kOrient - 1), mag));")
SOA = [("  float2 t[2][kSlots];", "  float tl[2][kSlots], th[2][kSlots];"),
       (STORE_T, "      sm.tl[h][slot] = hat(ob, lo, mag);\n"
                 "      sm.th[h][slot] = hat(ob, (lo + 1) & (kOrient - 1), "
                 "mag);"),
       ("  const float2* T = sm.t[h];",
        "  const float* TL = sm.tl[h];\n  const float* TH = sm.th[h];"),
       ("const float2 t = T[tm.x & 0xffff];",
        "const float2 t = make_float2(TL[tm.x & 0xffff], TH[tm.x & 0xffff]);")]
SHARED_BINS = """  float* acc = &sm.acc[0][lane];
  const int n = __ldg(p.lens + cell);
  for (int j = 0; j < n; ++j) {
    const int2 tm = __ldg(p.terms + j * kCells + cell);
    const float w = __int_as_float(tm.y);
    const float2 t = T[tm.x & 0xffff];
    const int lo = O[tm.x >> 16], hi = (lo + 1) & (kOrient - 1);
    acc[32 * lo] = add(acc[32 * lo], mul(w, t.x));
    acc[32 * hi] = add(acc[32 * hi], mul(w, t.y));
  }
  float a[kOrient];
#pragma unroll
  for (int o = 0; o < kOrient; ++o) a[o] = acc[32 * o];
"""
REGISTER_BINS = """  float ae[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ao[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int n = __ldg(p.lens + cell);
  for (int j = 0; j < n; ++j) {
    const int2 tm = __ldg(p.terms + j * kCells + cell);
    const float w = __int_as_float(tm.y);
    const float2 t = T[tm.x & 0xffff];
    const int lo = O[tm.x >> 16];
    const float plo = mul(w, t.x), phi = mul(w, t.y);
    const bool odd = lo & 1;
    const float pe = odd ? phi : plo, po = odd ? plo : phi;
    const int ke = ((lo + 1) >> 1) & 3, ko = lo >> 1;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k == ke) ae[k] = add(ae[k], pe);
      if (k == ko) ao[k] = add(ao[k], po);
    }
  }
  float a[kOrient] = {ae[0], ao[0], ae[1], ao[1], ae[2], ao[2], ae[3], ao[3]};
"""
REGISTERS = [
    (SHARED_BINS, REGISTER_BINS),
    ("  float acc[kOrient][32];                // bin o of lane l at [o][l]\n",
     ""),
    ("  for (int o = 0; o < kOrient; ++o) sm.acc[o][lane] = 0.0f;\n", "")]

# name -> (source patches [(text, replacement)], tables: "colours" K5's
# own, "pad" sample s in record slot s + s // 16, "cells" the lists
# (16, L) cell-major)
VARIANTS = {
    "as is": ([], "colours"),
    "the sampling pass alone (returns before phase 2)": (
        [(PHASE2, "  __syncwarp();\n  if (p.N > 0) return;\n\n"
                  "  // ---- phase 2")], "colours"),
    "the histogram alone (no sampling pass)": (
        [(SAMPLE_LOOP, "  for (int s = lane; s < 0 * p.S; s += 32) {"),
         (READ_O, "const int lo = O[tm.x >> 16] & 7, hi")], "colours"),
    "odd warps the sampling pass alone, even warps the histogram alone": (
        [(SAMPLE_LOOP, "  for (int s = lane; s < ((e & 1) ? p.S : 0); "
                       "s += 32) {"),
         (READ_O, "const int lo = O[tm.x >> 16] & 7, hi"),
         ("  const int n = __ldg(p.lens + cell);",
          "  const int n = (e & 1) ? 0 : __ldg(p.lens + cell);")], "colours"),
    "without atan2f (the angle is +-1)": (
        [("atan2f(v.y, v.x)", "copysignf(1.0f, v.y)")], "colours"),
    "no interleave: gathers from gx and gy in global memory": (
        GLOBAL_GATHERS, "colours"),
    "records at slot s + s / 16 (no bank colours)": ([], "pad"),
    "bins in registers (predicated adds)": (REGISTERS, "colours"),
    "half64 (2 warps a block)": (
        [(BLOCK, "constexpr int kWarps = 2;")], "colours"),
    "half256 (8 warps a block)": (
        [(BLOCK, "constexpr int kWarps = 8;")], "colours"),
    "the lists staged in shared memory a block": (
        [("  __shared__ WarpSmem smem[kWarps];\n",
          "  __shared__ WarpSmem smem[kWarps];\n"
          "  __shared__ int2 staged[L_ * kCells];\n"
          "  for (int i = threadIdx.x; i < L_ * kCells; i += kWarps * 32)\n"
          "    staged[i] = __ldg(p.terms + i);\n"
          "  __syncthreads();\n"),
         ("    const int2 tm = __ldg(p.terms + j * kCells + cell);",
          "    const int2 tm = staged[j * kCells + cell];")], "colours"),
    "tlist_tlayout_half64 (cell-major lists, records as two arrays, "
    "2 warps a block)": (
        SOA + [(BLOCK, "constexpr int kWarps = 2;"),
               ("p.terms + j * kCells + cell", "p.terms + cell * L_ + j")],
        "cells"),
}

PROBE = r"""
#include <cuda_runtime.h>
__global__ void sincos_kernel(const float* t, float* s, float* c, long n) {
  const long i = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (i < n) { s[i] = sinf(t[i]); c[i] = cosf(t[i]); }
}
extern "C" int sincos_launch(const float* t, float* s, float* c, long n,
                             cudaStream_t st) {
  sincos_kernel<<<(n + 255) / 256, 256, 0, st>>>(t, s, c, n);
  return (int)cudaGetLastError();
}
"""


def nvcc(tag, text):
    src = os.path.join(OUT, f"{tag}.cu")
    with open(src, "w") as f:
        f.write(text)
    so = os.path.join(OUT, f"{tag}.so")
    return subprocess.Popen([CB._nvcc(), *CB.NVCC_FLAGS, f"-I{CB.CSRC}",
                             "-shared", "-o", so, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), so


def build(name, patches, L):
    text = SRC.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in the source once")
        text = text.replace(old, new.replace("L_", str(L)))
    return nvcc("v%d" % list(VARIANTS).index(name), text)


def sincos_probe(dev, stream):
    """sinf / cosf of this nvcc against torch.sin / torch.cos on every
    float32 bit pattern: (patterns whose bits differ, NaN equal to NaN),
    and their count."""
    p, so = nvcc("sincos", PROBE)
    if p.wait():
        raise SystemExit(f"sincos probe: nvcc failed\n{p.communicate()[0]}")
    f = ctypes.CDLL(so).sincos_launch
    f.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_long, ctypes.c_void_p]
    f.restype = ctypes.c_int
    n, bad, chunk = 0, 0, 1 << 28
    for start in range(-(1 << 31), 1 << 31, chunk):
        t = torch.arange(start, start + chunk, dtype=torch.int64,
                         device=dev).to(torch.int32).view(torch.float32)
        s, c = torch.empty_like(t), torch.empty_like(t)
        if f(t.data_ptr(), s.data_ptr(), c.data_ptr(), chunk, stream):
            raise SystemExit("sincos probe: launch failed")
        for mine, ref in ((s, torch.sin(t)), (c, torch.cos(t))):
            bad += int(((mine.view(torch.int32) != ref.view(torch.int32))
                        & ~(mine.isnan() & ref.isnan())).sum())
        n += chunk
    return bad, n


def stereo_calls(dev):
    """(args, kwargs) of the three edge_descriptors calls of frame 0."""
    seq = S.make_sequence(1, 376, 1241)
    imgs = [np.round(a).clip(0, 255).astype(np.float32)
            for a in (seq.frames[0].left, seq.frames[0].right)]
    pipe = PL.VOPipeline(seq.rig, VOConfig(), device=dev,
                         keyframe_policy="every_frame")
    describe, calls = DESC.edge_descriptors, []

    def recording(*a, **kw):
        calls.append((a, kw))
        return describe(*a, **kw)

    DESC.edge_descriptors = recording
    try:
        pipe.run_frame(*imgs)
    finally:
        DESC.edge_descriptors = describe
    if len(calls) != 3:
        raise SystemExit(f"{len(calls)} edge_descriptors calls, not 3")
    return calls


def lists(kind, kw, dev):
    """K5's (ii, jj, gauss, place, terms, lens) as a form reads them."""
    n = kw["n_samples"]
    ii, jj, gauss, _ = DESC._static_tables(n, kw["n_spatial"],
                                           kw["spacing"], dev)
    terms, lens, place = DESC._k5_terms(n, kw["n_spatial"], kw["spacing"],
                                        dev)
    if kind == "pad":
        idx, _ = DESC._cell_lists(n, kw["n_spatial"], kw["spacing"], dev)
        s = torch.arange(place.shape[0], device=dev, dtype=torch.int32)
        place = (s + s // 16) | (s + s // 16) << 16
        terms = torch.stack([place[idx.long()], terms[..., 1]], -1)
    elif kind == "cells":
        terms = terms.transpose(0, 1)
    return ii, jj, gauss, place, terms.contiguous(), lens


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    bad, n = sincos_probe(dev, stream)
    print(f"sinf / cosf against torch.sin / torch.cos: {bad} of {n} float32 "
          f"bit patterns differ")
    calls = stereo_calls(dev)
    L = lists("colours", calls[0][1], dev)[4].shape[0]
    procs = {n: build(n, p, L) for n, (p, _) in VARIANTS.items()}
    fns = {}
    for n, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{n}: nvcc failed\n{log}")
        used = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "Used" in ln]
        print(f"{n}: ptxas {used}")
        f = ctypes.CDLL(so).edge_descriptors_launch
        f.argtypes = CB._SIGNATURES["edge_descriptors_launch"]
        f.restype = ctypes.c_int
        fns[n] = f
    lens = lists("colours", calls[0][1], dev)[5]
    print(f"the card's cell lists: {lens.tolist()}, {int(lens.sum())} terms")
    total = {n: [0.0] * ROUNDS for n in fns}
    for name, (a, kw) in zip(("left edges", "right edges", "mates"), calls):
        gx, gy, x, y, theta = a
        H, W = gx.shape
        tex, surf = DESC._k5_maps(dev.index, stream, H, W)
        ref = DESC.edge_descriptors_plain(*a, **kw)
        outs = {n: torch.empty_like(ref) for n in fns}
        tabs = {n: lists(VARIANTS[n][1], kw, dev) for n in fns}

        def run(n):
            ii, jj, gauss, place, terms, lens = tabs[n]
            err = fns[n](gx.data_ptr(), gy.data_ptr(), tex, surf, H, W,
                         x.data_ptr(), y.data_ptr(), theta.data_ptr(),
                         x.shape[0], kw["shift_mag"], ii.data_ptr(),
                         jj.data_ptr(), gauss.data_ptr(), place.data_ptr(),
                         ii.shape[0],
                         terms.data_ptr(), lens.data_ptr(), 40, 8,
                         DESC._TWO_PI_F32, DESC._INV_TWO_PI_F32, kw["clip"],
                         kw["scale"], outs[n].data_ptr(), stream)
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
        base = np.mean(times["as is"])
        for n in fns:
            same = bool(((outs[n].view(torch.int16) == ref.view(torch.int16))
                         | (outs[n].isnan() & ref.isnan())).all())
            print(f"{name} ({x.shape[0]} edges), {n}: "
                  f"{' / '.join(f'{t:.4f}' for t in times[n])} ms, "
                  f"{100 * np.mean(times[n]) / base:.1f}% of as is; "
                  f"{'bit-equal to' if same else 'differs from'} the twin")
    base = np.mean(total["as is"])
    for n in fns:
        print(f"a stereo step's three calls, {n}: "
              f"{' / '.join(f'{t:.4f}' for t in total[n])} ms, "
              f"{100 * np.mean(total[n]) / base:.1f}% of as is")


if __name__ == "__main__":
    main()
