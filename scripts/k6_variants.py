#!/usr/bin/env python
"""Time K6 (csrc/dense_gates.cu) on the card as it is against copies of
its source with one part changed, to see what each part of its design
buys: the live slots a warp step (2, 4, 8 or 32, so 16, 8, 4 or 1 lanes
a slot), the register caps, the NCC's scores spread over a slot's
lanes, the stereo entry's one walk, the prep pass's share of a call,
and the gates launched while the prep pass runs. Every form
runs through the port's own wrappers (`dense_gates_*_cuda`, which
allocate, check and launch) bound to the form's library, and is timed as
launches alone: 20 calls captured in one CUDA graph, so the host's work
runs once at capture (`chip_smoke.graph_ms`). Forms in turns, in rounds.

    python scripts/k6_variants.py

Needs a CUDA device and nvcc (sm_90a). Builds into build/k6_variants/.
Input: frame 2's three K6 calls (stages 4-5 and stage 11 of its stereo
step, its temporal step) of make_sequence(3, 376, 1241), rounded to
uint8, through VOPipeline(VOConfig()), the operands `chip_smoke.py`
times. Each form says whether its outputs equal the twins' bit
for bit; the forms marked "(timing only)" compute something else.
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

SRC = CB.CSRC / "dense_gates.cu"
OUT = os.path.join(REPO, "build", "k6_variants")
REPS, ROUNDS = 20, 3
KINDS = ("stereo", "flat", "temporal")

SLOTS = "constexpr int kSlots = 8;"
TEMPORAL = "__launch_bounds__(kWarps * 32, 3)\ndense_gates_temporal_kernel"
STEREO = "__launch_bounds__(kWarps * 32)\ndense_gates_stereo_kernel"
PREP_T = ("    prep<__nv_bfloat16, L>(p.cf_pat, cf_desc, Mc, 2, p.g, "
          "cf_terms, stream);")
PREP_S = "    prep<float, L>(r_pat, r_desc, Nr, 1, p.g, r_terms, stream);"
GATES_T = ("  dense_gates_temporal_kernel<L><<<blocks(p.M), kWarps * 32, 0, "
           "stream>>>(p);")
GATES_S = ("  dense_gates_stereo_kernel<L><<<blocks(p.N), kWarps * 32, 0, "
           "stream>>>(p);")
# the stereo entry's walk, and the two walks it replaced: the distances,
# then a list of the slots past the SIFT gate, then their NCC
ONE_WALK = """  walk(n, lane, s_c[w], s_j[w], [&](int c, size_t j, int hl, bool keep) {
    const float* t = p.r_terms + j * terms_stride(1);
    const float x = desc_pair(s_desc[w], p.r_desc + j * 32,
                              reinterpret_cast<const float2*>(t + 4)[0], hl);
    const float y = ncc_pair(s_pat[w], p.r_pat + j * two,
                             reinterpret_cast<const float4*>(t)[0],
                             p.r_ok + 2 * j, p.g, hl);
    if (keep) {
      o_dist[c] = x;
      if (x < p.sift) o_ncc[c] = y;
    }
  });"""
TWO_WALKS = """  walk(n, lane, s_c[w], s_j[w], [&](int c, size_t j, int hl, bool keep) {
    const float* t = p.r_terms + j * terms_stride(1);
    const float x = desc_pair(s_desc[w], p.r_desc + j * 32,
                              reinterpret_cast<const float2*>(t + 4)[0], hl);
    if (keep) o_dist[c] = x;
  });
  const int ns = list_slots(m0 && o_dist[lane] < p.sift,
                            m1 && o_dist[lane + 32] < p.sift, j0, j1, lane,
                            s_c[w], s_j[w]);
  walk(ns, lane, s_c[w], s_j[w], [&](int c, size_t j, int hl, bool keep) {
    const float* t = p.r_terms + j * terms_stride(1);
    const float y = ncc_pair(s_pat[w], p.r_pat + j * two,
                             reinterpret_cast<const float4*>(t)[0],
                             p.r_ok + 2 * j, p.g, hl);
    if (keep) o_ncc[c] = y;
  });"""
# the stereo row's own terms formed one a half-warp (the descriptor on
# lanes 0-15, the patch on 16-31), each half's butterflies on its own
# shuffle mask
FULL = ("  for (int o = 8; o > 0; o >>= 1) v = add(v, __shfl_xor_sync(kFull, "
        "v, o));")
HALF = ("  for (int o = 8; o > 0; o >>= 1)\n    v = add(v, __shfl_xor_sync("
        "(threadIdx.x & 16) ? 0xffff0000u : 0x0000ffffu, v, o));")
BOTH = """  const Desc d = load_desc(p.l_desc + (size_t)i * 32, h);
  const Patch<S> l = load_patch<S>(p.l_pat + (size_t)i * two,
                                   p.l_ok + 2 * (size_t)i, p.g, h);
  if (lane < 16) {
    keep_desc(s_desc[w], d, h);
    keep_patch(s_pat[w], l, h);
  }"""
SPLIT = """  if (lane < 16) {
    keep_desc(s_desc[w], load_desc(p.l_desc + (size_t)i * 32, h), h);
  } else {
    keep_patch(s_pat[w], load_patch<S>(p.l_pat + (size_t)i * two,
                                        p.l_ok + 2 * (size_t)i, p.g, h), h);
  }"""
# Programmatic dependent launch: the gates launched while the prep pass
# runs, each warp waiting for the prep's terms only before its walk
WAIT = '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
WALK_S = ("  walk(n, lane, s_c[w], s_j[w], [&](int c, size_t j, int hl, bool "
          "keep) {\n    const float* t = p.r_terms")
WALK_T = ("  walk(n, lane, s_c[w], s_j[w], [&](int c, size_t j, int hl, bool "
          "keep) {\n    const float* t = p.cf_terms")
PREP_TOP = ("  const int lane = threadIdx.x & 31, h = lane & 15;\n"
            "  const int u0 = 2 * (blockIdx.x")


def pdl_launch(kernel, grid):
    return ("  {\n    cudaLaunchConfig_t cfg = {};\n"
            f"    cfg.gridDim = dim3({grid});\n"
            "    cfg.blockDim = dim3(kWarps * 32);\n"
            "    cfg.stream = stream;\n"
            "    cudaLaunchAttribute at[1];\n"
            "    at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;\n"
            "    at[0].val.programmaticStreamSerializationAllowed = 1;\n"
            "    cfg.attrs = at;\n    cfg.numAttrs = 1;\n"
            f"    cudaLaunchKernelEx(&cfg, {kernel}, p);\n  }}")


PDL = [(PREP_TOP, '  asm volatile("griddepcontrol.launch_dependents;");\n'
        + PREP_TOP),
       (WALK_S, WAIT + WALK_S), (WALK_T, WAIT + WALK_T),
       (GATES_S, pdl_launch("dense_gates_stereo_kernel<L>", "blocks(p.N)")),
       (GATES_T, pdl_launch("dense_gates_temporal_kernel<L>",
                            "blocks(p.M)"))]
# name -> source patches [(text, replacement)], each text replaced
# wherever it stands (it must stand somewhere)
VARIANTS = {
    "as is": [],
    "2 slots a step (16 lanes a slot)": [
        (SLOTS, "constexpr int kSlots = 2;")],
    "4 slots a step (8 lanes a slot)": [
        (SLOTS, "constexpr int kSlots = 4;")],
    "32 slots a step (one lane a slot, no butterfly)": [
        (SLOTS, "constexpr int kSlots = 32;")],
    "the temporal gates with no register cap (64, spilling)": [
        (TEMPORAL, TEMPORAL.replace("32, 3)", "32)"))],
    "the gates at most 128 registers (2 blocks an SM)": [
        (TEMPORAL, TEMPORAL.replace("32, 3)", "32, 2)")),
        (STEREO, STEREO.replace("32)", "32, 2)"))],
    "the stereo gates at most 80 registers (3 blocks an SM)": [
        (STEREO, STEREO.replace("32)", "32, 3)"))],
    "the stereo gates at most 40 registers (6 blocks an SM)": [
        (STEREO, STEREO.replace("32)", "32, 6)"))],
    "the stereo row's descriptor and patch one a half-warp": [
        (FULL, HALF), (BOTH, SPLIT)],
    "the NCC's four scores on every lane of a slot": [
        ("if constexpr (kLanes >= 4) {", "if constexpr (false) {")],
    "the stereo gates in two walks (the NCC after the SIFT gate's list)": [
        (ONE_WALK, TWO_WALKS)],
    "the gates launched while the prep pass runs (programmatic "
    "dependent launch)": PDL,
    "the prep pass alone (timing only)": [
        (GATES_T, ""), (GATES_S, "")],
    "the gates alone, no prep pass (timing only)": [
        (PREP_T, ""), (PREP_S, "")],
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
    """The form's library with the K6 entries' argument types."""
    handle = ctypes.CDLL(so)
    for name, argtypes in CB._SIGNATURES.items():
        if name.startswith("dense_gates"):
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return handle


def frame2_calls(dev):
    """{kind: (args, kwargs)} of frame 2's three K6 calls."""
    seq = S.make_sequence(3, 376, 1241)
    pipe = PL.VOPipeline(seq.rig, VOConfig(), device=dev,
                         keyframe_policy="every_frame")
    calls, orig = {}, {k: getattr(PAT, f"dense_gates_{k}") for k in KINDS}

    def recording(kind):
        def run(*a, **kw):
            calls[kind] = (a, kw)
            return orig[kind](*a, **kw)
        return run

    for k in KINDS:
        setattr(PAT, f"dense_gates_{k}", recording(k))
    try:
        for f in seq.frames:
            pipe.run_frame(*(np.round(a).clip(0, 255).astype(np.uint8)
                             for a in (f.left, f.right)))
    finally:
        for k in KINDS:
            setattr(PAT, f"dense_gates_{k}", orig[k])
    return calls


def stacked(x):
    return torch.stack(x) if isinstance(x, tuple) else x


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
    kern = {k: getattr(PAT, f"dense_gates_{k}_cuda") for k in KINDS}
    twin = {k: stacked(getattr(PAT, f"dense_gates_{k}_plain")(*a, **kw))
            for k, (a, kw) in calls.items()}
    real_lib = CB.lib
    times = {n: {k: [] for k in KINDS} for n in libs}
    same = {}
    try:
        for n, handle in libs.items():
            CB.lib = lambda h=handle: h
            same[n] = all(
                CS.f32_differ(stacked(kern[k](*a, **kw)), twin[k]) == 0
                for k, (a, kw) in calls.items())
        for _ in range(ROUNDS):                # rounds, forms in turn
            for n, handle in libs.items():
                CB.lib = lambda h=handle: h
                for k, (a, kw) in calls.items():
                    times[n][k].append(CS.graph_ms(
                        lambda: kern[k](*a, **kw), REPS))
    finally:
        CB.lib = real_lib
    torch.cuda.synchronize()
    base = {k: np.mean(times["as is"][k]) for k in KINDS}
    for k, (a, kw) in calls.items():
        live = a[5] if k == "flat" else a[3] if k == "stereo" else a[10]
        print(f"{k} call ({tuple(live.shape)}, {int(live.sum())} live):")
        for n in libs:
            t = times[n][k]
            print(f"  {n}: {' / '.join(f'{x:.4f}' for x in t)} ms alone, "
                  f"{100 * np.mean(t) / base[k]:.1f}% of as is; "
                  f"{'bit-equal to' if same[n] else 'differs from'} the "
                  f"twins")
    for n in libs:
        print(f"a frame's three calls, {n}: "
              f"{sum(np.mean(times[n][k]) for k in KINDS):.4f} ms alone")


if __name__ == "__main__":
    main()
