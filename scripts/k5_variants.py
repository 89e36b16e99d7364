#!/usr/bin/env python
"""Time K5 (csrc/edge_descriptors.cu) on the card as it is against copies
of its source with one part taken out, to see where a launch spends its
time, and against the same library with one term of each cell list (the
histogram but one term taken out). Every form is launched alone, on
operands prepared once, through its C entry.

    python scripts/k5_variants.py

Needs a CUDA device and nvcc (sm_90a). Builds into build/k5_variants/.
Input: the three `edge_descriptors` calls (left edges, right edges, final
mates) of frame 0's stereo step of make_sequence(1, 376, 1241), rounded to
uint8, through VOPipeline(VOConfig()). Only the form as it is computes
the descriptors: the others compute something else and are timing only;
each says whether its output equals the twin's bit for bit.
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
PHASE2 = "  __syncwarp();\n\n  // ---- phase 2"
# name -> (text of the source, its replacement); None: the source as is
VARIANTS = {
    "as is": None,
    "the sampling pass alone (returns before phase 2)": (
        PHASE2, "  __syncwarp();\n  if (p.L > 0) return;\n\n  // ---- phase 2"),
    "without atan2f (the angle is +-1)": (
        "atan2f(gy, gx)", "copysignf(1.0f, gy)"),
    "without fmodf (the angle is not wrapped)": (
        "remainder_pos(ang, p.two_pi)", "ang"),
}
ONE_TERM = "as is, one term of each cell list"
REPS, ROUNDS = 50, 2


def build(name, patch):
    tag = "v%d" % list(VARIANTS).index(name)
    src = os.path.join(OUT, f"{tag}.cu")
    text = SRC.read_text()
    if patch is not None:
        if text.count(patch[0]) != 1:
            raise SystemExit(f"{name}: {patch[0]!r} is not in the source once")
        text = text.replace(patch[0], patch[1])
    with open(src, "w") as f:
        f.write(text)
    so = os.path.join(OUT, f"{tag}.so")
    return subprocess.Popen([CB._nvcc(), *CB.NVCC_FLAGS, f"-I{CB.CSRC}",
                             "-shared", "-o", so, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), so


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


def operands(a, kw):
    """The C entry's arguments but the lists and the output, prepared once
    as `edge_descriptors_cuda` prepares them, and the keypoint tensors
    that the pointers point into."""
    gx, gy, x, y, theta = a
    dev = x.device
    kp = DESC._keypoints(x, y, theta, kw["shift_mag"])
    ii, jj, gauss, _ = DESC._static_tables(kw["n_samples"], kw["n_spatial"],
                                           kw["spacing"], dev)
    two_pi = np.float32(DESC.TWO_PI)
    head = [gx.data_ptr(), gy.data_ptr(), *gx.shape,
            *(t.data_ptr() for t in kp), x.shape[0], ii.data_ptr(),
            jj.data_ptr(), gauss.data_ptr(), ii.shape[0]]
    tail = [40, 8, float(two_pi), float(np.float32(1.0) / two_pi),
            kw["clip"], kw["scale"]]
    return head, tail, kp


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    os.makedirs(OUT, exist_ok=True)
    procs = {n: build(n, p) for n, p in VARIANTS.items()}
    fns = {}
    for n, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{n}: nvcc failed\n{log}")
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "Used" in ln]
        print(f"{n}: ptxas {regs}")
        f = ctypes.CDLL(so).edge_descriptors_launch
        f.argtypes = CB._SIGNATURES["edge_descriptors_launch"]
        f.restype = ctypes.c_int
        fns[n] = f
    fns[ONE_TERM] = fns["as is"]
    dev = torch.device("cuda", 0)
    calls = stereo_calls(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    total = {n: [0.0] * ROUNDS for n in fns}
    for name, (a, kw) in zip(("left edges", "right edges", "mates"), calls):
        head, tail, kp = operands(a, kw)    # kp holds the keypoints
        lists = DESC._cell_lists(kw["n_samples"], kw["n_spatial"],
                                 kw["spacing"], dev)
        ref = DESC.edge_descriptors_plain(*a, **kw)
        outs = {n: torch.empty_like(ref) for n in fns}

        def run(n):
            ls = [t[:1] for t in lists] if n == ONE_TERM else lists
            err = fns[n](*head, ls[0].data_ptr(), ls[1].data_ptr(),
                         ls[0].shape[0], *tail, outs[n].data_ptr(), stream)
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
            same = torch.equal(outs[n].view(torch.int16),
                               ref.view(torch.int16))
            print(f"{name} ({a[2].shape[0]} edges), {n}: "
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
