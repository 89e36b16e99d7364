#!/usr/bin/env python
"""Time the K1 CUDA kernel (csrc/toed_gradient_field.cu) on the card as
it is (4 output columns per row-pass thread) against the same source
built with 8 columns per thread (`-DTOED_COLS=8`), in turns, and check
both against the plain twin.

    python scripts/k1_variants.py

Needs a CUDA device and nvcc (sm_90a). Builds into build/k1_variants/.
Input: both images of frame 0 of make_sequence(1, 376, 1241), uint8-valued.
"""

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from edge_based_visual_odometry_tpu_torch.io import synthetic as S  # noqa: E402
from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB  # noqa: E402
from edge_based_visual_odometry_tpu_torch.ops import toed  # noqa: E402

SRC = os.path.join(REPO, "edge_based_visual_odometry_tpu_torch", "csrc",
                   "toed_gradient_field.cu")
OUT = os.path.join(REPO, "build", "k1_variants")
VARIANTS = {"4 columns per thread (as is)": 4, "8 columns per thread": 8}


def build(cols):
    so = os.path.join(OUT, f"k1_cols{cols}.so")
    return subprocess.Popen([CB._nvcc(), *CB.NVCC_FLAGS, f"-DTOED_COLS={cols}",
                             "-shared", "-o", so, SRC],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), so


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    os.makedirs(OUT, exist_ok=True)
    procs = {n: build(c) for n, c in VARIANTS.items()}
    fns = {}
    for n, (p, so) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{n}: nvcc failed\n{log}")
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "Used" in ln]
        print(f"{n}: ptxas {regs}")
        f = ctypes.CDLL(so).toed_gradient_field_launch
        f.argtypes = CB._SIGNATURES["toed_gradient_field_launch"]
        f.restype = ctypes.c_int
        fns[n] = f
    dev = torch.device("cuda", 0)
    fr = S.make_sequence(1, 376, 1241).frames[0]
    img = torch.stack([torch.as_tensor(np.round(a).clip(0, 255))
                       for a in (fr.left, fr.right)]).to(dev, torch.float32)
    B, H, W = img.shape
    taps = toed._kernel_taps(17, 2.0)
    ref = toed.toed_gradient_field_plain(img)

    def run(f):
        outs = [torch.empty((B, 2 * H, 2 * W), device=dev) for _ in range(4)]
        err = f(img.data_ptr(), B, H, W, *(o.data_ptr() for o in outs),
                taps.ctypes.data, torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(f"launch failed: CUDA error {err}")
        return outs

    times = {n: [] for n in fns}
    for _ in range(2):                      # two rounds, variants in turn
        for n, f in fns.items():
            for _ in range(3):
                run(f)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(50):
                run(f)
            t1.record()
            torch.cuda.synchronize()
            times[n].append(t0.elapsed_time(t1) / 50)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for n, f in fns.items():
        outs = run(f)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(a, b)) for a, b in zip(outs, ref))
        print(f"{n}: {' / '.join(f'{t:.4f}' for t in times[n])} ms, "
              f"{'bit-equal to' if same else 'differs from'} the plain twin")


if __name__ == "__main__":
    main()
