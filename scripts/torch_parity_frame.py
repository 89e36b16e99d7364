#!/usr/bin/env python
"""Frame-0 parity of the PyTorch port against the JAX package, on the CPU.

    python scripts/torch_parity_frame.py [--float] [--small]

Runs frame 0 of `make_sequence` through the stereo step of both packages
and prints, per package: the left and right edge counts, the mates, the
12 stereo stage rows and the GN input (the pairs entering stage 9, the
row after stage 8). Frames are rounded to uint8 as the PNG path gives
them, or with --float left as the float frames `bench.py` feeds.

Default: 376 x 1241 with `VOConfig()` defaults - full size, which takes
several GiB and some minutes on the CPU. --small: 120 x 160 with the
reduced capacities of the port's tests.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from edge_based_visual_odometry_tpu.config import VOConfig as JVOConfig  # noqa: E402
from edge_based_visual_odometry_tpu.io import synthetic as JS  # noqa: E402
from edge_based_visual_odometry_tpu.models import pipeline as JPL  # noqa: E402
from edge_based_visual_odometry_tpu_torch.config import VOConfig  # noqa: E402
from edge_based_visual_odometry_tpu_torch.models import pipeline as PL  # noqa: E402

SMALL = dict(max_edges=1024, max_candidates=8, gather_slots=64,
             max_mates=512, max_refine_pairs=1024, max_quad_candidates=8,
             quad_gather_slots=144, ransac_max_iterations=256, gn_max_iter=4)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--float", action="store_true",
                    help="feed the float frames instead of uint8")
    ap.add_argument("--small", action="store_true",
                    help="120 x 160 with reduced capacities")
    a = ap.parse_args()
    h, w = (120, 160) if a.small else (376, 1241)
    kw = SMALL if a.small else {}
    seq = JS.make_sequence(1, h, w)
    f = seq.frames[0]
    if a.float:
        left, right = f.left.astype(np.float32), f.right.astype(np.float32)
    else:
        left, right = (np.round(x).clip(0, 255).astype(np.uint8)
                       for x in (f.left, f.right))
    jfr = JPL.build_stereo_step(seq.rig, JVOConfig(**kw), has_gt=False)(
        left, right)
    tfr = PL.build_stereo_step(seq.rig, VOConfig(**kw), "cpu")(left, right)
    rows = {"jax": np.asarray(jfr.stereo_metrics)[:, 1].astype(int),
            "port": tfr.stereo_metrics[:, 1].numpy().astype(int)}
    for name, fr in (("jax", jfr), ("port", tfr)):
        print(f"{name}: edges L/R {int(fr.n_left_edges)}/"
              f"{int(fr.n_right_edges)}, mates {int(fr.mates.count)}, "
              f"GN input {rows[name][7]}, stage rows {rows[name].tolist()}")
    print(f"largest stage-row difference: "
          f"{int(np.abs(rows['jax'] - rows['port']).max())}")


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
