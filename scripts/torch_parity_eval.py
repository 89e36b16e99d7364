#!/usr/bin/env python
"""Evaluation-mode temporal step of the PyTorch port against the JAX
package, on the CPU.

    python scripts/torch_parity_eval.py [--small] [--slots N]

Frames 0 and 1 of `make_sequence` (float frames, GT disparity, every pixel
visible) go through the JAX package's GT-supervised stereo step; then
`match_temporal(use_gt=True)` with the GT relative pose runs in both
packages on those same JAX mates, and once more in the port on the
port's own mates. Prints per package the eight temporal stage rows
[recall, precision, precision, ambiguity], the rows that formed a
veridical quad, and the candidates the reference-mode gather kept, and
at the end the largest difference between the JAX rows and the port's on
the same mates.

Default: 376 x 1241 with `VOConfig()` defaults - full size, which takes
several GiB and some minutes on the CPU. --small: 120 x 160 with the
reduced capacities of the port's tests. --slots N overrides
`quad_gather_slots` (the capacity of the reference-mode gather that
`use_gt` forces) in both packages.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from edge_based_visual_odometry_tpu import geometry as JGEO  # noqa: E402
from edge_based_visual_odometry_tpu.config import VOConfig as JVOConfig  # noqa: E402
from edge_based_visual_odometry_tpu.io import synthetic as JS  # noqa: E402
from edge_based_visual_odometry_tpu.models import pipeline as JPL  # noqa: E402
from edge_based_visual_odometry_tpu.models import temporal_matcher as JTM  # noqa: E402
from edge_based_visual_odometry_tpu.models.types import RigArrays as JRigArrays  # noqa: E402
from edge_based_visual_odometry_tpu_torch import geometry as GEO  # noqa: E402
from edge_based_visual_odometry_tpu_torch.config import VOConfig  # noqa: E402
from edge_based_visual_odometry_tpu_torch.models import pipeline as PL  # noqa: E402
from edge_based_visual_odometry_tpu_torch.models import temporal_matcher as TM  # noqa: E402
from edge_based_visual_odometry_tpu_torch.models import types as TY  # noqa: E402

SMALL = dict(max_edges=1024, max_candidates=8, gather_slots=64,
             max_mates=512, max_refine_pairs=1024, max_quad_candidates=8,
             quad_gather_slots=144, ransac_max_iterations=256, gn_max_iter=4)
CPU = torch.device("cpu")


def show(name, rows, quads):
    rows = np.asarray(rows, np.float64)
    print(f"{name}: rows with a veridical quad "
          f"{int(np.asarray(quads.row_mask).sum())}, candidates after the "
          f"cascade {int(np.asarray(quads.cmask).sum())}")
    for stage, r in zip(TM.TEMPORAL_STAGE_NAMES, rows):
        print(f"    {stage:>24}: recall {r[0]:.4f} precision {r[1]:.4f} "
              f"ambiguity {r[3]:.3f}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true",
                    help="120 x 160 with reduced capacities")
    ap.add_argument("--slots", type=int, default=0,
                    help="override quad_gather_slots in both packages")
    a = ap.parse_args()
    h, w = (120, 160) if a.small else (376, 1241)
    kw = dict(SMALL if a.small else {})
    if a.slots:
        kw["quad_gather_slots"] = a.slots
    jcfg, cfg = JVOConfig(**kw), VOConfig(**kw)
    print(f"{h} x {w}, quad_gather_slots {cfg.quad_gather_slots}, "
          f"temporal_grid_radius {cfg.temporal_grid_radius}, "
          f"max_quad_candidates {cfg.max_quad_candidates}")
    seq = JS.make_sequence(2, h, w)
    occ = np.full((h, w), 255.0, np.float32)
    imgs = [(f.left.astype(np.float32), f.right.astype(np.float32))
            for f in seq.frames]

    # ---- JAX: GT-supervised stereo on both frames, then the quads ----
    jstereo = JPL.build_stereo_step(seq.rig, jcfg, has_gt=True)
    jfr = [jax.tree_util.tree_map(np.asarray, jstereo(
        l, r, jnp.asarray(f.disparity), jnp.asarray(occ)))
        for (l, r), f in zip(imgs, seq.frames)]
    jrig = JRigArrays.from_rig(seq.rig)
    poses = [JGEO.Pose(jnp.asarray(f.R, jnp.float32),
                       jnp.asarray(f.t, jnp.float32)) for f in seq.frames]
    rel = JGEO.relative_pose(poses[0], poses[1])

    @jax.jit
    def jtemporal(m0, fd0, m1, fd1, R, t):
        return JTM.match_temporal(m0, m1, fd0, fd1, JGEO.Pose(R, t), jrig,
                                  jcfg, use_gt=True)

    jq, jrows = jax.tree_util.tree_map(np.asarray, jtemporal(
        jfr[0].mates, jfr[0].frame, jfr[1].mates, jfr[1].frame, rel.R, rel.t))
    for k, fr in enumerate(jfr):
        s = np.asarray(fr.stereo_metrics)[-1]
        print(f"jax stereo frame {k}: mates {int(fr.mates.count)}, final "
              f"recall {s[0]:.4f} precision {s[1]:.4f}")
    show("jax", jrows, jq)

    # ---- the port on JAX's mates ----
    rig = TY.rig_arrays_from_rig(seq.rig, CPU)
    trel = GEO.Pose(torch.from_numpy(np.array(rel.R)),
                    torch.from_numpy(np.array(rel.t)))
    q, rows = TM.match_temporal(
        TY.stereo_mates_from_numpy(jfr[0].mates, CPU),
        TY.stereo_mates_from_numpy(jfr[1].mates, CPU),
        TY.frame_data_from_numpy(jfr[0].frame, CPU),
        TY.frame_data_from_numpy(jfr[1].frame, CPU), trel, rig, cfg,
        use_gt=True)
    show("port on jax's mates", rows.numpy(), q)
    d = np.abs(rows.numpy()[:, :2] - np.asarray(jrows)[:, :2])
    print(f"largest recall / precision difference, port vs jax on the same "
          f"mates: {d[:, 0].max():.4f} / {d[:, 1].max():.4f}")

    # ---- the port on its own mates ----
    stereo = PL.build_stereo_step(seq.rig, cfg, "cpu", has_gt=True)
    fr = [stereo(l, r, f.disparity, occ) for (l, r), f in zip(imgs, seq.frames)]
    q, rows = TM.match_temporal(fr[0].mates, fr[1].mates, fr[0].frame,
                                fr[1].frame, trel, rig, cfg, use_gt=True)
    for k, f in enumerate(fr):
        s = f.stereo_metrics[-1]
        print(f"port stereo frame {k}: mates {int(f.mates.count)}, final "
              f"recall {float(s[0]):.4f} precision {float(s[1]):.4f}")
    show("port on its own mates", rows.numpy(), q)


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
