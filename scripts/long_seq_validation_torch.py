#!/usr/bin/env python
"""Long-sequence validation of the port at production resolution.

Counterpart of `scripts/long_seq_validation.py`: a synthetic corridor
(`io/synthetic.make_corridor_sequence`, 100 frames of 376x1241 by
default, realistic forward motion) driven through the port's production
CLI path in process (`cli.run` with a config dict and in-memory
`StereoSample`s, so neither yaml nor an image codec is needed): adaptive
keyframing and sliding-window BA, no GT supervision. Judged on

  - ATE RMSE under `drift_frac` x the GT path length,
  - no collapsed frame (mates >= 1000, quads >= 500; 100 / 50 below
    300,000 pixels),
  - a pose on every frame: RANSAC succeeds on every frame after the
    first (frames_without_pose), and the trajectory covers every frame
    (metrics.json exists only then).

Usage (on the card; `--device cpu` runs the plain twins):
    python scripts/long_seq_validation_torch.py [--n_frames 100] [--out DIR]
Writes <out>/out/metrics.json, <out>/out/trajectory_tum.txt and the
judged record <out>/longseq_result.json, which also names the card and
its power limit.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def corridor(n_frames: int, h: int, w: int):
    """(config dict, StereoSamples, GT path length) of the corridor."""
    import numpy as np

    from edge_based_visual_odometry_tpu_torch.io import synthetic as S
    from edge_based_visual_odometry_tpu_torch.io.datasets import StereoSample

    seq = S.make_corridor_sequence(n_frames=n_frames, h=h, w=w)
    # GT as cam->world, like every dataset
    samples = [StereoSample(left=np.round(f.left).clip(0, 255).astype(np.uint8),
                            right=np.round(f.right).clip(0, 255).astype(np.uint8),
                            timestamp=float(k), gt_R=f.R.T, gt_t=-f.R.T @ f.t,
                            file_idx=k)
               for k, f in enumerate(seq.frames)]
    K = seq.rig.left.K
    cam = {"resolution": [w, h],
           "intrinsics": [float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                          float(K[1, 2])],
           "distortion_coefficients": [0, 0, 0, 0]}
    cfg = {"dataset_type": "KITTI", "left_camera": cam, "right_camera": cam,
           "stereo": {"R21": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                              [0.0, 0.0, 1.0]],
                      "T21": [float(seq.rig.T21[0]), 0.0, 0.0]}}
    cs = [-f.R.T @ f.t for f in seq.frames]
    path_len = float(sum(np.linalg.norm(cs[i + 1] - cs[i])
                         for i in range(len(cs) - 1)))
    return cfg, samples, path_len


def card_name(device: str) -> str:
    """`nvidia-smi` name and power limit of the card, or the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        torch.cuda.get_device_name(0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_frames", type=int, default=100)
    ap.add_argument("--h", type=int, default=376)
    ap.add_argument("--w", type=int, default=1241)
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "longseq_376x1241"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max_edges", type=int, default=None,
                    help="the CLI's --max_edges (default: VOConfig())")
    ap.add_argument("--ba_window", type=int, default=5)
    ap.add_argument("--drift_frac", type=float, default=0.05,
                    help="ATE bound as a fraction of GT path length")
    args = ap.parse_args(argv)

    from edge_based_visual_odometry_tpu_torch import cli as CLI

    print(f"rendering {args.n_frames} corridor frames at "
          f"{args.h}x{args.w} ...", flush=True)
    cfg, samples, path_len = corridor(args.n_frames, args.h, args.w)
    out_dir = os.path.join(args.out, "out")

    # capacity-guard scan: any collapsed frame invalidates the run
    # (thresholds scale down for small smoke-test resolutions)
    min_mates, min_quads = (1000, 500) if args.h * args.w > 300000 \
        else (100, 50)
    bad, no_pose = [], []

    def on_frame(k, fr, tr):
        mates = int(fr.mates.count)
        quads = None if tr is None else int(tr.n_quads)
        if mates < min_mates or (quads is not None and quads < min_quads):
            bad.append((k, mates, quads))
        if tr is not None and not bool(tr.success):
            no_pose.append(k)

    flags = CLI.default_args(device=args.device, keyframe_policy="adaptive",
                             ba_window=args.ba_window, output_dir=out_dir,
                             max_edges=args.max_edges)
    res = CLI.run(cfg, flags, samples, on_frame=on_frame)
    # metrics.json is absent when a frame produced no pose: a judged
    # pass:false record, not a traceback
    metrics = res["metrics"] or {"ate_rmse": None, "rpe_trans": None,
                                 "rpe_rot_deg": None, "frames_per_s": None}
    ate = metrics["ate_rmse"]
    bound = args.drift_frac * path_len
    result = {
        "n_frames": args.n_frames,
        "resolution": [args.h, args.w],
        "backend": torch.device(args.device).type,
        "card": card_name(args.device),
        "ba_window": args.ba_window,
        "keyframe_policy": "adaptive",
        # the judging criterion inside the result, so a loosened bound is
        # visible without recomputing ate_bound / gt_path_len
        "drift_frac": args.drift_frac,
        "gt_path_len_m": round(path_len, 3),
        "ate_rmse_m": ate,
        "ate_bound_m": round(bound, 3),
        "rpe_trans_m": metrics["rpe_trans"],
        "rpe_rot_deg": metrics["rpe_rot_deg"],
        "frames_per_s": metrics["frames_per_s"],
        "ba": metrics.get("ba"),
        "collapsed_frames": bad,
        "frames_without_pose": no_pose,
        "pass": bool(ate is not None and ate < bound and not bad
                     and not no_pose),
    }
    rec_path = os.path.join(args.out, "longseq_result.json")
    with open(rec_path, "w") as fo:
        json.dump(result, fo, indent=2)
    print(json.dumps(result, indent=2))
    print(f"recorded to {rec_path}")
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["pass"] else 1)
