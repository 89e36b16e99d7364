"""CLI of the port: YAML-config-driven stereo edge VO on a dataset.

Counterpart of the reference's `main_vo.py` (itself the equivalent of
cmd/main_VO.cpp:22-119): same flags, same output files (`trajectory_tum.txt`,
`metrics.json`, per-frame dump files, checkpoints) and same printed lines,
plus `--device` (default `cuda`; a CUDA device that does not exist is an
error, never a silent run on the CPU).

    python main_vo_torch.py -c config.yaml [--device cpu] [...]

`main(argv)` parses the flags, reads the YAML and hands the dataset
iterator to `run(cfg_dict, args, samples)`, which builds the pipeline and
drives the frame loop; `run` can also be given the config as a dict and
the frames as an in-memory iterable of `StereoSample`s.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Edge-based stereo VO (PyTorch/CUDA port)")
    ap.add_argument("-c", "--config_file", required=True,
                    help="YAML config (reference schema, config/*.yaml)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pipeline: 'cuda' (default; "
                         "fails where no CUDA device exists) or 'cpu' "
                         "(plain PyTorch twins of the kernels)")
    ap.add_argument("--max_frames", type=int, default=0,
                    help="process at most N frames (0 = all)")
    ap.add_argument("--use_gt_pose", action="store_true",
                    help="eval mode: build quads from GT relative pose "
                         "(the reference's veridical path)")
    ap.add_argument("--output_dir", default=None,
                    help="override output_dir from the YAML")
    ap.add_argument("--max_edges", type=int, default=None)
    ap.add_argument("--no_prefetch", action="store_true",
                    help="disable the native background decode threads")
    ap.add_argument("--dump_stereo_pairs", action="store_true",
                    help="write finalized_stereo_edge_pairs_frame_N.txt per "
                         "frame (reference Stereo_Matches.cpp:1656-1699)")
    ap.add_argument("--dump_quads", action="store_true",
                    help="write quads_frame_N.txt per re-keyframing frame "
                         "(reference Temporal_Matches.cpp:1066-1112)")
    ap.add_argument("--record_filter_distributions", action="store_true",
                    help="write per-frame filter-score + ambiguity "
                         "distribution files (reference "
                         "RECORD_FILTER_DISTRIBUTIONS, definitions.h:61)")
    ap.add_argument("--save_viz", action="store_true",
                    help="render figures of every dump file into "
                         "<output_dir>/viz (viz/, needs matplotlib)")
    ap.add_argument("--checkpoint_dir", default=None,
                    help="save/resume pipeline state here "
                         "(utils/checkpoint.py). An existing checkpoint is "
                         "resumed automatically; already-processed frames "
                         "are skipped.")
    ap.add_argument("--checkpoint_every", type=int, default=25,
                    help="checkpoint cadence in frames (with "
                         "--checkpoint_dir)")
    ap.add_argument("--keyframe_policy", default="every_frame",
                    choices=["reference", "every_frame", "adaptive"],
                    help="keyframe selection: 'reference' = frame 0 "
                         "forever (reference src/Pipeline.cpp:133-137), "
                         "'every_frame' = frame-to-frame VO, 'adaptive' = "
                         "re-keyframe when tracking quality drops")
    ap.add_argument("--ba_window", type=int, default=0,
                    help="sliding-window BA length in keyframes (0 = off; "
                         "models/window_ba.py)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override any VOConfig field (repeatable), e.g. "
                         "--set gn_max_iter=10 --set ncc_thresh=0.5")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse and validate the flags; errors exit non-zero here, before any
    work starts."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.ba_window >= 2 and args.keyframe_policy == "reference":
        ap.error("--ba_window >= 2 requires a re-keyframing policy "
                 "(--keyframe_policy every_frame|adaptive): windowed BA "
                 "chains tracks across keyframes, and 'reference' never "
                 "creates a second keyframe")
    return args


def default_args(**overrides) -> argparse.Namespace:
    """The flags' defaults as a Namespace, for callers of `run` that have
    no command line; `overrides` set individual flags."""
    args = build_parser().parse_args(["-c", ""])
    for k, v in overrides.items():
        if not hasattr(args, k):
            raise AttributeError(f"unknown flag {k!r}")
        setattr(args, k, v)
    return args


def vo_config_from_args(args):
    """VOConfig with --max_edges scaling and --set overrides applied."""
    from edge_based_visual_odometry_tpu_torch.config import VOConfig

    vo_cfg = VOConfig()
    if args.max_edges:
        # scale the dependent fixed-shape capacities with the edge budget,
        # keeping the capacity ratios of the defaults (sized for
        # max_edges=32768)
        n = args.max_edges
        vo_cfg = dataclasses.replace(
            vo_cfg, max_edges=n,
            max_mates=max(256, vo_cfg.max_mates * n // VOConfig.max_edges),
            max_refine_pairs=max(1024, vo_cfg.max_refine_pairs * n
                                 // VOConfig.max_edges),
            max_gate_pairs=max(4096,
                               vo_cfg.max_gate_pairs * n
                               // VOConfig.max_edges),
            max_pose_quads=max(512,
                               vo_cfg.max_pose_quads * n
                               // VOConfig.max_edges),
            ransac_max_iterations=min(vo_cfg.ransac_max_iterations,
                                      max(512, n // 4)))
    for kv in args.set:
        key, _, val = kv.partition("=")
        cur = getattr(vo_cfg, key)     # AttributeError on unknown field
        if isinstance(cur, bool):
            parsed = val.lower() in ("1", "true", "yes")
        else:
            parsed = type(cur)(val)
        vo_cfg = dataclasses.replace(vo_cfg, **{key: parsed})
    return vo_cfg


def _w2c_pose(gt_R, gt_t):
    """Dataset GT is camera-to-world; the pipeline uses world-to-camera."""
    from edge_based_visual_odometry_tpu_torch.geometry import Pose
    return Pose(torch.as_tensor(gt_R.T, dtype=torch.float32),
                torch.as_tensor(-gt_R.T @ gt_t, dtype=torch.float32))


def dataset_samples(cfg_yaml: dict, args: argparse.Namespace):
    """`start -> iterator of StereoSample` over the dataset the config
    names; `start` is the file position to resume decoding at."""
    from edge_based_visual_odometry_tpu_torch.config import rig_from_yaml_dict
    from edge_based_visual_odometry_tpu_torch.io import datasets

    rig = rig_from_yaml_dict(cfg_yaml)

    def make(start: int = 0):
        return datasets.make_iterator(
            cfg_yaml["dataset_type"], cfg_yaml["dataset_dir"],
            cfg_yaml["sequence_name"], cfg_yaml.get("gt_file_path", ""),
            np.asarray(rig.rot_frame2body) if rig.rot_frame2body else None,
            np.asarray(rig.transl_frame2body) if rig.transl_frame2body else None,
            image_hw=(rig.left.height, rig.left.width),
            prefetch=not args.no_prefetch, start=start)

    return make


def run(cfg_yaml: dict, args: argparse.Namespace, samples,
        on_frame=None) -> dict:
    """Build the pipeline from a config dict (reference YAML schema) and
    the flags, drive the frame loop, and write the outputs.

    `samples`: the frames, as an iterable of `StereoSample`s or as a
    callable `start -> iterable` that is given the dataset file position to
    resume decoding at (`dataset_samples` makes one for the dataset the
    config names).
    `on_frame(n, fr, tr)`: called after each processed frame with its index
    and the pipeline's (FrameResult, TemporalResult or None).
    Returns {"pipe", "frames", "frames_processed", "seconds", "metrics"
    (the dict written to metrics.json, or None), "out_dir"}."""
    from edge_based_visual_odometry_tpu_torch.config import rig_from_yaml_dict
    from edge_based_visual_odometry_tpu_torch.geometry import Pose
    from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
    from edge_based_visual_odometry_tpu_torch.models import stereo_matcher as SM
    from edge_based_visual_odometry_tpu_torch.models import temporal_matcher as TM
    from edge_based_visual_odometry_tpu_torch.utils import metrics as MET

    rig = rig_from_yaml_dict(cfg_yaml)
    dataset_type = cfg_yaml["dataset_type"]
    has_gt_disparity = dataset_type == "ETH3D_stereo"  # src/Dataset.cpp:126-129
    vo_cfg = vo_config_from_args(args)

    out_dir = args.output_dir or cfg_yaml.get("output_dir", "./outputs")
    os.makedirs(out_dir, exist_ok=True)

    pipe = PL.VOPipeline(rig=rig, cfg=vo_cfg, device=args.device,
                         has_gt_disparity=has_gt_disparity,
                         use_gt_pose=args.use_gt_pose,
                         keyframe_policy=args.keyframe_policy,
                         ba_window=args.ba_window,
                         record_distributions=args.record_filter_distributions)
    rig_arrays = None
    if (args.dump_stereo_pairs or args.dump_quads
            or args.record_filter_distributions):
        from edge_based_visual_odometry_tpu_torch.models.types import (
            rig_arrays_from_rig)
        from edge_based_visual_odometry_tpu_torch.utils import debug_io as DIO
        rig_arrays = rig_arrays_from_rig(rig, pipe.device)

    resume_from = 0
    file_pos = 0           # dataset FILE-list position to resume decode at
    restored_gt = None
    if args.checkpoint_dir:
        from edge_based_visual_odometry_tpu_torch.utils import checkpoint as CKPT
        if CKPT.restore_pipeline_state(args.checkpoint_dir, pipe):
            resume_from = pipe.frame_idx
            # file position + GT trajectory travel alongside the pipeline
            # checkpoint: decode failures make file position != frame
            # count, and rebuilding gt_traj from the metadata prefix
            # would re-include the never-processed bad files
            cs_path = os.path.join(args.checkpoint_dir, "cli_state.npz")
            if not os.path.exists(cs_path):
                raise FileNotFoundError(
                    f"{cs_path}: the checkpoint has a pipeline state but no "
                    f"file position; checkpoints from before cli_state.npz "
                    f"are not resumed by the port")
            cs = np.load(cs_path)
            file_pos = int(cs["file_pos"])
            restored_gt = [Pose(torch.as_tensor(R, dtype=torch.float32),
                                torch.as_tensor(t, dtype=torch.float32))
                           for R, t in zip(cs["gt_R"], cs["gt_t"])]
            print(f"resumed from checkpoint at frame {resume_from} "
                  f"(file {file_pos})", flush=True)

    # file_pos makes a dataset iterator skip image decode for the files the
    # restored trajectory already covers (metadata still yielded)
    it = samples(file_pos) if callable(samples) else samples

    gt_traj = list(restored_gt) if restored_gt is not None else []
    timestamps = []
    t0 = time.time()
    n = resume_from
    last_file_pos = file_pos

    def save_ckpt():
        CKPT.save_pipeline_state(args.checkpoint_dir, pipe)
        gtR = (np.stack([p.R.numpy() for p in gt_traj])
               if gt_traj else np.zeros((0, 3, 3), np.float32))
        gtt = (np.stack([p.t.numpy() for p in gt_traj])
               if gt_traj else np.zeros((0, 3), np.float32))
        np.savez(os.path.join(args.checkpoint_dir, "cli_state.npz"),
                 file_pos=last_file_pos, gt_R=gtR, gt_t=gtt)

    for sample in it:
        if sample.file_idx < file_pos:
            # already in the restored trajectory
            timestamps.append(sample.timestamp)
            last_file_pos = max(last_file_pos, sample.file_idx + 1)
            continue
        gt_pose = None
        if sample.gt_R is not None:
            gt_pose = _w2c_pose(sample.gt_R, sample.gt_t)
            gt_traj.append(gt_pose)
        timestamps.append(sample.timestamp)
        kf_before = pipe.keyframe   # quads in tr reference THIS keyframe
        kf_idx_before = pipe.kf_index
        fr, tr = pipe.run_frame(sample.left, sample.right,
                                disparity=sample.left_disparity,
                                gt_pose=gt_pose,
                                occlusion=sample.left_occlusion)
        if args.dump_stereo_pairs:
            DIO.write_finalized_stereo_pairs(
                os.path.join(out_dir,
                             f"finalized_stereo_edge_pairs_frame_{n}.txt"),
                fr.mates, rig_arrays)
        if args.dump_quads and tr is not None and kf_before is not None:
            DIO.write_quads(os.path.join(out_dir, f"quads_frame_{n}.txt"),
                            kf_before.mates, tr.quads,
                            kf_idx=kf_idx_before, cf_idx=n)
        if args.record_filter_distributions:
            DIO.write_distributions(out_dir, n, fr.distributions)
            if has_gt_disparity:
                # io.h per-cluster evaluation dumps (photo-refine eval,
                # TP->FN transitions, false-negative clusters)
                DIO.write_eval_cluster_dumps(out_dir, n, fr.distributions,
                                             tol=vo_cfg.gt_pair_dist_tol)
        n += 1
        last_file_pos = sample.file_idx + 1
        msg = (f"frame {n - 1}: edges L/R = {int(fr.n_left_edges)}/"
               f"{int(fr.n_right_edges)}, mates = {int(fr.mates.count)}")
        if tr is not None:
            msg += (f", quads = {int(tr.n_quads)}, "
                    f"inliers = {int(tr.inlier_count)} "
                    f"({float(tr.inlier_ratio):.3f})")
        print(msg, flush=True)
        if on_frame is not None:
            on_frame(n - 1, fr, tr)
        if (args.checkpoint_dir and args.checkpoint_every
                and n % args.checkpoint_every == 0):
            save_ckpt()
        if args.max_frames and n >= args.max_frames:
            break

    if args.checkpoint_dir and n > resume_from:
        save_ckpt()

    dt = time.time() - t0
    done = n - resume_from
    print(f"\nprocessed {n} frames in {dt:.2f}s "
          f"({max(done, 0) / dt:.3f} frames/s)")

    if pipe.stereo_metrics_log:
        avg = MET.average_stage_metrics(pipe.stereo_metrics_log)
        print(MET.format_stage_table(SM.STAGE_NAMES, avg,
                                     "Stereo Edge Matching Metrics"))
    if pipe.temporal_metrics_log:
        avg = MET.average_stage_metrics(pipe.temporal_metrics_log)
        print(MET.format_stage_table(TM.TEMPORAL_STAGE_NAMES, avg,
                                     "Temporal Quad Matching Metrics"))

    traj_file = os.path.join(out_dir, "trajectory_tum.txt")
    # real sample timestamps so TUM tooling (evo, associate.py) can match
    # against groundtruth files; fall back to frame indices on length
    # mismatch (e.g. resumed runs over datasets with decode failures)
    ts = timestamps if len(timestamps) == len(pipe.trajectory) else None
    MET.write_trajectory_tum(traj_file, pipe.trajectory, timestamps=ts)
    print(f"trajectory written to {traj_file}")

    rec = None
    if gt_traj and len(gt_traj) == len(pipe.trajectory):
        ate = MET.ate_rmse(pipe.trajectory, gt_traj)
        rpe_t, rpe_r = MET.rpe_stats(pipe.trajectory, gt_traj)
        print(f"ATE RMSE = {ate:.4f} m | RPE = {rpe_t:.4f} m, {rpe_r:.4f} deg")
        rec = {"ate_rmse": ate, "rpe_trans": rpe_t,
               "rpe_rot_deg": rpe_r, "frames": n,
               "frames_processed": max(done, 0),
               # resumed (skipped) frames must not inflate fps
               "frames_per_s": max(done, 0) / dt}
        if pipe.ba_info_log:
            # windowed-BA cost split: host bookkeeping vs device solve
            rec["ba"] = {
                "solves": len(pipe.ba_info_log),
                "mean_landmarks": float(np.mean(
                    [b["n_landmarks"] for b in pipe.ba_info_log])),
                "mean_obs": float(np.mean(
                    [b["n_obs"] for b in pipe.ba_info_log])),
                "mean_host_assembly_s": float(np.mean(
                    [b["host_assembly_s"] for b in pipe.ba_info_log])),
                "mean_solve_s": float(np.mean(
                    [b["solve_s"] for b in pipe.ba_info_log])),
            }
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(rec, f, indent=2)

    if args.save_viz:
        from edge_based_visual_odometry_tpu_torch.viz.__main__ import (
            _render_all)
        _render_all(out_dir, os.path.join(out_dir, "viz"))
    return {"pipe": pipe, "frames": n, "frames_processed": max(done, 0),
            "seconds": dt, "metrics": rec, "out_dir": out_dir}


def main(argv=None) -> int:
    args = parse_args(argv)
    import yaml
    with open(args.config_file) as f:
        cfg_yaml = yaml.safe_load(f)
    run(cfg_yaml, args, dataset_samples(cfg_yaml, args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
