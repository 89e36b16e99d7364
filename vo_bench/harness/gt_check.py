"""What decides `correct` in a supervised (`gt_frame`) cell: the frame
cells' numbers (`check.py`: `stereo_px`, `temporal_px`, `pose_px` and the
`*_min` counts) and the evaluation path's, over the same checked frames
against the plain reference (`vo_bench/reference/eval_rows.py`,
float64):

- `gt_px`: the worst frame's 90th percentile, over its valid mates, of
  the distance of the program's GT right location (`gt_x`, `gt_y`, from
  the disparity map it was handed) from the exact right pixel of the
  mate's left point;
- `stereo_recall_err`, `stereo_precision_err`, `temporal_recall_err`,
  `temporal_precision_err`: the worst frame's absolute difference
  between the Final row the program logged for the frame (its stage-row
  logs, read once after the window) and the reference's, recomputed from
  the frame's own edges, mates and quads;
- `eval_rows_missing`: the stage rows the window's frames should have
  logged (a stereo and a temporal row a frame) less those the program
  logged (`pipeline.EVAL`, or the logs' lengths in a program without
  the counter).

The control computes the same numbers with the reference in bfloat16 in
the program's place: the exact right pixels and both Final rows.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from vo_bench.harness import check as CHECK
from vo_bench.reference import eval_rows as ER

RULES = ("dist_to_gt_thresh", "dist_to_gt_thresh_quads", "gt_pair_dist_tol",
         "gt_pair_orient_tol", "epipolar_line_dist_thresh",
         "gt_orient_exclusion_deg", "veridical_orient_thresh_deg")
ROW_ERRS = ("stereo_recall_err", "stereo_precision_err",
            "temporal_recall_err", "temporal_precision_err")


def rules(cfg) -> dict:
    """The reference's rules, as the configuration's `VOConfig` sets
    them."""
    return {name: float(getattr(cfg, name)) for name in RULES}


def rows_logged(pipe) -> int:
    """Stereo and temporal stage rows the pipeline has logged: its
    `EVAL` counter, where the program has one (reset with the launch
    counts), else its logs' lengths."""
    from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
    counts = getattr(PL, "EVAL", None)
    if counts is not None:
        return counts["stereo_rows"] + counts["temporal_rows"]
    return len(pipe.stereo_metrics_log) + len(pipe.temporal_metrics_log)


def add_right_edges(records: List[dict], cfg):
    """The right-image edges of each record that lacks them: the timed
    step returns those its cascade read (`FrameResult.right_edges`); a
    program whose step does not gets them detected anew on the record's
    images, by the same kernels on the same pixels."""
    from edge_based_visual_odometry_tpu_torch.ops import toed
    for rec in records:
        if rec.get("right_edges") is not None:
            continue
        _, red = toed.detect_edges(
            torch.stack(rec["images"]), kernel_size=cfg.toed_kernel_size,
            sigma=cfg.toed_sigma, grad_mag_min=cfg.toed_grad_mag_min,
            max_edges=cfg.max_edges, border=cfg.toed_border)
        rec["right_edges"] = (red.x, red.y, red.theta, red.valid)


def per_frame(scene, records: List[dict], logs, rule: dict,
              dtype=torch.float64, q: float = CHECK.ERR_QUANTILE):
    """Each checked frame's evaluation numbers. `logs`: (stereo rows,
    temporal rows), the program's stage-row logs; `dtype` float64 judges
    the program, bfloat16 gives the control."""
    stereo_log, temporal_log = logs
    out = []
    for rec in records:
        s_ref = ER.stereo_final(scene, rec["k"], rec["lr_mates"],
                                rec["right_edges"], rule)
        t_ref = ER.temporal_final(scene, rec["kf"], rec["k"], rec["kf_mates"],
                                  rec["cf_mates"], rec["quads_lr"], rule)
        if dtype == torch.float64:
            s_ans = stereo_log[rec["stereo_row"]][-1, :2]
            t_ans = temporal_log[rec["temporal_row"]][-1, :2]
        else:
            s_ans = ER.stereo_final(scene, rec["k"], rec["lr_mates"],
                                    rec["right_edges"], rule, dtype)[:2]
            t_ans = ER.temporal_final(scene, rec["kf"], rec["k"],
                                      rec["kf_mates"], rec["cf_mates"],
                                      rec["quads_lr"], rule, dtype)[:2]
        errs = [abs(float(a) - b) for a, b in zip(s_ans, s_ref[:2])]
        errs += [abs(float(a) - b) for a, b in zip(t_ans, t_ref[:2])]
        row = dict(zip(ROW_ERRS, errs))
        row.update(gt_px=ER.gt_px(scene, rec["k"], rec["gt"], q, dtype),
                   stereo_rows=s_ref[2], temporal_rows=t_ref[2],
                   stereo_recall=s_ref[0], temporal_recall=t_ref[0])
        out.append(row)
    return out


def numbers_of(rows: List[dict]) -> Dict[str, float]:
    """The worst checked frame's evaluation numbers (a number that is not
    finite counts as the worst)."""
    def worst(name):
        vals = [r[name] for r in rows]
        if not vals:
            return math.inf
        return max(v if math.isfinite(v) else math.inf for v in vals)
    return {name: worst(name) for name in ("gt_px", *ROW_ERRS)}


def frame_numbers(scene, records: List[dict], logs, rule: dict, ba_solves,
                  scene_index, device, pose_quantile: float,
                  dtype=torch.float64) -> Dict[str, float]:
    """The frame cells' numbers (`check.frame_numbers`) and the
    evaluation path's over the same records."""
    out = CHECK.frame_numbers(scene, records, ba_solves, scene_index, device,
                              pose_quantile, dtype)
    out.update(numbers_of(per_frame(scene, records, logs, rule, dtype)))
    return out
