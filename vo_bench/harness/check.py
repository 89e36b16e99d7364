"""What decides `correct`: the numbers compared and their limits.

Each number is read over the checked frames (a sample of the window's
frames drawn from the seed) or the window's BA solves. The pixel numbers
are against the plain reference (`vo_bench/reference/exact.py`,
float64):

- `stereo_px`: the worst frame's 90th percentile, over its valid mates,
  of the distance of the mate's right point from the true right-image
  pixel of its left point;
- `temporal_px`: the worst frame's 90th percentile, over the keyframe
  rows with a candidate, of the best candidate's (highest left NCC, as
  windowed BA links them) distance from the true pixel of the keyframe
  point in the frame, along the candidate edge's normal (an edge fixes
  only that direction);
- `pose_px`: over the frames, the cell's `pose_quantile` (its workload
  file) of a frame's relative pose keyframe -> frame, read as the median
  distance between where it and the true pose put the reference's own
  probe points (a 24 x 64 grid of the keyframe cast into the scene): the
  90th percentile where every frame is a keyframe; the median with
  adaptive keyframes, whose frames far from their keyframe read up to
  6 px, above the control's 1.2-2.2;
- `ba_px`: the worst solve's largest `pose_px` between two consecutive
  refined keyframes of its window.

A high percentile, and the worst frame or solve, so that a fault in a
part of the rows or of the frames shows. The counts are the program's
own, a lower limit each, so that work left out shows where the answers
kept are right: `mates_min` (the fewest valid mates of a checked frame),
`quads_min` (the fewest lifted quads), `inliers_min` (the fewest RANSAC
inliers). The scene is fixed, so sound runs give steady counts.

The control computes the pixel numbers with the reference itself, in
bfloat16, in the program's place: its true right pixels, frame pixels
and relative poses at the same points. A run is correct when no frame
failed (no pose, or a temporal step without success), every kernel
K1-K9 launched in the window, and every number is within its limit, the
cell's `check` in its workload file: at most the limit, or for a name
that ends in `_min`, at least it.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List

import torch

from vo_bench.reference import exact as REF


ERR_QUANTILE = 0.9     # of a frame's rows: stereo_px, temporal_px


def _stereo(scene, rec, dtype, q):
    lx, ly, rx, ry, valid = rec["mates"]
    v = valid.bool()
    lx, ly = lx[v].double(), ly[v].double()
    truth = REF.stereo_truth(scene, rec["k"], lx, ly, torch.float64)
    if dtype == torch.float64:
        ans = torch.stack([rx[v].double(), ry[v].double()], -1)
    else:
        ans = REF.stereo_truth(scene, rec["k"], lx, ly, dtype).double()
    return REF.quantile_px(torch.linalg.norm(ans - truth, dim=-1), q)


def _temporal(scene, rec, dtype, q):
    lcx, lcy, lct, cmask, ncc = rec["quads"]
    kx, ky = rec["kf_rows"]
    score = torch.where(cmask, ncc.float(),
                        torch.full_like(ncc.float(), -math.inf))
    best = score.argmax(1)
    has = cmask.any(1)
    rows = torch.nonzero(has).squeeze(1)
    b = best[rows]
    cx, cy = lcx[rows, b].double(), lcy[rows, b].double()
    th = lct[rows, b].double()
    px, py = kx[rows].double(), ky[rows].double()
    truth = REF.temporal_truth(scene, rec["kf"], rec["k"], px, py,
                               torch.float64)
    if dtype == torch.float64:
        ans = torch.stack([cx, cy], -1)
    else:
        ans = REF.temporal_truth(scene, rec["kf"], rec["k"], px, py,
                                 dtype).double()
    d = ans - truth
    normal = torch.stack([-torch.sin(th), torch.cos(th)], -1)
    return REF.quantile_px((d * normal).sum(-1).abs(), q)


def _pose(scene, kf, cf, R, t, dtype, device):
    if dtype == torch.float64:
        return REF.pose_px(scene, kf, cf, R.double(), t.double())
    Rc, tc = REF.control_pose(scene, kf, cf, device)
    return REF.pose_px(scene, kf, cf, Rc, tc)


def per_frame(scene, records: List[dict], device, dtype=torch.float64,
              q: float = ERR_QUANTILE):
    """Each checked frame's numbers: its pixel errors (the q-quantile over
    its rows) and its counts."""
    return [dict(k=rec["k"], kf=rec["kf"],
                 stereo_px=_stereo(scene, rec, dtype, q),
                 temporal_px=_temporal(scene, rec, dtype, q),
                 pose_px=_pose(scene, rec["kf"], rec["k"], rec["R"],
                               rec["t"], dtype, device),
                 mates=int(rec["mates"][4].bool().sum()),
                 quads=int(rec["n_quads"]), inliers=int(rec["inliers"]))
            for rec in records]


def per_solve(scene, ba_solves, scene_index, device, dtype=torch.float64):
    """Each BA solve's largest `pose_px` over its consecutive refined
    keyframes."""
    out = []
    for idx, poses in ba_solves:
        worst = 0.0
        for (fa, pa), (fb, pb) in zip(zip(idx, poses),
                                      zip(idx[1:], poses[1:])):
            R = pb.R.double() @ pa.R.double().T
            t = pb.t.double() - R @ pa.t.double()
            worst = max(worst, _pose(scene, scene_index(fa),
                                     scene_index(fb), R, t, dtype, device))
        out.append(worst)
    return out


def frame_numbers(scene, records: List[dict], ba_solves, scene_index,
                  device, pose_quantile: float,
                  dtype=torch.float64) -> Dict[str, float]:
    """The cell's numbers over the sampled frames and every BA solve;
    `dtype` float64 judges the program, bfloat16 gives the control (whose
    counts are the program's)."""
    rows = per_frame(scene, records, device, dtype)
    return numbers_of(rows, None if ba_solves is None else per_solve(
        scene, ba_solves, scene_index, device, dtype), pose_quantile)


def numbers_of(rows: List[dict], solves,
               pose_quantile: float) -> Dict[str, float]:
    """The cell's numbers from `per_frame`'s rows and `per_solve`'s."""
    out = {name: max((r[name] for r in rows), default=math.inf)
           for name in ("stereo_px", "temporal_px")}
    out["pose_px"] = quantile([r["pose_px"] for r in rows], pose_quantile)
    for name in ("mates", "quads", "inliers"):
        out[f"{name}_min"] = min((r[name] for r in rows), default=0)
    if solves is not None:
        out["ba_px"] = max(solves, default=math.inf)
    return out


def quantile(values, q: float) -> float:
    """The q-quantile of `values` (linear between order statistics; 1.0
    the largest); inf for none."""
    if not values:
        return math.inf
    return float(torch.quantile(torch.tensor(values, dtype=torch.float64),
                                q))


def judge(numbers: Dict[str, float], limits: Dict[str, float],
          failed: int):
    """(correct, checks): each number the cell's `check` names with its
    limit, and the frames that failed with theirs (0). A number the cell
    does not name is not compared (as `inliers_min` with adaptive
    keyframes: its sound runs and its faults read alike)."""
    checks = {"failed": {"value": failed, "limit": 0}}
    ok = failed == 0
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        within = value >= limit if name.endswith("_min") else value <= limit
        ok = ok and math.isfinite(value) and within
    return ok, checks


def print_checks(checks, stream=sys.stderr):
    """Each number compared beside its limit, as the last lines."""
    for name, c in checks.items():
        side = "at least" if name.endswith("_min") else "limit"
        print(f"check {name}: {c['value']} ({side} {c['limit']})",
              file=stream)
