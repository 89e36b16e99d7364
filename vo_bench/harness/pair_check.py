"""What decides `correct` in a `pair_step` cell: the numbers compared.

Over the sampled global steps (`pair_step_run.SAMPLE`, the same steps on
every rank), against the plain reference (`vo_bench/reference/exact.py`,
float64, on the host):

- `pair_px`: the worst rank's 75th percentile (the cell's
  `pair_quantile`), over the rows of rank 0's gathered output that rank
  computed, of `exact.pose_px`: the median distance between where the
  row's relative pose and the scene's exact one put the reference's
  probe points of the pair's keyframe. The worst rank, so that one rank
  dealt wrong pairs shows;
- `mates_min`: the fewest stereo mates of a keyframe or current frame
  over the gathered rows;
- `exchange_mismatch`: rows of rank 0's gathered output (R, t, inlier
  ratio, both mate counts) that differ, bit for bit, from the block the
  rank that computed them holds;
- `exchanges`: the ranks whose `mesh.EXCHANGES` does not read one
  all-reduce and five all-gathers a step of the loop;
- `kernels_not_launched`: on every rank, the hand kernels that did not
  launch in the loop (the card only).

The control computes `pair_px` with the reference itself in bfloat16 in
the program's place (`exact.control_pose`). The judgement is
`check.judge`'s, on the cell's `check`.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from vo_bench.harness import check as CHECK
from vo_bench.reference import exact as REF
from vo_bench.scene import render as RS

FIELDS = ("R", "t", "ratio", "n_kf", "n_cf")


def truth_scene(cell) -> RS.Scene:
    """The cell's scene without its images: the lap's poses, the planes
    and the rig, all the reference reads."""
    traj = cell.scene["trajectory"]
    poses = [RS.trajectory_pose(traj, k) for k in range(traj["n_frames"])]
    return RS.Scene(None, None, np.stack([p[0] for p in poses]),
                    np.stack([p[1] for p in poses]),
                    RS.planes_of(cell.scene["planes"]),
                    RS.Rig.from_config(cell.config["rig"]))


def rows_px(scene, records: List[dict], n_lap: int,
            dtype=torch.float64) -> List[tuple]:
    """(column j, batch B, `pose_px`) of every checked row of rank 0's
    gathered output: float64 judges the program, bfloat16 gives the
    control."""
    out = []
    for rec in records:
        B = len(rec["ks"])
        for j, kf in enumerate(rec["ks"]):
            cf = (kf + 1) % n_lap
            if dtype == torch.float64:
                R = torch.as_tensor(rec["rows"]["R"][j], dtype=dtype)
                t = torch.as_tensor(rec["rows"]["t"][j], dtype=dtype)
            else:
                R, t = REF.control_pose(scene, kf, cf, "cpu")
            out.append((j, B, REF.pose_px(scene, kf, cf, R, t)))
    return out


def pair_px(by_row, n_ranks: int, q: float) -> float:
    """The worst rank's q-quantile of its rows' `pose_px`."""
    if not by_row:
        return math.inf
    worst = -math.inf
    for r in range(n_ranks):
        vals = [px for j, B, px in by_row if j * n_ranks // B == r]
        worst = max(worst, CHECK.quantile(vals, q))
    return worst


def exchange_mismatch(ranks: List[dict]) -> int:
    """Rows of rank 0's gathered output that differ from the computing
    rank's own block, bit for bit (a sampled step missing on a rank
    counts its whole block)."""
    n = len(ranks)
    bad = 0
    for slot, rec in ranks[0]["records"].items():
        B = len(rec["ks"])
        per = B // n
        for r, other in enumerate(ranks):
            mine = other["records"].get(slot)
            if mine is None or mine["s"] != rec["s"]:
                bad += per
                continue
            for i in range(per):
                row = r * per + i
                if any(np.asarray(rec["rows"][f][row]).tobytes()
                       != np.asarray(mine["own"][f][i]).tobytes()
                       for f in FIELDS):
                    bad += 1
    return bad


def exchanges_off(ranks: List[dict]) -> int:
    """Ranks whose exchange counts are not one all-reduce and five
    all-gathers a step of the loop."""
    return sum(r["counts"]["exchanges"].get("all_reduce") != r["steps"]
               or r["counts"]["exchanges"].get("all_gather")
               != 5 * r["steps"] for r in ranks)


def kernels_not_launched(ranks: List[dict]) -> int:
    return sum(v == 0 for r in ranks
               for v in r["counts"]["launches"].values())


def run_numbers(cell, ranks: List[dict], on_card: bool,
                dtype=torch.float64) -> Dict[str, float]:
    """The cell's numbers over the ranks' results (`rank_window`'s or
    an episode's)."""
    scene = truth_scene(cell)
    n_lap = scene.R.shape[0]
    records = [ranks[0]["records"][k] for k in sorted(ranks[0]["records"])]
    by_row = rows_px(scene, records, n_lap, dtype)
    q = float(cell.workload["pair_quantile"])
    mates = [int(min(a, b)) for rec in records
             for a, b in zip(rec["rows"]["n_kf"], rec["rows"]["n_cf"])]
    return {"pair_px": pair_px(by_row, len(ranks), q),
            "mates_min": min(mates, default=0),
            "exchange_mismatch": exchange_mismatch(ranks),
            "exchanges": exchanges_off(ranks),
            "kernels_not_launched": (kernels_not_launched(ranks)
                                     if on_card else 0)}
