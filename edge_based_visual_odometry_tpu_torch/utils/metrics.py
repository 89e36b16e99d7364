"""Evaluation metrics: stage tables and trajectory accuracy (ATE/RPE).

Copy of `edge_based_visual_odometry_tpu/utils/metrics.py`; poses may hold
tensors on any device (`to_numpy` moves them to the host once). Stage tables mirror the reference's printed format
(Stereo_Matches_Metrics_Statistics, src/Stereo_Matches.cpp:1701-1735;
Temporal_Matches_Metrics_Statistics, src/Temporal_Matches.cpp:1114-1148).
ATE/RPE are the standard trajectory metrics the reference leaves to its
offline MATLAB scripts (test/kitti_vis.m etc.).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from edge_based_visual_odometry_tpu_torch.models.types import to_numpy


def average_stage_metrics(per_frame: Sequence[np.ndarray]) -> np.ndarray:
    """Average (n_stages, 4) metric arrays across frames."""
    if not per_frame:
        return np.zeros((0, 4))
    return np.mean(np.stack(per_frame), axis=0)


def format_stage_table(stage_names: Sequence[str], avg: np.ndarray,
                       title: str) -> str:
    """Reference-style table: Stage | Recall | Precision | Ambiguity."""
    lines = [f"\n===== {title} =====",
             f"{'Stage':>25} | {'Recall':>12} | {'Precision':>12} | "
             f"{'Ambiguity':>12}"]
    for name, row in zip(stage_names, avg):
        lines.append(f"{name:>25} | {row[0]:>12.8f} | {row[1]:>12.8f} | "
                     f"{row[3]:>12.8f}")
    return "\n".join(lines)


def _poses_to_positions(poses_w2c: Sequence) -> np.ndarray:
    """world->cam (R, t) poses -> camera centers c = -R^T t."""
    out = []
    for p in poses_w2c:
        R = to_numpy(p.R, np.float64)
        t = to_numpy(p.t, np.float64)
        out.append(-R.T @ t)
    return np.stack(out)


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Umeyama alignment of trajectories (est -> gt). Returns (s, R, t)."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    E = est - mu_e
    G = gt - mu_g
    C = G.T @ E / len(est)
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / (E * E).sum() * len(est)) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_poses, gt_poses, align: bool = True) -> float:
    """Absolute trajectory error (RMSE of positions after SE(3) alignment)."""
    est = _poses_to_positions(est_poses)
    gt = _poses_to_positions(gt_poses)
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    if align and n >= 3:
        s, R, t = align_umeyama(est, gt)
        est = (s * (R @ est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def rpe_stats(est_poses, gt_poses, delta: int = 1):
    """Relative pose error over `delta`-frame intervals.
    Returns (trans_rmse, rot_rmse_deg)."""
    n = min(len(est_poses), len(gt_poses))
    dts, drs = [], []
    for i in range(n - delta):
        def rel(poses):
            R1 = to_numpy(poses[i].R, np.float64)
            t1 = to_numpy(poses[i].t, np.float64)
            R2 = to_numpy(poses[i + delta].R, np.float64)
            t2 = to_numpy(poses[i + delta].t, np.float64)
            R = R2 @ R1.T
            t = t2 - R @ t1
            return R, t
        Re, te = rel(est_poses)
        Rg, tg = rel(gt_poses)
        dR = Re @ Rg.T
        dt = te - dR @ tg
        dts.append(np.linalg.norm(dt))
        cos = np.clip((np.trace(dR) - 1) / 2, -1, 1)
        drs.append(np.degrees(np.arccos(cos)))
    if not dts:
        return 0.0, 0.0
    return (float(np.sqrt(np.mean(np.square(dts)))),
            float(np.sqrt(np.mean(np.square(drs)))))


def write_trajectory_tum(path: str, poses_w2c, timestamps=None):
    """TUM format: timestamp tx ty tz qx qy qz qw (camera-to-world)."""
    from edge_based_visual_odometry_tpu_torch.geometry import R_to_quat
    with open(path, "w") as f:
        for i, p in enumerate(poses_w2c):
            R = to_numpy(p.R, np.float64)
            t = to_numpy(p.t, np.float64)
            c = -R.T @ t
            q = R_to_quat(R.T)   # cam->world rotation
            ts = timestamps[i] if timestamps is not None else float(i)
            f.write(f"{ts} {c[0]} {c[1]} {c[2]} {q[1]} {q[2]} {q[3]} {q[0]}\n")
