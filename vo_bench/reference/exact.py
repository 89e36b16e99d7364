"""The plain reference: where each answer truly lies, from the scene.

The benchmark renders its frames from planes and a trajectory that it
knows exactly, so the reference needs no second VO pipeline: for a
point the program reports, it casts the ray through that pixel into the
scene and projects the hit into the other camera or frame. It reads the
program's outputs only to judge them (the pixels whose truth it looks
up), and imports nothing of the program.

Every function takes a `dtype`: float64 gives the truth; the control is
the same reference in bfloat16, the nearest precision below the float32
that the configurations state, put in the program's place.

Coordinates: the program undistorts each image on the card, so its
points are pinhole pixels of each camera's K; X_c = R X_w + t per
camera, X_r = R21 X_l + T21 between the two.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def _t(a, dtype, device):
    return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)


def rays(K, u, v, dtype):
    """(N, 3) pinhole rays K^-1 [u, v, 1] (z = 1)."""
    u, v = u.to(dtype), v.to(dtype)
    x = (u - float(K[0, 2])) / float(K[0, 0])
    y = (v - float(K[1, 2])) / float(K[1, 1])
    return torch.stack([x, y, torch.ones_like(x)], -1)


def raycast(planes: Sequence, R, t, d: torch.Tensor):
    """(N, 3) camera-frame points where rays `d` of the camera (R, t)
    first meet the planes (beyond 0.1 along the ray); NaN where none."""
    dt, dev = d.dtype, d.device
    Rt, tt = _t(R, dt, dev), _t(t, dt, dev)
    dw = d @ Rt                                  # R^T d
    best = torch.full(d.shape[:-1], math.inf, dtype=dt, device=dev)
    for pl in planes:
        n = _t(pl.n, dt, dev)
        lam = (_t(pl.c, dt, dev) + n @ (Rt.T @ tt)) / (dw @ n)
        lam = torch.where(lam > 0.1, lam, torch.full_like(lam, math.inf))
        best = torch.minimum(best, lam)
    best = torch.where(torch.isfinite(best), best,
                       torch.full_like(best, math.nan))
    return best[..., None] * d


def project(K, X):
    """(N, 2) pixels of camera-frame points X."""
    z = X[..., 2]
    return torch.stack([float(K[0, 0]) * X[..., 0] / z + float(K[0, 2]),
                        float(K[1, 1]) * X[..., 1] / z + float(K[1, 2])], -1)


def relative(Ra, ta, Rb, tb, dtype, device):
    """Camera a -> camera b of two world -> camera poses."""
    Ra, ta, Rb, tb = (_t(x, dtype, device) for x in (Ra, ta, Rb, tb))
    R = Rb @ Ra.T
    return R, tb - R @ ta


def stereo_truth(scene, k: int, lx, ly, dtype):
    """Right-image pixel of each left-image pixel (lx, ly) of frame k."""
    rig = scene.rig
    X = raycast(scene.planes, scene.R[k], scene.t[k],
                rays(rig.K_left, lx, ly, dtype))
    Xr = X @ _t(rig.R21, dtype, X.device).T + _t(rig.T21, dtype, X.device)
    return project(rig.K_right, Xr)


def temporal_truth(scene, kf: int, cf: int, lx, ly, dtype):
    """Left-image pixel in frame cf of each left-image pixel (lx, ly) of
    frame kf."""
    K = scene.rig.K_left
    X = raycast(scene.planes, scene.R[kf], scene.t[kf],
                rays(K, lx, ly, dtype))
    R, t = relative(scene.R[kf], scene.t[kf], scene.R[cf], scene.t[cf],
                    dtype, X.device)
    return project(K, X @ R.T + t)


def probes(scene, kf: int, device, dtype, rows: int = 24, cols: int = 64):
    """The reference's own probe points: a grid of frame kf's left pixels
    cast into the scene, (N, 3) in kf's camera frame."""
    rig = scene.rig
    v, u = torch.meshgrid(
        torch.linspace(8.0, rig.height - 9.0, rows, dtype=torch.float64,
                       device=device),
        torch.linspace(8.0, rig.width - 9.0, cols, dtype=torch.float64,
                       device=device), indexing="ij")
    return raycast(scene.planes, scene.R[kf], scene.t[kf],
                   rays(rig.K_left, u.reshape(-1), v.reshape(-1), dtype))


def pose_px(scene, kf: int, cf: int, R, t) -> float:
    """Median over the probes of frame kf that frame cf sees of the pixel
    distance between where the relative pose (R, t) (kf -> cf, any dtype)
    puts them in cf and where they truly land (float64)."""
    dev = R.device
    X = probes(scene, kf, dev, torch.float64)
    Rg, tg = relative(scene.R[kf], scene.t[kf], scene.R[cf], scene.t[cf],
                      torch.float64, dev)
    Xg = X @ Rg.T + tg
    ug = project(scene.rig.K_left, Xg)
    if R.dtype == torch.float64:
        u = project(scene.rig.K_left, X @ R.T + t)
    else:                  # the control: the whole chain in its precision
        Xl = probes(scene, kf, dev, R.dtype)
        u = project(scene.rig.K_left, Xl @ R.T + t).to(torch.float64)
    ok = (torch.isfinite(Xg).all(-1) & (Xg[:, 2] > 0.5)
          & (ug[:, 0] >= 0) & (ug[:, 0] <= scene.rig.width - 1)
          & (ug[:, 1] >= 0) & (ug[:, 1] <= scene.rig.height - 1))
    err = torch.linalg.norm(u - ug, dim=-1)[ok]
    return float(err.median()) if err.numel() else math.inf


def control_pose(scene, kf: int, cf: int, device):
    """The reference's own relative pose kf -> cf in bfloat16."""
    return relative(scene.R[kf], scene.t[kf], scene.R[cf], scene.t[cf],
                    torch.bfloat16, device)


def quantile_px(err: torch.Tensor, q: float) -> float:
    """The q-quantile of the finite errors (linear between order
    statistics); inf for none."""
    err = err[torch.isfinite(err)]
    return float(torch.quantile(err, q)) if err.numel() else math.inf
