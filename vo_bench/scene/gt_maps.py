"""The ground-truth maps of a supervised cell, rendered from the scene's
exact geometry as ETH3D's two-view benchmark ships them with each frame:

- `disp0GT.pfm`: the left image's disparity x_left - x_right at each
  pixel centre, f B / Z from the renderer's depth (f the left focal
  length, B = -T21_x the baseline of a rectified rig), float32, inf where
  the pixel's ray meets no plane;
- `mask0nocc.png`: uint8, 255 where the pixel's point lands inside the
  right image and is the right camera's nearest hit there, else 0.

A scene whose planes bound a convex room or courtyard hides nothing:
its mask is 0 only on the strip of the left image whose points leave
the right image.
"""

from __future__ import annotations

import math

import torch

from vo_bench.scene import render as RS

# relative depth difference under which the right camera's nearest hit is
# the left pixel's own point
SAME_HIT = 1e-9


def frame_maps(rig: RS.Rig, planes, R, t, rays_l: torch.Tensor):
    """(disparity (H, W) float32, non-occlusion (H, W) uint8) of the frame
    whose left camera is (R, t) (X_c = R X_w + t), on `rays_l`'s device;
    `rays_l` the left camera's pixel rays (`render.pixel_rays`)."""
    dt, dev = rays_l.dtype, rays_l.device
    _, depth = RS.render(rays_l, R, t, planes, 0)
    f, baseline = float(rig.K_left[0, 0]), -float(rig.T21[0])
    disparity = torch.where(torch.isfinite(depth), f * baseline / depth,
                            torch.full_like(depth, math.inf))
    disparity = disparity.to(torch.float32)

    X = depth[..., None] * rays_l                         # left camera
    R21 = torch.as_tensor(rig.R21, dtype=dt, device=dev)
    T21 = torch.as_tensor(rig.T21, dtype=dt, device=dev)
    Xr = X @ R21.T + T21
    K = rig.K_right
    ur = K[0, 0] * Xr[..., 0] / Xr[..., 2] + K[0, 2]
    vr = K[1, 1] * Xr[..., 1] / Xr[..., 2] + K[1, 2]
    inside = (torch.isfinite(depth) & (Xr[..., 2] > 0) & (ur >= 0)
              & (ur <= rig.width - 1) & (vr >= 0) & (vr <= rig.height - 1))
    ur = torch.where(inside, ur, torch.zeros_like(ur))
    vr = torch.where(inside, vr, torch.zeros_like(vr))
    rays_r = torch.stack([(ur - K[0, 2]) / K[0, 0], (vr - K[1, 2]) / K[1, 1],
                          torch.ones_like(ur)], -1)
    _, hit = RS.render(rays_r.reshape(1, -1, 3), rig.R21 @ R,
                       rig.R21 @ t + rig.T21, planes, 0)
    hit = hit.reshape(depth.shape)
    nearest = torch.abs(hit - Xr[..., 2]) <= SAME_HIT * Xr[..., 2]
    visible = torch.where(inside & nearest, 255, 0).to(torch.uint8)
    return disparity, visible


def scene_maps(scene: RS.Scene, device):
    """Each frame's maps of a rendered scene (`render.make_scene`), made on
    `device` and moved to host memory once: ((N, H, W) float32, (N, H, W)
    uint8) numpy arrays."""
    rig = scene.rig
    rays_l = RS.pixel_rays(rig.height, rig.width, rig.K_left, rig.dist_left,
                           device)
    disp, vis = [], []
    for R, t in zip(scene.R, scene.t):
        d, v = frame_maps(rig, scene.planes, R, t, rays_l)
        disp.append(d)
        vis.append(v)
    return torch.stack(disp).cpu().numpy(), torch.stack(vis).cpu().numpy()

