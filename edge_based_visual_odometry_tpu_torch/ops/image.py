"""Sobel gradients (cv::Sobel ksize 3, scale 1/8, reflect-101 borders) and
the undistortion remap (cv::undistort semantics).

Port of `edge_based_visual_odometry_tpu/ops/image.py`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from edge_based_visual_odometry_tpu_torch.ops import patches as P

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def _conv3(img: torch.Tensor, k) -> torch.Tensor:
    """3x3 correlation with reflect-101 borders over (..., H, W), as the
    reference's unrolled shift-adds (same accumulation order)."""
    H, W = img.shape[-2:]
    lead = img.shape[:-2]
    p = F.pad(img.reshape(-1, 1, H, W), (1, 1, 1, 1), mode="reflect")
    p = p.reshape(*lead, H + 2, W + 2)
    acc = None
    for a in range(3):
        for b in range(3):
            w = k[a][b] / 8.0
            if w == 0.0:
                continue
            s = p[..., a:a + H, b:b + W]
            acc = w * s if acc is None else acc + w * s
    return acc


def sobel_gradients(img: torch.Tensor):
    """(gx, gy) of (..., H, W) images with the reference's 1/8 scaling."""
    img = img.to(torch.float32)
    kx = _SOBEL_X
    ky = tuple(tuple(kx[b][a] for b in range(3)) for a in range(3))
    return _conv3(img, kx), _conv3(img, ky)


def undistort(img: torch.Tensor, K: torch.Tensor, dist: torch.Tensor):
    """Undistort (H, W) with the OpenCV (k1, k2, p1, p2) model: for each
    undistorted pixel the FORWARD distortion model gives the source pixel in
    the distorted input, which is sampled bilinearly (clamped)."""
    H, W = img.shape
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    jj = torch.arange(W, dtype=torch.float32, device=img.device)[None, :].expand(H, W)
    ii = torch.arange(H, dtype=torch.float32, device=img.device)[:, None].expand(H, W)
    x = (jj - cx) / fx
    y = (ii - cy) / fy
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return P.bilinear_sample_clamp(img.to(torch.float32), xd * fx + cx,
                                   yd * fy + cy)
