"""Sobel gradients (cv::Sobel ksize 3, scale 1/8, reflect-101 borders).

Port of `edge_based_visual_odometry_tpu/ops/image.py::sobel_gradients`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
