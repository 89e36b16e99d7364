"""Gradient-orientation-histogram edge descriptor (the SIFT stand-in).

Port of `edge_based_visual_odometry_tpu/ops/descriptors.py`:
`edge_descriptors` has the semantics of the reference's
`edge_descriptors_tiled` (16x16 rotated sample grid, 4x4 spatial cells x
8 orientation bins, Gaussian radial weight, L2 normalize / clip 0.2 /
renormalize / scale 512) including its bf16 output cast, which the
descriptor gates see.
"""

from __future__ import annotations

import math

import torch

from edge_based_visual_odometry_tpu_torch.ops import patches as P


def _static_tables(n_samples, n_spatial, spacing, device):
    half = (n_samples - 1) / 2.0
    offs = (torch.arange(n_samples, dtype=torch.float32, device=device)
            - half) * spacing
    ii = offs.repeat_interleave(n_samples)
    jj = offs.repeat(n_samples)
    sigma = n_samples * spacing / 2.0
    gauss = torch.exp(-(ii * ii + jj * jj) / (2.0 * sigma * sigma))
    cell = n_samples / n_spatial
    u = torch.clamp((ii + half * spacing) / (cell * spacing) - 0.5,
                    0.0, n_spatial - 1.0)
    v = torch.clamp((jj + half * spacing) / (cell * spacing) - 0.5,
                    0.0, n_spatial - 1.0)
    sp = torch.arange(n_spatial, dtype=torch.float32, device=device)
    Wu = torch.clamp(1.0 - torch.abs(u[:, None] - sp), min=0.0)    # (S, 4)
    Wv = torch.clamp(1.0 - torch.abs(v[:, None] - sp), min=0.0)
    SP = (Wu[:, :, None] * Wv[:, None, :]).reshape(-1, n_spatial * n_spatial)
    return ii, jj, gauss, SP


def edge_descriptors(gx_img, gy_img, x, y, theta, shift_mag: float = 8.0,
                     n_samples: int = 16, n_spatial: int = 4,
                     n_orient: int = 8, spacing: float = 1.0,
                     clip: float = 0.2, scale: float = 512.0,
                     tile: int = 40, stride: int = 8,
                     chunk: int = 16384):
    """Descriptors at the two orthogonally shifted keypoints of (N,) edges.

    Returns FLAT (N, 2*D) bf16, [plus | minus]. Chunked over keypoints to
    bound memory; chunking never changes results."""
    N = x.shape[0]
    D = n_spatial * n_spatial * n_orient
    ii, jj, gauss, SP = _static_tables(n_samples, n_spatial, spacing,
                                       x.device)
    orient = torch.arange(n_orient, dtype=torch.float32, device=x.device)
    maps = torch.stack([gx_img, gy_img])
    plus, minus = P.orthogonal_shifted_points(x, y, theta, shift_mag)
    kx = torch.cat([plus[:, 0], minus[:, 0]])
    ky = torch.cat([plus[:, 1], minus[:, 1]])
    kt = torch.cat([theta, theta])
    two_pi = 2.0 * math.pi
    outs = []
    for s in range(0, max(2 * N, 1), chunk):
        kx_c, ky_c, kt_c = kx[s:s + chunk], ky[s:s + chunk], kt[s:s + chunk]
        ct = torch.cos(kt_c)[:, None]
        st = torch.sin(kt_c)[:, None]
        sx = kx_c[:, None] + ct * ii - st * jj
        sy = ky_c[:, None] + st * ii + ct * jj
        gx, gy = P.sample_around(maps, kx_c, ky_c, sx, sy, tile, stride)
        mag = torch.sqrt(gx * gx + gy * gy) * gauss
        ang = torch.atan2(gy, gx) - kt_c[:, None]
        ob = torch.remainder(ang, two_pi) / two_pi * n_orient
        dd = torch.abs(ob[..., None] - orient)
        dd = torch.minimum(dd, n_orient - dd)
        T = mag[..., None] * torch.clamp(1.0 - dd, min=0.0)   # (b, S, 8)
        desc = torch.einsum("sp,kso->kpo", SP, T).reshape(-1, D)
        desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1,
                                                    keepdim=True), min=1e-7)
        desc = torch.clamp(desc, max=clip)
        norm2 = torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True),
                            min=1e-7)
        outs.append((desc / norm2 * scale).to(torch.bfloat16))
    out = torch.cat(outs)
    return torch.cat([out[:N], out[N:]], 1)


def min_cross_distance_dot(desc_a, desc_b):
    """Min of the 4 cross L2 distances between 2-keypoint descriptors via
    |a|^2 + |b|^2 - 2 a.b. desc_a (B, 2*D); desc_b (B, C, 2*D) -> (B, C)."""
    a = desc_a.to(torch.float32)
    b = desc_b.to(torch.float32)
    D = a.shape[-1] // 2
    a_h = torch.stack([a[..., :D], a[..., D:]], -2)        # (B, 2, D)
    a2 = (a_h * a_h).sum(-1)                               # (B, 2)
    d2s = []
    for b_h in (b[..., :D], b[..., D:]):
        b2 = (b_h * b_h).sum(-1)                           # (B, C)
        ab = torch.einsum("bid,bcd->bci", a_h, b_h)        # (B, C, 2)
        d2s.append(a2[:, None, :] + b2[..., None] - 2.0 * ab)
    d2 = torch.minimum(d2s[0], d2s[1])
    return torch.sqrt(torch.clamp(d2.min(-1).values, min=0.0))
