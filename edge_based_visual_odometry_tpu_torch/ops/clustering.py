"""Vectorized agglomerative edge clustering.

Port of `edge_based_visual_odometry_tpu/ops/clustering.py::cluster_edges`:
connected components of the thresholded pairwise-distance graph by
min-label propagation with pointer jumping, the centroid-ranked
MAX_CLUSTER_SIZE cap (members beyond the cap nearest the component
centroid revert to singletons), and the Gaussian-weighted cluster
representative. Rows are processed in chunks to bound the (rows, C, C, C)
rank comparison; chunking never changes results.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class ClusterResult(NamedTuple):
    x: torch.Tensor        # (N, C) cluster-center x (representative slots)
    y: torch.Tensor
    theta: torch.Tensor
    mask: torch.Tensor     # (N, C) True only at representative slots
    label: torch.Tensor    # (N, C) int64 component label
    members: torch.Tensor  # (N, C, C) bool membership matrix M[r, j]


def _labels(x, y, theta, mask, dist_thresh, orient_thresh_deg,
            by_orientation, max_cluster_size):
    N, C = x.shape
    dx = x[:, :, None] - x[:, None, :]
    dy = y[:, :, None] - y[:, None, :]
    adj = torch.sqrt(dx * dx + dy * dy) < dist_thresh
    if by_orientation:
        dth = torch.abs(theta[:, :, None] - theta[:, None, :])
        adj = adj & (dth < math.radians(orient_thresh_deg))
    eye = torch.eye(C, dtype=torch.bool, device=x.device)
    adj = (adj & mask[:, :, None] & mask[:, None, :]) | eye
    iota = torch.arange(C, device=x.device)
    lab = iota.expand(N, C).clone()
    big = torch.full((), C, dtype=lab.dtype, device=x.device)
    # reach after k rounds: d_{k+1} = 2 (d_k + 1)
    for _ in range(max(1, int(math.ceil(math.log2(max(C, 2)))) + 2)):
        masked = torch.where(adj, lab[:, None, :], big)
        lab = torch.minimum(lab, masked.min(-1).values)
        lab = torch.minimum(lab, torch.gather(lab, 1, lab))  # pointer jump
    lab = torch.where(mask, lab, big)

    if max_cluster_size and max_cluster_size < C:
        M0 = (lab[:, None, :] == iota[:, None]) & mask[:, None, :]
        M0f = M0.to(x.dtype)
        cnt0 = torch.clamp(M0f.sum(-1), min=1.0)
        cx0 = torch.einsum("nrj,nj->nr", M0f, x) / cnt0
        cy0 = torch.einsum("nrj,nj->nr", M0f, y) / cnt0
        ddx0 = x[:, None, :] - cx0[:, :, None]
        ddy0 = y[:, None, :] - cy0[:, :, None]
        dc = torch.sqrt(ddx0 * ddx0 + ddy0 * ddy0)          # (n, r, j)
        A = dc[:, :, :, None]                               # (n, r, k, 1)
        B = dc[:, :, None, :]                               # (n, r, 1, j)
        k_lt_j = iota[:, None] < iota[None, :]
        closer = (A < B) | ((A == B) & k_lt_j)
        rank = (closer & M0[:, :, :, None]).sum(-2)         # (n, r, j)
        my_rank = torch.where(M0, rank, torch.zeros_like(rank)).sum(-2)
        kept = my_rank < max_cluster_size
        same = lab[:, :, None] == lab[:, None, :]
        cand = torch.where(same & kept[:, None, :] & mask[:, None, :],
                           iota[None, None, :], big)
        core_lab = cand.min(-1).values
        lab = torch.where(mask & kept, core_lab,
                          torch.where(mask, iota.expand(N, C), lab))
    return lab


def cluster_edges(x, y, theta, mask, dist_thresh: float = 1.0,
                  orient_thresh_deg: float = 20.0, by_orientation: bool = True,
                  gauss_sigma: float = 2.0, max_cluster_size: int = 0,
                  chunk: int = 4096) -> ClusterResult:
    """Cluster the candidate sets of (N, C) edge arrays (see module
    docstring); the orientation gate is the raw radian difference."""
    N, C = x.shape
    lab = torch.cat([
        _labels(x[s:s + chunk], y[s:s + chunk], theta[s:s + chunk],
                mask[s:s + chunk], dist_thresh, orient_thresh_deg,
                by_orientation, max_cluster_size)
        for s in range(0, max(N, 1), chunk)])
    iota = torch.arange(C, device=x.device)
    M = (lab[:, None, :] == iota[:, None]) & mask[:, None, :]
    Mf = M.to(x.dtype)
    safe_cnt = torch.clamp(Mf.sum(-1), min=1.0)
    cen_x = torch.einsum("nrj,nj->nr", Mf, x) / safe_cnt
    cen_y = torch.einsum("nrj,nj->nr", Mf, y) / safe_cnt
    ddx = x[:, None, :] - cen_x[:, :, None]
    ddy = y[:, None, :] - cen_y[:, :, None]
    d_cen = torch.sqrt(ddx * ddx + ddy * ddy)
    mean_shift = (Mf * d_cen).sum(-1) / safe_cnt
    w = torch.exp(-0.5 * ((d_cen - mean_shift[:, :, None]) / gauss_sigma) ** 2)
    w = w * Mf
    wsum = torch.clamp(w.sum(-1), min=1e-12)
    gx = torch.einsum("nrj,nj->nr", w, x) / wsum
    gy = torch.einsum("nrj,nj->nr", w, y) / wsum
    gt = torch.einsum("nrj,nj->nr", w, theta) / wsum
    rep = (lab == iota) & mask
    zero = torch.zeros_like(x)
    return ClusterResult(x=torch.where(rep, gx, zero),
                         y=torch.where(rep, gy, zero),
                         theta=torch.where(rep, gt, zero),
                         mask=rep, label=lab, members=M)
