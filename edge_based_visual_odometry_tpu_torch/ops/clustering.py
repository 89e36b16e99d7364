"""Vectorized agglomerative edge clustering.

Port of `edge_based_visual_odometry_tpu/ops/clustering.py::cluster_edges`:
label groups of the thresholded pairwise-distance graph by JAX's
`_rounds(C)` rounds of min-label propagation with pointer jumping (the
connected components where no component has more than 8 members; a
longer chain can end them in more than one label, and the port keeps
JAX's result), the centroid-ranked MAX_CLUSTER_SIZE cap (members beyond
the cap nearest the group's centroid revert to singletons), and the
Gaussian-weighted cluster representative.

`cluster_edges` runs, on CUDA tensors, the hand-written kernel
`csrc/cluster_edges.cu` (K4, `cluster_edges_cuda`), and on CPU tensors its
plain twin `cluster_edges_plain`, which processes rows in chunks to bound
the (rows, C, C, C) rank comparison (chunking never changes results). The
twin sums over slots in ascending order, one term after another; the
kernel adds the same terms in that order, those of masked slots only
where they can change a bit (csrc/cluster_edges.cu says when), so the
two agree bit for bit on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB

MAX_SLOTS = 64        # K4 holds a row's slots in one warp, two a lane


class ClusterResult(NamedTuple):
    x: torch.Tensor        # (N, C) cluster-center x (representative slots)
    y: torch.Tensor
    theta: torch.Tensor
    mask: torch.Tensor     # (N, C) True only at representative slots
    label: torch.Tensor    # (N, C) int64 component label
    members: torch.Tensor  # (N, C, C) bool membership matrix M[r, j]


def _f32(v: float) -> float:
    """`v` rounded to float32, as PyTorch rounds a Python scalar it
    compares with or multiplies into a float32 tensor."""
    return float(np.float32(v))


def _scalars(dist_thresh, orient_thresh_deg, gauss_sigma):
    """(distance threshold, orientation threshold in radians, 1 / sigma)
    as the float32 values both versions compare and multiply with."""
    return (_f32(dist_thresh), _f32(math.radians(orient_thresh_deg)),
            float(np.float32(1.0) / np.float32(gauss_sigma)))


def _rounds(C: int) -> int:
    # JAX's count: it reaches every member of a group of at most 8
    # members (diameter <= 7), not always the far end of a longer chain
    return max(1, int(math.ceil(math.log2(max(C, 2)))) + 2)


def _seq_sum(t):
    """Sum over the last axis in ascending order, one term after another
    (the order in which a lane of K4 adds its slots)."""
    s = t[..., 0]
    for j in range(1, t.shape[-1]):
        s = s + t[..., j]
    return s


def _labels(x, y, theta, mask, thresh, orient_rad, by_orientation,
            max_cluster_size):
    N, C = x.shape
    dx = x[:, :, None] - x[:, None, :]
    dy = y[:, :, None] - y[:, None, :]
    adj = torch.sqrt(dx * dx + dy * dy) < thresh
    if by_orientation:
        dth = torch.abs(theta[:, :, None] - theta[:, None, :])
        adj = adj & (dth < orient_rad)
    eye = torch.eye(C, dtype=torch.bool, device=x.device)
    adj = (adj & mask[:, :, None] & mask[:, None, :]) | eye
    iota = torch.arange(C, device=x.device)
    lab = iota.expand(N, C).clone()
    big = torch.full((), C, dtype=lab.dtype, device=x.device)
    for _ in range(_rounds(C)):
        masked = torch.where(adj, lab[:, None, :], big)
        lab = torch.minimum(lab, masked.min(-1).values)
        lab = torch.minimum(lab, torch.gather(lab, 1, lab))  # pointer jump
    lab = torch.where(mask, lab, big)

    if max_cluster_size and max_cluster_size < C:
        M0 = (lab[:, None, :] == iota[:, None]) & mask[:, None, :]
        M0f = M0.to(x.dtype)
        cnt0 = torch.clamp(M0f.sum(-1), min=1.0)   # integers: any order
        cx0 = _seq_sum(M0f * x[:, None, :]) / cnt0
        cy0 = _seq_sum(M0f * y[:, None, :]) / cnt0
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


def cluster_edges_plain(x, y, theta, mask, dist_thresh: float = 1.0,
                        orient_thresh_deg: float = 20.0,
                        by_orientation: bool = True, gauss_sigma: float = 2.0,
                        max_cluster_size: int = 0,
                        chunk: int = 4096) -> ClusterResult:
    """The plain twin of K4 (see module docstring), on any device; the
    orientation gate is the raw radian difference."""
    N, C = x.shape
    thresh, orient_rad, inv_sigma = _scalars(dist_thresh, orient_thresh_deg,
                                             gauss_sigma)
    lab = torch.cat([
        _labels(x[s:s + chunk], y[s:s + chunk], theta[s:s + chunk],
                mask[s:s + chunk], thresh, orient_rad, by_orientation,
                max_cluster_size)
        for s in range(0, max(N, 1), chunk)])
    iota = torch.arange(C, device=x.device)
    M = (lab[:, None, :] == iota[:, None]) & mask[:, None, :]
    Mf = M.to(x.dtype)
    safe_cnt = torch.clamp(Mf.sum(-1), min=1.0)         # integers: any order
    cen_x = _seq_sum(Mf * x[:, None, :]) / safe_cnt
    cen_y = _seq_sum(Mf * y[:, None, :]) / safe_cnt
    ddx = x[:, None, :] - cen_x[:, :, None]
    ddy = y[:, None, :] - cen_y[:, :, None]
    d_cen = torch.sqrt(ddx * ddx + ddy * ddy)
    mean_shift = _seq_sum(Mf * d_cen) / safe_cnt
    z = (d_cen - mean_shift[:, :, None]) * inv_sigma
    w = torch.exp(-0.5 * (z * z)) * Mf
    wsum = torch.clamp(_seq_sum(w), min=1e-12)
    gx = _seq_sum(w * x[:, None, :]) / wsum
    gy = _seq_sum(w * y[:, None, :]) / wsum
    gt = _seq_sum(w * theta[:, None, :]) / wsum
    rep = (lab == iota) & mask
    zero = torch.zeros_like(x)
    return ClusterResult(x=torch.where(rep, gx, zero),
                         y=torch.where(rep, gy, zero),
                         theta=torch.where(rep, gt, zero),
                         mask=rep, label=lab, members=M)


def cluster_edges_cuda(x, y, theta, mask, dist_thresh: float = 1.0,
                       orient_thresh_deg: float = 20.0,
                       by_orientation: bool = True, gauss_sigma: float = 2.0,
                       max_cluster_size: int = 0) -> ClusterResult:
    """The hand-written kernel (csrc/cluster_edges.cu, K4): same contract
    as `cluster_edges_plain`, for contiguous float32 (N, C <= 64) CUDA
    tensors and a bool mask; one launch."""
    dev = x.device
    if not x.is_cuda:
        raise ValueError(f"cluster_edges_cuda: needs CUDA tensors, got them "
                         f"on {dev}")
    if x.dim() != 2:
        raise ValueError(f"cluster_edges_cuda: x of shape {tuple(x.shape)}, "
                         f"expected (N, C)")
    N, C = x.shape
    if C > MAX_SLOTS:
        raise ValueError(f"cluster_edges_cuda: {C} slots a row, the kernel "
                         f"takes at most {MAX_SLOTS}")
    for name, t in (("x", x), ("y", y), ("theta", theta)):
        CB.require(t, name, torch.float32, (N, C), dev)
    CB.require(mask, "mask", torch.bool, (N, C), dev)
    out = [torch.empty((N, C), dtype=torch.float32, device=dev)
           for _ in range(3)]
    rep = torch.empty((N, C), dtype=torch.bool, device=dev)
    lab = torch.empty((N, C), dtype=torch.int64, device=dev)
    members = torch.empty((N, C, C), dtype=torch.bool, device=dev)
    res = ClusterResult(*out, mask=rep, label=lab, members=members)
    if N == 0 or C == 0:
        return res
    thresh, orient_rad, inv_sigma = _scalars(dist_thresh, orient_thresh_deg,
                                             gauss_sigma)
    with torch.cuda.device(dev):
        err = CB.lib().cluster_edges_launch(
            x.data_ptr(), y.data_ptr(), theta.data_ptr(), mask.data_ptr(), N,
            C, thresh, int(bool(by_orientation)), orient_rad, inv_sigma,
            int(max_cluster_size), _rounds(C),
            *(t.data_ptr() for t in res), CB.stream_ptr(dev))
    CB.check(err, "cluster_edges")
    CB.LAUNCHES["cluster_edges"] += 1
    return res


def cluster_edges(x, y, theta, mask, dist_thresh: float = 1.0,
                  orient_thresh_deg: float = 20.0, by_orientation: bool = True,
                  gauss_sigma: float = 2.0, max_cluster_size: int = 0,
                  chunk: int = 4096) -> ClusterResult:
    """Cluster the candidate sets of (N, C) edge arrays (see module
    docstring): K4 for CUDA tensors, the plain twin (in row chunks of
    `chunk`) for CPU tensors."""
    kw = dict(dist_thresh=dist_thresh, orient_thresh_deg=orient_thresh_deg,
              by_orientation=by_orientation, gauss_sigma=gauss_sigma,
              max_cluster_size=max_cluster_size)
    if x.is_cuda:
        return cluster_edges_cuda(x, y, theta, mask, **kw)
    if x.device.type != "cpu":
        raise ValueError(f"cluster_edges: unsupported device {x.device}")
    return cluster_edges_plain(x, y, theta, mask, chunk=chunk, **kw)
