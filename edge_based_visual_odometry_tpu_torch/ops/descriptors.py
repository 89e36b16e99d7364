"""Gradient-orientation-histogram edge descriptor (the SIFT stand-in).

Port of `edge_based_visual_odometry_tpu/ops/descriptors.py`:
`edge_descriptors` has the semantics of the reference's
`edge_descriptors_tiled` (16x16 rotated sample grid, 4x4 spatial cells x
8 orientation bins, Gaussian radial weight, L2 normalize / clip 0.2 /
renormalize / scale 512) including its bf16 output cast, which the
descriptor gates see.

`edge_descriptors` runs, on CUDA tensors, the hand-written kernel
`csrc/edge_descriptors.cu` (K5, `edge_descriptors_cuda`), and on CPU
tensors its plain twin `edge_descriptors_plain`. The twin does its float
arithmetic in K5's order, so the two agree bit for bit on the card:
  - a bin (cell p, orientation o) adds SP[s, p] * T[s, o] over the
    samples s of cell p's list (`_cell_lists`: the samples whose spatial
    weight SP[s, p] is not 0 in the table as computed, ascending, padded
    with weight 0; term j of every cell's list side by side, so that a
    warp reads a term of all 16 lists at once), one term after another;
  - the norms add the squares of lane l's bins q l .. q l + q - 1 in order
    (q = D / 32, 4 at 4 x 4 x 8), then over the 32 lanes by a butterfly
    (`_warp_norm`).
Every value that does not depend on a sample (the keypoints, their cosine
and sine, the static tables) is computed here, in PyTorch, for both.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.ops import patches as P

TWO_PI = 2.0 * math.pi
MAX_SAMPLES = 256     # K5 keeps a keypoint's samples in shared memory
K5_CELLS, K5_ORIENT = 16, 8     # K5's histogram: 4 x 4 cells x 8 bins


@functools.lru_cache(maxsize=None)
def _static_tables(n_samples, n_spatial, spacing, device):
    """Sample offsets (ii, jj), Gaussian weights (S,) and spatial hat
    weights SP (S, n_spatial^2), computed on `device`."""
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


@functools.lru_cache(maxsize=None)
def _cell_lists(n_samples, n_spatial, spacing, device):
    """Term j of each cell's list: samples (L, cells) int32 and their
    weights SP[s, p] (L, cells) float32. A cell's list holds the samples
    whose SP is not 0 in the table as computed on `device` (float32 leaves
    weights of ~1e-7 where the ideal hat is 0, and they count), ascending;
    lists shorter than the longest, L, end in sample 0 at weight 0. Cached,
    as the tables are: L is read back from the device."""
    SP = _static_tables(n_samples, n_spatial, spacing, device)[3]
    nz = SP != 0
    L = int(nz.sum(0).max())
    order = torch.sort((~nz).to(torch.int8), dim=0, stable=True).indices[:L]
    keep = torch.gather(nz, 0, order)
    idx = torch.where(keep, order, torch.zeros_like(order))
    w = torch.where(keep, torch.gather(SP, 0, order),
                    torch.zeros((), device=device))
    return idx.to(torch.int32).contiguous(), w.contiguous()


def _keypoints(x, y, theta, shift_mag):
    """The 2N keypoints [plus | minus] shifted +-shift_mag along the edge
    normals: (kx, ky, theta, cos theta, sin theta), each (2N,)."""
    plus, minus = P.orthogonal_shifted_points(x, y, theta, shift_mag)
    kt = torch.cat([theta, theta])
    return (torch.cat([plus[:, 0], minus[:, 0]]),
            torch.cat([plus[:, 1], minus[:, 1]]), kt, torch.cos(kt),
            torch.sin(kt))


def _warp_norm(desc):
    """L2 norms (b, 1) of (b, D) rows in K5's order: lane l of 32 holds
    bins q l .. q l + q - 1 (q = ceil(D / 32), 4 at K5's 128), adds their
    squares in order, then the lanes add by a butterfly (as
    `gauss_newton._lane_sum`'s)."""
    b, D = desc.shape
    q = -(-D // 32)
    sq = torch.nn.functional.pad(desc * desc, (0, 32 * q - D)).reshape(b, 32, q)
    s = sq[:, :, 0]
    for i in range(1, q):
        s = s + sq[:, :, i]
    for o in (16, 8, 4, 2, 1):
        s = s[:, :o] + s[:, o:2 * o]
    return torch.sqrt(s)


def edge_descriptors_plain(gx_img, gy_img, x, y, theta, shift_mag: float = 8.0,
                           n_samples: int = 16, n_spatial: int = 4,
                           n_orient: int = 8, spacing: float = 1.0,
                           clip: float = 0.2, scale: float = 512.0,
                           tile: int = 40, stride: int = 8,
                           chunk: int = 16384):
    """Plain-PyTorch twin of K5 (module docstring): FLAT (N, 2*D) bf16,
    [plus | minus]. Chunked over keypoints to bound memory; chunking never
    changes results."""
    N = x.shape[0]
    n_cells = n_spatial * n_spatial
    D = n_cells * n_orient
    dev = x.device
    ii, jj, gauss, _ = _static_tables(n_samples, n_spatial, spacing, dev)
    idx, w = _cell_lists(n_samples, n_spatial, spacing, dev)
    idx = idx.long()
    orient = torch.arange(n_orient, dtype=torch.float32, device=dev)
    maps = torch.stack([gx_img, gy_img])
    kx, ky, kt, ct, st = _keypoints(x, y, theta, shift_mag)
    outs = []
    for s in range(0, max(2 * N, 1), chunk):
        c = slice(s, s + chunk)
        sx = kx[c, None] + ct[c, None] * ii - st[c, None] * jj
        sy = ky[c, None] + st[c, None] * ii + ct[c, None] * jj
        gx, gy = P.sample_around(maps, kx[c], ky[c], sx, sy, tile, stride)
        mag = torch.sqrt(gx * gx + gy * gy) * gauss
        ang = torch.atan2(gy, gx) - kt[c, None]
        ob = torch.remainder(ang, TWO_PI) / TWO_PI * n_orient
        dd = torch.abs(ob[..., None] - orient)
        dd = torch.minimum(dd, n_orient - dd)
        T = mag[..., None] * torch.clamp(1.0 - dd, min=0.0)   # (b, S, o)
        desc = torch.zeros((T.shape[0], n_cells, n_orient), device=dev)
        for j in range(idx.shape[0]):
            desc = desc + w[j, :, None] * T[:, idx[j]]
        desc = desc.reshape(-1, D)
        desc = desc / torch.clamp(_warp_norm(desc), min=1e-7)
        desc = torch.clamp(desc, max=clip)
        norm2 = torch.clamp(_warp_norm(desc), min=1e-7)
        outs.append((desc / norm2 * scale).to(torch.bfloat16))
    out = torch.cat(outs)
    return torch.cat([out[:N], out[N:]], 1)


def edge_descriptors_cuda(gx_img, gy_img, x, y, theta, shift_mag: float = 8.0,
                          n_samples: int = 16, n_spatial: int = 4,
                          n_orient: int = 8, spacing: float = 1.0,
                          clip: float = 0.2, scale: float = 512.0,
                          tile: int = 40, stride: int = 8):
    """The hand-written kernel (csrc/edge_descriptors.cu, K5): same
    contract as `edge_descriptors_plain`, for contiguous float32 CUDA
    tensors, 4 x 4 cells x 8 orientation bins and at most 16 x 16
    samples; one launch, written straight into the (N, 256) output."""
    dev = x.device
    if not x.is_cuda:
        raise ValueError(f"edge_descriptors_cuda: needs CUDA tensors, got "
                         f"them on {dev}")
    if n_spatial * n_spatial != K5_CELLS or n_orient != K5_ORIENT:
        raise ValueError(f"edge_descriptors_cuda: {n_spatial}x{n_spatial} "
                         f"cells x {n_orient} bins; K5 computes 4x4 x 8")
    S = n_samples * n_samples
    if S > MAX_SAMPLES:
        raise ValueError(f"edge_descriptors_cuda: {S} samples a keypoint, "
                         f"K5 takes at most {MAX_SAMPLES}")
    if stride <= 0 or stride & (stride - 1):
        # K5 divides by the stride, the twin multiplies by its reciprocal:
        # the same only for a power of two
        raise ValueError(f"edge_descriptors_cuda: atlas stride {stride}, "
                         f"K5 takes a power of two")
    if x.dim() != 1 or gx_img.dim() != 2:
        raise ValueError(f"edge_descriptors_cuda: x of shape "
                         f"{tuple(x.shape)} and maps of shape "
                         f"{tuple(gx_img.shape)}, expected (N,) and (H, W)")
    N = x.shape[0]
    H, W = gx_img.shape
    CB.require(gx_img, "gx_img", torch.float32, (H, W), dev)
    CB.require(gy_img, "gy_img", torch.float32, (H, W), dev)
    for name, t in (("x", x), ("y", y), ("theta", theta)):
        CB.require(t, name, torch.float32, (N,), dev)
    out = torch.empty((N, 2 * K5_CELLS * K5_ORIENT), dtype=torch.bfloat16,
                      device=dev)
    if N == 0:
        return out
    kx, ky, kt, ct, st = _keypoints(x, y, theta, shift_mag)
    ii, jj, gauss, _ = _static_tables(n_samples, n_spatial, spacing, dev)
    idx, w = _cell_lists(n_samples, n_spatial, spacing, dev)
    two_pi = np.float32(TWO_PI)
    with torch.cuda.device(dev):
        err = CB.lib().edge_descriptors_launch(
            gx_img.data_ptr(), gy_img.data_ptr(), H, W, kx.data_ptr(),
            ky.data_ptr(), kt.data_ptr(), ct.data_ptr(), st.data_ptr(), N,
            ii.data_ptr(), jj.data_ptr(), gauss.data_ptr(), S, idx.data_ptr(),
            w.data_ptr(), idx.shape[0], tile, stride, float(two_pi),
            float(np.float32(1.0) / two_pi), clip, scale, out.data_ptr(),
            CB.stream_ptr(dev))
    CB.check(err, "edge_descriptors")
    CB.LAUNCHES["edge_descriptors"] += 1
    return out


def edge_descriptors(gx_img, gy_img, x, y, theta, shift_mag: float = 8.0,
                     n_samples: int = 16, n_spatial: int = 4,
                     n_orient: int = 8, spacing: float = 1.0,
                     clip: float = 0.2, scale: float = 512.0,
                     tile: int = 40, stride: int = 8,
                     chunk: int = 16384):
    """Descriptors at the two orthogonally shifted keypoints of (N,) edges:
    FLAT (N, 2*D) bf16, [plus | minus]. K5 for CUDA tensors, the plain
    twin (in keypoint chunks of `chunk`) for CPU tensors."""
    kw = dict(shift_mag=shift_mag, n_samples=n_samples, n_spatial=n_spatial,
              n_orient=n_orient, spacing=spacing, clip=clip, scale=scale,
              tile=tile, stride=stride)
    if x.is_cuda:
        return edge_descriptors_cuda(gx_img, gy_img, x, y, theta, **kw)
    if x.device.type != "cpu":
        raise ValueError(f"edge_descriptors: unsupported device {x.device}")
    return edge_descriptors_plain(gx_img, gy_img, x, y, theta, chunk=chunk,
                                  **kw)


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
