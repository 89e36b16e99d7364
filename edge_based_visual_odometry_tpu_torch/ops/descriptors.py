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
K5 adds only the terms that are not +0 (each sample's hat at its 2 bins,
each cell's list without its padding, `_k5_terms`): every term is >= +0,
so the sums keep every bit. The static tables are computed here, in
PyTorch, for both; K5 forms the keypoints and their cosine and sine
itself, with the arithmetic of `_keypoints`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.ops import patches as P

TWO_PI = 2.0 * math.pi
# K5's 2 pi and the twin's multiply for `/ TWO_PI`: its float32 reciprocal
_TWO_PI_F32 = float(np.float32(TWO_PI))
_INV_TWO_PI_F32 = float(np.float32(1.0) / np.float32(TWO_PI))
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


K5_COLOURS, K5_PER_COLOUR = 16, 17   # K5's record slots: colour = slot % 16


def _bank_colours(idx, lens, S):
    """A colour 0-15 for each of S samples, at most 17 samples a colour,
    such that the samples the cells read at one term step (row j of
    `idx` (L, cells) where j < lens) differ in colour where it can: K5
    places sample s at a record slot of its colour, so that those reads
    fall on distinct shared-memory banks. Greedy, the most constrained
    sample first (DSATUR); deterministic."""
    together = np.zeros((S, S), np.int64)
    for j in range(idx.shape[0]):
        c = np.unique(idx[j, lens > j])
        together[np.ix_(c, c)] += 1
    np.fill_diagonal(together, 0)
    degree = (together > 0).sum(1)
    colour = np.full(S, -1)
    count = np.zeros(K5_COLOURS, np.int64)
    clash = np.zeros((S, K5_COLOURS), np.int64)   # co-reads with colour k
    for _ in range(S):
        free = np.nonzero(colour < 0)[0]
        saturation = (clash[free] > 0).sum(1)
        s = free[np.lexsort((-degree[free], -saturation))[0]]
        k = int(np.argmin(np.where(count < K5_PER_COLOUR, clash[s],
                                   np.iinfo(np.int64).max)))
        colour[s], count[k] = k, count[k] + 1
        clash[:, k] += together[:, s]
    return colour


@functools.lru_cache(maxsize=None)
def _k5_terms(n_samples, n_spatial, spacing, device):
    """K5's tables, from `_cell_lists` (the table as computed on
    `device`): (terms (L, cells, 2) int32, term j of each cell {the
    sample's place, the bits of its weight}; lens (cells,) int32, the
    length of each cell's list without its padding; place (S,) int32).
    A sample's place is its record slot 16 r + k (k its colour from
    `_bank_colours`, r its rank among the samples of that colour) in the
    low 16 bits and the byte of its o_lo, 4 (k + 16 (r // 4)) + r % 4, in
    the high 16."""
    idx, w = _cell_lists(n_samples, n_spatial, spacing, device)
    lens = (w != 0).sum(0).to(torch.int32)
    S = n_samples * n_samples
    colour = _bank_colours(idx.cpu().numpy(), lens.cpu().numpy(), S)
    rank = np.zeros(S, np.int64)
    for k in range(K5_COLOURS):
        mine = colour == k
        rank[mine] = np.arange(int(mine.sum()))
    slot = K5_COLOURS * rank + colour
    byte = 4 * (colour + K5_COLOURS * (rank // 4)) + rank % 4
    place = torch.from_numpy((slot | byte << 16).astype(np.int32)).to(device)
    terms = torch.stack([place[idx.long()], w.view(torch.int32)], -1)
    return terms.contiguous(), lens, place


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


@functools.lru_cache(maxsize=None)
def _k5_maps(device_index, stream, H, W):
    """The CUDA array of {gx, gy} pairs that K5's launches on `stream`
    write and read (`edge_descriptors_maps_create`), made at the first
    call of a shape and kept: (texture, surface) handles."""
    buf = (ctypes.c_ulonglong * 3)()
    CB.check(CB.lib().edge_descriptors_maps_create(H, W, buf),
             "edge_descriptors_maps_create")
    return buf[1], buf[2]


def edge_descriptors_cuda(gx_img, gy_img, x, y, theta, shift_mag: float = 8.0,
                          n_samples: int = 16, n_spatial: int = 4,
                          n_orient: int = 8, spacing: float = 1.0,
                          clip: float = 0.2, scale: float = 512.0,
                          tile: int = 40, stride: int = 8):
    """The hand-written kernel (csrc/edge_descriptors.cu, K5): same
    contract as `edge_descriptors_plain`, for contiguous float32 CUDA
    tensors, 4 x 4 cells x 8 orientation bins and at most 16 x 16
    samples; one launch (the {gx, gy} interleave into the map's CUDA
    array, then the kernel), written straight into the (N, 256) output."""
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
    ii, jj, gauss, _ = _static_tables(n_samples, n_spatial, spacing, dev)
    terms, lens, place = _k5_terms(n_samples, n_spatial, spacing, dev)
    with torch.cuda.device(dev):
        stream = CB.stream_ptr(dev)
        tex, surf = _k5_maps(dev.index, stream, H, W)
        err = CB.lib().edge_descriptors_launch(
            gx_img.data_ptr(), gy_img.data_ptr(), tex, surf, H, W,
            x.data_ptr(), y.data_ptr(), theta.data_ptr(), N, shift_mag,
            ii.data_ptr(), jj.data_ptr(), gauss.data_ptr(), place.data_ptr(),
            S, terms.data_ptr(), lens.data_ptr(), tile, stride, _TWO_PI_F32,
            _INV_TWO_PI_F32, clip, scale, out.data_ptr(), stream)
    CB.check(err, "edge_descriptors")
    CB.LAUNCHES["edge_descriptors"] += 1
    return out


def k5_info():
    """What the built K5 is on this card: warps a block, registers a
    thread, local (spill) bytes a thread, static shared bytes a block,
    blocks and warps an SM (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`)."""
    buf = (ctypes.c_int * 5)()
    CB.check(CB.lib().edge_descriptors_info(ctypes.addressof(buf)),
             "edge_descriptors_info")
    return dict(warps_per_block=buf[0], registers=buf[1],
                local_bytes=buf[2], shared_bytes=buf[3],
                blocks_per_sm=buf[4], warps_per_sm=buf[0] * buf[4])


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
