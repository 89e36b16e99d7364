"""Rotated-patch sampling, NCC scoring and the dense gates.

Port of `edge_based_visual_odometry_tpu/ops/patches.py`. `edge_patches`
has the semantics of the reference's `edge_patches_tiled`: every sample is
read through `sample_tile_clamped`, the bilinear sampler of the
reference's atlas tiles (hat weights, tile clamp, edge-replicate
padding). For patches and descriptors the tile clamp never binds (the
reference's static coverage guard), so this equals border-clamped
bilinear sampling; for the GN refiners it bounds the travel.

Two hand-written kernels sit behind this module's wrappers, which send a
CUDA tensor to the kernel and a CPU tensor to its plain twin:
  - K7 (`csrc/edge_patches.cu`): `edge_patches` / `edge_patches_flat`,
    twin `edge_patches_plain`; given a `live` mask (stage 11's flat
    list), K7 samples the live edges only;
  - K6 (`csrc/dense_gates.cu`): the stereo cascade's descriptor gate and
    NCC (stages 4-5, `dense_gates_stereo`), its post-cluster NCC over
    a flat pair list (stage 11, `dense_gates_flat`) and the temporal
    cascade's NCC and descriptor gates (`dense_gates_temporal`); twins
    `dense_gates_*_plain`. They write only the live slots of the mask
    they are given; every other slot gets the fill the caller names
    (the value its state held before the stage). The stereo and
    temporal entries launch a prep pass over the candidate table first
    (each row's centring and |b|^2 formed once), so they count two
    launches.
The twins do their float arithmetic in the kernels' order, so each
agrees with its kernel bit for bit on the card:
  - a sum over one side of a patch (P*P <= 128 samples): sample s on
    lane s % 32, slot s // 32 of 2 slots (P*P <= 64) or 4; each lane adds
    its slots in order (0 past the side), then a butterfly over the 32
    lanes (`_lane_sum`); the mean is that sum times the float32
    reciprocal of P*P;
  - a dot over one 128-bin half of a descriptor: bin k on lane k // 8 of
    16, each lane adds its 8 products in order, then a butterfly over the
    16 lanes (`_half_dot`).
`ncc`, `ncc4` and `descriptors.min_cross_distance_dot` keep JAX's form;
the tests hold the twins against them and against JAX.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.ops import tiled_sampling as TS

MAX_SIDE = 128       # K6, K7: a patch side's P*P samples, <= 4 a lane of 32
MAX_PATCH = 11       # K2, K3, K6, K7: odd patch sizes up to 11 (2 P^2 <= 242)
K6_DESC = 256        # K6: two 128-bin bf16 halves, K5's output
MAX_SLOTS = 64       # K6: a row's live slots as one 64-bit mask
NCC_EPS = 1e-10      # K6: a side is degenerate below this sum of squares


def bilinear_sample_nan(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Bilinear interpolation with out-of-bounds detection: returns (value,
    in_bounds), out of bounds when floor(x) < 0 or ceil(x) > W-1 (same for
    y). Callers mask instead of propagating NaN."""
    H, W = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    x1 = torch.ceil(x)
    y1 = torch.ceil(y)
    inb = (x0 >= 0) & (y0 >= 0) & (x1 <= W - 1) & (y1 <= H - 1)
    x0i = torch.clamp(x0, 0, W - 1).to(torch.int64)
    y0i = torch.clamp(y0, 0, H - 1).to(torch.int64)
    x1i = torch.clamp(x1, 0, W - 1).to(torch.int64)
    y1i = torch.clamp(y1, 0, H - 1).to(torch.int64)
    v00 = img[y0i, x0i]
    v10 = img[y0i, x1i]
    v01 = img[y1i, x0i]
    v11 = img[y1i, x1i]
    a = x - x0
    b = y - y0
    val = ((1 - a) * (1 - b) * v00 + a * (1 - b) * v10
           + (1 - a) * b * v01 + a * b * v11)
    return val, inb


def bilinear_sample_clamp(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Bilinear sampling with coordinates clamped to the image."""
    H, W = img.shape
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    a = x - x0
    b = y - y0
    v00 = img[y0, x0]
    v10 = img[y0, x1]
    v01 = img[y1, x0]
    v11 = img[y1, x1]
    return ((1 - a) * (1 - b) * v00 + a * (1 - b) * v10
            + (1 - a) * b * v01 + a * b * v11)


def _index(v, n: int):
    """Integer index of a float position clamped to n - 1; a NaN position
    (a GN lane whose step went NaN) reads index 0 with its NaN weights, as
    the card's float-to-int conversion makes it, not an undefined index."""
    return torch.nan_to_num(torch.clamp(v, max=n - 1), nan=0.0).to(torch.int64)


def sample_tile_clamped(maps: torch.Tensor, ox, oy, xs, ys, tile: int):
    """Bilinear samples of (H, W) or (C, H, W) maps at absolute coords
    (xs, ys), each clamped to the T x T tile at origin (ox, oy) and read
    with edge-replicate padding beyond the image. ox/oy broadcast against
    xs/ys. Returns xs.shape, or (C, *xs.shape) for stacked maps.

    Same arithmetic as the reference's hat-weight contraction: the column
    weights combine first, then the row weights."""
    squeeze = maps.dim() == 2
    if squeeze:
        maps = maps[None]
    C, H, W = maps.shape
    rx = torch.clamp(xs - ox, 0.0, tile - 1.0)
    ry = torch.clamp(ys - oy, 0.0, tile - 1.0)
    x0 = torch.floor(rx)
    y0 = torch.floor(ry)
    wc0 = 1.0 - torch.abs(rx - x0)
    wc1 = 1.0 - torch.abs(rx - (x0 + 1.0))
    wr0 = 1.0 - torch.abs(ry - y0)
    wr1 = 1.0 - torch.abs(ry - (y0 + 1.0))
    ix0 = _index(ox + x0, W)
    ix1 = _index(ox + x0 + 1.0, W)
    iy0 = _index(oy + y0, H)
    iy1 = _index(oy + y0 + 1.0, H)
    flat = maps.reshape(C, H * W)

    def g(iy, ix):
        return flat[:, (iy * W + ix).reshape(-1)].reshape(C, *xs.shape)

    out = (wr0 * (wc0 * g(iy0, ix0) + wc1 * g(iy0, ix1))
           + wr1 * (wc0 * g(iy1, ix0) + wc1 * g(iy1, ix1)))
    return out[0] if squeeze else out


def sample_around(maps, cx, cy, xs, ys, tile: int, stride: int):
    """Sample (B, S) coords from the atlas tile picked for each anchor
    (cx, cy) of shape (B,)."""
    H, W = maps.shape[-2:]
    ox = TS.tile_origin(cx, tile, stride, W)[:, None]
    oy = TS.tile_origin(cy, tile, stride, H)[:, None]
    return sample_tile_clamped(maps, ox, oy, xs, ys, tile)


def orthogonal_shifted_points(x, y, theta, shift_mag: float):
    """(plus, minus) points shifted perpendicular to the edge direction:
    plus = (x + m sin t, y - m cos t)."""
    sx = shift_mag * torch.sin(theta)
    sy = shift_mag * torch.cos(theta)
    return (torch.stack([x + sx, y - sy], -1),
            torch.stack([x - sx, y + sy], -1))


def patch_offsets(patch_size: int, device):
    """(ii, jj) offsets of the P*P samples, i outer / j inner."""
    half = patch_size // 2
    offs = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    return offs.repeat_interleave(patch_size), offs.repeat(patch_size)


def rotated_patch_coords(cx, cy, theta, patch_size: int):
    """(..., P*P, 2) rotated patch coordinates:
    (cx + cos t * i - sin t * j, cy + sin t * i + cos t * j)."""
    ii, jj = patch_offsets(patch_size, cx.device)
    ct = torch.cos(theta)[..., None]
    st = torch.sin(theta)[..., None]
    px = cx[..., None] + ct * ii - st * jj
    py = cy[..., None] + st * ii + ct * jj
    return torch.stack([px, py], -1)


def edge_patches_plain(img, x, y, theta, patch_size: int, shift_mag: float,
                       tile: int = 32, stride: int = 8, chunk: int = 1 << 16):
    """Plain twin of K7: two-side rotated patches of (B,) edges, FLAT
    (B, 2*P*P) [plus | minus], and ok flags (B, 2) [plus, minus] that
    follow the NaN-on-OOB rule (every sample's floor/ceil inside the
    image). Chunked over B to bound memory; chunking never changes
    results."""
    B = x.shape[0]
    pp = patch_size * patch_size
    H, W = img.shape
    pats, oks = [], []
    for s in range(0, max(B, 1), chunk):
        x_c, y_c, t_c = x[s:s + chunk], y[s:s + chunk], theta[s:s + chunk]
        plus, minus = orthogonal_shifted_points(x_c, y_c, t_c, shift_mag)
        cp = rotated_patch_coords(plus[..., 0], plus[..., 1], t_c, patch_size)
        cm = rotated_patch_coords(minus[..., 0], minus[..., 1], t_c,
                                  patch_size)
        coords = torch.cat([cp, cm], -2)                 # (b, 2pp, 2)
        cx_, cy_ = coords[..., 0], coords[..., 1]
        pats.append(sample_around(img, x_c, y_c, cx_, cy_, tile, stride))
        inb = ((torch.floor(cx_) >= 0) & (torch.floor(cy_) >= 0)
               & (torch.ceil(cx_) <= W - 1) & (torch.ceil(cy_) <= H - 1))
        oks.append(torch.stack([inb[:, :pp].all(-1), inb[:, pp:].all(-1)],
                               1))
    return torch.cat(pats), torch.cat(oks)


def _check_patch_size(what, patch_size):
    if patch_size % 2 == 0 or not 0 < patch_size <= MAX_PATCH:
        raise ValueError(f"{what}: patch size {patch_size}, the kernel takes "
                         f"odd sizes up to {MAX_PATCH}")


def check_coverage(patch_size: int, shift_mag: float, tile: int = 32,
                   stride: int = 8, what: str = "edge_patches"):
    """The reference's static coverage guard (`edge_patches_tiled`): every
    sample of the two side patches must fit the nearest atlas tile, which
    reaches +-(tile / 2 - stride / 2 - 1) from the edge; the patches need
    shift_mag + (P // 2) * 1.4143 + 1. Raises ValueError, with the
    reference's numbers, where they do not fit (P = 9 needs a shift <=
    4.34, P = 11 <= 2.93 at tile 32, stride 8)."""
    need = shift_mag + (patch_size // 2) * 1.4143 + 1.0
    covers = tile / 2 - stride / 2 - 1
    if covers < need:
        raise ValueError(f"{what}: atlas tile {tile}/stride {stride} covers "
                         f"+-{covers}, patches need +-{need:.1f}")


def _patch_outputs(B: int, patch_size: int, dev):
    """K7's outputs, (B, 2 P^2) float32 patches and (B, 2) ok flags, as
    allocated: not initialised."""
    return (torch.empty((B, 2 * patch_size * patch_size), dtype=torch.float32,
                        device=dev),
            torch.empty((B, 2), dtype=torch.bool, device=dev))


def edge_patches_cuda(img, x, y, theta, patch_size: int, shift_mag: float,
                      tile: int = 32, stride: int = 8, live=None):
    """The hand-written kernel (csrc/edge_patches.cu, K7): same contract as
    `edge_patches_plain`, for a contiguous float32 (H, W) image and (B,)
    edges on the card, an odd P <= 11 and a power-of-two atlas stride;
    one launch. With `live`, a (B,) bool mask on the card, only
    the live edges are sampled and written: a dead edge's patch row and
    ok flags are unspecified (whatever the new buffers held)."""
    dev = x.device
    if not x.is_cuda:
        raise ValueError(f"edge_patches_cuda: needs CUDA tensors, got them "
                         f"on {dev}")
    _check_patch_size("edge_patches_cuda", patch_size)
    if stride <= 0 or stride & (stride - 1):
        # K7 divides by the stride, the twin multiplies by its reciprocal:
        # the same only for a power of two
        raise ValueError(f"edge_patches_cuda: atlas stride {stride}, K7 "
                         f"takes a power of two")
    if x.dim() != 1 or img.dim() != 2:
        raise ValueError(f"edge_patches_cuda: x of shape {tuple(x.shape)} "
                         f"and image of shape {tuple(img.shape)}, expected "
                         f"(B,) and (H, W)")
    B = x.shape[0]
    H, W = img.shape
    CB.require(img, "img", torch.float32, (H, W), dev)
    for name, t in (("x", x), ("y", y), ("theta", theta)):
        CB.require(t, name, torch.float32, (B,), dev)
    if live is not None:
        CB.require(live, "live", torch.bool, (B,), dev)
    pat, ok = _patch_outputs(B, patch_size, dev)
    if B == 0:
        return pat, ok
    with torch.cuda.device(dev):
        err = CB.lib().edge_patches_launch(
            img.data_ptr(), H, W, x.data_ptr(), y.data_ptr(),
            theta.data_ptr(), 0 if live is None else live.data_ptr(), B,
            patch_size, shift_mag, tile, stride, pat.data_ptr(),
            ok.data_ptr(), CB.stream_ptr(dev))
    CB.check(err, "edge_patches")
    CB.LAUNCHES["edge_patches"] += 1
    return pat, ok


def k7_info():
    """What the built K7 is on this card: edges a block, registers a
    thread, local (spill) bytes a thread, static shared bytes a block,
    blocks and warps an SM (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`,
    8 warps a block)."""
    buf = (ctypes.c_int * 5)()
    CB.check(CB.lib().edge_patches_info(ctypes.addressof(buf)),
             "edge_patches_info")
    return dict(edges_per_block=buf[0], registers=buf[1],
                local_bytes=buf[2], shared_bytes=buf[3],
                blocks_per_sm=buf[4], warps_per_sm=8 * buf[4])


def edge_patches_flat(img, x, y, theta, patch_size: int, shift_mag: float,
                      tile: int = 32, stride: int = 8, chunk: int = 1 << 16,
                      live=None):
    """Two-side rotated patches of (B,) edges: (patches (B, 2*P*P) [plus |
    minus], ok (B, 2)). K7 for CUDA tensors, the plain twin (in chunks of
    `chunk` edges) for CPU tensors. `live`, a (B,) bool mask, lets K7
    skip the dead edges, whose rows are then unspecified (the twin
    computes every row). On both devices a patch that does not fit the
    atlas tile raises (`check_coverage`), as in the reference."""
    check_coverage(patch_size, shift_mag, tile, stride)
    if x.is_cuda:
        return edge_patches_cuda(img, x, y, theta, patch_size, shift_mag,
                                 tile, stride, live)
    if x.device.type != "cpu":
        raise ValueError(f"edge_patches: unsupported device {x.device}")
    return edge_patches_plain(img, x, y, theta, patch_size, shift_mag, tile,
                              stride, chunk)


def edge_patches(img, x, y, theta, patch_size: int, shift_mag: float,
                 tile: int = 32, stride: int = 8, chunk: int = 1 << 16):
    """`edge_patches_flat` as the reference returns it: (patch_plus,
    patch_minus, ok_plus, ok_minus), patches (B, P*P) (views of the flat
    patches)."""
    pat, ok = edge_patches_flat(img, x, y, theta, patch_size, shift_mag,
                                tile, stride, chunk)
    pp = patch_size * patch_size
    return pat[:, :pp], pat[:, pp:], ok[:, 0], ok[:, 1]


def ncc(p1, p2, valid=None, eps: float = 1e-10):
    """Normalized cross-correlation of (..., K) patches; -1 where degenerate
    or invalid."""
    c1 = p1 - p1.mean(-1, keepdim=True)
    c2 = p2 - p2.mean(-1, keepdim=True)
    ss1 = (c1 * c1).sum(-1)
    ss2 = (c2 * c2).sum(-1)
    score = (c1 * c2).sum(-1) / torch.sqrt(torch.clamp(ss1 * ss2,
                                                       min=eps * eps))
    bad = (ss1 < eps) | (ss2 < eps)
    if valid is not None:
        bad = bad | ~valid
    return torch.where(bad, torch.full_like(score, -1.0), score)


def ncc4(ap, am, a_okp, a_okm, bp, bm, b_okp, b_okm):
    """Max of the 4 side pairings (A+,B+), (A-,B-), (A+,B-), (A-,B+)."""
    s_pp = ncc(ap, bp, a_okp & b_okp)
    s_nn = ncc(am, bm, a_okm & b_okm)
    s_pn = ncc(ap, bm, a_okp & b_okm)
    s_np = ncc(am, bp, a_okm & b_okp)
    return torch.maximum(torch.maximum(s_pp, s_nn), torch.maximum(s_pn, s_np))


# ---- K6: the dense NCC and descriptor gates ----

def _recip(n: int) -> float:
    """The float32 reciprocal of n, which the mean multiplies by."""
    return float(np.float32(1.0) / np.float32(n))


def _lane_leaves(v):
    """The 32 lane partials of sums over the last axis (n <= 128) in K6's
    order: sample s on lane s % 32, slot s // 32 of 2 slots (n <= 64) or
    4; each lane adds its slots in order, 0 past n."""
    n = v.shape[-1]
    if n > MAX_SIDE:
        raise ValueError(f"_lane_leaves: {n} samples a side, K6 takes at "
                         f"most {MAX_SIDE}")
    ns = 2 if n <= 64 else 4
    s = F.pad(v, (0, 32 * ns - n)).reshape(*v.shape[:-1], ns, 32)
    acc = s[..., 0, :]
    for k in range(1, ns):
        acc = acc + s[..., k, :]
    return acc


def _lane_sum(v):
    """Sums over the last axis (n <= 128) in K6's order: each lane's
    partial (`_lane_leaves`), then a butterfly over the 32 lanes."""
    s = _lane_leaves(v)
    for o in (16, 8, 4, 2, 1):
        s = s[..., :o] + s[..., o:2 * o]
    return s[..., 0]


def _centred(v, inv_pp):
    """One side's samples (..., P*P) minus their mean, and their sum of
    squares."""
    c = v - (_lane_sum(v) * inv_pp)[..., None]
    return c, _lane_sum(c * c)


def _ncc_lanes(ca, ssa, cb, ssb, ok):
    """`ncc` of two centred sides in K6's order."""
    score = _lane_sum(ca * cb) / torch.sqrt(torch.clamp(
        ssa * ssb, min=NCC_EPS * NCC_EPS))
    bad = (ssa < NCC_EPS) | (ssb < NCC_EPS) | ~ok
    return torch.where(bad, torch.full_like(score, -1.0), score)


def ncc4_lanes(a, a_ok, b, b_ok, patch_size: int):
    """`ncc4` of FLAT [plus | minus] patches (..., 2*P*P) with ok flags
    (..., 2), in K6's order: the max of the 4 side pairings (A+,B+),
    (A-,B-), (A+,B-), (A-,B+)."""
    pp = patch_size * patch_size
    inv = _recip(pp)
    ap, sap = _centred(a[..., :pp], inv)
    am, sam = _centred(a[..., pp:], inv)
    bp, sbp = _centred(b[..., :pp], inv)
    bm, sbm = _centred(b[..., pp:], inv)
    s_pp = _ncc_lanes(ap, sap, bp, sbp, a_ok[..., 0] & b_ok[..., 0])
    s_nn = _ncc_lanes(am, sam, bm, sbm, a_ok[..., 1] & b_ok[..., 1])
    s_pn = _ncc_lanes(ap, sap, bm, sbm, a_ok[..., 0] & b_ok[..., 1])
    s_np = _ncc_lanes(am, sam, bp, sbp, a_ok[..., 1] & b_ok[..., 0])
    return torch.maximum(torch.maximum(s_pp, s_nn), torch.maximum(s_pn, s_np))


def _half_dot(a, b):
    """Dots over the last axis (128) in K6's order: bin k on lane k // 8 of
    16, each lane adds its 8 products in order, then a butterfly over the
    16 lanes."""
    p = (a * b).reshape(*a.shape[:-1], 16, 8)
    s = p[..., 0]
    for t in range(1, 8):
        s = s + p[..., t]
    for o in (8, 4, 2, 1):
        s = s[..., :o] + s[..., o:2 * o]
    return s[..., 0]


def desc_distance_lanes(a, b):
    """`descriptors.min_cross_distance_dot` of (..., 256) bf16 descriptor
    pairs in K6's order: sqrt(max(min(|a_i|^2 + |b_j|^2 - 2 a_i.b_j), 0))
    over the halves i, j, the min taken as min(min(++, +-), min(-+, --))."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    D = a.shape[-1] // 2
    ah, bh = (a[..., :D], a[..., D:]), (b[..., :D], b[..., D:])
    a2 = [_half_dot(h, h) for h in ah]
    b2 = [_half_dot(h, h) for h in bh]
    d2 = [[(a2[i] + b2[j]) - 2.0 * _half_dot(ah[i], bh[j]) for j in (0, 1)]
          for i in (0, 1)]
    d = torch.minimum(torch.minimum(d2[0][0], d2[0][1]),
                      torch.minimum(d2[1][0], d2[1][1]))
    return torch.sqrt(torch.clamp(d, min=0.0))


def _live_pairs(mask, chunk):
    """(rows, slots) of the set entries of an (N, C) mask, row-major, in
    pieces of at most `chunk`."""
    rows, slots = torch.nonzero(mask, as_tuple=True)
    for s in range(0, rows.numel(), chunk):
        yield rows[s:s + chunk], slots[s:s + chunk]


def dense_gates_stereo_plain(l_desc, r_desc, cand_idx, cmask, l_patches,
                             l_ok, r_patches, r_ok, sift_threshold: float,
                             patch_size: int, fill_dist: float,
                             fill_ncc: float,
                             chunk: int = 1 << 16):
    """Plain twin of K6's stereo entry (the stereo cascade's stages 4-5):
    on the live slots of `cmask` (N, C), the descriptor distance of the
    left row's (N, 256) bf16 descriptor to the right one of `cand_idx`
    (N, C); on the slots that also pass `dist < sift_threshold`, the NCC
    of the FLAT (., 2*P*P) patches with their (., 2) ok flags. Returns
    (dist, ncc), (N, C) float32, `fill_dist` / `fill_ncc` where not
    computed."""
    dev = cmask.device
    dist = torch.full(cmask.shape, fill_dist, dtype=torch.float32, device=dev)
    ncc = torch.full(cmask.shape, fill_ncc, dtype=torch.float32, device=dev)
    for r, c in _live_pairs(cmask, chunk):
        dist[r, c] = desc_distance_lanes(l_desc[r], r_desc[cand_idx[r, c]])
    for r, c in _live_pairs(cmask & (dist < sift_threshold), chunk):
        j = cand_idx[r, c]
        ncc[r, c] = ncc4_lanes(l_patches[r], l_ok[r], r_patches[j], r_ok[j],
                               patch_size)
    return dist, ncc


def dense_gates_temporal_plain(kf_patches_l, kf_ok_l, kf_patches_r, kf_ok_r,
                               kf_desc_l, kf_desc_r, cf_patches, cf_ok,
                               cf_desc, cf_idx, cmask, patch_size: int,
                               fill_ncc: float, fill_dist: float,
                               chunk: int = 1 << 16):
    """Plain twin of K6's temporal entry (the temporal cascade's NCC and
    descriptor gates): on the live slots of `cmask` (M, Cq), for both
    sides, the NCC of the KF mate's FLAT (M, 2*P*P) float32 patches
    against the CF mate's of `cf_idx`, read from the bf16 table
    `cf_patches` (Mc, 4*P*P) [left | right] with ok flags `cf_ok` (Mc, 4),
    and the descriptor distance against `cf_desc` (Mc, 512) bf16 [left |
    right]. Returns (4, M, Cq) float32: left NCC, right NCC, left
    distance, right distance; `fill_ncc` / `fill_dist` on dead slots."""
    M, Cq = cmask.shape
    two = 2 * patch_size * patch_size
    out = torch.empty((4, M, Cq), dtype=torch.float32, device=cmask.device)
    out[:2] = fill_ncc
    out[2:] = fill_dist
    for r, c in _live_pairs(cmask, chunk):
        j = cf_idx[r, c]
        cp = cf_patches[j].to(torch.float32)
        cok = cf_ok[j]
        cd = cf_desc[j]
        out[0, r, c] = ncc4_lanes(kf_patches_l[r], kf_ok_l[r], cp[:, :two],
                                  cok[:, :2], patch_size)
        out[1, r, c] = ncc4_lanes(kf_patches_r[r], kf_ok_r[r], cp[:, two:],
                                  cok[:, 2:], patch_size)
        out[2, r, c] = desc_distance_lanes(kf_desc_l[r], cd[:, :K6_DESC])
        out[3, r, c] = desc_distance_lanes(kf_desc_r[r], cd[:, K6_DESC:])
    return out


def dense_gates_flat_plain(l_patches, l_ok, rows, r_patches, r_ok, live,
                           patch_size: int, fill: float,
                           chunk: int = 1 << 16):
    """Plain twin of K6's flat entry (the stereo cascade's stage 11): for
    each live entry f of the (F,) list, the NCC of the left patches of row
    `rows[f]` against the right patches `r_patches[f]` (FLAT, with ok
    flags). Returns (F,) float32, `fill` where not live."""
    out = torch.full(live.shape, fill, dtype=torch.float32,
                     device=live.device)
    for f, _ in _live_pairs(live[:, None], chunk):
        r = rows[f]
        out[f] = ncc4_lanes(l_patches[r], l_ok[r], r_patches[f], r_ok[f],
                            patch_size)
    return out


def _k6_checks(what, cmask, patch_size, *descs):
    if not cmask.is_cuda:
        raise ValueError(f"{what}: needs CUDA tensors, got them on "
                         f"{cmask.device}")
    _check_patch_size(what, patch_size)
    if cmask.dim() != 2 or cmask.shape[1] > MAX_SLOTS:
        raise ValueError(f"{what}: mask of shape {tuple(cmask.shape)}, K6 "
                         f"takes (N, C <= {MAX_SLOTS})")
    for d in descs:
        if d.dim() != 2 or d.shape[1] % K6_DESC:
            raise ValueError(f"{what}: descriptors of shape "
                             f"{tuple(d.shape)}, K6 takes rows of "
                             f"{K6_DESC} bf16 (K5's two halves) a side")


def _gate_scalars(patch_size):
    """K6's float arguments of the NCC: the mean's reciprocal, the
    degenerate-side bound and the floor under the product of squares (the
    twin's float32 values of each)."""
    return _recip(patch_size * patch_size), NCC_EPS, NCC_EPS * NCC_EPS


def _launch(name, fn, dev, n_launches, *args):
    with torch.cuda.device(dev):
        err = fn(*args, CB.stream_ptr(dev))
    CB.check(err, name)
    CB.LAUNCHES["dense_gates"] += n_launches


def _terms(rows, sides, dev):
    """Scratch for the prep pass's terms of a candidate table: a row's
    {mean+, ss+, mean-, ss-} a side, then {|b+|^2, |b-|^2} a side, padded
    to 16 bytes (csrc/dense_gates.cu `terms_stride`)."""
    if rows >= 2 ** 31:
        raise ValueError(f"dense_gates: a table of {rows} rows, K6 keeps "
                         f"candidate indices in 32 bits")
    return torch.empty((rows, 8 if sides == 1 else 12), dtype=torch.float32,
                       device=dev)


def dense_gates_stereo_cuda(l_desc, r_desc, cand_idx, cmask, l_patches, l_ok,
                            r_patches, r_ok, sift_threshold: float,
                            patch_size: int, fill_dist: float,
                            fill_ncc: float):
    """K6's stereo entry (csrc/dense_gates.cu): same contract as
    `dense_gates_stereo_plain`, for contiguous CUDA tensors (bf16
    descriptors, int64 indices, bool masks and flags); two launches (the
    prep pass over the right table, then the gates), one with no right
    row."""
    what = "dense_gates_stereo_cuda"
    _k6_checks(what, cmask, patch_size, l_desc, r_desc)
    dev = cmask.device
    N, C = cmask.shape
    Nr = r_desc.shape[0]
    two = 2 * patch_size * patch_size
    for t, name, dtype, shape in (
            (l_desc, "l_desc", torch.bfloat16, (N, K6_DESC)),
            (r_desc, "r_desc", torch.bfloat16, (Nr, K6_DESC)),
            (cand_idx, "cand_idx", torch.int64, (N, C)),
            (cmask, "cmask", torch.bool, (N, C)),
            (l_patches, "l_patches", torch.float32, (N, two)),
            (l_ok, "l_ok", torch.bool, (N, 2)),
            (r_patches, "r_patches", torch.float32, (Nr, two)),
            (r_ok, "r_ok", torch.bool, (Nr, 2))):
        CB.require(t, name, dtype, shape, dev)
    out = torch.empty((2, N, C), dtype=torch.float32, device=dev)
    if N and C:
        terms = _terms(Nr, 1, dev)
        _launch("dense_gates (stereo)", CB.lib().dense_gates_stereo_launch,
                dev, 1 + (Nr > 0), l_desc.data_ptr(), r_desc.data_ptr(),
                cand_idx.data_ptr(), cmask.data_ptr(), N, C,
                l_patches.data_ptr(), l_ok.data_ptr(), r_patches.data_ptr(),
                r_ok.data_ptr(), Nr, terms.data_ptr(), patch_size,
                sift_threshold,
                *_gate_scalars(patch_size), fill_dist,
                fill_ncc, out.data_ptr())
    return out[0], out[1]


def dense_gates_temporal_cuda(kf_patches_l, kf_ok_l, kf_patches_r, kf_ok_r,
                              kf_desc_l, kf_desc_r, cf_patches, cf_ok,
                              cf_desc, cf_idx, cmask, patch_size: int,
                              fill_ncc: float, fill_dist: float):
    """K6's temporal entry (csrc/dense_gates.cu): same contract as
    `dense_gates_temporal_plain`, for contiguous CUDA tensors; two
    launches (the prep pass over the CF table, then the gates), one with
    no CF row."""
    what = "dense_gates_temporal_cuda"
    _k6_checks(what, cmask, patch_size, kf_desc_l, kf_desc_r, cf_desc)
    dev = cmask.device
    M, Cq = cmask.shape
    Mc = cf_desc.shape[0]
    two = 2 * patch_size * patch_size
    for t, name, dtype, shape in (
            (kf_patches_l, "kf_patches_l", torch.float32, (M, two)),
            (kf_ok_l, "kf_ok_l", torch.bool, (M, 2)),
            (kf_patches_r, "kf_patches_r", torch.float32, (M, two)),
            (kf_ok_r, "kf_ok_r", torch.bool, (M, 2)),
            (kf_desc_l, "kf_desc_l", torch.bfloat16, (M, K6_DESC)),
            (kf_desc_r, "kf_desc_r", torch.bfloat16, (M, K6_DESC)),
            (cf_patches, "cf_patches", torch.bfloat16, (Mc, 2 * two)),
            (cf_ok, "cf_ok", torch.bool, (Mc, 4)),
            (cf_desc, "cf_desc", torch.bfloat16, (Mc, 2 * K6_DESC)),
            (cf_idx, "cf_idx", torch.int64, (M, Cq)),
            (cmask, "cmask", torch.bool, (M, Cq))):
        CB.require(t, name, dtype, shape, dev)
    out = torch.empty((4, M, Cq), dtype=torch.float32, device=dev)
    if M and Cq:
        terms = _terms(Mc, 2, dev)
        _launch("dense_gates (temporal)",
                CB.lib().dense_gates_temporal_launch, dev, 1 + (Mc > 0),
                kf_patches_l.data_ptr(), kf_ok_l.data_ptr(),
                kf_patches_r.data_ptr(), kf_ok_r.data_ptr(),
                kf_desc_l.data_ptr(), kf_desc_r.data_ptr(),
                cf_patches.data_ptr(), cf_ok.data_ptr(), cf_desc.data_ptr(),
                Mc, terms.data_ptr(), cf_idx.data_ptr(), cmask.data_ptr(), M, Cq, patch_size,
                *_gate_scalars(patch_size), fill_ncc,
                fill_dist, out.data_ptr())
    return out


def dense_gates_flat_cuda(l_patches, l_ok, rows, r_patches, r_ok, live,
                          patch_size: int, fill: float):
    """K6's flat entry (csrc/dense_gates.cu): same contract as
    `dense_gates_flat_plain`, for contiguous CUDA tensors; one launch."""
    what = "dense_gates_flat_cuda"
    _k6_checks(what, live[:, None], patch_size)
    dev = live.device
    N, Fn = l_patches.shape[0], live.shape[0]
    two = 2 * patch_size * patch_size
    for t, name, dtype, shape in (
            (l_patches, "l_patches", torch.float32, (N, two)),
            (l_ok, "l_ok", torch.bool, (N, 2)),
            (rows, "rows", torch.int64, (Fn,)),
            (r_patches, "r_patches", torch.float32, (Fn, two)),
            (r_ok, "r_ok", torch.bool, (Fn, 2)),
            (live, "live", torch.bool, (Fn,))):
        CB.require(t, name, dtype, shape, dev)
    out = torch.empty((Fn,), dtype=torch.float32, device=dev)
    if Fn:
        _launch("dense_gates (flat)", CB.lib().dense_gates_flat_launch, dev,
                1, l_patches.data_ptr(), l_ok.data_ptr(), rows.data_ptr(),
                r_patches.data_ptr(), r_ok.data_ptr(), live.data_ptr(), Fn,
                patch_size, *_gate_scalars(patch_size),
                fill, out.data_ptr())
    return out


K6_KERNELS = ("prep (float32 table)", "prep (bf16 table)", "stereo",
              "temporal", "flat")


def k6_info():
    """What the built K6 is on this card, per kernel of `K6_KERNELS`: warps
    a block, registers a thread, local (spill) bytes a thread, static
    shared bytes a block, blocks and warps an SM
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`), for the instances
    of 2 samples a lane (P <= 7) as the top-level keys and of 4 (P = 9,
    11) under "wide"; and the live slots the gates take a warp step."""
    buf = (ctypes.c_int * 51)()
    CB.check(CB.lib().dense_gates_info(ctypes.addressof(buf)),
             "dense_gates_info")

    def kernels(base):
        out = {}
        for k, name in enumerate(K6_KERNELS):
            v = buf[base + 5 * k:base + 5 * k + 5]
            out[name] = dict(warps_per_block=v[0], registers=v[1],
                             local_bytes=v[2], shared_bytes=v[3],
                             blocks_per_sm=v[4], warps_per_sm=v[0] * v[4])
        return out

    return dict(kernels(0), slots_a_step=buf[25], wide=kernels(26))


def _dispatch(name, cmask, kernel, twin, *args, **kw):
    if cmask.is_cuda:
        return kernel(*args, **kw)
    if cmask.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {cmask.device}")
    return twin(*args, **kw)


def dense_gates_stereo(l_desc, r_desc, cand_idx, cmask, l_patches, l_ok,
                       r_patches, r_ok, sift_threshold: float,
                       patch_size: int, fill_dist: float, fill_ncc: float):
    """The stereo cascade's stages 4-5 (`dense_gates_stereo_plain`): K6 for
    CUDA tensors, the plain twin for CPU tensors. Returns (dist, ncc)."""
    return _dispatch("dense_gates_stereo", cmask, dense_gates_stereo_cuda,
                     dense_gates_stereo_plain, l_desc, r_desc, cand_idx,
                     cmask, l_patches, l_ok, r_patches, r_ok, sift_threshold,
                     patch_size, fill_dist, fill_ncc)


def dense_gates_temporal(kf_patches_l, kf_ok_l, kf_patches_r, kf_ok_r,
                         kf_desc_l, kf_desc_r, cf_patches, cf_ok, cf_desc,
                         cf_idx, cmask, patch_size: int, fill_ncc: float,
                         fill_dist: float):
    """The temporal cascade's NCC and descriptor gates
    (`dense_gates_temporal_plain`): K6 for CUDA tensors, the plain twin
    for CPU tensors. Returns (4, M, Cq): left / right NCC, left / right
    descriptor distance."""
    return _dispatch("dense_gates_temporal", cmask, dense_gates_temporal_cuda,
                     dense_gates_temporal_plain, kf_patches_l, kf_ok_l,
                     kf_patches_r, kf_ok_r, kf_desc_l, kf_desc_r, cf_patches,
                     cf_ok, cf_desc, cf_idx, cmask, patch_size, fill_ncc,
                     fill_dist)


def dense_gates_flat(l_patches, l_ok, rows, r_patches, r_ok, live,
                     patch_size: int, fill: float):
    """The stereo cascade's post-cluster NCC over a flat pair list
    (`dense_gates_flat_plain`): K6 for CUDA tensors, the plain twin for
    CPU tensors."""
    return _dispatch("dense_gates_flat", live, dense_gates_flat_cuda,
                     dense_gates_flat_plain, l_patches, l_ok, rows,
                     r_patches, r_ok, live, patch_size, fill)
