"""Rotated-patch sampling and NCC scoring.

Port of `edge_based_visual_odometry_tpu/ops/patches.py`. `edge_patches`
has the semantics of the reference's `edge_patches_tiled`: every sample is
read through `sample_tile_clamped`, the bilinear sampler of the
reference's atlas tiles (hat weights, tile clamp, edge-replicate
padding). For patches and descriptors the tile clamp never binds (the
reference's static coverage guard), so this equals border-clamped
bilinear sampling; for the GN refiners it bounds the travel.
"""

from __future__ import annotations

import torch

from edge_based_visual_odometry_tpu_torch.ops import tiled_sampling as TS


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
    ix0 = torch.clamp(ox + x0, max=W - 1).to(torch.int64)
    ix1 = torch.clamp(ox + x0 + 1.0, max=W - 1).to(torch.int64)
    iy0 = torch.clamp(oy + y0, max=H - 1).to(torch.int64)
    iy1 = torch.clamp(oy + y0 + 1.0, max=H - 1).to(torch.int64)
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


def edge_patches(img, x, y, theta, patch_size: int, shift_mag: float,
                 tile: int = 32, stride: int = 8, chunk: int = 1 << 16):
    """Two-side rotated patches of (B,) edges.

    Returns (patch_plus, patch_minus, ok_plus, ok_minus), patches (B, P*P);
    ok flags follow the NaN-on-OOB rule (every sample's floor/ceil inside
    the image). Chunked over B to bound memory; chunking never changes
    results."""
    B = x.shape[0]
    pp = patch_size * patch_size
    H, W = img.shape
    outs = []
    for s in range(0, max(B, 1), chunk):
        x_c, y_c, t_c = x[s:s + chunk], y[s:s + chunk], theta[s:s + chunk]
        plus, minus = orthogonal_shifted_points(x_c, y_c, t_c, shift_mag)
        cp = rotated_patch_coords(plus[..., 0], plus[..., 1], t_c, patch_size)
        cm = rotated_patch_coords(minus[..., 0], minus[..., 1], t_c,
                                  patch_size)
        coords = torch.cat([cp, cm], -2)                 # (b, 2pp, 2)
        cx_, cy_ = coords[..., 0], coords[..., 1]
        vals = sample_around(img, x_c, y_c, cx_, cy_, tile, stride)
        inb = ((torch.floor(cx_) >= 0) & (torch.floor(cy_) >= 0)
               & (torch.ceil(cx_) <= W - 1) & (torch.ceil(cy_) <= H - 1))
        outs.append((vals[:, :pp], vals[:, pp:],
                     inb[:, :pp].all(-1), inb[:, pp:].all(-1)))
    return tuple(torch.cat(parts) for parts in zip(*outs))


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
