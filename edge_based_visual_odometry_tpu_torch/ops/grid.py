"""Sorted spatial index: sort by (y-band, x) + searchsorted range queries.

Port of `edge_based_visual_odometry_tpu/ops/grid.py`. A (qx, qy, rx, ry)
box query returns, per query, `n_band_window` contiguous spans of the
sorted order in fixed slot windows with validity masks: exactly the
edges whose x lies in [qx - rx, qx + rx] and whose y-band overlaps
[qy - ry, qy + ry].

GUARANTEE (kept from the reference): every masked-True slot refers to a
valid source entry - invalid entries carry a sentinel key that sorts past
every in-range span.

Orderings use stable torch.sort, which equals the reference's stable
argsort / top_k order (ties toward the lower index).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SortedGrid(NamedTuple):
    sorted_idx: torch.Tensor    # (N,) int64
    sorted_keys: torch.Tensor   # (N,) int64 composite (band, x/16 px)
    sorted_attrs: torch.Tensor  # (1 + A, N) [index plane, attrs...]
    band_h: float
    n_bands: int
    width: int


def build_sorted_grid(x, y, valid, width: int, height: int, band_h: int,
                      attrs=None) -> SortedGrid:
    """Composite key = band * (W*16) + round(x*16), sentinel for invalid.
    attrs: optional (N, A) payload, stored attribute-major in sorted order
    behind an index plane (original index as f32)."""
    n_bands = -(-height // band_h)
    W16 = width * 16
    band = torch.clamp(torch.floor(y / band_h), 0, n_bands - 1).to(torch.int64)
    xq = torch.clamp(torch.round(x * 16.0), 0, W16 - 1).to(torch.int64)
    key = band * W16 + xq
    key = torch.where(valid, key, torch.full_like(key, (n_bands + 1) * W16))
    sorted_keys, order = torch.sort(key, stable=True)
    if attrs is None:
        attrs = torch.stack([x, y], -1)
    idx_plane = torch.arange(x.shape[0], dtype=torch.float32,
                             device=x.device)[:, None]
    attrs = torch.cat([idx_plane, attrs], -1)
    return SortedGrid(order, sorted_keys, attrs.T[:, order].contiguous(),
                      float(band_h), int(n_bands), int(width))


def _band_window_positions(grid: SortedGrid, qx, qy, rx: float, ry: float,
                           slots_per_band: int, n_band_window: int):
    """(pos, mask) of shape (Q, n_band_window * slots_per_band) into the
    sorted arrays."""
    W16 = grid.width * 16
    nb = grid.n_bands * W16
    b0 = torch.floor((qy - ry) / grid.band_h).to(torch.int64)
    xq_lo = torch.clamp(torch.floor((qx - rx) * 16.0), 0, W16 - 1).to(torch.int64)
    xq_hi = torch.clamp(torch.ceil((qx + rx) * 16.0), 0, W16 - 1).to(torch.int64)
    N = grid.sorted_idx.shape[0]
    ks = torch.arange(n_band_window, dtype=torch.int64, device=qx.device)
    b = b0[None, :] + ks[:, None]                        # (K, Q)
    b_ok = (b >= 0) & (b < grid.n_bands)
    k_lo = torch.clamp(b * W16 + xq_lo[None, :], 0, nb)
    k_hi = torch.clamp(b * W16 + xq_hi[None, :] + 1, 0, nb)
    keys = grid.sorted_keys
    lo = torch.searchsorted(keys, k_lo.reshape(-1)).reshape(k_lo.shape)
    hi = torch.searchsorted(keys, k_hi.reshape(-1)).reshape(k_hi.shape)
    offs = torch.arange(slots_per_band, dtype=torch.int64, device=qx.device)
    pos = lo[:, :, None] + offs                          # (K, Q, S)
    m = (pos < hi[:, :, None]) & b_ok[:, :, None] & (pos < N)
    pos = torch.clamp(pos, max=N - 1)
    Q = qx.shape[0]
    return (pos.permute(1, 0, 2).reshape(Q, -1),
            m.permute(1, 0, 2).reshape(Q, -1))


def query_sorted_grid_attrs(grid: SortedGrid, qx, qy, rx: float, ry: float,
                            slots_per_band: int, n_band_window: int):
    """Box query -> (idx (Q, S) int64, attrs (A, Q, S), mask (Q, S));
    idx indexes the original arrays and is 0 where masked out."""
    pos, mask = _band_window_positions(grid, qx, qy, rx, ry,
                                       slots_per_band, n_band_window)
    g = grid.sorted_attrs[:, pos]
    idx = torch.where(mask, g[0].to(torch.int64), torch.zeros_like(pos))
    return idx, g[1:], mask


def compact_candidates_attrs(idx, attrs, mask, capacity: int, priority=None):
    """Compact (Q, S) masked slots to (Q, capacity): valid slots first, in
    ascending `priority` (stable; original slot order when None), then the
    masked-out slots in slot order. Overflow beyond capacity is dropped.
    Returns (idx, attrs (A, Q, capacity), mask)."""
    if priority is None:
        key = (~mask).to(torch.float32)
    else:
        key = torch.where(mask, priority, torch.full_like(priority, 3.0e38))
    order = torch.sort(key, dim=-1, stable=True).indices[:, :capacity]
    return (torch.gather(idx, 1, order),
            torch.gather(attrs, 2, order[None].expand(attrs.shape[0], -1, -1)),
            torch.gather(mask, 1, order))
