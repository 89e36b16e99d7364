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

`compact_candidates_attrs` keeps the first slots of each row of a gather
window in priority order: on a CUDA tensor the hand-written kernel
`csrc/compact_candidates.cu`, which gives the plain twin's outputs bit for
bit; on a CPU tensor the twin `compact_candidates_plain`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB


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


# TOED keeps at most one edge a pixel of its 2x interpolation grid, each
# within sqrt(2) grid steps of that pixel (`ops/toed.py`, the subpixel fit)
EDGE_REACH_PX = 0.5 * math.sqrt(2.0)
# the band height of `any_in_box`'s own grid: the fewest slots a query
# reads at the radii it serves (1-2 px); its windows a query, which bound
# the memory a call takes
BOX_BAND_H = 2
BOX_PASSES = 2


def band_span_capacity(band_h: float, r: float) -> int:
    """The most entries one band's span of an r-box query can hold where
    the grid holds one image's edges, or some of them (a frame's mates):
    the interpolation pixels whose edge can land in the span, which is
    band_h high and 2 r + 3/16 px wide (the keys' 1/16 px rounding)."""
    cols = math.floor(2.0 * (2.0 * r + 3.0 / 16.0 + 2.0 * EDGE_REACH_PX)) + 1
    rows = math.floor(2.0 * (band_h + 2.0 * EDGE_REACH_PX)) + 1
    return cols * rows


def any_in_box(x, y, valid, attrs, width: int, height: int, qx, qy,
               r: float, test):
    """(Q,) bool: whether a valid point (x, y) within the r-box around
    each query passes `test(attrs (A, Q, S), mask (Q, S)) -> (Q, S)
    bool`, `attrs` (N, A) the points' own. The points are sorted into a
    grid of `BOX_BAND_H`-high bands, and every slot a band's span can
    hold is read (`band_span_capacity`), in `BOX_PASSES` windows of
    static shape: the answer is exact however dense the points."""
    grid = build_sorted_grid(x, y, valid, width, height, band_h=BOX_BAND_H,
                             attrs=attrs)
    W16 = width * 16
    nb = grid.n_bands * W16
    ks = torch.arange(int(-(-2 * r // BOX_BAND_H)) + 1, dtype=torch.int64,
                      device=qx.device)
    b = torch.floor((qy - r) / BOX_BAND_H).to(torch.int64)[:, None] + ks
    b_ok = (b >= 0) & (b < grid.n_bands)
    xq_lo = torch.clamp(torch.floor((qx - r) * 16.0), 0, W16 - 1)
    xq_hi = torch.clamp(torch.ceil((qx + r) * 16.0), 0, W16 - 1)
    k_lo = torch.clamp(b * W16 + xq_lo.to(torch.int64)[:, None], 0, nb)
    k_hi = torch.clamp(b * W16 + xq_hi.to(torch.int64)[:, None] + 1, 0, nb)
    lo = torch.searchsorted(grid.sorted_keys, k_lo)          # (Q, K)
    hi = torch.where(b_ok, torch.searchsorted(grid.sorted_keys, k_hi), lo)
    cap = band_span_capacity(BOX_BAND_H, r)
    step = -(-cap // BOX_PASSES)
    last = grid.sorted_keys.shape[0] - 1
    out = torch.zeros(qx.shape, dtype=torch.bool, device=qx.device)
    for first in range(0, cap, step):
        offs = torch.arange(first, min(first + step, cap), dtype=torch.int64,
                            device=qx.device)
        pos = lo[..., None] + offs                           # (Q, K, S)
        mask = (pos < hi[..., None]).flatten(1)
        at = grid.sorted_attrs[1:, torch.clamp(pos, max=last).flatten(1)]
        out = out | test(at, mask).any(1)
    return out


# slots a row `csrc/compact_candidates.cu` takes (a warp keeps its row's
# live keys and slots, 8 B a slot, and a histogram in shared memory)
MAX_SLOTS = 4096


def compact_candidates_plain(idx, attrs, mask, capacity: int, priority=None):
    """Compact (Q, S) masked slots to (Q, capacity): valid slots first, in
    ascending `priority` (stable; original slot order when None), then the
    masked-out slots in slot order. Overflow beyond capacity is dropped.
    Returns (idx, attrs (A, Q, capacity), mask). The plain twin of
    `csrc/compact_candidates.cu`, and the CPU path."""
    if priority is None:
        key = (~mask).to(torch.float32)
    else:
        key = torch.where(mask, priority, torch.full_like(priority, 3.0e38))
    order = torch.sort(key, dim=-1, stable=True).indices[:, :capacity]
    return (torch.gather(idx, 1, order),
            torch.gather(attrs, 2, order[None].expand(attrs.shape[0], -1, -1)),
            torch.gather(mask, 1, order))


def compact_candidates_cuda(idx, attrs, mask, capacity: int, priority=None):
    """The hand-written kernel (csrc/compact_candidates.cu); the contract
    of `compact_candidates_plain` as `torch.sort` keeps it on the card:
    each row's slots ordered by (key, slot), the key in the order cub's
    radix sort gives floats (-0.0 as +0.0, NaNs by their bits), the first
    min(capacity, S) kept. idx (Q, S) int64, attrs (A, Q, S) float32, mask
    (Q, S) bool, priority (Q, S) float32 or None, contiguous CUDA tensors;
    S at most `MAX_SLOTS`. One launch (none where Q or the width is 0)."""
    if not mask.is_cuda:
        raise ValueError(f"compact_candidates_cuda: needs a CUDA tensor, got "
                         f"one on {mask.device}")
    if mask.dim() != 2 or attrs.dim() != 3:
        raise ValueError(f"mask (Q, S) and attrs (A, Q, S) expected, got "
                         f"{tuple(mask.shape)} and {tuple(attrs.shape)}")
    Q, S = mask.shape
    A = attrs.shape[0]
    dev = mask.device
    CB.require(idx, "idx", torch.int64, (Q, S), dev)
    CB.require(attrs, "attrs", torch.float32, (A, Q, S), dev)
    CB.require(mask, "mask", torch.bool, (Q, S), dev)
    if priority is not None:
        CB.require(priority, "priority", torch.float32, (Q, S), dev)
    C = int(capacity)
    if C < 0:
        raise ValueError(f"capacity = {C}: must be >= 0")
    if S > MAX_SLOTS:
        raise ValueError(f"{S} slots a row: the kernel takes at most "
                         f"{MAX_SLOTS}")
    W = min(C, S)
    out_idx = torch.empty((Q, W), dtype=torch.int64, device=dev)
    out_attrs = torch.empty((A, Q, W), dtype=torch.float32, device=dev)
    out_mask = torch.empty((Q, W), dtype=torch.bool, device=dev)
    if Q == 0 or W == 0:
        return out_idx, out_attrs, out_mask
    lib = CB.lib()
    with torch.cuda.device(dev):
        err = lib.compact_candidates_launch(
            idx.data_ptr(), attrs.data_ptr(), mask.data_ptr(),
            None if priority is None else priority.data_ptr(), Q, S, A, W,
            out_idx.data_ptr(), out_attrs.data_ptr(), out_mask.data_ptr(),
            CB.stream_ptr(dev))
    CB.check(err, "compact_candidates")
    CB.LAUNCHES["compact_candidates"] += 1
    return out_idx, out_attrs, out_mask


def compact_candidates_attrs(idx, attrs, mask, capacity: int, priority=None):
    """`compact_candidates_plain`'s compaction: the CUDA kernel for CUDA
    tensors, the plain twin for CPU tensors."""
    if mask.is_cuda:
        return compact_candidates_cuda(idx, attrs, mask, capacity, priority)
    if mask.device.type != "cpu":
        raise ValueError(f"compact_candidates_attrs: unsupported device "
                         f"{mask.device}")
    return compact_candidates_plain(idx, attrs, mask, capacity, priority)
