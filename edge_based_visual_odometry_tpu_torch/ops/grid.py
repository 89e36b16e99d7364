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
