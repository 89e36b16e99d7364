"""The tile-origin rule of the reference's atlas sampling.

The reference samples GN patches from a fixed-stride atlas of T x T tiles
(`edge_based_visual_odometry_tpu/ops/tiled_sampling.py::fetch_atlas_tiles`)
and clamps every sample to its tile. There is no atlas here - samplers
read the image directly - but the clamp changes results (it bounds GN
travel), so it is kept: a sample at x is read at
clamp(x, ox, ox + T - 1), then edge-replicated into the image, where

    ox = clip(round((c - T/2) / s), 0, n_b - 1) * s,   n_b = ceil(W / s)

for the anchor c of the sample's candidate.
"""

from __future__ import annotations

import torch


def atlas_stride(tile: int) -> int:
    """Stride of the reference's atlas for a given GN tile size."""
    return tile // 3 if tile % 3 == 0 else tile // 4


def tile_origin(c: torch.Tensor, tile: int, stride: int, size: int):
    """Origin (float tensor) of the atlas tile picked for anchor c along an
    image axis of length `size`."""
    n_b = -(-size // stride)
    k = torch.clamp(torch.round((c - tile / 2.0) / stride), 0, n_b - 1)
    return k * stride
