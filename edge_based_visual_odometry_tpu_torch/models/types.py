"""Shared tensor types of the VO frame, and converters from numpy.

The converters take the JAX package's outputs as numpy arrays (any
object exposing the same fields works) and build the port's types on a
given device, so a parity test can feed a port stage exactly what the
reference fed its counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from edge_based_visual_odometry_tpu_torch.config import StereoRig, VOConfig


class RigArrays(NamedTuple):
    """Stereo rig constants as device tensors (derived from StereoRig)."""

    K_left: torch.Tensor       # (3, 3)
    K_right: torch.Tensor
    K_left_inv: torch.Tensor
    K_right_inv: torch.Tensor
    R21: torch.Tensor          # (3, 3) left -> right
    T21: torch.Tensor          # (3,)
    F21: torch.Tensor          # (3, 3) left point -> right epipolar line
    F12: torch.Tensor


class EdgeList(NamedTuple):
    """Fixed-capacity padded TOED edge list."""

    x: torch.Tensor        # (MAX_EDGES,) subpixel x, image coords
    y: torch.Tensor
    theta: torch.Tensor    # third-order orientation, radians
    mag: torch.Tensor      # subpixel gradient magnitude
    valid: torch.Tensor    # bool
    count: torch.Tensor    # () int32


class FrameData(NamedTuple):
    """Per-frame images (H, W) float32 and their Sobel/8 gradients."""

    left: torch.Tensor
    right: torch.Tensor
    left_gx: torch.Tensor
    left_gy: torch.Tensor
    right_gx: torch.Tensor
    right_gy: torch.Tensor


class StereoMates(NamedTuple):
    """Finalized stereo edge pairs as fixed-capacity SoA."""

    left_x: torch.Tensor        # (M,)
    left_y: torch.Tensor
    left_theta: torch.Tensor
    right_x: torch.Tensor
    right_y: torch.Tensor
    right_theta: torch.Tensor
    left_patches: torch.Tensor   # (M, 2*P*P) [plus | minus]
    right_patches: torch.Tensor  # (M, 2*P*P)
    left_patch_ok: torch.Tensor  # (M, 2) bool
    right_patch_ok: torch.Tensor
    left_desc: torch.Tensor      # (M, 2*D) bf16 [plus | minus]
    right_desc: torch.Tensor     # (M, 2*D) bf16
    gamma: torch.Tensor          # (M, 3) triangulated 3D point, left cam
    gamma_gt: torch.Tensor       # (M, 3) GT-disparity 3D point (eval path)
    gt_x: torch.Tensor           # (M,) GT right location (-1 without GT)
    gt_y: torch.Tensor
    is_tp: torch.Tensor          # (M,) bool (eval path)
    valid: torch.Tensor          # (M,) bool
    count: torch.Tensor          # () int32


def rig_arrays_from_rig(rig: StereoRig, device, dtype=torch.float32) -> RigArrays:
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return RigArrays(
        K_left=t(rig.left.K), K_right=t(rig.right.K),
        K_left_inv=t(rig.left.K_inv), K_right_inv=t(rig.right.K_inv),
        R21=t(rig.R21_np), T21=t(rig.T21_np), F21=t(rig.F21), F12=t(rig.F12))


def config_from_fields(fields: dict) -> VOConfig:
    """VOConfig from a field dict (e.g. dataclasses.asdict of the
    reference's config); unknown keys raise."""
    names = {f.name for f in dataclasses.fields(VOConfig)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"unknown VOConfig fields: {sorted(unknown)}")
    return VOConfig(**fields)


def _tensor(a, device):
    """numpy (or numpy-convertible) -> tensor on `device`; bf16 arrays
    (ml_dtypes) are carried through their bit pattern."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.uint16).astype(np.int16))
        return bits.view(torch.bfloat16).to(device)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr)).to(device)


def _convert(cls, obj, device):
    return cls(**{f: _tensor(getattr(obj, f), device) for f in cls._fields})


def edge_list_from_numpy(obj, device) -> EdgeList:
    return _convert(EdgeList, obj, device)


def frame_data_from_numpy(obj, device) -> FrameData:
    return _convert(FrameData, obj, device)


def stereo_mates_from_numpy(obj, device) -> StereoMates:
    return _convert(StereoMates, obj, device)
