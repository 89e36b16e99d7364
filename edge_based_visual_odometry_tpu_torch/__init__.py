"""PyTorch/CUDA port of the edge-based stereo visual odometry frame.

The JAX package `edge_based_visual_odometry_tpu` is the reference: every
module here keeps its counterpart's module path, function names and
tensor contracts (shapes, capacities, masks, orderings), so that each
stage can be held against the reference on the same numpy inputs.

Plain tensor code is PyTorch. Ten kernels of the frame are hand-written
CUDA for Hopper (`csrc/`), built with nvcc at first use:

  - K1 `ops.toed.toed_gradient_field`             (TOED filter bank)
  - `ops.toed.nms_compact`                        (TOED's NMS, subpixel
                                                   fit and compaction)
  - K2 `ops.gauss_newton.refine_along_epipolar`   (1-DoF epipolar GN)
  - K3 `ops.gauss_newton.refine_2dof_pair_batch`  (2-DoF KF->CF GN)
  - K4 `ops.clustering.cluster_edges`             (edge clustering)
  - K5 `ops.descriptors.edge_descriptors`         (edge descriptors)
  - K6 `ops.patches.dense_gates_stereo`, `dense_gates_flat`,
    `dense_gates_temporal`                        (NCC + descriptor gates)
  - K7 `ops.patches.edge_patches`                 (two-side edge patches)
  - K8 `ops.pose.ransac_counts`                   (RANSAC inlier counts)
  - K9 `ops.pose.pose_gn_normal_equations`        (pose GN sums)

Each has a plain-PyTorch twin in the same module; a CPU tensor goes to
the twin, a CUDA tensor to the kernel.
"""

import torch as _torch

# Subpixel edge geometry needs true f32 accumulation, and TF32 keeps only
# ~3 decimal digits. Matmuls and cuDNN convolutions both stay in full f32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from edge_based_visual_odometry_tpu_torch.config import (  # noqa: E402
    CameraConfig, StereoRig, VOConfig)

__version__ = "0.1.0"

__all__ = ["VOConfig", "CameraConfig", "StereoRig", "__version__"]
