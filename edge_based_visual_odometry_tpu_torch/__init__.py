"""PyTorch/CUDA port of the edge-based stereo visual odometry frame.

The JAX package `edge_based_visual_odometry_tpu` is the reference: every
module here keeps its counterpart's module path, function names and
tensor contracts (shapes, capacities, masks, orderings), so that each
stage can be held against the reference on the same numpy inputs.

Plain tensor code is PyTorch. The two hot kernels of the frame are
hand-written CUDA for Hopper (`csrc/`), built with nvcc at first use:

  - `ops.toed.toed_gradient_field`             (TOED filter bank)
  - `ops.gauss_newton.refine_along_epipolar`   (1-DoF epipolar GN)

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
