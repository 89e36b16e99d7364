#!/usr/bin/env python
"""Stereo edge VO on a dataset with the PyTorch/CUDA port: see
`edge_based_visual_odometry_tpu_torch/cli.py` (`-h` lists the flags)."""
import sys

from edge_based_visual_odometry_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
