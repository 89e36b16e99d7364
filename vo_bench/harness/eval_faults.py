"""Faults of the evaluation path, planted under the timed path of a
supervised (`gt_frame`) cell to show that its check sees them; each
takes a `setattr(obj, name, value)` as `faults.py`'s do:

- `gt_pose_inverted`: each frame's GT pose handed camera -> world, the
  inverse of what `run_frame` takes (`io/datasets.py` warns that this
  silently halves the temporal cascade's recall);
- `disparity_one_column_off`: every GT right location one column off
  (the disparity handed 1 px too large);
- `stale_maps`: the stereo step keeps the GT maps of the call that
  captured its graph (its second) for every later call, as a graph
  whose static GT inputs are not refreshed after capture would.

The fourth reading the limits are set from is the bfloat16 control
(`calibrate_gt.py --control`).
"""

from __future__ import annotations

import numpy as np


def _run_frame(setattr, change):
    from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
    real = PL.VOPipeline.run_frame

    def broken(self, left, right, disparity=None, gt_pose=None,
               occlusion=None):
        disparity, gt_pose = change(disparity, gt_pose)
        return real(self, left, right, disparity=disparity, gt_pose=gt_pose,
                    occlusion=occlusion)
    setattr(PL.VOPipeline, "run_frame", broken)


def gt_pose_inverted(setattr):
    def invert(disparity, pose):
        R, t = (np.asarray(a, np.float32) for a in pose)
        return disparity, type(pose)(R.T.copy(), -(R.T @ t))
    _run_frame(setattr, invert)


def disparity_one_column_off(setattr):
    _run_frame(setattr, lambda disparity, pose: (disparity + 1.0, pose))


def stale_maps(setattr):
    from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
    real = PL.build_stereo_step

    def build(*a, **kw):
        step = real(*a, **kw)
        held = []

        def stale(left, right, disparity=None, occlusion=None):
            if disparity is not None:
                if len(held) < 2:
                    held.append((disparity, occlusion))
                disparity, occlusion = held[-1]
            return step(left, right, disparity, occlusion)
        return stale
    setattr(PL, "build_stereo_step", build)


FAULTS = {f.__name__: f for f in (gt_pose_inverted, disparity_one_column_off,
                                  stale_maps)}
