"""Frame-level VO pipeline: the stereo step, the temporal step, the
per-frame loop.

Port of `edge_based_visual_odometry_tpu/models/pipeline.py` for the
production frame:

  stereo step   = Sobel + TOED on both images (one launch of the
                  gradient-field kernel for the pair) + `match_stereo`
  temporal step = `match_temporal` + `lift_quads` + `estimate_pose`

`VOPipeline.run_frame` carries the keyframe state across frames with the
`reference`, `every_frame` and `adaptive` keyframe policies, a bootstrap
temporal step (reference-mode gather window) until the first successful
pose, and constant-velocity prediction. Not ported yet (ROADMAP queue 1):
windowed BA, the GT supervision modes and distorted rigs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from edge_based_visual_odometry_tpu_torch import geometry as geom
from edge_based_visual_odometry_tpu_torch.config import StereoRig, VOConfig
from edge_based_visual_odometry_tpu_torch.models import motion_tracker as MT
from edge_based_visual_odometry_tpu_torch.models import stereo_matcher as SM
from edge_based_visual_odometry_tpu_torch.models import temporal_matcher as TM
from edge_based_visual_odometry_tpu_torch.models.types import (
    FrameData, StereoMates, rig_arrays_from_rig)
from edge_based_visual_odometry_tpu_torch.ops import image as IMG
from edge_based_visual_odometry_tpu_torch.ops import toed


class FrameResult(NamedTuple):
    frame: FrameData
    mates: StereoMates
    stereo_metrics: torch.Tensor     # (n_stages, 4)
    n_left_edges: torch.Tensor
    n_right_edges: torch.Tensor
    distributions: Optional[dict] = None   # filter distributions: not ported


class TemporalResult(NamedTuple):
    quads: TM.TemporalQuads
    temporal_metrics: torch.Tensor   # (n_stages, 4)
    R: torch.Tensor                  # relative pose KF -> CF
    t: torch.Tensor
    inlier_count: torch.Tensor
    inlier_ratio: torch.Tensor
    n_quads: torch.Tensor
    success: torch.Tensor


def _has_distortion(rig: StereoRig) -> bool:
    return (any(abs(d) > 0 for d in rig.left.distortion[:4])
            or any(abs(d) > 0 for d in rig.right.distortion[:4]))


def _device(device) -> torch.device:
    """torch.device(device); a CUDA device where none exists is an error,
    never a silent run on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: no CUDA device is available; pass "
            f"device='cpu' to run the plain PyTorch twins on the CPU")
    return device


def build_stereo_step(rig: StereoRig, cfg: VOConfig, device):
    """fn(left, right[, gn_capture]) -> FrameResult; images (H, W) numpy or
    tensors, uint8 or float."""
    if _has_distortion(rig):
        raise NotImplementedError(
            "distorted rigs: device undistort is ROADMAP queue 1 item 5")
    device = _device(device)
    rig_a = rig_arrays_from_rig(rig, device)
    gather_ry = SM.derive_gather_band(rig, cfg)

    def step(left, right, gn_capture=None) -> FrameResult:
        both = torch.stack([torch.as_tensor(np.asarray(left)),
                            torch.as_tensor(np.asarray(right))]).to(
            device=device, dtype=torch.float32)
        gxs, gys = IMG.sobel_gradients(both)
        frame = FrameData(left=both[0], right=both[1],
                          left_gx=gxs[0], left_gy=gys[0],
                          right_gx=gxs[1], right_gy=gys[1])
        led, red = toed.detect_edges(
            both, kernel_size=cfg.toed_kernel_size, sigma=cfg.toed_sigma,
            grad_mag_min=cfg.toed_grad_mag_min, max_edges=cfg.max_edges,
            border=cfg.toed_border)
        mates, _, metrics = SM.match_stereo(led, red, frame, rig_a, cfg,
                                            gather_ry=gather_ry,
                                            gn_capture=gn_capture)
        return FrameResult(frame=frame, mates=mates, stereo_metrics=metrics,
                           n_left_edges=led.count, n_right_edges=red.count)

    return step


def build_temporal_step(rig: StereoRig, cfg: VOConfig, device):
    """fn(kf_mates, kf_frame, cf_mates, cf_frame, rel_R, rel_t, seed) ->
    TemporalResult; rel_R/rel_t is the predicted KF->CF pose."""
    rig_a = rig_arrays_from_rig(rig, _device(device))

    def step(kf_mates, kf_frame, cf_mates, cf_frame, rel_R, rel_t,
             seed) -> TemporalResult:
        quads, tmetrics = TM.match_temporal(
            kf_mates, cf_mates, kf_frame, cf_frame, geom.Pose(rel_R, rel_t),
            rig_a, cfg)
        pq = MT.lift_quads(kf_mates, quads, rig_a, cfg)
        res = MT.estimate_pose(pq, rig_a, cfg, seed)
        return TemporalResult(quads=quads, temporal_metrics=tmetrics,
                              R=res.R, t=res.t, inlier_count=res.inlier_count,
                              inlier_ratio=res.inlier_ratio,
                              n_quads=res.n_quads, success=res.success)

    return step


@dataclasses.dataclass
class VOPipeline:
    """Host-side loop carrying keyframe state across frames.

    keyframe_policy: "reference" (frame 0 only), "every_frame" (previous
    frame becomes the keyframe) or "adaptive" (re-keyframe when the
    inlier ratio or quad count drops below its threshold).

    device: "cuda" (the default) runs the hand-written kernels and raises
    where no CUDA device exists; "cpu" runs their plain twins."""

    rig: StereoRig
    cfg: VOConfig
    device: object = "cuda"
    has_gt_disparity: bool = False
    use_gt_pose: bool = False
    keyframe_policy: str = "every_frame"
    rekeyframe_min_inlier_ratio: float = 0.4
    rekeyframe_min_quads: int = 50
    ba_window: int = 0

    def __post_init__(self):
        if self.has_gt_disparity or self.use_gt_pose:
            raise NotImplementedError(
                "GT supervision / GT-pose modes are ROADMAP queue 1 item 5")
        if self.keyframe_policy not in ("reference", "every_frame",
                                        "adaptive"):
            raise ValueError(f"unknown keyframe_policy "
                             f"{self.keyframe_policy!r}")
        if self.ba_window:
            raise NotImplementedError(
                "windowed BA (ba_window > 0) is ROADMAP queue 1 item 6")
        self.device = torch.device(self.device)
        self._stereo_step = build_stereo_step(self.rig, self.cfg, self.device)
        self._temporal_step = build_temporal_step(self.rig, self.cfg,
                                                  self.device)
        # bootstrap: the first temporal step has no velocity (identity
        # prediction), so it runs with the reference-mode window radius
        self._temporal_step_boot = self._temporal_step
        if self.cfg.temporal_gather_mode == "prediction":
            boot_cfg = dataclasses.replace(
                self.cfg,
                temporal_grid_radius_prod=self.cfg.temporal_grid_radius,
                quad_gather_slots_prod=self.cfg.quad_gather_slots)
            self._temporal_step_boot = build_temporal_step(
                self.rig, boot_cfg, self.device)
        self._have_velocity = False
        self.keyframe: Optional[FrameResult] = None
        self.kf_index = 0
        self.kf_pose_est = geom.Pose.identity(self.device)
        self.trajectory = []                       # per-frame world->cam
        self.frame_idx = 0
        self.last_rel = geom.Pose.identity(self.device)   # predicted KF->CF
        self.prev_cam_pose: Optional[geom.Pose] = None

    def run_frame(self, left_img, right_img):
        """Process one stereo frame; returns (FrameResult, TemporalResult or
        None)."""
        fr = self._stereo_step(left_img, right_img)
        tr = None
        if self.keyframe is None:
            self._set_keyframe(fr)
            self.trajectory.append(self.kf_pose_est)
            self.prev_cam_pose = self.kf_pose_est
        else:
            step = (self._temporal_step if self._have_velocity
                    else self._temporal_step_boot)
            tr = step(self.keyframe.mates, self.keyframe.frame, fr.mates,
                      fr.frame, self.last_rel.R, self.last_rel.t,
                      self.cfg.ransac_seed + self.frame_idx)
            if bool(tr.success):
                self._have_velocity = True
            rel_est = geom.Pose(tr.R, tr.t)
            cam_pose = rel_est.compose(self.kf_pose_est)
            self.trajectory.append(cam_pose)
            # constant-velocity prediction: previous frame -> current frame
            vel = geom.relative_pose(self.prev_cam_pose, cam_pose)
            self.prev_cam_pose = cam_pose
            if self._should_rekeyframe(tr):
                self.kf_pose_est = cam_pose
                self._set_keyframe(fr)
                self.last_rel = vel
            else:
                self.last_rel = vel.compose(rel_est)
        self.frame_idx += 1
        return fr, tr

    def _should_rekeyframe(self, tr: TemporalResult) -> bool:
        if self.keyframe_policy == "reference":
            return False
        if self.keyframe_policy == "every_frame":
            return True
        return (float(tr.inlier_ratio) < self.rekeyframe_min_inlier_ratio
                or int(tr.n_quads) < self.rekeyframe_min_quads)

    def _set_keyframe(self, fr: FrameResult):
        self.keyframe = fr
        self.kf_index = self.frame_idx
