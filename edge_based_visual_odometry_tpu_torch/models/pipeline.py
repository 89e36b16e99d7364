"""Frame-level VO pipeline: the stereo step, the temporal step, the
per-frame loop.

Port of `edge_based_visual_odometry_tpu/models/pipeline.py`:

  stereo step   = undistort (distorted rigs) + Sobel + TOED on both images
                  (one launch of the gradient-field kernel for the pair) +
                  `match_stereo`
  temporal step = `match_temporal` + `lift_quads` + `estimate_pose`

On a CUDA device each step replays a CUDA graph of its body from its
third call on (`utils/graphs.py`): the same kernels and ops, launched by
one replay in place of the host's ~1,900 launches a frame, the
supervised steps' (GT maps, GT pose) too. Calls with recorded
distributions or a GN capture run eagerly, as every call does on the
CPU.

`VOPipeline.run_frame` carries the keyframe state across frames with the
`reference`, `every_frame` and `adaptive` keyframe policies, a bootstrap
temporal step (reference-mode gather window) until the first successful
pose, and constant-velocity prediction. Evaluation modes: GT disparity
supervision of the stereo cascade (`has_gt_disparity`), quads from the GT
relative pose (`use_gt_pose`), filter distributions
(`record_distributions`). The supervised modes' stage rows are kept on
the device (`StageRows`) and read to the host when the logs are read;
`EVAL` counts them. `ba_window >= 2` refines the keyframe poses with
the sliding-window BA of `models/window_ba.py`.
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
    EdgeList, FrameData, StereoMates, resolve_device, rig_arrays_from_rig)
from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.ops import image as IMG
from edge_based_visual_odometry_tpu_torch.ops import patches as PAT
from edge_based_visual_odometry_tpu_torch.ops import toed
from edge_based_visual_odometry_tpu_torch.utils.graphs import StepGraph
from edge_based_visual_odometry_tpu_torch.utils.timing import span

# the evaluation path since the last `cuda_build.reset_launch_counts()`:
# stage rows logged (stereo, temporal), GT-map bytes handed to the stereo step
EVAL = CB.counter("stereo_rows", "temporal_rows", "gt_bytes")


class FrameResult(NamedTuple):
    frame: FrameData
    mates: StereoMates
    stereo_metrics: torch.Tensor     # (n_stages, 4)
    n_left_edges: torch.Tensor
    n_right_edges: torch.Tensor
    # filter / ambiguity distributions; None unless the step was built
    # with record_distributions
    distributions: Optional[dict] = None
    # the right image's edges the supervised cascade read; None unless the
    # step was built with has_gt
    right_edges: Optional[EdgeList] = None


class TemporalResult(NamedTuple):
    quads: TM.TemporalQuads
    temporal_metrics: torch.Tensor   # (n_stages, 4)
    R: torch.Tensor                  # relative pose KF -> CF
    t: torch.Tensor
    inlier_count: torch.Tensor
    inlier_ratio: torch.Tensor
    n_quads: torch.Tensor
    success: torch.Tensor


class StageRows:
    """One step's stage-row log. `append` copies a (n_stages, 4) row into
    the next slot of a device block of `BLOCK` rows: no wait for the
    device, and no hold on the row's tensor, which may view a graph
    replay's whole result. `rows()` reads what is new to the host in one
    copy and gives every row in order, as numpy arrays. `counter`: its
    entry of `EVAL`."""

    BLOCK = 1024

    def __init__(self, counter: str):
        self.counter = counter
        self.blocks = []
        self.n = 0
        self._read = []

    def append(self, row: torch.Tensor):
        i = self.n % self.BLOCK
        if i == 0:
            self.blocks.append(torch.empty((self.BLOCK, *row.shape),
                                           dtype=row.dtype,
                                           device=row.device))
        self.blocks[-1][i].copy_(row)
        self.n += 1
        EVAL[self.counter] += 1

    def rows(self) -> list:
        if len(self._read) < self.n:
            first = len(self._read) // self.BLOCK
            host = torch.cat(self.blocks[first:]).cpu().numpy()
            self._read = (self._read[:first * self.BLOCK]
                          + list(host[:self.n - first * self.BLOCK]))
        return list(self._read)


def _needs_undistort(cam) -> bool:
    return any(abs(d) > 0 for d in cam.distortion[:4])


def check_config(cfg: VOConfig, device: torch.device):
    """What the step builders check at construction: the reference's
    patch-coverage guard on every device (`patches.check_coverage`: the
    NCC patches of `patch_size` at `orthogonal_shift_mag` must fit the
    32 / 8 atlas tile), and on CUDA the kernels' ranges
    (`check_kernel_ranges`). Raises ValueError naming the fields."""
    PAT.check_coverage(
        cfg.patch_size, cfg.orthogonal_shift_mag,
        what=f"VOConfig.patch_size = {cfg.patch_size!r} with "
             f"VOConfig.orthogonal_shift_mag = {cfg.orthogonal_shift_mag!r}")
    if device.type == "cuda":
        CB.check_kernel_ranges(cfg)


def build_stereo_step(rig: StereoRig, cfg: VOConfig, device,
                      has_gt: bool = False,
                      record_distributions: bool = False):
    """fn(left, right[, disparity, occlusion]) -> FrameResult; images
    (H, W) numpy or tensors on any device, uint8 or float. A camera with
    non-zero distortion coefficients is undistorted on the device first.
    `has_gt`: the step takes the GT disparity map and the non-occlusion
    mask and supervises the cascade with them. A setting the reference
    refuses, or on CUDA one outside a kernel's range, raises here
    (`check_config`). On CUDA, without `record_distributions`, a call
    replays the step's graph (`StepGraph`) once it is captured: the
    images (and the maps) are copied to the graph's static inputs, the
    rest is the graph."""
    device = resolve_device(device)
    check_config(cfg, device)
    rig_a = rig_arrays_from_rig(rig, device)
    gather_ry = SM.derive_gather_band(rig, cfg)
    dists = [torch.tensor(cam.distortion[:4], dtype=torch.float32,
                          device=device) if _needs_undistort(cam) else None
             for cam in (rig.left, rig.right)]

    def step(left, right, disparity=None, occlusion=None) -> FrameResult:
        with span("stereo_step"):
            imgs = (_tensor(left), _tensor(right))
            maps = None
            if has_gt:
                maps = (_tensor(disparity),
                        None if occlusion is None else _tensor(occlusion))
                EVAL["gt_bytes"] += sum(m.nbytes for m in maps
                                        if m is not None)
            if graph is None:
                return _step(imgs, maps)
            return graph((imgs, maps) if has_gt else (imgs,))

    def _step(imgs, maps):
        with span("upload"):
            # a host image's copy is pageable: the host waits for it
            with span("wait.upload"):
                imgs = [a.to(device) for a in imgs]
            both = torch.stack(imgs).to(dtype=torch.float32)
        if maps is not None:
            with span("gt_upload"):
                with span("wait.gt_upload"):
                    maps = tuple(None if m is None else m.to(device)
                                 for m in maps)
        return _match(both, maps)

    def _graph_body(imgs, *rest):
        # rest: (maps, seed, generator) with `has_gt`, else (seed, generator)
        return _match(torch.stack(imgs).to(dtype=torch.float32),
                      rest[0] if has_gt else None)

    def _match(both, maps):
        if dists[0] is not None or dists[1] is not None:
            with span("undistort"):
                both = torch.stack([
                    img if d is None else IMG.undistort(img, K, d)
                    for img, K, d in zip(both,
                                         (rig_a.K_left, rig_a.K_right),
                                         dists)])
        with span("sobel"):
            gxs, gys = IMG.sobel_gradients(both)
            frame = FrameData(left=both[0], right=both[1],
                              left_gx=gxs[0], left_gy=gys[0],
                              right_gx=gxs[1], right_gy=gys[1])
        with span("detect_edges"):
            led, red = toed.detect_edges(
                both, kernel_size=cfg.toed_kernel_size, sigma=cfg.toed_sigma,
                grad_mag_min=cfg.toed_grad_mag_min, max_edges=cfg.max_edges,
                border=cfg.toed_border)
        with span("match_stereo"):
            out = SM.match_stereo(
                led, red, frame, rig_a, cfg,
                disparity_map=(None if maps is None
                               else maps[0].to(torch.float32)),
                occlusion_map=(None if maps is None or maps[1] is None
                               else maps[1].to(torch.float32)),
                gather_ry=gather_ry,
                record_distributions=record_distributions)
        return FrameResult(frame=frame, mates=out[0], stereo_metrics=out[2],
                           n_left_edges=led.count, n_right_edges=red.count,
                           distributions=out[3] if record_distributions
                           else None,
                           right_edges=red if maps is not None else None)

    graph = (StepGraph("stereo_step", _graph_body, device,
                       load_spans=(("upload", "wait.upload"),
                                   ("gt_upload", "wait.gt_upload")))
             if device.type == "cuda" and not record_distributions else None)
    return step


def _tensor(a) -> torch.Tensor:
    return a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))


def build_temporal_step(rig: StereoRig, cfg: VOConfig, device,
                        use_gt: bool = False):
    """fn(kf_mates, kf_frame, cf_mates, cf_frame, rel_R, rel_t, seed) ->
    TemporalResult; rel_R/rel_t is the KF->CF pose used for quad
    prediction (GT with `use_gt`, predicted in production). A setting the
    reference refuses, or on CUDA one outside a kernel's range, raises
    here (`check_config`). On CUDA a call whose tensors are all on the
    device replays the step's graph (`StepGraph`) once it is captured;
    its RANSAC draws come from the graph's generator, seeded with `seed`
    before each replay, and equal the eager step's."""
    device = resolve_device(device)
    check_config(cfg, device)
    rig_a = rig_arrays_from_rig(rig, device)

    def step(kf_mates, kf_frame, cf_mates, cf_frame, rel_R, rel_t,
             seed) -> TemporalResult:
        with span("temporal_step"):
            if graph is None:
                return _body(kf_mates, kf_frame, cf_mates, cf_frame, rel_R,
                             rel_t, seed)
            return graph(((kf_mates, kf_frame), (cf_mates, cf_frame),
                          (rel_R, rel_t)), seed)

    def _body(kf_mates, kf_frame, cf_mates, cf_frame, rel_R, rel_t, seed,
              generator=None):
        with span("match_temporal"):
            quads, tmetrics = TM.match_temporal(
                kf_mates, cf_mates, kf_frame, cf_frame,
                geom.Pose(rel_R, rel_t), rig_a, cfg, use_gt=use_gt)
        with span("lift_quads"):
            pq = MT.lift_quads(kf_mates, quads, rig_a, cfg, use_gt=use_gt)
        with span("estimate_pose"):
            res = (MT.estimate_pose(pq, rig_a, cfg, seed) if generator is None
                   else MT.estimate_pose(pq, rig_a, cfg, seed,
                                         generator=generator))
        return TemporalResult(quads=quads, temporal_metrics=tmetrics,
                              R=res.R, t=res.t, inlier_count=res.inlier_count,
                              inlier_ratio=res.inlier_ratio,
                              n_quads=res.n_quads, success=res.success)

    def _graph_body(kf, cf, rel, seed, generator):
        return _body(*kf, *cf, *rel, seed, generator)

    graph = (StepGraph("temporal_step", _graph_body, device, generator=True)
             if device.type == "cuda" else None)
    return step


@dataclasses.dataclass
class VOPipeline:
    """Host-side loop carrying keyframe state across frames.

    keyframe_policy: "reference" (frame 0 only), "every_frame" (previous
    frame becomes the keyframe) or "adaptive" (re-keyframe when the
    inlier ratio or quad count drops below its threshold).

    device: "cuda" (the default) runs the hand-written kernels and raises
    where no CUDA device exists; "cpu" runs their plain twins.

    has_gt_disparity: `run_frame` takes the GT disparity (and optionally
    the non-occlusion mask, 255 = visible) and logs the stereo stage rows.
    use_gt_pose: quads are built from the GT relative pose and the
    temporal stage rows are logged. The logs, `stereo_metrics_log` and
    `temporal_metrics_log`, are lists of (n_stages, 4) numpy rows, read
    from the device when they are read (`StageRows`). ba_window:
    sliding-window BA length in keyframes (0 = off, >= 2 on; needs a
    re-keyframing policy).

    A rig with non-zero distortion coefficients is undistorted inside the
    stereo step, on `device` (the reference goes through cv2 on the host
    where cv2 imports; the port keeps the one path, so that a run does not
    depend on the packages installed)."""

    rig: StereoRig
    cfg: VOConfig
    device: object = "cuda"
    has_gt_disparity: bool = False
    use_gt_pose: bool = False
    keyframe_policy: str = "every_frame"
    rekeyframe_min_inlier_ratio: float = 0.4
    rekeyframe_min_quads: int = 50
    ba_window: int = 0
    ba_mesh: object = None
    record_distributions: bool = False

    def __post_init__(self):
        if self.keyframe_policy not in ("reference", "every_frame",
                                        "adaptive"):
            raise ValueError(f"unknown keyframe_policy "
                             f"{self.keyframe_policy!r}")
        self.device = resolve_device(self.device)
        self._stereo_step = build_stereo_step(
            self.rig, self.cfg, self.device, self.has_gt_disparity,
            record_distributions=self.record_distributions)
        self._temporal_step = build_temporal_step(
            self.rig, self.cfg, self.device, self.use_gt_pose)
        # bootstrap: the first temporal step has no velocity (identity
        # prediction), so it runs with the reference-mode window radius
        self._temporal_step_boot = self._temporal_step
        if (not self.use_gt_pose
                and self.cfg.temporal_gather_mode == "prediction"):
            boot_cfg = dataclasses.replace(
                self.cfg,
                temporal_grid_radius_prod=self.cfg.temporal_grid_radius,
                quad_gather_slots_prod=self.cfg.quad_gather_slots)
            self._temporal_step_boot = build_temporal_step(
                self.rig, boot_cfg, self.device, self.use_gt_pose)
        self._have_velocity = False
        self.wba = None
        if self.ba_window >= 2:
            # track chaining links the previous keyframe's mates to the new
            # keyframe through the quads of the re-keyframing frame; the
            # frame-0-forever policy never yields a second keyframe
            if self.keyframe_policy not in ("every_frame", "adaptive"):
                raise ValueError(
                    "windowed BA (ba_window >= 2) requires a re-keyframing "
                    f"policy, got keyframe_policy={self.keyframe_policy!r}")
            from edge_based_visual_odometry_tpu_torch.models.window_ba import (
                WindowBA, WindowBAConfig)
            self.wba = WindowBA(self.rig.left.K,
                                WindowBAConfig(window=self.ba_window),
                                mesh=self.ba_mesh, device=self.device)
        self.keyframe: Optional[FrameResult] = None
        self.kf_index = 0
        self._ba_kf_frames = []       # frame index of each BA-window keyframe
        self.kf_pose_gt: Optional[geom.Pose] = None     # world->cam GT
        self.kf_pose_est = geom.Pose.identity(self.device)
        self.trajectory = []                       # per-frame world->cam
        self.frame_idx = 0
        self._stereo_rows = StageRows("stereo_rows")
        self._temporal_rows = StageRows("temporal_rows")
        self.ba_info_log = []         # per-BA-solve info dicts
        self.last_rel = geom.Pose.identity(self.device)   # predicted KF->CF
        self.prev_cam_pose: Optional[geom.Pose] = None

    @property
    def stereo_metrics_log(self) -> list:
        return self._stereo_rows.rows()

    @property
    def temporal_metrics_log(self) -> list:
        return self._temporal_rows.rows()

    def _on_device(self, pose: Optional[geom.Pose]) -> Optional[geom.Pose]:
        if pose is None:
            return None
        return geom.Pose(*(torch.as_tensor(a).to(self.device, torch.float32)
                           for a in pose))

    def run_frame(self, left_img, right_img, disparity=None,
                  gt_pose: Optional[geom.Pose] = None, occlusion=None):
        """Process one stereo frame; returns (FrameResult, TemporalResult or
        None). `disparity`, `occlusion`: GT left disparity and
        non-occlusion mask (255 = visible) of the GT supervision mode;
        `gt_pose`: world->cam GT pose of the frame (`use_gt_pose`)."""
        with span("frame", self.frame_idx):
            return self._run_frame(left_img, right_img, disparity, gt_pose,
                                   occlusion)

    def _run_frame(self, left_img, right_img, disparity, gt_pose, occlusion):
        gt_pose = self._on_device(gt_pose)
        if self.has_gt_disparity:
            if occlusion is None:
                occlusion = np.full(np.asarray(disparity).shape, 255.0,
                                    np.float32)
            fr = self._stereo_step(left_img, right_img, disparity, occlusion)
        else:
            fr = self._stereo_step(left_img, right_img)
        tr = None
        if self.keyframe is None:
            with span("keyframe"):
                self._set_keyframe(fr, gt_pose)
                self.trajectory.append(self.kf_pose_est)
                self.prev_cam_pose = self.kf_pose_est
                if self.wba is not None:
                    self.wba.add_keyframe(fr.mates, self.kf_pose_est)
                    self._ba_kf_frames.append(self.frame_idx)
        else:
            if self.use_gt_pose:
                rel = geom.relative_pose(self.kf_pose_gt, gt_pose)
            else:
                rel = self.last_rel    # constant-velocity prediction
            step = (self._temporal_step if self._have_velocity
                    else self._temporal_step_boot)
            tr = step(self.keyframe.mates, self.keyframe.frame, fr.mates,
                      fr.frame, rel.R, rel.t,
                      self.cfg.ransac_seed + self.frame_idx)
            with span("wait.success"):
                success = bool(tr.success)
            if success:
                self._have_velocity = True
            rel_est = geom.Pose(tr.R, tr.t)
            cam_pose = rel_est.compose(self.kf_pose_est)
            self.trajectory.append(cam_pose)
            # constant-velocity prediction: previous frame -> current frame
            vel = geom.relative_pose(self.prev_cam_pose, cam_pose)
            self.prev_cam_pose = cam_pose
            with span("keyframe"):
                rekeyframe = self._should_rekeyframe(tr)
                if rekeyframe:
                    self.kf_pose_est = cam_pose
                    self._set_keyframe(fr, gt_pose)
                    self.last_rel = vel
                else:
                    self.last_rel = vel.compose(rel_est)
            if rekeyframe and self.wba is not None:
                with span("window_ba"):
                    self._run_window_ba(fr, tr, cam_pose)
        if self.has_gt_disparity or (self.use_gt_pose and tr is not None):
            with span("eval.rows"):
                if self.has_gt_disparity:
                    self._stereo_rows.append(fr.stereo_metrics)
                if self.use_gt_pose and tr is not None:
                    self._temporal_rows.append(tr.temporal_metrics)
        self.frame_idx += 1
        return fr, tr

    def _run_window_ba(self, fr: FrameResult, tr: TemporalResult, cam_pose):
        """Register the new keyframe with its track links, solve the
        window, and write the refined keyframe poses back."""
        from edge_based_visual_odometry_tpu_torch.models.window_ba import (
            best_links_from_quads)
        self.wba.add_keyframe(fr.mates, cam_pose, best_links_from_quads(tr))
        self._ba_kf_frames.append(self.frame_idx)
        out = self.wba.run()
        if out is None:
            return
        poses, ba_info = out
        self.ba_info_log.append(ba_info)
        # Refresh the KEYFRAME entries of the trajectory and the current
        # estimate. Under 'adaptive' keyframes are a sparse subset of
        # frames, so write back at the recorded keyframe frame indices (the
        # frames between keep their relative estimates), aligned from the
        # END: newest pose <-> newest recorded keyframe index, which stays
        # right when fewer indices than poses are recorded.
        ks = self._ba_kf_frames
        m = min(len(ks), len(poses))
        for fi, p in zip(ks[-m:], poses[-m:]):
            self.trajectory[fi] = p
        self.kf_pose_est = poses[-1]

    def _should_rekeyframe(self, tr: TemporalResult) -> bool:
        if self.keyframe_policy == "reference":
            return False
        if self.keyframe_policy == "every_frame":
            return True
        with span("wait.keyframe"):
            return (float(tr.inlier_ratio) < self.rekeyframe_min_inlier_ratio
                    or int(tr.n_quads) < self.rekeyframe_min_quads)

    def _set_keyframe(self, fr: FrameResult, gt_pose: Optional[geom.Pose]):
        self.keyframe = fr
        self.kf_index = self.frame_idx
        self.kf_pose_gt = gt_pose
