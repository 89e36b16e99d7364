"""Runtime configuration for the TPU edge-VO framework.

This module is a copy of `edge_based_visual_odometry_tpu/config.py`, kept
equal to it by tests/test_torch_config.py (fields, defaults, checks). Its
comments are the JAX package's: every fps or ms figure in them was
measured for the JAX package on a TPU v5e and is no figure for the
PyTorch port (see PERF.md for the port's).

The reference keeps ~50 compile-time ``#define`` thresholds in
``include/definitions.h:16-86`` plus a per-dataset YAML schema parsed by
``src/Dataset.cpp:54-148``.  Here every tier-2 compile-time constant is lifted
into one frozen dataclass (``VOConfig``) whose fields are static arguments of
the jitted pipeline, and the YAML schema is parsed into ``StereoRig``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class VOConfig:
    """All pipeline thresholds (reference: include/definitions.h:16-86).

    These are Python-level constants: they are closed over by jitted
    functions, so changing any field triggers a recompile (intended - the
    reference requires a rebuild for the same change).

    Reference defines deliberately NOT mirrored here (a field that is
    consumed nowhere would be worse than no field):
      EPIP_TENGENCY_{ORIENT,PROXIM}_THRESH, EDGE_CLUSTER_THRESH - defined
        in definitions.h but never referenced by the reference itself.
      LOWES_RATIO - passed to apply_Lowe_Ratio_Test, whose body keeps the
        single best candidate unconditionally and never reads the ratio
        (Stereo_Matches.cpp:1513 + function body); our Best stage matches.
      GRID_SIZE - the reference's square-cell SpatialGrid; our scatter-free
        sorted grid (ops/grid.py) uses y-bands + exact x ranges, so there
        is no square-cell size (band_h is its analog, an explicit arg).
      RANSAC min_iterations / success_prob - drive the reference's
        adaptive sequential termination (MotionTracker.cpp:196-248); the
        batched fixed-iteration RANSAC scores all hypotheses in parallel
        (documented deviation, see README).
      The veridical search radius (Temporal_Matches.cpp:68) - a gather
        superset; our veridical gather uses the exact <2 px gates directly
        with a sufficient radius, equivalent by construction.
    """

    # --- Stereo edge matching (definitions.h:17-36) ---
    epipolar_line_dist_thresh: float = 0.5     # px (EPIPOLAR_LINE_DIST_THRESH)
    max_disparity: float = 25.0                # px (MAX_DISPARITY)
    orthogonal_shift_mag: float = 5.0          # px (ORTHOGONAL_SHIFT_MAG)
    patch_size: int = 7                        # px (PATCH_SIZE)
    ncc_thresh: float = 0.6                    # (NCC_THRESH)
    epip_tangency_displ_thresh: float = 3.0    # px (EPIP_TANGENCY_DISPL_THRESH)
    location_perturbation: float = 0.4         # px (LOCATION_PERTURBATION)
    orient_perturbation: float = 0.174533      # rad = 10 deg (ORIENT_PERTURBATION)
    cluster_dist_thresh: float = 1.0           # px (CLUSTER_DIST_THRESH)
    cluster_orient_thresh: float = 20.0        # deg (CLUSTER_ORIENT_THRESH)
    max_cluster_size: int = 10                 # (MAX_CLUSTER_SIZE)
    cluster_orient_gauss_sigma: float = 2.0    # (CLUSTER_ORIENT_GAUSS_SIGMA)
    bnb_sift: float = 0.4                      # (BNB_SIFT)
    bnb_ncc: float = 0.9                       # (BNB_NCC)
    huber_delta: float = 1.0                   # (HUBER_DELTA)
    sift_threshold: float = 500.0              # (SIFT_THRESHOLD) descriptor gate, stereo
    orientation_thresh_deg: float = 10.0       # stereo orientation filter arg (Stereo_Matches.cpp:1399)

    # --- Precision/recall eval (definitions.h:42-43) ---
    dist_to_gt_thresh: float = 1.0             # px (DIST_TO_GT_THRESH)
    dist_to_gt_thresh_quads: float = 2.0       # px (DIST_TO_GT_THRESH_QUADS)

    # --- RANSAC constraint gates (definitions.h:47-50) ---
    tau_c1: float = 0.13
    tau_c2: float = 0.12
    tau_c3: float = 0.12
    tau_c4: float = 0.32

    # --- RANSAC options (reference include/MotionTracker.h:37-62) ---
    ransac_max_iterations: int = 5000
    ransac_max_reproj_error: float = 1.5       # px
    ransac_top_rank_percentage: float = 0.7
    ransac_seed: int = 42
    ransac_refine: bool = True     # inlier-set Kabsch refinement (new
                                   # capability; the reference returns the
                                   # raw 2-point winner)
    # Preemptive two-stage scoring (deviation; cf. Nister's preemptive
    # RANSAC): every hypothesis is first scored on the top-ranked
    # `ransac_prescore_quads` quads of the PROSAC ordering, then only the
    # best `ransac_prescore_keep` hypotheses are scored on the full quad
    # set (the winner's inlier count stays a full-set count). ~6x less
    # scoring work than the (K, Q) matrix at the round-4 budgets; the
    # reference's sequential loop with adaptive termination likewise
    # scores only a fraction of hypotheses exhaustively
    # (MotionTracker.cpp:196-248). 0 disables (exact full scoring).
    ransac_prescore_quads: int = 4096
    ransac_prescore_keep: int = 256

    # --- TOED (definitions.h:76-77) ---
    toed_kernel_size: int = 17                 # (TOED_KERNEL_SIZE)
    toed_sigma: float = 2.0                    # (TOED_SIGMA)
    toed_grad_mag_min: float = 2.0             # NMS gate (cpu_toed.cpp:406)
    toed_border: int = 10                      # interp-image + image border rejection (cpu_toed.cpp:401,553)

    # --- Temporal quad cascade (Temporal_Matches.cpp hard-coded args) ---
    temporal_grid_radius: float = 30.0         # px (Temporal_Matches.cpp:184)
    temporal_orient_thresh_deg: float = 10.0   # (Temporal_Matches.cpp:188)
    temporal_ncc_thresh: float = 0.8           # (Temporal_Matches.cpp:192)
    temporal_sift_thresh: float = 200.0        # (Temporal_Matches.cpp:197)
    temporal_bnb_ratio: float = 0.8            # (Temporal_Matches.cpp:201,205)
    temporal_huber_delta: float = 3.0          # (Temporal_Matches.cpp:612)
    veridical_orient_thresh_deg: float = 10.0  # (Temporal_Matches.cpp:67)
    sift_shift_mag: float = 8.0                # descriptor keypoint shift (Stereo_Matches.cpp:669)

    # --- Gauss-Newton photometric refinement (Stereo_Matches.cpp:1159-1288) ---
    gn_max_iter: int = 20
    gn_tol: float = 1e-3
    # two-phase convergence compaction (ops/gauss_newton._two_phase): all
    # lanes run gn_phase1_iters, then only the unconverged minority
    # (compacted to a gn_phase2_budget buffer) pays the remaining
    # iterations. 0 disables (single-phase, identical results).
    gn_phase1_iters: int = 2
    gn_phase2_budget: int = 16384
    # ^ round-5 sweep (capacity_sweep r5combo, 2026-08-20): phase1 2
    # iters + 16k phase-2 budget + tile 32 measured 1.244 fps vs 1.001
    # at (4, 32k, 40) with EQUAL-OR-BETTER pose quality (f1 0.019 deg /
    # 1.9 mm vs 0.056 / 3.3; pct_refined 1.0 both)
    gn_tile: int = 32               # GN sampling tile (travel bound, px;
    # 32 -> stride 8, window +-11 = patch extent 8.75 + ~2.2 px travel;
    # the r5combo sweep row shows no quality cost vs 40)
    # 2-pass split-weight bf16 value sampling in the GN refiners
    # (ops/tiled_sampling.bilinear_sample_tiles weight_split): exact to
    # ~0.003 gray for integer-valued (uint8-sourced) images - the
    # production PNG path; keep False for non-integer sources (host-
    # undistorted EuRoC frames)
    gn_weight_split: bool = True
    # ^ round-5 sweep: 1.301 vs 1.244 fps at comparable quality even on
    # FLOAT-valued frames (worst pose delta ~2 mm); exact to ~0.003 gray
    # on the integer-valued production PNG path

    # --- GT supervision path (Stereo_Matches.cpp:146,228) ---
    gt_orient_exclusion_deg: float = 4.0       # omit edges near 0/±180 deg
    gt_pair_dist_tol: float = 1.0              # px (Stereo_Matches.cpp:228)
    gt_pair_orient_tol: float = 5.0            # deg (Stereo_Matches.cpp:228)

    # --- Fixed-shape capacities (TPU-specific; no reference equivalent:
    #     the reference uses dynamically-sized std::vectors) ---
    # Round-4 capacity defaults: chosen from the measured TPU capacity
    # sweep (benchmarks/capacity_sweep_results.jsonl, "combo24k" row) so
    # the production workload matches the reference's keep-everything
    # semantics (unbounded candidate storage, Dataset.h:180-289; refine
    # every survivor, Stereo_Matches.cpp:1290-1358). At KITTI resolution
    # (~24.2k edges/image): final mates 23,948 < 24,576 (nothing
    # truncated), GN input 91,291 < 131,072 (100% refined). Quality vs
    # the old starved defaults (8k mates, 72% refined): pose error f1
    # (0.535 deg, 47 mm) -> (0.042 deg, 4.2 mm), f2 (0.065 deg, 5 mm) ->
    # (0.024 deg, 2.5 mm). Raising max_pose_quads is only safe TOGETHER
    # with these (alone on starved mates it admits ambiguous quads and
    # degrades pose 10x - NOTES.md round 4). Fits HBM with 8.2 GiB
    # headroom after the attribute-major grid/patch layouts
    # (benchmarks/hbm_probe.py).
    max_edges: int = 32768          # per-image TOED edge capacity
    max_candidates: int = 32        # per-left-edge stereo candidate capacity
    gather_slots: int = 160         # raw grid-gather slots before compaction
    max_mates: int = 24576          # finalized stereo mates capacity
    max_refine_pairs: int = 131072  # flat (row, cand) capacity for GN/post-NCC
    max_gate_pairs: int = 393216    # flat capacity for the desc/NCC gate
    # stages (must cover measured post-orientation pairs: ~274k at KITTI
    # res; chunk skipping makes the budget tail nearly free)
    gate_chunk: int = 8192          # pairs per chunk in the flat gate stages
    gate_layout: str = "dense"      # "dense" ((N, C) row chunks) | "flat"
    # (active-pair list) for the desc/NCC gate stages; identical results
    # on CPU and at small shapes. DEFAULT IS DENSE: the flat descriptor
    # gate ("flat"/"flat4") is mis-fused by the current TPU compiler at
    # production shapes (376x1241, default budgets) - the whole cascade
    # silently collapses to zero while CPU stays correct; bisect history
    # in benchmarks/NOTES.md round 3. "flat5" (NCC-only flat) compiles
    # correctly but measured no faster than dense (1.387 vs 1.388 fps),
    # so dense is both the safe and the simple choice. "flat4"/"flat5"
    # apply the flat layout to ONLY the descriptor (4) or NCC (5) stage -
    # single-stage bisect arms (scripts/bisect_flat.py).
    # Temporal NCC/desc gate layout: "dense" ((M, Cq) full computation) |
    # "flat" (compact active pairs first; work scales with the ~20%
    # post-orientation occupancy). Identical results for live slots;
    # flat's budget overflow passes unscored (stereo flat-gate rule).
    temporal_gate_layout: str = "dense"
    temporal_gate_pairs: int = 262144   # flat budget (of M * Cq slots)
    max_quad_candidates: int = 32   # per-KF-mate temporal candidate capacity
    # (sized 48 for the reference's radius-30 window; the prediction-
    # centered radius-16 production window has ~4x less ambiguity, and
    # the sweep shows Cq=32 keeps Cq=48's pose quality at +9% fps while
    # Cq=24 starts to cost accuracy - capacity_sweep cq24/cq32 rows)
    quad_gather_slots: int = 576    # raw temporal grid-gather slots (total)
    # Production temporal gather (TPU-native deviation, README table):
    # the reference searches radius 30 around the KF location because its
    # window must absorb the FULL inter-frame motion
    # (Temporal_Matches.cpp:184). The production pipeline has a
    # constant-velocity prediction (pipeline.py), so the window only
    # needs to absorb PREDICTION ERROR (acceleration-bounded, a few px)
    # - centering the gather at the projected prediction lets the radius
    # and slot count shrink ~4x (the (M, S) raw-window stage measured
    # 157+ ms of the 941 ms temporal step at S=576; NOTES round 4).
    # Eval mode (use_gt=True) always uses reference semantics for the
    # stage-table parity harness. The pipeline runs its FIRST temporal
    # step (identity prediction, error = full motion) on a bootstrap
    # program with the reference radius/slots.
    temporal_gather_mode: str = "prediction"   # "prediction" | "reference"
    temporal_grid_radius_prod: float = 16.0    # px around the prediction
    quad_gather_slots_prod: int = 192          # raw slots (prediction mode)
    max_pose_quads: int = 32768     # flat quad budget for RANSAC scoring
    sample_chunk: int = 512         # candidates per chunk in tiled sampling
    # (swept on v5e at KITTI size: 512 beats 1024/2048/4096/8192 - smaller
    # serial chunks pipeline better against the atlas row-gathers)
    gn_phase1_chunk: int = 4096     # candidates per chunk in GN PHASE 1:
    # fixed iteration count -> no convergence-coupling penalty for wide
    # chunks, and 131072/512 = 256 serial chunks was pure overhead
    # (ops/gauss_newton._two_phase). Phase 2 keeps gn_chunk.
    gn_chunk: int = 512             # candidates per chunk in the GN refiners
    # (isolated GN strongly prefers 2048 - 34 vs 154 ms at 65k pairs - but
    # in-cascade the active set is small and 512 measured equal-or-better:
    # 604 vs 610 ms stereo; kept as a separate knob for large-budget runs)
                                    # (bounds tile-buffer HBM working set)
    cell_capacity: int = 16         # per-grid-cell edge capacity

    # --- Descriptor (SIFT replacement; deliberate deviation, see
    #     ops/descriptors.py docstring) ---
    desc_patch_samples: int = 16    # 16x16 sampling grid
    desc_spatial_bins: int = 4      # 4x4 spatial cells
    desc_orient_bins: int = 8       # 8 orientation bins -> 128-D
    # 0.66 matches cv::SIFT's window at the reference's keypoint size=1
    # (3*scale*(d+1)*sqrt(2)/2 ~= 5.3 px half-width; Stereo_Matches.cpp
    # :669-675): 16 samples x 0.66 ~= 10.6 px. Measured on the GT
    # fixture: temporal final recall 0.91 -> 0.98, ATE 0.020 -> 0.004 m.
    desc_sample_spacing: float = 0.66
    desc_clip: float = 0.2
    desc_scale: float = 512.0

    # --- Diagnostics ---
    # Prepend 3 extra rows to the stereo metrics array (raw gather-window
    # occupancy, row_mask count, epi<100px count) for bisecting cascade
    # collapses (scripts/bisect_flat.py). Changes the metrics row count,
    # so the stage tables no longer align with STAGE_NAMES - debug only.
    debug_preepi_metrics: bool = False

    def __post_init__(self):
        # a perf-bisect knob that silently accepts garbage defeats its
        # purpose: anything != "flat" would quietly select "dense"
        if self.gate_layout not in ("flat", "dense", "flat4", "flat5"):
            raise ValueError(
                f"gate_layout must be 'flat', 'dense', 'flat4' or 'flat5', "
                f"got {self.gate_layout!r}")
        if self.temporal_gather_mode not in ("prediction", "reference"):
            raise ValueError(
                f"temporal_gather_mode must be 'prediction' or 'reference', "
                f"got {self.temporal_gather_mode!r}")
        if self.temporal_gate_layout not in ("dense", "flat"):
            raise ValueError(
                f"temporal_gate_layout must be 'dense' or 'flat', "
                f"got {self.temporal_gate_layout!r}")


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """One camera's intrinsics (reference YAML `left_camera`/`right_camera`,
    parsed at src/Dataset.cpp:77-97)."""

    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    distortion: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )

    @property
    def K_inv(self) -> np.ndarray:
        return np.linalg.inv(self.K)


def _skew(t: np.ndarray) -> np.ndarray:
    """Skew-symmetric matrix (reference src/utility.cpp:33-43)."""
    return np.array(
        [[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]], [-t[1], t[0], 0.0]],
        dtype=np.float64,
    )


@dataclasses.dataclass(frozen=True)
class StereoRig:
    """Stereo extrinsics + derived fundamental matrices.

    The reference computes F on the fly from R21/T21
    (src/Dataset.cpp:106-112):  F21 = K_r^-T [T21]_x R21 K_l^-1.
    """

    left: CameraConfig
    right: CameraConfig
    R21: Tuple[Tuple[float, ...], ...]   # left -> right rotation
    T21: Tuple[float, ...]               # left -> right translation
    rot_frame2body: Optional[Tuple[Tuple[float, ...], ...]] = None
    transl_frame2body: Optional[Tuple[float, ...]] = None

    @property
    def R21_np(self) -> np.ndarray:
        return np.asarray(self.R21, dtype=np.float64)

    @property
    def T21_np(self) -> np.ndarray:
        return np.asarray(self.T21, dtype=np.float64)

    @property
    def R12_np(self) -> np.ndarray:
        return self.R21_np.T

    @property
    def T12_np(self) -> np.ndarray:
        return -self.R21_np.T @ self.T21_np

    @property
    def F21(self) -> np.ndarray:
        """Fundamental matrix mapping left points to right epipolar lines."""
        Kl, Kr = self.left.K, self.right.K
        return np.linalg.inv(Kr).T @ (_skew(self.T21_np) @ self.R21_np) @ np.linalg.inv(Kl)

    @property
    def F12(self) -> np.ndarray:
        """Fundamental matrix mapping right points to left epipolar lines."""
        Kl, Kr = self.left.K, self.right.K
        return np.linalg.inv(Kl).T @ (_skew(self.T12_np) @ self.R12_np) @ np.linalg.inv(Kr)


def rig_from_yaml_dict(cfg: dict) -> StereoRig:
    """Build a StereoRig from the reference's YAML schema
    (keys as in config/kitti.yaml:1-29, parsed at src/Dataset.cpp:54-148)."""

    def cam(node) -> CameraConfig:
        res = node["resolution"]
        intr = node["intrinsics"]
        dist = tuple(float(d) for d in node.get("distortion_coefficients", [0, 0, 0, 0]))
        return CameraConfig(
            width=int(res[0]), height=int(res[1]),
            fx=float(intr[0]), fy=float(intr[1]), cx=float(intr[2]), cy=float(intr[3]),
            distortion=dist,
        )

    stereo = cfg["stereo"]
    r2b = cfg.get("frame_to_body")
    rot_f2b = None
    tr_f2b = None
    if r2b is not None:
        # Reference maps the row-major 9-vector then transposes
        # (src/Dataset.cpp:141) because Eigen::Map is column-major; net
        # effect: the YAML 9-vector is read row-major as-is.
        flat = np.asarray(r2b["rotation"], dtype=np.float64).reshape(3, 3)
        rot_f2b = tuple(tuple(row) for row in flat)
        tr_f2b = tuple(float(x) for x in r2b["translation"])

    return StereoRig(
        left=cam(cfg["left_camera"]),
        right=cam(cfg["right_camera"]),
        R21=tuple(tuple(float(x) for x in row) for row in stereo["R21"]),
        T21=tuple(float(x) for x in stereo["T21"]),
        rot_frame2body=rot_f2b,
        transl_frame2body=tr_f2b,
    )
