"""Stereo edge matching: the filter cascade as masked tensor passes.

Port of `edge_based_visual_odometry_tpu/models/stereo_matcher.py` with the
dense gate layout, in both modes: production (no GT) and GT-supervised
(veridical sets from a GT disparity map and an optional non-occlusion
mask). The state is one fixed-shape (N_left, MAX_CAND) candidate tensor
with a monotone mask:

  stage 1  epipolar distance      stage 7  best/nearly-best descriptor
  stage 2  max disparity          stage 8  epipolar shift
  stage 3  orientation            stage 9  1-DoF photometric GN (kernel K2)
  stage 4  descriptor gate (K6)   stage 10 clustering (K4)
  stage 5  NCC (K6)               stage 11 post-cluster NCC (K7, K6)
  stage 6  best/nearly-best NCC   stage 12 best-only pick, empty-row purge

Stage metrics rows are aligned with STAGE_NAMES: without GT, [rows with
>= 1 candidate, total candidates, 0, 0]; with GT, [recall, precision,
precision over rows with candidates, ambiguity].
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from edge_based_visual_odometry_tpu_torch import geometry as geom
from edge_based_visual_odometry_tpu_torch.config import VOConfig
from edge_based_visual_odometry_tpu_torch.models.types import (
    EdgeList, FrameData, RigArrays, StereoMates)
from edge_based_visual_odometry_tpu_torch.ops import clustering as CL
from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.ops import descriptors as DESC
from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
from edge_based_visual_odometry_tpu_torch.ops import grid as GRID
from edge_based_visual_odometry_tpu_torch.ops import patches as P
from edge_based_visual_odometry_tpu_torch.utils.timing import span

STAGE_NAMES = (
    "Epipolar Proximity", "Location Proximity", "Orientation", "SIFT", "NCC",
    "BNB-NCC", "BNB-SIFT", "Photometric Refinement", "Edge Clustering",
    "NCC-Post", "Best", "Final",
)

class StereoState(NamedTuple):
    """Cascade state: left edge rows x candidate slots."""

    row_mask: torch.Tensor       # (N,)
    lx: torch.Tensor
    ly: torch.Tensor
    ltheta: torch.Tensor
    epi_line: torch.Tensor       # (N, 3)
    gt_x: torch.Tensor           # (N,) GT right location (-1 without GT)
    gt_y: torch.Tensor
    gamma_gt_l: torch.Tensor     # (N, 3) GT 3D point, left / right camera
    gamma_gt_r: torch.Tensor
    cand_idx: torch.Tensor       # (N, C) right TOED index
    cx: torch.Tensor
    cy: torch.Tensor
    ctheta: torch.Tensor
    cmask: torch.Tensor
    ncc: torch.Tensor
    desc_dist: torch.Tensor


def _gt_rows(mask, row_mask, d_gt, dist_to_gt: float):
    """[recall, precision, precision over rows with candidates, ambiguity]
    of an (N, S) candidate mask whose distances to the GT location are
    d_gt."""
    tp = mask & (d_gt <= dist_to_gt)
    n_tp = tp.sum(1)
    n_c = mask.sum(1)
    has_c = row_mask & (n_c > 0)
    rows = torch.clamp(row_mask.sum(), min=1)
    rows_w = torch.clamp(has_c.sum(), min=1)
    zero = torch.zeros((), device=mask.device)
    prec = torch.where(n_c > 0, n_tp / torch.clamp(n_c, min=1), zero)
    return torch.stack([
        (row_mask & (n_tp > 0)).sum() / rows,
        torch.where(row_mask, prec, zero).sum() / rows,
        torch.where(has_c, prec, zero).sum() / rows_w,
        torch.where(has_c, n_c, torch.zeros_like(n_c)).sum() / rows_w,
    ]).to(torch.float32)


def _metrics(state: StereoState, dist_to_gt: float):
    """Per-stage recall / precision / ambiguity against the GT locations."""
    d = torch.sqrt((state.cx - state.gt_x[:, None]) ** 2
                   + (state.cy - state.gt_y[:, None]) ** 2)
    return _gt_rows(state.cmask, state.row_mask, d, dist_to_gt)


def _bnb_keep(scores, mask, ratio_thresh: float, higher_better: bool):
    """Best/nearly-best streak filter: sort candidates best first (stable),
    keep rank 0 and every following rank whose ratio to the best passes,
    stopping at the first failure; rows with < 2 candidates untouched."""
    big = torch.full_like(scores, 3.4e38)
    key = torch.where(mask, -scores if higher_better else scores, big)
    order = torch.sort(key, dim=-1, stable=True).indices
    s_sorted = torch.gather(scores, -1, order)
    m_sorted = torch.gather(mask, -1, order)
    best = s_sorted[..., 0:1]
    ratio = s_sorted / best if higher_better else best / s_sorted
    ok = (ratio >= ratio_thresh) & m_sorted & (best != 0.0)
    ok[..., 0] = m_sorted[..., 0]
    keep_sorted = torch.cumprod(ok.to(torch.int32), dim=-1).to(torch.bool)
    n_cand = mask.sum(-1, keepdim=True)
    keep_sorted = torch.where(n_cand < 2, m_sorted, keep_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return mask & keep


# slots a row `csrc/bnb_keep.cu` takes (one warp a row, two slots a lane)
BNB_MAX_SLOTS = 64


def bnb_keep_cuda(scores, mask, ratio_thresh: float, higher_better: bool):
    """The hand-written kernel (csrc/bnb_keep.cu): `_bnb_keep`'s kept
    slots as the twin gives them on the card, bit for bit: the slots
    ordered by (key, slot), the key in the order torch.sort gives floats
    there (-0.0 as +0.0, NaNs by their bits), the ratio an IEEE division
    compared in float32. scores (N, C) float32 and mask (N, C) bool,
    contiguous CUDA tensors; C at most `BNB_MAX_SLOTS`. One launch (none
    where the mask is empty)."""
    if not mask.is_cuda:
        raise ValueError(f"bnb_keep_cuda: needs a CUDA tensor, got one on "
                         f"{mask.device}")
    if mask.dim() != 2:
        raise ValueError(f"mask (N, C) expected, got {tuple(mask.shape)}")
    N, C = mask.shape
    dev = mask.device
    CB.require(scores, "scores", torch.float32, (N, C), dev)
    CB.require(mask, "mask", torch.bool, (N, C), dev)
    if C > BNB_MAX_SLOTS:
        raise ValueError(f"{C} slots a row: the kernel takes at most "
                         f"{BNB_MAX_SLOTS}")
    out = torch.empty_like(mask)
    if N == 0 or C == 0:
        return out
    lib = CB.lib()
    with torch.cuda.device(dev):
        err = lib.bnb_keep_launch(scores.data_ptr(), mask.data_ptr(), N, C,
                                  float(ratio_thresh), int(higher_better),
                                  out.data_ptr(), CB.stream_ptr(dev))
    CB.check(err, "bnb_keep")
    CB.LAUNCHES["bnb_keep"] += 1
    return out


def bnb_keep(scores, mask, ratio_thresh: float, higher_better: bool):
    """`_bnb_keep`'s streak filter: the CUDA kernel for CUDA tensors, the
    plain twin for CPU tensors."""
    if mask.is_cuda:
        return bnb_keep_cuda(scores, mask, ratio_thresh, higher_better)
    if mask.device.type != "cpu":
        raise ValueError(f"bnb_keep: unsupported device {mask.device}")
    return _bnb_keep(scores, mask, ratio_thresh, higher_better)


def _epipolar_shift(state: StereoState, cfg: VOConfig):
    """Shift candidates onto the epipolar line (normal foot, tangent
    intersection, or orientation-perturbed tangent intersection)."""
    line = state.epi_line[:, None, :]
    xy = torch.stack([state.cx, state.cy], -1)
    foot, nd = geom.normal_foot_on_line(line, xy)
    inter1, disp1 = geom.tangential_intersection_with_line(line, xy,
                                                           state.ctheta)
    a, b = line[..., 0], line[..., 1]
    dp_th = -a * torch.sin(state.ctheta) + b * torch.cos(state.ctheta)
    pert = cfg.orient_perturbation
    dtheta = torch.where(dp_th > 0, torch.full_like(dp_th, pert),
                         torch.where(dp_th < 0, torch.full_like(dp_th, -pert),
                                     torch.zeros_like(dp_th)))
    theta2 = state.ctheta + dtheta
    inter2, disp2 = geom.tangential_intersection_with_line(line, xy, theta2)
    case_a = nd < cfg.location_perturbation
    case_b = ~case_a & (disp1 < cfg.epip_tangency_displ_thresh)
    case_c = ~case_a & ~case_b & (disp2 < cfg.epip_tangency_displ_thresh)
    new_xy = torch.where(case_a[..., None], foot,
                         torch.where(case_b[..., None], inter1,
                                     torch.where(case_c[..., None], inter2,
                                                 xy)))
    return state._replace(cx=new_xy[..., 0], cy=new_xy[..., 1],
                          ctheta=torch.where(case_c, theta2, state.ctheta))


def _flatten_active(cmask, max_pairs: int):
    """Active (row, slot) pairs of an (N, C) mask in row-major order,
    compacted to (max_pairs,) lists (rows, slots, fmask); slots past the
    active count are (0, 0, False)."""
    N, C = cmask.shape
    flat = cmask.reshape(-1)
    pos = torch.cumsum(flat.to(torch.int64), 0) - 1
    lin = torch.arange(N * C, device=cmask.device)
    tgt = torch.where(flat & (pos < max_pairs), pos,
                      torch.full_like(pos, max_pairs))     # dump slot
    slot_of = torch.zeros(max_pairs + 1, dtype=torch.int64,
                          device=cmask.device).scatter_(0, tgt, lin)[:max_pairs]
    n_active = torch.clamp(pos[-1] + 1, max=max_pairs)
    fmask = torch.arange(max_pairs, device=cmask.device) < n_active
    slot_of = torch.where(fmask, slot_of, torch.zeros_like(slot_of))
    return slot_of // C, slot_of % C, fmask


def _scatter_back(template, rows, slots, fmask, values):
    """Write flat values back into a copy of an (N, C) tensor."""
    N, C = template.shape
    lin = torch.where(fmask, rows * C + slots,
                      torch.full_like(rows, N * C))        # dump slot
    out = torch.cat([template.reshape(-1),
                     template.new_zeros(1)]).scatter_(0, lin, values)
    return out[:N * C].reshape(N, C)


def derive_gather_band(rig, cfg: VOConfig) -> float:
    """Vertical half-height (px) of the stage-1 gather window from the rig's
    epipolar geometry (host-side numpy).

    The window is centred on the foot of the perpendicular from the left
    edge p to its epipolar line (`match_stereo`), not on p. A valid
    candidate q lies within eps of the line and within D of p, so on the
    line's chord through that disk: |q_y - foot_y| <= sqrt(D^2 - d^2) |t_y|
    + eps, with d the chord's nearest distance to p and t the line's unit
    direction; the bound is maximised over a grid of image points. The JAX
    package centres the window on p, and so adds delta |n_y| (delta the
    distance of p from its line): on a rig whose cameras differ, as
    EuRoC's (cy 248.4 against 255.2 px), that is ~14 px, and the window's
    2 bands become 6 that share the same `gather_slots`, so that a dense
    band drops its candidates beyond the first 26 by x, the true mate
    among them. Rectified rigs keep the reference's 4 px either way."""
    F = np.asarray(rig.F21, np.float64)
    W, H = rig.left.width, rig.left.height
    D = float(cfg.max_disparity)
    eps = float(cfg.epipolar_line_dist_thresh)
    gx, gy = np.meshgrid(np.linspace(0.0, W - 1.0, 32),
                         np.linspace(0.0, H - 1.0, 32))
    pts = np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)], -1)
    lines = pts @ F.T
    a, b, c = lines[:, 0], lines[:, 1], lines[:, 2]
    norm = np.hypot(a, b)
    ok = norm > 1e-12
    a, b, c, norm = a[ok], b[ok], c[ok], norm[ok]
    ty = np.abs(a) / norm
    delta = np.minimum(np.abs(a * pts[ok, 0] + b * pts[ok, 1] + c) / norm, D)
    d_near = np.maximum(delta - eps, 0.0)
    dy = np.sqrt(np.maximum(D * D - d_near * d_near, 0.0)) * ty
    ry = (float(dy.max()) if dy.size else 0.0) + eps + 1.0
    return float(max(4.0, min(ry, H / 2.0)))


def _count_row(mask):
    """[rows with >= 1 candidate, total candidates, 0, 0]."""
    z = torch.zeros((), device=mask.device)
    return torch.stack([mask.any(1).sum().to(torch.float32),
                        mask.sum().to(torch.float32), z, z])


def match_stereo(left_edges: EdgeList, right_edges: EdgeList,
                 frame: FrameData, rig: RigArrays, cfg: VOConfig,
                 disparity_map: Optional[torch.Tensor] = None,
                 occlusion_map: Optional[torch.Tensor] = None,
                 gather_ry: float = 4.0, record_distributions: bool = False):
    """Run the full stereo cascade.

    `disparity_map` (H, W): GT left disparity; switches on the supervision
    path (veridical sets, recall/precision rows, `gamma_gt` and `is_tp` of
    the mates). `occlusion_map`: optional non-occlusion mask (255 = visible
    in both views); edges whose GT location is occluded leave the veridical
    sets.

    Returns (StereoMates, StereoState, metrics (n_stages, 4)), and with
    `record_distributions` a 4th element: a dict of raw filter-score and
    ambiguity distributions, '<filter>' -> (values (N, C), is_gt (N, C),
    mask (N, C)) taken before the gate, '<stage>_ambiguity' -> (counts
    (N,), row_mask (N,)), '<stage>_state' -> StereoState snapshots and
    'right_edges_xyt', which `utils/debug_io` writes out."""
    has_gt = disparity_map is not None
    N = cfg.max_edges
    C = cfg.max_candidates
    H, W = frame.left.shape
    dev = frame.left.device

    with span("stereo.gather"):
        lx, ly, lt = left_edges.x, left_edges.y, left_edges.theta
        row_mask = left_edges.valid
        epi = geom.epipolar_lines(rig.F21, torch.stack([lx, ly], -1))

        # ---- GT supervision: GT right location and 3D point per left
        # edge ----
        if has_gt:
            disp, disp_ok = P.bilinear_sample_nan(disparity_map, lx, ly)
            deg = geom.rad2deg(lt)
            excl = cfg.gt_orient_exclusion_deg
            orient_excl = ((torch.abs(deg) < excl)
                           | (torch.abs(deg - 180.0) < excl)
                           | (torch.abs(deg + 180.0) < excl))
            gt_ok = (disp_ok & torch.isfinite(disp) & (disp >= 0)
                     & ~orient_excl)
            if occlusion_map is not None:
                # bilinear >= 254 == all 4 neighbour pixels are 255 (visible)
                occ, occ_in = P.bilinear_sample_nan(occlusion_map, lx, ly)
                gt_ok = gt_ok & occ_in & (occ >= 254.0)
            minus1 = torch.full_like(lx, -1.0)
            gt_x = torch.where(gt_ok, lx - disp, minus1)
            gt_y = torch.where(gt_ok, ly, minus1)
            ray1 = geom.pixel_to_ray(rig.K_left_inv,
                                     torch.stack([lx, ly], -1))
            ray2 = geom.pixel_to_ray(rig.K_left_inv,
                                     torch.stack([gt_x, gt_y], -1))
            gamma_l = geom.backproject_two_rays(rig.R21, rig.T21, ray1, ray2)
            gamma_r = torch.einsum("ij,nj->ni", rig.R21, gamma_l) + rig.T21
            row_mask = row_mask & gt_ok
        else:
            gt_x = torch.full((N,), -1.0, device=dev)
            gt_y = torch.full((N,), -1.0, device=dev)
            gamma_l = torch.full((N, 3), -1.0, device=dev)
            gamma_r = torch.full((N, 3), -1.0, device=dev)

        r_attrs = torch.stack([right_edges.x, right_edges.y,
                               right_edges.theta], -1)
        rgrid = GRID.build_sorted_grid(right_edges.x, right_edges.y,
                                       right_edges.valid, W, H, band_h=8,
                                       attrs=r_attrs)

        # ---- veridical sets: right edges near the GT location that also
        # pass the epipolar and orientation tolerances; rows without one
        # leave; every right edge in reach is read ----
        if has_gt:
            def veridical(v_attrs, vmask):
                v_x, v_y, v_t = v_attrs[0], v_attrs[1], v_attrs[2]
                v_epi = geom.point_line_distance(epi[:, None, :],
                                                 torch.stack([v_x, v_y], -1))
                v_d = torch.sqrt((v_x - gt_x[:, None]) ** 2
                                 + (v_y - gt_y[:, None]) ** 2)
                # raw (unwrapped) orientation difference
                v_dth = torch.abs(geom.rad2deg(v_t)
                                  - geom.rad2deg(lt)[:, None])
                return (vmask & (v_epi < cfg.epipolar_line_dist_thresh)
                        & (v_d < cfg.gt_pair_dist_tol)
                        & (v_dth < cfg.gt_pair_orient_tol))

            row_mask = row_mask & GRID.any_in_box(
                right_edges.x, right_edges.y, right_edges.valid, r_attrs, W, H,
                gt_x, gt_y, cfg.gt_pair_dist_tol, veridical)

        # ---- stages 1-3 on the raw gather window, then compact to C;
        # the window is centred in y on the foot of the perpendicular from
        # the left edge to its epipolar line (`derive_gather_band`) ----
        a, b, c = epi.unbind(-1)
        qy = ly - b * (a * lx + b * ly + c) / (a * a + b * b)
        qy = torch.where(torch.isfinite(qy), qy, ly)
        n_band_window = int(-(-2.0 * gather_ry // 8)) + 1
        gidx, g_attrs, gmask = GRID.query_sorted_grid_attrs(
            rgrid, lx, qy, rx=cfg.max_disparity + 1.5, ry=gather_ry,
            slots_per_band=max(8, cfg.gather_slots // n_band_window),
            n_band_window=n_band_window)
        g_x, g_y, g_t = g_attrs[0], g_attrs[1], g_attrs[2]
        metrics = []
        if has_gt:
            g_dgt = torch.sqrt((g_x - gt_x[:, None]) ** 2
                               + (g_y - gt_y[:, None]) ** 2)

        def record_raw(mask):
            metrics.append(_gt_rows(mask, row_mask, g_dgt,
                                    cfg.dist_to_gt_thresh)
                           if has_gt else _count_row(mask))

        g_epi = geom.point_line_distance(epi[:, None, :],
                                         torch.stack([g_x, g_y], -1))
        if cfg.debug_preepi_metrics:
            record_raw(gmask)          # raw gather-window occupancy (debug)
            record_raw(row_mask[:, None])
            record_raw(gmask & (g_epi < 100.0) & row_mask[:, None])
        gmask = (gmask & (g_epi < cfg.epipolar_line_dist_thresh)
                 & row_mask[:, None])
        record_raw(gmask)
        g_d = torch.sqrt((g_x - lx[:, None]) ** 2 + (g_y - ly[:, None]) ** 2)
        gmask = gmask & (g_d <= cfg.max_disparity)
        record_raw(gmask)
        g_dth = geom.orientation_diff_deg(lt[:, None], g_t)
        gmask = gmask & geom.orientation_gate(g_dth,
                                              cfg.orientation_thresh_deg)
        record_raw(gmask)

        cand_idx, c_attrs, cmask = GRID.compact_candidates_attrs(
            gidx, g_attrs, gmask, C, priority=g_epi)
        # the scores a slot holds until a gate computes it
        fill_ncc, fill_dist = 0.0, 2.0 * cfg.sift_threshold
        state = StereoState(
            row_mask=row_mask, lx=lx, ly=ly, ltheta=lt, epi_line=epi,
            gt_x=gt_x, gt_y=gt_y, gamma_gt_l=gamma_l, gamma_gt_r=gamma_r,
            cand_idx=cand_idx, cx=c_attrs[0], cy=c_attrs[1], ctheta=c_attrs[2],
            cmask=cmask,
            ncc=torch.full((N, C), fill_ncc, device=dev),
            desc_dist=torch.full((N, C), fill_dist, device=dev))

    def record(st):
        metrics.append(_metrics(st, cfg.dist_to_gt_thresh) if has_gt
                       else _count_row(st.cmask))

    dists = {}

    def snap_filter(name, st, values):
        """Filter scores before their gate, with the veridical flags."""
        if not record_distributions:
            return
        if has_gt:
            d = torch.sqrt((st.cx - st.gt_x[:, None]) ** 2
                           + (st.cy - st.gt_y[:, None]) ** 2)
            is_gt = st.cmask & (d <= cfg.dist_to_gt_thresh)
        else:
            is_gt = torch.zeros_like(st.cmask)
        dists[name] = (values, is_gt, st.cmask)

    def snap_ambiguity(stage, st):
        """Per-edge candidate counts."""
        if record_distributions:
            dists[f"{stage}_ambiguity"] = (st.cmask.sum(1), st.row_mask)

    def snap_state(stage, st):
        """Cascade-state snapshot for the per-cluster evaluation writers."""
        if record_distributions:
            dists[f"{stage}_state"] = st

    if record_distributions:
        dists["right_edges_xyt"] = (right_edges.x, right_edges.y,
                                    right_edges.theta)

    desc_kw = dict(shift_mag=cfg.sift_shift_mag,
                   n_samples=cfg.desc_patch_samples,
                   n_spatial=cfg.desc_spatial_bins,
                   n_orient=cfg.desc_orient_bins,
                   spacing=cfg.desc_sample_spacing, clip=cfg.desc_clip,
                   scale=cfg.desc_scale)
    with span("stereo.descriptors"):
        l_desc = DESC.edge_descriptors(frame.left_gx, frame.left_gy, lx, ly,
                                       lt, **desc_kw)
        r_desc = DESC.edge_descriptors(frame.right_gx, frame.right_gy,
                                       right_edges.x, right_edges.y,
                                       right_edges.theta, **desc_kw)

    # ---- patches for NCC, flat [plus | minus] (K7) ----
    with span("stereo.patches"):
        psize, pshift = cfg.patch_size, cfg.orthogonal_shift_mag
        l_patches, l_patch_ok = P.edge_patches_flat(frame.left, lx, ly, lt,
                                                    psize, pshift)
        r_patches, r_patch_ok = P.edge_patches_flat(
            frame.right, right_edges.x, right_edges.y, right_edges.theta,
            psize, pshift)

    # ---- stages 4-5: descriptor gate on the live slots, NCC on its
    # survivors (K6); the other slots keep their fill ----
    with span("stereo.gates"):
        ddist, sim = P.dense_gates_stereo(
            l_desc, r_desc, state.cand_idx, state.cmask, l_patches, l_patch_ok,
            r_patches, r_patch_ok, cfg.sift_threshold, psize,
            fill_dist=fill_dist, fill_ncc=fill_ncc)
        snap_filter("sift_distance", state, ddist)
        state = state._replace(
            cmask=state.cmask & (ddist < cfg.sift_threshold), desc_dist=ddist)
        record(state)
        snap_ambiguity("sift", state)
        snap_filter("ncc", state, sim)
        state = state._replace(cmask=state.cmask & (sim > cfg.ncc_thresh),
                               ncc=sim)
        record(state)

    # ---- stages 6/7: best-nearly-best on NCC, then descriptor ----
    with span("stereo.bnb"):
        state = state._replace(cmask=bnb_keep(
            state.ncc, state.cmask, cfg.bnb_ncc, higher_better=True))
        record(state)
        state = state._replace(cmask=bnb_keep(
            state.desc_dist, state.cmask, cfg.bnb_sift, higher_better=False))
        record(state)

    # ---- stage 8: epipolar shift ----
    with span("stereo.shift"):
        state = _epipolar_shift(state, cfg)
        snap_state("shift", state)

    # ---- stage 9: photometric GN along the epipolar line (kernel K2) ----
    with span("stereo.refine"):
        rows, slots, fmask = _flatten_active(state.cmask,
                                             cfg.max_refine_pairs)
        epi_dir = torch.stack([-state.epi_line[:, 1], state.epi_line[:, 0]],
                              -1)
        epi_dir = epi_dir / torch.linalg.norm(epi_dir, dim=-1, keepdim=True)
        row_pack = torch.stack([state.lx, state.ly, state.ltheta,
                                epi_dir[:, 0], epi_dir[:, 1]], -1)[rows]
        cand_pack = torch.stack([state.cx, state.cy],
                                -1).reshape(N * C, 2)[rows * C + slots]
        gn_args = (frame.left, frame.right, frame.right_gx, frame.right_gy,
                   row_pack[:, 0].contiguous(), row_pack[:, 1].contiguous(),
                   row_pack[:, 2].contiguous(), cand_pack[:, 0].contiguous(),
                   cand_pack[:, 1].contiguous(), row_pack[:, 3:5].contiguous())
        gn_kw = dict(patch_size=cfg.patch_size, max_iter=cfg.gn_max_iter,
                     tol=cfg.gn_tol, huber_delta=cfg.huber_delta,
                     tile=cfg.gn_tile, chunk=cfg.gn_chunk, active=fmask,
                     phase1_iters=cfg.gn_phase1_iters,
                     phase2_budget=cfg.gn_phase2_budget)
        res = GN.refine_along_epipolar_batch(*gn_args, **gn_kw)
        # the shift applies unconditionally (the cascade keeps refined
        # validity for statistics only)
        state = state._replace(
            cx=_scatter_back(state.cx, rows, slots, fmask,
                             cand_pack[:, 0] + res.delta * row_pack[:, 3]),
            cy=_scatter_back(state.cy, rows, slots, fmask,
                             cand_pack[:, 1] + res.delta * row_pack[:, 4]),
            ncc=_scatter_back(state.ncc, rows, slots, fmask, res.score),
            desc_dist=_scatter_back(state.desc_dist, rows, slots, fmask,
                                    res.confidence))
        record(state)
        snap_ambiguity("photometric_refinement", state)
        snap_state("photo_refine", state)

    # ---- stage 10: clustering (no orientation gate on the stereo path) ----
    with span("stereo.cluster"):
        cl = CL.cluster_edges(state.cx, state.cy, state.ctheta, state.cmask,
                              dist_thresh=cfg.cluster_dist_thresh,
                              orient_thresh_deg=cfg.cluster_orient_thresh,
                              by_orientation=False,
                              gauss_sigma=cfg.cluster_orient_gauss_sigma,
                              max_cluster_size=cfg.max_cluster_size)
        state = state._replace(
            cx=torch.where(cl.mask, cl.x, state.cx),
            cy=torch.where(cl.mask, cl.y, state.cy),
            ctheta=torch.where(cl.mask, cl.theta, state.ctheta),
            cmask=cl.mask)
        record(state)
        snap_ambiguity("edge_clustering", state)
        snap_state("cluster", state)

    # ---- stage 11: post-cluster NCC at the new centres (K7, K6) ----
    with span("stereo.recheck"):
        rows, slots, fmask = _flatten_active(state.cmask,
                                             cfg.max_refine_pairs)
        lin = rows * C + slots
        fx, fy, ft = (t.reshape(-1)[lin]
                      for t in (state.cx, state.cy, state.ctheta))
        # K7 samples the live entries only (a prefix of the list); K6 reads
        # none of the others
        f_patches, f_patch_ok = P.edge_patches_flat(frame.right, fx, fy, ft,
                                                    psize, pshift, live=fmask)
        just_pass = cfg.ncc_thresh + 1e-6
        sim_f = P.dense_gates_flat(l_patches, l_patch_ok, rows, f_patches,
                                   f_patch_ok, fmask, psize, fill=just_pass)
        # active pairs beyond the flat budget stay alive, just passing
        sim_full = _scatter_back(torch.full_like(state.ncc, just_pass),
                                 rows, slots, fmask, sim_f)
        state = state._replace(
            cmask=state.cmask & (sim_full > cfg.ncc_thresh), ncc=sim_full)
        record(state)

    # ---- stage 12: best-only pick, then the empty-row purge ----
    with span("stereo.pick"):
        best_slot = torch.argmax(torch.where(
            state.cmask, state.ncc,
            torch.full_like(state.ncc, -float("inf"))), 1)
        only_best = (torch.arange(C, device=dev)[None, :]
                     == best_slot[:, None])
        state = state._replace(cmask=state.cmask & only_best)
        record(state)
        state = state._replace(row_mask=state.row_mask & state.cmask.any(1))
        record(state)

    with span("stereo.finalize"):
        mates = _finalize(state, frame, rig, cfg, l_patches, l_patch_ok,
                          l_desc, best_slot, desc_kw)
    if record_distributions:
        return mates, state, torch.stack(metrics), dists
    return mates, state, torch.stack(metrics)


def _finalize(state: StereoState, frame: FrameData, rig: RigArrays,
              cfg: VOConfig, l_patches, l_patch_ok, l_desc, best_slot,
              desc_kw):
    """Compact alive rows (row order) to max_mates finalized mates with
    right patches/descriptors at the final positions and the two-ray 3D
    point."""
    N = cfg.max_edges
    M = cfg.max_mates
    dev = state.lx.device
    alive = state.row_mask
    pos = torch.cumsum(alive.to(torch.int64), 0) - 1
    tgt = torch.where(alive & (pos < M), pos, torch.full_like(pos, M))
    row_of = torch.zeros(M + 1, dtype=torch.int64, device=dev).scatter_(
        0, tgt, torch.arange(N, device=dev))[:M]
    count = torch.clamp(pos[-1] + 1, max=M).to(torch.int32)
    valid = torch.arange(M, device=dev) < count
    row_of = torch.where(valid, row_of, torch.zeros_like(row_of))

    bs = best_slot[row_of]
    rx = state.cx[row_of, bs]
    ry = state.cy[row_of, bs]
    rt = state.ctheta[row_of, bs]
    lx = state.lx[row_of]
    ly = state.ly[row_of]
    lt = state.ltheta[row_of]

    r_patches, r_patch_ok = P.edge_patches_flat(
        frame.right, rx, ry, rt, cfg.patch_size, cfg.orthogonal_shift_mag)
    r_desc = DESC.edge_descriptors(frame.right_gx, frame.right_gy, rx, ry, rt,
                                   **desc_kw)
    ray1 = geom.pixel_to_ray(rig.K_left_inv, torch.stack([lx, ly], -1))
    ray2 = geom.pixel_to_ray(rig.K_right_inv, torch.stack([rx, ry], -1))
    gamma = geom.backproject_two_rays(rig.R21, rig.T21, ray1, ray2)

    gt_x = state.gt_x[row_of]
    gt_y = state.gt_y[row_of]
    d_gt = torch.sqrt((rx - gt_x) ** 2 + (ry - gt_y) ** 2)
    is_tp = valid & (gt_x >= 0) & (d_gt <= cfg.dist_to_gt_thresh)

    v1 = valid[:, None]
    zero = torch.zeros((), device=dev)
    z = lambda a: torch.where(valid, a, zero)
    minus1 = torch.full((M,), -1.0, device=dev)
    return StereoMates(
        left_x=z(lx), left_y=z(ly), left_theta=z(lt),
        right_x=z(rx), right_y=z(ry), right_theta=z(rt),
        left_patches=l_patches[row_of] * v1,
        right_patches=r_patches * v1,
        left_patch_ok=l_patch_ok[row_of] & v1,
        right_patch_ok=r_patch_ok & v1,
        left_desc=l_desc[row_of] * v1,
        right_desc=r_desc * v1,
        gamma=gamma * v1,
        gamma_gt=state.gamma_gt_l[row_of] * v1,
        gt_x=torch.where(valid, gt_x, minus1),
        gt_y=torch.where(valid, gt_y, minus1),
        is_tp=is_tp, valid=valid, count=count)
