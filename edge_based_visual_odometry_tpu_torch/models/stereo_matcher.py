"""Stereo edge matching: the filter cascade as masked tensor passes.

Port of `edge_based_visual_odometry_tpu/models/stereo_matcher.py`, the
production (no-GT) branch with the dense gate layout. The state is one
fixed-shape (N_left, MAX_CAND) candidate tensor with a monotone mask:

  stage 1  epipolar distance      stage 7  best/nearly-best descriptor
  stage 2  max disparity          stage 8  epipolar shift
  stage 3  orientation            stage 9  1-DoF photometric GN (kernel K2)
  stage 4  descriptor gate        stage 10 clustering
  stage 5  NCC                    stage 11 post-cluster NCC
  stage 6  best/nearly-best NCC   stage 12 best-only pick, empty-row purge

Stage metrics rows are [rows with >= 1 candidate, total candidates, 0, 0]
aligned with STAGE_NAMES.
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
from edge_based_visual_odometry_tpu_torch.ops import descriptors as DESC
from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
from edge_based_visual_odometry_tpu_torch.ops import grid as GRID
from edge_based_visual_odometry_tpu_torch.ops import patches as P

STAGE_NAMES = (
    "Epipolar Proximity", "Location Proximity", "Orientation", "SIFT", "NCC",
    "BNB-NCC", "BNB-SIFT", "Photometric Refinement", "Edge Clustering",
    "NCC-Post", "Best", "Final",
)

ROW_CHUNK = 8192   # rows per chunk of the dense gate stages (memory bound)


class StereoState(NamedTuple):
    """Cascade state: left edge rows x candidate slots."""

    row_mask: torch.Tensor       # (N,)
    lx: torch.Tensor
    ly: torch.Tensor
    ltheta: torch.Tensor
    epi_line: torch.Tensor       # (N, 3)
    cand_idx: torch.Tensor       # (N, C) right TOED index
    cx: torch.Tensor
    cy: torch.Tensor
    ctheta: torch.Tensor
    cmask: torch.Tensor
    ncc: torch.Tensor
    desc_dist: torch.Tensor


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
    epipolar geometry (host-side numpy; same bound as the reference)."""
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
    ny = np.abs(b) / norm
    ty = np.abs(a) / norm
    delta = np.minimum(np.abs(a * pts[ok, 0] + b * pts[ok, 1] + c) / norm, D)
    d_near = np.maximum(delta - eps, 0.0)
    dy = delta * ny + np.sqrt(np.maximum(D * D - d_near * d_near, 0.0)) * ty
    ry = (float(dy.max()) if dy.size else 0.0) + eps + 1.0
    return float(max(4.0, min(ry, H / 2.0)))


def _count_row(mask):
    """[rows with >= 1 candidate, total candidates, 0, 0]."""
    z = torch.zeros((), device=mask.device)
    return torch.stack([mask.any(1).sum().to(torch.float32),
                        mask.sum().to(torch.float32), z, z])


def _row_chunked(fn, n_rows: int, chunk: int = ROW_CHUNK):
    return torch.cat([fn(slice(s, s + chunk))
                      for s in range(0, max(n_rows, 1), chunk)])


def match_stereo(left_edges: EdgeList, right_edges: EdgeList,
                 frame: FrameData, rig: RigArrays, cfg: VOConfig,
                 gather_ry: float = 4.0, gn_capture: Optional[dict] = None):
    """Run the production stereo cascade.

    Returns (StereoMates, StereoState, metrics (n_stages, 4)).
    `gn_capture`: if a dict is given, the stage-9 GN input (the flat pair
    list handed to `refine_along_epipolar_batch`) is stored in it."""
    N = cfg.max_edges
    C = cfg.max_candidates
    H, W = frame.left.shape
    dev = frame.left.device

    lx, ly, lt = left_edges.x, left_edges.y, left_edges.theta
    row_mask = left_edges.valid
    epi = geom.epipolar_lines(rig.F21, torch.stack([lx, ly], -1))

    r_attrs = torch.stack([right_edges.x, right_edges.y, right_edges.theta], -1)
    rgrid = GRID.build_sorted_grid(right_edges.x, right_edges.y,
                                   right_edges.valid, W, H, band_h=8,
                                   attrs=r_attrs)

    # ---- stages 1-3 on the raw gather window, then compact to C ----
    n_band_window = int(-(-2.0 * gather_ry // 8)) + 1
    gidx, g_attrs, gmask = GRID.query_sorted_grid_attrs(
        rgrid, lx, ly, rx=cfg.max_disparity + 1.5, ry=gather_ry,
        slots_per_band=max(8, cfg.gather_slots // n_band_window),
        n_band_window=n_band_window)
    g_x, g_y, g_t = g_attrs[0], g_attrs[1], g_attrs[2]
    metrics = []

    g_epi = geom.point_line_distance(epi[:, None, :],
                                     torch.stack([g_x, g_y], -1))
    gmask = gmask & (g_epi < cfg.epipolar_line_dist_thresh) & row_mask[:, None]
    metrics.append(_count_row(gmask))
    g_d = torch.sqrt((g_x - lx[:, None]) ** 2 + (g_y - ly[:, None]) ** 2)
    gmask = gmask & (g_d <= cfg.max_disparity)
    metrics.append(_count_row(gmask))
    g_dth = geom.orientation_diff_deg(lt[:, None], g_t)
    gmask = gmask & geom.orientation_gate(g_dth, cfg.orientation_thresh_deg)
    metrics.append(_count_row(gmask))

    cand_idx, c_attrs, cmask = GRID.compact_candidates_attrs(
        gidx, g_attrs, gmask, C, priority=g_epi)
    state = StereoState(
        row_mask=row_mask, lx=lx, ly=ly, ltheta=lt, epi_line=epi,
        cand_idx=cand_idx, cx=c_attrs[0], cy=c_attrs[1], ctheta=c_attrs[2],
        cmask=cmask,
        ncc=torch.zeros((N, C), device=dev),
        desc_dist=torch.full((N, C), 2.0 * cfg.sift_threshold, device=dev))

    def record(st):
        metrics.append(_count_row(st.cmask))

    desc_kw = dict(shift_mag=cfg.sift_shift_mag,
                   n_samples=cfg.desc_patch_samples,
                   n_spatial=cfg.desc_spatial_bins,
                   n_orient=cfg.desc_orient_bins,
                   spacing=cfg.desc_sample_spacing, clip=cfg.desc_clip,
                   scale=cfg.desc_scale)
    l_desc = DESC.edge_descriptors(frame.left_gx, frame.left_gy, lx, ly, lt,
                                   **desc_kw)
    r_desc = DESC.edge_descriptors(frame.right_gx, frame.right_gy,
                                   right_edges.x, right_edges.y,
                                   right_edges.theta, **desc_kw)

    # ---- stage 4: descriptor gate (dense rows) ----
    ddist = _row_chunked(lambda s: DESC.min_cross_distance_dot(
        l_desc[s], r_desc[state.cand_idx[s]]), N)
    state = state._replace(cmask=state.cmask & (ddist < cfg.sift_threshold),
                           desc_dist=ddist)
    record(state)

    # ---- patches for NCC, flat [plus | minus] ----
    pp_n = cfg.patch_size * cfg.patch_size
    lp_p, lp_m, lok_p, lok_m = P.edge_patches(
        frame.left, lx, ly, lt, cfg.patch_size, cfg.orthogonal_shift_mag)
    l_patches = torch.cat([lp_p, lp_m], -1)
    l_patch_ok = torch.stack([lok_p, lok_m], 1)
    rp_p, rp_m, rok_p, rok_m = P.edge_patches(
        frame.right, right_edges.x, right_edges.y, right_edges.theta,
        cfg.patch_size, cfg.orthogonal_shift_mag)
    r_patches = torch.cat([rp_p, rp_m], -1)
    r_patch_ok = torch.stack([rok_p, rok_m], 1)

    # ---- stage 5: NCC (dense rows) ----
    def ncc_rows(s):
        idx = state.cand_idx[s]
        cp, cok = r_patches[idx], r_patch_ok[idx]
        lp, lok = l_patches[s][:, None], l_patch_ok[s][:, None]
        return P.ncc4(lp[..., :pp_n], lp[..., pp_n:], lok[..., 0], lok[..., 1],
                      cp[..., :pp_n], cp[..., pp_n:], cok[..., 0], cok[..., 1])

    sim = _row_chunked(ncc_rows, N)
    state = state._replace(cmask=state.cmask & (sim > cfg.ncc_thresh), ncc=sim)
    record(state)

    # ---- stages 6/7: best-nearly-best on NCC, then descriptor ----
    state = state._replace(cmask=_bnb_keep(state.ncc, state.cmask,
                                           cfg.bnb_ncc, higher_better=True))
    record(state)
    state = state._replace(cmask=_bnb_keep(state.desc_dist, state.cmask,
                                           cfg.bnb_sift, higher_better=False))
    record(state)

    # ---- stage 8: epipolar shift ----
    state = _epipolar_shift(state, cfg)

    # ---- stage 9: photometric GN along the epipolar line (kernel K2) ----
    rows, slots, fmask = _flatten_active(state.cmask, cfg.max_refine_pairs)
    epi_dir = torch.stack([-state.epi_line[:, 1], state.epi_line[:, 0]], -1)
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
    if gn_capture is not None:
        gn_capture.update(args=gn_args, kwargs=gn_kw)
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

    # ---- stage 10: clustering (no orientation gate on the stereo path) ----
    cl = CL.cluster_edges(state.cx, state.cy, state.ctheta, state.cmask,
                          dist_thresh=cfg.cluster_dist_thresh,
                          orient_thresh_deg=cfg.cluster_orient_thresh,
                          by_orientation=False,
                          gauss_sigma=cfg.cluster_orient_gauss_sigma,
                          max_cluster_size=cfg.max_cluster_size)
    state = state._replace(cx=torch.where(cl.mask, cl.x, state.cx),
                           cy=torch.where(cl.mask, cl.y, state.cy),
                           ctheta=torch.where(cl.mask, cl.theta, state.ctheta),
                           cmask=cl.mask)
    record(state)

    # ---- stage 11: post-cluster NCC at the new centres ----
    rows, slots, fmask = _flatten_active(state.cmask, cfg.max_refine_pairs)
    f_pack = torch.stack([state.cx, state.cy, state.ctheta],
                         -1).reshape(N * C, 3)[rows * C + slots]
    pp, pm, okp, okm = P.edge_patches(
        frame.right, f_pack[:, 0], f_pack[:, 1], f_pack[:, 2],
        cfg.patch_size, cfg.orthogonal_shift_mag)
    lp_r = l_patches[rows]
    lok_r = l_patch_ok[rows]
    sim_f = P.ncc4(lp_r[:, :pp_n], lp_r[:, pp_n:], lok_r[:, 0], lok_r[:, 1],
                   pp, pm, okp, okm)
    # active pairs beyond the flat budget stay alive, just passing
    sim_full = _scatter_back(torch.full_like(state.ncc, cfg.ncc_thresh + 1e-6),
                             rows, slots, fmask, sim_f)
    state = state._replace(cmask=state.cmask & (sim_full > cfg.ncc_thresh),
                           ncc=sim_full)
    record(state)

    # ---- stage 12: best-only pick, then the empty-row purge ----
    best_slot = torch.argmax(torch.where(state.cmask, state.ncc,
                                         torch.full_like(state.ncc,
                                                         -float("inf"))), 1)
    only_best = (torch.arange(C, device=dev)[None, :] == best_slot[:, None])
    state = state._replace(cmask=state.cmask & only_best)
    record(state)
    state = state._replace(row_mask=state.row_mask & state.cmask.any(1))
    record(state)

    mates = _finalize(state, frame, rig, cfg, l_patches, l_patch_ok, l_desc,
                      best_slot, desc_kw)
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

    pp, pm, okp, okm = P.edge_patches(frame.right, rx, ry, rt, cfg.patch_size,
                                      cfg.orthogonal_shift_mag)
    r_patches = torch.cat([pp, pm], -1)
    r_patch_ok = torch.stack([okp, okm], 1)
    r_desc = DESC.edge_descriptors(frame.right_gx, frame.right_gy, rx, ry, rt,
                                   **desc_kw)
    ray1 = geom.pixel_to_ray(rig.K_left_inv, torch.stack([lx, ly], -1))
    ray2 = geom.pixel_to_ray(rig.K_right_inv, torch.stack([rx, ry], -1))
    gamma = geom.backproject_two_rays(rig.R21, rig.T21, ray1, ray2)

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
        gamma_gt=torch.full((M, 3), -1.0, device=dev) * v1,
        gt_x=minus1, gt_y=minus1.clone(),
        is_tp=torch.zeros((M,), dtype=torch.bool, device=dev),
        valid=valid, count=count)
