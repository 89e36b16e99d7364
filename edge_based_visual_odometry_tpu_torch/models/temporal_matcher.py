"""Temporal quad matching: keyframe stereo mates <-> current-frame mates.

Port of `edge_based_visual_odometry_tpu/models/temporal_matcher.py` with the
dense gate layout, in both gather modes ("prediction": window centred at
the predicted projection; "reference": radius around the KF locations)
and in the evaluation mode `use_gt` (GT relative pose, GT 3D points, only
rows that form a veridical quad, recall/precision rows). The state is a
fixed-shape (M_kf, MAX_QUAD_CAND) tensor keyed by CF mate index.

Cascade: grid gathering + box membership both sides, orientation both
sides, NCC both sides, descriptor both sides (both gates: kernel K6),
best/nearly-best on the left NCC then the left descriptor, 2-DoF
photometric GN both sides (K3), clustering of the left centres with
right-side averaging (K4).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from edge_based_visual_odometry_tpu_torch import geometry as geom
from edge_based_visual_odometry_tpu_torch.config import VOConfig
from edge_based_visual_odometry_tpu_torch.models.stereo_matcher import (
    _count_row, _flatten_active, _scatter_back, bnb_keep)
from edge_based_visual_odometry_tpu_torch.models.types import (
    FrameData, RigArrays, StereoMates)
from edge_based_visual_odometry_tpu_torch.ops import clustering as CL
from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
from edge_based_visual_odometry_tpu_torch.ops import grid as GRID
from edge_based_visual_odometry_tpu_torch.ops import patches as P
from edge_based_visual_odometry_tpu_torch.utils.timing import span

TEMPORAL_STAGE_NAMES = (
    "Location Proximity", "Orientation", "NCC", "SIFT",
    "BNB-NCC", "BNB-SIFT", "Photometric Refinement", "Edge Clustering",
)


class TemporalQuads(NamedTuple):
    """Fixed-shape quad candidate state; rows align with KF mate slots."""

    row_mask: torch.Tensor       # (M,)
    proj_left: torch.Tensor      # (M, 2) predicted projections into the CF
    proj_right: torch.Tensor
    proj_theta_l: torch.Tensor   # (M,)
    proj_theta_r: torch.Tensor
    has_veridical: torch.Tensor  # (M,) bool
    cf_idx: torch.Tensor         # (M, Cq)
    lcx: torch.Tensor
    lcy: torch.Tensor
    lct: torch.Tensor
    rcx: torch.Tensor
    rcy: torch.Tensor
    rct: torch.Tensor
    cmask: torch.Tensor
    ncc_l: torch.Tensor          # left-side NCC score (BNB key)
    desc_l: torch.Tensor         # left-side descriptor distance


def _quad_metrics(q, kf_is_tp, dist_thresh: float):
    """[recall, precision, precision, ambiguity] of the quad candidates
    against the projections of the KF point, over rows whose KF mate is a
    true positive. `q` needs row_mask, proj_left/right, l/r centres, cmask."""
    rows = q.row_mask & kf_is_tp
    dl = torch.sqrt((q.lcx - q.proj_left[:, 0:1]) ** 2
                    + (q.lcy - q.proj_left[:, 1:2]) ** 2)
    dr = torch.sqrt((q.rcx - q.proj_right[:, 0:1]) ** 2
                    + (q.rcy - q.proj_right[:, 1:2]) ** 2)
    tp = q.cmask & (dl < dist_thresh) & (dr < dist_thresh)
    n_tp = tp.sum(1)
    n_c = q.cmask.sum(1)
    has_c = rows & (n_c > 0)
    n_rows = torch.clamp(rows.sum(), min=1)
    n_rows_c = torch.clamp(has_c.sum(), min=1)
    zero = torch.zeros((), device=dl.device)
    recall = (rows & (n_tp > 0)).sum() / n_rows
    precision = torch.where(has_c, n_tp / torch.clamp(n_c, min=1),
                            zero).sum() / n_rows_c
    ambiguity = torch.where(has_c, n_c,
                            torch.zeros_like(n_c)).sum() / n_rows_c - 1.0
    return torch.stack([recall, precision, precision,
                        ambiguity]).to(torch.float32)


def _project_kf_points(kf: StereoMates, rel: geom.Pose, rig: RigArrays,
                       use_gt_gamma: bool = False):
    """Project KF 3D points (the GT-disparity points with `use_gt_gamma`)
    and transported tangents into the CF."""
    g_cf_l = rel.transform(kf.gamma_gt if use_gt_gamma else kf.gamma)
    pl = geom.project(rig.K_left, g_cf_l)
    g_cf_r = torch.einsum("ij,nj->ni", rig.R21, g_cf_l) + rig.T21
    pr = geom.project(rig.K_right, g_cf_r)
    g1 = geom.pixel_to_ray(rig.K_left_inv,
                           torch.stack([kf.left_x, kf.left_y], -1))
    g2 = geom.pixel_to_ray(rig.K_right_inv,
                           torch.stack([kf.right_x, kf.right_y], -1))
    t1 = geom.theta_to_ray_tangent(rig.K_left_inv, kf.left_theta)
    t2 = geom.theta_to_ray_tangent(rig.K_right_inv, kf.right_theta)
    T2_l = rel.rotate(geom.reconstruct_3d_tangent(rig.R21, g1, g2, t1, t2))
    T2_r = torch.einsum("ij,nj->ni", rig.R21, T2_l)
    tl = geom.project_3d_tangent_to_2d(T2_l, geom.pixel_to_ray(rig.K_left_inv, pl))
    tr = geom.project_3d_tangent_to_2d(T2_r, geom.pixel_to_ray(rig.K_right_inv, pr))
    return (pl, pr, torch.atan2(tl[..., 1], tl[..., 0]),
            torch.atan2(tr[..., 1], tr[..., 0]))


def match_temporal(kf: StereoMates, cf: StereoMates, kf_frame: FrameData,
                   cf_frame: FrameData, rel_pose: geom.Pose, rig: RigArrays,
                   cfg: VOConfig, use_gt: bool = False):
    """Run the quad cascade. rel_pose: KF->CF pose (GT with `use_gt`,
    predicted in production). Returns (TemporalQuads, metrics) with metrics
    rows aligned to TEMPORAL_STAGE_NAMES: [rows with >= 1 candidate, total
    candidates, 0, 0], or with `use_gt` [recall, precision, precision,
    ambiguity]."""
    M = cfg.max_mates
    Cq = cfg.max_quad_candidates
    H, W = cf_frame.left.shape
    dev = kf.left_x.device
    margin = 10.0

    with span("temporal.gather"):
        pl, pr, th_l, th_r = _project_kf_points(kf, rel_pose, rig,
                                                use_gt_gamma=use_gt)
        in_img = ((pl[:, 0] > margin) & (pl[:, 1] > margin)
                  & (pl[:, 0] < W - margin) & (pl[:, 1] < H - margin)
                  & (pr[:, 0] > margin) & (pr[:, 1] > margin)
                  & (pr[:, 0] < W - margin) & (pr[:, 1] < H - margin))

        band_h = 8
        cf_attrs = torch.stack([cf.left_x, cf.left_y, cf.left_theta,
                                cf.right_x, cf.right_y, cf.right_theta], -1)
        lgrid = GRID.build_sorted_grid(cf.left_x, cf.left_y, cf.valid, W, H,
                                       band_h=band_h, attrs=cf_attrs)

        # ---- veridical quads: < 2 px both sides + transported
        # orientation, over every frame mate in reach ----
        r_v = cfg.dist_to_gt_thresh_quads
        v_th = cfg.veridical_orient_thresh_deg

        def veridical(v_at, vmask):
            v_dl = torch.sqrt((v_at[0] - pl[:, 0:1]) ** 2
                              + (v_at[1] - pl[:, 1:2]) ** 2)
            v_dr = torch.sqrt((v_at[3] - pr[:, 0:1]) ** 2
                              + (v_at[4] - pr[:, 1:2]) ** 2)
            v_ol = geom.orientation_diff_deg(th_l[:, None], v_at[2])
            v_or = geom.orientation_diff_deg(th_r[:, None], v_at[5])
            # masked slots are valid entries by the grid query's guarantee
            return (vmask & (v_dl < r_v) & (v_dr < r_v)
                    & geom.orientation_gate(v_ol, v_th)
                    & geom.orientation_gate(v_or, v_th))

        if use_gt:
            has_verid = GRID.any_in_box(cf.left_x, cf.left_y, cf.valid,
                                        cf_attrs, W, H, pl[:, 0], pl[:, 1],
                                        r_v, veridical)
        else:
            # production reads no veridical flag: its window stays the
            # first 8 slots a band of the (r_v + 1)-box, as its graph was
            vwin = int(-(-2 * (r_v + 1.0) // band_h)) + 1
            _, v_at, vmask = GRID.query_sorted_grid_attrs(
                lgrid, pl[:, 0], pl[:, 1], rx=r_v + 1.0, ry=r_v + 1.0,
                slots_per_band=8, n_band_window=vwin)
            has_verid = veridical(v_at, vmask).any(1)
        row_mask = kf.valid & in_img
        if use_gt:
            # only KF rows that formed a veridical quad take part
            row_mask = row_mask & has_verid

        # ---- candidate gathering with left AND right box membership; the
        # evaluation mode always gathers around the KF locations ----
        if use_gt or cfg.temporal_gather_mode == "reference":
            r_g, n_slots = cfg.temporal_grid_radius, cfg.quad_gather_slots
            gl_x, gl_y = kf.left_x, kf.left_y
            gr_x, gr_y = kf.right_x, kf.right_y
        else:
            r_g = cfg.temporal_grid_radius_prod
            n_slots = cfg.quad_gather_slots_prod
            gl_x, gl_y = pl[:, 0], pl[:, 1]
            gr_x, gr_y = pr[:, 0], pr[:, 1]
        gwin = int(-(-2 * r_g // band_h)) + 1
        gidx, g_at, gmask = GRID.query_sorted_grid_attrs(
            lgrid, gl_x, gl_y, rx=r_g, ry=r_g,
            slots_per_band=-(-n_slots // gwin), n_band_window=gwin)
        gmask = (gmask & row_mask[:, None]
                 & (torch.abs(g_at[3] - gr_x[:, None]) <= r_g)
                 & (torch.abs(g_at[4] - gr_y[:, None]) <= r_g))
        metrics = []

        def record_raw(mask):
            if not use_gt:
                metrics.append(_count_row(mask))
                return
            tmp = TemporalQuads(
                row_mask=row_mask, proj_left=pl, proj_right=pr,
                proj_theta_l=th_l, proj_theta_r=th_r, has_veridical=has_verid,
                cf_idx=gidx, lcx=g_at[0], lcy=g_at[1], lct=g_at[2],
                rcx=g_at[3], rcy=g_at[4], rct=g_at[5], cmask=mask,
                ncc_l=None, desc_l=None)
            metrics.append(_quad_metrics(tmp, kf.is_tp,
                                         cfg.dist_to_gt_thresh_quads))

        record_raw(gmask)

        g_ol = geom.orientation_diff_deg(kf.left_theta[:, None], g_at[2])
        g_or = geom.orientation_diff_deg(kf.right_theta[:, None], g_at[5])
        g_th = cfg.temporal_orient_thresh_deg
        gmask = (gmask & geom.orientation_gate(g_ol, g_th)
                 & geom.orientation_gate(g_or, g_th))
        record_raw(gmask)

        # compaction priority: distance to the predicted projection, both sides
        d_l = torch.hypot(g_at[0] - pl[:, None, 0], g_at[1] - pl[:, None, 1])
        d_r = torch.hypot(g_at[3] - pr[:, None, 0], g_at[4] - pr[:, None, 1])
        cf_idx, c_at, cmask = GRID.compact_candidates_attrs(
            gidx, g_at, gmask, Cq, priority=d_l + d_r)
        # the scores a slot holds until a gate computes it (failing both gates)
        fill_ncc, fill_dist = -1.0, 900.0
        q = TemporalQuads(
            row_mask=row_mask, proj_left=pl, proj_right=pr, proj_theta_l=th_l,
            proj_theta_r=th_r, has_veridical=has_verid, cf_idx=cf_idx,
            lcx=c_at[0], lcy=c_at[1], lct=c_at[2],
            rcx=c_at[3], rcy=c_at[4], rct=c_at[5], cmask=cmask,
            ncc_l=torch.full((M, Cq), fill_ncc, device=dev),
            desc_l=torch.full((M, Cq), fill_dist, device=dev))

    def record(qq):
        metrics.append(_quad_metrics(qq, kf.is_tp, cfg.dist_to_gt_thresh_quads)
                       if use_gt else _count_row(qq.cmask))

    # ---- NCC + descriptor gates, both sides, on the live slots (K6) ----
    # CF patches are rounded to bf16, as the reference ships them
    with span("temporal.gates"):
        cf_patches = torch.cat([cf.left_patches, cf.right_patches],
                               -1).to(torch.bfloat16)
        cf_ok = torch.cat([cf.left_patch_ok, cf.right_patch_ok], -1)
        cf_desc = torch.cat([cf.left_desc, cf.right_desc], -1)
        sim_l, sim_r, dl, dr = P.dense_gates_temporal(
            kf.left_patches, kf.left_patch_ok, kf.right_patches,
            kf.right_patch_ok, kf.left_desc, kf.right_desc, cf_patches, cf_ok,
            cf_desc, q.cf_idx, q.cmask, cfg.patch_size, fill_ncc=fill_ncc,
            fill_dist=fill_dist)
        q = q._replace(cmask=q.cmask & (sim_l > cfg.temporal_ncc_thresh)
                       & (sim_r > cfg.temporal_ncc_thresh), ncc_l=sim_l)
        record(q)
        q = q._replace(cmask=q.cmask & (dl < cfg.temporal_sift_thresh)
                       & (dr < cfg.temporal_sift_thresh), desc_l=dl)
        record(q)

    # ---- BNB on left-side scores ----
    with span("temporal.bnb"):
        q = q._replace(cmask=bnb_keep(
            q.ncc_l, q.cmask, cfg.temporal_bnb_ratio, higher_better=True))
        record(q)
        q = q._replace(cmask=bnb_keep(
            q.desc_l, q.cmask, cfg.temporal_bnb_ratio, higher_better=False))
        record(q)

    # ---- 2-DoF photometric refinement, both sides ----
    with span("temporal.refine"):
        rows, slots, fmask = _flatten_active(q.cmask, cfg.max_refine_pairs)
        kf_pack = torch.stack([kf.left_x, kf.left_y, kf.left_theta,
                               kf.right_x, kf.right_y, kf.right_theta],
                              -1)[rows]
        c_pack = torch.stack([q.lcx, q.lcy, q.lct, q.rcx, q.rcy, q.rct],
                             -1).reshape(M * Cq, 6)[rows * Cq + slots]

        maps4 = GN.interleave_pair_maps(
            (cf_frame.left, cf_frame.left_gx, cf_frame.left_gy),
            (cf_frame.right, cf_frame.right_gx, cf_frame.right_gy))
        res_l, res_r = GN.refine_2dof_pair_batch(
            kf_frame.left, kf_frame.right, maps4, kf_pack, c_pack, fmask,
            patch_size=cfg.patch_size, max_iter=cfg.gn_max_iter,
            tol=cfg.gn_tol,
            huber_delta=cfg.temporal_huber_delta, tile=cfg.gn_tile,
            chunk=cfg.gn_chunk, phase1_iters=cfg.gn_phase1_iters,
            phase2_budget=cfg.gn_phase2_budget)
        # refined location = kf - d, applied per side where that side is
        # valid
        new_lx = torch.where(res_l.valid, kf_pack[:, 0] - res_l.delta[:, 0],
                             c_pack[:, 0])
        new_ly = torch.where(res_l.valid, kf_pack[:, 1] - res_l.delta[:, 1],
                             c_pack[:, 1])
        new_rx = torch.where(res_r.valid, kf_pack[:, 3] - res_r.delta[:, 0],
                             c_pack[:, 3])
        new_ry = torch.where(res_r.valid, kf_pack[:, 4] - res_r.delta[:, 1],
                             c_pack[:, 4])
        q = q._replace(lcx=_scatter_back(q.lcx, rows, slots, fmask, new_lx),
                       lcy=_scatter_back(q.lcy, rows, slots, fmask, new_ly),
                       rcx=_scatter_back(q.rcx, rows, slots, fmask, new_rx),
                       rcy=_scatter_back(q.rcy, rows, slots, fmask, new_ry))
        record(q)

    # ---- clustering of the left centres, right centres averaged ----
    with span("temporal.cluster"):
        cl = CL.cluster_edges(q.lcx, q.lcy, q.lct, q.cmask,
                              dist_thresh=cfg.cluster_dist_thresh,
                              orient_thresh_deg=cfg.cluster_orient_thresh,
                              by_orientation=True,
                              gauss_sigma=cfg.cluster_orient_gauss_sigma,
                              max_cluster_size=cfg.max_cluster_size)
        Mw = cl.members.to(torch.float32)
        cnt = torch.clamp(Mw.sum(-1), min=1.0)
        avg_rx = torch.einsum("mrj,mj->mr", Mw, q.rcx) / cnt
        avg_ry = torch.einsum("mrj,mj->mr", Mw, q.rcy) / cnt
        avg_rt = torch.einsum("mrj,mj->mr", Mw, q.rct) / cnt
        q = q._replace(lcx=torch.where(cl.mask, cl.x, q.lcx),
                       lcy=torch.where(cl.mask, cl.y, q.lcy),
                       lct=torch.where(cl.mask, cl.theta, q.lct),
                       rcx=torch.where(cl.mask, avg_rx, q.rcx),
                       rcy=torch.where(cl.mask, avg_ry, q.rcy),
                       rct=torch.where(cl.mask, avg_rt, q.rct),
                       cmask=cl.mask)
        record(q)
    return q, torch.stack(metrics)
