"""Relative pose from quad pairs: constraint-gated 2-point RANSAC.

Port of `edge_based_visual_odometry_tpu/models/motion_tracker.py`: quads lifted to (Gamma, Gamma_bar, T, T_bar) in PROSAC order, all
hypotheses drawn at once, gated by the 4 rigid-invariance constraints,
solved by closed-form triad alignment, prescored on the top quads, scored
in full for the best `ransac_prescore_keep`, then polished by inlier GN.
The counts and the GN step's normal equations are the hand-written
kernels K8 and K9 on the card, their plain twins on the CPU
(`ops/pose.py`); the stages of `estimate_pose` are functions of their own
(`_hypotheses`, `_prescore`, `_rank`, `_full_count`, `_refine_step`,
`_final_count`), so that a run can time them apart.

Hypothesis draws come from a `torch.Generator` seeded with the frame's
seed (or from the generator a caller passes, seeded alike: a CUDA
graph's own); the reference's threefry draws cannot be reproduced, so
`estimate_pose` also takes the draws (idx1, idx2) directly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from edge_based_visual_odometry_tpu_torch import geometry as geom
from edge_based_visual_odometry_tpu_torch.config import VOConfig
from edge_based_visual_odometry_tpu_torch.models.temporal_matcher import (
    TemporalQuads)
from edge_based_visual_odometry_tpu_torch.models.types import (
    RigArrays, StereoMates)
from edge_based_visual_odometry_tpu_torch.ops import pose as POSE
from edge_based_visual_odometry_tpu_torch.utils.timing import span


class PoseQuads(NamedTuple):
    """Flat lifted quads in PROSAC order, valid first."""

    gamma: torch.Tensor        # (Q, 3) KF 3D point
    gamma_bar: torch.Tensor    # (Q, 3) CF 3D point
    tangent: torch.Tensor      # (Q, 3)
    tangent_bar: torch.Tensor  # (Q, 3)
    cf_left: torch.Tensor      # (Q, 2) CF left centre (scoring target)
    valid: torch.Tensor        # (Q,) bool
    is_veridical: torch.Tensor # (Q,) bool (False without GT)
    n_valid: torch.Tensor      # () int32


class RansacResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inlier_count: torch.Tensor
    inlier_ratio: torch.Tensor
    n_quads: torch.Tensor
    success: torch.Tensor     # bool: >= 2 quads available


def lift_quads(kf: StereoMates, quads: TemporalQuads, rig: RigArrays,
               cfg: VOConfig, use_gt: bool = False) -> PoseQuads:
    """Lift every (KF mate, candidate) pair and order PROSAC style by
    (row candidate count, flat position), keeping the first
    max_pose_quads. With `use_gt` only true-positive KF mates take part
    and `is_veridical` flags the quads within the GT distance on both
    sides.

    Each camera's points and tangents are lifted with its own K inverse:
    the left image's with `K_left_inv`, the right image's with
    `K_right_inv`. This departs on purpose from the reference and the JAX
    package, which lift both images with the left K. That is wrong on any
    rig whose cameras differ: on EuRoC's (cx 367.2 against 380.0 px, cy
    248.4 against 255.2) the right rays are off by 12.8 px in x and 6.9 px
    in y, as large as the disparities themselves, and RANSAC keeps a
    fraction of the quads. Where both cameras share one K the two lifts
    are the same computation."""
    M, Cq = quads.cmask.shape
    Kl, Kr = rig.K_left_inv, rig.K_right_inv
    g1l = geom.pixel_to_ray(Kl, torch.stack([kf.left_x, kf.left_y], -1))
    g1r = geom.pixel_to_ray(Kr, torch.stack([kf.right_x, kf.right_y], -1))
    Gamma = geom.backproject_two_rays(rig.R21, rig.T21, g1l, g1r)
    T = geom.reconstruct_3d_tangent(
        rig.R21, g1l, g1r, geom.theta_to_ray_tangent(Kl, kf.left_theta),
        geom.theta_to_ray_tangent(Kr, kf.right_theta))
    gbl = geom.pixel_to_ray(Kl, torch.stack([quads.lcx, quads.lcy], -1))
    gbr = geom.pixel_to_ray(Kr, torch.stack([quads.rcx, quads.rcy], -1))
    Gamma_bar = geom.backproject_two_rays(rig.R21, rig.T21, gbl, gbr)
    T_bar = geom.reconstruct_3d_tangent(
        rig.R21, gbl, gbr, geom.theta_to_ray_tangent(Kl, quads.lct),
        geom.theta_to_ray_tangent(Kr, quads.rct))

    row_ok = quads.row_mask & kf.is_tp if use_gt else quads.row_mask
    mask = quads.cmask & row_ok[:, None]
    n_cand_row = mask.sum(1)
    Q = min(cfg.max_pose_quads, M * Cq)
    # stable counting-sort order: (class, flat position), masked-out last
    cls = torch.where(mask, n_cand_row[:, None].expand(M, Cq),
                      torch.full_like(mask, Cq + 2, dtype=n_cand_row.dtype))
    order = torch.sort(cls.reshape(-1), stable=True).indices[:Q]
    n_sel = mask.sum().to(torch.int32)
    sel_ok = torch.arange(Q, device=mask.device) < n_sel
    order = torch.where(sel_ok, order, torch.zeros_like(order))

    def flat(a):
        return a.reshape(M * Cq, *a.shape[2:])[order]

    valid = flat(mask) & sel_ok
    if use_gt:
        dl = torch.sqrt((quads.lcx - quads.proj_left[:, 0:1]) ** 2
                        + (quads.lcy - quads.proj_left[:, 1:2]) ** 2)
        dr = torch.sqrt((quads.rcx - quads.proj_right[:, 0:1]) ** 2
                        + (quads.rcy - quads.proj_right[:, 1:2]) ** 2)
        is_veridical = flat(quads.cmask & (dl < cfg.dist_to_gt_thresh_quads)
                            & (dr < cfg.dist_to_gt_thresh_quads)) & valid
    else:
        is_veridical = torch.zeros_like(valid)
    return PoseQuads(
        gamma=flat(Gamma[:, None].expand(M, Cq, 3)),
        gamma_bar=flat(Gamma_bar), tangent=flat(T[:, None].expand(M, Cq, 3)),
        tangent_bar=flat(T_bar),
        cf_left=flat(torch.stack([quads.lcx, quads.lcy], -1)),
        valid=valid, is_veridical=is_veridical,
        n_valid=valid.sum().to(torch.int32))


def _pose_from_pair(g1, gb1, t1, tb1, g2, gb2, t2, tb2):
    """Closed-form triad alignment; all args (..., 3)."""
    def unit(v):
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)
    e1 = unit(g2 - g1)
    e1b = unit(gb2 - gb1)
    e2 = unit(t1 - (e1 * t1).sum(-1, keepdim=True) * e1)
    e2b = unit(tb1 - (e1b * tb1).sum(-1, keepdim=True) * e1b)
    B = torch.stack([e1, e2, torch.linalg.cross(e1, e2)], -1)
    Bb = torch.stack([e1b, e2b, torch.linalg.cross(e1b, e2b)], -1)
    R = Bb @ B.transpose(-1, -2)
    return R, gb1 - torch.einsum("...ij,...j->...i", R, g1)


def _sample_quad_pairs(pq: PoseQuads, cfg: VOConfig, seed: int, K: int,
                       idx=None, generator=None):
    """Top-rank pair draws: uniform over the top ransac_top_rank_percentage
    of the PROSAC order, idx2 != idx1. `idx` = (idx1, idx2) overrides the
    generator; `generator`, seeded by the caller, replaces a fresh one
    seeded with `seed`."""
    if idx is None:
        dev = pq.gamma.device
        top_n = torch.clamp(
            (cfg.ransac_top_rank_percentage * pq.n_valid).to(torch.int64),
            min=2)
        gen = (torch.Generator(device=dev).manual_seed(int(seed))
               if generator is None else generator)
        idx1 = torch.randint(0, 1 << 30, (K,), generator=gen, device=dev) % top_n
        idx2 = torch.randint(0, 1 << 30, (K,), generator=gen, device=dev) % top_n
        idx2 = torch.where(idx2 == idx1, (idx2 + 1) % top_n, idx2)
    else:
        idx1, idx2 = (torch.as_tensor(i).to(pq.gamma.device, torch.int64)
                      for i in idx)
    samples = (pq.gamma[idx1], pq.gamma_bar[idx1], pq.tangent[idx1],
               pq.tangent_bar[idx1], pq.gamma[idx2], pq.gamma_bar[idx2],
               pq.tangent[idx2], pq.tangent_bar[idx2])
    return idx1, idx2, samples


def _constraint_gates(samples, cfg: VOConfig):
    """The 4 rigid-motion invariance gates over sampled pairs."""
    g1, gb1, t1, tb1, g2, gb2, t2, tb2 = samples
    dG = g2 - g1
    dGb = gb2 - gb1
    lG = torch.linalg.norm(dG, dim=-1)
    lGb = torch.linalg.norm(dGb, dim=-1)
    c1 = torch.abs(lG - lGb) / lG < cfg.tau_c1
    c2 = torch.abs(torch.abs((dG * t1).sum(-1) / lG)
                   - torch.abs((dGb * tb1).sum(-1) / lGb)) < cfg.tau_c2
    c3 = torch.abs(torch.abs((dG * t2).sum(-1) / lG)
                   - torch.abs((dGb * tb2).sum(-1) / lGb)) < cfg.tau_c3
    c4 = torch.abs(torch.abs((t1 * t2).sum(-1))
                   - torch.abs((tb1 * tb2).sum(-1))) < cfg.tau_c4
    return c1, c2, c3, c4


CONSTRAINT_STAGE_NAMES = (
    "Baseline", "Normalized Length Constraint", "T1 Angle Similarity Constraint",
    "T2 Angle Similarity Constraint", "Tangent Angle Similarity Constraint",
)


def constraint_sweep_metrics(pq: PoseQuads, cfg: VOConfig,
                             seed: Optional[int] = None, idx=None):
    """Diagnostic recall / precision of the 4 RANSAC constraint gates over
    the quad pairs RANSAC would draw, against `pq.is_veridical` (evaluation
    mode). Returns (5, 3) rows [recall, precision, surviving veridical
    pairs] aligned with CONSTRAINT_STAGE_NAMES; `idx` = (idx1, idx2)
    injects the draws."""
    K = cfg.ransac_max_iterations
    idx1, idx2, samples = _sample_quad_pairs(
        pq, cfg, cfg.ransac_seed if seed is None else seed, K, idx)
    ver = pq.is_veridical[idx1] & pq.is_veridical[idx2]
    init_ver = ver.sum()
    surviving = torch.ones_like(ver)
    rows = []
    for g in (torch.ones_like(ver), *_constraint_gates(samples, cfg)):
        surviving = surviving & g
        n_ver = (surviving & ver).sum()
        rows.append(torch.stack([
            n_ver / torch.clamp(init_ver, min=1),
            n_ver / torch.clamp(surviving.sum(), min=1),
            n_ver.to(torch.float32)]))
    return torch.stack(rows)


def _pick(a, i):
    """a[i] for a 0-dim index tensor, read on the device: indexing with a
    0-dim tensor reads its value on the host and waits for the card."""
    return a.index_select(0, i.reshape(1))[0]


def _hypotheses(pq: PoseQuads, rig: RigArrays, cfg: VOConfig, seed: int,
                idx=None, generator=None):
    """The K drawn pairs' gate, closed-form poses and projections K R,
    K t."""
    _, _, samples = _sample_quad_pairs(pq, cfg, seed,
                                       cfg.ransac_max_iterations, idx,
                                       generator)
    c1, c2, c3, c4 = _constraint_gates(samples, cfg)
    R, t = _pose_from_pair(*samples)
    KG = torch.einsum("ij,kjl->kil", rig.K_left, R).contiguous()
    Kt = torch.einsum("ij,kj->ki", rig.K_left, t).contiguous()
    return c1 & c2 & c3 & c4, R, t, KG, Kt


def _prescore(KG, Kt, gate, pq: PoseQuads, Qs: int, thr: float):
    """Every hypothesis's count on the first Qs quads (K8 on the card);
    -1 where gated out."""
    return POSE.ransac_counts(KG, Kt, pq.gamma[:Qs], pq.cf_left[:Qs],
                              pq.valid[:Qs], thr, gate=gate)


def _rank(counts, keep: int):
    """The hypotheses of the `keep` best prescores, ties in draw order."""
    return torch.sort(counts, descending=True, stable=True).indices[:keep]


def _full_count(KG, Kt, gate, pq: PoseQuads, thr: float, index=None):
    """Counts on every quad of the hypotheses `index` (all without it; K8
    on the card); -1 where gated out."""
    return POSE.ransac_counts(KG, Kt, pq.gamma, pq.cf_left, pq.valid, thr,
                              gate=gate, index=index)


def _refine_step(Rr, tr, pq: PoseQuads, K_left, thr: float):
    """One inlier Gauss-Newton step of the pose: the normal equations (K9
    on the card), then the 6 x 6 solve and the update, which keep the pose
    where fewer than 3 quads weigh in. A singular H yields a non-finite
    step, as JAX's solve does; nothing here waits for the card."""
    s = POSE.pose_gn_normal_equations(Rr, tr, pq.gamma, pq.cf_left,
                                      pq.valid, K_left, thr)
    Hm = POSE.normal_matrix(s) + 1e-6 * torch.eye(6, device=s.device)
    dp = torch.linalg.solve_ex(Hm, s[21:27])[0]
    dR = geom.so3_exp(dp[:3])
    ok = s[27] >= 3
    return (torch.where(ok, dR @ Rr, Rr),
            torch.where(ok, dR @ tr + dp[3:], tr))


def _final_count(Rr, tr, pq: PoseQuads, K_left, thr: float):
    """The refined pose's inlier count, in JAX's K (R gamma + t) order."""
    p = torch.einsum("ij,qj->qi", Rr, pq.gamma) + tr
    uvw = torch.einsum("ij,qj->qi", K_left, p)
    e = torch.linalg.norm(uvw[:, :2] / uvw[:, 2:3] - pq.cf_left, dim=-1)
    return ((e < thr) & pq.valid & (uvw[:, 2] > 1e-6)).sum()


def estimate_pose(pq: PoseQuads, rig: RigArrays, cfg: VOConfig,
                  seed: Optional[int] = None, idx=None,
                  generator=None) -> RansacResult:
    """Vectorized constraint-gated RANSAC; `idx` = (idx1, idx2) injects
    the hypothesis draws, `generator` (seeded by the caller) draws them
    in place of a fresh generator seeded with `seed`. On the card the
    counts run in K8 and the refinement's normal equations in K9
    (`ops/pose.py`)."""
    K = cfg.ransac_max_iterations
    seed = cfg.ransac_seed if seed is None else seed
    with span("pose.hypotheses"):
        gate, R, t, KG, Kt = _hypotheses(pq, rig, cfg, seed, idx, generator)
    thr = cfg.ransac_max_reproj_error

    with span("pose.score"):
        Qs = cfg.ransac_prescore_quads
        if Qs and Qs < pq.gamma.shape[0]:
            top_idx = _rank(_prescore(KG, Kt, gate, pq, Qs, thr),
                            min(cfg.ransac_prescore_keep, K))
            # a kept hypothesis is gated out exactly where its prescore is
            # -1
            counts_f = _full_count(KG, Kt, gate, pq, thr, index=top_idx)
            best_local = torch.argmax(counts_f)
            best = _pick(top_idx, best_local)
            best_raw = _pick(counts_f, best_local)
        else:
            counts = _full_count(KG, Kt, gate, pq, thr)
            best = torch.argmax(counts)
            best_raw = _pick(counts, best)
        best_count = torch.clamp(best_raw, min=0)
        n_q = torch.clamp(pq.n_valid, min=1)
        success = pq.n_valid >= 2
        found = success & (best_raw >= 0)
        I = torch.eye(3, dtype=R.dtype, device=R.device)
        R_best = torch.where(found, _pick(R, best), I)
        t_best = torch.where(found, _pick(t, best), torch.zeros(
            3, dtype=t.dtype, device=t.device))

    if cfg.ransac_refine:
        with span("pose.refine"):
            Rr, tr = R_best, t_best
            for _ in range(4):
                Rr, tr = _refine_step(Rr, tr, pq, rig.K_left, thr)
        with span("pose.count"):
            cnt_f = _final_count(Rr, tr, pq, rig.K_left, thr)
            finite = torch.isfinite(Rr).all() & torch.isfinite(tr).all()
            ok_refined = success & finite & (
                cnt_f >= (0.8 * best_count).to(cnt_f.dtype))
            R_best = torch.where(ok_refined, Rr, R_best)
            t_best = torch.where(ok_refined, tr, t_best)
            best_count = torch.where(ok_refined, cnt_f, best_count)

    return RansacResult(R=R_best, t=t_best, inlier_count=best_count,
                        inlier_ratio=best_count / n_q, n_quads=pq.n_valid,
                        success=success)
