"""Relative pose from quad pairs: constraint-gated 2-point RANSAC.

Port of `edge_based_visual_odometry_tpu/models/motion_tracker.py` (no-GT
path): quads lifted to (Gamma, Gamma_bar, T, T_bar) in PROSAC order, all
hypotheses drawn at once, gated by the 4 rigid-invariance constraints,
solved by closed-form triad alignment, prescored on the top quads, scored
in full for the best `ransac_prescore_keep`, then polished by inlier GN.

Hypothesis draws come from a `torch.Generator` seeded with the frame's
seed; the reference's threefry draws cannot be reproduced, so
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

SCORE_CHUNK = 1024   # hypotheses per chunk of the (K, Q) scoring


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
               cfg: VOConfig) -> PoseQuads:
    """Lift every (KF mate, candidate) pair and order PROSAC style by
    (row candidate count, flat position), keeping the first
    max_pose_quads. The LEFT K inverse serves both cameras, as in the
    reference."""
    M, Cq = quads.cmask.shape
    Kinv = rig.K_left_inv
    g1l = geom.pixel_to_ray(Kinv, torch.stack([kf.left_x, kf.left_y], -1))
    g1r = geom.pixel_to_ray(Kinv, torch.stack([kf.right_x, kf.right_y], -1))
    Gamma = geom.backproject_two_rays(rig.R21, rig.T21, g1l, g1r)
    T = geom.reconstruct_3d_tangent(
        rig.R21, g1l, g1r, geom.theta_to_ray_tangent(Kinv, kf.left_theta),
        geom.theta_to_ray_tangent(Kinv, kf.right_theta))
    gbl = geom.pixel_to_ray(Kinv, torch.stack([quads.lcx, quads.lcy], -1))
    gbr = geom.pixel_to_ray(Kinv, torch.stack([quads.rcx, quads.rcy], -1))
    Gamma_bar = geom.backproject_two_rays(rig.R21, rig.T21, gbl, gbr)
    T_bar = geom.reconstruct_3d_tangent(
        rig.R21, gbl, gbr, geom.theta_to_ray_tangent(Kinv, quads.lct),
        geom.theta_to_ray_tangent(Kinv, quads.rct))

    mask = quads.cmask & quads.row_mask[:, None]
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
    return PoseQuads(
        gamma=flat(Gamma[:, None].expand(M, Cq, 3)),
        gamma_bar=flat(Gamma_bar), tangent=flat(T[:, None].expand(M, Cq, 3)),
        tangent_bar=flat(T_bar),
        cf_left=flat(torch.stack([quads.lcx, quads.lcy], -1)),
        valid=valid, is_veridical=torch.zeros_like(valid),
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
                       idx=None):
    """Top-rank pair draws: uniform over the top ransac_top_rank_percentage
    of the PROSAC order, idx2 != idx1. `idx` = (idx1, idx2) overrides the
    generator."""
    if idx is None:
        dev = pq.gamma.device
        top_n = torch.clamp(
            (cfg.ransac_top_rank_percentage * pq.n_valid).to(torch.int64),
            min=2)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        idx1 = torch.randint(0, 1 << 30, (K,), generator=gen, device=dev) % top_n
        idx2 = torch.randint(0, 1 << 30, (K,), generator=gen, device=dev) % top_n
        idx2 = torch.where(idx2 == idx1, (idx2 + 1) % top_n, idx2)
    else:
        idx1, idx2 = (torch.as_tensor(i, dtype=torch.int64,
                                      device=pq.gamma.device) for i in idx)
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


def _inlier_counts(KG, Kt, gamma, cf_left, valid, thresh):
    """Per-hypothesis inlier counts over quads (with cheirality)."""
    out = []
    for s in range(0, KG.shape[0], SCORE_CHUNK):
        uvw = (torch.einsum("kij,qj->kqi", KG[s:s + SCORE_CHUNK], gamma)
               + Kt[s:s + SCORE_CHUNK, None, :])
        uv = uvw[..., :2] / uvw[..., 2:3]
        err = torch.linalg.norm(uv - cf_left[None], dim=-1)
        inl = (err < thresh) & valid[None] & (uvw[..., 2] > 1e-6)
        out.append(inl.sum(1))
    return torch.cat(out)


def estimate_pose(pq: PoseQuads, rig: RigArrays, cfg: VOConfig,
                  seed: Optional[int] = None, idx=None) -> RansacResult:
    """Vectorized constraint-gated RANSAC; `idx` = (idx1, idx2) injects
    the hypothesis draws."""
    K = cfg.ransac_max_iterations
    seed = cfg.ransac_seed if seed is None else seed
    _, _, samples = _sample_quad_pairs(pq, cfg, seed, K, idx)
    c1, c2, c3, c4 = _constraint_gates(samples, cfg)
    gate = c1 & c2 & c3 & c4
    R, t = _pose_from_pair(*samples)
    KG = torch.einsum("ij,kjl->kil", rig.K_left, R)
    Kt = torch.einsum("ij,kj->ki", rig.K_left, t)
    thr = cfg.ransac_max_reproj_error
    minus1 = torch.full((), -1, dtype=torch.int64, device=R.device)

    Qs = cfg.ransac_prescore_quads
    if Qs and Qs < pq.gamma.shape[0]:
        pre = _inlier_counts(KG, Kt, pq.gamma[:Qs], pq.cf_left[:Qs],
                             pq.valid[:Qs], thr)
        counts_pre = torch.where(gate, pre, minus1)
        keep = min(cfg.ransac_prescore_keep, K)
        srt = torch.sort(counts_pre, descending=True, stable=True)
        top_pre, top_idx = srt.values[:keep], srt.indices[:keep]
        counts_f = _inlier_counts(KG[top_idx], Kt[top_idx], pq.gamma,
                                  pq.cf_left, pq.valid, thr)
        counts_f = torch.where(top_pre >= 0, counts_f, minus1)
        best_local = torch.argmax(counts_f)
        best = top_idx[best_local]
        best_raw = counts_f[best_local]
    else:
        counts = torch.where(gate, _inlier_counts(KG, Kt, pq.gamma,
                                                  pq.cf_left, pq.valid, thr),
                             minus1)
        best = torch.argmax(counts)
        best_raw = counts[best]
    best_count = torch.clamp(best_raw, min=0)
    n_q = torch.clamp(pq.n_valid, min=1)
    success = pq.n_valid >= 2
    found = success & (best_raw >= 0)
    I = torch.eye(3, dtype=R.dtype, device=R.device)
    R_best = torch.where(found, R[best], I)
    t_best = torch.where(found, t[best], torch.zeros_like(t[best]))

    if cfg.ransac_refine:
        fx, fy = rig.K_left[0, 0], rig.K_left[1, 1]
        cx, cy = rig.K_left[0, 2], rig.K_left[1, 2]
        Rr, tr = R_best, t_best
        for _ in range(4):
            Xc = torch.einsum("ij,qj->qi", Rr, pq.gamma) + tr
            z = torch.clamp(Xc[:, 2], min=1e-6)
            u = fx * Xc[:, 0] / z + cx
            v = fy * Xc[:, 1] / z + cy
            r = torch.stack([u, v], -1) - pq.cf_left
            e = torch.linalg.norm(r, dim=-1)
            w = ((e < thr) & pq.valid).to(torch.float32)
            iz = 1.0 / z
            iz2 = iz * iz
            zz = torch.zeros_like(z)
            Jp = torch.stack([
                torch.stack([fx * iz, zz, -fx * Xc[:, 0] * iz2], -1),
                torch.stack([zz, fy * iz, -fy * Xc[:, 1] * iz2], -1)], 1)
            J_om = -torch.einsum("qij,qjk->qik", Jp, geom.skew(Xc))
            J = torch.cat([J_om, Jp], -1)                    # (Q, 2, 6)
            Hm = (torch.einsum("q,qia,qib->ab", w, J, J)
                  + 1e-6 * torch.eye(6, device=J.device))
            b = -torch.einsum("q,qia,qi->a", w, J, r)
            dp = torch.linalg.solve(Hm, b)
            dR = geom.so3_exp(dp[:3])
            ok = w.sum() >= 3
            Rr, tr = (torch.where(ok, dR @ Rr, Rr),
                      torch.where(ok, dR @ tr + dp[3:], tr))
        p = torch.einsum("ij,qj->qi", Rr, pq.gamma) + tr
        uvw = torch.einsum("ij,qj->qi", rig.K_left, p)
        e = torch.linalg.norm(uvw[:, :2] / uvw[:, 2:3] - pq.cf_left, dim=-1)
        cnt_f = ((e < thr) & pq.valid & (uvw[:, 2] > 1e-6)).sum()
        finite = torch.isfinite(Rr).all() & torch.isfinite(tr).all()
        ok_refined = success & finite & (
            cnt_f >= (0.8 * best_count).to(cnt_f.dtype))
        R_best = torch.where(ok_refined, Rr, R_best)
        t_best = torch.where(ok_refined, tr, t_best)
        best_count = torch.where(ok_refined, cnt_f, best_count)

    return RansacResult(R=R_best, t=t_best, inlier_count=best_count,
                        inlier_ratio=best_count / n_q, n_quads=pq.n_valid,
                        success=success)
