"""Sliding-window bundle adjustment with Schur-complement reduction.

Port of `edge_based_visual_odometry_tpu/models/ba.py`:

  - Fixed-shape problem: K poses, L landmarks, O observations with masks.
  - One damped Gauss-Newton iteration = dense batched einsums:
      * per-landmark 3x3 Hessian blocks H_ll + inversion (batched),
      * camera-landmark coupling W as a dense (L, K, 6, 3) tensor,
      * Schur complement S = H_pp - sum_l W H_ll^-1 W^T as one einsum,
      * reduced (6K, 6K) camera solve + landmark back-substitution.

The blocks are accumulated over observations with `index_add_` /
`index_put_(accumulate=True)`; on a CUDA device the order of those sums
is not fixed, so two runs may differ in the last bits. The iterations run
as a Python loop with no host synchronisation inside.

Split over devices (`reduce=`, made by `all_reduce_sum`): each rank holds
a block of the landmarks and the observations of those landmarks, so
H_ll, b_l, W, H_ll^-1 and the back-substitution stay local; the pose
blocks, the Schur term, the rhs correction and the two sums of the Huber
cost are all-reduced once per iteration, and every rank solves the same
reduced (6K, 6K) system, so the poses agree on every rank.

Pose updates use a first-order SE(3) retraction; the first pose is gauge-
fixed. Everything is float32.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from edge_based_visual_odometry_tpu_torch.geometry import skew
from edge_based_visual_odometry_tpu_torch.geometry import so3_exp as _so3_exp


class BAProblem(NamedTuple):
    R: torch.Tensor         # (K, 3, 3) world->cam
    t: torch.Tensor         # (K, 3)
    X: torch.Tensor         # (L, 3) landmarks (world)
    obs_kf: torch.Tensor    # (O,) integer pose index
    obs_lm: torch.Tensor    # (O,) integer landmark index
    obs_uv: torch.Tensor    # (O, 2) pixel measurements
    obs_w: torch.Tensor     # (O,) weights (0 = inactive)
    K_cam: torch.Tensor     # (3, 3) intrinsics
    # Optional landmark position prior (e.g. the stereo triangulation,
    # which constrains the depth that short low-parallax temporal tracks
    # leave nearly unobservable - without it the Schur system is close to
    # singular and f32 GN diverges). prior_w = 0 disables.
    X_prior: Optional[torch.Tensor] = None   # (L, 3)
    prior_w: Optional[torch.Tensor] = None   # () or (L,)
    # Optional per-observation edge normals (O, 2). Edge correspondences
    # only constrain the reprojection PERPENDICULAR to the edge (aperture
    # problem). With obs_n set, the residual is the scalar normal
    # component n . (proj - uv).
    obs_n: Optional[torch.Tensor] = None


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    cost_history: torch.Tensor   # (n_iters + 1,) weighted mean sq px error


def _residuals_and_jacobians(p: BAProblem):
    """Reprojection residuals (O, 2) + Jacobians wrt pose (O, 2, 6:
    [omega, upsilon]) and landmark (O, 2, 3); (O, 1, .) with obs_n."""
    kf = p.obs_kf.long()
    Rk = p.R[kf]
    tk = p.t[kf]
    Xl = p.X[p.obs_lm.long()]
    Xc = torch.einsum("oij,oj->oi", Rk, Xl) + tk
    fx = p.K_cam[0, 0]
    fy = p.K_cam[1, 1]
    cx = p.K_cam[0, 2]
    cy = p.K_cam[1, 2]
    x, y, z = Xc[:, 0], Xc[:, 1], torch.clamp(Xc[:, 2], min=1e-6)
    u = fx * x / z + cx
    v = fy * y / z + cy
    r = torch.stack([u, v], -1) - p.obs_uv

    iz = 1.0 / z
    iz2 = iz * iz
    zz = torch.zeros_like(z)
    # d(u,v)/dXc
    Jp = torch.stack([
        torch.stack([fx * iz, zz, -fx * x * iz2], -1),
        torch.stack([zz, fy * iz, -fy * y * iz2], -1),
    ], 1)                                              # (O, 2, 3)
    # pose: Xc = R X + t; d/d omega (left perturbation) = -[Xc]_x, d/d t = I
    J_omega = -torch.einsum("oij,ojk->oik", Jp, skew(Xc))   # (O, 2, 3)
    J_pose = torch.cat([J_omega, Jp], -1)                   # (O, 2, 6)
    J_lm = torch.einsum("oij,ojk->oik", Jp, Rk)             # (O, 2, 3)
    if p.obs_n is not None:
        # project onto the edge normal -> scalar residual per observation
        r = (r * p.obs_n).sum(-1, keepdim=True)             # (O, 1)
        J_pose = torch.einsum("oi,oia->oa", p.obs_n, J_pose)[:, None, :]
        J_lm = torch.einsum("oi,oia->oa", p.obs_n, J_lm)[:, None, :]
    return r, J_pose, J_lm


def _huber_terms(p: BAProblem, r, huber: float):
    """(weights, weighted squared residual sum, weight sum): the Huber
    cost is the second over the first clamped to >= 1."""
    rn = torch.linalg.norm(r, dim=-1)
    w_h = torch.where(rn <= huber, torch.ones_like(rn),
                      huber / torch.clamp(rn, min=1e-12))
    w = p.obs_w * w_h
    return w, (w * rn * rn).sum(), p.obs_w.sum()


def _cost(num, den):
    return num / torch.clamp(den, min=1.0)


Reduce = Callable[..., tuple]


def all_reduce_sum(group) -> Reduce:
    """`reduce` for a BA split over the ranks of `group`: sums its tensors
    over the ranks with one flat all_reduce (they share a dtype)."""
    def reduce(*ts):
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        out, i = [], 0
        for t in ts:
            out.append(flat[i:i + t.numel()].view_as(t))
            i += t.numel()
        return tuple(out)
    return reduce


def ba_iteration(p: BAProblem, damping: float, huber: float,
                 reduce: Optional[Reduce] = None):
    """One damped GN step with Schur complement on landmarks. `reduce`:
    sums the landmark-axis partial sums over the ranks that split the
    landmarks (see the module docstring); None on one device."""
    Kn = p.R.shape[0]
    L = p.X.shape[0]
    dev, dt = p.X.device, p.X.dtype
    kf = p.obs_kf.long()
    lm = p.obs_lm.long()
    r, J_pose, J_lm = _residuals_and_jacobians(p)
    w, c_num, c_den = _huber_terms(p, r, huber)

    # --- blocks via scatter-adds over observations ---
    JtJ_pp = torch.zeros((Kn, 6, 6), device=dev, dtype=dt).index_add_(
        0, kf, w[:, None, None] * torch.einsum("oia,oib->oab", J_pose, J_pose))
    b_p = torch.zeros((Kn, 6), device=dev, dtype=dt).index_add_(
        0, kf, -w[:, None] * torch.einsum("oia,oi->oa", J_pose, r))
    H_ll = torch.zeros((L, 3, 3), device=dev, dtype=dt).index_add_(
        0, lm, w[:, None, None] * torch.einsum("oia,oib->oab", J_lm, J_lm))
    b_l = torch.zeros((L, 3), device=dev, dtype=dt).index_add_(
        0, lm, -w[:, None] * torch.einsum("oia,oi->oa", J_lm, r))
    eye3 = torch.eye(3, device=dev, dtype=dt)
    eye6 = torch.eye(6, device=dev, dtype=dt)
    if p.X_prior is not None and p.prior_w is not None:
        pw = torch.as_tensor(p.prior_w, device=dev, dtype=dt).expand(L)
        H_ll = H_ll + pw[:, None, None] * eye3[None]
        b_l = b_l + pw[:, None] * (p.X_prior - p.X)

    # W: (L, K, 6, 3) camera-landmark coupling
    Wc = torch.zeros((L, Kn, 6, 3), device=dev, dtype=dt).index_put_(
        (lm, kf),
        w[:, None, None] * torch.einsum("oia,oib->oab", J_pose, J_lm),
        accumulate=True)

    lam = damping
    # singular blocks (damping 0, a landmark no one observes) give
    # non-finite values, as JAX's inv and solve do, instead of raising
    H_ll_inv = torch.linalg.inv_ex(H_ll + lam * eye3[None])[0]

    # --- Schur complement (both einsums reduce over the landmark axis) ---
    WHinv = torch.einsum("lkab,lbc->lkac", Wc, H_ll_inv)     # (L, K, 6, 3)
    S_cross = torch.einsum("lkac,lqbc->kaqb", WHinv, Wc)     # (K, 6, K, 6)
    rhs_corr = torch.einsum("lkac,lc->ka", WHinv, b_l)
    if reduce is not None:
        JtJ_pp, b_p, S_cross, rhs_corr, c_num, c_den = reduce(
            JtJ_pp, b_p, S_cross, rhs_corr, c_num, c_den)
    diag = torch.arange(Kn, device=dev)
    S = torch.zeros((Kn, 6, Kn, 6), device=dev, dtype=dt)
    S[diag, :, diag, :] += JtJ_pp + lam * eye6[None]
    S = S - S_cross
    rhs = b_p - rhs_corr

    # gauge fix: freeze pose 0 with a strong prior
    S[0, :, 0, :] += 1e8 * eye6

    dp = torch.linalg.solve_ex(S.reshape(Kn * 6, Kn * 6),
                               rhs.reshape(-1))[0].reshape(Kn, 6)
    dl = torch.einsum("lab,lb->la", H_ll_inv,
                      b_l - torch.einsum("lkab,ka->lb", Wc, dp))

    # retract
    dR = _so3_exp(dp[:, :3])
    R_new = torch.einsum("kij,kjl->kil", dR, p.R)
    t_new = torch.einsum("kij,kj->ki", dR, p.t) + dp[:, 3:]
    return p._replace(R=R_new, t=t_new, X=p.X + dl), _cost(c_num, c_den)


def run_ba(p: BAProblem, n_iters: int = 10, damping: float = 1e-4,
           huber: float = 2.0, reduce: Optional[Reduce] = None) -> BAResult:
    """Fixed-iteration windowed BA; no host synchronisation inside.
    `reduce` (see `ba_iteration`): X stays this rank's landmark block."""
    costs = []
    for _ in range(n_iters):
        p, cost = ba_iteration(p, damping, huber, reduce)
        costs.append(cost)
    # Huber-weight the final entry exactly like the per-iteration costs,
    # so cost_history is a comparable series end to end
    r, _, _ = _residuals_and_jacobians(p)
    _, num, den = _huber_terms(p, r, huber)
    if reduce is not None:
        num, den = reduce(num, den)
    costs.append(_cost(num, den))
    return BAResult(R=p.R, t=p.t, X=p.X, cost_history=torch.stack(costs))
