"""Seeded numpy inputs for K8 (RANSAC hypothesis scoring), K9 (the pose
Gauss-Newton step) and `estimate_pose`: the cases the port's CPU tests
hold the twins against float64 numpy and JAX with, and its `gpu` tests
hold the kernels against the twins with. No JAX here, and torch only
inside the two helpers at the end for the card (`pose_twins`,
`singular_on_card`).

`singular_quads(seed)` is the case that made the port's refinement solve
raise where JAX returns a pose: 64 quads of which only the first 2 are
valid, integer-valued gamma = gamma_bar (x, y in [-3, 3], z in [2, 8]),
`cf_left` their exact projection; at SINGULAR_SEEDS (with
`SINGULAR_CFG`) the 6 x 6 normal matrix of the first refinement step is
exactly singular in float32, summed in JAX's order and in K9's.
`scene_quads(seed, Q, n_valid)` is a static-rig motion: points in front of
the camera, a small rotation and translation, CF centres projected with
0.3 px noise, a share of outliers, the valid quads first (PROSAC order).
`hypotheses(seed, K_hyp)` makes K R and K t for poses near the
true one, some behind the camera, and a gate with some False.
"""

import contextlib

import numpy as np

from edge_based_visual_odometry_tpu_torch.io import synthetic as S

K_LEFT = np.asarray(S.default_rig(120, 160).left.K, np.float32)
SINGULAR_SEEDS = (6, 258, 449)
SINGULAR_CFG = dict(ransac_max_iterations=64, ransac_prescore_quads=0)
THRESH = 1.5                   # VOConfig().ransac_max_reproj_error


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _rot(w):
    th = np.linalg.norm(w)
    k = w / max(th, 1e-12)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def _project(K, X):
    uvw = X @ K.T
    return (uvw[:, :2] / uvw[:, 2:3]).astype(np.float32)


def singular_quads(seed, Q=64, n_valid=2):
    """PoseQuads fields (numpy) of the singular case."""
    rng = np.random.default_rng(seed)
    g = np.stack([rng.integers(-3, 4, Q), rng.integers(-3, 4, Q),
                  rng.integers(2, 9, Q)], 1).astype(np.float32)
    t = _unit(rng.normal(size=(Q, 3)))
    return dict(gamma=g, gamma_bar=g.copy(), tangent=t, tangent_bar=t.copy(),
                cf_left=_project(K_LEFT, g),
                valid=np.arange(Q) < n_valid,
                is_veridical=np.zeros(Q, bool), n_valid=np.int32(n_valid))


def scene_motion(seed):
    rng = np.random.default_rng(1000 + seed)
    R = _rot(rng.normal(0, 0.02, 3))
    t = np.array([rng.normal(0, 0.05), rng.normal(0, 0.02),
                  rng.uniform(0.1, 0.3)])
    return R, t


def scene_quads(seed, Q, n_valid, outliers=0.3, noise=0.3):
    """PoseQuads fields (numpy) of a static-rig motion (module doc)."""
    rng = np.random.default_rng(seed)
    R, t = scene_motion(seed)
    K = K_LEFT.astype(np.float64)
    g = np.stack([rng.uniform(-4, 4, Q), rng.uniform(-3, 3, Q),
                  rng.uniform(4, 20, Q)], 1)
    gb = g @ R.T + t
    T = _unit(rng.normal(size=(Q, 3)))
    Tb = _unit(T @ R.T)
    cf = _project(K, gb) + rng.normal(0, noise, (Q, 2))
    bad = rng.random(Q) < outliers
    cf[bad] += rng.uniform(-40, 40, (int(bad.sum()), 2))
    gb[bad] += rng.normal(0, 0.5, (int(bad.sum()), 3))
    valid = np.arange(Q) < n_valid
    return dict(gamma=g.astype(np.float32), gamma_bar=gb.astype(np.float32),
                tangent=T, tangent_bar=Tb, cf_left=cf.astype(np.float32),
                valid=valid, is_veridical=np.zeros(Q, bool),
                n_valid=np.int32(n_valid))


def hypotheses(seed, K_hyp, spread=0.003, behind=0.1, gated_out=0.3):
    """KG (K_hyp, 3, 3), Kt (K_hyp, 3) float32 and a gate (K_hyp,) bool
    for poses around `scene_motion(seed)`; a share `behind` of them put
    the scene behind the camera."""
    rng = np.random.default_rng(2000 + seed)
    R0, t0 = scene_motion(seed)
    K = K_LEFT.astype(np.float64)
    KG, Kt = [], []
    for h in range(K_hyp):
        R = _rot(rng.normal(0, spread, 3)) @ R0
        t = t0 + rng.normal(0, 10 * spread, 3)
        if rng.random() < behind:
            R, t = -R, -t
        KG.append(K @ R)
        Kt.append(K @ t)
    gate = rng.random(K_hyp) >= gated_out
    return (np.asarray(KG, np.float32), np.asarray(Kt, np.float32), gate)


def gn_pose(seed, spread=0.001):
    """A pose (R, t) float32 near `scene_motion(seed)`: where the
    refinement starts."""
    rng = np.random.default_rng(3000 + seed)
    R0, t0 = scene_motion(seed)
    R = _rot(rng.normal(0, spread, 3)) @ R0
    return (R.astype(np.float32),
            (t0 + rng.normal(0, spread, 3)).astype(np.float32))


@contextlib.contextmanager
def pose_twins():
    """A context in which `estimate_pose` runs K8's and K9's plain twins
    on the card (the module attributes it calls, swapped)."""
    from edge_based_visual_odometry_tpu_torch.ops import pose as POSE

    saved = (POSE.ransac_counts, POSE.pose_gn_normal_equations)
    POSE.ransac_counts = POSE.ransac_counts_plain
    POSE.pose_gn_normal_equations = POSE.pose_gn_normal_equations_plain
    try:
        yield
    finally:
        POSE.ransac_counts, POSE.pose_gn_normal_equations = saved


def singular_on_card(dev):
    """The singular refinement case through `estimate_pose` on the card
    and on the CPU with the same draws: asserts that the card returns
    `success`, 2 inliers and a finite pose within 1e-4 of the CPU's.
    Returns the seeds."""
    import torch

    from edge_based_visual_odometry_tpu_torch.config import VOConfig
    from edge_based_visual_odometry_tpu_torch.models import motion_tracker as MT
    from edge_based_visual_odometry_tpu_torch.models import types as TY

    cfg = VOConfig(**SINGULAR_CFG)
    draws = np.arange(cfg.ransac_max_iterations) % 2
    for seed in SINGULAR_SEEDS:
        res = {}
        for d in ("cpu", dev):
            pq = MT.PoseQuads(**{k: torch.as_tensor(np.array(v)).to(d)
                                 for k, v in singular_quads(seed).items()})
            res[str(d)] = MT.estimate_pose(
                pq, TY.rig_arrays_from_rig(S.default_rig(120, 160), d), cfg,
                idx=(draws, 1 - draws))
        c, g = res["cpu"], res[str(dev)]
        assert (bool(g.success) and int(g.inlier_count) == 2
                and bool(torch.isfinite(g.R).all()
                         and torch.isfinite(g.t).all())), (
            f"singular case {seed} on the card: success {bool(g.success)}, "
            f"{int(g.inlier_count)} inliers, R {g.R.tolist()}")
        err = max(float((g.R.cpu() - c.R).abs().max()),
                  float((g.t.cpu() - c.t).abs().max()))
        assert err <= 1e-4, (f"singular case {seed}: card and CPU poses "
                             f"{err:.3g} apart")
    return SINGULAR_SEEDS
