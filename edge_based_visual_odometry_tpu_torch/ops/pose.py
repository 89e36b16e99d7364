"""RANSAC hypothesis scoring and the inlier Gauss-Newton step of
`models/motion_tracker.py::estimate_pose`.

Port of the two numeric loops of `edge_based_visual_odometry_tpu/models/
motion_tracker.py::estimate_pose`: `make_score` / `score_all` (`:240-263`,
a `lax.map` over chunks of hypotheses) and `gn_step` (`:307-334`, a
`lax.scan`). On the TPU both are XLA ops, not a `pallas_call`. Two
hand-written kernels sit behind this module's wrappers, which send CUDA
tensors to the kernel and CPU tensors to its plain twin:
  - K8 (`csrc/ransac_score.cu`): `ransac_counts`, each hypothesis's count
    of quads that reproject within the threshold in front of the camera,
    twin `ransac_counts_plain`;
  - K9 (`csrc/pose_gn.cu`): `pose_gn_normal_equations`, one refinement
    step's weighted normal equations (the 21 upper-triangle entries of
    H, the 6 of b, and the sum of the weights), twin
    `pose_gn_normal_equations_plain`.
The twins do their float arithmetic in the kernels' order, so each agrees
with its kernel bit for bit on the card:
  - K8 forms a pair's projection as ((k0 g0 + k1 g1) + k2 g2) + t for each
    row of K R and K t, u and v as IEEE divisions by the third row, the
    error as sqrt(du^2 + dv^2); counts are integers, so the order in which
    the kernel joins its tiles' counts does not matter;
  - K9's 28 sums follow the kernel's layout (`K9_THREADS` threads a block,
    `K9_PER_THREAD` quads a thread, contiguous runs of quads a block): a
    thread adds its quads in order, a butterfly over the 32 lanes, the
    warps in order, then the blocks in order; slots past the quad count
    hold -0.0, which adds nothing (`_k9_layout_sum`).
No `einsum` in either twin: its order on the card is not known.
"""

from __future__ import annotations

import numpy as np
import torch

from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.ops.clustering import _f32

Z_MIN = _f32(1e-6)                # cheirality threshold and GN depth clamp
K9_THREADS = 128                  # K9: threads a block (4 warps)
K9_PER_THREAD = 4                 # K9: quads a thread, added in order
K9_SUMS = 28                      # 21 of H's upper triangle, 6 of b, sum(w)
CHUNK_PAIRS = 1 << 22             # K8's twin: (hypothesis, quad) pairs a chunk

# (a, b) of H's upper triangle, row by row: K9's first 21 sums
H_TRIANGLE = tuple((a, b) for a in range(6) for b in range(a, 6))
_H_INDEX = np.array([[H_TRIANGLE.index((min(a, b), max(a, b)))
                      for b in range(6)] for a in range(6)])
_h_index = {}


# ---------------------------------------------------------------- K8 ----

def _score_chunk(KG, Kt, gamma, cf_left, valid, thr):
    """Counts of one chunk of hypotheses (K8's per-pair arithmetic)."""
    g0, g1, g2 = gamma[:, 0], gamma[:, 1], gamma[:, 2]

    def row(i):
        return (((KG[:, i, 0, None] * g0 + KG[:, i, 1, None] * g1)
                 + KG[:, i, 2, None] * g2) + Kt[:, i, None])

    w = row(2)
    du = row(0) / w - cf_left[:, 0]
    dv = row(1) / w - cf_left[:, 1]
    err = torch.sqrt(du * du + dv * dv)
    inl = (err < thr) & valid & (w > Z_MIN)
    return inl.sum(1, dtype=torch.int32)


def ransac_counts_plain(KG, Kt, gamma, cf_left, valid, thresh: float,
                        gate=None, index=None):
    """The plain twin of K8, on any device: for each hypothesis h (each
    entry of `index`, else each row of KG), the number of quads q with
    `valid[q]`, depth > 1e-6 and reprojection error of K R_h gamma_q + K t_h
    against `cf_left[q]` below `thresh`; -1 where `gate` is False.
    KG (K, 3, 3), Kt (K, 3) float32; gamma (Q, 3), cf_left (Q, 2), valid
    (Q,) bool; gate (K,) bool; index int64. Returns int32."""
    if index is not None:
        KG, Kt = KG[index], Kt[index]
        gate = gate[index] if gate is not None else None
    thr = _f32(thresh)
    Q = gamma.shape[0]
    rows = max(1, CHUNK_PAIRS // max(Q, 1))
    counts = torch.cat([
        _score_chunk(KG[s:s + rows], Kt[s:s + rows], gamma, cf_left, valid,
                     thr) for s in range(0, KG.shape[0], rows)]
        + [torch.zeros(0, dtype=torch.int32, device=KG.device)])
    if gate is not None:
        counts = torch.where(gate, counts, torch.full_like(counts, -1))
    return counts


def ransac_counts_cuda(KG, Kt, gamma, cf_left, valid, thresh: float,
                       gate=None, index=None):
    """The hand-written kernel (csrc/ransac_score.cu, K8): same contract as
    `ransac_counts_plain`, for contiguous CUDA tensors; one launch (its
    output zeroed by a memset on the same stream). `index` is read by the
    kernel: the rows of KG are not gathered."""
    dev = KG.device
    if not KG.is_cuda:
        raise ValueError(f"ransac_counts_cuda: needs CUDA tensors, got them "
                         f"on {dev}")
    K = KG.shape[0]
    Q = gamma.shape[0]
    CB.require(KG, "KG", torch.float32, (K, 3, 3), dev)
    CB.require(Kt, "Kt", torch.float32, (K, 3), dev)
    CB.require(gamma, "gamma", torch.float32, (Q, 3), dev)
    CB.require(cf_left, "cf_left", torch.float32, (Q, 2), dev)
    CB.require(valid, "valid", torch.bool, (Q,), dev)
    if gate is not None:
        CB.require(gate, "gate", torch.bool, (K,), dev)
    if index is not None:
        if index.dim() != 1:
            raise ValueError(f"index: shape {tuple(index.shape)}, expected "
                             f"(n,)")
        CB.require(index, "index", torch.int64, (index.shape[0],), dev)
    n = K if index is None else index.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = CB.lib().ransac_score_launch(
            KG.data_ptr(), Kt.data_ptr(),
            gate.data_ptr() if gate is not None else None,
            index.data_ptr() if index is not None else None, n,
            gamma.data_ptr(), cf_left.data_ptr(), valid.data_ptr(), Q,
            _f32(thresh), Z_MIN, out.data_ptr(), CB.stream_ptr(dev))
    CB.check(err, "ransac_score")
    CB.LAUNCHES["ransac_score"] += 1
    return out


def ransac_counts(KG, Kt, gamma, cf_left, valid, thresh: float, gate=None,
                  index=None):
    """Inlier counts of RANSAC hypotheses (see `ransac_counts_plain`): K8
    for CUDA tensors, the plain twin for CPU tensors."""
    if KG.is_cuda:
        return ransac_counts_cuda(KG, Kt, gamma, cf_left, valid, thresh,
                                  gate=gate, index=index)
    if KG.device.type != "cpu":
        raise ValueError(f"ransac_counts: unsupported device {KG.device}")
    return ransac_counts_plain(KG, Kt, gamma, cf_left, valid, thresh,
                               gate=gate, index=index)


# ---------------------------------------------------------------- K9 ----

def _gn_terms(R, t, gamma, cf_left, valid, K, thr):
    """(Q, 28) per-quad terms of one GN step, in K9's arithmetic: H's
    upper triangle w Ja Jb summed over the 2 rows, the b terms w Ja r,
    and w (b is negated after the sums)."""
    g0, g1, g2 = gamma[:, 0], gamma[:, 1], gamma[:, 2]

    def row(i):
        return ((R[i, 0] * g0 + R[i, 1] * g1) + R[i, 2] * g2) + t[i]

    X, Y, Z = row(0), row(1), row(2)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = torch.clamp(Z, min=Z_MIN)
    r0 = fx * X / z + cx - cf_left[:, 0]
    r1 = fy * Y / z + cy - cf_left[:, 1]
    e = torch.sqrt(r0 * r0 + r1 * r1)
    w = ((e < thr) & valid).to(torch.float32)
    iz = torch.reciprocal(z)
    iz2 = iz * iz
    a, d = fx * iz, fy * iz
    c, f = -fx * X * iz2, -fy * Y * iz2
    zero = torch.zeros_like(z)
    J0 = (c * Y, a * Z - c * X, -(a * Y), a, zero, c)
    J1 = (f * Y - d * Z, -(f * X), d * X, zero, d, f)
    w0 = [w * j for j in J0]
    w1 = [w * j for j in J1]
    terms = [w0[p] * J0[q] + w1[p] * J1[q] for p, q in H_TRIANGLE]
    terms += [w0[p] * r0 + w1[p] * r1 for p in range(6)]
    return torch.stack(terms + [w], -1)


def _k9_blocks(Q: int) -> int:
    return max(1, -(-Q // (K9_THREADS * K9_PER_THREAD)))


def _k9_layout_sum(T):
    """Sum (Q, n) terms over Q in K9's order (module docstring)."""
    Q, n = T.shape
    B = _k9_blocks(Q)
    pad = B * K9_THREADS * K9_PER_THREAD - Q
    T = torch.cat([T, torch.full((pad, n), -0.0, dtype=T.dtype,
                                 device=T.device)])
    T = T.reshape(B, K9_PER_THREAD, K9_THREADS, n)
    acc = T[:, 0]
    for k in range(1, K9_PER_THREAD):
        acc = acc + T[:, k]
    acc = acc.reshape(B, K9_THREADS // 32, 32, n)
    width = 32
    while width > 1:                      # the butterfly: lane l + (l ^ h)
        width //= 2
        acc = acc[:, :, :width] + acc[:, :, width:2 * width]
    acc = acc[:, :, 0]                    # (B, warps, n)
    blk = acc[:, 0]
    for wp in range(1, K9_THREADS // 32):
        blk = blk + acc[:, wp]
    s = blk[0]
    for b in range(1, B):
        s = s + blk[b]
    return s


def pose_gn_normal_equations_plain(R, t, gamma, cf_left, valid, K,
                                   thresh: float):
    """The plain twin of K9, on any device: one GN step of the pose (R, t)
    on the quads' reprojection error through the intrinsics K, inliers
    re-gated at `thresh` (w = error < thresh and valid, the depth clamped
    at 1e-6). Returns (28,) float32: H's upper triangle row by row
    (`H_TRIANGLE`), b = -J^T W r, and sum(w)."""
    T = _gn_terms(R, t, gamma, cf_left, valid, K, _f32(thresh))
    s = _k9_layout_sum(T)
    return torch.cat([s[:21], -s[21:27], s[27:]])


def pose_gn_normal_equations_cuda(R, t, gamma, cf_left, valid, K,
                                  thresh: float):
    """The hand-written kernel (csrc/pose_gn.cu, K9): same contract as
    `pose_gn_normal_equations_plain`, for contiguous float32 CUDA tensors;
    one launch (its block ticket zeroed by a memset on the same stream),
    which reads R, t and K on the card."""
    dev = gamma.device
    if not gamma.is_cuda:
        raise ValueError(f"pose_gn_normal_equations_cuda: needs CUDA tensors, "
                         f"got them on {dev}")
    Q = gamma.shape[0]
    CB.require(R, "R", torch.float32, (3, 3), dev)
    CB.require(t, "t", torch.float32, (3,), dev)
    CB.require(K, "K", torch.float32, (3, 3), dev)
    CB.require(gamma, "gamma", torch.float32, (Q, 3), dev)
    CB.require(cf_left, "cf_left", torch.float32, (Q, 2), dev)
    CB.require(valid, "valid", torch.bool, (Q,), dev)
    B = _k9_blocks(Q)
    out = torch.empty(K9_SUMS, dtype=torch.float32, device=dev)
    partial = torch.empty(B * K9_SUMS + 1, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = CB.lib().pose_gn_launch(
            R.data_ptr(), t.data_ptr(), K.data_ptr(), gamma.data_ptr(),
            cf_left.data_ptr(), valid.data_ptr(), Q, _f32(thresh), Z_MIN,
            K9_THREADS, K9_PER_THREAD, partial.data_ptr(), out.data_ptr(),
            CB.stream_ptr(dev))
    CB.check(err, "pose_gn")
    CB.LAUNCHES["pose_gn"] += 1
    return out


def pose_gn_normal_equations(R, t, gamma, cf_left, valid, K, thresh: float):
    """One refinement step's normal equations (see
    `pose_gn_normal_equations_plain`): K9 for CUDA tensors, the plain twin
    for CPU tensors."""
    if gamma.is_cuda:
        return pose_gn_normal_equations_cuda(R, t, gamma, cf_left, valid, K,
                                             thresh)
    if gamma.device.type != "cpu":
        raise ValueError(f"pose_gn_normal_equations: unsupported device "
                         f"{gamma.device}")
    return pose_gn_normal_equations_plain(R, t, gamma, cf_left, valid, K,
                                          thresh)


def normal_matrix(sums):
    """The symmetric (6, 6) H of K9's 28 sums (on their device)."""
    dev = sums.device
    if dev not in _h_index:
        _h_index[dev] = torch.as_tensor(_H_INDEX, device=dev)
    return sums[_h_index[dev]]

