"""Frozen copy of the kernels' work arithmetic and the card's peaks.

Copied from `chip_smoke.py` (the constants and `k1_work` ... `k9_work`,
`bound`) so that later changes to the program cannot move the
benchmark's yardstick; `vo_bench/tests/test_vo_bench_work.py` holds the
copy to the counts of `tests/test_torch_bounds.py`. A launch's bound is
the larger of its operations over the float32 peak and its bytes (each
input read once, each output written once) over the memory rate.
"""

import numpy as np
import torch

# H100 SXM at its full 700 W: float32 outside the tensor cores, HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# K1, per low-res pixel: 12 column + 36 row correlations of 19 taps (one
# FMA = 2 flops each), and per phase an epilogue of 46 flops for the two
# third-order sums, 4 for |grad| (its sqrt as one) and 15 for atan2.
K1_FMA_PER_PIXEL = 12 * 19 + 36 * 19
K1_EPILOGUE_FLOPS = 65
K1_OUTPUTS_PER_PIXEL = 16            # 4 phases x (Ix, Iy, |grad|, orient)

# K2, per sample of the 2 P^2: once per candidate the left sample (10
# coordinate, 18 tap, 9 bilinear, 1 mean, 1 centring); per iteration the
# right sample (10 coordinate, 18 tap, 3 x 9 bilinear, 1 mean, 16 residual,
# weight and the three sums) plus 12 scalar flops (step, mean scale,
# delta, rms, confidence).
K2_LEFT_SAMPLE_FLOPS = 39
K2_SAMPLE_FLOPS = 72
K2_ITER_FLOPS = 12
K2_LANE_IN_BYTES = 6 * 4 + 2 * 4 + 1    # lx ly theta rx ry alpha0, epi, active
K2_LANE_OUT_BYTES = 3 * 4 + 1 + 4 + 1   # alpha score conf, valid, iters, done

# K3 (csrc/gn_2dof.cu), counted from its code, per sample of the 2 P^2
# (abs and selects not counted): once per lane the KF sample (4 offset,
# 6 coordinate, 22 tap, 9 bilinear, 1 mean, 1 centring) and the 4 CF
# offsets; per iteration the CF sample (6 coordinate, 22 tap, 3 x 9
# bilinear, 1 mean, 2 residual, 2 weight, 15 for the six sums) plus 28
# scalar flops (centre, means, reg, 2x2 solve, rms, |step|, confidence,
# update).
K3_ONCE_SAMPLE_FLOPS = 47
K3_SAMPLE_FLOPS = 75
K3_ITER_FLOPS = 28
K3_LANE_IN_BYTES = 6 * 4 + 2 * 4 + 1    # kx ky kt cx cy ct, d0, active
K3_LANE_OUT_BYTES = 4 * 4 + 1 + 4 + 1   # d score conf, valid, iters, done

# K4 (csrc/cluster_edges.cu), counted over each row's pairs of active
# slots (the sum of n_r^2) and its active slots: a term of a masked slot
# is an exact zero (compares, selects and the integer label steps not
# counted). Per pair the adjacency distance (2 sub, 2 mul, add, sqrt), and
# 1 sub more with the orientation gate; with the cap, per pair the
# centroid sums (2 mul, 2 add) and per slot 2 divisions and its distance
# to the centroid (6); for the representative, per pair the centroid sums
# (4), the distance (6), the mean-shift sum (2), the weight (sub, 2 mul
# for z and z^2, mul by -0.5, exp, mul by the membership: 6), its sum (1)
# and the three weighted sums (6), and per slot 6 divisions. Bytes: every
# slot read and every output written, whatever the mask.
K4_PAIR_FLOPS = 6
K4_ORIENT_PAIR_FLOPS = 1
K4_CAP_PAIR_FLOPS = 4
K4_CAP_SLOT_FLOPS = 8
K4_REP_PAIR_FLOPS = 25
K4_REP_SLOT_FLOPS = 6
K4_SLOT_IN_BYTES = 3 * 4 + 1            # x y theta, mask
K4_SLOT_OUT_BYTES = 3 * 4 + 1 + 8       # x y theta, mask, int64 label

# K5 (csrc/edge_descriptors.cu), counted from its code (abs, min, max and
# selects not counted): per sample 8 coordinate, 18 tap, 2 x 9 bilinear,
# 5 magnitude (its sqrt as one), 16 angle (atan2 as 15, as in K1), 4 bin
# position (fmod and its sign fix as 2) and 4 a bin for the 2 bins of the
# circular orientation hat that can be nonzero (its other 6 are exact
# zeros and not counted, as the histogram is counted at its nonzero
# terms); the histogram: a multiply and an add for each nonzero spatial
# weight and each of the 2 orientation bins the hat can touch; per
# keypoint the two norms (2 x 128 squares and adds, 2 sqrt), 2 x 128
# divisions and 128 scalings. Bytes: the two maps once; per keypoint 5
# floats in (x, y, theta, cos, sin) and 128 bf16 out; the tables.
K5_SAMPLE_FLOPS = 8 + 18 + 18 + 5 + 16 + 4 + 2 * 4
K5_TERM_FLOPS = 2 * 2
K5_KEYPOINT_FLOPS = 4 * 128 + 2 + 3 * 128
K5_KEYPOINT_IN_BYTES = 5 * 4
K5_KEYPOINT_OUT_BYTES = 128 * 2

# K6 (csrc/dense_gates.cu): what the function needs over the live pairs
# (abs, min, max, compares and selects not counted), with a side of pp
# samples. A descriptor's |a|^2 is 2 x (128 products, 127 adds), once a
# descriptor: once a row with a live pair, once a distinct candidate row;
# a pair's distance adds the 4 cross dots (2 x 256 products, 2 x 254
# sums), 4 x (add, mul, sub) for the squared distances and a sqrt. A
# patch side's centring is its sum (pp - 1), the mean (1), pp
# subtractions, pp squares and their pp - 1 adds, once a side (a row's, a
# distinct candidate row's; the flat call's right sides once an entry);
# each of the 4 pairings of an NCC adds pp products (2 pp - 1) and takes
# a product, sqrt and division. (The kernel's prep pass forms the terms
# of every row of the candidate table, read or not; only the rows a live
# pair reads are counted.) Bytes: the mask read and the outputs written
# in full, the index of each live slot, and each table row a live pair
# needs, once.
K6_DESC_PAIR_FLOPS = 2 * 256 + 2 * 254 + 4 * 3 + 1
K6_DESC_ROW_FLOPS = 2 * (128 + 127)


def k6_side_flops(pp):
    return 4 * pp - 1


def k6_pair_flops(pp):
    return 4 * (2 * pp - 1 + 3)


# K7 (csrc/edge_patches.cu), counted from its code (abs, floor, ceil,
# compares and selects not counted): per sample 8 coordinate (4 products,
# 4 sums), 16 tap (the tile clamp's 2, the 4 weights' 10, the 4 indices'
# sums), 9 bilinear; per edge sin and cos (as 1 each), the 2 shifts, the
# 4 centres and the 2 tile origins (3 each). Bytes: the image once; per
# live edge x, y, theta in, its 2 P^2 floats and 2 flags out (and the
# live flags, where the call has them).
K7_SAMPLE_FLOPS = 8 + 16 + 9
K7_EDGE_FLOPS = 2 + 2 + 4 + 6


# K8 (csrc/ransac_score.cu), per pair of a gated hypothesis and a valid
# quad (compares not counted): K R g + K t (3 rows of 3 multiplies and 3
# adds), 2 divisions, 2 subtractions, 2 squares, an add and a sqrt. Bytes:
# per hypothesis counted its K R and K t rows, its gate and its int32
# count (and its int64 index, where the call passes one); per quad gamma,
# cf and valid.
K8_PAIR_FLOPS = 18 + 2 + 2 + 2 + 1 + 1
K8_HYP_BYTES = 9 * 4 + 3 * 4 + 1 + 4
K8_INDEX_BYTES = 8
K8_QUAD_BYTES = 3 * 4 + 2 * 4 + 1

# K9 (csrc/pose_gn.cu), per quad (the depth clamp, compares and selects not
# counted): R g + t 18, the residual 8 (2 x multiply, divide, add,
# subtract), its norm 4, 1 / z and its square 2, fx / z and fy / z 2, the
# two depth terms 6 (negate, 2 multiplies each), the rotation Jacobian 12,
# the weighted rows 12, H's 21 entries 63, b's 6 entries 18, and one add
# into each of the 28 sums; then b's 6 negations. Bytes: gamma, cf and
# valid a quad; R, t, K in and the 28 sums out.
K9_QUAD_FLOPS = 18 + 8 + 4 + 2 + 2 + 6 + 12 + 12 + 63 + 18 + 28
K9_STEP_FLOPS = 6
K9_QUAD_BYTES = 3 * 4 + 2 * 4 + 1
K9_STEP_BYTES = (9 + 3 + 9 + 28) * 4


def bound(flops, nbytes, peak_flops=PEAK_FLOPS):
    """Least time in ms for `flops` and `nbytes` on the card, and what
    sets it ("operations" or "bytes")."""
    t_op, t_by = flops / peak_flops, nbytes / PEAK_BYTES
    return dict(flops=int(flops), bytes=int(nbytes),
                bound_ms=max(t_op, t_by) * 1e3,
                bound_by="operations" if t_op >= t_by else "bytes")


def k1_work(B, H, W):
    """(flops, bytes) of K1 on (B, H, W) images."""
    px = B * H * W
    flops = px * (2 * K1_FMA_PER_PIXEL + 4 * K1_EPILOGUE_FLOPS)
    return flops, px * 4 + K1_OUTPUTS_PER_PIXEL * px * 4


def k2_work(iters_run, active, patch_size, H, W):
    """(flops, bytes) of one K2 launch over B lanes: `iters_run` the
    iterations each lane ran in it, `active` the lanes it refined."""
    n = 2 * patch_size * patch_size
    iters_run = np.asarray(iters_run, np.int64)
    B = iters_run.shape[0]
    flops = (int(np.count_nonzero(active)) * n * K2_LEFT_SAMPLE_FLOPS
             + int(iters_run.sum()) * (n * K2_SAMPLE_FLOPS + K2_ITER_FLOPS))
    nbytes = 4 * H * W * 4 + B * (K2_LANE_IN_BYTES + K2_LANE_OUT_BYTES)
    return flops, nbytes


def k3_work(iters_run, active, patch_size, H, W):
    """(flops, bytes) of one K3 launch over B lanes: `iters_run` the
    iterations each lane ran in it, `active` the lanes it refined."""
    n = 2 * patch_size * patch_size
    iters_run = np.asarray(iters_run, np.int64)
    B = iters_run.shape[0]
    flops = (int(np.count_nonzero(active)) * n * K3_ONCE_SAMPLE_FLOPS
             + int(iters_run.sum()) * (n * K3_SAMPLE_FLOPS + K3_ITER_FLOPS))
    nbytes = 4 * H * W * 4 + B * (K3_LANE_IN_BYTES + K3_LANE_OUT_BYTES)
    return flops, nbytes


def k4_work(mask, by_orientation, max_cluster_size):
    """(flops, bytes) of one K4 launch over the (N, C) slots of `mask`
    (a numpy array or a tensor): flops over each row's active slots and
    their pairs, bytes over every slot (each read, each output written);
    the (N, C, C) membership matrix is one byte an entry."""
    mask = np.asarray(mask.cpu() if isinstance(mask, torch.Tensor) else mask)
    N, C = mask.shape
    n = mask.sum(1, dtype=np.int64)
    pairs, active = int((n * n).sum()), int(n.sum())
    cap = bool(max_cluster_size) and max_cluster_size < C
    flops = (pairs * (K4_PAIR_FLOPS + K4_REP_PAIR_FLOPS
                      + K4_ORIENT_PAIR_FLOPS * bool(by_orientation)
                      + K4_CAP_PAIR_FLOPS * cap)
             + active * (K4_REP_SLOT_FLOPS + K4_CAP_SLOT_FLOPS * cap))
    return flops, N * C * (K4_SLOT_IN_BYTES + K4_SLOT_OUT_BYTES + C)


def k5_work(K, S, nonzero, H, W):
    """(flops, bytes) of one K5 launch over K keypoints of S samples:
    `nonzero` the spatial weights that are not 0 in the table (S x 16),
    read with their sample index; the (ii, jj, gauss) tables S floats
    each."""
    flops = K * (S * K5_SAMPLE_FLOPS + nonzero * K5_TERM_FLOPS
                 + K5_KEYPOINT_FLOPS)
    nbytes = (2 * H * W * 4 + K * (K5_KEYPOINT_IN_BYTES
                                   + K5_KEYPOINT_OUT_BYTES)
              + 3 * S * 4 + nonzero * 8)
    return flops, nbytes


def k6_work(kind, live, pp, idx, survivors=None):
    """(flops, bytes) of one K6 launch (numpy arrays or tensors): `kind`
    "stereo", "temporal" or "flat"; `live` the (N, C) mask it was given
    ((F,) flags for "flat"); `pp` the samples of a patch side; `idx` the
    rows a pair reads: the (N, C) candidates in the right (stereo) or CF
    (temporal) table, the (F,) left rows (flat); `survivors` the stereo
    slots that passed the descriptor gate (the NCC's pairs)."""
    def arr(m, dtype=bool):
        return np.asarray(m.cpu() if isinstance(m, torch.Tensor) else m,
                          dtype)

    live, idx = arr(live), arr(idx, np.int64)
    n_live = int(live.sum())
    side, pair = k6_side_flops(pp), k6_pair_flops(pp)
    pat = 2 * pp * 4 + 2                         # a row's patches and flags
    u_live = np.unique(idx[live]).size          # distinct rows read
    if kind == "flat":
        F = live.shape[0]
        flops = u_live * 2 * side + n_live * (2 * side + pair)
        return flops, F * (1 + 4) + n_live * (8 + pat) + u_live * pat
    N, C = live.shape
    rows = int(live.any(1).sum())
    if kind == "stereo":
        surv = arr(survivors)
        n_surv, s_rows = int(surv.sum()), int(surv.any(1).sum())
        u_surv = np.unique(idx[surv]).size
        flops = ((rows + u_live) * K6_DESC_ROW_FLOPS
                 + n_live * K6_DESC_PAIR_FLOPS
                 + (s_rows + u_surv) * 2 * side + n_surv * pair)
        nbytes = (N * C * (1 + 2 * 4) + n_live * 8 + (rows + u_live) * 512
                  + (s_rows + u_surv) * pat)
        return flops, nbytes
    assert kind == "temporal", kind
    flops = ((rows + u_live) * 2 * (K6_DESC_ROW_FLOPS + 2 * side)
             + n_live * 2 * (K6_DESC_PAIR_FLOPS + pair))
    nbytes = (N * C * (1 + 4 * 4) + n_live * 8 + rows * 2 * (512 + pat)
              + u_live * (1024 + 4 * pp * 2 + 4))
    return flops, nbytes


def k7_work(B, pp, H, W, live=None):
    """(flops, bytes) of one K7 launch over B edges of 2 pp samples on an
    H x W image; with `live` (a (B,) mask), over its live edges."""
    n = B if live is None else int(np.count_nonzero(
        np.asarray(live.cpu() if isinstance(live, torch.Tensor) else live)))
    flops = n * (2 * pp * K7_SAMPLE_FLOPS + K7_EDGE_FLOPS)
    return flops, (H * W * 4 + n * (3 * 4 + 2 * pp * 4 + 2)
                   + (0 if live is None else B))


def k8_work(n_out, n_gated, Q, n_valid, indexed=False):
    """(flops, bytes) of one K8 call: `n_out` hypotheses counted, of which
    `n_gated` pass the gate, over Q quads of which `n_valid` are valid."""
    flops = K8_PAIR_FLOPS * n_gated * n_valid
    nbytes = (n_out * (K8_HYP_BYTES + (K8_INDEX_BYTES if indexed else 0))
              + Q * K8_QUAD_BYTES)
    return flops, nbytes


def k9_work(Q):
    """(flops, bytes) of one K9 call over Q quads."""
    return (Q * K9_QUAD_FLOPS + K9_STEP_FLOPS,
            Q * K9_QUAD_BYTES + K9_STEP_BYTES)

