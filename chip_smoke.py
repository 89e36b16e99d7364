#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each passes or exits non-zero):
  1. require CUDA; print the card (nvidia-smi name, power limit);
  2. build the hand-written kernels from csrc/ (nvcc, sm_90a) and print
     what ptxas says of each (registers, shared memory, spills);
  3. K1 (TOED gradient field) vs its plain twin on frame 0 of the
     376x1241 synthetic sequence, both images; timed beside the twin;
  4. K2 (1-DoF epipolar GN) vs its plain twin, bit for bit, on the real
     stage-9 input of that frame: as one 20-iteration launch and as the
     pipeline's two phases; each form timed on the interleaved maps the
     pipeline makes once per frame, and that interleave timed apart;
  5. the port on the CPU (plain twins) vs the port on the GPU (kernels)
     on a small 120x160 sequence;
  6. the production frame: VOPipeline(VOConfig(), every_frame) over the 3
     frames, with launch counts, workload and pose-error checks, the
     steps timed by `StageTimer`; then the prediction-mode temporal step
     of frame 2 again, 3 times, each stage of it timed (synchronised),
     and frame 2's stereo step so;
 6b. K3 (2-DoF KF -> CF GN) vs its plain twin, bit for bit, on the
     operands frame 2's temporal step gave `refine_2dof_pair_batch`,
     both sides in one launch: as one 20-iteration launch and as the
     main path's two launches (phase 2's lanes picked on the device),
     also against the per-side form (`_two_phase`: a sort, gathers and
     merges around one-side launches); each form, the per-side form and
     the pair interleave timed beside its bound (the two launches and the
     glue between them apart), the twin and the watch of the lanes'
     deltas timed; registers, spills and warps an SM;
 6c. K4 (edge clustering) vs its plain twin run on the card, bit for bit,
     on the operands frame 2's stereo and temporal steps gave
     `cluster_edges`; each call timed beside its bound and the twin, with
     its rows counted by active slots (0, 1-8, 9+) and the rows whose
     sums add every slot (a non-finite or huge value); K4 against the JAX
     package's outputs on every case of tests/cluster_cases.py
     (tests/data/k4_jax_reference.npz, within K4_JAX_ULPS; phase 2 prints
     its registers and spills; `scripts/k4_variants.py` times other
     forms of it);
 6d. K5 (edge descriptors) vs its plain twin run on the card, bit for bit
     (bf16 bit patterns), on the operands of the three calls of frame 2's
     stereo step (left edges, right edges, final mates); each call timed
     beside its bound (and its FMA-free bound) and the twin; the built
     kernel's registers, local memory, shared memory and warps an SM; K5
     against the JAX package's outputs on every case of
     tests/descriptor_cases.py (tests/data/k5_jax_reference.npz, within
     1 bf16 ulp; `scripts/k5_variants.py` times the launch alone and its
     parts);
 6e. K6 (the dense NCC and descriptor gates) vs its plain twins run on the
     card, bit for bit on every slot (the slots not computed holding their
     fill), on the operands of frame 2's stereo call (stages 4-5), its
     stage-11 call (the flat pair list) and its temporal call; each call
     timed with its wrapper and as launches alone (a CUDA graph; the
     stereo and temporal calls' prep pass included), beside its bound over
     the live pairs and the twin, its live slots counted; each kernel's
     registers, spills and warps an SM; K6 against the JAX package's
     `ncc4` and `min_cross_distance_dot` on every case of
     tests/gate_cases.py (tests/data/k6_k7_jax_reference.npz, within the
     CPU tests' tolerances; `scripts/k6_variants.py` times other forms of
     it);
 6f. K7 (two-side edge patches) vs its plain twin run on the card, bit for
     bit, on frame 2's four calls (left edges, right edges, the stage-11
     centres, on their live entries only, the final mates); each call
     timed with its wrapper and as launches alone, beside its bound (the
     stage-11 call's over its live entries) and the twin; its registers,
     local bytes and warps an SM; K7 against the JAX package's
     `edge_patches_tiled` on every patch case of tests/gate_cases.py (the
     same file);
 6g. the patch sizes past the default: 3 frames at P = 5, 9 and 11, each
     with the largest shift the reference's coverage guard admits (5, 4
     and 2.9 px); on frame 2's operands at each size K2 (two phases), K3
     (both sides, two launches), K6 (three entries) and K7 (four calls)
     bit for bit against their twins on the card, each timed alone (a
     CUDA graph) beside its bound; the ptxas registers and spills of the
     instances each size runs; the P = 9 frames held to the production
     guards (a successful, finite pose with >= 500 quads on frames 1-2)
     and to the default frame's launches of K2, K3, K6 and K7;
 6h. K8 (RANSAC hypothesis scoring) and K9 (the pose GN step's normal
     equations) vs their plain twins run on the card, bit for bit, on the
     operands of frame 2's two `ransac_counts` calls (the prescore and
     the full count) and four `pose_gn_normal_equations` calls; each
     timed with its wrapper and launched alone, beside its bound (and its
     FMA-free bound) and the twin; frame 2's `estimate_pose` on the
     kernels against the same on the twins (R, t, inliers identical),
     both timed, with no wait for the card in the call (PyTorch's sync
     debug warnings) and its 4 refinement steps run with the sync check
     set to raise; the singular case of
     tests/pose_cases.py
     through `estimate_pose` on the card (success, 2 inliers, a finite
     pose, within 1e-4 of the CPU's). Phase 6's temporal split times
     estimate_pose's stages: the gates and pair poses, the prescore, the
     sort, the full count, the 4 refinement steps, the final count;
  7. the sequence path at full width: `cli.run` on 6 frames of 376x1241
     (in-memory samples, a config dict), every_frame, windowed BA over 3
     keyframes, dump files on, a checkpoint every 2 frames; then the same
     frames cut at frame 3 and resumed from the checkpoint, and once more
     without BA. Checks per frame the kernel launches, mates, quads and
     pose error, the BA cost series, the ATE with BA against without, the
     resumed trajectory against the uninterrupted one, and the dump files;
  8. the evaluation path: 3 frames with GT disparity supervision, GT
     poses and filter distributions on a rig with small distortion (the
     frames distorted in numpy with the inverse map), checking the final
     stereo recall / precision, the temporal rows against floors taken
     from the reference package's reading at this width, the RANSAC
     constraint sweep, and K2 bit for bit against its twin on this path's
     remapped float frames;
  9. the multi-device path: `parallel/mesh.py` under torch.distributed
     with NCCL (world size 1): the sharded pair step on a batch of two
     376x1241 frame pairs with distinct seeds, each pair's mates and quads
     against the same frames through VOPipeline's steps, its pose error,
     the all-reduced mean; the step timed; `analyze_production_memory`;
 9b. a cross-rank collective on the card: two spawned ranks on cuda:0 in
     a gloo group (NCCL refuses two ranks on one GPU) split the windowed
     BA of the 8-keyframe corridor chain, against one rank on the card;
 10. the corridor at reduced depth: `scripts/long_seq_validation_torch.py`
     (cli.run, adaptive keyframes, BA window 5) on 25 frames of
     `make_corridor_sequence` at 376x1241: no collapsed frame, a pose on
     every frame, ATE under 5% of the GT path;
On every path (6-10) the active K3 lanes are checked for a finite
delta, and the lanes ended by the singular-lane guard are counted; K4 is
launched once per stereo step and once per temporal step, K5 three times
per stereo step, K6 three times per stereo step (stages 4-5: the prep
pass and the gates; stage 11) and twice per temporal step (the prep pass
and the gates), K7 four times per stereo step, K8 twice and K9 four
times per temporal step.
Last, a fourth production frame under `device_trace` (torch.profiler):
the kernels of a frame, their time on the card, the card's busy share.
Prints a JSON line of per-kernel results (time, bound, % of bound, and
the launches of each driven path), then as the last line
{"ok": true, "device": {...}}.

The bound of a kernel is the least time the card could take for its
work: the larger of its operations over the float32 peak and its bytes
(each input read once, each output written once) over the memory rate.
K2's and K3's arithmetic is FMA-free (each multiply and add rounds on its
own, to stay bit-equal to the twin), so they can reach at most half the
FMA peak; their lines also give the bound at that rate (`bound_ms_no_fma`).
The counting functions below need no GPU (tests/test_torch_bounds.py).
"""

import contextlib
import dataclasses
import functools
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM at its full 700 W: float32 outside the tensor cores, HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the same units issuing one multiply or one add per lane and clock
PEAK_FLOPS_NO_FMA = PEAK_FLOPS / 2

# phases 7-8 run `cli.run` with these flags on top of their own (the
# defaults: the card, VOConfig() as it is)
CLI_FLAGS = {"device": "cuda"}

# frames of phase 10's corridor (the 100-frame run is
# scripts/long_seq_validation_torch.py's default)
N_CORRIDOR = 25

# Floors of phase 8's temporal rows. At this width the reference package
# itself reads 0.9537 after the gather (its window holds ~278 candidates a
# row and keeps `quad_gather_slots` of them) and 0.8179 / 0.7157 final
# recall / precision on frames 0 -> 1, and the port on the same mates
# 0.8198 / 0.7178 (`scripts/torch_parity_eval.py`, CPU); the floors sit
# 0.04-0.05 below, for the remapped frames and the second frame pair.
EVAL_TEMPORAL_FLOOR = {"gather_recall": 0.91, "recall": 0.77,
                       "precision": 0.67}

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


def nms_work(B, H, W, kept, max_edges):
    """(flops, bytes) of TOED's NMS and compaction (csrc/
    toed_nms_compact.cu) on B images of H x W: bytes, Ix, Iy and |grad|
    of each field pixel once, the orientation of each kept pixel, and the
    B EdgeLists (4 floats and a flag a slot, the counts). Its arithmetic
    (comparisons, and the fit only on pixels past NMS) is not counted:
    the bytes bound it."""
    return 0, (B * 4 * H * W * 3 * 4 + sum(kept) * 4
               + B * max_edges * (4 * 4 + 1) + B * 4)


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


def gate_errors(a, b, mask, tol, relative=False):
    """Entries of `mask` where a and b (numpy) differ past the CPU tests'
    tolerance against JAX: NaN in one only, or |a - b| > atol + rtol |b|
    (relative: rtol = tol, atol = tol max(1, max |b|) as
    tests/test_torch_ops.py's `close`; else atol = tol). Returns (that
    count, the largest |a - b| over the entries finite in both)."""
    mask = np.asarray(mask, bool)
    a = np.asarray(a, np.float64)[mask]
    b = np.asarray(b, np.float64)[mask]
    fin = np.isfinite(a) & np.isfinite(b)
    scale = max(1.0, float(np.abs(b[fin]).max())) if fin.any() else 1.0
    atol, rtol = (tol * scale, tol) if relative else (tol, 0.0)
    d = np.abs(np.where(fin, a - b, 0.0))
    bad = ((np.isnan(a) != np.isnan(b))
           | (fin & (d > atol + rtol * np.abs(np.where(fin, b, 0.0))))
           | (~fin & ~np.isnan(a) & (a != b)))
    return int(bad.sum()), float(d.max()) if d.size else 0.0


# K4 against the JAX package's outputs: x, y and theta within this many
# float32 ulps of max(|a|, |b|, 1). The twin (and K4) adds in ascending
# slot order, XLA's dots in their own order, and the card's expf may
# differ from the CPU's vectorised exp in the last bit; the twin on the
# CPU is within 7 of JAX on every case.
K4_JAX_ULPS = 16


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps):
    """Mean device ms per call over `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps):
    """Mean device ms per call of `fn`'s launches alone: `reps` calls
    captured in one CUDA graph, so the wrapper's host work (checks, the
    ctypes call) runs once at capture and not between the launches; the
    graph replayed once to warm, then timed."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / reps
    del g
    return ms


def launch_bound(ms, launch_ms, flops, nbytes, fma_free=False):
    """`with_bound` for a kernel timed both with its wrapper (`ms`) and
    as launches alone (`launch_ms`): the % of bound is the launches',
    the wrapper's beside it."""
    b = with_bound(launch_ms, flops, nbytes, fma_free)
    b.update(ms=ms, launch_ms=launch_ms,
             pct_of_bound_with_wrapper=100.0 * b["bound_ms"] / ms)
    return b


def with_bound(ms, flops, nbytes, fma_free=False):
    b = bound(flops, nbytes)
    b.update(ms=ms, pct_of_bound=100.0 * b["bound_ms"] / ms)
    if fma_free:
        nf = bound(flops, nbytes, PEAK_FLOPS_NO_FMA)["bound_ms"]
        b.update(bound_ms_no_fma=nf, pct_of_bound_no_fma=100.0 * nf / ms)
    return b


def same_lanes(x, y, mask, what):
    """Fail unless two GN results (delta, score, conf, valid, iters, done)
    are bit-equal on the lanes of `mask`; a NaN equals a NaN."""
    for nm, u, v in zip(("delta", "score", "conf", "valid", "iters", "done"),
                        x, y):
        ne = u != v
        if u.is_floating_point():
            ne &= ~(u.isnan() & v.isnan())
        if ne.dim() == 2:
            ne = ne.any(-1)
        n_bad = int(ne[mask].sum())
        check(n_bad == 0, f"{what}: {nm} differs on {n_bad} of "
                          f"{int(mask.sum())} active lanes")


def same_cluster(a, b, what):
    """Fail unless two ClusterResults are equal: label, mask and members
    equal, x / y / theta bit-equal (a NaN equals a NaN). Returns the
    largest |a - b| over the finite float outputs."""
    for nm in ("label", "mask", "members"):
        n_bad = int((getattr(a, nm) != getattr(b, nm)).sum())
        check(n_bad == 0, f"{what}: {nm} differs at {n_bad} entries")
    err = 0.0
    for nm in ("x", "y", "theta"):
        u, v = getattr(a, nm), getattr(b, nm)
        ne = ((u.view(torch.int32) != v.view(torch.int32))
              & ~(u.isnan() & v.isnan()))
        n_bad = int(ne.sum())
        check(n_bad == 0, f"{what}: {nm} not bit-equal at {n_bad} slots")
        fin = u.isfinite() & v.isfinite()
        if bool(fin.any()):
            err = max(err, float((u - v).abs()[fin].max()))
    return err


def f32_ulps(a, b):
    """The largest difference of two float32 arrays in ulps of
    max(|a|, |b|, 1) (0 where both are NaN), and the entries that are NaN
    in one only."""
    u, v = (np.asarray(t, np.float32).astype(np.float64) for t in (a, b))
    nan = np.isnan(u) | np.isnan(v)
    mag = np.maximum(np.maximum(np.abs(np.where(nan, 0, u)),
                                np.abs(np.where(nan, 0, v))), 1.0)
    with np.errstate(invalid="ignore"):
        d = np.where(nan | (u == v), 0.0, np.abs(u - v)
                     / np.exp2(np.floor(np.log2(mag)) - 23))
    return (float(d.max()) if d.size else 0.0,
            int((np.isnan(u) != np.isnan(v)).sum()))


def k4_against_jax(dev):
    """K4 on the card against the JAX package's outputs on every case of
    `tests/cluster_cases.py` at 64 rows of 32 slots (`tests/data/
    k4_jax_reference.npz`): {case: (label, mask and members entries that
    differ, entries NaN in one only, the largest x / y / theta difference
    in ulps)}."""
    from edge_based_visual_odometry_tpu_torch.ops import clustering as CL
    from scripts import k4_jax_reference as KJ
    from tests import cluster_cases as CC

    res = {}
    with np.load(KJ.PATH) as refs:
        for name in CC.CASES:
            x, y, th, mask, kw = KJ.inputs(name)
            k = CL.cluster_edges_cuda(
                *(torch.from_numpy(a).to(dev) for a in (x, y, th, mask)), **kw)
            ref = {f: refs[KJ.key(name, f)] for f in KJ.FIELDS}
            n_bad = sum(int((getattr(k, f).cpu().numpy() != ref[f]).sum())
                        for f in ("label", "mask", "members"))
            errs = [f32_ulps(getattr(k, f).cpu().numpy(), ref[f])
                    for f in ("x", "y", "theta")]
            res[name] = (n_bad, sum(e[1] for e in errs),
                         max(e[0] for e in errs))
    return res


def recorder(fn, imgs, gn_kw, calls, **extra):
    """A `_two_phase` run that launches `fn` on the maps `imgs` and keeps
    each launch's operands in `calls`."""
    def run(args, delta0, it0, it_stop, active):
        calls.append((args, delta0, it0, it_stop, active))
        return fn(*imgs, *args, delta0, active, it0, it_stop, **gn_kw,
                  **extra)
    return run


def gn_forms(launch, forms, work, P, H, W):
    """Time each form (args, delta0, it0, it_stop, active) of a GN kernel
    with CUDA events; its bound from the iterations each lane ran."""
    rows = {}
    for form, (args, d0, it0, it_stop, fact) in forms.items():
        def run():
            return launch(args, d0, it0, it_stop, fact)
        res, _ = run()
        run_it = (res.iters.long() - it0).clamp(min=0) * fact
        w = work(run_it.cpu().numpy(), fact.cpu().numpy(), P, H, W)
        row = with_bound(cuda_ms(run, 20), *w, fma_free=True)
        row.update(lanes=int(fact.shape[0]), active=int(fact.sum()),
                   iterations=int(run_it.sum()))
        rows[form] = row
    return rows


def step_split(stages, label, step, args, reps=3):
    """Per-stage ms of `step(*args)` (`label`), mean of `reps` runs; each
    stage (module, attribute, label) timed with the card synchronised
    before and after it, its calls in a step summed."""
    from edge_based_visual_odometry_tpu_torch.utils import timing as TIM

    timer = TIM.StageTimer()
    saved = [(m, n, getattr(m, n)) for m, n, _ in stages]
    try:
        for (m, n, fn), (_, _, name) in zip(saved, stages):
            setattr(m, n, functools.partial(timer.timed, name, fn))
        for _ in range(reps):
            timer.timed(label, step, *args)
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    return {n: sum(ts) / reps * 1e3 for n, ts in timer.times.items()}


# estimate_pose's stages (models/motion_tracker.py), as temporal_split
# names them
POSE_STAGES = (("_hypotheses", "gates and _pose_from_pair"),
               ("_prescore", "prescore (K8)"), ("_rank", "sort"),
               ("_full_count", "full count (K8)"),
               ("_refine_step", "4 refinement steps (K9 + solve_ex)"),
               ("_final_count", "final count"))


def temporal_split(step, args, reps=3):
    """Per-stage ms of one temporal step (`step_split`), estimate_pose's
    stages (`POSE_STAGES`) among them."""
    from edge_based_visual_odometry_tpu_torch.models import motion_tracker as MT
    from edge_based_visual_odometry_tpu_torch.models import temporal_matcher as TM
    from edge_based_visual_odometry_tpu_torch.ops import clustering as CL
    from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
    from edge_based_visual_odometry_tpu_torch.ops import patches as P

    split = step_split(
        ((TM, "match_temporal", "match_temporal"),
         (GN, "interleave_pair_maps", "interleave_pair_maps"),
         (GN, "refine_2dof_pair_batch", "refine_2dof_pair_batch"),
         (CL, "cluster_edges", "cluster_edges"),
         (P, "dense_gates_temporal", "dense NCC + descriptor gates"),
         (MT, "lift_quads", "lift_quads"),
         (MT, "estimate_pose", "estimate_pose"),
         *((MT, fn, name) for fn, name in POSE_STAGES)),
        "temporal step", step, args, reps)
    split["rest of match_temporal"] = split["match_temporal"] - sum(
        split[nm] for nm in ("interleave_pair_maps", "refine_2dof_pair_batch",
                             "cluster_edges", "dense NCC + descriptor gates"))
    split["rest of estimate_pose"] = split["estimate_pose"] - sum(
        split[nm] for _, nm in POSE_STAGES)
    return split


def stereo_split(step, args, reps=3):
    """Per-stage ms of one stereo step (`step_split`): edge detection,
    descriptors, the dense gates of stages 4-5 (K6), the four patch calls
    (K7), K2's two phases (`refine_along_epipolar_batch`), the clustering
    and stage 11's NCC (K6)."""
    from edge_based_visual_odometry_tpu_torch.models import stereo_matcher as SM
    from edge_based_visual_odometry_tpu_torch.ops import clustering as CL
    from edge_based_visual_odometry_tpu_torch.ops import descriptors as DESC
    from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
    from edge_based_visual_odometry_tpu_torch.ops import patches as P
    from edge_based_visual_odometry_tpu_torch.ops import toed as T

    inner = ("edge_descriptors", "dense NCC + descriptor gates",
             "edge_patches", "refine_along_epipolar_batch", "cluster_edges",
             "stage-11 NCC")
    split = step_split(
        ((T, "detect_edges", "detect_edges"),
         (SM, "match_stereo", "match_stereo"),
         (DESC, "edge_descriptors", inner[0]),
         (P, "dense_gates_stereo", inner[1]),
         (P, "edge_patches_flat", inner[2]),
         (GN, "refine_along_epipolar_batch", inner[3]),
         (CL, "cluster_edges", inner[4]),
         (P, "dense_gates_flat", inner[5])),
        "stereo step", step, args, reps)
    split["rest of match_stereo"] = split["match_stereo"] - sum(
        split[nm] for nm in inner)
    split["rest of the step"] = (split["stereo step"] - split["match_stereo"]
                                 - split["detect_edges"])
    return split


def u8(a):
    """Production PNG path: integer-valued images."""
    return np.round(a).clip(0, 255).astype(np.uint8)


def rel_pose_err(tr, f_kf, f_cf):
    R_gt = f_cf.R @ f_kf.R.T
    t_gt = f_cf.t - R_gt @ f_kf.t
    dR = tr.R.double().cpu().numpy() @ R_gt.T
    ang = float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))
    return ang, float(np.linalg.norm(tr.t.double().cpu().numpy() - t_gt))


def rel_err(Ra, ta, Rb, tb, f_a, f_b):
    """Error (deg, m) of the relative pose a -> b of two world->cam poses
    against the synthetic GT of frames f_a -> f_b."""
    R_est = Rb @ Ra.T
    t_est = tb - R_est @ ta
    R_gt = f_b.R @ f_a.R.T
    t_gt = f_b.t - R_gt @ f_a.t
    c = (np.trace(R_est @ R_gt.T) - 1) / 2
    return (float(np.degrees(np.arccos(np.clip(c, -1, 1)))),
            float(np.linalg.norm(t_est - t_gt)))


def rig_config(rig, dataset_type, out_dir):
    """The CLI's config dict (reference YAML schema) for a StereoRig."""
    def cam(c):
        return {"resolution": [c.width, c.height],
                "intrinsics": [c.fx, c.fy, c.cx, c.cy],
                "distortion_coefficients": list(c.distortion[:4])}
    return {"dataset_type": dataset_type, "output_dir": out_dir,
            "left_camera": cam(rig.left), "right_camera": cam(rig.right),
            "stereo": {"R21": [list(r) for r in rig.R21],
                       "T21": list(rig.T21)}}


def distort_image(img, cam):
    """The distorted image whose undistortion gives `img` back (numpy):
    per distorted pixel, the normalised undistorted point by fixed-point
    iteration of the forward (k1, k2, p1, p2) model, then a bilinear sample
    of `img` there."""
    h, w = img.shape
    k1, k2, p1, p2 = cam.distortion[:4]
    jj, ii = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    xd, yd = (jj - cam.cx) / cam.fx, (ii - cam.cy) / cam.fy
    x, y = xd.copy(), yd.copy()
    for _ in range(10):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        x = (xd - 2.0 * p1 * x * y - p2 * (r2 + 2.0 * x * x)) / radial
        y = (yd - p1 * (r2 + 2.0 * y * y) - 2.0 * p2 * x * y) / radial
    sx = np.clip(x * cam.fx + cam.cx, 0, w - 1.001)
    sy = np.clip(y * cam.fy + cam.cy, 0, h - 1.001)
    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    a, b = sx - x0, sy - y0
    return ((1 - a) * (1 - b) * img[y0, x0] + a * (1 - b) * img[y0, x0 + 1]
            + (1 - a) * b * img[y0 + 1, x0] + a * b * img[y0 + 1, x0 + 1]
            ).astype(np.float32)


def samples_of(frames_gt, images, disparity=False):
    """In-memory StereoSamples: GT as cam->world, like every dataset."""
    from edge_based_visual_odometry_tpu_torch.io.datasets import StereoSample
    return [StereoSample(left=l, right=r, timestamp=float(k),
                         gt_R=f.R.T, gt_t=-f.R.T @ f.t, file_idx=k,
                         left_disparity=f.disparity if disparity else None)
            for k, (f, (l, r)) in enumerate(zip(frames_gt, images))]


def traj_arrays(pipe):
    return (torch.stack([p.R for p in pipe.trajectory]).double().cpu().numpy(),
            torch.stack([p.t for p in pipe.trajectory]).double().cpu().numpy())


class K3Watch:
    """While installed, counts over every call of K3's sides entry the
    active lanes whose delta is not finite and the lanes the singular-lane
    guard ended (done without a score after at least one iteration). The
    counts stay on the card until read, so the path gets no host sync;
    they cost a few small kernels a temporal step, inside the timed
    windows of the paths it watches (phase 6b times them: `lane_counts`)."""

    def __init__(self):
        from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
        self.GN, self.counts, self.orig = GN, [], None

    @staticmethod
    def lane_counts(res, done, active):
        """(non-finite deltas, guard-ended lanes) among the active lanes
        of one call's (S RefineResults, done (S, B)), on the card."""
        d = torch.stack([r.delta for r in res])
        sc = torch.stack([r.score for r in res])
        it = torch.stack([r.iters for r in res])
        return torch.stack([(~torch.isfinite(d).all(-1) & active).sum(),
                            (done & (sc == 1e6) & (it > 0) & active).sum()])

    def __enter__(self):
        orig = self.orig = self.GN.refine_2dof_sides_cuda

        def watched(kf_imgs, maps4, kpack, cpack, active, **kw):
            res, done = orig(kf_imgs, maps4, kpack, cpack, active, **kw)
            self.counts.append(self.lane_counts(res, done, active))
            return res, done
        self.GN.refine_2dof_sides_cuda = watched
        return self

    def __exit__(self, *exc):
        self.GN.refine_2dof_sides_cuda = self.orig

    def read(self, path):
        """(calls, non-finite, guard-ended) so far; fails on a non-finite
        delta."""
        tot = (torch.stack(self.counts).sum(0).tolist() if self.counts
               else [0, 0])
        check(tot[0] == 0, f"{path}: {tot[0]} active K3 lanes returned a "
                           f"non-finite delta")
        return len(self.counts), tot[0], tot[1]


def k3_side(kf_img, cf_img, cf_gx, cf_gy, kx, ky, ktheta, cx, cy, ctheta,
            d0, active, it0, it_stop, patch_size=7, max_iter=20, tol=1e-3,
            huber_delta=3.0, tile=32, maps4=None):
    """`refine_2dof_plain`'s contract on K3: its sides entry over one
    side, from an explicit d0, iterations [it0, it_stop). `maps4`: the
    side's interleaved CF maps, made here if None."""
    from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN

    if maps4 is None:
        maps4 = GN.interleave_maps(cf_img, cf_gx, cf_gy)
    out = GN.k3_outputs(1, kx.shape[0], kx.device)
    GN._k3_launch([kf_img], maps4[None], torch.stack([kx, ky, ktheta], -1),
                  torch.stack([cx, cy, ctheta], -1), active, out, it0,
                  it_stop, max_iter, patch_size, tol, huber_delta, tile,
                  d0=d0[None].contiguous())
    return GN.RefineResult(*(t[0] for t in out[:5])), out[5][0]


def k3_split_times(launch_args, kw, reps):
    """Device ms of K3's two launches on the main path and of the glue
    between them (the cumsum of `done` and the queue's zeroed counter),
    each from its own pair of CUDA events, mean of `reps` runs; the state
    after phase 1 (iters, done) and the (d, score, conf, valid, iters,
    done) buffers after phase 2."""
    from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN

    kfs, maps4, kpack, cpack, act = launch_args
    B = kpack.shape[0]
    lk = dict(max_iter=kw["max_iter"], patch_size=kw["patch_size"],
              tol=kw["tol"], huber_delta=kw["huber_delta"], tile=kw["tile"])
    p1 = kw["phase1_iters"]
    B2 = min(B, max(kw["chunk"], kw["phase2_budget"]))
    out = GN.k3_outputs(len(kfs), B, kpack.device)
    marks, after1 = [], None
    for r in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        GN._k3_launch(kfs, maps4, kpack, cpack, act, out, 0, p1, **lk)
        ev[1].record()
        if after1 is None:
            after1 = (out[4].clone(), out[5].clone())
        cum = torch.cumsum(out[5].view(-1), 0, dtype=torch.int32)
        counter = torch.zeros(1, dtype=torch.int32, device=kpack.device)
        ev[2].record()
        GN._k3_launch(kfs, maps4, kpack, cpack, act, out, p1, kw["max_iter"],
                      **lk, queue=(cum, B2, counter))
        ev[3].record()
        if r:                       # the first run warms up
            marks.append(ev)
    torch.cuda.synchronize()
    t = [sum(e[k].elapsed_time(e[k + 1]) for e in marks) / reps
         for k in range(3)]
    return dict(phase1=t[0], glue=t[1], phase2=t[2]), after1, B2, out


def phase_k3(k3_ops, card, H, W):
    """Phase 6b: K3 against its twin on the operands frame 2's temporal
    step gave `refine_2dof_pair_batch` (`k3_ops`: its (args, kwargs)),
    both sides: the both-sides launch as one 20-iteration launch and as
    the main path's two launches, against the plain twin and against the
    per-side form (`_two_phase`'s sort, gathers and merges around
    one-side launches); each form timed beside its bound, the per-side
    form, the twin and `K3Watch`'s counts timed. Returns the kernel's
    JSON entry."""
    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
    from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN

    (a3, kw3), = k3_ops
    kfs, maps4, kpack, cpack, act3 = [a3[0], a3[1]], a3[2], a3[3], a3[4], a3[5]
    kpack, cpack = kpack.contiguous(), cpack.contiguous()
    B3 = act3.shape[0]
    P3, mi3, p13 = kw3["patch_size"], kw3["max_iter"], kw3["phase1_iters"]
    g3 = dict(patch_size=P3, max_iter=mi3, tol=kw3["tol"],
              huber_delta=kw3["huber_delta"], tile=kw3["tile"])
    ph3 = dict(phase1_iters=p13, phase2_budget=kw3["phase2_budget"],
               max_iter=mi3, chunk=kw3["chunk"])
    names = ("left", "right")
    # each side's operands in the per-side form
    sides = []
    for s in range(2):
        imgs = (kfs[s], *(maps4[s, ..., k].contiguous() for k in range(3)))
        lanes = tuple(t[:, 3 * s + k].contiguous() for t in (kpack, cpack)
                      for k in range(3))
        d0 = torch.stack([lanes[0] - lanes[3], lanes[1] - lanes[4]], -1)
        sides.append((imgs, lanes, d0))

    # the both-sides launch as one 20-iteration launch, against the twin
    one, one_done = GN.refine_2dof_sides_cuda(kfs, maps4, kpack, cpack,
                                              act3, **g3)
    err = 0.0
    for s, (imgs, lanes, d0) in enumerate(sides):
        rp, dp = GN.refine_2dof_plain(*imgs, *lanes, d0, act3, 0, mi3, **g3)
        torch.cuda.synchronize()
        same_lanes((*one[s], one_done[s]), (*rp, dp), act3,
                   f"K3 {names[s]} side, both-sides {mi3}-iteration launch")
        err = max(err, float((one[s].delta - rp.delta).abs()[act3].max()))
    # the main path's two launches (refine_2dof_pair_batch), against the
    # twin's in-place form and against the per-side form on the kernel
    CB.reset_launch_counts()
    two = GN.refine_2dof_pair_batch(*a3, **kw3)
    torch.cuda.synchronize()
    check(CB.LAUNCHES["refine_2dof"] == 2,
          f"K3: {CB.LAUNCHES['refine_2dof']} launches for the two phases "
          f"of both sides")
    plains = []
    for s, (imgs, lanes, d0) in enumerate(sides):
        plain = GN._two_phase_in_place(
            lambda a, d, it0, it_stop, ac: GN.refine_2dof_plain(
                *imgs, *a, d, ac, it0, it_stop, **g3),
            B3, lanes, act3, d0, **ph3)
        old = GN._two_phase(recorder(k3_side, imgs, g3, [],
                                     maps4=maps4[s]), B3, lanes, act3, d0,
                            **ph3)
        torch.cuda.synchronize()
        same_lanes(two[s], plain[0], act3,
                   f"K3 {names[s]} side, two launches vs the twin")
        same_lanes(two[s], old, act3,
                   f"K3 {names[s]} side, two launches vs _two_phase over "
                   f"one-side launches")
        err = max(err, float((two[s].delta - plain[0].delta
                              ).abs()[act3].max()))
        plains.append(plain)

    # the both-sides forms: one 20-iteration launch, and the two launches
    # with the glue between them timed apart
    def both_work(iters_run, fact):
        w = [k3_work(iters_run[s], fact[s], P3, H, W) for s in range(2)]
        return sum(x[0] for x in w), sum(x[1] for x in w)

    k3 = {}
    it_one = (torch.stack([r.iters for r in one]).long()
              * act3).cpu().numpy()
    actn = np.stack([act3.cpu().numpy()] * 2)
    k3["both_one_launch_20"] = with_bound(
        cuda_ms(lambda: GN.refine_2dof_sides_cuda(kfs, maps4, kpack, cpack,
                                                  act3, **g3), 20),
        *both_work(it_one, actn), fma_free=True)
    t, (it1, done1), B2, out = k3_split_times(
        (kfs, maps4, kpack, cpack, act3), kw3, 20)
    # the buffers the main path's launches left, done included, against
    # the twin's in-place form
    for s, (plain, pdone) in enumerate(plains):
        same_lanes([u[s] for u in out], (*plain, pdone), act3,
                   f"K3 {names[s]} side, state after phase 2 (done "
                   f"included) vs the twin")
    sel = GN.phase2_lanes(done1, B2)
    run1 = (it1.long() * act3).cpu().numpy()
    run2 = ((out[4].long() - p13).clamp(min=0) * sel).cpu().numpy()
    k3["both_phase1"] = with_bound(t["phase1"], *both_work(run1, actn),
                                   fma_free=True)
    k3["both_phase2"] = with_bound(t["phase2"], *both_work(
        run2, sel.cpu().numpy()), fma_free=True)
    main = with_bound(t["phase1"] + t["phase2"],
                      *both_work(run1 + run2, actn), fma_free=True)
    ms_inter = cuda_ms(lambda: GN.interleave_pair_maps(
        *((maps4[s, ..., 0], maps4[s, ..., 1], maps4[s, ..., 2])
          for s in range(2))), 50)
    ms_pair = cuda_ms(lambda: GN.refine_2dof_pair_batch(*a3, **kw3), 20)
    ms_watch = cuda_ms(lambda: K3Watch.lane_counts(one, one_done, act3), 50)

    def old_step():
        for imgs, lanes, d0 in sides:
            m4 = GN.interleave_maps(*imgs[1:])
            GN._two_phase(recorder(k3_side, imgs, g3, [], maps4=m4), B3,
                          lanes, act3, d0, **ph3)
    # the per-side form does the main path's lane-iterations: its bound
    k3["per_side_form"] = with_bound(cuda_ms(old_step, 20),
                                     *both_work(run1 + run2, actn),
                                     fma_free=True)
    ms_old = k3["per_side_form"]["ms"]
    # the pair interleave reads 3 maps and writes one 16-byte map a side
    inter = with_bound(ms_inter, 0, 2 * H * W * (3 * 4 + 16))
    ms_plain = cuda_ms(lambda: [GN._two_phase_in_place(
        lambda a, d, it0, it_stop, ac, imgs=imgs: GN.refine_2dof_plain(
            *imgs, *a, d, ac, it0, it_stop, **g3),
        B3, lanes, act3, d0, **ph3) for imgs, lanes, d0 in sides], 1)
    info = GN.k3_info()
    for form, row in k3.items():
        print(f"K3 {form}: {row['ms']:.4f} ms; bound "
              f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}), "
              f"{row['pct_of_bound']:.1f}% of it; FMA-free bound "
              f"{row['bound_ms_no_fma'] * 1e3:.1f} us, "
              f"{row['pct_of_bound_no_fma']:.1f}% of it")
    n_sel = int(sel.sum())
    print(f"K3 both sides (B={B3} a side, active {int(act3.sum())}, phase 2 "
          f"on {n_sel} lanes picked on the device, budget {B2} a side): "
          f"bit-equal to its twin on every active lane, as one launch and as "
          f"two launches (done included), and to _two_phase over one-side "
          f"launches")
    print(f"K3 refine_2dof: a temporal step's two launches "
          f"{main['ms']:.4f} ms (phase 1 {t['phase1']:.4f} + phase 2 "
          f"{t['phase2']:.4f}), {main['pct_of_bound']:.1f}% of their "
          f"{main['bound_ms'] * 1e3:.1f} us bound; glue between them "
          f"(cumsum, counter) {t['glue']:.4f} ms; pair interleave "
          f"{ms_inter:.4f} ms ({inter['pct_of_bound']:.1f}% of its "
          f"{inter['bound_ms'] * 1e3:.1f} us bound, bytes); "
          f"refine_2dof_pair_batch whole {ms_pair:.4f} "
          f"ms; the per-side form (4 one-side launches, 2 interleaves, "
          f"sort, gathers, merges) {ms_old:.4f} ms; plain twin (both "
          f"sides, two phases in place) {ms_plain:.1f} ms; K3Watch's counts "
          f"{ms_watch:.4f} ms a call [{card}]")
    print(f"K3 registers / spill bytes / blocks an SM / warps an SM: direct "
          f"(phase 1) {info['direct_registers']} / "
          f"{info['direct_local_bytes']} / {info['direct_blocks_per_sm']} / "
          f"{info['direct_warps_per_sm']}; queue (phase 2) "
          f"{info['queue_registers']} / {info['queue_local_bytes']} / "
          f"{info['queue_blocks_per_sm']} / {info['queue_warps_per_sm']} "
          f"({info['warps_per_block']} warps a block; "
          f"cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    return dict(
        name="refine_2dof", route="cuda",
        source="edge_based_visual_odometry_tpu_torch/csrc/gn_2dof.cu",
        replaces="edge_based_visual_odometry_tpu/ops/gauss_newton.py:387",
        max_abs_err=err, plain_ms=ms_plain, library_ms=None,
        maps_interleave_ms=ms_inter, step_launches_ms=main["ms"],
        glue_ms=t["glue"], pair_batch_ms=ms_pair, per_side_form_ms=ms_old,
        watch_ms=ms_watch, phase2_lanes=n_sel, occupancy=info, **main,
        forms={f: {k: r[k] for k in (
            "ms", "bound_ms", "bound_by", "pct_of_bound", "bound_ms_no_fma",
            "pct_of_bound_no_fma") if k in r} for f, r in k3.items()})


def phase_k4(cl_ops, card):
    """Phase 6c: K4 against its twin run on the card, bit for bit, on the
    operands frame 2's stereo and temporal steps gave `cluster_edges`
    (`cl_ops`: kind -> (args, kwargs)); each call timed with CUDA events
    beside its bound, and the twin timed; its rows counted by active
    slots and by the sums' path. Also holds K4 against the JAX package's
    outputs (`k4_against_jax`). Returns the kernel's JSON entry, its times
    and bound those of a frame's two calls."""
    from edge_based_visual_odometry_tpu_torch.ops import clustering as CL

    calls, err = {}, 0.0
    for kind in ("stereo", "temporal"):
        check(kind in cl_ops, f"K4: no {kind} call of cluster_edges recorded")
        a, kw = cl_ops[kind]
        N, C = a[0].shape
        k = CL.cluster_edges_cuda(*a, **kw)
        p = CL.cluster_edges_plain(*a, **kw)
        torch.cuda.synchronize()
        err = max(err, same_cluster(k, p, f"K4 {kind} call ({N} x {C})"))
        row = with_bound(cuda_ms(lambda: CL.cluster_edges_cuda(*a, **kw), 50),
                         *k4_work(a[3], kw["by_orientation"],
                                  kw["max_cluster_size"]))
        n = a[3].sum(1)
        ok = ((a[0].abs() <= 2.0 ** 62) & (a[1].abs() <= 2.0 ** 62)
              & a[2].isfinite()).all(1)
        row.update(plain_ms=cuda_ms(lambda: CL.cluster_edges_plain(*a, **kw),
                                    3),
                   rows=N, slots=C, active=int(n.sum()),
                   clusters=int(k.mask.sum()),
                   rows_by_active={"0": int((n == 0).sum()),
                                   "1-8": int(((n > 0) & (n <= 8)).sum()),
                                   "9+": int((n > 8).sum())},
                   rows_every_slot=int((~ok).sum()))
        calls[kind] = row
        print(f"K4 cluster_edges, {kind} call ({N} x {C}, "
              f"{row['active']} active slots, rows with 0 / 1-8 / 9+ active "
              f"slots {' / '.join(map(str, row['rows_by_active'].values()))}"
              f", {row['rows_every_slot']} rows whose sums add every slot, "
              f"{row['clusters']} clusters, "
              f"orientation gate {kw['by_orientation']}, cap "
              f"{kw['max_cluster_size']}): bit-equal to its twin on the card "
              f"(label, mask, members, x, y, theta); kernel {row['ms']:.4f} "
              f"ms, twin {row['plain_ms']:.3f} ms; bound "
              f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}: "
              f"{row['flops']} flop, {row['bytes']} B), "
              f"{row['pct_of_bound']:.1f}% of it [{card}]")
    jax_cmp = k4_against_jax(a[0].device)
    for name, (n_bad, n_nan, ulps) in jax_cmp.items():
        print(f"K4 against JAX's cluster_edges, case {name} (64 x 32): "
              f"label / mask / members differ at {n_bad} entries, NaN in "
              f"one only at {n_nan}, x / y / theta at most {ulps:.1f} ulp")
        check(n_bad == 0 and n_nan == 0 and ulps <= K4_JAX_ULPS,
              f"K4 case {name}: {n_bad} label / mask / members entries and "
              f"{n_nan} NaN differ from JAX's, or {ulps} ulp > {K4_JAX_ULPS}")
    frame = with_bound(sum(r["ms"] for r in calls.values()),
                       sum(r["flops"] for r in calls.values()),
                       sum(r["bytes"] for r in calls.values()))
    return dict(
        name="cluster_edges", route="cuda",
        source="edge_based_visual_odometry_tpu_torch/csrc/cluster_edges.cu",
        replaces="edge_based_visual_odometry_tpu/ops/clustering.py:42",
        max_abs_err=err, library_ms=None,
        plain_ms=sum(r["plain_ms"] for r in calls.values()), calls=calls,
        against_jax_max_ulps=max(u for _, _, u in jax_cmp.values()), **frame)


def bf16_differ(a, b):
    """Entries of two bf16 tensors whose bit patterns differ (a NaN equals
    a NaN), and the largest difference over the finite ones in units of
    one bf16 ulp of max(|a|, |b|, 1)."""
    ne = ((a.view(torch.int16) != b.view(torch.int16))
          & ~(a.isnan() & b.isnan()))
    u, v = a.float(), b.float()
    fin = u.isfinite() & v.isfinite()
    mag = torch.clamp(torch.maximum(u.abs(), v.abs()), min=1.0)
    ulps = (u - v).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return int(ne.sum()), float(ulps[fin].max()) if bool(fin.any()) else 0.0


def bf16_ulps(a, b):
    """Entries of two bf16 tensors that are NaN in one only, or that differ
    by more than one bf16 ulp of max(|a|, |b|, 1) (the CPU tests' tolerance
    against JAX), and the largest difference in those ulps."""
    u, v = a.float(), b.float()
    nan = u.isnan() | v.isnan()
    mag = torch.clamp(torch.maximum(u.abs(), v.abs()), min=1.0)
    ulps = torch.where(nan | (u == v), 0.0, (u - v).abs()
                       / torch.exp2(torch.floor(torch.log2(mag)) - 7))
    bad = (u.isnan() != v.isnan()) | ~(ulps <= 1)
    return int(bad.sum()), float(ulps.max()) if ulps.numel() else 0.0


def k5_against_jax(dev):
    """K5 on the card against the JAX package's outputs on every case of
    `tests/descriptor_cases.py` at 64 edges (`tests/data/
    k5_jax_reference.npz`): {case: (entries past 1 bf16 ulp or NaN in one
    only, the largest difference in ulps)}."""
    from edge_based_visual_odometry_tpu_torch.ops import descriptors as DESC
    from scripts import k5_jax_reference as KJ
    from tests import descriptor_cases as DC

    res = {}
    with np.load(KJ.PATH) as refs:
        for name in DC.CASES:
            maps, edges, kw = DC.case(name, KJ.N_EDGES)
            k = DESC.edge_descriptors_cuda(
                *(torch.from_numpy(a).to(dev) for a in maps + edges), **kw)
            ref = torch.from_numpy(refs[name].astype(np.int16)).view(
                torch.bfloat16)
            res[name] = bf16_ulps(k.cpu(), ref)
    return res


def phase_k5(desc_ops, card):
    """Phase 6d: K5 against its twin run on the card, bit for bit (bf16 bit
    patterns, a NaN equal to a NaN), on the operands of the three
    `edge_descriptors` calls of frame 2's stereo step (`desc_ops`: (args,
    kwargs) of each); each call timed with CUDA events beside its bound,
    and the twin timed. Returns the kernel's JSON entry, its times and
    bound those of a stereo step's three calls. Also prints what the built
    kernel is on the card (registers, spills, shared memory, warps an SM)
    and holds it against the JAX package's outputs (`k5_against_jax`)."""
    from edge_based_visual_odometry_tpu_torch.ops import descriptors as DESC

    check(len(desc_ops) == 3, f"K5: {len(desc_ops)} calls of edge_descriptors "
                              f"recorded in frame 2's stereo step, not 3")
    info = DESC.k5_info()
    print(f"K5 build: {info['registers']} registers and {info['local_bytes']}"
          f" B of local memory (stack) a thread, {info['shared_bytes']} B of "
          f"shared memory a "
          f"block of {info['warps_per_block']} warps, {info['blocks_per_sm']} "
          f"blocks ({info['warps_per_sm']} warps) an SM [{card}]")
    jax_cmp = k5_against_jax(desc_ops[0][0][0].device)
    for name, (n_bad, ulps) in jax_cmp.items():
        print(f"K5 against JAX's edge_descriptors_tiled, case {name} (64 "
              f"edges): {n_bad} entries past 1 bf16 ulp, at most {ulps:.2f} "
              f"ulp")
        check(n_bad == 0, f"K5 case {name}: {n_bad} entries differ from "
                          f"JAX's by more than 1 bf16 ulp")

    calls, err = {}, 0.0
    for name, (a, kw) in zip(("left edges", "right edges", "mates"),
                             desc_ops):
        N = a[2].shape[0]
        H, W = a[0].shape
        k = DESC.edge_descriptors_cuda(*a, **kw)
        p = DESC.edge_descriptors_plain(*a, **kw)
        torch.cuda.synchronize()
        check(k.shape == (N, 256) and k.dtype == torch.bfloat16,
              f"K5 {name}: output {tuple(k.shape)} {k.dtype}")
        n_bad, ulps = bf16_differ(k, p)
        check(n_bad == 0, f"K5 {name} call ({N} edges): {n_bad} bf16 entries "
                          f"differ from the twin, at most {ulps:.2f} bf16 ulp")
        fin = k.isfinite() & p.isfinite()
        err = max(err, float((k.float() - p.float()).abs()[fin].max()))
        S = kw["n_samples"] ** 2
        SP = DESC._static_tables(kw["n_samples"], kw["n_spatial"],
                                 kw["spacing"], k.device)[3]
        nonzero = int((SP != 0).sum())
        row = with_bound(
            cuda_ms(lambda: DESC.edge_descriptors_cuda(*a, **kw), 20),
            *k5_work(2 * N, S, nonzero, H, W), fma_free=True)
        row.update(plain_ms=cuda_ms(
            lambda: DESC.edge_descriptors_plain(*a, **kw), 2),
            edges=N, keypoints=2 * N, nonzero_weights=nonzero,
            nan_rows=int(k.isnan().any(1).sum()))
        calls[name] = row
        print(f"K5 edge_descriptors, {name} ({N} edges, {2 * N} keypoints, "
              f"{S} samples, {nonzero} nonzero spatial weights, "
              f"{row['nan_rows']} rows with NaN): bit-equal to its twin on the "
              f"card (bf16 bits); kernel {row['ms']:.4f} ms, twin "
              f"{row['plain_ms']:.3f} ms; bound {row['bound_ms'] * 1e3:.1f} us "
              f"({row['bound_by']}: {row['flops']} flop, {row['bytes']} B), "
              f"{row['pct_of_bound']:.1f}% of it, FMA-free bound "
              f"{row['bound_ms_no_fma'] * 1e3:.1f} us, "
              f"{row['pct_of_bound_no_fma']:.1f}% of it [{card}]")
    step = with_bound(sum(r["ms"] for r in calls.values()),
                      sum(r["flops"] for r in calls.values()),
                      sum(r["bytes"] for r in calls.values()), fma_free=True)
    print(f"K5 a stereo step's three calls: {step['ms']:.4f} ms, "
          f"{step['pct_of_bound']:.1f}% of {step['bound_ms'] * 1e3:.1f} us "
          f"({step['pct_of_bound_no_fma']:.1f}% of the FMA-free "
          f"{step['bound_ms_no_fma'] * 1e3:.1f} us); twin "
          f"{sum(r['plain_ms'] for r in calls.values()):.2f} ms [{card}]")
    return dict(
        name="edge_descriptors", route="cuda",
        source="edge_based_visual_odometry_tpu_torch/csrc/edge_descriptors.cu",
        replaces="edge_based_visual_odometry_tpu/ops/descriptors.py:114",
        max_abs_err=err, library_ms=None,
        plain_ms=sum(r["plain_ms"] for r in calls.values()), calls=calls,
        info=info, against_jax_max_ulps=max(u for _, u in jax_cmp.values()),
        **step)


def gate_tensors(case, dev):
    """A case of tests/gate_cases.py (numpy) as tensors on `dev`, the
    descriptors and the CF patches in bf16."""
    out = {}
    for k, v in case.items():
        v = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        out[k] = v.to(torch.bfloat16) if "desc" in k or k == "cf_pat" else v
    return out


def k6_args(kind, t, patch_size=None):
    """(args, kwargs) of K6's `kind` entry ("stereo", "temporal", "flat")
    on a gate case's tensors (made at `patch_size`, the cases' P = 7 if
    None), with the fills the cascades use."""
    from tests import gate_cases as GC

    P = GC.P if patch_size is None else patch_size
    if kind == "stereo":
        return ((t["l_desc"], t["r_desc"], t["cand"], t["cmask"], t["l_pat"],
                 t["l_ok"], t["r_pat"], t["r_ok"], GC.SIFT, P),
                dict(fill_dist=2 * GC.SIFT, fill_ncc=0.0))
    if kind == "temporal":
        return ((t["kf_pat_l"], t["kf_ok_l"], t["kf_pat_r"], t["kf_ok_r"],
                 t["kf_desc_l"], t["kf_desc_r"], t["cf_pat"], t["cf_ok"],
                 t["cf_desc"], t["cf_idx"], t["cmask"], P),
                dict(fill_ncc=-1.0, fill_dist=900.0))
    assert kind == "flat", kind
    return ((t["l_pat"], t["l_ok"], t["rows"], t["r_pat"], t["r_ok"],
             t["live"], P), dict(fill=0.6 + 1e-6))


def k6_against_jax(dev):
    """K6 on the card against the JAX package's `min_cross_distance_dot`
    and `ncc4` on every case of `tests/gate_cases.py`
    (`tests/data/k6_k7_jax_reference.npz`): {case: (entries past the CPU
    tests' tolerance, the largest distance and NCC differences)}; the
    distances within 0.05 on the live slots, the NCC within 1e-5 of
    max(1, |b|) on the pairs it computed."""
    from edge_based_visual_odometry_tpu_torch.ops import patches as PAT
    from scripts import k6_k7_jax_reference as KJ
    from tests import gate_cases as GC

    res = {}
    with np.load(KJ.PATH) as ref:
        for name in GC.GATE_CASES:
            s = GC.stereo_case(name)
            a, kw = k6_args("stereo", gate_tensors(s, dev))
            d, n = (x.cpu().numpy() for x in PAT.dense_gates_stereo_cuda(*a,
                                                                        **kw))
            f = GC.flat_case(name)
            a, kw = k6_args("flat", gate_tensors(f, dev))
            fl = PAT.dense_gates_flat_cuda(*a, **kw).cpu().numpy()
            tc = GC.temporal_case(name)
            a, kw = k6_args("temporal", gate_tensors(tc, dev))
            tm = PAT.dense_gates_temporal_cuda(*a, **kw).cpu().numpy()
            rd, rn = ref[f"stereo/{name}/dist"], ref[f"stereo/{name}/ncc"]
            rt = ref[f"temporal/{name}"]
            live, tlive = s["cmask"], tc["cmask"]
            errs = [gate_errors(d, rd, live, 0.05),
                    gate_errors(n, rn, live & (d < GC.SIFT), 1e-5, True),
                    gate_errors(fl, rn.reshape(-1), f["live"], 1e-5, True)]
            errs += [gate_errors(tm[q], rt[q], tlive, 1e-5, True)
                     for q in (0, 1)]
            errs += [gate_errors(tm[q], rt[q], tlive, 0.05) for q in (2, 3)]
            res[name] = (sum(e[0] for e in errs),
                         max(errs[0][1], errs[5][1], errs[6][1]),
                         max(errs[1][1], errs[2][1], errs[3][1],
                             errs[4][1]))
    return res


def k7_against_jax(dev):
    """K7 on the card against the JAX package's `edge_patches_tiled` on
    every patch case of `tests/gate_cases.py` (the same file): {case:
    (values past 1e-5 of max(1, |b|) or NaN in one only, the largest
    difference, ok flags that differ)}."""
    from edge_based_visual_odometry_tpu_torch.ops import patches as PAT
    from scripts import k6_k7_jax_reference as KJ
    from tests import gate_cases as GC

    res = {}
    with np.load(KJ.PATH) as ref:
        for name in GC.PATCH_CASES:
            img, edges = GC.patch_case(name)
            pat, ok = (x.cpu().numpy() for x in PAT.edge_patches_cuda(
                *(torch.from_numpy(a).to(dev) for a in (img, *edges)),
                GC.P, GC.SHIFT))
            n_bad, err = gate_errors(pat, ref[f"patches/{name}/pat"],
                                     np.ones(pat.shape, bool), 1e-5, True)
            res[name] = (n_bad, err,
                         int((ok != ref[f"patches/{name}/ok"]).sum()))
    return res


def f32_differ(a, b):
    """Entries of two float32 tensors whose bit patterns differ (a NaN
    equals a NaN)."""
    return int(((a.view(torch.int32) != b.view(torch.int32))
                & ~(a.isnan() & b.isnan())).sum())


K6_ENTRIES = ("stereo", "flat", "temporal")


def k6_call(kind, a, kw, what="K6"):
    """K6's `kind` entry ("stereo", "flat", "temporal") on the operands
    (a, kw) against its twin run on the card: fails unless every slot is
    bit-equal and the slots not computed hold their fill. Returns (kernel
    output, twin output, its (flops, bytes) (`k6_work`), the call's
    counts)."""
    from edge_based_visual_odometry_tpu_torch.ops import patches as PAT

    kern = getattr(PAT, f"dense_gates_{kind}_cuda")
    twin = getattr(PAT, f"dense_gates_{kind}_plain")
    k, p = kern(*a, **kw), twin(*a, **kw)
    torch.cuda.synchronize()
    k, p = (torch.stack(x) if isinstance(x, tuple) else x for x in (k, p))
    n_bad = f32_differ(k, p)
    check(n_bad == 0, f"{what} {kind} call: {n_bad} of {k.numel()} values "
                      f"not bit-equal to the twin")
    if kind == "stereo":
        live, pp = a[3], a[9] * a[9]
        surv = live & (k[0] < a[8])
        fills = ((k[0] == kw["fill_dist"]) | live).all() & (
            (k[1] == kw["fill_ncc"]) | surv).all()
        work = k6_work("stereo", live, pp, a[2], surv)
        detail = dict(rows=live.shape[0], slots=live.shape[1],
                      live=int(live.sum()), ncc_pairs=int(surv.sum()))
    elif kind == "flat":
        live, pp = a[5], a[6] * a[6]
        fills = ((k == kw["fill"]) | live).all()
        work = k6_work("flat", live, pp, a[2])
        detail = dict(pairs=live.shape[0], live=int(live.sum()))
    else:
        live, pp = a[10], a[11] * a[11]
        fills = ((k[:2] == kw["fill_ncc"]) | live).all() & (
            (k[2:] == kw["fill_dist"]) | live).all()
        work = k6_work("temporal", live, pp, a[9])
        detail = dict(rows=live.shape[0], slots=live.shape[1],
                      live=int(live.sum()))
    check(bool(fills), f"{what} {kind} call: a slot not computed lost its "
                       f"fill")
    return k, p, work, detail


def phase_k6(gate_ops, card):
    """Phase 6e: K6 against its twins run on the card, bit for bit on every
    slot, on the operands of frame 2's three calls (`gate_ops`: kind ->
    (args, kwargs)): stages 4-5 and stage 11 of its stereo step, its
    temporal step; the slots not computed hold their fill. Each call timed
    with CUDA events beside its bound (`k6_work`) and the twin; K6 against
    the JAX package (`k6_against_jax`). Returns the kernel's JSON entry,
    its times and bound those of a frame's three calls."""
    from edge_based_visual_odometry_tpu_torch.ops import patches as PAT

    entries = {kind: (getattr(PAT, f"dense_gates_{kind}_cuda"),
                      getattr(PAT, f"dense_gates_{kind}_plain"))
               for kind in K6_ENTRIES}
    calls, err = {}, 0.0
    for kind, (kern, twin) in entries.items():
        check(kind in gate_ops, f"K6: no {kind} call recorded in frame 2")
        a, kw = gate_ops[kind]
        k, p, work, detail = k6_call(kind, a, kw)
        fin = k.isfinite() & p.isfinite()
        if bool(fin.any()):
            err = max(err, float((k - p).abs()[fin].max()))
        row = launch_bound(cuda_ms(lambda: kern(*a, **kw), 20),
                           graph_ms(lambda: kern(*a, **kw), 20), *work)
        row.update(plain_ms=cuda_ms(lambda: twin(*a, **kw), 2), **detail)
        calls[kind] = row
        print(f"K6 dense_gates, {kind} call ({detail}): bit-equal to its "
              f"twin on the card on every slot, fills kept; kernel "
              f"{row['launch_ms']:.4f} ms launched alone, {row['ms']:.4f} "
              f"ms with its wrapper, twin {row['plain_ms']:.3f} ms; bound "
              f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}: "
              f"{row['flops']} flop, {row['bytes']} B), "
              f"{row['pct_of_bound']:.1f}% of it alone, "
              f"{row['pct_of_bound_with_wrapper']:.1f}% with the wrapper "
              f"[{card}]")
    info = PAT.k6_info()
    for name in PAT.K6_KERNELS:
        i = info[name]
        print(f"K6 {name} kernel: {i['registers']} registers, "
              f"{i['local_bytes']} local (spill) bytes, "
              f"{i['shared_bytes']} B shared a block, {i['warps_per_sm']} "
              f"warps an SM; {info['slots_a_step']} slots a warp step")
        check(i["local_bytes"] == 0, f"K6 {name} kernel spills")
    jax_cmp = k6_against_jax(gate_ops["stereo"][0][0].device)
    for name, (n_bad, d_err, n_err) in jax_cmp.items():
        print(f"K6 against JAX's min_cross_distance_dot / ncc4, case {name}: "
              f"{n_bad} entries past the tolerance (distance 0.05, NCC "
              f"1e-5); distances at most {d_err:.3g} apart, NCC "
              f"{n_err:.3g}")
        check(n_bad == 0, f"K6 case {name}: {n_bad} entries differ from "
                          f"JAX's past the tolerance")
    frame = launch_bound(*(sum(r[k] for r in calls.values()) for k in (
        "ms", "launch_ms", "flops", "bytes")))
    print(f"K6 a frame's three calls: {frame['launch_ms']:.4f} ms launched "
          f"alone, {frame['ms']:.4f} ms with the wrapper; "
          f"{frame['pct_of_bound']:.1f}% of {frame['bound_ms'] * 1e3:.1f} us "
          f"alone, {frame['pct_of_bound_with_wrapper']:.1f}% with the "
          f"wrapper; twin {sum(r['plain_ms'] for r in calls.values()):.2f} "
          f"ms [{card}]")
    return dict(
        name="dense_gates", route="cuda",
        source="edge_based_visual_odometry_tpu_torch/csrc/dense_gates.cu",
        replaces="edge_based_visual_odometry_tpu/ops/patches.py:186",
        max_abs_err=err, library_ms=None,
        plain_ms=sum(r["plain_ms"] for r in calls.values()), calls=calls,
        info=info,
        against_jax_max_err={"distance": max(v[1] for v in jax_cmp.values()),
                             "ncc": max(v[2] for v in jax_cmp.values())},
        **frame)


K7_CALLS = ("left edges", "right edges", "stage-11 centres", "mates")


def k7_call(name, a, kw, what="K7"):
    """K7 on one recorded `edge_patches_flat` call (a, kw) of a stereo
    step (`name` of `K7_CALLS`) against its twin run on the card: fails
    unless the patches and ok flags of the live edges are bit-equal
    (stage 11's call alone has a live mask). Returns (kernel (patches,
    ok), twin (patches, ok), edges, live edges, (flops, bytes)
    (`k7_work`))."""
    from edge_based_visual_odometry_tpu_torch.ops import patches as PAT

    B = a[1].shape[0]
    H, W = a[0].shape
    pp = a[4] * a[4]
    live = kw.get("live")
    twin_kw = {k_: v for k_, v in kw.items() if k_ != "live"}
    check((live is not None) == (name == "stage-11 centres"),
          f"{what} {name} call: a live mask "
          f"{'missing' if live is None else 'given'}")
    k = PAT.edge_patches_cuda(*a, **kw)
    p = PAT.edge_patches_plain(*a, **twin_kw)
    torch.cuda.synchronize()
    if live is not None:         # a dead entry's row is unspecified
        k, p = (k[0][live], k[1][live]), (p[0][live], p[1][live])
    n_bad = f32_differ(k[0], p[0]) + int((k[1] != p[1]).sum())
    n_live = B if live is None else int(live.sum())
    check(n_bad == 0, f"{what} {name} call ({n_live} of {B} edges): "
                      f"{n_bad} values or flags differ from the twin")
    return k, p, B, n_live, k7_work(B, pp, H, W, live)


def phase_k7(patch_ops, card):
    """Phase 6f: K7 against its twin run on the card, bit for bit, on the
    operands of the four `edge_patches_flat` calls of frame 2's stereo
    step (`patch_ops`: (args, kwargs) of each); each call timed beside its
    bound (`k7_work`) and the twin; K7 against the JAX package
    (`k7_against_jax`). Returns the kernel's JSON entry, its times and
    bound those of a stereo step's four calls."""
    from edge_based_visual_odometry_tpu_torch.ops import patches as PAT

    check(len(patch_ops) == 4, f"K7: {len(patch_ops)} calls of edge_patches "
                               f"recorded in frame 2's stereo step, not 4")
    calls, err = {}, 0.0
    for name, (a, kw) in zip(K7_CALLS, patch_ops):
        k, p, B, n_live, work = k7_call(name, a, kw)
        twin_kw = {k_: v for k_, v in kw.items() if k_ != "live"}
        fin = k[0].isfinite()
        if bool(fin.any()):
            err = max(err, float((k[0] - p[0]).abs()[fin].max()))
        row = launch_bound(
            cuda_ms(lambda: PAT.edge_patches_cuda(*a, **kw), 20),
            graph_ms(lambda: PAT.edge_patches_cuda(*a, **kw), 20),
            *work)
        row.update(plain_ms=cuda_ms(
            lambda: PAT.edge_patches_plain(*a, **twin_kw), 2),
            edges=B, live=n_live, ok_sides=int(k[1].sum()))
        calls[name] = row
        print(f"K7 edge_patches, {name} ({n_live} live of {B} edges, "
              f"{row['ok_sides']} sides ok): bit-equal to its twin on the "
              f"card on the live edges; kernel "
              f"{row['launch_ms']:.4f} ms launched alone, {row['ms']:.4f} "
              f"ms with its wrapper, twin {row['plain_ms']:.3f} ms; bound "
              f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}: "
              f"{row['flops']} flop, {row['bytes']} B), "
              f"{row['pct_of_bound']:.1f}% of it alone, "
              f"{row['pct_of_bound_with_wrapper']:.1f}% with the wrapper "
              f"[{card}]")
    info = PAT.k7_info()
    print(f"K7 kernel: {info['registers']} registers, {info['local_bytes']} "
          f"local bytes (sinf's and cosf's argument reduction), "
          f"{info['shared_bytes']} B shared a block of "
          f"{info['edges_per_block']} edges, {info['warps_per_sm']} warps an "
          f"SM")
    jax_cmp = k7_against_jax(patch_ops[0][0][0].device)
    for name, (n_bad, e, n_ok) in jax_cmp.items():
        print(f"K7 against JAX's edge_patches_tiled, case {name}: {n_bad} "
              f"values past 1e-5 of max(1, |b|) (at most {e:.3g} apart), "
              f"{n_ok} ok flags differ")
        check(n_bad == 0 and n_ok == 0,
              f"K7 case {name}: {n_bad} values and {n_ok} flags differ from "
              f"JAX's")
    step = launch_bound(*(sum(r[k] for r in calls.values()) for k in (
        "ms", "launch_ms", "flops", "bytes")))
    print(f"K7 a stereo step's four calls: {step['launch_ms']:.4f} ms "
          f"launched alone, {step['ms']:.4f} ms with the wrapper; "
          f"{step['pct_of_bound']:.1f}% of {step['bound_ms'] * 1e3:.1f} us "
          f"alone, {step['pct_of_bound_with_wrapper']:.1f}% with the "
          f"wrapper; twin {sum(r['plain_ms'] for r in calls.values()):.2f} ms "
          f"[{card}]")
    return dict(
        name="edge_patches", route="cuda",
        source="edge_based_visual_odometry_tpu_torch/csrc/edge_patches.cu",
        replaces="edge_based_visual_odometry_tpu/ops/patches.py:125",
        max_abs_err=err, library_ms=None,
        plain_ms=sum(r["plain_ms"] for r in calls.values()), calls=calls,
        info=info, against_jax_max_err=max(v[1] for v in jax_cmp.values()),
        **step)


K8_CALLS = ("prescore", "full count")


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


def wall_ms(fn, reps):
    """Mean host ms of `fn` between two synchronisations, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def sync_count(fn):
    """How many times `fn` makes the host wait for the card (PyTorch's
    sync debug warnings)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def singular_on_card(dev):
    """The singular refinement case (tests/pose_cases.py) through
    `estimate_pose` on the card and on the CPU with the same draws: fails
    unless the card returns `success`, 2 inliers and a finite pose within
    1e-4 of the CPU's. Returns the seeds."""
    from edge_based_visual_odometry_tpu_torch.config import VOConfig
    from edge_based_visual_odometry_tpu_torch.io import synthetic as S
    from edge_based_visual_odometry_tpu_torch.models import motion_tracker as MT
    from edge_based_visual_odometry_tpu_torch.models import types as TY
    from tests import pose_cases as PC

    cfg = VOConfig(**PC.SINGULAR_CFG)
    draws = np.arange(cfg.ransac_max_iterations) % 2
    for seed in PC.SINGULAR_SEEDS:
        res = {}
        for d in ("cpu", dev):
            pq = MT.PoseQuads(**{k: torch.as_tensor(np.array(v)).to(d)
                                 for k, v in PC.singular_quads(seed).items()})
            res[str(d)] = MT.estimate_pose(
                pq, TY.rig_arrays_from_rig(S.default_rig(120, 160), d), cfg,
                idx=(draws, 1 - draws))
        c, g = res["cpu"], res[str(dev)]
        check(bool(g.success) and int(g.inlier_count) == 2
              and bool(torch.isfinite(g.R).all() and torch.isfinite(g.t).all()),
              f"singular case {seed} on the card: success {bool(g.success)}, "
              f"{int(g.inlier_count)} inliers, R {g.R.tolist()}")
        err = max(float((g.R.cpu() - c.R).abs().max()),
                  float((g.t.cpu() - c.t).abs().max()))
        check(err <= 1e-4, f"singular case {seed}: card and CPU poses "
                           f"{err:.3g} apart")
    return PC.SINGULAR_SEEDS


def phase_pose(k8_ops, k9_ops, est_args, card):
    """Phase 6h: K8 and K9 against their twins run on the card, bit for
    bit, on the operands of frame 2's two `ransac_counts` calls (the
    prescore and the full count) and four `pose_gn_normal_equations`
    calls (the refinement steps), each timed with its wrapper and launched
    alone beside its bound (`k8_work`, `k9_work`) and the twin; frame 2's
    `estimate_pose` on the kernels against the same on the twins (R, t
    and the inlier count identical), both timed, with no wait for the card
    in the call (`sync_count`) and its refinement steps run with the
    card's sync check set to raise; the singular case on the card
    (`singular_on_card`). Returns the kernels' JSON entries, each with the
    times and bound of a temporal step's calls."""
    from edge_based_visual_odometry_tpu_torch.models import motion_tracker as MT
    from edge_based_visual_odometry_tpu_torch.ops import pose as POSE

    check(len(k8_ops) == 2, f"K8: {len(k8_ops)} ransac_counts calls "
                            f"recorded in frame 2's temporal step, not 2")
    check(len(k9_ops) == 4, f"K9: {len(k9_ops)} pose_gn_normal_equations "
                            f"calls recorded in frame 2's temporal step, "
                            f"not 4")
    calls = {}
    for name, (a, kw) in zip(K8_CALLS, k8_ops):
        k = POSE.ransac_counts_cuda(*a, **kw)
        p = POSE.ransac_counts_plain(*a, **kw)
        torch.cuda.synchronize()
        n_bad = int((k != p).sum())
        check(n_bad == 0, f"K8 {name}: {n_bad} of {k.numel()} counts differ "
                          f"from the twin")
        index, gate = kw.get("index"), kw.get("gate")
        sel = gate if index is None else gate[index]
        n_valid = int(a[4].sum())
        work = k8_work(k.numel(), int(sel.sum()), a[2].shape[0], n_valid,
                       index is not None)
        row = launch_bound(
            cuda_ms(lambda: POSE.ransac_counts_cuda(*a, **kw), 20),
            graph_ms(lambda: POSE.ransac_counts_cuda(*a, **kw), 20),
            *work, fma_free=True)
        row.update(plain_ms=cuda_ms(
            lambda: POSE.ransac_counts_plain(*a, **kw), 3),
            hypotheses=k.numel(), gated=int(sel.sum()),
            quads=a[2].shape[0], valid_quads=n_valid,
            best_count=int(k.max()))
        calls[name] = row
        print(f"K8 ransac_score, {name} ({row['hypotheses']} hypotheses, "
              f"{row['gated']} gated in, {row['quads']} quads, "
              f"{n_valid} valid; best count {row['best_count']}): counts "
              f"equal to its twin's on the card; kernel "
              f"{row['launch_ms']:.4f} ms launched alone, {row['ms']:.4f} ms "
              f"with its wrapper, twin {row['plain_ms']:.3f} ms; bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: "
              f"{row['flops']} flop, {row['bytes']} B), FMA-free "
              f"{row['bound_ms_no_fma'] * 1e3:.2f} us; "
              f"{row['pct_of_bound_no_fma']:.1f}% of the FMA-free bound "
              f"alone [{card}]")
    k8 = launch_bound(*(sum(r[key] for r in calls.values()) for key in (
        "ms", "launch_ms", "flops", "bytes")), fma_free=True)

    steps = {}
    for i, (a, kw) in enumerate(k9_ops):
        k = POSE.pose_gn_normal_equations_cuda(*a, **kw)
        p = POSE.pose_gn_normal_equations_plain(*a, **kw)
        torch.cuda.synchronize()
        n_bad = f32_differ(k, p)
        check(n_bad == 0, f"K9 step {i}: {n_bad} of 28 sums not bit-equal "
                          f"to the twin's")
        row = launch_bound(
            cuda_ms(lambda: POSE.pose_gn_normal_equations_cuda(*a, **kw), 20),
            graph_ms(lambda: POSE.pose_gn_normal_equations_cuda(*a, **kw),
                     20), *k9_work(a[2].shape[0]), fma_free=True)
        row.update(plain_ms=cuda_ms(
            lambda: POSE.pose_gn_normal_equations_plain(*a, **kw), 3),
            quads=a[2].shape[0], weight=float(k[27]))
        steps[f"step {i}"] = row
    k9 = launch_bound(*(sum(r[key] for r in steps.values()) for key in (
        "ms", "launch_ms", "flops", "bytes")), fma_free=True)
    print(f"K9 pose_gn, 4 steps over {k9_ops[0][0][2].shape[0]} quads "
          f"(sum of weights "
          f"{', '.join(str(int(r['weight'])) for r in steps.values())}): "
          f"the 28 sums bit-equal to the twin's in every step; "
          f"{k9['launch_ms']:.4f} ms launched alone, {k9['ms']:.4f} ms with "
          f"the wrapper, twin "
          f"{sum(r['plain_ms'] for r in steps.values()):.3f} ms; bound "
          f"{k9['bound_ms'] * 1e3:.3f} us ({k9['bound_by']}), FMA-free "
          f"{k9['bound_ms_no_fma'] * 1e3:.3f} us; "
          f"{k9['pct_of_bound_no_fma']:.2f}% of the FMA-free bound alone "
          f"[{card}]")

    res_k = MT.estimate_pose(*est_args)
    with pose_twins():
        res_p = MT.estimate_pose(*est_args)
    torch.cuda.synchronize()
    same = (torch.equal(res_k.R, res_p.R) and torch.equal(res_k.t, res_p.t)
            and int(res_k.inlier_count) == int(res_p.inlier_count))
    check(same, f"estimate_pose on K8 / K9 vs on the twins: R "
                f"{res_k.R.tolist()} / {res_p.R.tolist()}, inliers "
                f"{int(res_k.inlier_count)} / {int(res_p.inlier_count)}")
    ms_k = wall_ms(lambda: MT.estimate_pose(*est_args), 5)
    with pose_twins():
        ms_p = wall_ms(lambda: MT.estimate_pose(*est_args), 5)
    probe = torch.zeros(1, device=res_k.R.device)
    check(sync_count(lambda: probe.item()) >= 1,
          "sync_count does not see the wait of .item()")
    n_sync = sync_count(lambda: MT.estimate_pose(*est_args))
    check(n_sync == 0, f"estimate_pose waited for the card {n_sync} times")
    # the 4 refinement steps (K9, solve_ex, the update) never wait
    torch.cuda.synchronize()
    pq, thr = est_args[0], k9_ops[0][0][6]
    Rr, tr, K_left = k9_ops[0][0][0], k9_ops[0][0][1], k9_ops[0][0][5]
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            Rr, tr = MT._refine_step(Rr, tr, pq, K_left, thr)
    except RuntimeError as e:
        fail(f"a refinement step waited for the card: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    seeds = singular_on_card(res_k.R.device)
    print(f"estimate_pose (frame 2): on K8 / K9 R, t and {int(res_k.inlier_count)}"
          f" inliers identical to the twins' on the card; {ms_k:.3f} ms on "
          f"the kernels, {ms_p:.3f} ms on the twins (host clock, "
          f"synchronised, mean of 5); the refinement steps never wait for "
          f"the card (sync debug mode 'error'), nor does the whole call "
          f"(no sync warning); the singular case (seeds {seeds}) returns "
          f"success, 2 inliers and a finite pose [{card}]")
    return [
        dict(name="ransac_score", route="cuda",
             source="edge_based_visual_odometry_tpu_torch/csrc/ransac_score.cu",
             replaces="edge_based_visual_odometry_tpu/models/motion_tracker.py:240",
             max_abs_err=0.0, library_ms=None,
             plain_ms=sum(r["plain_ms"] for r in calls.values()),
             calls=calls, estimate_pose_ms=ms_k,
             estimate_pose_on_twins_ms=ms_p, **k8),
        dict(name="pose_gn", route="cuda",
             source="edge_based_visual_odometry_tpu_torch/csrc/pose_gn.cu",
             replaces="edge_based_visual_odometry_tpu/models/motion_tracker.py:307",
             max_abs_err=0.0, library_ms=None,
             plain_ms=sum(r["plain_ms"] for r in steps.values()),
             calls=steps, **k9)]


# Phase 6g: the patch sizes past the default. Each runs with the largest
# shift the reference's coverage guard admits there (P = 9: <= 4.34 px,
# P = 11: <= 2.93 px; `patches.check_coverage`), P = 5 at the default.
WIDE_PATCHES = ((5, 5.0), (9, 4.0), (11, 2.9))
GUARDED_PATCH = 9       # the size whose 3 frames are held to the guards
PATCH_KERNELS = ("refine_along_epipolar", "refine_2dof", "dense_gates",
                 "edge_patches")


class Recording:
    """Within `with Recording() as ops:`, the wrappers a frame calls keep
    their operands: ops["k2"] the last `refine_along_epipolar_batch`
    call's (args, kwargs), ops["k3"] the last `refine_2dof_pair_batch`'s,
    ops[kind] the last call of each K6 entry, ops["k7"] the
    `edge_patches_flat` calls since it was last cleared."""

    def __enter__(self):
        from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
        from edge_based_visual_odometry_tpu_torch.ops import patches as PAT

        self.ops, self.saved = {"k7": []}, []
        targets = [(GN, "refine_along_epipolar_batch", "k2"),
                   (GN, "refine_2dof_pair_batch", "k3"),
                   (PAT, "edge_patches_flat", "k7")]
        targets += [(PAT, f"dense_gates_{kind}", kind) for kind in K6_ENTRIES]
        for mod, name, key in targets:
            fn = getattr(mod, name)

            def run(*a, _fn=fn, _key=key, **kw):
                if _key == "k7":
                    self.ops["k7"].append((a, kw))
                else:
                    self.ops[_key] = (a, kw)
                return _fn(*a, **kw)
            self.saved.append((mod, name, fn))
            setattr(mod, name, run)
        return self.ops

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)


def ptxas_entries():
    """{kernel's mangled name: (registers, spill store bytes, spill load
    bytes)} from the ptxas log of the built library."""
    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB

    out, name, spill = {}, None, (0, 0)
    for ln in CB.ptxas_log().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = (int(m.group(1)), *spill)
            name = None
    return out


def patch_instances(P):
    """The ptxas entries of the kernel instances patch size P runs: K2's
    slots a thread, K3's P, K6's samples a lane, K7's one kernel."""
    ns = max(4, (2 * P * P + 31) // 32)
    lanes = 2 if P * P <= 64 else 4
    pats = {"K2": rf"epipolar_gn_kernelILi{ns}E",
            "K3": rf"gn_2dof_(direct|queue)ILi{P}E",
            "K6": rf"dense_gates_\w+?_kernelI(\w*?)Li{lanes}E",
            "K7": r"edge_patches_kernel"}
    found = {}
    for name, v in ptxas_entries().items():
        for k, pat in pats.items():
            if re.search(pat, name):
                short = re.search(r"epipolar_gn_kernel|gn_2dof_direct|"
                                  r"gn_2dof_queue|dense_gates_[a-z]+_kernel|"
                                  r"edge_patches_kernel", name).group(0)
                if "prep" in short:
                    short += " (bf16)" if "bfloat16" in name else " (float)"
                found[f"{k} {short}"] = v
    return found


def wide_gn_k2(ops, P, H, W):
    """K2 at patch size P on frame 2's stage-9 operands: the two phases
    bit for bit against the twin on the card, each launch timed alone (a
    CUDA graph) beside its bound from the iterations it ran."""
    from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN

    a, kw = ops["k2"]
    act = kw["active"]
    B = act.shape[0]
    gn_kw = dict(patch_size=P, max_iter=kw["max_iter"], tol=kw["tol"],
                 huber_delta=kw["huber_delta"], tile=kw["tile"])
    phase_kw = dict(phase1_iters=kw["phase1_iters"],
                    phase2_budget=kw["phase2_budget"],
                    max_iter=kw["max_iter"], chunk=kw["chunk"])
    maps4 = GN.interleave_maps(*a[1:4])
    lanes = tuple(t.contiguous() for t in a[4:])
    alpha0 = torch.zeros(B, device=act.device)
    calls = []
    rk = GN._two_phase(recorder(GN.refine_along_epipolar_cuda, a[:4], gn_kw,
                                calls, maps4=maps4), B, lanes, act, alpha0,
                       **phase_kw)
    rp = GN._two_phase(recorder(GN.refine_along_epipolar_plain, a[:4],
                                gn_kw, []), B, lanes, act, alpha0, **phase_kw)
    torch.cuda.synchronize()
    same_lanes(rk, rp, act, f"K2 at P = {P}, two phases")
    ms, flops, nbytes = 0.0, 0, 0
    for args, d0, it0, it_stop, fact in calls:
        def run(args=args, d0=d0, it0=it0, it_stop=it_stop, fact=fact):
            return GN.refine_along_epipolar_cuda(*a[:4], *args, d0, fact,
                                                 it0, it_stop, maps4=maps4,
                                                 **gn_kw)
        res, _ = run()
        it = ((res.iters.long() - it0).clamp(min=0) * fact).cpu().numpy()
        f, b = k2_work(it, fact.cpu().numpy(), P, H, W)
        ms, flops, nbytes = ms + graph_ms(run, 20), flops + f, nbytes + b
    return with_bound(ms, flops, nbytes, fma_free=True), dict(
        lanes=B, active=int(act.sum()))


def wide_gn_k3(ops, P, H, W):
    """K3 at patch size P on frame 2's `refine_2dof_pair_batch` operands:
    the main path's two launches bit for bit against the twin's in-place
    form on the card, both sides; the two launches (and the cumsum between
    them) timed alone through a CUDA graph beside their bound."""
    from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN

    a3, kw3 = ops["k3"]
    kfs, maps4, act3 = [a3[0], a3[1]], a3[2], a3[5]
    kpack, cpack = a3[3].contiguous(), a3[4].contiguous()
    B3 = act3.shape[0]
    g3 = dict(patch_size=P, max_iter=kw3["max_iter"], tol=kw3["tol"],
              huber_delta=kw3["huber_delta"], tile=kw3["tile"])
    ph3 = dict(phase1_iters=kw3["phase1_iters"],
               phase2_budget=kw3["phase2_budget"], chunk=kw3["chunk"])
    two = GN.refine_2dof_pair_batch(*a3, **kw3)
    iters = []
    for s in range(2):
        imgs = (kfs[s], *(maps4[s, ..., k].contiguous() for k in range(3)))
        lanes = tuple(t[:, 3 * s + k].contiguous() for t in (kpack, cpack)
                      for k in range(3))
        d0 = torch.stack([lanes[0] - lanes[3], lanes[1] - lanes[4]], -1)
        plain, _ = GN._two_phase_in_place(
            lambda x, d, it0, it_stop, ac, imgs=imgs: GN.refine_2dof_plain(
                *imgs, *x, d, ac, it0, it_stop, **g3),
            B3, lanes, act3, d0, max_iter=kw3["max_iter"], **ph3)
        torch.cuda.synchronize()
        same_lanes(two[s], plain, act3, f"K3 at P = {P}, side {s}, two "
                                        f"launches vs the twin")
        iters.append((two[s].iters.long() * act3).cpu().numpy())
    ms = graph_ms(lambda: GN.refine_2dof_sides_cuda(
        kfs, maps4, kpack, cpack, act3, **g3, **ph3), 20)
    actn = act3.cpu().numpy()
    w = [k3_work(it, actn, P, H, W) for it in iters]
    return with_bound(ms, sum(x[0] for x in w), sum(x[1] for x in w),
                      fma_free=True), dict(lanes=B3, active=int(act3.sum()))


def wide_gates_k6(ops, P):
    """K6's three entries at patch size P on frame 2's operands, each bit
    for bit against its twin on the card (`k6_call`) and timed alone (a
    CUDA graph, the prep pass included) beside its bound."""
    from edge_based_visual_odometry_tpu_torch.ops import patches as PAT

    rows = {}
    for kind in K6_ENTRIES:
        a, kw = ops[kind]
        at = a[{"stereo": 9, "flat": 6, "temporal": 11}[kind]]
        check(at == P, f"K6 {kind} call at patch size {at}, not {P}")
        _, _, work, detail = k6_call(kind, a, kw, f"K6 at P = {P}")
        kern = getattr(PAT, f"dense_gates_{kind}_cuda")
        rows[kind] = dict(with_bound(graph_ms(lambda: kern(*a, **kw), 20),
                                     *work), **detail)
    return rows


def wide_patches_k7(ops, P):
    """K7 on frame 2's four calls at patch size P, each bit for bit
    against its twin on the card (`k7_call`) and timed alone (a CUDA
    graph) beside its bound."""
    from edge_based_visual_odometry_tpu_torch.ops import patches as PAT

    check(len(ops["k7"]) == 4, f"K7 at P = {P}: {len(ops['k7'])} calls in "
                               f"frame 2's stereo step, not 4")
    rows = {}
    for name, (a, kw) in zip(K7_CALLS, ops["k7"]):
        check(a[4] == P, f"K7 {name} call at patch size {a[4]}, not {P}")
        _, _, B, n_live, work = k7_call(name, a, kw, f"K7 at P = {P}")
        rows[name] = dict(with_bound(graph_ms(
            lambda: PAT.edge_patches_cuda(*a, **kw), 20), *work),
            edges=B, live=n_live)
    return rows


def phase_patch_sizes(seq, frames, card, main_launches, dev):
    """Phase 6g: the production frame at the patch sizes of
    `WIDE_PATCHES`. For each, 3 frames of 376x1241 through VOPipeline
    (every_frame) on the card, recording frame 2's operands of K2, K3, K6
    (three entries) and K7 (four calls); each kernel held bit-equal to its
    twin on the card on them and timed alone through a CUDA graph beside
    its bound, and the ptxas registers and spills of the instances the
    size runs printed. At `GUARDED_PATCH` the frames are held to the
    production guards (a successful, finite pose on frames 1-2 with >= 500
    quads) and the launches of K2, K3, K6 and K7 to those of the default
    frame's run (`main_launches`). Returns {P: {kernel: row}} for the
    kernels' JSON entries."""
    from edge_based_visual_odometry_tpu_torch.config import VOConfig
    from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
    from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
    from edge_based_visual_odometry_tpu_torch.ops import patches as PAT

    H, W = frames[0][0].shape
    by_p = {}
    for P, shift in WIDE_PATCHES:
        cfg = VOConfig(patch_size=P, orthogonal_shift_mag=shift)
        pipe = PL.VOPipeline(seq.rig, cfg, device=dev,
                             keyframe_policy="every_frame")
        torch.cuda.synchronize()
        CB.reset_launch_counts()
        line = []
        with Recording() as ops:
            for k, (l, r) in enumerate(frames):
                ops["k7"].clear()
                fr, tr = pipe.run_frame(l, r)
                torch.cuda.synchronize()
                n_mates = int(fr.mates.count)
                check(n_mates > 0, f"P = {P}, frame {k}: no mates")
                if k == 0:
                    line.append(f"mates {n_mates}")
                    continue
                ang, terr = rel_pose_err(tr, seq.frames[k - 1],
                                         seq.frames[k])
                n_q = int(tr.n_quads)
                line.append(f"mates {n_mates}, quads {n_q}, pose err "
                            f"{ang:.4f} deg / {terr * 1e3:.2f} mm")
                if P == GUARDED_PATCH:
                    check(bool(tr.success), f"P = {P}, frame {k}: pose not "
                                            f"successful")
                    check(bool(torch.isfinite(tr.R).all()
                               and torch.isfinite(tr.t).all()),
                          f"P = {P}, frame {k}: non-finite pose")
                    check(n_q >= 500, f"P = {P}, frame {k}: quads {n_q} < "
                                      f"500")
        launches = {n: CB.LAUNCHES[n] for n in PATCH_KERNELS}
        if P == GUARDED_PATCH:
            main = {n: main_launches[n] for n in PATCH_KERNELS}
            check(launches == main, f"P = {P}: launches {launches}, the "
                                    f"default frame's run {main}")
        print(f"P = {P}, shift {shift} px, 3 frames of {H}x{W}: "
              + "; ".join(f"frame {k}: {x}" for k, x in enumerate(line))
              + f"; launches of K2 / K3 / K6 / K7 "
              f"{' / '.join(str(v) for v in launches.values())}"
              + (" (the default frame's)" if P == GUARDED_PATCH else ""))
        rows = {"refine_along_epipolar": wide_gn_k2(ops, P, H, W),
                "refine_2dof": wide_gn_k3(ops, P, H, W)}
        rows["dense_gates"] = wide_gates_k6(ops, P)
        rows["edge_patches"] = wide_patches_k7(ops, P)
        k2, k2n = rows["refine_along_epipolar"]
        k3, k3n = rows["refine_2dof"]
        print(f"P = {P} K2 frame 2 ({k2n['lanes']} lanes, {k2n['active']} "
              f"active; two phases) bit-equal to its twin; "
              f"{k2['ms']:.4f} ms launched alone, bound "
              f"{k2['bound_ms'] * 1e3:.1f} us ({k2['bound_by']}), "
              f"{k2['pct_of_bound']:.1f}% of it, "
              f"{k2['pct_of_bound_no_fma']:.1f}% of the FMA-free bound "
              f"[{card}]")
        print(f"P = {P} K3 frame 2 ({k3n['lanes']} lanes a side, "
              f"{k3n['active']} active; both sides, two launches) bit-equal "
              f"to its twin; {k3['ms']:.4f} ms launched alone, bound "
              f"{k3['bound_ms'] * 1e3:.1f} us ({k3['bound_by']}), "
              f"{k3['pct_of_bound']:.1f}% of it, "
              f"{k3['pct_of_bound_no_fma']:.1f}% of the FMA-free bound "
              f"[{card}]")
        for kname, label in (("dense_gates", "K6"), ("edge_patches", "K7")):
            for call, row in rows[kname].items():
                print(f"P = {P} {label} frame 2 {call} call ({row.get('live')}"
                      f" live) bit-equal to its twin; {row['ms']:.4f} ms "
                      f"launched alone, bound {row['bound_ms'] * 1e3:.1f} us "
                      f"({row['bound_by']}), {row['pct_of_bound']:.1f}% of "
                      f"it [{card}]")
        for name, (regs, st, ld) in sorted(patch_instances(P).items()):
            print(f"P = {P} ptxas {name}: {regs} registers, {st} / {ld} "
                  f"bytes spill stores / loads")
        info3 = GN.k3_info()["by_patch_size"][P]
        print(f"P = {P} K3 direct / queue: {info3['direct_registers']} / "
              f"{info3['queue_registers']} registers, "
              f"{info3['direct_local_bytes']} / {info3['queue_local_bytes']}"
              f" local bytes, {info3['direct_warps_per_sm']} / "
              f"{info3['queue_warps_per_sm']} warps an SM")
        if P * P > 64:
            info6 = PAT.k6_info()["wide"]
            for name in PAT.K6_KERNELS:
                check(info6[name]["local_bytes"] == 0,
                      f"K6 {name} kernel at 4 samples a lane spills")
        by_p[P] = {
            "refine_along_epipolar": dict(k2, **k2n),
            "refine_2dof": dict(k3, **k3n),
            "dense_gates": rows["dense_gates"],
            "edge_patches": rows["edge_patches"],
            "launches": launches}
    return by_p


def phase_sequence(seq, images, card, work_dir):
    """Phase 7. Returns the kernel launches of the main run."""
    from edge_based_visual_odometry_tpu_torch import cli as CLI
    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB

    n = len(images)
    frames_gt = seq.frames[:n]
    samples = samples_of(frames_gt, images)

    def run(tag, **flags):
        out_dir = os.path.join(work_dir, tag)
        per_frame = []
        last = dict(CB.LAUNCHES)

        def on_frame(k, fr, tr):
            per_frame.append(dict(
                k=k, mates=int(fr.mates.count),
                quads=None if tr is None else int(tr.n_quads),
                launches={nm: CB.LAUNCHES[nm] - last[nm] for nm in last}))
            last.update(CB.LAUNCHES)
        flags.setdefault("output_dir", out_dir)
        res = CLI.run(rig_config(seq.rig, "KITTI", out_dir),
                      CLI.default_args(keyframe_policy="every_frame",
                                       **CLI_FLAGS, **flags),
                      samples, on_frame=on_frame)
        torch.cuda.synchronize()
        return res, per_frame

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CB.reset_launch_counts()
    main_dir = os.path.join(work_dir, "seq_ba")
    res, per_frame = run("seq_ba", ba_window=3, dump_stereo_pairs=True,
                         dump_quads=True, record_filter_distributions=True,
                         checkpoint_dir=os.path.join(work_dir, "ckpt_main"),
                         checkpoint_every=2)
    launches = dict(CB.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    pipe = res["pipe"]
    check(res["frames"] == n and len(per_frame) == n,
          f"sequence: {res['frames']} frames processed, expected {n}")
    R, t = traj_arrays(pipe)
    check(bool(np.isfinite(R).all() and np.isfinite(t).all()),
          "sequence: non-finite trajectory")
    for pf in per_frame:
        k = pf["k"]
        check(pf["launches"]["toed_gradient_field"] >= 1
              and pf["launches"]["refine_along_epipolar"] >= 1
              and pf["launches"]["refine_2dof"] == (2 if k else 0)
              and pf["launches"]["cluster_edges"] == (2 if k else 1)
              and pf["launches"]["edge_descriptors"] == 3
              and pf["launches"]["ransac_score"] == (2 if k else 0)
              and pf["launches"]["pose_gn"] == (4 if k else 0),
              f"sequence frame {k}: kernel launches {pf['launches']}")
        check(pf["mates"] >= 21000,
              f"sequence frame {k}: mates {pf['mates']} < 21000")
        if k:
            check(pf["quads"] >= 500,
                  f"sequence frame {k}: quads {pf['quads']} < 500")
            ang, terr = rel_err(R[k - 1], t[k - 1], R[k], t[k],
                                frames_gt[k - 1], frames_gt[k])
            check(ang < 0.2 and terr < 0.010,
                  f"sequence frame {k}: pose error {ang:.4f} deg / "
                  f"{terr * 1e3:.2f} mm")
            pf.update(deg=round(ang, 4), mm=round(terr * 1e3, 2))
    print("sequence frames (mates; quads, deg, mm after BA): "
          + "; ".join(f"{pf['mates']}" + (f", {pf['quads']}, {pf['deg']}, "
                                          f"{pf['mm']}" if pf["k"] else "")
                      for pf in per_frame))

    # BA: at least one solve, each with a finite cost series that ends
    # below its start and never rises by more than 2% from one iteration
    # to the next. (The series is the Huber-weighted reprojection term
    # alone; the step also minimises the landmark prior's term, so once
    # converged the reprojection term moves up and down in its last digits.)
    check(len(pipe.ba_info_log) >= 1, "sequence: no BA solve ran")
    for i, b in enumerate(pipe.ba_info_log):
        c = np.asarray(b["cost"], np.float64)
        check(bool(np.isfinite(c).all()), f"BA solve {i}: cost {c}")
        check(bool(c[-1] <= c[0] and np.all(c[1:] <= c[:-1] * 1.02 + 1e-9)),
              f"BA solve {i}: cost rises: {c}")
    ba = res["metrics"]["ba"]
    print(f"BA: {ba['solves']} solves, mean landmarks {ba['mean_landmarks']:.0f}"
          f", mean obs {ba['mean_obs']:.0f}, mean_solve_s "
          f"{ba['mean_solve_s']:.4f}, mean_host_assembly_s "
          f"{ba['mean_host_assembly_s']:.4f} (solve_s per solve "
          f"{[round(b['solve_s'], 4) for b in pipe.ba_info_log]}), first/last "
          f"cost of the last solve {pipe.ba_info_log[-1]['cost'][0]:.5f} / "
          f"{pipe.ba_info_log[-1]['cost'][-1]:.5f} [{card}]")
    from edge_based_visual_odometry_tpu_torch.utils import checkpoint as CKPT
    t_ck = time.perf_counter()
    CKPT.save_pipeline_state(os.path.join(work_dir, "ckpt_timed"), pipe)
    t_ck = time.perf_counter() - t_ck
    ck_mb = os.path.getsize(os.path.join(work_dir, "ckpt_timed",
                                         "state.npz")) / 1e6
    print(f"one checkpoint save: {t_ck:.3f} s, state.npz {ck_mb:.1f} MB "
          f"(compressed) [{card}]")

    # dump files, with the column counts of the reference's formats
    for k in range(n):
        lines = open(os.path.join(
            main_dir, f"finalized_stereo_edge_pairs_frame_{k}.txt")
        ).read().splitlines()
        check(len(lines) == per_frame[k]["mates"] + 1
              and len(lines[1].split()) == 16,
              f"dump: finalized pairs of frame {k}")
        fdl = open(os.path.join(main_dir, f"sift_distance_frame_{k}.txt")
                   ).read().splitlines()
        check(fdl[2] == "filter_value\tis_GT" and len(fdl) > 3
              and len(fdl[3].split("\t")) == 2,
              f"dump: sift_distance of frame {k}")
        al = open(os.path.join(main_dir, f"ambiguity_sift_frame_{k}.txt")
                  ).read().splitlines()
        check(al[2] == "num_candidates" and len(al) > 3,
              f"dump: ambiguity of frame {k}")
        if k:
            ql = open(os.path.join(main_dir, f"quads_frame_{k}.txt")
                      ).read().splitlines()
            check(ql[0].startswith(f"# keyframe {k - 1}") and len(ql) > 2
                  and len(ql[2].split(",")) == 8, f"dump: quads of frame {k}")
    for name in ("trajectory_tum.txt", "metrics.json"):
        check(os.path.exists(os.path.join(main_dir, name)), f"no {name}")
    check(os.path.exists(os.path.join(work_dir, "ckpt_main", "state.npz")),
          "no checkpoint written")

    # the same frames without BA and without dumps: ATE and frames/s
    res0, _ = run("seq_plain")
    ate, ate0 = res["metrics"]["ate_rmse"], res0["metrics"]["ate_rmse"]
    check(ate <= 1.5 * ate0 + 1e-4,
          f"ATE with BA {ate:.5f} m > 1.5 x {ate0:.5f} m without")
    print(f"sequence of {n} frames {'x'.join(map(str, images[0][0].shape))}: "
          f"{res0['metrics']['frames_per_s']:.3f} frames/s without BA or "
          f"dumps, {res['metrics']['frames_per_s']:.3f} frames/s with BA "
          f"window 3, dumps and checkpoints; ATE {ate0:.5f} m without BA, "
          f"{ate:.5f} m with; peak device memory {peak_gib:.2f} GiB "
          f"[{card}]")

    # cut at frame 3, then resume from the checkpoint to the end
    ck = os.path.join(work_dir, "ckpt_cut")
    cut = dict(ba_window=3, checkpoint_dir=ck, checkpoint_every=2,
               output_dir=os.path.join(work_dir, "seq_resumed"))
    run("seq_resumed", max_frames=3, **cut)
    res2, pf2 = run("seq_resumed", **cut)
    check([p["k"] for p in pf2] == list(range(3, n)),
          f"resume: frames {[p['k'] for p in pf2]} ran")
    R2, t2 = traj_arrays(res2["pipe"])
    check(R2.shape == R.shape, "resume: trajectory length")
    diff = max(float(np.abs(R2 - R).max()), float(np.abs(t2 - t).max()))
    # the BA's scatter-adds have no fixed order on the card, so two runs
    # may differ in the last bits: equal within 1e-5
    check(diff <= 1e-5, f"resume: trajectory differs by {diff:.3g}")
    print(f"resume from frame 3: trajectory "
          f"{'bit-equal to' if diff == 0.0 else f'within {diff:.3g} of'} "
          f"the uninterrupted run's")
    return launches


def phase_evaluation(seq, card, work_dir, dev):
    """Phase 8. Returns its kernel launches."""
    from edge_based_visual_odometry_tpu_torch import cli as CLI
    from edge_based_visual_odometry_tpu_torch.models import motion_tracker as MT
    from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
    from edge_based_visual_odometry_tpu_torch.models import stereo_matcher as SM
    from edge_based_visual_odometry_tpu_torch.models.types import (
        rig_arrays_from_rig)
    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
    from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
    from edge_based_visual_odometry_tpu_torch.ops import image as IMG

    cam = dataclasses.replace(seq.rig.left,
                              distortion=(-0.02, 0.004, 0.0003, -0.0002))
    rig = dataclasses.replace(seq.rig, left=cam, right=cam)
    frames_gt = seq.frames[:3]
    images = [(distort_image(f.left, cam), distort_image(f.right, cam))
              for f in frames_gt]

    # the device remap against the same remap on the CPU, and against the
    # frame that was distorted (interior)
    K = torch.as_tensor(cam.K, dtype=torch.float32)
    d = torch.tensor(cam.distortion[:4], dtype=torch.float32)
    img = torch.from_numpy(images[0][0])
    und = IMG.undistort(img.to(dev), K.to(dev), d.to(dev)).cpu()
    err = float((und - IMG.undistort(img, K, d)).abs().max())
    back = float(np.abs(und.numpy() - frames_gt[0].left)[16:-16, 16:-16]
                 .mean())
    check(err < 1e-2, f"undistort: card vs CPU differ by {err:.3g} gray")
    check(back < 1.0, f"undistort: mean {back:.3g} gray from the clean frame")

    rig_a = rig_arrays_from_rig(rig, dev)
    sweeps, prev = [], {}

    def on_frame(k, fr, tr):
        if tr is not None:
            pq = MT.lift_quads(prev["fr"].mates, tr.quads, rig_a, pipe_cfg,
                               use_gt=True)
            sweeps.append(MT.constraint_sweep_metrics(
                pq, pipe_cfg, pipe_cfg.ransac_seed + k).cpu().numpy())
        prev["fr"] = fr

    out_dir = os.path.join(work_dir, "eval")
    args = CLI.default_args(**CLI_FLAGS, use_gt_pose=True,
                            record_filter_distributions=True,
                            output_dir=out_dir)
    pipe_cfg = CLI.vo_config_from_args(args)
    CB.reset_launch_counts()
    res = CLI.run(rig_config(rig, "ETH3D_stereo", out_dir), args,
                  samples_of(frames_gt, images, disparity=True),
                  on_frame=on_frame)
    torch.cuda.synchronize()
    launches = dict(CB.LAUNCHES)
    pipe = res["pipe"]

    # K2 on this path's input: the stage-9 operands of frame 0, made from
    # remapped (float-valued) images under GT supervision, through the
    # kernel and through its plain twin, bit for bit
    cap = {}
    PL.build_stereo_step(rig, pipe_cfg, dev, has_gt=True)(
        *images[0], frames_gt[0].disparity,
        np.full(images[0][0].shape, 255.0, np.float32), gn_capture=cap)
    a, kw = cap["args"], cap["kwargs"]
    act = kw["active"]
    frac = float((a[1] != a[1].round()).float().mean())
    check(frac > 0.5, f"evaluation: {frac:.2f} of the right image is "
                      f"non-integer; the remap did not run")
    gn_kw = dict(patch_size=kw["patch_size"], max_iter=kw["max_iter"],
                 tol=kw["tol"], huber_delta=kw["huber_delta"], tile=kw["tile"])
    alpha0 = torch.zeros(act.shape[0], device=dev)
    rk, dk = GN.refine_along_epipolar_cuda(*a, alpha0, act, 0, kw["max_iter"],
                                           **gn_kw)
    rp, dp = GN.refine_along_epipolar_plain(*a, alpha0, act, 0,
                                            kw["max_iter"], **gn_kw)
    same_lanes((*rk, dk), (*rp, dp), act, "K2 evaluation frame, one launch")
    same_lanes(GN.refine_along_epipolar_batch(*a, **kw),
               GN._two_phase(
                   lambda args, d0, it0, it_stop, active:
                   GN.refine_along_epipolar_plain(*a[:4], *args, d0, active,
                                                  it0, it_stop, **gn_kw),
                   act.shape[0], tuple(t.contiguous() for t in a[4:]), act,
                   alpha0, phase1_iters=kw["phase1_iters"],
                   phase2_budget=kw["phase2_budget"], max_iter=kw["max_iter"],
                   chunk=kw["chunk"]),
               act, "K2 evaluation frame, two phases")
    print(f"K2 on the evaluation path's stage-9 input ({int(act.sum())} "
          f"active lanes, {frac:.2f} of the right image non-integer): "
          f"bit-equal to its twin, as one launch and as two phases")
    check(len(pipe.stereo_metrics_log) == 3
          and len(pipe.temporal_metrics_log) == 2, "evaluation: logs")
    for k, rows in enumerate(pipe.stereo_metrics_log):
        check(rows.shape == (len(SM.STAGE_NAMES), 4)
              and bool(np.isfinite(rows).all()), f"eval frame {k}: rows")
        rec, prec = float(rows[-1, 0]), float(rows[-1, 1])
        check(rec >= 0.9 and prec >= 0.95,
              f"eval frame {k}: final recall {rec:.4f} precision {prec:.4f}")
    for k, rows in enumerate(pipe.temporal_metrics_log):
        check(bool(np.isfinite(rows).all()), f"eval: temporal rows {rows}")
        (g_rec, _), (rec, prec) = rows[0, :2], rows[-1, :2]
        check(g_rec >= EVAL_TEMPORAL_FLOOR["gather_recall"]
              and rec >= EVAL_TEMPORAL_FLOOR["recall"]
              and prec >= EVAL_TEMPORAL_FLOOR["precision"],
              f"eval frame {k + 1}: temporal recall after the gather "
              f"{g_rec:.4f}, final recall {rec:.4f} precision {prec:.4f}, "
              f"floors {EVAL_TEMPORAL_FLOOR}")
    check(len(sweeps) == 2, "evaluation: constraint sweeps")
    for sw in sweeps:
        check(sw.shape == (5, 3) and bool(np.isfinite(sw).all())
              and bool(np.all((sw[:, :2] >= 0) & (sw[:, :2] <= 1))),
              f"constraint sweep rows {sw}")
    for name in ("ncc_frame_0.txt", "matching_edge_clusters_data_frame_0.txt",
                 "photo_refine_data_from_evaluation_statistics_frame_2.txt",
                 "false_negative_edge_clusters_frame_1.txt"):
        check(os.path.exists(os.path.join(out_dir, name)), f"eval: no {name}")
    fin = np.mean(np.stack(pipe.stereo_metrics_log), 0)[-1]
    tfin = np.mean(np.stack(pipe.temporal_metrics_log), 0)[-1]
    print(f"evaluation, 3 frames {'x'.join(map(str, images[0][0].shape))}, "
          f"distorted rig undistorted on the "
          f"device (card vs CPU remap {err:.2g} gray): final stereo recall "
          f"{fin[0]:.4f} precision {fin[1]:.4f}; final temporal recall "
          f"{tfin[0]:.4f} precision {tfin[1]:.4f}; constraint sweep "
          f"(recall, precision) after all gates "
          f"{[tuple(round(float(v), 4) for v in sw[-1, :2]) for sw in sweeps]}; ATE "
          f"{res['metrics']['ate_rmse']:.5f} m [{card}]")
    return launches


def phase_pair_step(seq, images, card, dev):
    """Phase 9. Returns the kernel launches of the checked pair step."""
    import torch.distributed as dist
    from edge_based_visual_odometry_tpu_torch.config import VOConfig
    from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
    from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM

    cfg = VOConfig()
    mesh = PM.init_distributed(device="cuda")
    try:
        check(dist.get_backend() == "nccl" and mesh.size() == 1,
              f"pair step: backend {dist.get_backend()}, {mesh.size()} ranks")
        # two pairs, frames 0 -> 1 and 1 -> 2, seeds 0 and 1; each pair's
        # prediction is its GT relative pose (what a running loop's
        # velocity supplies)
        pairs = [(0, 1), (1, 2)]
        rel = []
        for a, b in pairs:
            R = seq.frames[b].R @ seq.frames[a].R.T
            rel.append((R, seq.frames[b].t - R @ seq.frames[a].t))
        stack = [torch.as_tensor(np.stack([images[p[i]][j] for p in pairs]),
                                 device=dev) for i in (0, 1) for j in (0, 1)]
        args = stack + [
            torch.as_tensor(np.stack([r[0] for r in rel]), dtype=torch.float32,
                            device=dev),
            torch.as_tensor(np.stack([r[1] for r in rel]), dtype=torch.float32,
                            device=dev),
            torch.tensor([0, 1], dtype=torch.int32)]

        # the checked run records each pair's quads on the way
        quads, temporal = [], PL.build_temporal_step

        def recording(*a, **kw):
            step = temporal(*a, **kw)

            def run(*args):
                tr = step(*args)
                quads.append(int(tr.n_quads))
                return tr
            return run
        PL.build_temporal_step = recording
        try:
            checked = PM.build_sharded_pair_step(seq.rig, cfg, mesh)
        finally:
            PL.build_temporal_step = temporal
        torch.cuda.synchronize()
        CB.reset_launch_counts()
        out = checked(*args)
        torch.cuda.synchronize()
        launches = dict(CB.LAUNCHES)

        # the same frames through VOPipeline's steps
        pipe = PL.VOPipeline(seq.rig, cfg, device=dev)
        rows = []
        for i, (a, b) in enumerate(pairs):
            fa = pipe._stereo_step(*images[a])
            fb = pipe._stereo_step(*images[b])
            tr = pipe._temporal_step(fa.mates, fa.frame, fb.mates, fb.frame,
                                     args[4][i], args[5][i], i)
            mine = (int(out.n_mates_kf[i]), int(out.n_mates_cf[i]), quads[i])
            ref = (int(fa.mates.count), int(fb.mates.count), int(tr.n_quads))
            for nm, u, v in zip(("kf mates", "cf mates", "quads"), mine, ref):
                check(min(u, v) >= 0.97 * max(u, v),
                      f"pair {i}: {nm} {u} vs {v} through VOPipeline's steps")
            Rg, tg = rel[i]
            dR = out.R[i].double().cpu().numpy() @ Rg.T
            ang = float(np.degrees(np.arccos(np.clip(
                (np.trace(dR) - 1) / 2, -1, 1))))
            terr = float(np.linalg.norm(out.t[i].double().cpu().numpy() - tg))
            check(ang < 0.2 and terr < 0.010,
                  f"pair {i}: pose error {ang:.4f} deg / {terr * 1e3:.2f} mm")
            rows.append(f"pair {pairs[i]}: mates {mine[0]}/{mine[1]} (steps "
                        f"{ref[0]}/{ref[1]}), quads {mine[2]} ({ref[2]}), "
                        f"inlier ratio {float(out.inlier_ratio[i]):.4f}, pose "
                        f"err {ang:.4f} deg / {terr * 1e3:.2f} mm")
        mean_rows = float(out.inlier_ratio.double().mean())
        check(abs(float(out.mean_inlier_ratio) - mean_rows) <= 1e-6,
              f"pair step: all-reduced mean {float(out.mean_inlier_ratio)} vs "
              f"mean of the rows {mean_rows}")
        print("pair step (NCCL, 1 rank, 2 pairs): " + "; ".join(rows)
              + f"; all-reduced mean inlier ratio "
              f"{float(out.mean_inlier_ratio):.6f}; launches {launches}")

        step = PM.build_sharded_pair_step(seq.rig, cfg, mesh)
        step(*args)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        print(f"sharded pair step, batch of 2 pairs 376x1241 on 1 rank: "
              f"{', '.join(f'{x:.1f}' for x in times)} ms "
              f"({2e3 / np.mean(times):.3f} frame pairs/s) [{card}]")

        mem = PM.analyze_production_memory(1)
        check(mem["fits_hbm"] and mem["peak_mib"] < mem["device_mib"],
              f"production memory {mem}")
        print("analyze_production_memory(1), one pair per device: "
              + ", ".join(f"{k} {v:.1f}" if isinstance(v, float)
                          else f"{k} {v}" for k, v in mem.items())
              + f" [{card}]")
    finally:
        dist.destroy_process_group()
    return launches


def phase_ba_ranks(card, work_dir):
    """Phase 9b: the windowed BA split over two ranks on one card."""
    from tests import torch_ranks as TR

    t = time.perf_counter()
    res = TR.spawn(TR.window_ba_worker, 2, pathlib.Path(work_dir), "cuda:0",
                   timeout=300)
    single = res[0]["single"]
    diff = max(float(np.abs(a - b).max())
               for r in res for a, b in zip(single, r["sharded"]))
    check(len(single) == 8 and diff <= 1e-4,
          f"sharded BA on the card: poses {diff:.3g} from one rank's")
    print(f"sharded windowed BA, 2 gloo ranks on cuda:0, 8-keyframe corridor "
          f"chain: every pose within {diff:.3g} of one rank's solve on the "
          f"card ({time.perf_counter() - t:.1f} s with the spawn) [{card}]")


def phase_corridor(card, work_dir):
    """Phase 10. Returns its kernel launches."""
    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
    from scripts import long_seq_validation_torch as LS

    CB.reset_launch_counts()
    rec = LS.main(["--n_frames", str(N_CORRIDOR),
                   "--out", os.path.join(work_dir, "corridor")])
    torch.cuda.synchronize()
    launches = dict(CB.LAUNCHES)
    check(rec["ate_rmse_m"] is not None, "corridor: a frame without a pose "
                                         "(no metrics)")
    check(not rec["collapsed_frames"] and not rec["frames_without_pose"],
          f"corridor: collapsed {rec['collapsed_frames']}, without a pose "
          f"{rec['frames_without_pose']}")
    check(rec["ate_rmse_m"] < rec["ate_bound_m"] and rec["pass"],
          f"corridor: ATE {rec['ate_rmse_m']} m, bound {rec['ate_bound_m']}")
    print(f"corridor, {N_CORRIDOR} frames 376x1241, adaptive, BA window 5: "
          f"ATE {rec['ate_rmse_m']:.5f} m of a {rec['ate_bound_m']} m bound "
          f"(path {rec['gt_path_len_m']} m), RPE {rec['rpe_trans_m']:.5f} m / "
          f"{rec['rpe_rot_deg']:.4f} deg, {rec['frames_per_s']:.3f} frames/s, "
          f"BA {rec['ba']} [{card}]")
    return launches


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from edge_based_visual_odometry_tpu_torch.config import VOConfig
    from edge_based_visual_odometry_tpu_torch.io import synthetic as S
    from edge_based_visual_odometry_tpu_torch.models import motion_tracker as MT
    from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
    from edge_based_visual_odometry_tpu_torch.ops import clustering as CL
    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
    from edge_based_visual_odometry_tpu_torch.ops import descriptors as DESC
    from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
    from edge_based_visual_odometry_tpu_torch.ops import patches as PAT
    from edge_based_visual_odometry_tpu_torch.ops import pose as POSE
    from edge_based_visual_odometry_tpu_torch.ops import toed
    from edge_based_visual_odometry_tpu_torch.utils import timing as TIM

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)    # card name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    CB.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{CB.library_path().relative_to(CB.BUILD_DIR.parents[1])}")
    for ln in CB.ptxas_log().splitlines():
        if ln.startswith("==") or "entry function" in ln or "spill" in ln \
                or "Used" in ln:
            print("ptxas: " + ln.strip())

    H, W = 376, 1241
    N_SEQ = 6            # frames of phase 7; phases 3-6 use the first 3
    seq = S.make_sequence(n_frames=N_SEQ, h=H, w=W)
    seq_images = [(u8(f.left), u8(f.right)) for f in seq.frames]
    frames = seq_images[:3]
    cfg = VOConfig()
    kernels = []

    # ---- 3. K1 vs plain ----
    img = torch.stack([torch.as_tensor(a) for a in frames[0]]).to(
        dev, torch.float32).contiguous()
    out_k = toed.toed_gradient_field_cuda(img, cfg.toed_kernel_size,
                                          cfg.toed_sigma)
    out_p = toed.toed_gradient_field_plain(img, cfg.toed_kernel_size,
                                           cfg.toed_sigma)
    torch.cuda.synchronize()
    err_k1 = 0.0
    for nm, a, b in zip(("Ix", "Iy", "mag"), out_k[:3], out_p[:3]):
        check(bool(torch.isfinite(a).all()), f"K1 {nm} not finite")
        d = (a - b).abs()
        bad = int((d > 2e-3 + 2e-4 * b.abs()).sum())
        err_k1 = max(err_k1, float(d.max()))
        check(bad == 0, f"K1 {nm}: {bad} values beyond rtol 2e-4 atol 2e-3 "
                        f"(max abs err {float(d.max()):.3g})")
    m = out_p[2] > 2.0
    d = (out_k[3] - out_p[3]).abs()[m]
    d = torch.minimum(d, 2 * np.pi - d)
    q_or = float(torch.quantile(d.double().cpu(), 0.999))
    check(q_or < 1e-3, f"K1 orient 99.9% quantile {q_or:.3g} rad >= 1e-3")
    n_diff = [int((a != b).sum()) for a, b in zip(out_k, out_p)]
    ms_k1 = cuda_ms(lambda: toed.toed_gradient_field_cuda(img), 50)
    ms_p1 = cuda_ms(lambda: toed.toed_gradient_field_plain(img), 20)
    w1 = with_bound(ms_k1, *k1_work(*img.shape))
    print(f"K1 toed_gradient_field (2x{H}x{W}): max abs err {err_k1:.3g}, "
          f"orient q99.9 {q_or:.3g} rad, values not bit-equal to the twin "
          f"(Ix, Iy, mag, orient) {n_diff}; kernel {ms_k1:.4f} ms, plain "
          f"{ms_p1:.3f} ms; bound {w1['bound_ms'] * 1e3:.1f} us "
          f"({w1['bound_by']}: {w1['flops']} flop, {w1['bytes']} B), "
          f"{w1['pct_of_bound']:.1f}% of bound")
    kernels.append(dict(
        name="toed_gradient_field", route="cuda",
        source="edge_based_visual_odometry_tpu_torch/csrc/toed_gradient_field.cu",
        replaces="edge_based_visual_odometry_tpu/ops/toed_pallas.py:131",
        max_abs_err=err_k1, plain_ms=ms_p1, library_ms=None, **w1,
        values_not_bit_equal=n_diff))

    # ---- 3b. NMS, subpixel fit and compaction vs the twin, bit for bit,
    # on K1's fields of frame 0; alone, and in place (detect_edges) ----
    nms_kw = dict(grad_mag_min=cfg.toed_grad_mag_min, border=cfg.toed_border)
    for M in (cfg.max_edges, 1024):
        e_k = toed.nms_compact_cuda(*out_k, H, W, M, **nms_kw)
        e_p = toed.nms_compact_plain(*out_k, H, W, M, **nms_kw)
        torch.cuda.synchronize()
        for b, (ek, ep) in enumerate(zip(e_k, e_p)):
            for nm, x, y in zip(ek._fields, ek, ep):
                same = x.dtype == y.dtype and x.shape == y.shape and (
                    f32_differ(x, y) == 0 if x.dtype == torch.float32
                    else bool(torch.equal(x, y)))
                check(same, f"toed_nms_compact (max_edges {M}) image {b}: "
                            f"{nm} differs from the twin")
        if M == cfg.max_edges:
            kept = [int(e.count) for e in e_k]
    check(min(kept) > 1024 and max(kept) < cfg.max_edges,
          f"toed_nms_compact: {kept} edges do not exercise both capacities")

    def nms():
        return toed.nms_compact_cuda(*out_k, H, W, cfg.max_edges, **nms_kw)

    def detect():
        return toed.detect_edges(
            img, cfg.toed_kernel_size, cfg.toed_sigma, cfg.toed_grad_mag_min,
            cfg.max_edges, cfg.toed_border)

    ms_n = cuda_ms(nms, 50)
    ms_n_alone = graph_ms(nms, 50)
    ms_np = cuda_ms(lambda: toed.nms_compact_plain(
        *out_k, H, W, cfg.max_edges, **nms_kw), 10)
    ms_det, ms_det_alone = cuda_ms(detect, 50), graph_ms(detect, 50)
    ms_k1_alone = graph_ms(lambda: toed.toed_gradient_field_cuda(img), 50)
    wn = launch_bound(ms_n, ms_n_alone,
                      *nms_work(2, H, W, kept, cfg.max_edges))
    print(f"toed_nms_compact (2x{2 * H}x{2 * W} fields, {kept} edges): "
          f"bit-equal to the twin at max_edges {cfg.max_edges} and 1024; "
          f"launches alone {ms_n_alone:.4f} ms, with the wrapper "
          f"{ms_n:.4f} ms, plain {ms_np:.3f} ms; bound "
          f"{wn['bound_ms'] * 1e3:.1f} us ({wn['bound_by']}: "
          f"{wn['bytes']} B), {wn['pct_of_bound']:.1f}% of bound; in place: "
          f"detect_edges {ms_det_alone:.4f} ms alone ({ms_det:.4f} with "
          f"the wrappers), K1 alone {ms_k1_alone:.4f} ms")
    kernels.append(dict(
        name="toed_nms_compact", route="cuda",
        source="edge_based_visual_odometry_tpu_torch/csrc/toed_nms_compact.cu",
        replaces="none (XLA ops: edge_based_visual_odometry_tpu/ops/toed.py "
                 "toed_nms_subpixel, extract_edges)",
        max_abs_err=0.0, plain_ms=ms_np, library_ms=None, **wn,
        detect_edges_ms=ms_det, detect_edges_launch_ms=ms_det_alone,
        k1_launch_ms=ms_k1_alone))

    # ---- 4. K2 vs plain, bit for bit, on the real stage-9 input ----
    cap = {}
    PL.build_stereo_step(seq.rig, cfg, dev)(*frames[0], gn_capture=cap)
    a, kw = cap["args"], cap["kwargs"]
    act = kw["active"]
    B = act.shape[0]
    n_act = int(act.sum())
    P, max_iter = kw["patch_size"], kw["max_iter"]
    alpha0 = torch.zeros(B, device=dev)
    gn_kw = dict(patch_size=P, max_iter=max_iter, tol=kw["tol"],
                 huber_delta=kw["huber_delta"], tile=kw["tile"])

    rp, dp = GN.refine_along_epipolar_plain(*a, alpha0, act, 0, max_iter,
                                            **gn_kw)
    rk, dk = GN.refine_along_epipolar_cuda(*a, alpha0, act, 0, max_iter,
                                           **gn_kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(rk.delta[act]).all()), "K2 alpha not finite")
    same_lanes((*rk, dk), (*rp, dp), act,
               f"K2 one {max_iter}-iteration launch")
    err_k2 = float((rk.delta - rp.delta).abs()[act].max())

    # the pipeline's two phases, recording each launch's operands; the
    # kernel reads the maps interleaved once, as refine_along_epipolar_batch
    # makes them
    maps4 = GN.interleave_maps(*a[1:4])
    lanes = tuple(t.contiguous() for t in a[4:])
    phase_kw = dict(phase1_iters=kw["phase1_iters"],
                    phase2_budget=kw["phase2_budget"], max_iter=max_iter,
                    chunk=kw["chunk"])
    calls_k, calls_p = [], []
    r2k = GN._two_phase(recorder(GN.refine_along_epipolar_cuda, a[:4], gn_kw,
                                 calls_k, maps4=maps4), B, lanes, act,
                        alpha0, **phase_kw)
    r2p = GN._two_phase(recorder(GN.refine_along_epipolar_plain, a[:4],
                                 gn_kw, calls_p), B, lanes, act, alpha0,
                        **phase_kw)
    r2b = GN.refine_along_epipolar_batch(*a, **kw)
    torch.cuda.synchronize()
    same_lanes(r2k, r2p, act, "K2 two phases")
    same_lanes(r2k, r2b, act, "K2 two phases vs refine_along_epipolar_batch")
    check(len(calls_k) == 2, f"K2: {len(calls_k)} launches for two phases")

    # timing: each form on the interleaved maps; bound from the iterations
    # run. The interleave is timed apart: the pipeline makes it once per
    # frame for both phases.
    ms_maps4 = cuda_ms(lambda: GN.interleave_maps(*a[1:4]), 50)
    print(f"K2 maps interleave (torch.stack of right, gx, gy into "
          f"{H}x{W}x4 float32): {ms_maps4:.4f} ms once per frame")
    forms = {f"one_launch_{max_iter}": ((*a[4:],), alpha0, 0, max_iter, act)}
    forms["phase1"], forms["phase2"] = calls_k
    k2 = gn_forms(
        lambda args, d0, it0, it_stop, fact: GN.refine_along_epipolar_cuda(
            *a[:4], *args, d0, fact, it0, it_stop, maps4=maps4, **gn_kw),
        forms, k2_work, P, H, W)
    for form, row in k2.items():
        print(f"K2 {form}: {row['lanes']} lanes, {row['active']} active, "
              f"{row['iterations']} lane-iterations; {row['ms']:.4f} ms; "
              f"bound {row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}), "
              f"{row['pct_of_bound']:.1f}% of it; FMA-free bound "
              f"{row['bound_ms_no_fma'] * 1e3:.1f} us, "
              f"{row['pct_of_bound_no_fma']:.1f}% of it")
    ms_p2 = cuda_ms(lambda: GN.refine_along_epipolar_plain(
        *a, alpha0, act, 0, max_iter, **gn_kw), 3)
    w2 = k2[f"one_launch_{max_iter}"]
    print(f"K2 refine_along_epipolar (B={B}, active {n_act}): bit-equal to "
          f"its twin on every active lane, as one launch and as two phases; "
          f"plain {ms_p2:.3f} ms; one frame's two phases "
          f"{k2['phase1']['ms'] + k2['phase2']['ms']:.4f} ms + interleave "
          f"{ms_maps4:.4f} ms")
    kernels.append(dict(
        name="refine_along_epipolar", route="cuda",
        source="edge_based_visual_odometry_tpu_torch/csrc/epipolar_gn.cu",
        replaces="edge_based_visual_odometry_tpu/ops/gn_pallas.py:218",
        max_abs_err=err_k2, plain_ms=ms_p2, library_ms=None,
        maps_interleave_ms=ms_maps4, **w2,
        forms={f: {k: r[k] for k in (
            "ms", "bound_ms", "bound_by", "pct_of_bound", "bound_ms_no_fma",
            "pct_of_bound_no_fma", "lanes", "active", "iterations")}
            for f, r in k2.items()}))

    # ---- 5. small input: plain twins on the CPU vs kernels on the GPU ----
    small_cfg = VOConfig(max_edges=1024, max_candidates=8, gather_slots=64,
                         max_mates=512, max_refine_pairs=1024,
                         max_quad_candidates=8, quad_gather_slots=144,
                         ransac_max_iterations=256, gn_max_iter=4)
    small = S.make_sequence(n_frames=2, h=120, w=160)
    runs = {}
    for d in ("cpu", dev):
        pipe = PL.VOPipeline(small.rig, small_cfg, device=d)
        runs[str(d)] = [pipe.run_frame(u8(f.left), u8(f.right))
                        for f in small.frames]
    for k, ((fc, tc), (fg, tg)) in enumerate(zip(runs["cpu"], runs[str(dev)])):
        sc = fc.stereo_metrics[:, 1].numpy()
        sg = fg.stereo_metrics[:, 1].cpu().numpy()
        check(bool(np.all(np.abs(sc - sg) <= 0.05 * sc + 5)),
              f"small frame {k}: stage rows differ cpu {sc} gpu {sg}")
        mc, mg = int(fc.mates.count), int(fg.mates.count)
        check(min(mc, mg) >= 0.97 * max(mc, mg),
              f"small frame {k}: mates cpu {mc} gpu {mg}")
    print(f"small 120x160: cpu vs gpu stage rows within 5%+5, mates "
          f"{[int(r[0].mates.count) for r in runs['cpu']]} vs "
          f"{[int(r[0].mates.count) for r in runs[str(dev)]]}")

    # ---- 6. the production frame through VOPipeline ----
    pipe = PL.VOPipeline(seq.rig, cfg, device=dev,
                         keyframe_policy="every_frame")
    # the prediction-mode temporal step (frame 2) keeps its arguments, and
    # the operands it gives K3 (refine_2dof_pair_batch, both sides)
    predict, pred_args, k3_ops = pipe._temporal_step, [], []

    def recording_predict(*step_args):
        pred_args[:] = [step_args]
        batch = GN.refine_2dof_pair_batch

        def rec(*a3, **kw3):
            k3_ops.append((a3, kw3))
            return batch(*a3, **kw3)
        GN.refine_2dof_pair_batch = rec
        try:
            return predict(*step_args)
        finally:
            GN.refine_2dof_pair_batch = batch

    # the operands of the last stereo and temporal calls of cluster_edges
    # (frame 2's) for phase 6c
    cluster, cl_ops = CL.cluster_edges, {}

    def recording_cluster(*a, **kw):
        cl_ops["temporal" if kw["by_orientation"] else "stereo"] = (a, kw)
        return cluster(*a, **kw)

    # the operands of the three edge_descriptors calls of the last stereo
    # step (frame 2's) for phase 6d
    describe, desc_ops = DESC.edge_descriptors, []

    def recording_describe(*a, **kw):
        desc_ops[:] = desc_ops[-2:] + [(a, kw)]
        return describe(*a, **kw)

    # the operands of the last K6 call of each kind (frame 2's) for phase
    # 6e, and of the four edge_patches calls of the last stereo step for
    # phase 6f
    gate_ops, patch_ops = {}, []
    gates = {kind: getattr(PAT, f"dense_gates_{kind}")
             for kind in ("stereo", "flat", "temporal")}

    def recording_gates(kind):
        def run(*a, **kw):
            gate_ops[kind] = (a, kw)
            return gates[kind](*a, **kw)
        return run

    sample = PAT.edge_patches_flat

    def recording_patches(*a, **kw):
        patch_ops.append((a, kw))
        return sample(*a, **kw)

    # the operands of the last temporal step's (frame 2's) estimate_pose,
    # its two K8 and four K9 calls for phase 6h
    pose_ops = {"k8": [], "k9": [], "est": None}
    count, normal_eq, estimate = (POSE.ransac_counts,
                                  POSE.pose_gn_normal_equations,
                                  MT.estimate_pose)

    def recording_count(*a, **kw):
        pose_ops["k8"].append((a, kw))
        return count(*a, **kw)

    def recording_normal_eq(*a, **kw):
        pose_ops["k9"].append((a, kw))
        return normal_eq(*a, **kw)

    def recording_estimate(*a, **kw):
        pose_ops.update(k8=[], k9=[], est=a)
        return estimate(*a, **kw)

    # StageTimer.timed waits for the card before and after each step
    timer = TIM.StageTimer()
    stereo = pipe._stereo_step
    pipe._stereo_step = functools.partial(timer.timed, "stereo step",
                                          stereo)
    pipe._temporal_step = functools.partial(timer.timed, "temporal step",
                                            recording_predict)
    pipe._temporal_step_boot = functools.partial(
        timer.timed, "temporal step", pipe._temporal_step_boot)
    torch.cuda.synchronize()
    CB.reset_launch_counts()
    per_frame = []
    CL.cluster_edges = recording_cluster
    DESC.edge_descriptors = recording_describe
    PAT.edge_patches_flat = recording_patches
    for kind in gates:
        setattr(PAT, f"dense_gates_{kind}", recording_gates(kind))
    POSE.ransac_counts = recording_count
    POSE.pose_gn_normal_equations = recording_normal_eq
    MT.estimate_pose = recording_estimate
    try:
        with K3Watch() as watch:
            for k, (l, r) in enumerate(frames):
                patch_ops.clear()
                before = dict(CB.LAUNCHES)
                t = time.perf_counter()
                fr, tr = pipe.run_frame(l, r)
                torch.cuda.synchronize()
                frame_ms = (time.perf_counter() - t) * 1e3
                step_ms = {nm.split()[0]: ts[-1] * 1e3
                           for nm, ts in timer.times.items()}
                per_frame.append((fr, tr, {n: CB.LAUNCHES[n] - before[n]
                                           for n in before}, step_ms,
                                  frame_ms))
    finally:
        CL.cluster_edges = cluster
        DESC.edge_descriptors = describe
        PAT.edge_patches_flat = sample
        for kind, fn in gates.items():
            setattr(PAT, f"dense_gates_{kind}", fn)
        POSE.ransac_counts = count
        POSE.pose_gn_normal_equations = normal_eq
        MT.estimate_pose = estimate
    launches = dict(CB.LAUNCHES)
    k3_lanes = {"frame": watch.read("frame")}

    record = []
    for k, (fr, tr, dl, ms, frame_ms) in enumerate(per_frame):
        n_mates = int(fr.mates.count)
        rows = fr.stereo_metrics[:, 1].cpu().numpy().astype(int).tolist()
        check(dl["toed_gradient_field"] >= 1, f"frame {k}: K1 not launched")
        # NMS and compaction: the count and the write pass, both images
        check(dl["toed_nms_compact"] == 2 * dl["toed_gradient_field"],
              f"frame {k}: toed_nms_compact launched "
              f"{dl['toed_nms_compact']} times")
        check(dl["refine_along_epipolar"] >= 1, f"frame {k}: K2 not launched")
        # K3: two launches a temporal step, each for both sides
        check(dl["refine_2dof"] == (2 if k else 0),
              f"frame {k}: K3 launched {dl['refine_2dof']} times")
        # K4: once in the stereo step, once in the temporal step
        check(dl["cluster_edges"] == (2 if k else 1),
              f"frame {k}: K4 launched {dl['cluster_edges']} times")
        # K5: left edges, right edges, final mates
        check(dl["edge_descriptors"] == 3,
              f"frame {k}: K5 launched {dl['edge_descriptors']} times")
        # K6: stages 4-5 (the prep pass and the gates) and stage 11, and
        # the temporal step's prep pass and gates
        check(dl["dense_gates"] == (5 if k else 3),
              f"frame {k}: K6 launched {dl['dense_gates']} times")
        # K7: left edges, right edges, stage-11 centres, final mates
        check(dl["edge_patches"] == 4,
              f"frame {k}: K7 launched {dl['edge_patches']} times")
        # K8: the prescore and the full count; K9: the 4 refinement steps
        check(dl["ransac_score"] == (2 if k else 0)
              and dl["pose_gn"] == (4 if k else 0),
              f"frame {k}: K8 / K9 launched {dl['ransac_score']} / "
              f"{dl['pose_gn']} times")
        m = fr.mates
        v = m.valid
        check(m.gamma.shape == (cfg.max_mates, 3), f"frame {k}: gamma shape")
        check(bool(torch.isfinite(m.gamma[v]).all()
                   and torch.isfinite(m.right_x[v]).all()),
              f"frame {k}: non-finite mates")
        line = (f"frame {k}: edges L/R {int(fr.n_left_edges)}/"
                f"{int(fr.n_right_edges)}, mates {n_mates}, stage rows "
                f"{rows}, launches {dl}, stereo {ms['stereo']:.1f} ms")
        if k == 0:
            check(n_mates >= 21000, f"frame 0: mates {n_mates} < 21000")
            record.append(n_mates)
        else:
            ang, terr = rel_pose_err(tr, seq.frames[k - 1], seq.frames[k])
            n_q = int(tr.n_quads)
            check(bool(tr.success), f"frame {k}: pose not successful")
            check(bool(torch.isfinite(tr.R).all() and torch.isfinite(tr.t).all()),
                  f"frame {k}: non-finite pose")
            check(n_q >= 500, f"frame {k}: quads {n_q} < 500")
            check(ang < 0.2 and terr < 0.010,
                  f"frame {k}: pose error {ang:.4f} deg / {terr * 1e3:.2f} mm")
            record += [n_q, round(ang, 4), round(terr * 1e3, 2)]
            line += (f", temporal {ms['temporal']:.1f} ms, quads {n_q}, "
                     f"inlier ratio {float(tr.inlier_ratio):.3f}, pose err "
                     f"{ang:.4f} deg / {terr * 1e3:.2f} mm, temporal rows "
                     f"{tr.temporal_metrics[:, 1].cpu().numpy().astype(int).tolist()}")
        print(line + f", frame {frame_ms:.1f} ms")
    # this workload's record with the first version of the kernels
    pr1 = [23863, 32768, 0.051, 4.6, 32768, 0.0293, 1.83]
    print(f"workload record (mates; quads, deg, mm per frame): {record}; "
          f"{'equals' if record == pr1 else 'differs from'} the first "
          f"port's {pr1}")

    print(timer.report())
    pipe._temporal_step = functools.partial(timer.timed, "temporal step",
                                            predict)
    check(len(k3_ops) == 1 and len(pred_args) == 1,
          f"frame 2: {len(k3_ops)} refine_2dof_pair_batch calls recorded")
    split = temporal_split(predict, pred_args[0])
    print(f"temporal step of frame 2 (prediction mode), per stage, each "
          f"synchronised, mean of 3, ms: "
          + ", ".join(f"{nm} {ms:.2f}" for nm, ms in split.items())
          + f" [{card}]")
    split = stereo_split(stereo, frames[2])
    print(f"stereo step of frame 2, per stage, each synchronised, mean of "
          f"3, ms: " + ", ".join(f"{nm} {ms:.2f}" for nm, ms in split.items())
          + f" [{card}]")

    # ---- 6b. K3 vs plain, bit for bit, on frame 2's operands ----
    kernels.append(phase_k3(k3_ops, card, H, W))
    # ---- 6c. K4 vs plain, bit for bit, on frame 2's two calls ----
    kernels.append(phase_k4(cl_ops, card))
    # ---- 6d. K5 vs plain, bit for bit, on frame 2's three calls ----
    kernels.append(phase_k5(desc_ops, card))
    # ---- 6e. K6 vs plain, bit for bit, on frame 2's three calls ----
    kernels.append(phase_k6(gate_ops, card))
    # ---- 6f. K7 vs plain, bit for bit, on frame 2's four calls ----
    kernels.append(phase_k7(patch_ops, card))
    # ---- 6g. K2, K3, K6, K7 at P = 5, 9, 11, bit for bit, timed ----
    wide = phase_patch_sizes(seq, frames, card, launches, dev)
    for kd in kernels:
        if kd["name"] in PATCH_KERNELS:
            kd["by_patch_size"] = {P: w[kd["name"]] for P, w in wide.items()}
    # ---- 6h. K8 and K9 vs plain, bit for bit, on frame 2's calls ----
    kernels += phase_pose(pose_ops["k8"], pose_ops["k9"], pose_ops["est"],
                          card)

    # ---- 7, 8. the sequence path and the evaluation path ----
    work_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chip_smoke")
    shutil.rmtree(work_dir, ignore_errors=True)
    by_path = {"frame": launches}
    with K3Watch() as watch:
        by_path["sequence"] = phase_sequence(seq, seq_images, card, work_dir)
    k3_lanes["sequence"] = watch.read("sequence")
    with K3Watch() as watch:
        by_path["evaluation"] = phase_evaluation(seq, card, work_dir, dev)
    k3_lanes["evaluation"] = watch.read("evaluation")

    # ---- 9, 9b, 10. multi-device pair step, sharded BA, corridor ----
    with K3Watch() as watch:
        by_path["pair_step"] = phase_pair_step(seq, seq_images, card, dev)
    k3_lanes["pair_step"] = watch.read("pair step")
    phase_ba_ranks(card, work_dir)
    with K3Watch() as watch:
        by_path["corridor"] = phase_corridor(card, work_dir)
    k3_lanes["corridor"] = watch.read("corridor")
    print("K3 per path (calls of the sides entry, active lanes with a "
          "non-finite delta, lanes ended by the singular-lane guard): "
          + "; ".join(f"{p} {c} / {n} / {g}" for p, (c, n, g)
                      in k3_lanes.items()))
    # K4 once per stereo step (one K1 launch each) and once per temporal
    # step (two K3 launches each)
    for path, c in by_path.items():
        check(c["cluster_edges"] == c["toed_gradient_field"]
              + c["refine_2dof"] // 2,
              f"{path}: K4 launched {c['cluster_edges']} times for "
              f"{c['toed_gradient_field']} stereo and "
              f"{c['refine_2dof'] // 2} temporal steps")
    print("K4 launches per path (stereo + temporal steps): "
          + "; ".join(f"{p} {c['cluster_edges']}" for p, c in by_path.items()))
    # K5 three times per stereo step
    for path, c in by_path.items():
        check(c["edge_descriptors"] == 3 * c["toed_gradient_field"],
              f"{path}: K5 launched {c['edge_descriptors']} times for "
              f"{c['toed_gradient_field']} stereo steps")
    print("K5 launches per path (3 a stereo step): "
          + "; ".join(f"{p} {c['edge_descriptors']}"
                      for p, c in by_path.items()))
    # K6 three times per stereo step and twice per temporal step (each
    # prep pass one launch), K7 four times per stereo step
    for path, c in by_path.items():
        steps = (c["toed_gradient_field"], c["refine_2dof"] // 2)
        check(c["dense_gates"] == 3 * steps[0] + 2 * steps[1],
              f"{path}: K6 launched {c['dense_gates']} times for {steps[0]} "
              f"stereo and {steps[1]} temporal steps")
        check(c["edge_patches"] == 4 * steps[0],
              f"{path}: K7 launched {c['edge_patches']} times for "
              f"{steps[0]} stereo steps")
    print("K6 / K7 launches per path (3 a stereo and 2 a temporal step / 4 "
          "a stereo step): " + "; ".join(
              f"{p} {c['dense_gates']} / {c['edge_patches']}"
              for p, c in by_path.items()))
    # K8 twice and K9 four times per temporal step
    for path, c in by_path.items():
        steps = c["refine_2dof"] // 2
        check(c["ransac_score"] == 2 * steps and c["pose_gn"] == 4 * steps,
              f"{path}: K8 / K9 launched {c['ransac_score']} / "
              f"{c['pose_gn']} times for {steps} temporal steps")
    print("K8 / K9 launches per path (2 / 4 a temporal step): " + "; ".join(
        f"{p} {c['ransac_score']} / {c['pose_gn']}"
        for p, c in by_path.items()))

    # last, one more frame under torch.profiler: the kernels of a frame,
    # their time on the card, and the share of the frame's wall time they
    # fill (the profiler's own cost is in that wall time; it runs after
    # every timed phase, so that it cannot touch their times)
    with TIM.device_trace(os.path.join(work_dir, "trace")) as prof:
        t = time.perf_counter()
        pipe.run_frame(*seq_images[3])
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t) * 1e3
    on_card = TIM.device_ops(prof, torch.autograd.DeviceType.CUDA)
    dev_ms = sum(e.self_device_time_total for e in on_card) / 1e3
    check(dev_ms > 0, "traced frame 3: the profiler saw no device time")
    print(f"traced frame 3: {sum(e.count for e in on_card)} kernels and "
          f"copies (4,096 before K6 and K7), {dev_ms:.1f} ms "
          f"on the card in "
          f"{traced_ms:.1f} ms of wall time under the profiler (busy share "
          f"{dev_ms / traced_ms:.2f}) [{card}]")
    shutil.rmtree(work_dir, ignore_errors=True)

    for kd in kernels:
        kd["launches"] = launches[kd["name"]]
        kd["launches_per_frame"] = kd["launches"] / len(frames)
        kd["launches_by_path"] = {p: c[kd["name"]] for p, c in by_path.items()}
        for path, c in by_path.items():
            check(c[kd["name"]] >= 1,
                  f"{kd['name']} not launched on the {path} path")
    for kd in kernels:
        kd["card"] = card
        # bound_us and limiter ("flops" | "bytes") restate bound_ms and
        # bound_by in the units and words of PERF.md's kernel table
        kd["bound_us"] = kd["bound_ms"] * 1e3
        kd["limiter"] = ("flops" if kd["bound_by"] == "operations"
                         else "bytes")
    print(json.dumps({"kernels": [
        {k: kd[k] for k in (
            "name", "route", "source", "replaces", "launches",
            "launches_per_frame", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "bound_us", "limiter", "pct_of_bound", "library_ms",
            "flops", "bytes", "card")}
        | {k: v for k, v in kd.items() if k in (
            "bound_ms_no_fma", "pct_of_bound_no_fma", "maps_interleave_ms",
            "values_not_bit_equal", "forms", "launches_by_path",
            "step_launches_ms", "glue_ms", "pair_batch_ms",
            "per_side_form_ms", "watch_ms", "phase2_lanes", "occupancy",
            "against_jax_max_ulps", "against_jax_max_err", "calls",
            "launch_ms", "pct_of_bound_with_wrapper", "by_patch_size",
            "estimate_pose_ms", "estimate_pose_on_twins_ms",
            "detect_edges_ms", "detect_edges_launch_ms", "k1_launch_ms")}
        for kd in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
