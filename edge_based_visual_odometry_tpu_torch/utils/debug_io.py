"""Debug/analysis file writers (reference include/io.h:14-211 +
Stereo_Matches.cpp:1656-1699, Temporal_Matches.cpp:1066-1112).

Port of `edge_based_visual_odometry_tpu/utils/debug_io.py`: same text
formats and column layouts. The writers take tensors on any device (or
numpy arrays) and move each to numpy once.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from edge_based_visual_odometry_tpu_torch import geometry as geom
from edge_based_visual_odometry_tpu_torch.models.types import (
    to_numpy as _np)


def write_toed_edges(path: str, edges) -> None:
    """Raw TOED edge dump: x y orientation per line
    (reference io.h:183-211 write_TOED_edges)."""
    n = int(edges.count)
    x = _np(edges.x)[:n]
    y = _np(edges.y)[:n]
    t = _np(edges.theta)[:n]
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"{x[i]} {y[i]} {t[i]}\n")


def write_finalized_stereo_pairs(path: str, mates, rig) -> None:
    """Finalized stereo edge pairs with reconstructed 3D point + tangent
    (reference write_finalized_stereo_edge_pairs_to_file,
    Stereo_Matches.cpp:1656-1699). Column layout matches the reference
    header line."""
    n = int(mates.count)
    lx = _np(mates.left_x)[:n]
    ly = _np(mates.left_y)[:n]
    lt = _np(mates.left_theta)[:n]
    rx = _np(mates.right_x)[:n]
    ry = _np(mates.right_y)[:n]
    rt = _np(mates.right_theta)[:n]

    dev = rig.K_left_inv.device

    def t32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    g1 = geom.pixel_to_ray(rig.K_left_inv, t32(np.stack([lx, ly], -1)))
    g2 = geom.pixel_to_ray(rig.K_right_inv, t32(np.stack([rx, ry], -1)))
    G = _np(geom.backproject_two_rays(rig.R21, rig.T21, g1, g2))
    t1 = geom.theta_to_ray_tangent(rig.K_left_inv, t32(lt))
    t2 = geom.theta_to_ray_tangent(rig.K_right_inv, t32(rt))
    T1 = geom.reconstruct_3d_tangent(rig.R21, g1, g2, t1, t2)
    pt1 = _np(geom.project_3d_tangent_to_2d(T1, g1))
    # NOTE: T1 is deliberately NOT rotated by R21 before projecting at the
    # right-camera gamma - the reference writes projected_T_2 =
    # project(T_1, gamma_2) with the unrotated left-frame tangent
    # (Stereo_Matches.cpp:1687-1688); reproduced for column-exact parity
    # with its MATLAB consumers (the temporal matcher's own transport does
    # rotate).
    pt2 = _np(geom.project_3d_tangent_to_2d(T1, g2))
    T1 = _np(T1)

    with open(path, "w") as f:
        f.write("left_edge_location, left_edge_orientation, "
                "right_edge_location, right_edge_orientation, "
                "left_edge_3D_point, left_edge_tangent\n")
        for i in range(n):
            f.write(f"{lx[i]} {ly[i]} {lt[i]} {rx[i]} {ry[i]} {rt[i]} "
                    f"{G[i, 0]} {G[i, 1]} {G[i, 2]} "
                    f"{T1[i, 0]} {T1[i, 1]} {T1[i, 2]} "
                    f"{pt1[i, 0]} {pt1[i, 1]} {pt2[i, 0]} {pt2[i, 1]}\n")


def write_quads(path: str, kf_mates, quads, kf_idx: int, cf_idx: int) -> None:
    """Quad CSV dump (reference write_quads_to_file,
    Temporal_Matches.cpp:1066-1112): one row per surviving candidate quad."""
    rm = _np(quads.row_mask)
    cm = _np(quads.cmask)
    klx = _np(kf_mates.left_x)
    kly = _np(kf_mates.left_y)
    krx = _np(kf_mates.right_x)
    kry = _np(kf_mates.right_y)
    lcx = _np(quads.lcx)
    lcy = _np(quads.lcy)
    rcx = _np(quads.rcx)
    rcy = _np(quads.rcy)
    with open(path, "w") as f:
        f.write("# keyframe %d <-> current frame %d\n" % (kf_idx, cf_idx))
        f.write("kf_left_x,kf_left_y,kf_right_x,kf_right_y,"
                "cf_left_x,cf_left_y,cf_right_x,cf_right_y\n")
        rows, cols = np.nonzero(cm & rm[:, None])
        for r, c in zip(rows, cols):
            f.write(f"{klx[r]},{kly[r]},{krx[r]},{kry[r]},"
                    f"{lcx[r, c]},{lcy[r, c]},{rcx[r, c]},{rcy[r, c]}\n")


def write_disparities(path: str, mates, frame_idx: int) -> None:
    """Disparity dump (reference record_disparities,
    Stereo_Matches.cpp:491-532)."""
    n = int(mates.count)
    lx = _np(mates.left_x)[:n]
    ly = _np(mates.left_y)[:n]
    rx = _np(mates.right_x)[:n]
    ry = _np(mates.right_y)[:n]
    gx = _np(mates.gt_x)[:n]
    with open(path, "w") as f:
        f.write(f"# Disparity values for frame {frame_idx}\n")
        f.write("# Columns: left_x\tleft_y\tright_x\tright_y\t"
                "estimated_disp\tgt_disp\tdisp_error\n")
        for i in range(n):
            est = lx[i] - rx[i]
            if gx[i] >= 0:
                gt = lx[i] - gx[i]
                err = est - gt
            else:
                gt = float("nan")
                err = float("nan")
            f.write(f"{lx[i]}\t{ly[i]}\t{rx[i]}\t{ry[i]}\t{est}\t{gt}\t{err}\n")


def write_filter_distribution(path: str, filter_name: str, frame_idx: int,
                              values, is_gt, mask) -> None:
    """Per-candidate filter-score distribution with veridical flags, in
    the reference's record_Filter_Distribution text format
    (Stereo_Matches.cpp:421-452): header + 'filter_value\\tis_GT' rows."""
    values = _np(values)
    is_gt = _np(is_gt).astype(int)
    mask = _np(mask).astype(bool)
    v = values[mask]
    g = is_gt[mask]
    with open(path, "w") as f:
        f.write(f"# {filter_name} distribution for frame {frame_idx}\n")
        f.write(f"# Total values: {v.size} (Veridical: {int(g.sum())}, "
                f"Non-veridical: {int(v.size - g.sum())})\n")
        f.write("filter_value\tis_GT\n")
        for vi, gi in zip(v, g):
            f.write(f"{vi}\t{gi}\n")


def write_ambiguity_distribution(path: str, stage_name: str, frame_idx: int,
                                 counts, row_mask) -> None:
    """Per-edge candidate-count distribution, reference
    record_Ambiguity_Distribution format (Stereo_Matches.cpp:454-489)."""
    counts = _np(counts)
    rm = _np(row_mask).astype(bool)
    c = counts[rm]
    with open(path, "w") as f:
        f.write(f"# Ambiguity distribution for stage: {stage_name} "
                f"| Frame: {frame_idx}\n")
        f.write(f"# Total edges: {c.size}\n")
        f.write("num_candidates\n")
        for ci in c:
            f.write(f"{int(ci)}\n")


def write_distributions(output_dir: str, frame_idx: int, dists: dict) -> None:
    """Write every entry of a match_stereo(record_distributions=True)
    dict: '<name>' -> <name>_frame_N.txt, '<stage>_ambiguity' ->
    ambiguity_<stage>_frame_N.txt (reference filename conventions)."""
    for name, payload in dists.items():
        if name.endswith("_state") or name == "right_edges_xyt":
            continue   # cascade-state snapshots (write_eval_cluster_dumps)
        if name.endswith("_ambiguity"):
            stage = name[: -len("_ambiguity")]
            write_ambiguity_distribution(
                os.path.join(output_dir,
                             f"ambiguity_{stage}_frame_{frame_idx}.txt"),
                stage, frame_idx, *payload)
        else:
            write_filter_distribution(
                os.path.join(output_dir, f"{name}_frame_{frame_idx}.txt"),
                name, frame_idx, *payload)


# --------------------------------------------------------------------------
# per-cluster evaluation writers (reference io.h:14-160). These consume the
# cascade-state snapshots recorded by match_stereo(record_distributions=
# True): "shift_state" (post epipolar shift), "photo_refine_state" (post
# 1-DoF GN), "cluster_state" (post clustering), plus "right_edges_xyt".
# --------------------------------------------------------------------------

def _tp_flags(st, tol: float):
    """Per-candidate TP flag vs the GT location (reference b_is_TP)."""
    d = np.sqrt((_np(st.cx) - _np(st.gt_x)[:, None]) ** 2
                + (_np(st.cy) - _np(st.gt_y)[:, None]) ** 2)
    return (_np(st.cmask) & (d <= tol)
            & (_np(st.gt_x)[:, None] >= 0)), d


def write_photo_refine_eval(path: str, refine_state, tol: float) -> None:
    """Per-candidate photometric-refinement evaluation rows (reference
    write_Evaluated_Photometric_Refinement_Data_to_file, io.h:14-34):
    is_TP, left index, refine score, confidence, validity, x, y, theta."""
    st = refine_state
    tp, _ = _tp_flags(st, tol)
    cm = _np(st.cmask)
    cx, cy, ct = (_np(a) for a in (st.cx, st.cy, st.ctheta))
    score, conf = _np(st.ncc), _np(st.desc_dist)
    rows, slots = np.nonzero(cm)
    with open(path, "w") as f:
        f.write("is_TP, left_edge_index, refine_final_score, "
                "refine_confidence, refine_validity\n")
        for r, c in zip(rows, slots):
            f.write(f"{int(tp[r, c])} {r} {score[r, c]} {conf[r, c]} 1 "
                    f"{cx[r, c]} {cy[r, c]} {ct[r, c]}\n")


def write_matching_clusters_eval(path: str, shift_state, refine_state,
                                 tol: float) -> None:
    """Clusters that were TP after the epipolar shift but lost TP through
    photometric refinement (reference
    write_Evaluated_Matching_Edge_Clusters_Data_to_file, io.h:39-69)."""
    tp_s, _ = _tp_flags(shift_state, tol)
    tp_r, _ = _tp_flags(refine_state, tol)
    lost = tp_s & ~tp_r & _np(refine_state.cmask)
    lx = _np(refine_state.lx)
    ly = _np(refine_state.ly)
    lt = _np(refine_state.ltheta)
    gx = _np(refine_state.gt_x)
    gy = _np(refine_state.gt_y)
    sx, sy, st_ = (_np(a) for a in
                   (shift_state.cx, shift_state.cy, shift_state.ctheta))
    rx, ry, rt = (_np(a) for a in
                  (refine_state.cx, refine_state.cy, refine_state.ctheta))
    rows, slots = np.nonzero(lost)
    with open(path, "w") as f:
        f.write("left_edge_index, left_edge_location, left_edge_orientation,"
                " GT_location, shifting_center_edge_location,"
                " shifting_center_edge_orientation,"
                " photometric_refinement_center_edge_location,"
                " photometric_refinement_center_edge_orientation\n")
        for r, c in zip(rows, slots):
            f.write(f"{r} {lx[r]} {ly[r]} {lt[r]} {gx[r]} {gy[r]} "
                    f"{sx[r, c]} {sy[r, c]} {st_[r, c]} "
                    f"{rx[r, c]} {ry[r, c]} {rt[r, c]}\n")


def write_false_negative_clusters(path: str, contributing_path: str,
                                  cluster_state, refine_state,
                                  right_edges_xyt, tol: float) -> None:
    """False-negative clusters after clustering + their contributing edges
    (reference write_False_Negative_Edge_Clusters_to_file, io.h:117-160).
    Contributing edges = the refine-stage candidates of the same row
    (the pre-cluster members), with their raw TOED right-edge rows."""
    st = cluster_state
    tp, d = _tp_flags(st, tol)
    has_gt = _np(st.gt_x) >= 0
    fn = (_np(st.cmask) & ~tp & has_gt[:, None])
    lx, ly, lt = (_np(a) for a in (st.lx, st.ly, st.ltheta))
    gx, gy = _np(st.gt_x), _np(st.gt_y)
    cx, cy, ct = (_np(a) for a in (st.cx, st.cy, st.ctheta))
    rows, slots = np.nonzero(fn)
    with open(path, "w") as f:
        f.write("left_edge_location, left_edge_orientation, GT_location, "
                "center_edge_location, center_edge_orientation, "
                "dist_error_to_GT\n")
        for r, c in zip(rows, slots):
            f.write(f"{lx[r]} {ly[r]} {lt[r]} {gx[r]} {gy[r]} "
                    f"{cx[r, c]} {cy[r, c]} {ct[r, c]} {d[r, c]}\n")

    tx, ty, tt = (_np(a) for a in right_edges_xyt)
    rcm = _np(refine_state.cmask)
    rcx, rcy, rct = (_np(a) for a in
                     (refine_state.cx, refine_state.cy, refine_state.ctheta))
    ridx = _np(refine_state.cand_idx)
    fn_rows = sorted(set(rows.tolist()))
    with open(contributing_path, "w") as f:
        f.write("false_negative_edge_cluster_index, "
                "contributing_edge_shifted_location, "
                "contributing_edge_shifted_orientation, "
                "contributing_toed_location, contributing_toed_orientation\n")
        for i, r in enumerate(fn_rows):
            for c in np.nonzero(rcm[r])[0]:
                k = ridx[r, c]
                f.write(f"{i} {rcx[r, c]} {rcy[r, c]} {rct[r, c]} "
                        f"{tx[k]} {ty[k]} {tt[k]}\n")


def write_eval_cluster_dumps(output_dir: str, frame_idx: int, dists: dict,
                             tol: float) -> None:
    """Drive the three io.h evaluation writers from a
    match_stereo(record_distributions=True) dict (GT datasets only)."""
    shift = dists.get("shift_state")
    refine = dists.get("photo_refine_state")
    cluster = dists.get("cluster_state")
    rxyt = dists.get("right_edges_xyt")
    if shift is None or refine is None or cluster is None or rxyt is None:
        return
    write_photo_refine_eval(
        os.path.join(output_dir,
                     "photo_refine_data_from_evaluation_statistics_frame_"
                     f"{frame_idx}.txt"), refine, tol)
    write_matching_clusters_eval(
        os.path.join(output_dir,
                     f"matching_edge_clusters_data_frame_{frame_idx}.txt"),
        shift, refine, tol)
    write_false_negative_clusters(
        os.path.join(output_dir,
                     f"false_negative_edge_clusters_frame_{frame_idx}.txt"),
        os.path.join(output_dir, "false_negative_edge_clusters_"
                     f"contributing_edges_frame_{frame_idx}.txt"),
        cluster, refine, rxyt, tol)
