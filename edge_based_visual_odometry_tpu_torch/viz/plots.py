"""Offline plots over the pipeline's text dumps.

Copy of `edge_based_visual_odometry_tpu/viz/plots.py` (the dump formats
are the same in both packages); `dump_ncc_debug` samples and scores with
the port's `ops/patches.py`.

Each plotting function mirrors one of the reference's MATLAB analysis
scripts (reference test/*.m); the loaders parse the dump formats written
by utils/debug_io.py, which themselves match the reference's io.h writers
column-for-column. Everything renders headless (Agg) straight to a file.

Reference script -> function map:
  test/visualize_edges.m, test/test_visualize_edges.m -> plot_edges_on_image
  test/edges_on_imgs.m                                -> plot_stereo_pairs
  test/visualize_stereo_matches.m                     -> plot_match_triage
  test/visualize_kf_cf_edges.m, visualize_kf_cf_projection.m -> plot_quads
  test/plot_distribution.m, plot_all_distributions.m  -> plot_filter_distribution
  test/plot_edge_count_distribution.m, visualize_proximity_histogram.m
                                                      -> plot_ambiguity_distribution
  test/kitti_vis.m, test/euroc_vis.m                  -> plot_trajectory
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


# --------------------------------------------------------------------------
# loaders for the debug_io / metrics text formats
# --------------------------------------------------------------------------

def load_toed_edges(path: str) -> dict:
    """Parse a write_toed_edges dump: `x y orientation` per line."""
    data = np.loadtxt(path, ndmin=2)
    if data.size == 0:
        data = np.zeros((0, 3))
    return {"x": data[:, 0], "y": data[:, 1], "theta": data[:, 2]}


def load_finalized_pairs(path: str) -> dict:
    """Parse a write_finalized_stereo_pairs dump (1 header line + 16
    numeric columns, same layout the reference's edges_on_imgs.m reads
    with readmatrix(NumHeaderLines=1))."""
    data = np.loadtxt(path, skiprows=1, ndmin=2)
    if data.size == 0:
        data = np.zeros((0, 16))
    return {
        "left_x": data[:, 0], "left_y": data[:, 1], "left_theta": data[:, 2],
        "right_x": data[:, 3], "right_y": data[:, 4], "right_theta": data[:, 5],
        "point3d": data[:, 6:9], "tangent3d": data[:, 9:12],
        "tangent2d_left": data[:, 12:14], "tangent2d_right": data[:, 14:16],
    }


def load_disparities(path: str) -> dict:
    """Parse a write_disparities dump (2 comment lines + 7 tab columns)."""
    data = np.loadtxt(path, comments="#", ndmin=2)
    if data.size == 0:
        data = np.zeros((0, 7))
    return {
        "left_x": data[:, 0], "left_y": data[:, 1],
        "right_x": data[:, 2], "right_y": data[:, 3],
        "est_disp": data[:, 4], "gt_disp": data[:, 5], "disp_err": data[:, 6],
    }


def load_quads(path: str) -> dict:
    """Parse a write_quads dump (comment line + CSV header + 8 columns)."""
    data = np.loadtxt(path, comments="#", delimiter=",", skiprows=2, ndmin=2)
    if data.size == 0:
        data = np.zeros((0, 8))
    keys = ["kf_left_x", "kf_left_y", "kf_right_x", "kf_right_y",
            "cf_left_x", "cf_left_y", "cf_right_x", "cf_right_y"]
    return {k: data[:, i] for i, k in enumerate(keys)}


def load_filter_distribution(path: str) -> dict:
    """Parse a write_filter_distribution dump: 2 comment lines +
    `filter_value\tis_GT` header + rows."""
    data = np.loadtxt(path, comments="#", skiprows=3, ndmin=2)
    if data.size == 0:
        data = np.zeros((0, 2))
    return {"values": data[:, 0], "is_gt": data[:, 1].astype(bool)}


def load_ambiguity_distribution(path: str) -> np.ndarray:
    """Parse a write_ambiguity_distribution dump: per-edge candidate counts."""
    data = np.loadtxt(path, comments="#", skiprows=3, ndmin=1)
    return np.atleast_1d(data).astype(int)


def load_trajectory_tum(path: str) -> dict:
    """Parse a TUM trajectory file: `timestamp tx ty tz qx qy qz qw`."""
    data = np.loadtxt(path, comments="#", ndmin=2)
    if data.size == 0:
        data = np.zeros((0, 8))
    return {"t": data[:, 0], "pos": data[:, 1:4], "quat": data[:, 4:8]}


def _load_image(img) -> Optional[np.ndarray]:
    """Accept an ndarray, a path, or None."""
    if img is None or isinstance(img, np.ndarray):
        return img
    return plt.imread(img)


def _show_image(ax, img: Optional[np.ndarray], width: float, height: float):
    if img is not None:
        ax.imshow(img, cmap="gray", origin="upper")
    else:
        ax.set_xlim(0, width)
        ax.set_ylim(height, 0)
        ax.set_aspect("equal")


# --------------------------------------------------------------------------
# plots
# --------------------------------------------------------------------------

def plot_edges_on_image(out_path: str, edges: dict, image=None,
                        tick_len: float = 3.0, title: str = "TOED edges"):
    """Edge overlay with short orientation ticks (reference
    test/visualize_edges.m draws line segments along each edge's
    orientation; test_visualize_edges.m the scatter variant)."""
    img = _load_image(image)
    x, y, th = edges["x"], edges["y"], edges.get("theta")
    fig, ax = plt.subplots(figsize=(12, 5))
    _show_image(ax, img, x.max() + 10 if x.size else 100,
                y.max() + 10 if y.size else 100)
    ax.plot(x, y, ".", color="tab:red", markersize=1.5)
    if th is not None and x.size:
        dx, dy = tick_len * np.cos(th), tick_len * np.sin(th)
        # one LineCollection-style call: interleave with NaN separators
        segs_x = np.column_stack([x - dx, x + dx, np.full_like(x, np.nan)]).ravel()
        segs_y = np.column_stack([y - dy, y + dy, np.full_like(y, np.nan)]).ravel()
        ax.plot(segs_x, segs_y, "-", color="tab:orange", linewidth=0.4)
    ax.set_title(f"{title} ({x.size} edges)")
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def _montage(ax, left_img, right_img, lw: float, lh: float):
    """Side-by-side montage; returns the x shift for right-image coords
    (reference edges_on_imgs.m: img_combined = [left, right])."""
    if left_img is not None and right_img is not None:
        ax.imshow(np.concatenate([left_img, right_img], axis=1),
                  cmap="gray", origin="upper")
    else:
        ax.set_xlim(0, 2 * lw)
        ax.set_ylim(lh, 0)
        ax.set_aspect("equal")
    return lw


def plot_stereo_pairs(out_path: str, pairs: dict, left_image=None,
                      right_image=None, image_width: Optional[float] = None,
                      n_links: int = 100, seed: int = 0):
    """Side-by-side stereo montage: all left edges red, all right edges
    green, a random subset of pair links (reference test/edges_on_imgs.m,
    '100 Random Connections')."""
    li, ri = _load_image(left_image), _load_image(right_image)
    lx, ly = pairs["left_x"], pairs["left_y"]
    rx, ry = pairs["right_x"], pairs["right_y"]
    w = image_width or (li.shape[1] if li is not None
                        else (max(lx.max(), rx.max()) + 10 if lx.size else 100))
    h = (li.shape[0] if li is not None
         else (max(ly.max(), ry.max()) + 10 if ly.size else 100))
    fig, ax = plt.subplots(figsize=(14, 5))
    shift = _montage(ax, li, ri, w, h)
    ax.plot(lx, ly, ".", color="tab:red", markersize=2, label="left edges")
    ax.plot(rx + shift, ry, ".", color="tab:green", markersize=2,
            label="right edges")
    if lx.size:
        k = min(n_links, lx.size)
        sel = np.random.default_rng(seed).choice(lx.size, size=k, replace=False)
        link_x = np.column_stack(
            [lx[sel], rx[sel] + shift, np.full(k, np.nan)]).ravel()
        link_y = np.column_stack([ly[sel], ry[sel], np.full(k, np.nan)]).ravel()
        ax.plot(link_x, link_y, "-", color="tab:cyan", linewidth=0.5, alpha=0.7)
    ax.set_title(f"Stereo edge pairs: {lx.size} mates, {min(n_links, lx.size)} "
                 "random links")
    ax.legend(loc="lower right", fontsize=8)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def plot_match_triage(out_path: str, disp: dict, left_image=None,
                      tp_tol: float = 1.0, inacc_tol: float = 2.0):
    """GT triage of stereo matches into true-positive / inaccurate / false
    panels (reference test/visualize_stereo_matches.m's three figures).
    Triage from the disparity dump's GT columns with the reference's GT
    location tolerances (definitions.h GT tols 1.0 / 2.0 px): TP if
    |disparity error| <= tp_tol, inaccurate if <= inacc_tol, else false;
    edges with no GT disparity (NaN) are skipped like the reference."""
    img = _load_image(left_image)
    err = np.abs(disp["disp_err"])
    has_gt = np.isfinite(err)
    tp = has_gt & (err <= tp_tol)
    inacc = has_gt & (err > tp_tol) & (err <= inacc_tol)
    false = has_gt & (err > inacc_tol)
    lx, ly = disp["left_x"], disp["left_y"]
    w = img.shape[1] if img is not None else (lx.max() + 10 if lx.size else 100)
    h = img.shape[0] if img is not None else (ly.max() + 10 if ly.size else 100)
    fig, axes = plt.subplots(3, 1, figsize=(12, 12))
    panels = [("True positives", tp, "tab:green"),
              ("Inaccurate", inacc, "tab:orange"),
              ("False", false, "tab:red")]
    for ax, (name, m, color) in zip(axes, panels):
        _show_image(ax, img, w, h)
        ax.plot(lx[m], ly[m], ".", color=color, markersize=2)
        ax.set_title(f"{name}: {int(m.sum())} / {int(has_gt.sum())} with GT")
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return {"tp": int(tp.sum()), "inaccurate": int(inacc.sum()),
            "false": int(false.sum()), "no_gt": int((~has_gt).sum())}


def plot_quads(out_path: str, quads: dict, kf_image=None, cf_image=None,
               image_width: Optional[float] = None, n_links: int = 100,
               seed: int = 0):
    """KF-left vs CF-left montage with temporal links (reference
    test/visualize_kf_cf_edges.m / visualize_kf_cf_projection.m)."""
    ki, ci = _load_image(kf_image), _load_image(cf_image)
    kx, ky = quads["kf_left_x"], quads["kf_left_y"]
    cx, cy = quads["cf_left_x"], quads["cf_left_y"]
    w = image_width or (ki.shape[1] if ki is not None
                        else (max(kx.max(), cx.max()) + 10 if kx.size else 100))
    h = (ki.shape[0] if ki is not None
         else (max(ky.max(), cy.max()) + 10 if ky.size else 100))
    fig, ax = plt.subplots(figsize=(14, 5))
    shift = _montage(ax, ki, ci, w, h)
    ax.plot(kx, ky, ".", color="tab:red", markersize=2, label="KF left edges")
    ax.plot(cx + shift, cy, ".", color="tab:green", markersize=2,
            label="CF left edges")
    if kx.size:
        k = min(n_links, kx.size)
        sel = np.random.default_rng(seed).choice(kx.size, size=k, replace=False)
        link_x = np.column_stack(
            [kx[sel], cx[sel] + shift, np.full(k, np.nan)]).ravel()
        link_y = np.column_stack([ky[sel], cy[sel], np.full(k, np.nan)]).ravel()
        ax.plot(link_x, link_y, "-", color="tab:cyan", linewidth=0.5, alpha=0.7)
    ax.set_title(f"Temporal quads (KF left <-> CF left): {kx.size} quads")
    ax.legend(loc="lower right", fontsize=8)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def plot_filter_distribution(out_path: str, dist: dict, filter_name: str = "",
                             bins: int = 50):
    """Veridical-vs-non overlaid histogram of a filter score distribution
    (reference test/plot_distribution.m; batch driver
    plot_all_distributions.m = call this per file)."""
    v, g = dist["values"], dist["is_gt"]
    fig, ax = plt.subplots(figsize=(8, 5))
    if v.size:
        lo, hi = float(v.min()), float(v.max())
        if lo == hi:
            lo, hi = lo - 0.5, hi + 0.5
        edges = np.linspace(lo, hi, bins + 1)
        ax.hist(v[~g], bins=edges, alpha=0.6, color="tab:red",
                label=f"non-veridical ({int((~g).sum())})")
        ax.hist(v[g], bins=edges, alpha=0.6, color="tab:green",
                label=f"veridical ({int(g.sum())})")
    ax.set_xlabel("filter value")
    ax.set_ylabel("count")
    ax.set_title(f"{filter_name} score distribution")
    ax.legend()
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def plot_ambiguity_distribution(out_path: str, counts: np.ndarray,
                                stage_name: str = ""):
    """Histogram of per-edge surviving-candidate counts (reference
    test/plot_edge_count_distribution.m / visualize_proximity_histogram.m)."""
    fig, ax = plt.subplots(figsize=(8, 5))
    if counts.size:
        hi = max(1, int(counts.max()))
        ax.hist(counts, bins=np.arange(0, hi + 2) - 0.5, color="tab:blue")
        ax.axvline(float(counts.mean()), color="tab:orange",
                   label=f"mean ambiguity {counts.mean():.2f}")
        ax.legend()
    ax.set_xlabel("candidates per edge")
    ax.set_ylabel("edges")
    ax.set_title(f"Ambiguity after stage: {stage_name}")
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def plot_trajectory(out_path: str, est: dict, gt: Optional[dict] = None,
                    plane: str = "xz"):
    """Top-down trajectory overlay, estimated vs GT, with ATE in the title
    (reference test/kitti_vis.m / euroc_vis.m trajectory overlays). KITTI's
    camera convention makes (x, z) the ground plane; pass plane='xy' for
    EuRoC-style world frames."""
    ia, ib = {"xz": (0, 2), "xy": (0, 1), "yz": (1, 2)}[plane]
    fig, ax = plt.subplots(figsize=(8, 8))
    p = est["pos"]
    ax.plot(p[:, ia], p[:, ib], "-", color="tab:blue", label="estimated")
    ax.plot(p[:1, ia], p[:1, ib], "o", color="tab:blue")
    title = f"Trajectory ({len(p)} frames)"
    if gt is not None and len(gt["pos"]):
        q = gt["pos"]
        ax.plot(q[:, ia], q[:, ib], "--", color="tab:gray", label="ground truth")
        n = min(len(p), len(q))
        if n:
            from edge_based_visual_odometry_tpu_torch.utils import metrics as MET
            a, b = p[:n].astype(np.float64), q[:n].astype(np.float64)
            s, R, t = MET.align_umeyama(a, b)
            ate = float(np.sqrt(np.mean(
                np.sum((s * (R @ a.T).T + t - b) ** 2, axis=1))))
            title += f" | ATE RMSE {ate:.3f} m"
    ax.set_xlabel(plane[0])
    ax.set_ylabel(plane[1])
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)


# --------------------------------------------------------------------------
# NCC patch debugging (reference test/debug_ncc_patches.m, 711 LoC, and
# test/test_include/test_NCC_patch.hpp:75-153 whose golden output dir
# test/ncc_debug_frame1_edge8/ this reproduces: per-candidate patch PNGs,
# candidate_scores.csv, patch_statistics.txt, all_patches_grid.png)
# --------------------------------------------------------------------------

def dump_ncc_debug(out_dir: str, left_img, right_img, edge, candidates,
                   gt_xy=None, patch_size: int = 7, shift_mag: float = 5.0,
                   gt_tol: float = 1.0) -> dict:
    """Extract the two rotated side patches of one left edge and of each
    right candidate with the production ops (ops/patches.edge_patches),
    score all 4 side pairings, and write the reference's NCC debug layout.

    edge: (x, y, theta) of the left edge. candidates: dict with 1-D arrays
    x, y, theta. gt_xy: optional GT right location for the 'Near GT?'
    column. Returns {'scores': (C,) max-NCC, 'best': argmax index}.
    Runs on the CPU (a handful of patches).
    """
    import torch

    from edge_based_visual_odometry_tpu_torch.ops import patches as OPP

    os.makedirs(out_dir, exist_ok=True)
    li = torch.as_tensor(np.asarray(left_img, np.float32))
    ri = torch.as_tensor(np.asarray(right_img, np.float32))
    ex, ey, eth = (float(v) for v in edge)
    cx = np.atleast_1d(np.asarray(candidates["x"], np.float32))
    cy = np.atleast_1d(np.asarray(candidates["y"], np.float32))
    cth = np.atleast_1d(np.asarray(candidates["theta"], np.float32))

    ap, am, a_okp, a_okm = OPP.edge_patches(
        li, torch.tensor([ex]), torch.tensor([ey]), torch.tensor([eth]),
        patch_size, shift_mag)
    bp, bm, b_okp, b_okm = OPP.edge_patches(
        ri, torch.from_numpy(cx), torch.from_numpy(cy), torch.from_numpy(cth),
        patch_size, shift_mag)
    scores = OPP.ncc4(ap, am, a_okp, a_okm, bp, bm, b_okp, b_okm).numpy()
    pair_scores = {}
    if len(cx):        # edge-vs-cand1 scores need at least one candidate
        pair_scores = {
            "Plus-Plus": float(OPP.ncc(ap[0], bp[0], a_okp[0] & b_okp[0])),
            "Minus-Minus": float(OPP.ncc(am[0], bm[0], a_okm[0] & b_okm[0])),
        }
    ap, am, bp, bm = (a.numpy() for a in (ap[0], am[0], bp, bm))

    P_ = patch_size

    def save_patch(name, vals):
        img = np.asarray(vals, np.float32).reshape(P_, P_)
        lo, hi = float(img.min()), float(img.max())
        plt.imsave(os.path.join(out_dir, name),
                   (img - lo) / max(hi - lo, 1e-6), cmap="gray")
        return img

    edge_p = save_patch("edge_patch_plus.png", ap)
    edge_m = save_patch("edge_patch_minus.png", am)
    cand_imgs = []
    for i in range(len(cx)):
        pi = save_patch(f"cand{i + 1}_patch_plus.png", bp[i])
        mi = save_patch(f"cand{i + 1}_patch_minus.png", bm[i])
        cand_imgs.append((pi, mi))

    with open(os.path.join(out_dir, "candidate_scores.csv"), "w") as f:
        f.write("Candidate,Position,Distance to GT,Max NCC,Near GT?\n")
        for i in range(len(cx)):
            if gt_xy is not None:
                d = float(np.hypot(cx[i] - gt_xy[0], cy[i] - gt_xy[1]))
                near = "Yes" if d <= gt_tol else "No"
                dtxt = f"{d:.4f}"
            else:
                dtxt, near = "nan", "n/a"
            f.write(f"{i + 1},\"({cx[i]:.1f}, {cy[i]:.1f})\",{dtxt},"
                    f"{scores[i]:.4f},{near}\n")

    with open(os.path.join(out_dir, "patch_statistics.txt"), "w") as f:
        f.write("NCC Patch Statistics\n====================\n\n")
        f.write("Edge:\n")
        f.write(f"  Location: ({ex:.2f}, {ey:.2f})\n")
        f.write(f"  Orientation: {eth:.4f}\n\n")
        f.write(f"  Plus Patch - Mean: {edge_p.mean():.4f}, "
                f"Variance: {edge_p.var():.4f}\n")
        f.write(f"  Minus Patch - Mean: {edge_m.mean():.4f}, "
                f"Variance: {edge_m.var():.4f}\n\n")
        for name, val in pair_scores.items():
            f.write(f"  {name} (edge vs cand1): {val:.4f}\n")

    # composite grid figure (debug_ncc_patches.m's main view)
    C = len(cx)
    fig, axes = plt.subplots(C + 1, 2, figsize=(5, 2.2 * (C + 1)),
                             squeeze=False)
    for ax, img, name in [(axes[0][0], edge_p, "edge +"),
                          (axes[0][1], edge_m, "edge -")]:
        ax.imshow(img, cmap="gray")
        ax.set_title(name, fontsize=8)
        ax.axis("off")
    for i, (pi, mi) in enumerate(cand_imgs):
        for ax, img, name in [
                (axes[i + 1][0], pi, f"cand{i + 1} + (ncc {scores[i]:.3f})"),
                (axes[i + 1][1], mi, f"cand{i + 1} -")]:
            ax.imshow(img, cmap="gray")
            ax.set_title(name, fontsize=8)
            ax.axis("off")
    fig.savefig(os.path.join(out_dir, "all_patches_grid.png"), dpi=110,
                bbox_inches="tight")
    plt.close(fig)
    return {"scores": scores, "best": int(scores.argmax()) if C else -1}
