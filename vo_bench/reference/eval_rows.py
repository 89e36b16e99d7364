"""The plain reference of the evaluation path: the Final row of each
stage table, recomputed from a frame's own outputs and the scene's exact
geometry (`exact.py`), and where the GT right locations truly lie.

The program logs, a frame, one row a stage of the stereo cascade and of
the quad cascade: [recall, precision, precision over rows with
candidates, ambiguity] against its GT (the disparity and non-occlusion
maps, the GT relative pose). The reference recomputes columns 0 and 1 of
the last row of each (`Final`, after the best-only pick and the purge;
`Edge Clustering`) by the reference's rules, with the truth in place of
the maps:

- stereo: a row is a mate whose left edge has a GT location (its point's
  exact right pixel inside the right image, the edge not within
  `gt_orient_exclusion_deg` of horizontal) and a veridical set: a right
  edge within `gt_pair_dist_tol` of that pixel, within
  `epipolar_line_dist_thresh` of the left point's epipolar line and
  within `gt_pair_orient_tol` of its orientation (raw degrees). A row is
  a true positive where the mate lies within `dist_to_gt_thresh` of the
  GT location; recall and precision are both the true positives' share
  of the rows (one candidate a row is left);
- temporal: a row is a keyframe mate that is a true positive of its own
  frame (as above, less the veridical set), whose point lands, by the
  exact relative pose, at least 10 px inside both images of the frame,
  and that forms a veridical quad: a mate of the frame within
  `dist_to_gt_thresh_quads` of both landing pixels, each side's
  orientation within `veridical_orient_thresh_deg` of the edge's
  transported orientation by the reference's rule (the 3D tangent where
  the keyframe's two interpretation planes meet, turned by the exact
  relative pose and projected at the landing pixels). A candidate is a
  true positive within `dist_to_gt_thresh_quads` of both landing
  pixels. Recall: the rows with a true positive over the rows;
  precision: the mean over the rows with a candidate of their true
  positives' share.

It reads the program's outputs only to judge them, and imports nothing
of the program: the rules' numbers come in `rules` (the keys above).
Every function takes a `dtype`: float64 gives the reference; the control
is the same reference in bfloat16 in the program's place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vo_bench.reference import exact as REF

MARGIN = 10.0          # px: the quad cascade's image margin


def _deg(theta):
    return theta * (180.0 / math.pi)


def _norm2(dx, dy):
    return torch.sqrt(dx * dx + dy * dy)


def near(q: torch.Tensor, db: torch.Tensor, radius: float):
    """(Q, S) indices into `db` (N, 2) and the mask of the points within
    `radius` of each query point of `q` (Q, 2): `db` bucketed on a grid
    of `radius`-sized cells, each query reading its 3 x 3 cells. A query
    point that is not finite has none."""
    dev, n_q = q.device, q.shape[0]
    q, db = q.to(torch.float64), db.to(torch.float64)
    ok = torch.isfinite(q).all(-1)
    if db.shape[0] == 0 or n_q == 0:
        return (torch.zeros((n_q, 1), dtype=torch.int64, device=dev),
                torch.zeros((n_q, 1), dtype=torch.bool, device=dev))
    dc = torch.floor(db / radius).to(torch.int64)
    lo = dc.min(0).values - 2
    dc = dc - lo
    width = int(dc[:, 0].max()) + 3
    qc = torch.floor(torch.where(ok[:, None], q, db[:1]) / radius).to(
        torch.int64) - lo
    key, order = torch.sort(dc[:, 1] * width + dc[:, 0])
    idx, mask = [], []
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            cx, cy = qc[:, 0] + ox, qc[:, 1] + oy
            k = torch.where((cx >= 0) & (cx < width) & (cy >= 0),
                            cy * width + cx, torch.full_like(cx, -1))
            a = torch.searchsorted(key, k)
            b = torch.searchsorted(key, k, right=True)
            j = a[:, None] + torch.arange(max(int((b - a).max()), 1),
                                          device=dev)
            m = j < b[:, None]
            idx.append(order[torch.where(m, j, torch.zeros_like(j))])
            mask.append(m & ok[:, None])
    idx, mask = torch.cat(idx, 1), torch.cat(mask, 1)
    d = db[idx] - q[:, None, :]
    return idx, mask & (_norm2(d[..., 0], d[..., 1]) < radius)


def _fundamental(rig, dtype, device):
    """F21 of the rig (left point -> right epipolar line), exact."""
    T = np.asarray(rig.T21, np.float64)
    Tx = np.array([[0.0, -T[2], T[1]], [T[2], 0.0, -T[0]],
                   [-T[1], T[0], 0.0]])
    F = (np.linalg.inv(rig.K_right).T @ Tx @ np.asarray(rig.R21)
         @ np.linalg.inv(rig.K_left))
    return torch.as_tensor(F, device=device).to(dtype)


def _inside(p, rig, margin=0.0):
    return (torch.isfinite(p).all(-1) & (p[:, 0] >= margin)
            & (p[:, 1] >= margin) & (p[:, 0] <= rig.width - 1 - margin)
            & (p[:, 1] <= rig.height - 1 - margin))


def _gt_ok(scene, k, lx, ly, lt, rules, dtype):
    """(exact right pixels (n, 2), whether each left point has a GT
    location: its right pixel inside the right image, its edge not near
    horizontal)."""
    truth = REF.stereo_truth(scene, k, lx, ly, dtype)
    deg = _deg(lt)
    excl = rules["gt_orient_exclusion_deg"]
    near_h = ((torch.abs(deg) < excl) | (torch.abs(deg - 180.0) < excl)
              | (torch.abs(deg + 180.0) < excl))
    return truth, _inside(truth, scene.rig) & ~near_h


def _cast(xs, valid, dtype):
    v = valid.bool()
    return [x[v].to(dtype) for x in xs]


def stereo_final(scene, k: int, mates, right_edges, rules,
                 dtype=torch.float64):
    """(recall, precision, rows) of frame k's stereo Final row. `mates`:
    (left_x, left_y, left_theta, right_x, right_y, valid) of the frame's
    mates; `right_edges`: (x, y, theta, valid) of its right image's
    edges."""
    lx, ly, lt, rx, ry = _cast(mates[:5], mates[5], dtype)
    ex, ey, et = _cast(right_edges[:3], right_edges[3], dtype)
    truth, ok = _gt_ok(scene, k, lx, ly, lt, rules, dtype)
    idx, m = near(truth, torch.stack([ex, ey], -1),
                  rules["gt_pair_dist_tol"])
    F = _fundamental(scene.rig, dtype, lx.device)
    a = F[0, 0] * lx + F[0, 1] * ly + F[0, 2]
    b = F[1, 0] * lx + F[1, 1] * ly + F[1, 2]
    c = F[2, 0] * lx + F[2, 1] * ly + F[2, 2]
    vx, vy, vt = ex[idx], ey[idx], et[idx]
    epi = (torch.abs(a[:, None] * vx + b[:, None] * vy + c[:, None])
           / torch.sqrt(a * a + b * b)[:, None])
    dth = torch.abs(_deg(vt) - _deg(lt)[:, None])
    verid = (m & (epi < rules["epipolar_line_dist_thresh"])
             & (dth < rules["gt_pair_orient_tol"])).any(1)
    rows = ok & verid
    d = _norm2(rx - truth[:, 0], ry - truth[:, 1])
    tp = rows & (d <= rules["dist_to_gt_thresh"])
    n = int(rows.sum())
    share = float(tp.sum()) / max(n, 1)
    return share, share, n


def _orientation_gate(a, b, thresh):
    """The reference's gate on two orientations (radians): their
    difference wrapped to [0, 180] degrees within `thresh` of 0 or 180."""
    d = torch.remainder(torch.abs(_deg(a - b)), 360.0)
    d = torch.where(d > 180.0, 360.0 - d, d)
    return (d < thresh) | (torch.abs(d - 180.0) < thresh)


def _ray(K_inv, x, y, w):
    """K^-1 [x, y, w] for each (x, y); w 1 for a point, 0 for a
    direction."""
    v = torch.stack([x, y, torch.full_like(x, float(w))], -1)
    return v @ K_inv.T


def _landing(scene, kf, cf, kf_mates, dtype):
    """Where the keyframe mates' left points truly land in frame cf, and
    the rule's orientations there: (left pixels, right pixels, left
    orientations, right orientations)."""
    rig = scene.rig
    lx, ly, lt, rx, ry, rt = kf_mates
    dev = lx.device
    X = REF.raycast(scene.planes, scene.R[kf], scene.t[kf],
                    REF.rays(rig.K_left, lx, ly, dtype))
    R, t = REF.relative(scene.R[kf], scene.t[kf], scene.R[cf], scene.t[cf],
                        dtype, dev)
    R21 = REF._t(rig.R21, dtype, dev)
    Xc = X @ R.T + t
    Xr = Xc @ R21.T + REF._t(rig.T21, dtype, dev)
    pl, pr = REF.project(rig.K_left, Xc), REF.project(rig.K_right, Xr)

    Kl = REF._t(np.linalg.inv(rig.K_left), dtype, dev)
    Kr = REF._t(np.linalg.inv(rig.K_right), dtype, dev)
    n1 = torch.linalg.cross(_ray(Kl, torch.cos(lt), torch.sin(lt), 0),
                            _ray(Kl, lx, ly, 1))
    n2 = torch.linalg.cross(_ray(Kr, torch.cos(rt), torch.sin(rt), 0),
                            _ray(Kr, rx, ry, 1)) @ R21
    T = torch.linalg.cross(n1, n2)
    Tl = T / torch.linalg.norm(T, dim=-1, keepdim=True) @ R.T
    Tr = Tl @ R21.T
    tl = Tl - Tl[:, 2:3] * _ray(Kl, pl[:, 0], pl[:, 1], 1)
    tr = Tr - Tr[:, 2:3] * _ray(Kr, pr[:, 0], pr[:, 1], 1)
    return (pl, pr, torch.atan2(tl[:, 1], tl[:, 0]),
            torch.atan2(tr[:, 1], tr[:, 0]))


def temporal_final(scene, kf: int, cf: int, kf_mates, cf_mates, quads,
                   rules, dtype=torch.float64):
    """(recall, precision, rows) of the quad cascade's last row for
    keyframe kf and frame cf. `kf_mates`, `cf_mates`: (left_x, left_y,
    left_theta, right_x, right_y, right_theta, valid); `quads`: (lcx,
    lcy, rcx, rcy, cmask), rows aligned with the keyframe's mate slots."""
    rig = scene.rig
    valid = kf_mates[6].bool()
    lx, ly, lt, rx, ry, rt = (x.to(dtype) for x in kf_mates[:6])
    truth, ok = _gt_ok(scene, kf, lx, ly, lt, rules, dtype)
    is_tp = (valid & ok & (_norm2(rx - truth[:, 0], ry - truth[:, 1])
                           <= rules["dist_to_gt_thresh"]))
    pl, pr, th_l, th_r = _landing(scene, kf, cf, (lx, ly, lt, rx, ry, rt),
                                  dtype)
    in_img = _inside(pl, rig, MARGIN) & _inside(pr, rig, MARGIN)

    tol = rules["dist_to_gt_thresh_quads"]
    cx, cy, ct, crx, cry, crt = _cast(cf_mates[:6], cf_mates[6], dtype)
    idx, m = near(pl, torch.stack([cx, cy], -1), tol)
    vth = rules["veridical_orient_thresh_deg"]
    verid = (m & (_norm2(crx[idx] - pr[:, 0:1], cry[idx] - pr[:, 1:2]) < tol)
             & _orientation_gate(th_l[:, None], ct[idx], vth)
             & _orientation_gate(th_r[:, None], crt[idx], vth)).any(1)
    rows = is_tp & in_img & verid

    lcx, lcy, rcx, rcy = (x.to(dtype) for x in quads[:4])
    cmask = quads[4].bool()
    tp = (cmask & (_norm2(lcx - pl[:, 0:1], lcy - pl[:, 1:2]) < tol)
          & (_norm2(rcx - pr[:, 0:1], rcy - pr[:, 1:2]) < tol))
    n_tp, n_c = tp.sum(1), cmask.sum(1)
    has_c = rows & (n_c > 0)
    n = int(rows.sum())
    recall = float((rows & (n_tp > 0)).sum()) / max(n, 1)
    prec = torch.where(has_c, n_tp.double() / n_c.clamp(min=1).double(),
                       torch.zeros((), dtype=torch.float64,
                                   device=n_c.device))
    precision = float(prec.sum()) / max(int(has_c.sum()), 1)
    return recall, precision, n


def gt_px(scene, k: int, mates, q: float, dtype=torch.float64) -> float:
    """The q-quantile over frame k's valid mates of the distance of the
    GT right location (gt_x, gt_y) from the left point's exact right
    pixel. `mates`: (left_x, left_y, gt_x, gt_y, valid); the control puts
    the exact pixel computed in `dtype` in the program's place."""
    lx, ly, gx, gy = _cast(mates[:4], mates[4], torch.float64)
    truth = REF.stereo_truth(scene, k, lx, ly, torch.float64)
    if dtype == torch.float64:
        ans = torch.stack([gx, gy], -1)
    else:
        ans = REF.stereo_truth(scene, k, lx.to(dtype), ly.to(dtype),
                               dtype).double()
    return REF.quantile_px(torch.linalg.norm(ans - truth, dim=-1), q)
