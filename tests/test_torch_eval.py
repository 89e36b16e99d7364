"""The evaluation path, port vs the JAX reference on the CPU, on
make_sequence(3, 120, 160) with GT disparity and a small config:

  - match_stereo with GT supervision on JAX's edges: recall / precision
    rows within 0.02, ambiguity within 5% + 0.05, mates and true positives
    within 5% + 5, every key and shape of `distributions`;
  - match_temporal(use_gt=True) on JAX's mates: the same row tolerances;
  - lift_quads(use_gt=True) on JAX's quads: same order, same veridical flags;
  - constraint_sweep_metrics with JAX's draws injected: exact counts;
  - undistort against JAX (atol 1e-3 gray) and against cv2 where it imports;
  - bilinear_sample_nan and the rest of geometry.py against JAX;
  - a distorted rig through VOPipeline (both cameras distorted, or one).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from edge_based_visual_odometry_tpu import geometry as JGEO
from edge_based_visual_odometry_tpu.config import VOConfig as JVOConfig
from edge_based_visual_odometry_tpu.io import synthetic as JS
from edge_based_visual_odometry_tpu.models import motion_tracker as JMT
from edge_based_visual_odometry_tpu.models import stereo_matcher as JSM
from edge_based_visual_odometry_tpu.models import temporal_matcher as JTM
from edge_based_visual_odometry_tpu.models.types import (
    FrameData as JFrameData, RigArrays as JRigArrays)
from edge_based_visual_odometry_tpu.ops import image as JIMG
from edge_based_visual_odometry_tpu.ops import patches as JP
from edge_based_visual_odometry_tpu.ops import toed as JT
from edge_based_visual_odometry_tpu_torch import geometry as GEO
from edge_based_visual_odometry_tpu_torch.config import VOConfig
from edge_based_visual_odometry_tpu_torch.models import motion_tracker as MT
from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
from edge_based_visual_odometry_tpu_torch.models import stereo_matcher as SM
from edge_based_visual_odometry_tpu_torch.models import temporal_matcher as TM
from edge_based_visual_odometry_tpu_torch.models import types as TY
from edge_based_visual_odometry_tpu_torch.ops import grid as G
from edge_based_visual_odometry_tpu_torch.ops import image as IMG
from edge_based_visual_odometry_tpu_torch.ops import patches as P

pytestmark = pytest.mark.heavy
torch.set_num_threads(2)

SMALL = dict(max_edges=1024, max_candidates=8, gather_slots=64,
             max_mates=512, max_refine_pairs=1024, max_quad_candidates=8,
             quad_gather_slots=144, ransac_max_iterations=256, gn_max_iter=4)
CPU = torch.device("cpu")


def _gt_rows_close(a, b):
    """[recall, precision, precision_pair, ambiguity] rows."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape and np.isfinite(a).all()
    assert np.all(np.abs(a[:, :3] - b[:, :3]) <= 0.02), (a[:, :3], b[:, :3])
    assert np.all(np.abs(a[:, 3] - b[:, 3])
                  <= 0.05 * np.abs(b[:, 3]) + 0.05), (a[:, 3], b[:, 3])


def _count_close(a, b):
    assert abs(int(a) - int(b)) <= 0.05 * max(int(a), int(b)) + 5, (a, b)


def _u8f(a):
    return np.round(a).clip(0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    """Three frames through JAX's GT-supervised stereo stage and frames
    0 -> 1 through its use_gt temporal stage (jitted), kept as numpy."""
    cfg = JVOConfig(**SMALL)
    seq = JS.make_sequence(3, 120, 160)
    rig = JRigArrays.from_rig(seq.rig)

    @jax.jit
    def stereo(left, right, disp, occ):
        both = jnp.stack([left, right])
        gxs, gys = jax.vmap(JIMG.sobel_gradients)(both)
        fd = JFrameData(left, right, gxs[0], gys[0], gxs[1], gys[1])
        led = JT.detect_edges(left, max_edges=cfg.max_edges)
        red = JT.detect_edges(right, max_edges=cfg.max_edges)
        mates, _, metrics, dists = JSM.match_stereo(
            led, red, fd, rig, cfg, disparity_map=disp, occlusion_map=occ,
            record_distributions=True)
        return fd, led, red, mates, metrics, dists

    occ = np.full((120, 160), 255.0, np.float32)
    occ[:, :60] = 0.0          # an occluded strip: those edges leave the GT sets
    frames = [jax.tree_util.tree_map(np.asarray, stereo(
        jnp.asarray(_u8f(f.left)), jnp.asarray(_u8f(f.right)),
        jnp.asarray(f.disparity), jnp.asarray(occ))) for f in seq.frames]
    poses = [JGEO.Pose(jnp.asarray(f.R, jnp.float32),
                       jnp.asarray(f.t, jnp.float32)) for f in seq.frames]
    rel = JGEO.relative_pose(poses[0], poses[1])

    @jax.jit
    def temporal(m0, fd0, m1, fd1, R, t):
        quads, metrics = JTM.match_temporal(m0, m1, fd0, fd1, JGEO.Pose(R, t),
                                            rig, cfg, use_gt=True)
        pq = JMT.lift_quads(m0, quads, rig, cfg, use_gt=True)
        idx1, idx2, _ = JMT._sample_quad_pairs(pq, cfg, 11,
                                               cfg.ransac_max_iterations)
        return (quads, metrics, pq, idx1, idx2,
                JMT.constraint_sweep_metrics(pq, cfg, 11))

    (fd0, _, _, m0, _, _), (fd1, _, _, m1, _, _) = frames[:2]
    tout = jax.tree_util.tree_map(
        np.asarray, temporal(m0, fd0, m1, fd1, rel.R, rel.t))
    return dict(seq=seq, cfg=cfg, occ=occ, frames=frames, rel=rel,
                temporal=tout)


def _port_cfg(ref):
    return TY.config_from_fields(dataclasses.asdict(ref["cfg"]))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_match_stereo_gt_rows_and_distributions(ref, k):
    cfg = _port_cfg(ref)
    rig = TY.rig_arrays_from_rig(ref["seq"].rig, CPU)
    fd, led, red, mates, metrics, dists = ref["frames"][k]
    out, state, rows, tdists = SM.match_stereo(
        TY.edge_list_from_numpy(led, CPU), TY.edge_list_from_numpy(red, CPU),
        TY.frame_data_from_numpy(fd, CPU), rig, cfg,
        disparity_map=torch.from_numpy(ref["seq"].frames[k].disparity.copy()),
        occlusion_map=torch.from_numpy(ref["occ"].copy()),
        gather_ry=SM.derive_gather_band(ref["seq"].rig, cfg),
        record_distributions=True)
    assert rows.shape == (len(SM.STAGE_NAMES), 4)
    _gt_rows_close(rows.numpy(), metrics)
    assert float(rows[-1, 0]) > 0.5 and float(rows[-1, 1]) > 0.9
    _count_close(out.count, mates.count)
    _count_close(out.is_tp.sum(), mates.is_tp.sum())
    assert int(out.is_tp.sum()) > 100
    # the occluded strip and the GT-less rows carry no GT location
    n = int(out.count)
    v = out.valid.numpy()
    assert np.all(out.left_x.numpy()[v & (out.gt_x.numpy() >= 0)] >= 59.0)
    tp = out.is_tp.numpy()
    np.testing.assert_allclose(out.gamma_gt.numpy()[tp][:, 2],
                               out.gamma.numpy()[tp][:, 2], rtol=0.15)
    assert not out.is_tp[n:].any()

    # every key, and every shape under it
    assert sorted(tdists) == sorted(dists)
    for key, ref_v in dists.items():
        got = tdists[key]
        if key.endswith("_state"):
            assert got._fields == ref_v._fields
        assert len(got) == len(ref_v), key
        for a, b in zip(got, ref_v):
            assert tuple(a.shape) == tuple(b.shape), key
            assert (a.dtype == torch.bool) == (b.dtype == np.bool_), key
    for key in ("sift_distance", "ncc"):
        (_, gt_a, m_a), (_, gt_b, m_b) = tdists[key], dists[key]
        _count_close(m_a.sum(), m_b.sum())
        _count_close(gt_a.sum(), gt_b.sum())
    amb_a, rm_a = tdists["edge_clustering_ambiguity"]
    amb_b, rm_b = dists["edge_clustering_ambiguity"]
    _count_close(rm_a.sum(), rm_b.sum())
    _count_close(amb_a[rm_a].sum(), amb_b[rm_b].sum())


def test_match_stereo_without_occlusion_map_keeps_the_strip(ref):
    cfg = _port_cfg(ref)
    fd, led, red, *_ = ref["frames"][0]
    out, _, rows = SM.match_stereo(
        TY.edge_list_from_numpy(led, CPU), TY.edge_list_from_numpy(red, CPU),
        TY.frame_data_from_numpy(fd, CPU),
        TY.rig_arrays_from_rig(ref["seq"].rig, CPU), cfg,
        disparity_map=torch.from_numpy(ref["seq"].frames[0].disparity.copy()))
    v = out.valid.numpy() & (out.gt_x.numpy() >= 0)
    assert (out.left_x.numpy()[v] < 59.0).sum() > 5
    assert float(rows[-1, 1]) > 0.9


def _jax_veridical_window(x, y, valid, attrs, width, height, qx, qy, r,
                          test):
    """JAX's veridical query: the first 8 slots a band of the (r + 1)-box
    on the gather's 8 px bands (the port reads every slot of the r-box,
    `ops/grid.py::any_in_box`)."""
    R = r + 1.0
    grid = G.build_sorted_grid(x, y, valid, width, height, band_h=8,
                               attrs=attrs)
    _, attrs, mask = G.query_sorted_grid_attrs(
        grid, qx, qy, rx=R, ry=R, slots_per_band=8,
        n_band_window=int(-(-2 * R // grid.band_h)) + 1)
    return test(attrs, mask).any(1)


def test_match_temporal_use_gt_rows(ref, monkeypatch):
    # held to JAX under JAX's window; the full window is held to a brute
    # force in tests/test_torch_ops.py and to the plain reference in
    # tests/test_torch_gt_bench.py
    monkeypatch.setattr(G, "any_in_box", _jax_veridical_window)
    cfg = _port_cfg(ref)
    rig = TY.rig_arrays_from_rig(ref["seq"].rig, CPU)
    (fd0, _, _, m0, _, _), (fd1, _, _, m1, _, _) = ref["frames"][:2]
    quads_ref, metrics_ref = ref["temporal"][:2]
    rel = GEO.Pose(torch.from_numpy(np.array(ref["rel"].R)),
                   torch.from_numpy(np.array(ref["rel"].t)))
    quads, metrics = TM.match_temporal(
        TY.stereo_mates_from_numpy(m0, CPU), TY.stereo_mates_from_numpy(m1, CPU),
        TY.frame_data_from_numpy(fd0, CPU), TY.frame_data_from_numpy(fd1, CPU),
        rel, rig, cfg, use_gt=True)
    assert metrics.shape == (len(TM.TEMPORAL_STAGE_NAMES), 4)
    _gt_rows_close(metrics.numpy(), metrics_ref)
    assert float(metrics[-1, 0]) > 0.3 and float(metrics[-1, 1]) > 0.5
    _count_close(quads.has_veridical.sum(), quads_ref.has_veridical.sum())
    _count_close(quads.row_mask.sum(), quads_ref.row_mask.sum())
    # use_gt keeps only the rows that formed a veridical quad
    assert not (quads.row_mask & ~quads.has_veridical).any()
    _count_close(quads.cmask.sum(), quads_ref.cmask.sum())
    # the projections come from the GT 3D points
    rm = quads_ref.row_mask
    np.testing.assert_allclose(quads.proj_left.numpy()[rm],
                               quads_ref.proj_left[rm], atol=1e-2)


def test_lift_quads_use_gt_and_constraint_sweep(ref):
    cfg = _port_cfg(ref)
    rig = TY.rig_arrays_from_rig(ref["seq"].rig, CPU)
    m0 = TY.stereo_mates_from_numpy(ref["frames"][0][3], CPU)
    quads_ref, _, pq_ref, idx1, idx2, sweep_ref = ref["temporal"]
    quads = TY._convert(TM.TemporalQuads, quads_ref, CPU)
    pq = MT.lift_quads(m0, quads, rig, cfg, use_gt=True)
    assert int(pq.n_valid) == int(pq_ref.n_valid) > 50
    np.testing.assert_array_equal(pq.valid.numpy(), pq_ref.valid)
    np.testing.assert_array_equal(pq.is_veridical.numpy(), pq_ref.is_veridical)
    assert int(pq.is_veridical.sum()) > 20
    # without use_gt nothing is flagged and every row takes part
    pq0 = MT.lift_quads(m0, quads, rig, cfg)
    assert not pq0.is_veridical.any() and int(pq0.n_valid) >= int(pq.n_valid)

    pq_j = TY._convert(MT.PoseQuads, pq_ref, CPU)
    sweep = MT.constraint_sweep_metrics(pq_j, cfg, idx=(idx1, idx2)).numpy()
    assert sweep.shape == (len(MT.CONSTRAINT_STAGE_NAMES), 3) == (5, 3)
    np.testing.assert_array_equal(sweep[:, 2], sweep_ref[:, 2])   # counts
    np.testing.assert_allclose(sweep[:, :2], sweep_ref[:, :2], atol=1e-6)
    assert sweep[0, 2] > 0 and np.all(np.diff(sweep[:, 2]) <= 0)
    assert np.all((sweep[:, :2] >= 0) & (sweep[:, :2] <= 1))
    # the generator's own draws give a sweep of the same form
    own = MT.constraint_sweep_metrics(pq_j, cfg, seed=11).numpy()
    assert own.shape == (5, 3) and own[0, 0] == 1.0


def _wavy(h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    return (120 + 60 * np.sin(0.2 * xx) + 40 * np.cos(0.15 * yy)).astype(
        np.float32)


def test_undistort_matches_jax_and_opencv():
    img = _wavy(120, 160)
    K = np.array([[150.0, 0, 80.0], [0, 150.0, 60.0], [0, 0, 1]], np.float32)
    dist = np.array([-0.28, 0.07, 0.0002, -0.0001], np.float32)
    ours = IMG.undistort(torch.from_numpy(img), torch.from_numpy(K),
                         torch.from_numpy(dist)).numpy()
    ref = np.asarray(JIMG.undistort(jnp.asarray(img), jnp.asarray(K),
                                    jnp.asarray(dist)))
    np.testing.assert_allclose(ours, ref, atol=1e-3)
    assert np.abs(ours - img).max() > 5.0          # it did move pixels
    cv2 = pytest.importorskip("cv2")
    cv = cv2.undistort(img, K.astype(np.float64), dist.astype(np.float64))
    a, b = ours[10:-10, 10:-10], cv[10:-10, 10:-10]   # borders extrapolate
    assert np.median(np.abs(a - b)) < 0.5
    assert np.mean(np.abs(a - b) < 2.0) > 0.95


def test_bilinear_sample_nan_matches_jax():
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 255, (24, 31)).astype(np.float32)
    x = rng.uniform(-2, 33, 500).astype(np.float32)
    y = rng.uniform(-2, 26, 500).astype(np.float32)
    x[:4], y[:4] = [0.0, 30.0, 30.0, 12.0], [0.0, 23.0, 5.5, 23.0]
    val, inb = P.bilinear_sample_nan(torch.from_numpy(img),
                                     torch.from_numpy(x), torch.from_numpy(y))
    jval, jinb = JP.bilinear_sample_nan(jnp.asarray(img), jnp.asarray(x),
                                        jnp.asarray(y))
    np.testing.assert_array_equal(inb.numpy(), np.asarray(jinb))
    assert inb[:4].all() and 100 < int(inb.sum()) < 500
    np.testing.assert_allclose(val.numpy(), np.asarray(jval), atol=1e-4)


@pytest.mark.parametrize("name", ["two_view", "multiview"])
def test_singular_triangulation_matches_jax(name):
    """Zero baseline at the principal point: the normal equations are
    exactly singular. JAX's solve returns NaN; the port returns the same
    instead of raising."""
    K = np.array([[300.0, 0, 80.0], [0, 300.0, 60.0], [0, 0, 1]], np.float32)
    Kinv = np.linalg.inv(K).astype(np.float32)
    I3, T0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    px = np.array([80.0, 60.0], np.float32)
    if name == "two_view":
        X = GEO.two_view_linear_triangulation(
            *(torch.from_numpy(a) for a in (px, px, Kinv, Kinv, I3, T0)))
        Xj = JGEO.two_view_linear_triangulation(
            *(jnp.asarray(a) for a in (px, px, Kinv, Kinv, I3, T0)))
    else:
        pts, Rs, Ts = np.stack([px] * 3), np.stack([I3] * 2), np.stack([T0] * 2)
        X = GEO.multiview_linear_triangulation(
            *(torch.from_numpy(a) for a in (pts, Rs, Ts, Kinv)))
        Xj = JGEO.multiview_linear_triangulation(
            *(jnp.asarray(a) for a in (pts, Rs, Ts, Kinv)))
    Xj = np.asarray(Xj)
    assert not np.isfinite(Xj).any()
    np.testing.assert_array_equal(np.isfinite(X.numpy()), np.isfinite(Xj))


@pytest.mark.parametrize("name", ["pose_algebra", "quaternions",
                                  "two_view", "multiview", "angles"])
def test_geometry_rest_matches_jax(name):
    rng = np.random.default_rng(4)
    R = np.asarray(JGEO.so3_exp(jnp.asarray([0.1, -0.2, 0.05], jnp.float32)))
    t = np.array([0.3, -0.1, 0.05], np.float32)
    pts = (rng.normal(0, 1, (7, 3)) + [0, 0, 5]).astype(np.float32)
    tp = GEO.Pose(torch.from_numpy(R.copy()), torch.from_numpy(t))
    jp = JGEO.Pose(jnp.asarray(R), jnp.asarray(t))
    K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]], np.float32)
    Kinv = np.linalg.inv(K).astype(np.float32)
    tK, tKinv = torch.from_numpy(K), torch.from_numpy(Kinv)
    if name == "pose_algebra":
        tpts = torch.from_numpy(pts)
        np.testing.assert_allclose(tp.detransform(tpts).numpy(),
                                   np.asarray(jp.detransform(jnp.asarray(pts))),
                                   atol=1e-6)
        np.testing.assert_allclose(tp.center().numpy(),
                                   np.asarray(jp.center()), atol=1e-7)
        inv, jinv = tp.inverse(), jp.inverse()
        np.testing.assert_allclose(inv.R.numpy(), np.asarray(jinv.R), atol=1e-7)
        np.testing.assert_allclose(inv.t.numpy(), np.asarray(jinv.t), atol=1e-7)
        np.testing.assert_allclose(
            inv.transform(tp.transform(tpts)).numpy(), pts, atol=1e-5)
    elif name == "quaternions":
        q = rng.normal(0, 1, (5, 4)).astype(np.float32)
        np.testing.assert_allclose(
            GEO.quat_to_R(torch.from_numpy(q)).numpy(),
            np.asarray(JGEO.quat_to_R(jnp.asarray(q))), atol=1e-6)
        for Rm in (R, np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, -1.0, 1.0])):
            np.testing.assert_array_equal(GEO.R_to_quat(Rm),
                                          JGEO.R_to_quat(Rm))
        np.testing.assert_array_equal(
            GEO.R_to_quat(torch.from_numpy(R.copy())), JGEO.R_to_quat(R))
    elif name == "two_view":
        px1 = np.asarray(JGEO.project(jnp.asarray(K), jnp.asarray(pts)))
        px2 = np.asarray(JGEO.project(jnp.asarray(K),
                                      jp.transform(jnp.asarray(pts))))
        X = GEO.two_view_linear_triangulation(
            torch.from_numpy(px1), torch.from_numpy(px2), tKinv, tKinv,
            tp.R, tp.t).numpy()
        # the reference solves one point per call
        Xj = np.stack([np.asarray(JGEO.two_view_linear_triangulation(
            jnp.asarray(px1[i]), jnp.asarray(px2[i]), jnp.asarray(Kinv),
            jnp.asarray(Kinv), jp.R, jp.t)) for i in range(len(pts))])
        np.testing.assert_allclose(X, Xj, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(X, pts, rtol=5e-3, atol=5e-3)
    elif name == "multiview":
        Rs = np.stack([R, R @ R])
        Ts = np.stack([t, 2 * t]).astype(np.float32)
        X0 = pts[0]
        px = np.stack([(K @ X0)[:2] / (K @ X0)[2]]
                      + [(K @ (Rs[i] @ X0 + Ts[i]))[:2]
                         / (K @ (Rs[i] @ X0 + Ts[i]))[2] for i in range(2)]
                      ).astype(np.float32)
        X = GEO.multiview_linear_triangulation(
            torch.from_numpy(px), torch.from_numpy(Rs.copy()),
            torch.from_numpy(Ts), tKinv).numpy()
        Xj = np.asarray(JGEO.multiview_linear_triangulation(
            jnp.asarray(px), jnp.asarray(Rs), jnp.asarray(Ts),
            jnp.asarray(Kinv)))
        np.testing.assert_allclose(X, Xj, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(X, X0, rtol=5e-3, atol=5e-3)
    else:
        a = rng.uniform(-400, 400, 9).astype(np.float32)
        np.testing.assert_allclose(GEO.deg2rad(torch.from_numpy(a)).numpy(),
                                   np.asarray(JGEO.deg2rad(jnp.asarray(a))),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            GEO.rad2deg(GEO.deg2rad(torch.from_numpy(a))).numpy(), a,
            rtol=1e-5)


def _distort_image(img, cam):
    """Inverse of the undistortion map in numpy: the distorted image whose
    undistortion gives `img` back. For each distorted pixel the normalised
    undistorted point is found by fixed-point iteration of the forward
    model, then `img` is sampled there bilinearly."""
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


@pytest.mark.parametrize("cameras", ["both", "left_only"])
def test_distorted_rig_through_the_pipeline(cameras):
    """A rig with non-zero distortion runs, both cameras distorted or one:
    each distorted camera's image goes through the remap of
    `ops/image.py::undistort` inside the stereo step, whether cv2 imports
    or not. Frames are distorted with the inverse map, so the undistorted
    frames are the synthetic ones and the pose must come out as on the
    clean rig."""
    seq = JS.make_sequence(2, 120, 160)
    dist = (-0.05, 0.01, 0.0005, -0.0005)
    cam = dataclasses.replace(seq.rig.left, distortion=dist)
    rcam = cam if cameras == "both" else seq.rig.right
    rig = dataclasses.replace(seq.rig, left=cam, right=rcam)
    pipe = PL.VOPipeline(rig, VOConfig(**SMALL), device="cpu")
    clean = PL.VOPipeline(seq.rig, VOConfig(**SMALL), device="cpu")
    for f in seq.frames:
        fr, tr = pipe.run_frame(
            _distort_image(f.left, cam),
            _distort_image(f.right, cam) if cameras == "both" else f.right)
        cfr, ctr = clean.run_frame(f.left, f.right)
        # the undistorted frame is the clean frame again (interior)
        d = (fr.frame.left - cfr.frame.left).abs()[10:-10, 10:-10]
        assert float(d.median()) < 0.5
        _count_close(fr.mates.count, cfr.mates.count)
    assert bool(tr.success) and float(tr.inlier_ratio) > 0.3
    R_gt = seq.frames[1].R @ seq.frames[0].R.T

    def err_deg(R):
        c = (np.trace(R.double().numpy() @ R_gt.T) - 1) / 2
        return np.degrees(np.arccos(np.clip(c, -1, 1)))
    assert err_deg(tr.R) < 0.5
    assert abs(err_deg(tr.R) - err_deg(ctr.R)) < 0.25
