"""EuRoC's stereo rig: each camera's points lifted with its own K.

EuRoC MAV's two cameras differ (cx 367.215 against 379.999 px, cy
248.375 against 255.238), its lenses are radial-tangential and its rig
is unrectified (R21 about 0.8 deg off the identity). On the CPU:

- (a) `lift_quads` on EuRoC's published K pair, R21 and T21, fed the
  exact pixels and image tangents of seeded float64 points 2-10 m in
  front of the left camera: its 3D points and tangents, keyframe and
  current frame, agree with a plain float64 two-ray triangulation over
  `vo_bench/reference/exact.py::rays` (each camera's own K) to 1e-4
  relative, where lifting the right image with the left K misses by a
  large fraction of each depth;
- (b) the same points on a rig whose cameras share one K: the port's
  lift equals the JAX package's bit for bit (that package lifts both
  images with the left K, as the C++ reference does), so the two differ
  only where the cameras do;
- the stereo gather on EuRoC's rig: every right edge within the
  epipolar tolerance of a left edge's line and within `max_disparity` of
  it reaches the cascade, where a dense band of them lies along the line
  (centred on the left edge itself, the window's 6 bands shared the
  gather slots, and a band kept only its first 26 edges by x);
- the cell's room: its lap closes, moves as EuRoC's rig flies (at most
  5 cm and 1.75 deg, 35 deg/s at 20 Hz, a frame) and keeps every
  textured surface in view at 2.1 m or more, so that no disparity passes
  24 px;
- (c) the `euroc.every_frame` cell at a fifth of its size, through
  `vo_bench/harness/frame_run.run`: correct; with the right image lifted
  with the left K, its pose check fails; with the right image undistorted
  with the left K, its mates fail.
"""

import copy
import time

import numpy as np
import pytest
import torch

from edge_based_visual_odometry_tpu_torch.config import (VOConfig,
                                                         rig_from_yaml_dict)
from edge_based_visual_odometry_tpu_torch.models import motion_tracker as MT
from edge_based_visual_odometry_tpu_torch.models import stereo_matcher as SM
from edge_based_visual_odometry_tpu_torch.models import types as TY
from edge_based_visual_odometry_tpu_torch.models.temporal_matcher import (
    TemporalQuads)
from edge_based_visual_odometry_tpu_torch.ops import image as IMG
from vo_bench.harness import frame_run as FRUN
from vo_bench.harness import spec as SPEC
from vo_bench.reference import exact as REF
from vo_bench.scene import render as RS
from vo_bench.tests.test_vo_bench_faults import tiny_cell as small_cell

torch.set_num_threads(2)

CPU = torch.device("cpu")
N = 512
EUROC = SPEC.load_json(SPEC.BENCH_DIR / "configs" / "euroc.json")["rig"]


def _rig(shared_k: bool = False):
    cfg = copy.deepcopy(EUROC)
    if shared_k:
        cfg["right_camera"] = copy.deepcopy(cfg["left_camera"])
    return rig_from_yaml_dict(cfg)


def _points(rig, seed: int):
    """Seeded float64 points 2-10 m in front of the left camera, through
    pixels of its image, with 3D tangents away from the epipolar planes
    (whose edges fix no depth); the same points and tangents in the
    current frame after a small motion."""
    rng = np.random.default_rng(seed)
    K = rig.left.K
    u = rng.uniform(20.0, rig.left.width - 20.0, N)
    v = rng.uniform(20.0, rig.left.height - 20.0, N)
    depth = rng.uniform(2.0, 10.0, N)
    X = depth[:, None] * (np.stack([u, v, np.ones(N)], -1)
                          @ np.linalg.inv(K).T)
    D = np.stack([rng.uniform(-0.5, 0.5, N), np.ones(N),
                  rng.uniform(-0.5, 0.5, N)], -1)
    D /= np.linalg.norm(D, axis=-1, keepdims=True)
    a = np.radians(2.0)
    R = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                  [-np.sin(a), 0.0, np.cos(a)]])
    t = np.array([0.03, -0.01, 0.04])
    return (X, D), (X @ R.T + t, D @ R.T)


def _image(K, X, D):
    """Pixels and image tangent angles of 3D points X with tangents D."""
    p = X @ K.T
    uv = p[:, :2] / p[:, 2:]
    q = (X + 1e-6 * D) @ K.T
    duv = q[:, :2] / q[:, 2:] - uv
    return uv, np.arctan2(duv[:, 1], duv[:, 0])


def _views(rig, X, D):
    """Left and right (pixels, angles) of points in the left camera."""
    R21, T21 = rig.R21_np, rig.T21_np
    return (_image(rig.left.K, X, D),
            _image(rig.right.K, X @ R21.T + T21, D @ R21.T))


def _inputs(rig, seed: int):
    """The port's StereoMates (keyframe) and TemporalQuads (one candidate
    a row, the current frame's true one), float32, and the true points
    and tangents."""
    kf, cf = _points(rig, seed)
    (lk, tlk), (rk, trk) = _views(rig, *kf)
    (lc, tlc), (rc, trc) = _views(rig, *cf)

    def f(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    z = torch.zeros(N)
    mates = TY.StereoMates(
        left_x=f(lk[:, 0]), left_y=f(lk[:, 1]), left_theta=f(tlk),
        right_x=f(rk[:, 0]), right_y=f(rk[:, 1]), right_theta=f(trk),
        left_patches=z[:, None], right_patches=z[:, None],
        left_patch_ok=torch.ones(N, 2, dtype=torch.bool),
        right_patch_ok=torch.ones(N, 2, dtype=torch.bool),
        left_desc=z[:, None].bfloat16(), right_desc=z[:, None].bfloat16(),
        gamma=torch.zeros(N, 3), gamma_gt=torch.zeros(N, 3), gt_x=z - 1,
        gt_y=z - 1, is_tp=torch.zeros(N, dtype=torch.bool),
        valid=torch.ones(N, dtype=torch.bool),
        count=torch.tensor(N, dtype=torch.int32))
    col = lambda a: f(a)[:, None]          # noqa: E731
    quads = TemporalQuads(
        row_mask=torch.ones(N, dtype=torch.bool), proj_left=f(lc),
        proj_right=f(rc), proj_theta_l=f(tlc), proj_theta_r=f(trc),
        has_veridical=torch.ones(N, dtype=torch.bool),
        cf_idx=torch.arange(N)[:, None], lcx=col(lc[:, 0]),
        lcy=col(lc[:, 1]), lct=col(tlc), rcx=col(rc[:, 0]),
        rcy=col(rc[:, 1]), rct=col(trc),
        cmask=torch.ones(N, 1, dtype=torch.bool), ncc_l=torch.ones(N, 1),
        desc_l=torch.zeros(N, 1))
    return mates, quads, kf, cf


def _reference(rig, uv_l, th_l, uv_r, th_r):
    """Plain float64 two-ray triangulation: the least-squares meeting
    point of the two cameras' rays (each through its own K), in the left
    camera, and the 3D tangent where the two interpretation planes meet."""
    def ray(K, uv):
        return REF.rays(K, torch.from_numpy(uv[:, 0]),
                        torch.from_numpy(uv[:, 1]), torch.float64).numpy()

    def tangent_ray(K, uv, th):
        step = uv + np.stack([np.cos(th), np.sin(th)], -1)
        return ray(K, step) - ray(K, uv)

    R, T = rig.R21_np, rig.T21_np
    d1 = ray(rig.left.K, uv_l)                       # left camera
    d2 = ray(rig.right.K, uv_r) @ R                  # R^T d2, left frame
    c2 = -R.T @ T                                    # right centre
    # s1 d1 - s2 d2 = c2 in least squares
    A = np.stack([d1, -d2], -1)                      # (N, 3, 2)
    s = np.linalg.solve(np.einsum("nki,nkj->nij", A, A),
                        np.einsum("nki,k->ni", A, c2)[..., None])[..., 0]
    X = s[:, :1] * d1
    n1 = np.cross(tangent_ray(rig.left.K, uv_l, th_l), d1)
    n2 = np.cross(tangent_ray(rig.right.K, uv_r, th_r) @ R, d2)
    D = np.cross(n1, n2)
    return X, D / np.linalg.norm(D, axis=-1, keepdims=True)


def _rel(a, b):
    """Each row's |a - b| / |b|; a tangent's sign is free."""
    a = np.asarray(a, np.float64)
    err = np.linalg.norm(a - b, axis=-1)
    if np.allclose(np.linalg.norm(b, axis=-1), 1.0):
        err = np.minimum(err, np.linalg.norm(a + b, axis=-1))
    return err / np.linalg.norm(b, axis=-1)


def _lifted(rig, seed):
    mates, quads, kf, cf = _inputs(rig, seed)
    pq = MT.lift_quads(mates, quads, TY.rig_arrays_from_rig(rig, CPU),
                       VOConfig())
    assert int(pq.n_valid) == N and bool(pq.valid.all())
    return pq, mates, quads, kf, cf


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_lift_matches_two_ray_triangulation_on_euroc(seed):
    rig = _rig()
    pq, mates, quads, kf, cf = _lifted(rig, seed)
    np.testing.assert_array_equal(pq.cf_left.numpy()[:, 0],
                                  quads.lcx.numpy()[:, 0])

    def ref(uv_l, th_l, uv_r, th_r):
        return _reference(rig, *(np.asarray(a, np.float64) for a in (
            uv_l, th_l, uv_r, th_r)))

    g, t = ref(np.stack([mates.left_x, mates.left_y], -1), mates.left_theta,
               np.stack([mates.right_x, mates.right_y], -1),
               mates.right_theta)
    gb, tb = ref(np.stack([quads.lcx[:, 0], quads.lcy[:, 0]], -1),
                 quads.lct[:, 0],
                 np.stack([quads.rcx[:, 0], quads.rcy[:, 0]], -1),
                 quads.rct[:, 0])
    # the reference itself meets the scene's points and tangents
    for mine, true in ((g, kf[0]), (t, kf[1]), (gb, cf[0]), (tb, cf[1])):
        assert _rel(mine, true).max() < 1e-4
    for name, ours, want in (("gamma", pq.gamma, g), ("tangent", pq.tangent, t),
                             ("gamma_bar", pq.gamma_bar, gb),
                             ("tangent_bar", pq.tangent_bar, tb)):
        err = _rel(ours.numpy(), want)
        assert err.max() < 1e-4, (name, float(err.max()))
    # the right image lifted with the left K (as the reference does) is
    # off by 12.8 px in x, as large as the disparities: depths miss by a
    # large fraction
    arrays = TY.rig_arrays_from_rig(rig, CPU)
    left_k = MT.lift_quads(mates, quads,
                           arrays._replace(K_right_inv=arrays.K_left_inv),
                           VOConfig())
    assert np.median(_rel(left_k.gamma.numpy(), g)) > 0.3


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 7])
def test_shared_k_lift_equals_left_k_lift_and_jax(seed):
    import jax.numpy as jnp

    from edge_based_visual_odometry_tpu.config import VOConfig as JVOConfig
    from edge_based_visual_odometry_tpu.models import motion_tracker as JMT
    from edge_based_visual_odometry_tpu.models import temporal_matcher as JTM
    from edge_based_visual_odometry_tpu.models import types as JTY

    rig = _rig(shared_k=True)
    pq, mates, quads, _, _ = _lifted(rig, seed)
    arrays = TY.rig_arrays_from_rig(rig, CPU)
    left_k = MT.lift_quads(mates, quads,
                           arrays._replace(K_right_inv=arrays.K_left_inv),
                           VOConfig())

    def j(nt, cls):
        return cls(**{k: jnp.asarray(
            v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy())
            for k, v in nt._asdict().items()})

    jpq = JMT.lift_quads(j(mates, JTY.StereoMates),
                         j(quads, JTM.TemporalQuads),
                         JTY.RigArrays.from_rig(rig), JVOConfig(),
                         use_gt=False)
    for name in MT.PoseQuads._fields:
        np.testing.assert_array_equal(getattr(pq, name).numpy(),
                                      getattr(left_k, name).numpy(),
                                      err_msg=name)
    # the JAX package's points bit for bit; its tangents round their cross
    # products in another order (within 1e-5, as tests/
    # test_torch_stereo_temporal.py holds lifted quads)
    for name in ("gamma", "gamma_bar", "cf_left", "valid"):
        np.testing.assert_array_equal(getattr(pq, name).numpy(),
                                      np.asarray(getattr(jpq, name)),
                                      err_msg=name)
    for name in ("tangent", "tangent_bar"):
        np.testing.assert_allclose(getattr(pq, name).numpy(),
                                   np.asarray(getattr(jpq, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def _chords(rig, cfg, lx, ly):
    """Right edges every pixel along each left point's epipolar line,
    within `max_disparity` - 0.5 of the point, and how many right edges
    each point's stage-2 gates should pass (float64)."""
    F = rig.F21
    D = cfg.max_disparity
    xs, ys = [], []
    for x, y in zip(lx, ly):
        a, b, c = F @ np.array([x, y, 1.0])
        n = np.hypot(a, b)
        s = (a * x + b * y + c) / (n * n)
        foot, t = np.array([x - a * s, y - b * s]), np.array([-b, a]) / n
        for k in np.arange(-D, D + 1.0):
            q = foot + k * t
            if np.hypot(q[0] - x, q[1] - y) <= D - 0.5:
                xs.append(q[0])
                ys.append(q[1])
    xs, ys = np.array(xs), np.array(ys)
    want = 0
    for x, y in zip(lx, ly):
        a, b, c = F @ np.array([x, y, 1.0])
        near = np.abs(a * xs + b * ys + c) / np.hypot(a, b) < 0.25
        want += int((near & (np.hypot(xs - x, ys - y) <= D - 0.5)).sum())
    return xs, ys, want


def test_stereo_gather_keeps_every_epipolar_candidate_on_euroc():
    rig = _rig()
    cfg = VOConfig(max_edges=1024, max_mates=1024, max_refine_pairs=8192)
    gx, gy = np.meshgrid([120.0, 300.0, 480.0, 640.0],
                         [60.5, 180.5, 300.5, 420.5])
    lx, ly = gx.ravel(), gy.ravel()
    rx, ry, want = _chords(rig, cfg, lx, ly)
    assert want > 16 * 32     # ~40 a chord: past the 26 slots a band of 6

    def edges(x, y):
        n = cfg.max_edges
        pad = lambda a: torch.from_numpy(np.pad(      # noqa: E731
            np.asarray(a, np.float32), (0, n - len(a))))
        valid = torch.arange(n) < len(x)
        return TY.EdgeList(x=pad(x), y=pad(y), theta=torch.zeros(n),
                           mag=torch.ones(n), valid=valid,
                           count=torch.tensor(len(x), dtype=torch.int32))

    z = torch.zeros(rig.left.height, rig.left.width)
    frame = TY.FrameData(left=z, right=z, left_gx=z, left_gy=z,
                         right_gx=z, right_gy=z)
    _, _, metrics = SM.match_stereo(
        edges(lx, ly), edges(rx, ry), frame,
        TY.rig_arrays_from_rig(rig, CPU), cfg,
        gather_ry=SM.derive_gather_band(rig, cfg))
    # stage 2 (epipolar distance, then max disparity): rows, candidates
    assert metrics[1, 0].item() == len(lx)
    assert metrics[1, 1].item() == want


# (c) the cell at a fifth of its width and height, focal lengths with
# them, distortion kept, small capacities (`vo_bench/tests/
# test_vo_bench_faults.py::tiny_cell`); the scene's textures five times
# coarser, so that a small image shows what the cell's own does (at the
# cell's texture scale a fifth-size image is crowded with ridges). At a
# fifth of the size the stereo step still misreads 1-5 px at the 90th
# percentile on the lap's frames 78-17, so the run starts at frame 31
# (SEED) and checks frames 34 onwards. Frames 34-42, run from frame 0 with
# RANSAC drawn from seed 0, read 0.065-0.135 / 0.056-0.097 / 0.055-0.158
# px and 546 / 514 / 503 at the fewest; with the right image lifted with
# the left K, 0.709-28.6 px of pose error; with the right image
# undistorted with the left K, 0.82-1.196 px of stereo error (its mates
# stay: at this size the cameras' centres differ by 2.6 and 1.4 px)
TEXTURE = 5.0
SMALL_CHECK = {"stereo_px": 0.33, "temporal_px": 0.3, "pose_px": 0.33,
               "mates_min": 450, "quads_min": 450, "inliers_min": 450}
SEED = 2 ** 31 + 95           # the lap's frame 31, 3 warm-up frames


def tiny_cell():
    cell = small_cell("euroc.every_frame")
    for plane in cell.scene["planes"]:
        plane["scale"] *= TEXTURE
    cell.workload["check"] = dict(SMALL_CHECK)
    return cell


def _left_k_lift(monkeypatch):
    """`lift_quads` as the reference and the JAX package lift: the right
    image with the left K."""
    real = MT.lift_quads

    def lift(kf, quads, rig, cfg, use_gt=False):
        return real(kf, quads, rig._replace(K_right_inv=rig.K_left_inv), cfg,
                    use_gt)
    monkeypatch.setattr(MT, "lift_quads", lift)


def _undistort_right_with_left_k(monkeypatch, cell):
    """The undistortion as a port that takes one K for both cameras would
    run it: the right image remapped with the left camera's K, so that
    its pinhole image lies ~13 px and ~7 px (at full size) off the right
    K's."""
    fx, fy, cx, cy = cell.config["rig"]["left_camera"]["intrinsics"]
    K_left = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    real = IMG.undistort

    def undistort(img, K, dist):
        return real(img, K_left.to(K), dist)
    monkeypatch.setattr(IMG, "undistort", undistort)


@pytest.mark.heavy
def test_small_euroc_cell_is_correct_and_sees_the_left_k_lift(monkeypatch):
    sound = FRUN.run(tiny_cell(), SEED, 8.0, False, time.perf_counter(),
                     device="cpu")
    assert sound["correct"], sound["checks"]
    _left_k_lift(monkeypatch)
    res = FRUN.run(tiny_cell(), SEED, 8.0, False, time.perf_counter(),
                   device="cpu")
    assert not res["correct"]
    pose = res["checks"]["pose_px"]
    assert pose["value"] > pose["limit"], res["checks"]


@pytest.mark.heavy
def test_small_euroc_cell_sees_the_right_image_undistorted_with_left_k(
        monkeypatch):
    cell = tiny_cell()
    _undistort_right_with_left_k(monkeypatch, cell)
    res = FRUN.run(cell, SEED, 8.0, False, time.perf_counter(), device="cpu")
    assert not res["correct"]
    stereo = res["checks"]["stereo_px"]
    assert stereo["value"] > stereo["limit"], res["checks"]


def test_room_lap_is_euroc_motion_inside_max_disparity():
    cell = SPEC.load_cell("euroc.every_frame")
    traj = cell.scene["trajectory"]
    n = traj["n_frames"]
    poses = [RS.trajectory_pose(traj, k) for k in range(n + 1)]
    np.testing.assert_allclose(poses[n][0], poses[0][0], atol=1e-12)
    np.testing.assert_allclose(poses[n][1], poses[0][1], atol=1e-12)
    centres = np.array([-R.T @ t for R, t in poses])
    steps = np.linalg.norm(np.diff(centres, axis=0), axis=-1)
    turns = [np.degrees(np.arccos(np.clip(
        (np.trace(b[0] @ a[0].T) - 1.0) / 2.0, -1.0, 1.0)))
        for a, b in zip(poses, poses[1:])]
    assert steps.max() <= 0.05 and max(turns) <= 1.75
    planes = RS.planes_of(cell.scene["planes"])
    floor = next(p for p in planes if p.ridges == 0)
    height = floor.c - centres @ np.asarray(floor.n)
    assert 1.2 <= height.min() and height.max() <= 1.6
    for p in planes:
        if p.ridges and p.n[1] == 0.0:                     # a wall
            gap = np.abs(centres @ np.asarray(p.n) - p.c)
            assert gap.min() >= 2.1
    rig = RS.Rig.from_config(cell.config["rig"])
    v, u = torch.meshgrid(torch.arange(0.0, rig.height, 8.0),
                          torch.arange(0.0, rig.width, 8.0), indexing="ij")
    d = REF.rays(rig.K_left, u.reshape(-1), v.reshape(-1), torch.float64)
    textured = [p for p in planes if p.ridges]
    fb = rig.K_left[0, 0] * np.linalg.norm(rig.T21)
    for R, t in poses[:n]:
        z = REF.raycast(planes, R, t, d)[:, 2]
        zt = REF.raycast(textured, R, t, d)[:, 2]
        seen = zt == z
        assert seen.float().mean() > 0.7
        assert fb / float(zt[seen].min()) <= 24.0
