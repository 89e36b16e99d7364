"""The scene renderer: a torch copy of the port's io/synthetic.py, the
distorted cameras' rays and the closed, periodic trajectory."""

import numpy as np
import torch

from edge_based_visual_odometry_tpu_torch.io import synthetic as S
from vo_bench.harness import spec as SPEC
from vo_bench.scene import render as RS


def _make_sequence_planes():
    def plane(nx, ny, z0):
        n = np.array([nx, ny, 1.0])
        s = np.linalg.norm(n)
        return (n / s, z0 / s)
    return [plane(0.0, 1.2, 4.0), plane(-1.0, 0.0, 5.0),
            plane(0.8, -0.3, 6.0)]


def test_render_matches_io_synthetic_on_a_small_frame():
    seq = S.make_sequence(n_frames=2, h=48, w=64)
    K, f = seq.rig.left.K, seq.frames[1]
    planes = _make_sequence_planes()
    img, depth, _ = S._render(K, f.R, f.t, planes, 48, 64, 7)
    rays = RS.pixel_rays(48, 64, K, [0, 0, 0, 0], "cpu")
    ti, td = RS.render(rays, f.R, f.t,
                       [RS.Plane(n=list(n), c=c) for n, c in planes], 7)
    np.testing.assert_allclose(ti.numpy(), img, atol=1e-4)
    np.testing.assert_allclose(td.numpy(), depth, rtol=1e-12)
    np.testing.assert_array_equal(
        RS.to_u8(ti).numpy(), np.round(img).clip(0, 255).astype(np.uint8))


# a radial-tangential camera (EuRoC MAV's cam0, 752 x 480): the renderer
# casts the ray through each distorted pixel
DISTORTED = {"resolution": [752, 480],
             "intrinsics": [458.654, 457.296, 367.215, 248.375],
             "distortion_coefficients": [-0.28340811, 0.07395907,
                                         0.00019359, 1.76187114e-05]}


def test_distorted_rays_invert_the_forward_model():
    rig = RS.Rig.from_config({"left_camera": DISTORTED,
                              "right_camera": DISTORTED,
                              "stereo": {"R21": np.eye(3).tolist(),
                                         "T21": [-0.11, 0.0, 0.0]}})
    rays = RS.pixel_rays(rig.height, rig.width, rig.K_left, rig.dist_left,
                         "cpu")
    x, y = rays[..., 0], rays[..., 1]
    k1, k2, p1, p2 = rig.dist_left[:4]
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    K = rig.K_left
    jj = torch.arange(rig.width, dtype=torch.float64)[None].expand_as(x)
    ii = torch.arange(rig.height, dtype=torch.float64)[:, None].expand_as(y)
    assert float((xd * K[0, 0] + K[0, 2] - jj).abs().max()) < 1e-6
    assert float((yd * K[1, 1] + K[1, 2] - ii).abs().max()) < 1e-6


def test_trajectory_closes():
    """Frame N is frame 0, and the step from frame N - 1 into frame 0 is
    no larger than the others: the loop runs lap after lap smoothly."""
    for name in ("street",):
        traj = SPEC.load_json(SPEC.BENCH_DIR / "scene" / f"{name}.json")[
            "trajectory"]
        n = traj["n_frames"]
        poses = [RS.trajectory_pose(traj, k) for k in range(n + 1)]
        np.testing.assert_allclose(poses[n][0], poses[0][0], atol=1e-12)
        np.testing.assert_allclose(poses[n][1], poses[0][1], atol=1e-12)
        centres = [-R.T @ t for R, t in poses]
        steps = [np.linalg.norm(b - a) for a, b in zip(centres, centres[1:])]
        assert steps[-1] <= max(steps[:-1]) + 1e-12
        assert len({round(float(s), 9) for s in steps}) > 1


def test_scene_frames_are_uint8_and_distinct():
    cell = SPEC.load_cell("kitti.every_frame")
    cfg = dict(cell.config)
    rig = RS.Rig.from_config(cfg["rig"])
    small = RS.Rig(rig.K_left * [[0.1], [0.1], [1]], rig.K_right * [[0.1],
                   [0.1], [1]], rig.dist_left, rig.dist_right, rig.R21,
                   rig.T21, 124, 38)
    sc = RS.make_scene(small, cell.scene, "cpu", n_frames=3)
    assert sc.left.dtype == np.uint8 and sc.left.shape == (3, 38, 124)
    assert (sc.left[0] != sc.left[1]).any()
    again = RS.make_scene(small, cell.scene, "cpu", n_frames=3)
    np.testing.assert_array_equal(again.right, sc.right)
