"""Analytic synthetic stereo sequences with exact ground truth.

Renders a textured slanted plane viewed by a rectified stereo rig along a
known camera trajectory. All sampling is of a closed-form texture function,
so images are photometrically consistent across views to float precision -
ideal for end-to-end pipeline tests (the role ETH3D delivery_area GT plays
for the reference, src/Dataset.cpp:126-129, without needing the dataset on
disk).

Everything here is host-side NumPy.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from edge_based_visual_odometry_tpu_torch.config import CameraConfig, StereoRig


def _texture(u: np.ndarray, v: np.ndarray, rng_seed: int = 7,
             n_ridges: int = 24) -> np.ndarray:
    """Closed-form texture with many long oriented step edges (tanh ridges)
    over a smooth base - rich TOED structure, stable GN basins."""
    rng = np.random.default_rng(rng_seed)
    out = (120.0 + 25.0 * np.sin(3.0 * u) * np.cos(2.0 * v)
           + 15.0 * np.sin(1.3 * u + 2.1 * v))
    for k in range(n_ridges):
        phi = rng.uniform(0, np.pi)
        c = rng.uniform(-2.5, 2.5)
        # strictly alternating signs keep partial sums bounded (no clipping
        # plateaus that would erase texture)
        amp = 17.0 * (1.0 if k % 2 == 0 else -1.0)
        width = rng.uniform(0.01, 0.03)
        out = out + amp * np.tanh(
            (np.cos(phi) * u + np.sin(phi) * v - c) / width)
    return np.clip(out, 0.0, 255.0)


_PHOTO_CACHE = {}


def _load_photo(which: str = "china") -> np.ndarray:
    """Grayscale real photograph from packages shipped in this
    environment (no network): scikit-learn's sample photos (china.jpg /
    flower.jpg, real 427x640 camera images) or matplotlib's
    grace_hopper.jpg. Contrast-normalized to [30, 225]."""
    if which in _PHOTO_CACHE:
        return _PHOTO_CACHE[which]
    if which in ("china", "flower"):
        from sklearn.datasets import load_sample_images
        imgs = load_sample_images()
        arr = dict(zip(
            [f.rsplit("/", 1)[-1].split(".")[0] for f in imgs.filenames],
            imgs.images))[which]
        gray = np.asarray(arr, np.float64).mean(-1)
    else:
        import matplotlib.cbook as cbook
        from PIL import Image
        p = cbook.get_sample_data("grace_hopper.jpg", asfileobj=False)
        gray = np.asarray(Image.open(p).convert("L"), np.float64)
    lo, hi = gray.min(), gray.max()
    gray = 30.0 + (gray - lo) / max(hi - lo, 1e-9) * 195.0
    _PHOTO_CACHE[which] = gray
    return gray


def _photo_texture(u: np.ndarray, v: np.ndarray, rng_seed: int = 7,
                   which: str = "china",
                   scale: float = 110.0) -> np.ndarray:
    """Real-photograph texture: bilinear sample of a mirror-tiled real
    photo over the world plane (rng_seed offsets the tile per plane so
    the scene's planes carry different image content). Mirror tiling
    keeps the function continuous; bilinear sampling keeps it
    photometrically consistent across views to float precision, like the
    analytic texture."""
    photo = _load_photo(which)
    H, W = photo.shape
    rng = np.random.default_rng(rng_seed)
    ou = rng.uniform(0, W)
    ov = rng.uniform(0, H)

    def mirror(a, n):
        p = np.mod(a, 2.0 * (n - 1))
        return np.where(p < (n - 1), p, 2.0 * (n - 1) - p)

    x = mirror(u * scale + ou, W)
    y = mirror(v * scale + ov, H)
    x0 = np.clip(np.floor(x).astype(np.int64), 0, W - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, H - 2)
    fx = x - x0
    fy = y - y0
    p00 = photo[y0, x0]
    p01 = photo[y0, x0 + 1]
    p10 = photo[y0 + 1, x0]
    p11 = photo[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * p00 + fx * p01)
            + fy * ((1 - fx) * p10 + fx * p11))


@dataclasses.dataclass
class SyntheticFrame:
    left: np.ndarray              # (H, W) float32
    right: np.ndarray
    disparity: np.ndarray         # (H, W) float32 GT left disparity
    R: np.ndarray                 # (3, 3) world -> camera (left)
    t: np.ndarray                 # (3,)


@dataclasses.dataclass
class SyntheticSequence:
    rig: StereoRig
    frames: List[SyntheticFrame]


def default_rig(h: int = 240, w: int = 320) -> StereoRig:
    cam = CameraConfig(width=w, height=h, fx=300.0, fy=300.0,
                       cx=w / 2.0, cy=h / 2.0)
    return StereoRig(left=cam, right=cam,
                     R21=((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0)),
                     T21=(-0.12, 0.0, 0.0))


def _render(K: np.ndarray, R: np.ndarray, t: np.ndarray,
            planes, h: int, w: int, seed: int, texture_fn=None):
    """Render a set of textured planes {(n, c)} from camera (R, t):
    X_c = R X_w + t; per pixel the nearest positive ray-plane intersection
    wins (depth buffer). Multiple planes at different depths give the
    parallax needed to make pose estimation well-conditioned (a single
    plane leaves the classic low-parallax rotation/translation ambiguity).
    Returns (image, depth)."""
    jj, ii = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    Kinv = np.linalg.inv(K)
    d = np.stack([jj, ii, np.ones_like(jj)], axis=-1) @ Kinv.T  # cam rays

    best_lam = np.full((h, w), np.inf)
    img = np.zeros((h, w))
    for pi, plane in enumerate(planes):
        # plane = (n, c) textured over world (x, y), or (n, c, (a, b))
        # with explicit texture axes - walls parallel to an axis need
        # their in-plane coordinates, not a degenerate projection
        plane_n, plane_c = plane[0], plane[1]
        axes = plane[2] if len(plane) > 2 else (0, 1)
        denom = (d @ R) @ plane_n          # n . (R^T d) per pixel
        with np.errstate(divide="ignore", invalid="ignore"):
            lam = (plane_c + plane_n @ (R.T @ t)) / denom
        lam = np.where(lam > 0.1, lam, np.inf)
        lam_safe = np.where(np.isfinite(lam), lam, 0.0)
        X_w = (lam_safe[..., None] * d - t) @ R  # R^T (lam d - t)
        tex = (texture_fn or _texture)(X_w[..., axes[0]], X_w[..., axes[1]],
                                       rng_seed=seed + 101 * pi)
        closer = lam < best_lam
        img = np.where(closer, tex, img)
        best_lam = np.where(closer, lam, best_lam)
    depth = best_lam * d[..., 2]
    return img.astype(np.float32), depth, None


def make_sequence(n_frames: int = 3, h: int = 240, w: int = 320,
                  seed: int = 7,
                  texture: str = "analytic") -> SyntheticSequence:
    """Stereo frames of a slanted textured plane under forward+lateral
    motion with mild rotation. Disparity GT follows the reference's
    convention GT_right_x = left_x - disparity (same row, rectified rig;
    src/Stereo_Matches.cpp:159).

    texture: "analytic" (tanh-ridge closed form) or a real-photograph
    name ("china" / "flower" / "grace_hopper") - real image statistics
    over the exact synthetic geometry (the round-4 verdict's stand-in
    for unfetchable real datasets; see docs/REAL_DATA.md)."""
    import functools
    texture_fn = (None if texture == "analytic"
                  else functools.partial(_photo_texture, which=texture))
    rig = default_rig(h, w)
    K = rig.left.K
    baseline = -rig.T21_np[0]

    # strongly slanted planes whose depth orderings cross inside the view
    # (ground + two opposing walls) -> genuine multi-depth parallax
    def plane(nx, ny, z0):
        # plane nx*X + ny*Y + Z = z0 in the world(=frame-0 camera) frame
        n = np.array([nx, ny, 1.0])
        s = np.linalg.norm(n)
        return (n / s, z0 / s)

    planes = [plane(0.0, 1.2, 4.0),     # ground-like: near at bottom
              plane(-1.0, 0.0, 5.0),    # wall: near at left
              plane(0.8, -0.3, 6.0)]    # wall: near at top-right

    frames = []
    for k in range(n_frames):
        # camera trajectory: world -> camera
        ang = 0.01 * k
        Rz = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                       [np.sin(ang), np.cos(ang), 0.0],
                       [0.0, 0.0, 1.0]])
        angy = 0.008 * k
        Ry = np.array([[np.cos(angy), 0.0, np.sin(angy)],
                       [0.0, 1.0, 0.0],
                       [-np.sin(angy), 0.0, np.cos(angy)]])
        R = Rz @ Ry
        t = np.array([-0.05 * k, 0.01 * k, -0.08 * k])

        left, depth, _ = _render(K, R, t, planes, h, w, seed, texture_fn)
        # right camera: X_r = R21 X_l + T21 -> world->right = (R21 R, R21 t + T21)
        Rr = rig.R21_np @ R
        tr = rig.R21_np @ t + rig.T21_np
        right, _, _ = _render(K, Rr, tr, planes, h, w, seed, texture_fn)
        disparity = (K[0, 0] * baseline / depth).astype(np.float32)
        frames.append(SyntheticFrame(left=left, right=right,
                                     disparity=disparity,
                                     R=R.astype(np.float64),
                                     t=t.astype(np.float64)))
    return SyntheticSequence(rig=rig, frames=frames)


def make_corridor_sequence(n_frames: int = 100, h: int = 376,
                           w: int = 1241, seed: int = 7,
                           step: float = 0.06) -> SyntheticSequence:
    """Long forward-motion sequence through a textured corridor.

    `make_sequence`'s fixed slanted planes only stay in view for a few
    frames; this scene is built for 100+ frame trajectories (the round-3
    stand-in for the blocked KITTI-00 gate): ground plane, two slightly
    converging side walls and a receding far wall, textured over their
    IN-PLANE coordinates, with the camera advancing `step` m/frame down
    +Z under gentle yaw/pitch sway and lateral drift. KITTI-like
    focal length so image motion magnitudes are realistic.

    The focal length scales with the output width (fx = 718 * w / 1241):
    a fixed fx=718 at reduced smoke resolutions gives a razor-thin FOV
    that sees only the fronto-parallel far wall - the degenerate
    low-parallax configuration `_render`'s docstring warns about - so
    small smoke runs would judge an ill-conditioned scene (ADVICE r3).
    """
    f = 718.0 * w / 1241.0
    cam = CameraConfig(width=w, height=h, fx=f, fy=f,
                       cx=w / 2.0, cy=h / 2.0)
    rig = StereoRig(left=cam, right=cam,
                    R21=((1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                         (0.0, 0.0, 1.0)),
                    T21=(-0.12, 0.0, 0.0))
    K = rig.left.K
    baseline = -rig.T21_np[0]
    total = n_frames * step

    def unit(n):
        n = np.asarray(n, np.float64)
        return n / np.linalg.norm(n)

    # n . X = c, texture axes = the two in-plane world coordinates
    planes = [
        (unit([0.0, 1.0, 0.0]), 1.5, (0, 2)),            # ground y=1.5
        (unit([1.0, 0.0, 0.02]), -2.5, (1, 2)),          # left wall
        (unit([-1.0, 0.0, 0.02]), -2.5, (1, 2)),         # right wall
        (unit([0.0, 0.0, 1.0]), total + 12.0, (0, 1)),   # far wall
    ]

    frames = []
    for k in range(n_frames):
        yaw = 0.015 * np.sin(0.12 * k)
        pitch = 0.008 * np.sin(0.07 * k + 1.0)
        cy_, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.array([[cy_, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy_]])
        Rx = np.array([[1.0, 0.0, 0.0], [0.0, cp, -sp], [0.0, sp, cp]])
        R = Ry @ Rx                                  # world -> camera
        C = np.array([0.3 * np.sin(0.05 * k), 0.05 * np.sin(0.03 * k),
                      step * k])                     # camera center
        t = -R @ C
        left, depth, _ = _render(K, R, t, planes, h, w, seed)
        Rr = rig.R21_np @ R
        tr = rig.R21_np @ t + rig.T21_np
        right, _, _ = _render(K, Rr, tr, planes, h, w, seed)
        disparity = (K[0, 0] * baseline / depth).astype(np.float32)
        frames.append(SyntheticFrame(left=left, right=right,
                                     disparity=disparity,
                                     R=R.astype(np.float64),
                                     t=t.astype(np.float64)))
    return SyntheticSequence(rig=rig, frames=frames)
