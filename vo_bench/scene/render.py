"""The benchmark's scenes, rendered with torch on the benchmark's device.

`texture` and `render` are a plain torch copy of the port's
`io/synthetic.py::_texture` and `_render` (closed-form tanh-ridge texture
on planes, nearest positive ray-plane hit per pixel), with three
additions the benchmark's scenes need:

- a plane may scale its texture coordinates (`scale`, metres a texture
  unit), mirror-tile them (`tile`, texture units a period, so ridges
  cover a whole street wall) and carry fewer ridges (`ridges`, 0 for a
  smooth road or floor);
- a camera with (k1, k2, p1, p2) distortion renders, at each distorted
  pixel, the ray through the undistorted point that the forward model
  maps there (20 fixed-point steps of `chip_smoke.py::distort_image`'s);
- `make_scene` renders a closed, periodic trajectory of N stereo frames
  from a scene file's planes and trajectory: frame N would be frame 0
  again, so a VO loop runs lap after lap with smooth motion.

Everything is float64 until the image is rounded to uint8, as a camera
gives it. The ridge parameters are drawn on the host with numpy's
`default_rng`, in `_texture`'s order, so a plane with `scale` 1, no tile
and 24 ridges renders what `_render` renders.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

N_RIDGES = 24


def ridge_params(rng_seed: int, n_ridges: int = N_RIDGES) -> np.ndarray:
    """(n_ridges, 3) of (phi, c, width), drawn as `_texture` draws them."""
    rng = np.random.default_rng(rng_seed)
    out = np.zeros((n_ridges, 3))
    for k in range(n_ridges):
        out[k, 0] = rng.uniform(0, np.pi)
        out[k, 1] = rng.uniform(-2.5, 2.5)
        out[k, 2] = rng.uniform(0.01, 0.03)
    return out


def _mirror(a: torch.Tensor, period: float) -> torch.Tensor:
    """Mirror-tile `a` into [-period / 2, period / 2]: continuous, so the
    tiling adds no step edge."""
    p = torch.remainder(a + period / 2.0, 2.0 * period)
    return torch.where(p < period, p, 2.0 * period - p) - period / 2.0


def texture(u: torch.Tensor, v: torch.Tensor, ridges: np.ndarray,
            n_ridges: int = N_RIDGES) -> torch.Tensor:
    """`_texture` over texture coordinates (u, v) with the first
    `n_ridges` of `ridges` (`ridge_params`); the sign of ridge k
    alternates with k as there."""
    out = (120.0 + 25.0 * torch.sin(3.0 * u) * torch.cos(2.0 * v)
           + 15.0 * torch.sin(1.3 * u + 2.1 * v))
    for k, (phi, c, width) in enumerate(ridges[:n_ridges]):
        amp = 17.0 * (1.0 if k % 2 == 0 else -1.0)
        out = out + amp * torch.tanh(
            (math.cos(phi) * u + math.sin(phi) * v - c) / width)
    return out.clamp(0.0, 255.0)


@dataclasses.dataclass
class Plane:
    """n . X_w = c, textured over world axes `axes` divided by `scale`."""

    n: Sequence[float]
    c: float
    axes: Sequence[int] = (0, 1)
    scale: float = 1.0
    tile: float = 0.0
    ridges: int = N_RIDGES


def pixel_rays(h: int, w: int, K: np.ndarray, dist: Sequence[float],
               device, dtype=torch.float64) -> torch.Tensor:
    """(h, w, 3) camera rays (z = 1) through each pixel of a camera with
    intrinsics K and (k1, k2, p1, p2) distortion."""
    jj = torch.arange(w, dtype=dtype, device=device)[None, :].expand(h, w)
    ii = torch.arange(h, dtype=dtype, device=device)[:, None].expand(h, w)
    xd = (jj - K[0, 2]) / K[0, 0]
    yd = (ii - K[1, 2]) / K[1, 1]
    k1, k2, p1, p2 = (float(d) for d in list(dist)[:4])
    x, y = xd.clone(), yd.clone()
    if any((k1, k2, p1, p2)):
        for _ in range(20):
            r2 = x * x + y * y
            radial = 1.0 + k1 * r2 + k2 * r2 * r2
            x = (xd - 2.0 * p1 * x * y - p2 * (r2 + 2.0 * x * x)) / radial
            y = (yd - p1 * (r2 + 2.0 * y * y) - 2.0 * p2 * x * y) / radial
    return torch.stack([x, y, torch.ones_like(x)], -1)


def render(rays: torch.Tensor, R: np.ndarray, t: np.ndarray,
           planes: List[Plane], seed: int):
    """Render `planes` from the camera (R, t) (X_c = R X_w + t) through
    `rays` (h, w, 3): per pixel the nearest hit beyond 0.1 wins. Plane i's
    ridges come from `ridge_params(seed + 101 * i)`. Returns (image,
    depth), float64; a pixel that hits nothing is 0 at infinite depth."""
    dev, dt = rays.device, rays.dtype
    Rt = torch.as_tensor(R, dtype=dt, device=dev)
    tt = torch.as_tensor(t, dtype=dt, device=dev)
    h, w, _ = rays.shape
    best = torch.full((h, w), math.inf, dtype=dt, device=dev)
    img = torch.zeros((h, w), dtype=dt, device=dev)
    dw = rays @ Rt                                   # R^T d per pixel
    for i, pl in enumerate(planes):
        n = torch.as_tensor(np.asarray(pl.n, np.float64), dtype=dt,
                            device=dev)
        denom = dw @ n
        lam = (pl.c + n @ (Rt.T @ tt)) / denom
        lam = torch.where(lam > 0.1, lam, torch.full_like(lam, math.inf))
        lam_safe = torch.where(torch.isfinite(lam), lam, torch.zeros_like(lam))
        X = (lam_safe[..., None] * rays - tt) @ Rt
        u = X[..., pl.axes[0]] / pl.scale
        v = X[..., pl.axes[1]] / pl.scale
        if pl.tile > 0:
            u, v = _mirror(u, pl.tile), _mirror(v, pl.tile)
        tex = texture(u, v, ridge_params(seed + 101 * i), pl.ridges)
        closer = lam < best
        img = torch.where(closer, tex, img)
        best = torch.where(closer, lam, best)
    return img, best * rays[..., 2]


def rotation(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """World -> camera rotation Rz(roll) Ry(yaw) Rx(pitch)."""
    cy, sy = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cr, sr = math.cos(roll), math.sin(roll)
    Ry = np.array([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    Rx = np.array([[1.0, 0.0, 0.0], [0.0, cp, -sp], [0.0, sp, cp]])
    Rz = np.array([[cr, -sr, 0.0], [sr, cr, 0.0], [0.0, 0.0, 1.0]])
    return Rz @ Ry @ Rx


def _wave(terms, phi: float) -> float:
    """sum of a * sin(h * phi + p) over terms [a, h, p] (h whole, so the
    sum has period 2 pi in phi)."""
    return sum(a * math.sin(int(h) * phi + p) for a, h, p in terms)


def trajectory_pose(traj: dict, k: int):
    """World -> camera (R, t) of frame k of the periodic trajectory:
    centre + waves on x, y, z (metres) and on yaw, pitch, roll (degrees),
    over phase 2 pi k / n_frames."""
    phi = 2.0 * math.pi * (k % traj["n_frames"]) / traj["n_frames"]
    C = np.array(traj["centre"], np.float64) + np.array(
        [_wave(traj["waves"].get(a, []), phi) for a in ("x", "y", "z")])
    ang = [math.radians(_wave(traj["waves"].get(a, []), phi))
           for a in ("yaw", "pitch", "roll")]
    R = rotation(*ang)
    return R, -R @ C


@dataclasses.dataclass
class Rig:
    """A stereo rig as the scene needs it (X_r = R21 X_l + T21)."""

    K_left: np.ndarray
    K_right: np.ndarray
    dist_left: Sequence[float]
    dist_right: Sequence[float]
    R21: np.ndarray
    T21: np.ndarray
    width: int
    height: int

    @staticmethod
    def from_config(cfg: dict) -> "Rig":
        """From a configuration file's `rig` (the reference's YAML
        schema: resolution, intrinsics, distortion, stereo R21 / T21)."""
        def K(cam):
            fx, fy, cx, cy = cam["intrinsics"]
            return np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
        left, right = cfg["left_camera"], cfg["right_camera"]
        return Rig(K(left), K(right),
                   left.get("distortion_coefficients", [0, 0, 0, 0]),
                   right.get("distortion_coefficients", [0, 0, 0, 0]),
                   np.asarray(cfg["stereo"]["R21"], np.float64),
                   np.asarray(cfg["stereo"]["T21"], np.float64),
                   int(left["resolution"][0]), int(left["resolution"][1]))


@dataclasses.dataclass
class Scene:
    """N stereo frames on the host as a camera gives them, and their
    world -> camera GT poses."""

    left: np.ndarray              # (N, H, W) uint8
    right: np.ndarray
    R: np.ndarray                 # (N, 3, 3) float64
    t: np.ndarray                 # (N, 3)
    planes: List[Plane]
    rig: Rig


def planes_of(spec: List[dict]) -> List[Plane]:
    return [Plane(**p) for p in spec]


def make_scene(rig: Rig, scene: dict, device,
               n_frames: Optional[int] = None) -> Scene:
    """Render the periodic trajectory `scene["trajectory"]` of
    `scene["planes"]` on `device`; the planes' ridges come from the
    scene's `texture_seed`, the same in every run, so that every seed of
    a cell does the same work. The images go to host memory once, as
    uint8."""
    seed = int(scene["texture_seed"])
    planes = planes_of(scene["planes"])
    traj = scene["trajectory"]
    n = traj["n_frames"] if n_frames is None else n_frames
    h, w = rig.height, rig.width
    rays_l = pixel_rays(h, w, rig.K_left, rig.dist_left, device)
    rays_r = pixel_rays(h, w, rig.K_right, rig.dist_right, device)
    lefts, rights, Rs, ts = [], [], [], []
    for k in range(n):
        R, t = trajectory_pose(traj, k)
        img_l, _ = render(rays_l, R, t, planes, seed)
        img_r, _ = render(rays_r, rig.R21 @ R, rig.R21 @ t + rig.T21,
                          planes, seed)
        lefts.append(to_u8(img_l))
        rights.append(to_u8(img_r))
        Rs.append(R)
        ts.append(t)
    return Scene(torch.stack(lefts).cpu().numpy(),
                 torch.stack(rights).cpu().numpy(), np.stack(Rs),
                 np.stack(ts), planes, rig)


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """Integer-valued as a camera gives it."""
    return torch.round(img).clamp(0, 255).to(torch.uint8)
