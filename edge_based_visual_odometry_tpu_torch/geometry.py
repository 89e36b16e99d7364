"""Projective / epipolar geometry as batched torch functions.

Port of `edge_based_visual_odometry_tpu/geometry.py`, restricted to what the
production frame calls: pose algebra, epipolar lines and distances, rays,
two-ray backprojection, 3D tangents, orientation gates, skew and so3_exp.
All functions broadcast over leading batch dims and keep the reference's
operation order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Pose(NamedTuple):
    """Rigid transform p_target = R @ p_source + t."""

    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    @staticmethod
    def identity(device=None, dtype=torch.float32) -> "Pose":
        return Pose(torch.eye(3, dtype=dtype, device=device),
                    torch.zeros(3, dtype=dtype, device=device))

    def transform(self, p: torch.Tensor) -> torch.Tensor:
        """R @ p + t over trailing (..., 3) points."""
        return torch.einsum("...ij,...j->...i", self.R, p) + self.t

    def rotate(self, p: torch.Tensor) -> torch.Tensor:
        return torch.einsum("...ij,...j->...i", self.R, p)

    def compose(self, other: "Pose") -> "Pose":
        """self . other: first apply `other`, then `self`."""
        return Pose(self.R @ other.R, self.rotate(other.t) + self.t)


def relative_pose(source: Pose, target: Pose) -> Pose:
    """Pose taking source-frame points to the target frame:
    R_rel = R_t R_s^T ; t_rel = -R_rel t_s + t_t."""
    R_rel = target.R @ source.R.transpose(-1, -2)
    t_rel = -torch.einsum("...ij,...j->...i", R_rel, source.t) + target.t
    return Pose(R_rel, t_rel)


def skew(t: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrices of (..., 3) vectors."""
    z = torch.zeros_like(t[..., 0])
    return torch.stack([
        torch.stack([z, -t[..., 2], t[..., 1]], -1),
        torch.stack([t[..., 2], z, -t[..., 0]], -1),
        torch.stack([-t[..., 1], t[..., 0], z], -1),
    ], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exp map (..., 3) -> (..., 3, 3)."""
    theta = torch.clamp(torch.linalg.norm(w, dim=-1, keepdim=True), min=1e-12)
    kx = skew(w / theta)
    th = theta[..., None]
    I = torch.eye(3, dtype=w.dtype, device=w.device)
    return I + torch.sin(th) * kx + (1 - torch.cos(th)) * (kx @ kx)


def epipolar_lines(F: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Lines l = F @ [x, y, 1] for (..., 2) points -> (..., 3)."""
    x = xy[..., 0]
    y = xy[..., 1]
    a = F[0, 0] * x + F[0, 1] * y + F[0, 2]
    b = F[1, 0] * x + F[1, 1] * y + F[1, 2]
    c = F[2, 0] * x + F[2, 1] * y + F[2, 2]
    return torch.stack([a, b, c], -1)


def point_line_distance(line: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Perpendicular distance of (..., 2) points to (..., 3) lines."""
    a, b, c = line[..., 0], line[..., 1], line[..., 2]
    num = torch.abs(a * xy[..., 0] + b * xy[..., 1] + c)
    return num / torch.sqrt(a * a + b * b)


def normal_foot_on_line(line: torch.Tensor, xy: torch.Tensor):
    """Foot of the perpendicular from a point to a line, and its distance."""
    a, b, c = line[..., 0], line[..., 1], line[..., 2]
    s = (a * xy[..., 0] + b * xy[..., 1] + c) / (a * a + b * b)
    foot = torch.stack([xy[..., 0] - a * s, xy[..., 1] - b * s], -1)
    return foot, torch.linalg.norm(xy - foot, dim=-1)


def tangential_intersection_with_line(line, xy, theta):
    """Intersection of the edge tangent (through xy at angle theta, in the
    tan(theta) parameterization) with a line, and its displacement."""
    a2 = torch.tan(theta)
    b2 = torch.full_like(a2, -1.0)
    c2 = -(a2 * xy[..., 0] - xy[..., 1])
    a1, b1, c1 = line[..., 0], line[..., 1], line[..., 2]
    den = a1 * b2 - a2 * b1
    xi = (b1 * c2 - b2 * c1) / den
    yi = (c1 * a2 - c2 * a1) / den
    inter = torch.stack([xi, yi], -1)
    return inter, torch.linalg.norm(inter - xy, dim=-1)


def backproject_two_rays(R21, T21, ray1, ray2):
    """Closed-form depth of ray1 from two normalized rays; returns the 3D
    point rho1 * ray1 in camera-1 coordinates."""
    Rr1 = torch.einsum("ij,...j->...i", R21, ray1)
    num = T21[0] - T21[2] * ray2[..., 0]
    den = Rr1[..., 2] * ray2[..., 0] - Rr1[..., 0]
    return (num / den)[..., None] * ray1


def reconstruct_3d_tangent(R21, gamma1, gamma2, tangent1, tangent2):
    """3D tangent as the intersection of the two interpretation planes."""
    n1 = torch.linalg.cross(tangent1, gamma1)
    n2 = torch.einsum("ji,...j->...i", R21, torch.linalg.cross(tangent2, gamma2))
    T = torch.linalg.cross(n1, n2)
    return T / torch.linalg.norm(T, dim=-1, keepdim=True)


def project_3d_tangent_to_2d(T3d, gamma):
    """t = normalize(T - T_z * gamma) at normalized image point gamma."""
    t = T3d - T3d[..., 2:3] * gamma
    return t / torch.linalg.norm(t, dim=-1, keepdim=True)


def pixel_to_ray(K_inv, xy):
    """K^-1 [x, y, 1] for (..., 2) pixel coords -> (..., 3) rays."""
    ones = torch.ones_like(xy[..., :1])
    return torch.einsum("ij,...j->...i", K_inv, torch.cat([xy, ones], -1))


def theta_to_ray_tangent(K_inv, theta):
    """K^-1 [cos t, sin t, 0]."""
    t = torch.stack([torch.cos(theta), torch.sin(theta),
                     torch.zeros_like(theta)], -1)
    return torch.einsum("ij,...j->...i", K_inv, t)


def project(K, p):
    """Pinhole projection of (..., 3) camera points -> (..., 2) pixels."""
    uvw = torch.einsum("ij,...j->...i", K, p)
    return uvw[..., :2] / uvw[..., 2:3]


def rad2deg(x):
    return x * (180.0 / math.pi)


def orientation_diff_deg(theta1, theta2):
    """|theta1 - theta2| in degrees wrapped to [0, 180]."""
    d = torch.remainder(torch.abs(rad2deg(theta1 - theta2)), 360.0)
    return torch.where(d > 180.0, 360.0 - d, d)


def orientation_gate(diff_deg, thresh_deg):
    """Pass if diff < t or |diff - 180| < t."""
    return (diff_deg < thresh_deg) | (torch.abs(diff_deg - 180.0) < thresh_deg)
