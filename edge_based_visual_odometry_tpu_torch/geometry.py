"""Projective / epipolar geometry as batched torch functions.

Port of `edge_based_visual_odometry_tpu/geometry.py`: pose algebra,
quaternions, epipolar lines and distances, rays, two-ray backprojection, 3D
tangents, linear triangulation, orientation gates, skew and so3_exp. All
functions broadcast over leading batch dims and keep the reference's
operation order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
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

    def detransform(self, p: torch.Tensor) -> torch.Tensor:
        """R^T @ (p - t)."""
        return torch.einsum("...ji,...j->...i", self.R, p - self.t)

    def inverse(self) -> "Pose":
        Rt = self.R.transpose(-1, -2)
        return Pose(Rt, -torch.einsum("...ij,...j->...i", Rt, self.t))

    def compose(self, other: "Pose") -> "Pose":
        """self . other: first apply `other`, then `self`."""
        return Pose(self.R @ other.R, self.rotate(other.t) + self.t)

    def center(self) -> torch.Tensor:
        """Camera centre in the source frame, -R^T t."""
        return -torch.einsum("...ji,...j->...i", self.R, self.t)


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


def quat_to_R(q: torch.Tensor) -> torch.Tensor:
    """(qw, qx, qy, qz) -> rotation matrix; normalizes first."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def R_to_quat(R) -> np.ndarray:
    """Rotation matrix -> (qw, qx, qy, qz); host-side numpy (trajectory
    IO). Takes an array or a tensor on any device."""
    if hasattr(R, "detach"):
        R = R.detach().cpu().numpy()
    R = np.asarray(R, dtype=np.float64)
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


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


def two_view_linear_triangulation(gamma1_px, gamma2_px, K1_inv, K2_inv, R, T):
    """Linear two-view triangulation of (..., 2) pixel pairs: the 4x4 DLT
    system solved as its inhomogeneous 3x3 normal equations (last
    coordinate fixed to 1). Returns (..., 3) points in view-1 coordinates."""
    g1 = pixel_to_ray(K1_inv, gamma1_px)
    g2 = pixel_to_ray(K2_inv, gamma2_px)
    zeros = torch.zeros_like(g1[..., 0])
    ones = torch.ones_like(zeros)
    y2, x2 = g2[..., 1], g2[..., 0]
    r0 = torch.stack([zeros, -ones, g1[..., 1], zeros], -1)
    r1 = torch.stack([ones, zeros, -g1[..., 0], zeros], -1)
    r2 = torch.stack([y2 * R[2, 0] - R[1, 0], y2 * R[2, 1] - R[1, 1],
                      y2 * R[2, 2] - R[1, 2], y2 * T[2] - T[1]], -1)
    r3 = torch.stack([R[0, 0] - x2 * R[2, 0], R[0, 1] - x2 * R[2, 1],
                      R[0, 2] - x2 * R[2, 2], T[0] - x2 * T[2]], -1)
    A = torch.stack([r0, r1, r2, r3], -2)               # (..., 4, 4)
    M = A[..., :3]
    b = -A[..., 3]
    AtA = torch.einsum("...ki,...kj->...ij", M, M)
    Atb = torch.einsum("...ki,...k->...i", M, b)
    # a singular system gives non-finite values, as JAX's solve does
    return torch.linalg.solve_ex(AtA, Atb)[0]


def multiview_linear_triangulation(pts_px, Rs, Ts, K_inv):
    """N-view linear triangulation. pts_px: (N, 2) pixels; Rs/Ts: (N-1, 3,
    3)/(N-1, 3) poses of views 2..N relative to view 1 (identity). Returns
    the (3,) point in view-1 coordinates."""
    g = pixel_to_ray(K_inv, pts_px)                     # (N, 3)
    z = torch.zeros((), dtype=g.dtype, device=g.device)
    one = torch.ones((), dtype=g.dtype, device=g.device)
    rows = [torch.stack([z, -one, g[0, 1], z]),
            torch.stack([one, z, -g[0, 0], z])]
    for p in range(Rs.shape[0]):
        Rp, Tp, mp = Rs[p], Ts[p], g[p + 1]
        rows.append(torch.stack([mp[1] * Rp[2, 0] - Rp[1, 0],
                                 mp[1] * Rp[2, 1] - Rp[1, 1],
                                 mp[1] * Rp[2, 2] - Rp[1, 2],
                                 mp[1] * Tp[2] - Tp[1]]))
        rows.append(torch.stack([Rp[0, 0] - mp[0] * Rp[2, 0],
                                 Rp[0, 1] - mp[0] * Rp[2, 1],
                                 Rp[0, 2] - mp[0] * Rp[2, 2],
                                 Tp[0] - mp[0] * Tp[2]]))
    A = torch.stack(rows, 0)
    M, b = A[:, :3], -A[:, 3]
    return torch.linalg.solve_ex(M.T @ M, M.T @ b)[0]


def rad2deg(x):
    return x * (180.0 / math.pi)


def deg2rad(x):
    return x * (math.pi / 180.0)


def orientation_diff_deg(theta1, theta2):
    """|theta1 - theta2| in degrees wrapped to [0, 180]."""
    d = torch.remainder(torch.abs(rad2deg(theta1 - theta2)), 360.0)
    return torch.where(d > 180.0, 360.0 - d, d)


def orientation_gate(diff_deg, thresh_deg):
    """Pass if diff < t or |diff - 180| < t."""
    return (diff_deg < thresh_deg) | (torch.abs(diff_deg - 180.0) < thresh_deg)
