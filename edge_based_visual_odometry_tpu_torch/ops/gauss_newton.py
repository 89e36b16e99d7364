"""Photometric Gauss-Newton refiners over flat candidate lists.

Port of the batched refiners of `edge_based_visual_odometry_tpu/ops/
gauss_newton.py`. Both work on mean-centred two-side rotated 7x7 patches
(at +-(P/2 + 1) along the edge normal) with Huber weights:

  - `refine_along_epipolar` - 1-DoF shift of the right candidate along the
    epipolar direction. On CUDA tensors this is the hand-written kernel
    `csrc/epipolar_gn.cu`; on CPU tensors its plain twin
    `refine_along_epipolar_plain`. `refine_along_epipolar_batch` drives it
    through the reference's two-phase convergence compaction.
  - `refine_2dof_batch` - the 2-DoF KF->CF translation refiner (plain
    PyTorch).

Results the reference's TPU layout introduced, kept here because they
change results: every right/CF sample is clamped to the atlas tile the
reference would fetch around the candidate (`ops/tiled_sampling.py`),
which bounds GN travel; left/KF samples to the 32 px tile around the
edge; and lanes past the phase-2 budget keep their phase-1 state with
valid=False.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.ops import patches as P
from edge_based_visual_odometry_tpu_torch.ops import tiled_sampling as TS

LEFT_TILE = 32     # the reference samples left/KF patches from a 32/8 atlas
LEFT_STRIDE = 8


class RefineResult(NamedTuple):
    delta: torch.Tensor       # (B,) alpha (1-DoF) or (B, 2) displacement
    score: torch.Tensor       # final RMS residual (1e6 if never finished)
    confidence: torch.Tensor  # exp(-rms / huber)
    valid: torch.Tensor       # converged after iter 0 and rms <= 2 huber
    iters: torch.Tensor       # per-lane iterations run (diagnostic)


def _two_side_coords(cx, cy, theta, nx, ny, side, patch_size):
    """(B, 2*P*P) x and y coords of the plus/minus rotated patches around
    (cx, cy) shifted +-side along the normal n."""
    cp = P.rotated_patch_coords(cx + nx * side, cy + ny * side, theta,
                                patch_size)
    cm = P.rotated_patch_coords(cx - nx * side, cy - ny * side, theta,
                                patch_size)
    c = torch.cat([cp, cm], -2)
    return c[..., 0], c[..., 1]


def _lane_sum(v):
    """Row sums of (B, n <= 128) in the CUDA kernel's order: sample s sits
    on lane s % 32, each lane adds its samples in order, then a butterfly
    over the 32 lanes. Keeps the plain twin bit-comparable to the kernel."""
    B, n = v.shape
    s = F.pad(v, (0, 128 - n)).reshape(B, 4, 32)
    s = ((s[:, 0] + s[:, 1]) + s[:, 2]) + s[:, 3]
    for o in (16, 8, 4, 2, 1):
        s = s[:, :o] + s[:, o:2 * o]
    return s[:, 0]


def _centered_halves(v, pp):
    """Each half of (B, 2*pp) samples minus its own mean."""
    first = torch.arange(v.shape[1], device=v.device) < pp
    zero = torch.zeros((), device=v.device)
    mp = _lane_sum(torch.where(first, v, zero)) * (1.0 / pp)
    mm = _lane_sum(torch.where(first, zero, v)) * (1.0 / pp)
    return v - torch.where(first, mp[:, None], mm[:, None])


def _left_patches(img, x, y, theta, nx, ny, side, patch_size):
    xs, ys = _two_side_coords(x, y, theta, nx, ny, side, patch_size)
    vals = P.sample_around(img, x, y, xs, ys, LEFT_TILE, LEFT_STRIDE)
    return _centered_halves(vals, patch_size * patch_size)


def _normal(theta):
    return -torch.sin(theta), torch.cos(theta)


def refine_along_epipolar_plain(left_img, right_img, right_gx, right_gy,
                                lx, ly, ltheta, rx, ry, epi_dir, alpha0,
                                active, it0: int, it_stop: int,
                                patch_size: int = 7, max_iter: int = 20,
                                tol: float = 1e-3, huber_delta: float = 1.0,
                                tile: int = 32):
    """Plain-PyTorch twin of the CUDA kernel: runs GN iterations
    [it0, it_stop) on every active lane starting from alpha0 and returns
    (RefineResult, done). Inactive lanes start done. Sums follow the
    kernel's lane order and divisions by constants are reciprocal
    multiplies, as in the kernel, so both do the same arithmetic."""
    side = patch_size / 2.0 + 1.0
    pp = patch_size * patch_size
    n_samples = 2 * pp
    H, W = left_img.shape
    nx, ny = _normal(ltheta)
    lc = _left_patches(left_img, lx, ly, ltheta, nx, ny, side, patch_size)
    stride = TS.atlas_stride(tile)
    ox = TS.tile_origin(rx, tile, stride, W)[:, None]
    oy = TS.tile_origin(ry, tile, stride, H)[:, None]
    maps = torch.stack([right_img, right_gx, right_gy])
    dx, dy = epi_dir[:, 0:1], epi_dir[:, 1:2]

    B = lx.shape[0]
    alpha = alpha0.clone()
    done = ~active
    score = torch.full((B,), 1e6, device=lx.device)
    conf = torch.zeros((B,), device=lx.device)
    valid = torch.zeros((B,), dtype=torch.bool, device=lx.device)
    iters = torch.zeros((B,), dtype=torch.int32, device=lx.device)
    for it in range(it0, it_stop):
        if bool(done.all()):
            break
        xs, ys = _two_side_coords(rx + alpha * epi_dir[:, 0],
                                  ry + alpha * epi_dir[:, 1],
                                  ltheta, nx, ny, side, patch_size)
        rv, gx, gy = P.sample_tile_clamped(maps, ox, oy, xs, ys, tile)
        r = lc - _centered_halves(rv, pp)
        g = -gx * dx + gy * dy
        absr = torch.abs(r)
        w = torch.where(absr <= huber_delta, torch.ones_like(r),
                        torch.reciprocal(absr) * huber_delta)
        Hh = _lane_sum(w * g * g)
        b = _lane_sum(w * g * r)
        cost = _lane_sum(w * r * r)
        degenerate = Hh < 1e-8
        delta = torch.where(degenerate, torch.zeros_like(Hh),
                            -b / torch.clamp(Hh, min=1e-8))
        rms = torch.sqrt(cost * (1.0 / n_samples))
        converged = (torch.abs(delta) < tol) | (it == max_iter - 1)
        is_outlier = (rms > huber_delta * 2.0) | (it < 1)
        finish = converged & ~done & ~degenerate
        score = torch.where(finish, rms, score)
        conf = torch.where(finish, torch.exp(-rms * (1.0 / huber_delta)),
                           conf)
        valid = torch.where(finish, ~is_outlier, valid)
        alpha = torch.where(done | degenerate, alpha, alpha + delta)
        iters = torch.where(done, iters, torch.full_like(iters, it + 1))
        done = done | converged | degenerate
    return RefineResult(alpha, score, conf, valid, iters), done


def refine_along_epipolar_cuda(left_img, right_img, right_gx, right_gy,
                               lx, ly, ltheta, rx, ry, epi_dir, alpha0,
                               active, it0: int, it_stop: int,
                               patch_size: int = 7, max_iter: int = 20,
                               tol: float = 1e-3, huber_delta: float = 1.0,
                               tile: int = 32):
    """The hand-written kernel (csrc/epipolar_gn.cu): same contract as
    `refine_along_epipolar_plain`, for CUDA tensors."""
    dev = lx.device
    if not lx.is_cuda:
        raise ValueError(f"refine_along_epipolar_cuda: needs CUDA tensors, "
                         f"got them on {dev}")
    H, W = left_img.shape
    B = lx.shape[0]
    if 2 * patch_size * patch_size > 128 or patch_size % 2 == 0:
        raise ValueError(f"patch_size {patch_size}: the kernel takes odd "
                         "sizes with 2*P*P <= 128")
    f32 = torch.float32
    for name, t in (("left_img", left_img), ("right_img", right_img),
                    ("right_gx", right_gx), ("right_gy", right_gy)):
        CB.require(t, name, f32, (H, W), dev)
    for name, t in (("lx", lx), ("ly", ly), ("ltheta", ltheta), ("rx", rx),
                    ("ry", ry), ("alpha0", alpha0)):
        CB.require(t, name, f32, (B,), dev)
    CB.require(epi_dir, "epi_dir", f32, (B, 2), dev)
    CB.require(active, "active", torch.bool, (B,), dev)
    out = [torch.empty((B,), dtype=f32, device=dev) for _ in range(3)]
    valid = torch.empty((B,), dtype=torch.bool, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    done = torch.empty((B,), dtype=torch.bool, device=dev)
    lib = CB.lib()
    with torch.cuda.device(dev):
        err = lib.refine_along_epipolar_launch(
            left_img.data_ptr(), right_img.data_ptr(), right_gx.data_ptr(),
            right_gy.data_ptr(), H, W,
            lx.data_ptr(), ly.data_ptr(), ltheta.data_ptr(), rx.data_ptr(),
            ry.data_ptr(), epi_dir.data_ptr(), alpha0.data_ptr(),
            active.data_ptr(),
            B, it0, it_stop, max_iter, patch_size, tile,
            TS.atlas_stride(tile), tol, huber_delta,
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            valid.data_ptr(), iters.data_ptr(), done.data_ptr(),
            CB.stream_ptr(dev))
    CB.check(err, "refine_along_epipolar")
    CB.LAUNCHES["refine_along_epipolar"] += 1
    return RefineResult(out[0], out[1], out[2], valid, iters), done


def refine_along_epipolar(left_img, right_img, right_gx, right_gy, lx, ly,
                          ltheta, rx, ry, epi_dir, alpha0, active, it0: int,
                          it_stop: int, **kw):
    """1-DoF epipolar GN over lanes (see `refine_along_epipolar_plain`):
    the CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    args = (left_img, right_img, right_gx, right_gy, lx, ly, ltheta, rx, ry,
            epi_dir, alpha0, active, it0, it_stop)
    if lx.is_cuda:
        return refine_along_epipolar_cuda(*args, **kw)
    if lx.device.type != "cpu":
        raise ValueError(f"refine_along_epipolar: unsupported device "
                         f"{lx.device}")
    return refine_along_epipolar_plain(*args, **kw)


def _two_phase(run, B: int, args, active, delta0, phase1_iters: int,
               phase2_budget: int, max_iter: int, chunk: int):
    """Convergence compaction: every lane runs `phase1_iters` iterations,
    then only the unconverged lanes, stably compacted to the front of a
    B2 = min(B, max(chunk, phase2_budget)) buffer, run the rest. Lanes past
    the budget keep their phase-1 state (valid=False).

    `run(args, delta0, it0, it_stop, active)` -> (RefineResult, done)."""
    r1, done1 = run(args, delta0, 0, phase1_iters, active)
    done1 = done1 | ~active
    B2 = min(B, max(chunk, phase2_budget))
    order = torch.sort(done1.to(torch.int32), stable=True).indices
    idx = order[:B2]
    act2 = ~done1[idx]
    r2, _ = run(tuple(a[idx] for a in args), r1.delta[idx], phase1_iters,
                max_iter, act2)

    def merge(a, b):
        take = act2 if b.dim() == 1 else act2[:, None]
        out = a.clone()
        out[idx] = torch.where(take, b, a[idx])
        return out

    return RefineResult(*(merge(a, b) for a, b in zip(r1, r2)))


def refine_along_epipolar_batch(left_img, right_img, right_gx, right_gy,
                                lx, ly, ltheta, rx, ry, epi_dir,
                                patch_size: int = 7, max_iter: int = 20,
                                tol: float = 1e-3, huber_delta: float = 1.0,
                                tile: int = 48, chunk: int = 2048,
                                active=None, phase1_iters: int = 0,
                                phase2_budget: int = 0) -> RefineResult:
    """Batched 1-DoF epipolar GN from alpha = 0. All edge args (B,);
    epi_dir (B, 2) unit. `phase1_iters` > 0 enables the two-phase compaction
    (identical results for lanes within the phase-2 budget)."""
    B = lx.shape[0]
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=lx.device)

    def run(args, delta0, it0, it_stop, act):
        return refine_along_epipolar(
            left_img, right_img, right_gx, right_gy, *args, delta0, act,
            it0, it_stop, patch_size=patch_size, max_iter=max_iter, tol=tol,
            huber_delta=huber_delta, tile=tile)

    args = tuple(a.contiguous() for a in (lx, ly, ltheta, rx, ry, epi_dir))
    alpha0 = torch.zeros((B,), dtype=torch.float32, device=lx.device)
    if not phase1_iters or phase1_iters >= max_iter:
        return run(args, alpha0, 0, max_iter, active)[0]
    return _two_phase(run, B, args, active, alpha0, phase1_iters,
                      phase2_budget, max_iter, chunk)


def refine_2dof_plain(kf_img, cf_img, cf_gx, cf_gy, kx, ky, ktheta,
                      cx, cy, ctheta, d0, active, it0: int, it_stop: int,
                      patch_size: int = 7, max_iter: int = 20,
                      tol: float = 1e-3, huber_delta: float = 3.0,
                      tile: int = 32):
    """2-DoF photometric GN iterations [it0, it_stop) from displacement d0
    (B, 2); the CF patch centre is kf - d, rotated by the CF orientation.
    Returns (RefineResult, done)."""
    side = patch_size / 2.0 + 1.0
    pp = patch_size * patch_size
    n_samples = 2 * pp
    H, W = kf_img.shape
    nkx, nky = _normal(ktheta)
    lc = _left_patches(kf_img, kx, ky, ktheta, nkx, nky, side, patch_size)
    ncx, ncy = _normal(ctheta)
    stride = TS.atlas_stride(tile)
    ox = TS.tile_origin(cx, tile, stride, W)[:, None]
    oy = TS.tile_origin(cy, tile, stride, H)[:, None]
    maps = torch.stack([cf_img, cf_gx, cf_gy])
    reg = 1e-6 * n_samples

    B = kx.shape[0]
    d = d0.clone()
    done = ~active
    score = torch.full((B,), 1e6, device=kx.device)
    conf = torch.zeros((B,), device=kx.device)
    valid = torch.zeros((B,), dtype=torch.bool, device=kx.device)
    iters = torch.zeros((B,), dtype=torch.int32, device=kx.device)
    for it in range(it0, it_stop):
        if bool(done.all()):
            break
        xs, ys = _two_side_coords(kx - d[:, 0], ky - d[:, 1], ctheta,
                                  ncx, ncy, side, patch_size)
        rv, gx, gy = P.sample_tile_clamped(maps, ox, oy, xs, ys, tile)
        r = lc - _centered_halves(rv, pp)
        absr = torch.abs(r)
        w = torch.where(absr < huber_delta, torch.ones_like(r),
                        huber_delta / absr)
        H00 = (w * gx * gx).sum(-1) + reg
        H01 = (w * gx * gy).sum(-1)
        H11 = (w * gy * gy).sum(-1) + reg
        b0 = (w * gx * r).sum(-1)
        b1 = (w * gy * r).sum(-1)
        cost = (w * r * r).sum(-1)
        inv = 1.0 / (H00 * H11 - H01 * H01)
        delta = torch.stack([-(H11 * b0 - H01 * b1) * inv,
                             -(-H01 * b0 + H00 * b1) * inv], -1)
        rms = torch.sqrt(cost / n_samples)
        converged = (torch.linalg.norm(delta, dim=-1) < tol) | (it == max_iter - 1)
        is_outlier = (rms > huber_delta * 2.0) | (it < 1)
        finish = converged & ~done
        score = torch.where(finish, rms, score)
        conf = torch.where(finish, torch.exp(-rms / huber_delta), conf)
        valid = torch.where(finish, ~is_outlier, valid)
        d = torch.where(done[:, None], d, d + delta)
        iters = torch.where(done, iters, torch.full_like(iters, it + 1))
        done = done | converged
    return RefineResult(d, score, conf, valid, iters), done


def refine_2dof_batch(kf_img, cf_img, cf_gx, cf_gy, kx, ky, ktheta,
                      cx, cy, ctheta, patch_size: int = 7, max_iter: int = 20,
                      tol: float = 1e-3, huber_delta: float = 3.0,
                      tile: int = 48, chunk: int = 2048, active=None,
                      phase1_iters: int = 0,
                      phase2_budget: int = 0) -> RefineResult:
    """Batched 2-DoF photometric GN from d0 = kf - cf; see
    `refine_along_epipolar_batch` for `active` / `phase1_iters`."""
    B = kx.shape[0]
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=kx.device)

    def run(args, delta0, it0, it_stop, act):
        return refine_2dof_plain(
            kf_img, cf_img, cf_gx, cf_gy, *args, delta0, act, it0, it_stop,
            patch_size=patch_size, max_iter=max_iter, tol=tol,
            huber_delta=huber_delta, tile=tile)

    args = (kx, ky, ktheta, cx, cy, ctheta)
    d0 = torch.stack([kx - cx, ky - cy], -1)
    if not phase1_iters or phase1_iters >= max_iter:
        return run(args, d0, 0, max_iter, active)[0]
    return _two_phase(run, B, args, active, d0, phase1_iters, phase2_budget,
                      max_iter, chunk)
