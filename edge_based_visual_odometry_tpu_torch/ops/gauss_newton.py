"""Photometric Gauss-Newton refiners over flat candidate lists.

Port of the batched refiners of `edge_based_visual_odometry_tpu/ops/
gauss_newton.py`. Both work on mean-centred two-side rotated P x P patches
(at +-(P/2 + 1) along the edge normal) with Huber weights:

  - `refine_along_epipolar` - 1-DoF shift of the right candidate along the
    epipolar direction. On CUDA tensors this is the hand-written kernel
    `csrc/epipolar_gn.cu`; on CPU tensors its plain twin
    `refine_along_epipolar_plain`. `refine_along_epipolar_batch` drives it
    through the reference's two-phase convergence compaction.
  - `refine_2dof_batch` - the 2-DoF KF->CF translation refiner of one
    side, and `refine_2dof_pair_batch`, both sides of a temporal step: on
    CUDA tensors the hand-written kernel `csrc/gn_2dof.cu` (K3), one
    launch a phase for both sides, phase 2's lanes picked on the device
    (`refine_2dof_sides_cuda`); on CPU tensors the two-phase loop over its
    plain twin `refine_2dof_plain`.

Results the reference's TPU layout introduced, kept here because they
change results: every right/CF sample is clamped to the atlas tile the
reference would fetch around the candidate (`ops/tiled_sampling.py`),
which bounds GN travel; left/KF samples to the 32 px tile around the
edge; and lanes past the phase-2 budget keep their phase-1 state with
valid=False.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.ops import patches as P
from edge_based_visual_odometry_tpu_torch.ops import tiled_sampling as TS

LEFT_TILE = 32     # the reference samples left/KF patches from a 32/8 atlas
LEFT_STRIDE = 8
MAX_PATCH_SAMPLES = 242   # K2 and K3 hold a lane's 2 P^2 samples in a warp
                          # (P <= 11: 8 samples a thread)


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
    """Row sums of (B, n <= 256) in the CUDA kernels' order: sample s sits
    on lane s % 32, slot s // 32 of NS = max(4, ceil(n / 32)) slots; each
    lane adds its slots in order (0 past n), then a butterfly over the 32
    lanes. Keeps the plain twins bit-comparable to the kernels."""
    B, n = v.shape
    if n > 256:
        raise ValueError(f"_lane_sum: {n} samples a row, the kernels take "
                         f"at most 256")
    ns = max(4, -(-n // 32))
    s = F.pad(v, (0, 32 * ns - n)).reshape(B, ns, 32)
    acc = s[:, 0]
    for k in range(1, ns):
        acc = acc + s[:, k]
    for o in (16, 8, 4, 2, 1):
        acc = acc[:, :o] + acc[:, o:2 * o]
    return acc[:, 0]


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


def interleave_maps(right_img, right_gx, right_gy):
    """(H, W, 4) {right, gx, gy, right} pixels: the layout the CUDA kernel
    reads, one 16-byte load per pixel (the fourth value only pads it)."""
    return torch.stack([right_img, right_gx, right_gy, right_img], -1)


_PAIRS = ("epi_dir",)     # the (B, 2) lane operands; the others are (B,)


def _launch_gn(entry: str, img, maps, maps4, lanes, active, it0: int,
               it_stop: int, patch_size: int, max_iter: int, tol: float,
               huber_delta: float, tile: int):
    """Validate the operands of a GN kernel and launch it once.

    `img` is the (name, image) whose patches are sampled once per lane,
    `maps` the (name, map) image, gx, gy the iterations sample (interleaved
    into `maps4` here when that is None), `lanes` the (name, tensor) lane
    operands in the C entry's order, the last the starting step, whose
    shape the returned delta has. Returns (RefineResult, done)."""
    dev = lanes[0][1].device
    if not lanes[0][1].is_cuda:
        raise ValueError(f"{entry}: needs CUDA tensors, got them on {dev}")
    H, W = img[1].shape
    B = lanes[0][1].shape[0]
    if (2 * patch_size * patch_size > MAX_PATCH_SAMPLES
            or patch_size % 2 == 0):
        raise ValueError(f"patch_size {patch_size}: the kernel takes odd "
                         f"sizes with 2*P*P <= {MAX_PATCH_SAMPLES}")
    f32 = torch.float32
    for name, t in (img, *maps):
        CB.require(t, name, f32, (H, W), dev)
    for name, t in lanes:
        CB.require(t, name, f32, (B, 2) if name in _PAIRS else (B,), dev)
    CB.require(active, "active", torch.bool, (B,), dev)
    delta = torch.empty_like(lanes[-1][1])
    score, conf = (torch.empty((B,), dtype=f32, device=dev) for _ in range(2))
    valid, done = (torch.empty((B,), dtype=torch.bool, device=dev)
                   for _ in range(2))
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    if maps4 is None:
        maps4 = interleave_maps(*(t for _, t in maps))
    CB.require(maps4, "maps4", f32, (H, W, 4), dev)
    with torch.cuda.device(dev):
        err = getattr(CB.lib(), f"{entry}_launch")(
            img[1].data_ptr(), maps4.data_ptr(), H, W,
            *(t.data_ptr() for _, t in lanes), active.data_ptr(), B, it0,
            it_stop, max_iter, patch_size, tile, TS.atlas_stride(tile), tol,
            huber_delta, delta.data_ptr(),
            score.data_ptr(), conf.data_ptr(), valid.data_ptr(),
            iters.data_ptr(), done.data_ptr(), CB.stream_ptr(dev))
    CB.check(err, entry)
    CB.LAUNCHES[entry] += 1
    return RefineResult(delta, score, conf, valid, iters), done


def refine_along_epipolar_cuda(left_img, right_img, right_gx, right_gy,
                               lx, ly, ltheta, rx, ry, epi_dir, alpha0,
                               active, it0: int, it_stop: int,
                               patch_size: int = 7, max_iter: int = 20,
                               tol: float = 1e-3, huber_delta: float = 1.0,
                               tile: int = 32, maps4=None):
    """The hand-written kernel (csrc/epipolar_gn.cu): same contract as
    `refine_along_epipolar_plain`, for CUDA tensors. `maps4`, if given, is
    `interleave_maps(right_img, right_gx, right_gy)`, made once for several
    launches on the same maps; otherwise the launch makes it."""
    return _launch_gn(
        "refine_along_epipolar", ("left_img", left_img),
        (("right_img", right_img), ("right_gx", right_gx),
         ("right_gy", right_gy)), maps4,
        (("lx", lx), ("ly", ly), ("ltheta", ltheta), ("rx", rx), ("ry", ry),
         ("epi_dir", epi_dir), ("alpha0", alpha0)), active, it0, it_stop,
        patch_size, max_iter, tol, huber_delta, tile)


def refine_along_epipolar(left_img, right_img, right_gx, right_gy, lx, ly,
                          ltheta, rx, ry, epi_dir, alpha0, active, it0: int,
                          it_stop: int, maps4=None, **kw):
    """1-DoF epipolar GN over lanes (see `refine_along_epipolar_plain`):
    the CUDA kernel for CUDA tensors (`maps4` as there), the plain twin
    for CPU tensors."""
    args = (left_img, right_img, right_gx, right_gy, lx, ly, ltheta, rx, ry,
            epi_dir, alpha0, active, it0, it_stop)
    if lx.is_cuda:
        return refine_along_epipolar_cuda(*args, maps4=maps4, **kw)
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
    # the kernel's layout of the maps, made once for both phases
    maps4 = (interleave_maps(right_img, right_gx, right_gy) if lx.is_cuda
             else None)

    def run(args, delta0, it0, it_stop, act):
        return refine_along_epipolar(
            left_img, right_img, right_gx, right_gy, *args, delta0, act,
            it0, it_stop, maps4=maps4, patch_size=patch_size,
            max_iter=max_iter, tol=tol, huber_delta=huber_delta, tile=tile)

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
    """Plain-PyTorch twin of the CUDA kernel K3: 2-DoF photometric GN
    iterations [it0, it_stop) from displacement d0 (B, 2) on every active
    lane; the CF patch centre is kf - d, rotated by the CF orientation.
    Returns (RefineResult, done); inactive lanes start done. Sums follow
    the kernel's lane order and divisions by constants are reciprocal
    multiplies, as in the kernel, so both do the same arithmetic.

    A lane whose step is not finite (its 2x2 system is singular: det
    rounds to 0, as on flat CF maps with large equal gradients) takes no
    step, is done, and gets no score from that iteration (1e6 / 0 /
    valid=False if it had not finished before), as the reference's 1-DoF
    refiner treats a degenerate system. A documented deviation: the
    reference's 2-DoF refiner takes the step, and whether that step is
    NaN depends on its reduction order."""
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
                        torch.reciprocal(absr) * huber_delta)
        wgx, wgy = w * gx, w * gy
        H00 = _lane_sum(wgx * gx) + reg
        H01 = _lane_sum(wgx * gy)
        H11 = _lane_sum(wgy * gy) + reg
        b0 = _lane_sum(wgx * r)
        b1 = _lane_sum(wgy * r)
        cost = _lane_sum(w * r * r)
        inv = torch.reciprocal(H00 * H11 - H01 * H01)
        delta = torch.stack([-(H11 * b0 - H01 * b1) * inv,
                             -(-H01 * b0 + H00 * b1) * inv], -1)
        rms = torch.sqrt(cost * (1.0 / n_samples))
        step = torch.sqrt(delta[:, 0] * delta[:, 0]
                          + delta[:, 1] * delta[:, 1])
        # a singular system (det rounds to 0): no step, no score, stop
        singular = ~torch.isfinite(delta).all(-1)
        converged = (step < tol) | (it == max_iter - 1)
        is_outlier = (rms > huber_delta * 2.0) | (it < 1)
        finish = converged & ~done & ~singular
        score = torch.where(finish, rms, score)
        conf = torch.where(finish, torch.exp(-rms * (1.0 / huber_delta)),
                           conf)
        valid = torch.where(finish, ~is_outlier, valid)
        d = torch.where((done | singular)[:, None], d, d + delta)
        iters = torch.where(done, iters, torch.full_like(iters, it + 1))
        done = done | converged | singular
    return RefineResult(d, score, conf, valid, iters), done


def interleave_pair_maps(left_maps, right_maps):
    """(2, H, W, 4): `interleave_maps` of the left (image, gx, gy) and of
    the right CF maps, written straight into one buffer (the layout K3's
    both-sides launch reads)."""
    img = left_maps[0]
    out = torch.empty((2, *img.shape, 4), dtype=torch.float32,
                      device=img.device)
    for o, (m, mx, my) in zip(out, (left_maps, right_maps)):
        torch.stack([m, mx, my, m], -1, out=o)
    return out


def phase2_lanes(done, budget: int):
    """(S, B) mask of the lanes phase 2 runs: on each side the first
    `budget` lanes that phase 1 left undone, in index order, which is the
    lane set `_two_phase` compacts (a stable sort of `done`). Computed as
    K3's phase-2 launch computes it, from the inclusive count of done
    lanes over the flat (side, lane) order, without a sort: a lane's rank
    among the undone lanes of its side is (i + 1) - its count of done
    lanes."""
    S, B = done.shape
    cum = torch.cumsum(done.reshape(-1), 0, dtype=torch.int32).reshape(S, B)
    base = F.pad(cum[:-1, -1:], (0, 0, 1, 0))     # done lanes of earlier sides
    rank = torch.arange(1, B + 1, dtype=torch.int32,
                        device=done.device) - (cum - base)
    return ~done & (rank <= budget)


def _two_phase_in_place(run, B: int, args, active, delta0, phase1_iters: int,
                        phase2_budget: int, max_iter: int, chunk: int):
    """K3's two launches in plain form: phase 1 on every lane, then phase
    2 on the lanes of `phase2_lanes` (B2 as in `_two_phase`), from their
    phase-1 state at their own index, written back there. Equal to
    `_two_phase` lane for lane; `run` as there."""
    r1, done1 = run(args, delta0, 0, phase1_iters, active)
    done1 = done1 | ~active
    B2 = min(B, max(chunk, phase2_budget))
    sel = phase2_lanes(done1[None], B2)[0]
    r2, done2 = run(args, r1.delta, phase1_iters, max_iter, sel)
    res = RefineResult(*(torch.where(sel if b.dim() == 1 else sel[:, None],
                                     b, a) for a, b in zip(r1, r2)))
    return res, torch.where(sel, done2, done1)


def k3_outputs(S: int, B: int, device):
    """The (d, score, conf, valid, iters, done) buffers of a K3 sides
    launch over S sides of B lanes."""
    f32 = torch.float32
    return (torch.empty((S, B, 2), dtype=f32, device=device),
            torch.empty((S, B), dtype=f32, device=device),
            torch.empty((S, B), dtype=f32, device=device),
            torch.empty((S, B), dtype=torch.bool, device=device),
            torch.empty((S, B), dtype=torch.int32, device=device),
            torch.empty((S, B), dtype=torch.bool, device=device))


def _k3_launch(kf_imgs, maps4, kpack, cpack, active, out, it0: int,
               it_stop: int, max_iter: int, patch_size: int, tol: float,
               huber_delta: float, tile: int, queue=None, d0=None):
    """One launch of K3's sides entry over S = len(kf_imgs) sides; `out`
    the (d, score, conf, valid, iters, done) buffers it writes. `queue`:
    None for every lane from `d0` (S, B, 2), or from kf - cf if `d0` is
    None (phase 1); or (cum_done, budget, counter) for phase 2 (in
    place)."""
    dev = kpack.device
    S, B = len(kf_imgs), kpack.shape[0]
    H, W = kf_imgs[0].shape
    cum, budget, counter = queue if queue is not None else (None, 0, None)
    ptr = lambda t: None if t is None else t.data_ptr()     # noqa: E731
    with torch.cuda.device(dev):
        err = CB.lib().refine_2dof_sides_launch(
            kf_imgs[0].data_ptr(), kf_imgs[-1].data_ptr(), maps4.data_ptr(),
            H, W, kpack.data_ptr(), cpack.data_ptr(), ptr(d0), S,
            active.data_ptr(), B,
            it0, it_stop, max_iter, patch_size, tile, TS.atlas_stride(tile),
            tol, huber_delta, ptr(cum), budget, ptr(counter),
            *(t.data_ptr() for t in out), CB.stream_ptr(dev))
    CB.check(err, "refine_2dof")
    CB.LAUNCHES["refine_2dof"] += 1


def refine_2dof_sides_cuda(kf_imgs, maps4, kpack, cpack, active,
                           patch_size: int = 7, max_iter: int = 20,
                           tol: float = 1e-3, huber_delta: float = 3.0,
                           tile: int = 48, chunk: int = 2048,
                           phase1_iters: int = 0, phase2_budget: int = 0):
    """K3 over S = len(kf_imgs) (1 or 2) sides of B lanes, for CUDA
    tensors: `maps4` (S, H, W, 4) the interleaved CF maps, `kpack` and
    `cpack` (B, 3 S) the KF edge's and the CF candidate's (x, y, theta)
    of each side, `active` (B,) for all sides. One launch runs iterations
    [0, max_iter) from kf - cf; with 0 < phase1_iters < max_iter, a second
    launch runs the rest on the lanes of `phase2_lanes` in place (from one
    torch.cumsum: no sort, gather, merge or host sync). Returns
    (S RefineResults, done (S, B))."""
    dev = kpack.device
    if not kpack.is_cuda:
        raise ValueError(f"refine_2dof_sides_cuda: needs CUDA tensors, got "
                         f"them on {dev}")
    S, B = len(kf_imgs), kpack.shape[0]
    if S not in (1, 2):
        raise ValueError(f"refine_2dof_sides_cuda: {S} sides")
    if (2 * patch_size * patch_size > MAX_PATCH_SAMPLES
            or patch_size % 2 == 0):
        raise ValueError(f"patch_size {patch_size}: the kernel takes odd "
                         f"sizes with 2*P*P <= {MAX_PATCH_SAMPLES}")
    f32 = torch.float32
    H, W = kf_imgs[0].shape
    for k, t in enumerate(kf_imgs):
        CB.require(t, f"kf_imgs[{k}]", f32, (H, W), dev)
    CB.require(maps4, "maps4", f32, (S, H, W, 4), dev)
    CB.require(kpack, "kpack", f32, (B, 3 * S), dev)
    CB.require(cpack, "cpack", f32, (B, 3 * S), dev)
    CB.require(active, "active", torch.bool, (B,), dev)
    out = k3_outputs(S, B, dev)
    two = 0 < phase1_iters < max_iter
    kw = dict(max_iter=max_iter, patch_size=patch_size, tol=tol,
              huber_delta=huber_delta, tile=tile)
    args = (kf_imgs, maps4, kpack, cpack, active, out)
    _k3_launch(*args, 0, phase1_iters if two else max_iter, **kw)
    if two:
        B2 = min(B, max(chunk, phase2_budget))
        cum = torch.cumsum(out[5].view(-1), 0, dtype=torch.int32)
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
        _k3_launch(*args, phase1_iters, max_iter, **kw,
                   queue=(cum, B2, counter))
    return [RefineResult(*(t[k] for t in out[:5])) for k in range(S)], out[5]


K3_PATCH_SIZES = (1, 3, 5, 7, 9, 11)     # K3's instances (csrc/gn_2dof.cu)


def k3_info():
    """What the built K3 is on this card: warps per block, and for its
    direct (phase 1) and queue (phase 2) kernels the registers a thread,
    local (spill) bytes a thread and blocks an SM holds
    (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`): at patch size 7 as
    the top-level keys, and at every patch size K3 takes under
    `by_patch_size` {P: {...}}."""
    buf = (ctypes.c_int * (1 + 7 * len(K3_PATCH_SIZES)))()
    CB.check(CB.lib().refine_2dof_info(ctypes.addressof(buf)),
             "refine_2dof_info")
    w = buf[0]
    by_p = {}
    for j, P_ in enumerate(K3_PATCH_SIZES):
        v = buf[1 + 7 * j:8 + 7 * j]
        if v[0] != P_:
            raise RuntimeError(f"refine_2dof_info: patch size {v[0]} where "
                               f"{P_} was expected")
        by_p[P_] = dict(warps_per_block=w, **{
            f"{k}_{f}": v[1 + 3 * i + n]
            for i, k in enumerate(("direct", "queue"))
            for n, f in enumerate(("registers", "local_bytes",
                                   "blocks_per_sm"))},
            direct_warps_per_sm=w * v[3], queue_warps_per_sm=w * v[6])
    return dict(by_p[7], by_patch_size=by_p)


def refine_2dof_batch(kf_img, cf_img, cf_gx, cf_gy, kx, ky, ktheta,
                      cx, cy, ctheta, patch_size: int = 7, max_iter: int = 20,
                      tol: float = 1e-3, huber_delta: float = 3.0,
                      tile: int = 48, chunk: int = 2048, active=None,
                      phase1_iters: int = 0,
                      phase2_budget: int = 0) -> RefineResult:
    """Batched 2-DoF photometric GN of one side from d0 = kf - cf; see
    `refine_along_epipolar_batch` for `active` / `phase1_iters`. The
    counterpart of the reference's function of the same name: on CUDA
    tensors K3's sides entry with one side (`refine_2dof_sides_cuda`), on
    CPU tensors `_two_phase` over the plain twin (equal results)."""
    B = kx.shape[0]
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=kx.device)
    if kx.is_cuda:
        res, _ = refine_2dof_sides_cuda(
            [kf_img], interleave_maps(cf_img, cf_gx, cf_gy)[None],
            torch.stack([kx, ky, ktheta], -1),
            torch.stack([cx, cy, ctheta], -1), active, patch_size=patch_size,
            max_iter=max_iter, tol=tol, huber_delta=huber_delta, tile=tile,
            chunk=chunk, phase1_iters=phase1_iters,
            phase2_budget=phase2_budget)
        return res[0]
    if kx.device.type != "cpu":
        raise ValueError(f"refine_2dof_batch: unsupported device {kx.device}")

    def run(args, delta0, it0, it_stop, act):
        return refine_2dof_plain(
            kf_img, cf_img, cf_gx, cf_gy, *args, delta0, act, it0, it_stop,
            patch_size=patch_size, max_iter=max_iter, tol=tol,
            huber_delta=huber_delta, tile=tile)

    args = tuple(a.contiguous() for a in (kx, ky, ktheta, cx, cy, ctheta))
    d0 = torch.stack([kx - cx, ky - cy], -1)
    if not phase1_iters or phase1_iters >= max_iter:
        return run(args, d0, 0, max_iter, active)[0]
    return _two_phase(run, B, args, active, d0, phase1_iters, phase2_budget,
                      max_iter, chunk)


def refine_2dof_pair_batch(kf_left, kf_right, cf_maps4, kf_pack, c_pack,
                           active, patch_size: int = 7, max_iter: int = 20,
                           tol: float = 1e-3, huber_delta: float = 3.0,
                           tile: int = 48, chunk: int = 2048,
                           phase1_iters: int = 0, phase2_budget: int = 0):
    """Both sides of a temporal step's 2-DoF GN: (left, right)
    RefineResults, each what `refine_2dof_batch` gives for its side.
    `cf_maps4` is `interleave_pair_maps` of the CF frame's maps;
    `kf_pack` and `c_pack` (B, 6) the KF edges' and the CF candidates'
    (x, y, theta) of the left then the right side; `active` (B,) both
    sides. On CUDA tensors one K3 launch a phase covers both sides; on
    CPU tensors each side goes through `refine_2dof_batch`."""
    kw = dict(patch_size=patch_size, max_iter=max_iter, tol=tol,
              huber_delta=huber_delta, tile=tile, chunk=chunk,
              phase1_iters=phase1_iters, phase2_budget=phase2_budget)
    if kf_pack.is_cuda:
        res, _ = refine_2dof_sides_cuda(
            [kf_left, kf_right], cf_maps4, kf_pack.contiguous(),
            c_pack.contiguous(), active, **kw)
        return tuple(res)
    return tuple(refine_2dof_batch(
        kf, cf_maps4[s, ..., 0], cf_maps4[s, ..., 1], cf_maps4[s, ..., 2],
        *kf_pack[:, 3 * s:3 * s + 3].unbind(-1),
        *c_pack[:, 3 * s:3 * s + 3].unbind(-1), active=active, **kw)
        for s, kf in enumerate((kf_left, kf_right)))
