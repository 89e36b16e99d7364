"""Third-order edge detection (TOED).

Port of `edge_based_visual_odometry_tpu/ops/toed.py`:

  1. `toed_gradient_field` - the separable TOED filter bank (12 column +
     36 row correlations of 19 taps at 4 half-pixel phases) giving the
     (2H, 2W) field of (Ix, Iy, |grad|, third-order orientation). On a
     CUDA tensor this is the hand-written kernel
     `csrc/toed_gradient_field.cu`; on a CPU tensor its plain twin
     `toed_gradient_field_plain`.
  2. `toed_nms_subpixel` - directional NMS over 8 gradient quadrants +
     parabola subpixel fit.
  3. `extract_edges` - raster-order compaction into a fixed-capacity
     EdgeList: the first `max_edges` entries of nonzero(keep).

`nms_compact` runs 2-3 over each image of a (B, 2H, 2W) field: on a CUDA
tensor the hand-written kernel `csrc/toed_nms_compact.cu`, which gives
the plain twin's EdgeLists bit for bit; on a CPU tensor the twin
`nms_compact_plain` (`toed_nms_subpixel`, then `extract_edges` per image).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from edge_based_visual_odometry_tpu_torch.models.types import EdgeList
from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.ops import filters

__all__ = ["EdgeList", "toed_gradient_field", "toed_gradient_field_plain",
           "toed_nms_subpixel", "extract_edges", "nms_compact",
           "nms_compact_plain", "detect_edges"]

HALO = 9                     # the CUDA kernel's taps: 2 HALO + 1 = 19
KERNEL_TAPS = 2 * HALO + 1
# The column channel feeding each of the 36 outputs, as the CUDA kernel
# fixes it (`phase_base(ph) + deriv_ychan(k)` in csrc/toed_gradient_field.cu):
# per phase the y-filter block (8, 0, 4, 4), per derivative its y-filter.
KERNEL_ROW_SELECT = np.array(
    [base + yc for base in (8, 0, 4, 4) for yc in (0, 1, 0, 1, 2, 1, 2, 0, 3)],
    dtype=np.int32)


def tap_width(kernel_size: int) -> int:
    """The width of the separable taps `filters.toed_separable_taps`
    builds for `kernel_size`: 2 ((kernel_size - 1) // 2 + 1) + 1."""
    return 2 * ((kernel_size - 1) // 2 + 1) + 1


def _taps(kernel_size: int, sigma: float):
    """The filter bank's (col, row_select, row) taps, of any width."""
    return filters.toed_separable_taps(kernel_size, sigma)


@functools.lru_cache(maxsize=None)
def _kernel_taps(kernel_size: int, sigma: float) -> np.ndarray:
    """The 12 x 19 column taps then the 36 x 19 row taps as one float32
    host array, built once per (kernel_size, sigma): the kernel takes
    them by value in its launch parameters (its constant bank), so no
    launch copies host memory to the device."""
    col, sel, row = _taps(kernel_size, sigma)
    if col.shape[1] != KERNEL_TAPS:
        raise ValueError(f"TOED taps of width {col.shape[1]}; the kernel "
                         f"takes {KERNEL_TAPS}")
    if not np.array_equal(sel, KERNEL_ROW_SELECT):
        raise ValueError("TOED row_select differs from the channel layout "
                         "the CUDA kernel fixes")
    out = np.concatenate([col.ravel(), row.ravel()]).astype(np.float32)
    out.setflags(write=False)
    return out


def _interleave(phases: torch.Tensor) -> torch.Tensor:
    """(B, 4, H, W) in phase order (0,0),(0,1),(1,0),(1,1) -> (B, 2H, 2W)."""
    B, _, H, W = phases.shape
    t = phases.reshape(B, 2, 2, H, W).permute(0, 3, 1, 4, 2)
    return t.reshape(B, 2 * H, 2 * W)


def toed_gradient_field_plain(img: torch.Tensor, kernel_size: int = 17,
                              sigma: float = 2.0):
    """Plain-PyTorch twin of the CUDA kernel. img: (H, W) or (B, H, W),
    values in [0, 255]. Returns (Ix, Iy, grad_mag, orient), each
    (..., 2H, 2W) float32; zero padding outside the image. Takes every
    `kernel_size` the filter bank builds taps for (the kernel: 19 taps,
    `kernel_size` 17)."""
    squeeze = img.dim() == 2
    x = (img[None] if squeeze else img).to(torch.float32)
    B, H, W = x.shape
    col, sel, row = _taps(kernel_size, sigma)
    halo = (col.shape[1] - 1) // 2
    dev = x.device
    col_t = torch.as_tensor(col, device=dev)[:, None, :, None]   # (12,1,K,1)
    row_t = torch.as_tensor(row, device=dev)[:, None, None, :]   # (36,1,1,K)
    cols = F.conv2d(x[:, None], col_t, padding=(halo, 0))        # (B,12,H,W)
    src = cols[:, torch.as_tensor(sel.astype(np.int64), device=dev)]
    d = F.conv2d(src, row_t, padding=(0, halo), groups=36)       # (B,36,H,W)
    d = d.reshape(B, 4, 9, H, W)
    fx, fy = d[:, :, 0], d[:, :, 1]
    fxx, fxy, fyy = d[:, :, 2], d[:, :, 3], d[:, :, 4]
    fxxy, fxyy, fxxx, fyyy = d[:, :, 5], d[:, :, 6], d[:, :, 7], d[:, :, 8]
    grad_mag = torch.sqrt(fx * fx + fy * fy)
    to_ix = (fx * (2 * fxx * fxx + 2 * fxy * fxy)
             + fy * (2 * fxx * fxy + 2 * fyy * fxy)
             + 2 * fx * fy * fxxy + fy * fy * fxyy + fx * fx * fxxx)
    to_iy = (fx * (2 * fxx * fxy + 2 * fyy * fxy)
             + fy * (2 * fyy * fyy + 2 * fxy * fxy)
             + 2 * fx * fy * fxyy + fx * fx * fxxy + fy * fy * fyyy)
    orient = torch.atan2(to_ix, -to_iy)
    out = tuple(_interleave(a) for a in (fx, fy, grad_mag, orient))
    return tuple(a[0] for a in out) if squeeze else out


def toed_gradient_field_cuda(img: torch.Tensor, kernel_size: int = 17,
                             sigma: float = 2.0):
    """The hand-written kernel (csrc/toed_gradient_field.cu); same contract
    as `toed_gradient_field_plain`, for float32 CUDA tensors."""
    if not img.is_cuda:
        raise ValueError(f"toed_gradient_field_cuda: needs a CUDA tensor, "
                         f"got one on {img.device}")
    squeeze = img.dim() == 2
    x = img[None] if squeeze else img
    if x.dim() != 3:
        raise ValueError(f"img: expected (H, W) or (B, H, W), got "
                         f"{tuple(img.shape)}")
    B, H, W = x.shape
    CB.require(x, "img", torch.float32, (B, H, W), x.device)
    taps = _kernel_taps(kernel_size, float(sigma))
    outs = [torch.empty((B, 2 * H, 2 * W), dtype=torch.float32,
                        device=x.device) for _ in range(4)]
    lib = CB.lib()
    with torch.cuda.device(x.device):
        err = lib.toed_gradient_field_launch(
            x.data_ptr(), B, H, W, *(o.data_ptr() for o in outs),
            taps.ctypes.data, CB.stream_ptr(x.device))
    CB.check(err, "toed_gradient_field")
    CB.LAUNCHES["toed_gradient_field"] += 1
    return tuple(o[0] for o in outs) if squeeze else tuple(outs)


def toed_gradient_field(img: torch.Tensor, kernel_size: int = 17,
                        sigma: float = 2.0):
    """(Ix, Iy, |grad|, orientation) on the (2H, 2W) grid: the CUDA kernel
    for a CUDA tensor, the plain twin for a CPU tensor."""
    if img.is_cuda:
        return toed_gradient_field_cuda(img.to(torch.float32).contiguous(),
                                        kernel_size, sigma)
    if img.device.type != "cpu":
        raise ValueError(f"toed_gradient_field: unsupported device "
                         f"{img.device}")
    return toed_gradient_field_plain(img, kernel_size, sigma)


def _neighbor(m: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """out[..., i, j] = m[..., i + di, j + dj] (zeros outside)."""
    H, W = m.shape[-2:]
    p = F.pad(m, (1, 1, 1, 1))
    return p[..., 1 + di:1 + di + H, 1 + dj:1 + dj + W]


def toed_nms_subpixel(Ix, Iy, grad_mag, orient, border: int = 10,
                      grad_mag_min: float = 2.0):
    """Directional NMS + parabola subpixel localization over (..., 2H, 2W)
    fields. Returns (subpix_x, subpix_y, subpix_mag, valid) in interp-grid
    units."""
    iH, iW = grad_mag.shape[-2:]
    g = grad_mag
    nd_x = Ix / g
    nd_y = Iy / g
    n = {(di, dj): _neighbor(g, di, dj)
         for di in (-1, 0, 1) for dj in (-1, 0, 1) if (di, dj) != (0, 0)}
    ax, ay = torch.abs(Ix), torch.abs(Iy)
    px, py = Ix >= 0, Iy >= 0
    sl_yx = nd_y / nd_x
    sl_xy = nd_x / nd_y
    quads = [
        (px & py & (Ix >= Iy), sl_yx, (n[(0, 1)], n[(1, 1)]), (n[(0, -1)], n[(-1, -1)])),
        (px & py & (Ix < Iy), sl_xy, (n[(1, 0)], n[(1, 1)]), (n[(-1, 0)], n[(-1, -1)])),
        (~px & py & (ax < Iy), -sl_xy, (n[(1, 0)], n[(1, -1)]), (n[(-1, 0)], n[(-1, 1)])),
        (~px & py & (ax >= Iy), -sl_yx, (n[(0, -1)], n[(1, -1)]), (n[(0, 1)], n[(-1, 1)])),
        (~px & ~py & (ax >= ay), sl_yx, (n[(0, -1)], n[(-1, -1)]), (n[(0, 1)], n[(1, 1)])),
        (~px & ~py & (ax < ay), sl_xy, (n[(-1, 0)], n[(-1, -1)]), (n[(1, 0)], n[(1, 1)])),
        (px & ~py & (Ix < ay), -sl_xy, (n[(-1, 0)], n[(-1, 1)]), (n[(1, 0)], n[(1, -1)])),
        (px & ~py & (Ix >= ay), -sl_yx, (n[(0, 1)], n[(-1, 1)]), (n[(0, -1)], n[(1, -1)])),
    ]
    slope = torch.zeros_like(g)
    fp = torch.zeros_like(g)
    fm = torch.zeros_like(g)
    for m, sl, (fp_a, fp_b), (fm_a, fm_b) in quads:
        slope = torch.where(m, sl, slope)
        fp = torch.where(m, fp_a * (1 - sl) + fp_b * sl, fp)
        fm = torch.where(m, fm_a * (1 - sl) + fm_b * sl, fm)

    is_max = ((g > fm) & (g >= fp)) | ((g >= fm) & (g > fp))
    s = torch.sqrt(1.0 + slope * slope)
    A = (fm + fp - 2.0 * g) / (2.0 * s * s)
    Bq = (fp - fm) / (2.0 * s)
    s_star = -Bq / (2.0 * A)
    max_f = A * s_star * s_star + Bq * s_star + g
    within_pixel = torch.abs(s_star) <= float(np.sqrt(np.float32(2.0)))

    jj = torch.arange(iW, dtype=torch.float32, device=g.device).expand(iH, iW)
    ii = torch.arange(iH, dtype=torch.float32,
                      device=g.device)[:, None].expand(iH, iW)
    subpix_x = jj + s_star * nd_x
    subpix_y = ii + s_star * nd_y
    sub_gx = max_f * nd_x
    sub_gy = max_f * nd_y
    subpix_mag = torch.sqrt(sub_gx * sub_gx + sub_gy * sub_gy)
    in_border = ((ii >= border) & (ii < iH - border)
                 & (jj >= border) & (jj < iW - border))
    grad_ok = g > grad_mag_min
    dir_ok = ~((ax < 1e-5) & (ay < 1e-5))
    valid = in_border & grad_ok & dir_ok & is_max & within_pixel
    return subpix_x, subpix_y, subpix_mag, valid


def extract_edges(subpix_x, subpix_y, subpix_mag, orient, valid,
                  img_height: int, img_width: int, max_edges: int,
                  border: int = 10) -> EdgeList:
    """Raster-order compaction of one image's (2H, 2W) maps: map interp
    coords to image coords via (p - 1) / 2, keep edges strictly inside the
    border, take the first `max_edges` of nonzero(keep)."""
    ex = (subpix_x - 1.0) * 0.5
    ey = (subpix_y - 1.0) * 0.5
    keep = (valid & (ex > border) & (ex < img_width - border)
            & (ey > border) & (ey < img_height - border))
    csum = torch.cumsum(keep.reshape(-1).to(torch.int64), 0)
    count = torch.clamp(csum[-1], max=max_edges).to(torch.int32)
    ranks = torch.arange(1, max_edges + 1, dtype=torch.int64,
                         device=keep.device)
    # the kept element of rank k sits at the first index whose inclusive
    # count reaches k + 1; ranks past `count` resolve past the end
    lin_of = torch.clamp(torch.searchsorted(csum, ranks), max=csum.numel() - 1)
    slot_ok = torch.arange(max_edges, device=keep.device) < count

    def pick(v):
        return torch.where(slot_ok, v.reshape(-1)[lin_of],
                           torch.zeros((), device=v.device))

    return EdgeList(pick(ex), pick(ey), pick(orient), pick(subpix_mag),
                    slot_ok, count)


def nms_compact_plain(Ix, Iy, grad_mag, orient, img_height: int,
                      img_width: int, max_edges: int,
                      grad_mag_min: float = 2.0, border: int = 10):
    """The plain twin of `csrc/toed_nms_compact.cu`: NMS, the subpixel fit
    and the raster-order compaction of each image of (B, 2H, 2W) fields;
    a list of B EdgeLists."""
    sx, sy, smag, valid = toed_nms_subpixel(Ix, Iy, grad_mag, orient,
                                            border=border,
                                            grad_mag_min=grad_mag_min)
    return [extract_edges(sx[b], sy[b], smag[b], orient[b], valid[b],
                          img_height, img_width, max_edges, border)
            for b in range(grad_mag.shape[0])]


def nms_compact_cuda(Ix, Iy, grad_mag, orient, img_height: int,
                     img_width: int, max_edges: int,
                     grad_mag_min: float = 2.0, border: int = 10):
    """The hand-written kernel (csrc/toed_nms_compact.cu); same contract
    as `nms_compact_plain`, for float32 CUDA tensors. Two launches (a
    count pass and a write pass); the EdgeLists view rows of (B,
    max_edges) outputs."""
    if not grad_mag.is_cuda:
        raise ValueError(f"nms_compact_cuda: needs a CUDA tensor, got one "
                         f"on {grad_mag.device}")
    if grad_mag.dim() != 3:
        raise ValueError(f"grad_mag: expected (B, 2H, 2W), got "
                         f"{tuple(grad_mag.shape)}")
    B, fh, fw = grad_mag.shape
    H, W, M = int(img_height), int(img_width), int(max_edges)
    if (fh, fw) != (2 * H, 2 * W):
        raise ValueError(f"fields of {(fh, fw)} for a {H} x {W} image: "
                         f"expected {(2 * H, 2 * W)}")
    if M < 0:
        raise ValueError(f"max_edges = {M}: must be >= 0")
    dev = grad_mag.device
    for name, t in (("Ix", Ix), ("Iy", Iy), ("grad_mag", grad_mag),
                    ("orient", orient)):
        CB.require(t, name, torch.float32, (B, fh, fw), dev)
    if B == 0:
        return []

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    row_count = empty(B, fh, dtype=torch.int32)
    cols = empty(B, fh, fw, dtype=torch.int32)
    x, y, theta, mag = (empty(B, M) for _ in range(4))
    ok = empty(B, M, dtype=torch.bool)
    count = empty(B, dtype=torch.int32)
    lib = CB.lib()
    with torch.cuda.device(dev):
        err = lib.toed_nms_compact_launch(
            Ix.data_ptr(), Iy.data_ptr(), grad_mag.data_ptr(),
            orient.data_ptr(), B, H, W, int(border), float(grad_mag_min), M,
            *(t.data_ptr() for t in (row_count, cols, x, y, theta, mag, ok,
                                     count)),
            CB.stream_ptr(dev))
    CB.check(err, "toed_nms_compact")
    CB.LAUNCHES["toed_nms_compact"] += 2
    return [EdgeList(x[b], y[b], theta[b], mag[b], ok[b], count[b])
            for b in range(B)]


def nms_compact(Ix, Iy, grad_mag, orient, img_height: int, img_width: int,
                max_edges: int, grad_mag_min: float = 2.0, border: int = 10):
    """Each image's EdgeList from (B, 2H, 2W) fields: the CUDA kernel for
    CUDA tensors, the plain twin for CPU tensors."""
    if grad_mag.is_cuda:
        return nms_compact_cuda(Ix, Iy, grad_mag, orient, img_height,
                                img_width, max_edges, grad_mag_min, border)
    if grad_mag.device.type != "cpu":
        raise ValueError(f"nms_compact: unsupported device {grad_mag.device}")
    return nms_compact_plain(Ix, Iy, grad_mag, orient, img_height, img_width,
                             max_edges, grad_mag_min, border)


def detect_edges(img: torch.Tensor, kernel_size: int = 17, sigma: float = 2.0,
                 grad_mag_min: float = 2.0, max_edges: int = 32768,
                 border: int = 10):
    """Image(s) -> EdgeList. img (H, W) gives one EdgeList; (B, H, W) gives
    a list of B EdgeLists, sharing one launch of the gradient field and one
    of NMS and compaction."""
    H, W = img.shape[-2:]
    fields = toed_gradient_field(img, kernel_size, sigma)
    if img.dim() == 2:
        return nms_compact(*(f[None] for f in fields), H, W, max_edges,
                           grad_mag_min, border)[0]
    return nms_compact(*fields, H, W, max_edges, grad_mag_min, border)
