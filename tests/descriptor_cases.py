"""Seeded numpy inputs for `edge_descriptors`: the cases the port's CPU
tests hold the twin against JAX with, and its `gpu` tests hold K5 against
the twin with. No JAX here: `case(name, N)` returns float32 gradient
maps gx, gy (H, W), edges x, y, theta (N,) and the keyword arguments
(`VOConfig()`'s descriptor settings); `bf16_ulps` (on torch tensors) is
the tolerance K5 is held to against JAX's outputs."""

import numpy as np

H, W = 80, 120
CASES = ("interior", "borders", "off_image", "axis_angles", "flat_windows",
         "bin_edges", "padded_rows", "nonfinite", "bin_edge_overflow")
# the cases whose descriptors hold NaN rows
NAN_CASES = ("nonfinite", "bin_edge_overflow")
KW = dict(shift_mag=8.0, n_samples=16, n_spatial=4, n_orient=8,
          spacing=0.66, clip=0.2, scale=512.0)


def _smooth_maps(g):
    """Sobel-sized gradients of a smooth random image of 0-255."""
    img = g.random((H + 16, W + 16)) * 255
    for axis in (0, 1):                       # two 9-tap box blurs
        c = np.cumsum(img, axis=axis)
        img = (np.take(c, range(9, c.shape[axis]), axis=axis)
               - np.take(c, range(c.shape[axis] - 9), axis=axis)) / 9
    img = img[:H, :W] * 4
    gy, gx = np.gradient(img)
    return 8 * gx, 8 * gy


def case(name, N, seed=0):
    g = np.random.default_rng(seed)
    gx, gy = _smooth_maps(g)
    x, y = g.uniform(16, W - 16, N), g.uniform(16, H - 16, N)
    th = g.uniform(-np.pi, np.pi, N)
    if name == "interior":
        pass
    elif name == "borders":
        # edges on the four borders: at the right and bottom the tile
        # origin clamps to the last atlas tile, which reaches past the
        # image, and reads are edge-replicated
        side = np.arange(N) % 4
        x = np.where(side == 0, g.uniform(0, 2, N), x)
        x = np.where(side == 1, g.uniform(W - 2, W - 1, N), x)
        y = np.where(side == 2, g.uniform(0, 2, N), y)
        y = np.where(side == 3, g.uniform(H - 2, H - 1, N), y)
    elif name == "off_image":
        # shifted off the image by up to 60 px on either side
        x = np.where(g.random(N) < 0.5, g.uniform(-60, -9, N),
                     g.uniform(W + 9, W + 60, N))
        y = g.uniform(-60, H + 60, N)
    elif name == "axis_angles":
        th = np.array([0.0, np.pi / 2, -np.pi / 2, np.pi, -np.pi])[
            np.arange(N) % 5]
    elif name == "flat_windows":
        # no gradient under any sample: the norm is clamped at 1e-7 and the
        # descriptor is zero
        gx[8:72, 8:112] = 0.0
        gy[8:72, 8:112] = 0.0
        x, y = g.uniform(32, 88, N), g.uniform(32, 48, N)
    elif name == "bin_edges":
        # one gradient direction everywhere (atan2 exactly 0), and angles
        # that put it on an orientation bin edge; theta 1e-8 rounds ob to 8.0,
        # whose circular hat gives bin 0 the weight 1
        gx = np.full((H, W), 300.0)
        gy = np.zeros((H, W))
        k = np.arange(N) % 19
        th = np.where(k < 17, (k - 8) * (np.pi / 4), 0.0)
        th = np.where(k == 17, 1e-8, th)
        th = np.where(k == 18, -1e-8, th)
    elif name == "padded_rows":
        # capacity rows past the edge count hold (0, 0, 0)
        pad = np.arange(N) >= N // 2
        x, y, th = (np.where(pad, 0.0, a) for a in (x, y, th))
    elif name == "nonfinite":
        bad = np.arange(N) % 3 == 0
        vals = np.array([np.nan, np.inf, -np.inf])[g.integers(0, 3, N)]
        x = np.where(bad, vals, x)
        y = np.where(bad & (g.random(N) > 0.5), np.nan, y)
        th = np.where(np.arange(N) % 7 == 1, np.nan, th)
    elif name == "bin_edge_overflow":
        # theta 1e-8 under a gradient of angle 0: every finite sample's ob
        # rounds to 8.0; beside them a block of gradients of 1e20, whose
        # squared magnitude overflows: the samples that read it are not
        # finite and make their keypoint's half NaN
        gx = np.full((H, W), 300.0)
        gy = np.zeros((H, W))
        gx[36:44, 56:64] = 1e20
        th = np.full(N, 1e-8)
    else:
        raise ValueError(f"no descriptor case {name!r}")
    f32 = np.float32
    return ((gx.astype(f32), gy.astype(f32)),
            tuple(np.asarray(a).astype(f32) for a in (x, y, th)), dict(KW))


def bf16_ulps(a, b):
    """Entries of two bf16 tensors that are NaN in one only, or that differ
    by more than one bf16 ulp of max(|a|, |b|, 1) (the CPU tests' tolerance
    against JAX), and the largest difference in those ulps."""
    import torch

    u, v = a.float(), b.float()
    nan = u.isnan() | v.isnan()
    mag = torch.clamp(torch.maximum(u.abs(), v.abs()), min=1.0)
    ulps = torch.where(nan | (u == v), 0.0, (u - v).abs()
                       / torch.exp2(torch.floor(torch.log2(mag)) - 7))
    bad = (u.isnan() != v.isnan()) | ~(ulps <= 1)
    return int(bad.sum()), float(ulps.max()) if ulps.numel() else 0.0
