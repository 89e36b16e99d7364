"""Hand-built TOED fields for `toed.nms_compact`: the cases the port's CPU
tests hold the plain twin to, and its `gpu` tests hold the kernel
(`csrc/toed_nms_compact.cu`) to the twin with. No JAX or torch here.

A peak is an isolated |grad| maximum (no two peaks are neighbours) with
Ix = |grad| and Iy = 0: its quadrant is the first (slope 0), its
neighbours are 0, so the parabola puts the edge on the pixel, at
((j - 1) / 2, (i - 1) / 2) in image coordinates, and it is kept wherever
the thresholds let it be.
"""

import numpy as np

# name -> (H, W, border, grad_mag_min, peaks as (i, j, |grad|), the peaks
# kept as (i, j) in raster order)
H, W, BORDER, GMIN = 24, 32, 4, 2.0
_ABOVE = float(np.nextafter(np.float32(GMIN), np.float32(np.inf)))
LIMIT_CASES = {
    # ex = border is dropped (ex > border), ex = border + 0.5 kept
    "x_low": (H, W, BORDER, GMIN,
              [(20, 2 * BORDER + 1, 5.0), (30, 2 * BORDER + 2, 5.0)],
              [(30, 2 * BORDER + 2)]),
    # ex = W - border is dropped, W - border - 0.5 kept
    "x_high": (H, W, BORDER, GMIN,
               [(20, 2 * (W - BORDER), 5.0), (30, 2 * (W - BORDER) + 1, 5.0)],
               [(20, 2 * (W - BORDER))]),
    "y_low": (H, W, BORDER, GMIN,
              [(2 * BORDER + 1, 20, 5.0), (2 * BORDER + 2, 30, 5.0)],
              [(2 * BORDER + 2, 30)]),
    "y_high": (H, W, BORDER, GMIN,
               [(2 * (H - BORDER), 20, 5.0), (2 * (H - BORDER) + 1, 30, 5.0)],
               [(2 * (H - BORDER), 20)]),
    # |grad| = grad_mag_min is dropped (|grad| > grad_mag_min), the next
    # float32 above it kept
    "grad_min": (H, W, BORDER, GMIN,
                 [(20, 20, GMIN), (20, 30, _ABOVE)], [(20, 30)]),
    # border 0: peaks on the field's last row and column, whose missing
    # neighbours are the zero padding
    "field_edge": (H, W, 0, GMIN,
                   [(2 * H - 1, 10, 5.0), (10, 2 * W - 1, 5.0),
                    (2 * H - 1, 2 * W - 1, 5.0)],
                   [(10, 2 * W - 1), (2 * H - 1, 10), (2 * H - 1, 2 * W - 1)]),
}


def limit_fields(name):
    """(Ix, Iy, |grad|, orientation) of case `name`, each (1, 2H, 2W)
    float32, then (H, W, border, grad_mag_min) and the kept (i, j)."""
    h, w, border, gmin, peaks, kept = LIMIT_CASES[name]
    g = np.zeros((1, 2 * h, 2 * w), np.float32)
    for i, j, v in peaks:
        g[0, i, j] = v
    orient = np.arange(g.size, dtype=np.float32).reshape(g.shape) * 1e-3
    return (g.copy(), np.zeros_like(g), g, orient), (h, w, border, gmin), kept
