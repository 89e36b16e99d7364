"""Gaussian-derivative filter banks for third-order edge detection.

The reference hard-codes 8 arrays of 19 taps (src/toed/cpu_toed.cpp:143-160)
but keeps the closed-form generator in comments (cpu_toed.cpp:134-141,
148-155).  We generate the taps from those closed forms (sigma = TOED_SIGMA,
support p in [-9, 9], optional half-pixel phase shift dy = 0.5):

    G(p)    =  exp(-p^2 / 2 s^2) / (sqrt(2 pi) s)
    Gx(p)   = -p exp(-p^2 / 2 s^2) / (sqrt(2 pi) s^3)
    Gxx(p)  = (p^2 - s^2) exp(-p^2 / 2 s^2) / (sqrt(2 pi) s^5)
    Gxxx(p) =  p (3 s^2 - p^2) exp(-p^2 / 2 s^2) / (sqrt(2 pi) s^7)

and assemble the 36 2D convolution kernels (9 derivative products x 4
half-pixel phases) in XLA-correlation layout, so one `lax.conv` call
reproduces the reference's quadruple-nested scalar loop
(cpu_toed.cpp:180-364) as a single MXU-friendly convolution.
"""

from __future__ import annotations

import functools

import numpy as np

SQRT_2PI = np.sqrt(2.0 * np.pi)

# The 9 derivative images, as (x-filter, y-filter) separable products, in the
# reference's accumulation order (cpu_toed.cpp:207-216):
#   fx   = Gx * G      fy   = G * Gx      fxx  = Gxx * G
#   fxy  = Gx * Gx     fyy  = G * Gxx     fxxy = Gxx * Gx
#   fxyy = Gx * Gxx    fxxx = Gxxx * G    fyyy = G * Gxxx
DERIVATIVE_PRODUCTS = (
    ("Gx", "G"), ("G", "Gx"), ("Gxx", "G"), ("Gx", "Gx"), ("G", "Gxx"),
    ("Gxx", "Gx"), ("Gx", "Gxx"), ("Gxxx", "G"), ("G", "Gxxx"),
)
DERIV_NAMES = ("fx", "fy", "fxx", "fxy", "fyy", "fxxy", "fxyy", "fxxx", "fyyy")

# Interp-pixel phase order: (sy, sx) offsets into the 2x-upsampled field
# (cpu_toed.cpp writes phase (0,0)->(si,sj), (0,1)->(si,sj+1),
#  (1,0)->(si+1,sj), (1,1)->(si+1,sj+1)).
PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))


def gaussian_derivative_taps(name: str, sigma: float, shift: float,
                             support: int) -> np.ndarray:
    """1D taps filter(p + shift) for p in [-support, support], float64."""
    p = np.arange(-support, support + 1, dtype=np.float64) + shift
    s = float(sigma)
    g = np.exp(-(p * p) / (2.0 * s * s))
    if name == "G":
        return g / (SQRT_2PI * s)
    if name == "Gx":
        return -p * g / (SQRT_2PI * s**3)
    if name == "Gxx":
        return (p * p - s * s) * g / (SQRT_2PI * s**5)
    if name == "Gxxx":
        return p * (3.0 * s * s - p * p) * g / (SQRT_2PI * s**7)
    raise ValueError(name)


@functools.lru_cache(maxsize=None)
def toed_conv_kernels(kernel_size: int = 17, sigma: float = 2.0) -> np.ndarray:
    """Build the (36, 1, K, K) correlation kernels, K = kernel_size + 2.

    Output channel layout: channel (phase_idx * 9 + deriv_idx) computes
    derivative DERIV_NAMES[deriv_idx] at phase PHASES[phase_idx].

    Semantics being reproduced (cpu_toed.cpp:199-350): for phase (sy, sx),
      f(i, j) = sum_{p,q} img(i - p, j - q) * fx_tap(q + 0.5 sx) * fy_tap(p + 0.5 sy)
    with support p, q in [-8, 8] for phase (0, 0) (the 17x17 loop) and
    [-9, 9] for the shifted phases (the 19x19 loops), zero outside image.
    XLA conv computes out(i,j) = sum_{a,b} img(i + a - C, j + b - C) k[a, b]
    (correlation), so k[a, b] = x_tap(C - b) * y_tap(C - a) with C = support.
    """
    cent = (kernel_size - 1) // 2            # 8
    cent_interp = cent + 1                   # 9

    taps = {}
    for nm in ("G", "Gx", "Gxx", "Gxxx"):
        taps[(nm, 0)] = gaussian_derivative_taps(nm, sigma, 0.0, cent_interp)
        taps[(nm, 1)] = gaussian_derivative_taps(nm, sigma, 0.5, cent_interp)

    K = 2 * cent_interp + 1                  # 19
    kernels = np.zeros((len(PHASES) * 9, 1, K, K), dtype=np.float64)
    for phase_idx, (sy, sx) in enumerate(PHASES):
        for deriv_idx, (x_name, y_name) in enumerate(DERIVATIVE_PRODUCTS):
            x_t = taps[(x_name, sx)].copy()
            y_t = taps[(y_name, sy)].copy()
            if sx == 0 and sy == 0:
                # Phase (0,0) uses the 17x17 loop: taps indexed
                # [q + cent + 1] for q in [-8, 8] -> endpoints unused.
                x_t[0] = x_t[-1] = 0.0
                y_t[0] = y_t[-1] = 0.0
            # correlation layout with flipped taps
            k2d = np.outer(y_t[::-1], x_t[::-1])
            kernels[phase_idx * 9 + deriv_idx, 0] = k2d
    return kernels.astype(np.float32)


@functools.lru_cache(maxsize=None)
def toed_separable_taps(kernel_size: int = 17, sigma: float = 2.0):
    """Separable factorization of the same kernels for the fast path.

    Returns (col_taps, row_select, row_taps):
      col_taps: (12, K) - y-direction taps in correlation order. Channel
                layout: 0-3 unshifted full 19-tap (G, Gx, Gxx, Gxxx),
                4-7 half-pixel-shifted, 8-11 unshifted with endpoints zeroed
                (the reference's 17x17 phase-(0,0) loop, cpu_toed.cpp:200).
      row_select: (36,) int - which column channel feeds each output.
      row_taps: (36, K) - x-direction taps per output, correlation order.
    """
    cent = (kernel_size - 1) // 2
    cent_interp = cent + 1
    names = ("G", "Gx", "Gxx", "Gxxx")
    K = 2 * cent_interp + 1

    col = np.zeros((12, K), dtype=np.float64)
    for ti, nm in enumerate(names):
        full0 = gaussian_derivative_taps(nm, sigma, 0.0, cent_interp)
        col[ti] = full0[::-1]
        col[4 + ti] = gaussian_derivative_taps(nm, sigma, 0.5, cent_interp)[::-1]
        trunc = full0.copy()
        trunc[0] = trunc[-1] = 0.0
        col[8 + ti] = trunc[::-1]

    row_select = np.zeros((36,), dtype=np.int32)
    row = np.zeros((36, K), dtype=np.float64)
    for phase_idx, (sy, sx) in enumerate(PHASES):
        for deriv_idx, (x_name, y_name) in enumerate(DERIVATIVE_PRODUCTS):
            out = phase_idx * 9 + deriv_idx
            x_t = gaussian_derivative_taps(x_name, sigma, 0.5 * sx, cent_interp)
            if sx == 0 and sy == 0:
                x_t = x_t.copy()
                x_t[0] = x_t[-1] = 0.0
                row_select[out] = 8 + names.index(y_name)
            else:
                row_select[out] = 4 * sy + names.index(y_name)
            row[out] = x_t[::-1]
    return col.astype(np.float32), row_select, row.astype(np.float32)
