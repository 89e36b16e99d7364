"""Rows of a gather window for the compaction's tests
(`tests/test_torch_compact.py` on the CPU, `tests/test_torch_cuda.py` on
the card), and the radix order of float32 keys."""

import numpy as np

FILL = np.float32(3.0e38)      # the twin's key of a masked slot
# live keys the callers never make: -0.0 ties with +0.0, +NaN comes after
# +inf, these at and past the fill after the masked slots; ordered alike
# by the twin on the CPU (by comparison) and on the card (radix bits)
SPECIAL_KEYS = np.array([np.inf, np.nan, -0.0, 0.0, 3.0e38, 3.2e38,
                         3.4028235e38], np.float32)
# NaNs that only radix bits order (the card): by sign and payload
NAN_KEYS = np.array([0x7FFFFFFF, 0x7F800001, 0xFFC00000, 0xFFFFFFFF],
                    np.uint32).view(np.float32)


def radix_bits(x):
    """float32 -> uint32 in the order cub's radix sort gives floats: -0.0
    as +0.0, then the sign bit set flips every bit, else the sign bit."""
    u = np.asarray(x, np.float32).view(np.uint32)
    u = np.where(u == 0x80000000, np.uint32(0), u)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def make_case(Q, S, A, seed, live_p=None, priority="random"):
    """Rows of a gather window: idx, attributes, a mask whose live share
    varies from row to row (or is `live_p`), and a priority."""
    g = np.random.default_rng(seed)
    p = g.random((Q, 1)) if live_p is None else np.full((Q, 1), live_p)
    mask = g.random((Q, S)) < p
    idx = np.where(mask, g.integers(0, 50_000, (Q, S)), 0).astype(np.int64)
    attrs = g.normal(size=(A, Q, S)).astype(np.float32) * 100
    if priority == "random":
        pri = (g.random((Q, S)) * 3.0).astype(np.float32)
    elif priority == "ties":
        pri = np.round(g.random((Q, S)) * 3).astype(np.float32)
    elif priority in ("special", "nans"):
        keys = (SPECIAL_KEYS if priority == "special"
                else np.concatenate([SPECIAL_KEYS, NAN_KEYS]))
        pri = (g.random((Q, S)) * 3.0).astype(np.float32)
        pick = g.random((Q, S)) < 0.25
        pri[pick] = g.choice(keys, int(pick.sum()))
    else:
        pri = None
    return idx, attrs, mask, pri
