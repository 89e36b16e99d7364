"""Rows for the best/nearly-best streak filter
(`stereo_matcher._bnb_keep`, its kernel `csrc/bnb_keep.cu`), for its CPU
tests (`tests/test_torch_bnb.py`) and its `gpu` tests
(`tests/test_torch_cuda.py`): hand-made rows of the cases the sort and the
streak meet, and seeded rows as the callers make them, as numpy arrays
(scores (R, C) float32, mask (R, C) bool)."""

import numpy as np

FILL = np.float32(3.4e38)      # the twin's key of a masked slot
# the callers' ratio thresholds (VOConfig): stereo stage 6 (`bnb_ncc`, NCC,
# higher better), stage 7 (`bnb_sift`, descriptor distance, lower better),
# the temporal step (`temporal_bnb_ratio`, both)
THRESHOLDS = {"stereo_ncc": (0.9, True), "stereo_sift": (0.4, False),
              "temporal_ncc": (0.8, True), "temporal_sift": (0.8, False)}
# NaNs of both signs and other payloads: only the card orders them by bits
NANS = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF812345,
                 0x7FFFFFFF], np.uint32).view(np.float32)


def _f32(*v):
    return np.array(v, np.float32)


def patterns(thresh: float, higher_better: bool, nans: bool):
    """Hand-made live slots (scores, in slot order) for one threshold and
    direction: ties of the best and mid-streak, a best of 0, -0.0 against
    +0.0, negative scores, +-inf, live keys at the fill (3.4e38), ratios
    one float32 ulp either side of the threshold, 0 / 1 / 2 live slots;
    with `nans`, NaNs of both signs and other payloads."""
    t = np.float32(thresh)
    up, down = np.nextafter(t, np.float32(2)), np.nextafter(t, np.float32(0))
    one_up = np.nextafter(np.float32(1), np.float32(2))

    def d(*v):       # scores of these ratios to the first: v, or 1 / v
        v = _f32(*v)
        return v if higher_better else (np.float32(1) / v).astype(np.float32)
    if higher_better:     # ratio s / 1
        exact = [_f32(1, t), _f32(1, up), _f32(1, down),
                 _f32(1, up, t, t, down, t)]
    else:                 # ratio best / s, best = t, up or down
        exact = [_f32(t, 1), _f32(up, 1), _f32(down, 1),
                 _f32(t, 1, 1, one_up, 1)]
    rows = [
        _f32(), _f32(0.5), d(0.7, 0.69), d(1.0, 0.01),
        d(1.0, 1.0, 0.95, 0.2),                    # best tied
        d(1.0, 0.97, 0.97, 0.97, 0.5, 0.97),       # ties mid-streak
        d(0.97, 1.0, 0.97, 0.5, 0.97, 0.99),
        _f32(0.0, -0.1, -0.5), _f32(0.0, 0.1, 0.5, 0.0),   # best 0
        _f32(-0.0, 0.0, 0.3), _f32(0.0, -0.0, 0.3), _f32(0.3, -0.0, 0.0),
        _f32(-0.2, -0.3, -0.25, -0.9),             # negative scores
        _f32(-0.5, 0.4, -0.45, -0.1),
        _f32(np.inf, 1.0, 0.95), _f32(-np.inf, 1.0, 0.95),
        _f32(np.inf, np.inf, 1.0), _f32(-np.inf, -np.inf),
        _f32(1.0, np.inf, -np.inf, 0.99),
        _f32(3.4e38, 1.0, 0.95), _f32(-3.4e38, 1.0, 0.95),   # at the fill
        _f32(3.4e38, 3.4e38), _f32(-3.4e38, -3.4e38, 1.0),
        _f32(3.4e38, 3.0e38, 3.4028235e38),
    ] + exact
    if nans:
        rows += [np.concatenate([_f32(1.0, 0.95), NANS]),
                 np.concatenate([NANS[:2], _f32(0.9, 0.85)]),
                 _f32(np.nan, np.nan), np.concatenate([NANS, _f32(0.3)]),
                 np.concatenate([NANS[2:4], _f32(-np.inf, np.inf)])]
    return rows


def edge_rows(C: int, thresh: float, higher_better: bool, seed: int = 0,
              nans: bool = True):
    """Each pattern of `patterns` that fits in C slots, four ways: at the
    row's start and at random slots, with the other slots masked or live
    at lower-ranked scores; a masked slot's score is random, NaN or the
    fill. Then rows with every slot live and rows with none."""
    g = np.random.default_rng(seed)
    out_s, out_m = [], []
    worse = np.float32(-0.5 if higher_better else 1e6)
    for p in patterns(thresh, higher_better, nans):
        if len(p) > C:
            continue
        for placed in ("start", "random"):
            for rest_live in (False, True):
                s = g.normal(size=C).astype(np.float32)
                s[g.random(C) < 0.1] = np.nan
                s[g.random(C) < 0.1] = FILL
                m = np.zeros(C, bool)
                if rest_live:
                    m[:] = g.random(C) < 0.5
                    s[m] = worse
                slots = (np.arange(len(p)) if placed == "start"
                         else g.permutation(C)[:len(p)])
                s[slots], m[slots] = p, True
                out_s.append(s)
                out_m.append(m)
    for live in (True, False):
        s = np.round(g.uniform(-1, 1, (8, C)), 2).astype(np.float32)
        out_s += list(s)
        out_m += [np.full(C, live)] * 8
    return np.stack(out_s), np.stack(out_m)


def random_rows(R: int, C: int, higher_better: bool, seed: int):
    """Rows as the callers make them: NCC in [-1, 1] (higher better) or
    descriptor distances in [0, 600] (lower better), rounded so that ties
    are common, each row with its own live share."""
    g = np.random.default_rng(seed)
    if higher_better:
        s = np.round(g.uniform(-1, 1, (R, C)), 2)
    else:
        s = np.round(g.uniform(0, 600, (R, C)), 0)
    m = g.random((R, C)) < g.random((R, 1))
    return s.astype(np.float32), m


def streak_reference(scores, mask, thresh: float, higher_better: bool,
                     live_only: bool = False):
    """The streak rule row by row: the slots sorted best first (stable;
    key = -s (higher better) or s on live slots, 3.4e38 on masked ones,
    -0.0 equal to +0.0, NaN last as the CPU sorts); rank 0 kept where it
    is live, then each following rank while it is live, best != 0 and its
    ratio (s / best or best / s, float32) >= thresh (float32); rows with
    fewer than 2 live slots kept as their mask. With `live_only` the masked
    slots take no part in the sort: the reference's rule
    (Stereo_Matches.cpp), which the twin's equals on every row whose live
    keys all lie below 3.4e38."""
    t = np.float32(thresh)
    out = np.zeros_like(mask)
    for r in range(scores.shape[0]):
        s, m = scores[r], mask[r]
        if m.sum() < 2:
            out[r] = m
            continue
        key = np.where(m, -s if higher_better else s, FILL)
        slots = np.flatnonzero(m) if live_only else range(len(s))
        order = sorted(slots, key=lambda j: (bool(np.isnan(key[j])),
                                             0.0 if np.isnan(key[j])
                                             else float(key[j]), j))
        best = s[order[0]]
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            for rank, j in enumerate(order):
                ratio = s[j] / best if higher_better else best / s[j]
                ok = m[j] and (rank == 0 or (best != 0 and ratio >= t))
                if not ok:
                    break
                out[r, j] = True
    return out
