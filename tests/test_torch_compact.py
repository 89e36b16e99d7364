"""The contract of the gather windows' compaction
(`grid.compact_candidates_attrs`), held on the plain twin on the CPU:
what the CUDA kernel `csrc/compact_candidates.cu` reproduces bit for bit
on the card (tests/test_torch_cuda.py). No JAX here: the twin is held
against JAX in tests/test_torch_ops.py.

- each row's slots ordered by (key, slot), key = priority on live slots
  and 3.0e38 on masked ones (0 / 1 with no priority), the key in the
  order of its radix bits; the first min(C, S) slots kept with their idx,
  attributes and mask. Held against a numpy reference of that order
  (`np.lexsort`) at the callers' shapes: S = 32 (the dry run), 160
  (stereo), 195 (temporal) and 576 (the evaluation path), C = 8 and 32,
  A = 3 and 6;
- many ties, every slot masked, every slot live, more live slots than C,
  C > S, no priority; live keys at and past 3.0e38, +inf, +NaN and -0.0
  (which ties with +0.0);
- the kernel's passes (a live list of more than 64 cut to the C lowest
  by a radix select, ranked by counting, the masked slots ranked from
  the counts of pass 1, the early stops), modelled in numpy lane by
  lane, give the twin's outputs and write each output slot once;
- a CPU tensor takes the twin and launches nothing.

On the CPU the twin orders by comparison; the keys here (one NaN,
0x7fc00000) are ordered alike by comparison and by radix bits. NaNs of
other signs and payloads are the `gpu` tests'.
"""

import numpy as np
import pytest
import torch

from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.ops import grid as G
from tests.compact_cases import FILL, make_case, radix_bits


def keys_of(mask, priority):
    if priority is None:
        return (~mask).astype(np.float32)
    return np.where(mask, priority, FILL).astype(np.float32)


def reference(idx, attrs, mask, C, priority):
    """The contract in numpy: each row's order by (radix key, slot)."""
    Q, S = mask.shape
    key = radix_bits(keys_of(mask, priority))
    order = np.stack([np.lexsort((np.arange(S), key[q]))
                      for q in range(Q)])[:, :min(C, S)].reshape(Q, -1)
    rows = np.arange(Q)[:, None]
    return idx[rows, order], attrs[:, rows, order], mask[rows, order]


def keep_lowest(keys, slots, W):
    """The kernel's `keep_lowest`: a radix select of the W-th smallest key,
    8 bits a round, then the keys below it and the first of its ties."""
    want, prefix, high = W, 0, 0
    for shift in (24, 16, 8, 0):
        hist = np.zeros(256, int)
        for k in keys:
            if k & high == prefix:
                hist[(k >> shift) & 0xFF] += 1
        incl = np.cumsum(hist)
        digit = int(np.flatnonzero(incl >= want)[0])
        want -= int(incl[digit] - hist[digit])
        prefix |= digit << shift
        high |= 0xFF << shift
    kept, ties = [], 0
    for k, s in zip(keys, slots):
        if k < prefix or (k == prefix and ties < want):
            kept.append((k, s))
        ties += k == prefix
    assert len(kept) == W
    return [k for k, _ in kept], [s for _, s in kept]


def kernel_model(idx, attrs, mask, C, priority):
    """`compact_candidates_kernel`'s three passes for each row, 32 lanes
    at a time: the outputs, and how often each output slot was written."""
    Q, S = mask.shape
    W = min(C, S)
    A = attrs.shape[0]
    out = (np.zeros((Q, W), idx.dtype), np.zeros((A, Q, W), np.float32),
           np.zeros((Q, W), bool))
    writes = np.zeros((Q, W), int)
    has_pri = priority is not None
    fill = radix_bits(FILL if has_pri else np.float32(1.0))
    lanes = np.arange(32)

    def put(q, s, r, live):
        out[0][q, r] = idx[q, s]
        out[1][:, q, r] = attrs[:, q, s]
        out[2][q, r] = live
        writes[q, r] += 1

    for q in range(Q):
        m = mask[q]
        key = radix_bits(priority[q]) if has_pri else None
        keys, slots = [], []
        n = lo = eq = 0
        for c in range(0, S, 32):                       # pass 1
            s = c + lanes
            live = (s < S) & m[np.minimum(s, S - 1)]
            k = (key[np.minimum(s, S - 1)] if has_pri
                 else np.full(32, radix_bits(np.float32(0.0))))
            keys += list(k[live])
            slots += list(s[live])
            n += int(live.sum())
            lo += int((live & (k < fill)).sum())
            eq += int((live & (k == fill)).sum())
        if has_pri:                                     # passes 2, 3
            if lo > W and n > 64:
                keys, slots = keep_lowest(keys, slots, W)
            for e in range(len(keys)):
                r = (sum(keys[t] <= keys[e] for t in range(e))
                     + sum(keys[t] < keys[e] for t in range(e + 1,
                                                            len(keys))))
                if keys[e] > fill:
                    r += S - n
                elif keys[e] == fill:
                    r += slots[e] - e
                if r < W:
                    put(q, slots[e], r, True)
        else:
            before = 0
            for c in range(0, S, 32):
                if before >= W:
                    break
                s = c + lanes
                live = (s < S) & m[np.minimum(s, S - 1)]
                for j in np.flatnonzero(live):
                    r = before + int(live[:j].sum())
                    if r < W:
                        put(q, s[j], r, True)
                before += int(live.sum())
        if lo >= W:                                     # pass 3
            continue
        live_before = eq_before = 0
        for c in range(0, S, 32):
            s = c + lanes
            inside = s < S
            live = inside & m[np.minimum(s, S - 1)]
            at_fill = (live & (key[np.minimum(s, S - 1)] == fill)
                       if has_pri and eq > 0 else np.zeros(32, bool))
            for j in np.flatnonzero(inside & ~live):
                r = (s[j] - live_before - int(live[:j].sum()) + lo
                     + eq_before + int(at_fill[:j].sum()))
                if r < W:
                    put(q, s[j], r, False)
            live_before += int(live.sum())
            eq_before += int(at_fill.sum())
            if c + 32 - live_before + lo >= W:
                break
    return out, writes


def twin(case, C):
    idx, attrs, mask, pri = case
    return G.compact_candidates_plain(
        torch.from_numpy(idx), torch.from_numpy(attrs), torch.from_numpy(mask),
        C, None if pri is None else torch.from_numpy(pri))


def assert_equal(got, ref):
    """(idx, attrs, mask) equal, every slot, attributes bit for bit."""
    for a, b in zip(got, ref):
        a = a.numpy() if torch.is_tensor(a) else a
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("A", [3, 6])
@pytest.mark.parametrize("C", [8, 32])
@pytest.mark.parametrize("S", [32, 160, 195, 576])
def test_twin_matches_the_reference_order(S, C, A):
    case = make_case(48, S, A, seed=S * 7 + C + A)
    assert_equal(twin(case, C), reference(*case[:3], C, case[3]))


SPECIAL = {
    "many_ties": dict(priority="ties"),
    "all_masked": dict(live_p=0.0),
    "all_live": dict(live_p=1.0),
    "no_priority": dict(priority=None),
    "no_priority_all_live": dict(priority=None, live_p=1.0),
}


@pytest.mark.parametrize("name", sorted(SPECIAL))
@pytest.mark.parametrize("S", [32, 195])
def test_twin_on_special_rows(name, S):
    case = make_case(40, S, 3, seed=len(name) + S, **SPECIAL[name])
    got = twin(case, 32)
    assert_equal(got, reference(*case[:3], 32, case[3]))
    mask = case[2]
    n_live = np.minimum(mask.sum(1), 32)
    # live slots first, then the masked ones, in slot order
    expect = np.arange(min(32, S))[None, :] < n_live[:, None]
    np.testing.assert_array_equal(got[2].numpy(), expect)


def test_more_live_slots_than_capacity_keeps_the_lowest():
    """Rows of more than C live slots keep their C lowest priorities, in
    order (idx here is the slot, to find each kept one)."""
    _, attrs, mask, pri = make_case(64, 195, 6, seed=3, live_p=0.6)
    assert (mask.sum(1) > 32).all()
    idx = np.broadcast_to(np.arange(195), mask.shape).copy()
    got = twin((idx, attrs, mask, pri), 32)
    assert bool(got[2].all())
    for q in range(64):
        np.testing.assert_array_equal(pri[q][got[0][q].numpy()],
                                      np.sort(pri[q][mask[q]])[:32])
    assert_equal(got, reference(idx, attrs, mask, 32, pri))


@pytest.mark.parametrize("C", [200, 576])
def test_capacity_past_the_slots_keeps_every_slot(C):
    case = make_case(16, 160, 3, seed=C)
    got = twin(case, C)
    assert got[0].shape == (16, 160) and got[1].shape == (3, 16, 160)
    assert_equal(got, reference(*case[:3], C, case[3]))


@pytest.mark.parametrize("S", [32, 160, 576])
def test_twin_orders_special_keys_as_the_radix_bits(S):
    """+inf, +NaN, -0.0 beside +0.0, 3.0e38 and past it, on a quarter of
    the slots."""
    case = make_case(48, S, 6, seed=S + 1, priority="special")
    assert_equal(twin(case, 32), reference(*case[:3], 32, case[3]))


def test_live_keys_at_and_past_the_fill():
    """Live keys equal to 3.0e38 interleave with the masked slots by slot;
    larger ones and +inf come after every masked slot."""
    idx, attrs, mask, pri = make_case(32, 160, 3, seed=11)
    g = np.random.default_rng(12)
    for v in (FILL, np.float32(3.2e38), np.float32(np.inf)):
        pick = mask & (g.random(mask.shape) < 0.3)
        pri = np.where(pick, v, pri).astype(np.float32)
    assert_equal(twin((idx, attrs, mask, pri), 160),
                 reference(idx, attrs, mask, 160, pri))


MODEL_CASES = {
    "stereo": (160, 32, 3, {}),
    "temporal": (195, 32, 6, {}),
    "evaluation": (576, 32, 6, {}),
    "dry_run": (32, 8, 3, {}),
    "ties": (195, 32, 6, dict(priority="ties")),
    "no_priority": (160, 32, 3, dict(priority=None)),
    "all_masked": (160, 32, 3, dict(live_p=0.0)),
    "wide": (160, 200, 3, {}),
    "special": (195, 32, 6, dict(priority="special")),
    "dense": (576, 32, 6, dict(live_p=0.8, priority="ties")),
    "half_head": (160, 160, 3, dict(live_p=0.9)),
    "half_tail": (160, 120, 3, dict(live_p=0.9)),
}


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_kernel_model_matches_twin(name):
    S, C, A, kw = MODEL_CASES[name]
    case = make_case(24, S, A, seed=len(name), **kw)
    if name == "ties":          # live keys at and past the fill too
        idx, attrs, mask, pri = case
        g = np.random.default_rng(5)
        for v in (FILL, np.float32(np.inf)):
            pri = np.where(mask & (g.random(mask.shape) < 0.2), v, pri)
        case = (idx, attrs, mask, pri.astype(np.float32))
    if name.startswith("half_"):  # the live slots in one half of the row
        idx, attrs, mask, pri = case
        half = np.arange(S) < S // 2
        mask = mask & (half if name == "half_head" else ~half)
        case = (idx, attrs, mask, pri)
    out, writes = kernel_model(*case[:3], C, case[3])
    assert (writes == 1).all()
    assert_equal(out, tuple(t.numpy() for t in twin(case, C)))


def test_cpu_tensor_takes_the_twin_and_kernel_wrapper_refuses_it(
        monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not build or launch a kernel")

    monkeypatch.setattr(CB, "lib", no_build)
    idx, attrs, mask, pri = (torch.from_numpy(a)
                             for a in make_case(16, 160, 3, seed=1))
    before = dict(CB.LAUNCHES)
    got = G.compact_candidates_attrs(idx, attrs, mask, 32, priority=pri)
    assert CB.LAUNCHES == before
    for a, b in zip(got, G.compact_candidates_plain(idx, attrs, mask, 32,
                                                    pri)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        G.compact_candidates_cuda(idx, attrs, mask, 32, pri)
