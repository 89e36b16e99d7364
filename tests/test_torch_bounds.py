"""The bound arithmetic chip_smoke.py reports beside each kernel's time:
work counted from the shapes (K1, K5, K7), from the iterations a launch
ran (K2, K3) and from the active or live slots (K4, K6), and the least
time the card needs for it. The counts are the benchmark's
(`vo_bench/harness/work.py`), which chip_smoke.py re-exports; these cases
are their one copy. chip_smoke.py imports without CUDA; only its main()
needs the card."""

import numpy as np
import pytest
import torch

import chip_smoke as C


def test_k1_work_at_production_shape():
    """Both 376 x 1241 images: 933,232 low-res pixels x (2 x 912 FMA flops
    + 4 x 65 epilogue flops); 4 bytes in and 16 x 4 bytes out per pixel
    (the numbers in PERF.md)."""
    flops, nbytes = C.k1_work(2, 376, 1241)
    assert flops == 933_232 * 2_084 == 1_944_855_488
    assert nbytes == 3_732_928 + 59_726_848 == 63_459_776
    b = C.bound(flops, nbytes)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] * 1e3 == pytest.approx(29.0277, abs=1e-3)


@pytest.mark.parametrize("it0", [0, 2])
def test_k2_work_from_hand_made_iters(it0):
    """Four lanes, one inactive; 0 + 1 + 2 + 20 iterations run in the
    launch. P = 7: 98 samples, 39 flops each for the left patch once per
    active lane, 98 x 72 + 12 flops per iteration. Bytes: the four
    376 x 1241 maps once, 33 bytes in and 18 out per lane. The launch's
    first iteration does not change the count: only iterations run."""
    iters_run = np.array([0, 1, 2, 20])
    active = np.array([False, True, True, True])
    flops, nbytes = C.k2_work(iters_run, active, 7, 376, 1241)
    assert flops == 3 * 98 * 39 + 23 * (98 * 72 + 12) == 174_030
    assert nbytes == 4 * 376 * 1241 * 4 + 4 * (33 + 18) == 7_466_060
    # few iterations over full-size maps: the bytes set the bound
    assert C.bound(flops, nbytes)["bound_by"] == "bytes"


def test_k2_work_at_production_scale_is_flop_bound():
    """Frame 0's one 20-iteration launch ran 1,199,441 lane-iterations over
    117,528 active of 131,072 lanes: ~8.9 GFLOP against ~14 MB."""
    B, n_act = 131_072, 117_528
    iters_run = np.zeros(B, np.int64)
    iters_run[:n_act] = 10
    iters_run[:1_199_441 - 10 * n_act] += 1
    assert int(iters_run.sum()) == 1_199_441
    flops, nbytes = C.k2_work(iters_run, np.arange(B) < n_act, 7, 376, 1241)
    assert flops == n_act * 98 * 39 + 1_199_441 * 7_068 == 8_926_841_004
    assert nbytes == 7_465_856 + B * 51 == 14_150_528
    b = C.bound(flops, nbytes)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] * 1e3 == pytest.approx(133.236, abs=1e-2)
    # K2 rounds every multiply and add on its own (no FMA): half the rate
    nf = C.with_bound(1.0, flops, nbytes, fma_free=True)
    assert nf["bound_ms_no_fma"] == pytest.approx(2 * b["bound_ms"])
    assert nf["pct_of_bound_no_fma"] == pytest.approx(2 * nf["pct_of_bound"])


def test_k3_work_from_hand_made_iters():
    """K3, five lanes, two inactive; 0 + 3 + 20 iterations run in the
    launch. P = 7: 98 samples, 47 flops each once per active lane (the KF
    sample and the CF offsets), 98 x 75 + 28 flops per iteration. Bytes:
    the four 376 x 1241 maps once, 33 bytes in and 22 out per lane."""
    iters_run = np.array([0, 3, 0, 20, 0])
    active = np.array([False, True, True, True, False])
    flops, nbytes = C.k3_work(iters_run, active, 7, 376, 1241)
    assert flops == 3 * 98 * 47 + 23 * (98 * 75 + 28) == 183_512
    assert nbytes == 4 * 376 * 1241 * 4 + 5 * (33 + 22) == 7_466_131
    assert C.bound(flops, nbytes)["bound_by"] == "bytes"


def test_k3_work_at_production_scale_is_flop_bound():
    """One side's 20-iteration launch over 131,072 lanes, 100,000 active,
    8 iterations each: ~6.4 GFLOP against ~14.7 MB."""
    B, n_act = 131_072, 100_000
    iters_run = np.where(np.arange(B) < n_act, 8, 0)
    flops, nbytes = C.k3_work(iters_run, np.arange(B) < n_act, 7, 376, 1241)
    assert flops == n_act * 98 * 47 + 800_000 * (98 * 75 + 28) == 6_363_000_000
    assert nbytes == 7_465_856 + B * 55 == 14_674_816
    b = C.bound(flops, nbytes)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] * 1e3 == pytest.approx(94.970, abs=1e-2)


def test_k4_work_from_a_hand_made_shape():
    """Two rows of 4 slots, 3 and 1 of them active, cap 10 >= C (no cap),
    no orientation gate: 3^2 + 1^2 = 10 pairs of active slots x (6 + 25)
    flops, 4 active slots x 6 divisions; 34 bytes a slot and one
    membership byte a pair of slots, active or not."""
    m = np.array([[1, 1, 0, 1], [0, 0, 1, 0]], bool)
    assert C.k4_work(m, False, 10) == (10 * 31 + 4 * 6, 8 * 34 + 32)
    # the gate adds 1 flop a pair; the cap 4 a pair and 8 a slot
    assert C.k4_work(m, True, 3) == (10 * 36 + 4 * 14, 8 * 34 + 32)
    assert C.k4_work(torch.from_numpy(m), True, 3) == C.k4_work(m, True, 3)
    assert C.k4_work(np.zeros((0, 32), bool), True, 10) == (0, 0)


@pytest.mark.parametrize("N,orient,flops,nbytes,us", [
    (32_768, False, 21_676_032, 69_206_016, 20.6585),    # stereo call
    (24_576, True, 16_687_104, 51_904_512, 15.4939)])    # temporal call
def test_k4_work_at_production_shape(N, orient, flops, nbytes, us):
    """`VOConfig()`: 32 slots a row, cap 10, row r holding r % 8 active
    slots (3.5 a row, as on the main path's frame). 13 bytes in and 21
    out a slot and a 1 KiB membership matrix a row: bytes bound both
    calls, the active pairs' flops take under 2% of their time."""
    mask = np.arange(32)[None, :] < (np.arange(N) % 8)[:, None]
    pairs, active = N // 8 * 140, N // 8 * 28
    assert C.k4_work(mask, orient, 10) == (flops, nbytes)
    assert flops == pairs * (35 + orient) + active * 14
    b = C.bound(flops, nbytes)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] * 1e3 == pytest.approx(us, abs=1e-3)
    assert flops / C.PEAK_FLOPS < 0.02 * nbytes / C.PEAK_BYTES


def test_bound_takes_the_larger_time():
    b = C.bound(67e9, 3.35e9)          # 1 ms of flops, 1 ms of bytes
    assert b["bound_ms"] == pytest.approx(1.0)
    assert C.bound(1e9, 3.35e10)["bound_by"] == "bytes"
    assert C.bound(67e10, 1e6)["bound_ms"] == pytest.approx(10.0)


def test_k5_work_from_a_hand_made_shape():
    """Two keypoints of 4 samples, 6 nonzero spatial weights, 10 x 20 maps:
    77 flops a sample (the circular hat at the 2 bins it can touch), 4 a
    nonzero weight (a multiply and an add for each of those 2 bins), 898 a
    keypoint (two norms, two divisions and the scaling of 128 bins).
    Bytes: both maps once, 20 in and 256 out a keypoint, 3 tables of 4
    floats, 8 bytes a nonzero weight."""
    flops, nbytes = C.k5_work(2, 4, 6, 10, 20)
    assert flops == 2 * (4 * 77 + 6 * 4 + 898) == 2_460
    assert nbytes == 2 * 200 * 4 + 2 * 276 + 48 + 48 == 2_248
    assert C.k5_work(0, 256, 784, 376, 1241)[0] == 0


@pytest.mark.parametrize("K,flops,nbytes,us", [
    (65_536, 1_556_217_856, 21_830_208, 23.2271),       # left / right edges
    (49_152, 1_167_163_392, 17_308_224, 17.4203),       # final mates
    (180_224, 4_279_599_104, 53_484_096, 63.8746)])     # a step, maps once
def test_k5_work_at_production_shape(K, flops, nbytes, us):
    """`VOConfig()`: 16 x 16 samples, 784 nonzero spatial weights at
    spacing 0.66 (the CPU's table; the run counts the card's), 376 x 1241
    maps. Operations bound every call, by 3-4x over the bytes: the
    samples' arithmetic, not the 256 bytes of bf16 a keypoint writes."""
    assert C.k5_work(K, 256, 784, 376, 1241) == (flops, nbytes)
    b = C.bound(flops, nbytes)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] * 1e3 == pytest.approx(us, abs=1e-3)
    assert flops / C.PEAK_FLOPS > 3 * nbytes / C.PEAK_BYTES


def test_k6_work_from_hand_made_masks():
    """P = 7 (49 samples a side: 195 flops to centre one, 400 for an NCC's
    4 pairings), a pair's distance 1,033 flops and a descriptor's |a|^2
    510, formed once a descriptor. Stereo, two rows of 4 slots over a
    5-row right table: one row with 3 live slots reading 2 distinct right
    rows (0 and 2), 2 of those slots past the descriptor gate (rows 0 and
    2 again); 512 bytes a descriptor, 394 a row's patches and flags, 8 an
    index of a live slot; the mask (1 byte) and the 2 outputs (8 bytes)
    of all 8 slots. Temporal, the same mask and indices into 5 CF rows:
    both sides of each, a CF row 1,420 bytes (both descriptors, bf16
    patches, 4 flags), 4 outputs a slot. Flat, 3 pairs, 2 live, both
    reading left row 0: its patches centred once, each entry's right
    patches once."""
    m = np.array([[1, 1, 0, 1], [0, 0, 0, 0]], bool)
    surv = np.array([[1, 0, 0, 1], [0, 0, 0, 0]], bool)
    idx = np.array([[0, 2, 4, 2], [1, 3, 0, 4]])
    assert C.k6_work("stereo", m, 49, idx, surv) == (
        (1 + 2) * 510 + 3 * 1033 + (1 + 2) * 2 * 195 + 2 * 400,
        8 * 9 + 3 * 8 + (1 + 2) * 512 + (1 + 2) * 394) == (6599, 2814)
    assert C.k6_work("temporal", m, 49, idx) == (
        (1 + 2) * 2 * (510 + 2 * 195) + 3 * 2 * (1033 + 400),
        8 * 17 + 3 * 8 + 2 * (512 + 394) + 2 * (1024 + 392 + 4)) == (
            13998, 4812)
    assert C.k6_work("flat", np.array([1, 0, 1], bool), 49,
                     np.array([0, 1, 0])) == (
        2 * 195 + 2 * (2 * 195 + 400), 3 * 5 + 2 * (8 + 394) + 394) == (
            1970, 1213)
    assert C.k6_work("stereo", torch.from_numpy(m), 49, torch.from_numpy(idx),
                     torch.from_numpy(surv)) == (6599, 2814)


def test_k6_work_counts_a_candidate_row_once():
    """A second live slot of a row that reads the same right row as the
    first adds only its pair's distance, NCC and index; one that reads
    another row adds that row's |b|^2, centring and bytes too."""
    one = np.array([[1, 0]], bool)
    both = np.array([[1, 1]], bool)
    w1 = C.k6_work("stereo", one, 49, np.array([[0, 0]]), one)
    same = C.k6_work("stereo", both, 49, np.array([[0, 0]]), both)
    other = C.k6_work("stereo", both, 49, np.array([[0, 1]]), both)
    assert (same[0] - w1[0], same[1] - w1[1]) == (1033 + 400, 8)
    assert (other[0] - same[0], other[1] - same[1]) == (510 + 2 * 195,
                                                        512 + 394)


@pytest.mark.parametrize("kind,N,flops,nbytes,us,by", [
    ("stereo", 32_768, 1_561_591_808, 77_201_408, 23.3073, "operations"),
    ("temporal", 24_576, 2_342_387_712, 99_090_432, 34.9610, "operations"),
    ("flat", 131_072, 116_326_400, 66_256_896, 19.7782, "bytes")])
def test_k6_work_at_production_shape_every_slot_live(kind, N, flops, nbytes,
                                                     us, by):
    """`VOConfig()` with every slot live (and past the descriptor gate)
    and every table row read: the most a call can need, ~1.6 GFLOP and
    ~77 MB for the stereo call, whose operations and bytes then take
    about as long (23.3 and 23.0 us). The main path's calls have a few
    live slots a row and read part of the tables."""
    live = np.ones((N, 32) if kind != "flat" else (N,), bool)
    n_table = 32_768 if kind != "temporal" else 24_576
    idx = ((np.arange(N)[:, None] + np.arange(32)) % n_table
           if kind != "flat" else np.arange(N) % n_table)
    args = (kind, live, 49, idx)
    w = C.k6_work(*args, live) if kind == "stereo" else C.k6_work(*args)
    assert w == (flops, nbytes)
    b = C.bound(*w)
    assert b["bound_by"] == by
    assert b["bound_ms"] * 1e3 == pytest.approx(us, abs=1e-3)


def test_k7_work_from_a_hand_made_shape():
    """Three edges of 2 x 49 samples on a 10 x 20 image: 33 flops a sample
    and 14 an edge; the image once, 12 bytes in and 394 out an edge."""
    assert C.k7_work(3, 49, 10, 20) == (3 * (98 * 33 + 14),
                                        800 + 3 * 406) == (9744, 2018)
    assert C.k7_work(0, 49, 376, 1241) == (0, 376 * 1241 * 4)


def test_k7_work_counts_live_edges_only():
    """With a live mask (stage 11's list), the dead edges are neither
    sampled nor written: the work of the live edges, plus the mask's one
    byte an entry; a mask with every entry live costs only those bytes."""
    live = np.array([1, 1, 0, 0, 0], bool)
    assert C.k7_work(5, 49, 10, 20, live) == (2 * (98 * 33 + 14),
                                              800 + 2 * 406 + 5)
    assert C.k7_work(5, 49, 10, 20, torch.from_numpy(live)) == (6496, 1617)
    full = C.k7_work(3, 49, 10, 20, np.ones(3, bool))
    assert full == (9744, 2018 + 3)
    # stage 11 of frame 2 at 376 x 1241: 37,576 live of 131,072 entries
    live = np.arange(131_072) < 37_576
    w = C.k7_work(131_072, 49, 376, 1241, live)
    assert w == (37_576 * (98 * 33 + 14),
                 376 * 1241 * 4 + 37_576 * 406 + 131_072)
    assert C.bound(*w)["bound_by"] == "bytes"


@pytest.mark.parametrize("B,flops,nbytes,us", [
    (32_768, 106_430_464, 15_170_272, 4.5284),     # left / right edges
    (131_072, 425_721_856, 55_081_696, 16.4423),   # stage-11 centres
    (24_576, 79_822_848, 11_844_320, 3.5356)])     # final mates
def test_k7_work_at_production_shape(B, flops, nbytes, us):
    """`VOConfig()` at 376 x 1241: bytes bound every call, the patches it
    writes; a stereo step's four calls write ~87 MB."""
    w = C.k7_work(B, 49, 376, 1241)
    assert w == (flops, nbytes)
    b = C.bound(*w)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] * 1e3 == pytest.approx(us, abs=1e-3)


def test_k8_work_from_a_hand_made_shape():
    """3 hypotheses, 2 gated in, over 5 quads of which 4 are valid: 26
    flops a (gated, valid) pair; 53 bytes a hypothesis (61 with its
    index) and 21 a quad."""
    assert C.K8_PAIR_FLOPS == 26
    flops, nbytes = C.k8_work(3, 2, 5, 4)
    assert flops == 2 * 4 * 26 == 208
    assert nbytes == 3 * 53 + 5 * 21 == 264
    assert C.k8_work(3, 2, 5, 4, indexed=True)[1] == 3 * 61 + 5 * 21


@pytest.mark.parametrize("n_out,Q,indexed,flops,nbytes,us", [
    (5000, 4096, False, 532_480_000, 351_016, 15.895),
    (256, 32768, True, 218_103_808, 703_744, 6.511)])
def test_k8_work_at_production_shape(n_out, Q, indexed, flops, nbytes, us):
    """VOConfig()'s prescore (5,000 hypotheses x 4,096 quads) and full
    count (256 kept x 32,768 quads), every hypothesis gated in and every
    quad valid: operations bound, at the FMA-free rate."""
    f, b = C.k8_work(n_out, n_out, Q, Q, indexed)
    assert (f, b) == (flops, nbytes)
    w = C.with_bound(1.0, f, b, fma_free=True)
    assert w["bound_by"] == "operations"
    assert w["bound_ms_no_fma"] * 1e3 == pytest.approx(us, abs=1e-3)


def test_k9_work():
    """173 flops and 21 bytes a quad, b's 6 negations and 196 bytes of
    R, t, K and the 28 sums once; at 32,768 quads under 0.2 us either
    way."""
    assert C.K9_QUAD_FLOPS == 173
    assert C.k9_work(0) == (6, 196)
    flops, nbytes = C.k9_work(32768)
    assert flops == 32768 * 173 + 6 == 5_668_870
    assert nbytes == 32768 * 21 + 196 == 688_324
    b = C.bound(flops, nbytes)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] * 1e3 == pytest.approx(0.2055, abs=1e-3)
    nf = C.with_bound(1.0, flops, nbytes, fma_free=True)
    assert nf["bound_ms_no_fma"] * 1e3 == pytest.approx(0.2055, abs=1e-3)
