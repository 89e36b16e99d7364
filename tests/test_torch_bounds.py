"""The bound arithmetic chip_smoke.py reports beside each kernel's time:
work counted from the shapes (K1), from the iterations a launch ran
(K2, K3) and from the active slots (K4), and the least time the card
needs for it. chip_smoke.py imports
without CUDA; only its main() needs the card."""

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
