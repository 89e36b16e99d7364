"""The frozen copy of the kernels' work counts gives chip_smoke.py's
(and so tests/test_torch_bounds.py's) numbers."""

import numpy as np
import pytest
import torch

import chip_smoke as C
from vo_bench.harness import kernels as KN
from vo_bench.harness import work as W


def test_literal_counts_of_test_torch_bounds():
    flops, nbytes = W.k1_work(2, 376, 1241)
    assert flops == 1_944_855_488 and nbytes == 63_459_776
    assert W.bound(flops, nbytes)["bound_ms"] * 1e3 == pytest.approx(
        29.0277, abs=1e-3)
    iters = np.array([0, 1, 2, 20])
    active = np.array([False, True, True, True])
    assert W.k2_work(iters, active, 7, 376, 1241) == (174_030, 7_466_060)
    assert W.k9_work(1000) == C.k9_work(1000)


@pytest.mark.parametrize("seed", range(4))
def test_copy_equals_chip_smoke(seed):
    rng = np.random.default_rng(seed)
    B = 257
    it = rng.integers(0, 21, B)
    act = rng.random(B) < 0.8
    for P in (3, 7, 11):
        assert W.k2_work(it, act, P, 376, 1241) == C.k2_work(
            it, act, P, 376, 1241)
        assert W.k3_work(it, act, P, 376, 1241) == C.k3_work(
            it, act, P, 376, 1241)
    mask = rng.random((64, 32)) < 0.3
    for orient in (False, True):
        assert W.k4_work(mask, orient, 10) == C.k4_work(mask, orient, 10)
    assert W.k5_work(65536, 256, 300, 376, 1241) == C.k5_work(
        65536, 256, 300, 376, 1241)
    live = torch.as_tensor(rng.random((64, 32)) < 0.4)
    idx = torch.as_tensor(rng.integers(0, 100, (64, 32)))
    surv = live & torch.as_tensor(rng.random((64, 32)) < 0.5)
    for kind in ("stereo", "temporal"):
        assert W.k6_work(kind, live, 49, idx, surv) == C.k6_work(
            kind, live, 49, idx, surv)
    assert W.k6_work("flat", live[:, 0], 49, idx[:, 0]) == C.k6_work(
        "flat", live[:, 0], 49, idx[:, 0])
    assert W.k7_work(500, 49, 376, 1241, live[:, 0]) == C.k7_work(
        500, 49, 376, 1241, live[:, 0])
    assert W.k8_work(5000, 1117, 4096, 4000, seed % 2 == 0) == C.k8_work(
        5000, 1117, 4096, 4000, seed % 2 == 0)
    assert (W.PEAK_FLOPS, W.PEAK_BYTES) == (C.PEAK_FLOPS, C.PEAK_BYTES)


def test_trace_names_map_to_the_kernels():
    assert KN.kernel_of("void epipolar_gn_kernel<4>(Params)") == "K2"
    assert KN.kernel_of("void (anonymous namespace)::gn_2dof_direct<7, 4>"
                        "((anonymous namespace)::K3Params)") == "K3"
    assert KN.kernel_of("dense_gates_prep_kernel<float>") == "K6"
    assert KN.kernel_of("interleave_kernel") is None
    assert KN.kernel_of("ncclDevKernel_AllReduce_Sum_f32") is None
