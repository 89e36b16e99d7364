"""The best/nearly-best streak filter (`stereo_matcher.bnb_keep`) on the
CPU: its plain twin `_bnb_keep`, which `csrc/bnb_keep.cu` reproduces bit
for bit on the card (tests/test_torch_cuda.py). No JAX here: the twin is
held against JAX in tests/test_torch_ops.py.

- the twin against a row-by-row loop of the streak rule
  (`bnb_cases.streak_reference`: sort best first, stable; keep rank 0
  and the following ranks while the ratio passes; rows with < 2 live
  slots left alone) on the hand-made rows of `tests/bnb_cases.py` (ties,
  a best of 0, -0.0 and +0.0, negative scores, NaN and +-inf, live keys
  at the fill, ratios one ulp either side of the threshold, 0, 1, 2 and
  all slots live) and on seeded rows, at the callers' thresholds, C = 32
  and 64; and against the reference's rule over the live slots alone on
  every row whose live keys lie below the fill;
- the kernel's steps (ranks by counting in radix order, best from rank 0,
  the first failing rank, the live count) modelled in numpy give the
  twin's output where the CPU and the card order the keys alike (no
  NaN key: NaNs of both signs and other payloads are the `gpu` tests');
- a CPU tensor takes the twin and launches nothing.
"""

import numpy as np
import pytest
import torch

from edge_based_visual_odometry_tpu_torch.models import stereo_matcher as SM
from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from tests import bnb_cases as BC
from tests.compact_cases import radix_bits


def kernel_model(scores, mask, thresh: float, higher_better: bool):
    """csrc/bnb_keep.cu's four steps on every row at once, in numpy."""
    R, C = scores.shape
    key = np.where(mask, -scores if higher_better else scores, BC.FILL)
    rb = radix_bits(key)
    j = np.arange(C)
    # 1. rank of slot j: the slots t with (key, t) < (key_j, j)
    before = ((rb[:, None, :] < rb[:, :, None])
              | ((rb[:, None, :] == rb[:, :, None]) & (j < j[:, None])))
    rank = before.sum(-1)
    assert (np.sort(rank, 1) == j).all(), "ranks are not a permutation"
    # 2. best: the score of rank 0
    best = scores[np.arange(R), np.argmax(rank == 0, 1)][:, None]
    # 3. the first failing rank, the live count
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        ratio = scores / best if higher_better else best / scores
    ok = np.where(rank == 0, mask,
                  (ratio >= np.float32(thresh)) & mask & (best != 0))
    first_fail = np.where(ok, C, rank).min(1, keepdims=True)
    n_live = mask.sum(1, keepdims=True)
    # 4. the kept slots
    return mask & ((n_live < 2) | (rank < first_fail))


def rows(C, thresh, higher_better, nans=True):
    s, m = BC.edge_rows(C, thresh, higher_better, seed=C, nans=nans)
    rs, rm = BC.random_rows(512, C, higher_better, seed=C + 1)
    return np.concatenate([s, rs]), np.concatenate([m, rm])


def twin(s, m, thresh, higher_better):
    return SM._bnb_keep(torch.from_numpy(s), torch.from_numpy(m), thresh,
                        higher_better).numpy()


@pytest.mark.parametrize("C", [32, 64])
@pytest.mark.parametrize("caller", sorted(BC.THRESHOLDS))
def test_twin_keeps_the_sorted_streak(caller, C):
    thresh, hb = BC.THRESHOLDS[caller]
    s, m = rows(C, thresh, hb)
    got = twin(s, m, thresh, hb)
    np.testing.assert_array_equal(got, BC.streak_reference(s, m, thresh, hb))
    key = np.where(m, -s if hb else s, 0)
    below = ~((np.isnan(key) | (key >= BC.FILL)) & m).any(1)
    assert below.sum() > 0.8 * len(below)
    np.testing.assert_array_equal(
        got[below], BC.streak_reference(s[below], m[below], thresh, hb,
                                        live_only=True))


@pytest.mark.parametrize("C", [1, 2, 8, 25, 32, 33, 40, 64])
@pytest.mark.parametrize("caller", sorted(BC.THRESHOLDS))
def test_kernel_model_equals_twin(caller, C):
    thresh, hb = BC.THRESHOLDS[caller]
    s, m = rows(C, thresh, hb, nans=False)
    np.testing.assert_array_equal(kernel_model(s, m, thresh, hb),
                                  twin(s, m, thresh, hb))


def test_edge_rows_hold_every_case():
    """The hand-made rows reach what they are made for: rows of 0, 1, 2
    and every slot live, a best tied, and a best of 0 among 2 or more live
    slots, which keeps rank 0 alone."""
    thresh, hb = BC.THRESHOLDS["stereo_ncc"]
    s, m = BC.edge_rows(32, thresh, hb)
    kept = twin(s, m, thresh, hb)
    n = m.sum(1)
    assert {0, 1, 2, 32} <= set(n.tolist())
    live = np.where(m, s, -np.inf)
    best = live.max(1, keepdims=True)
    assert ((live == best).sum(1) > 1).any()
    zero_best = (best[:, 0] == 0) & (n >= 2)
    assert zero_best.any() and (kept[zero_best].sum(1) == 1).all()


@pytest.mark.parametrize("caller", sorted(BC.THRESHOLDS))
def test_threshold_is_a_float32_compare(caller):
    """A ratio equal to the threshold rounded to float32 passes and one
    ulp below it fails (at 0.9 the float32 threshold lies below 0.9)."""
    thresh, hb = BC.THRESHOLDS[caller]
    t = np.float32(thresh)
    down = np.nextafter(t, np.float32(0))
    s = (np.array([[1, t], [1, down]], np.float32) if hb else
         np.array([[t, 1], [down, 1]], np.float32))
    got = twin(s, np.ones((2, 2), bool), thresh, hb)
    np.testing.assert_array_equal(got, [[True, True], [True, False]])


def test_cpu_tensor_takes_the_twin_and_kernel_wrapper_refuses_it(
        monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not build or launch a kernel")

    monkeypatch.setattr(CB, "lib", no_build)
    s, m = (torch.from_numpy(a) for a in BC.random_rows(64, 32, True, 3))
    before = dict(CB.LAUNCHES)
    for thresh, hb in BC.THRESHOLDS.values():
        got = SM.bnb_keep(s, m, thresh, hb)
        assert torch.equal(got, SM._bnb_keep(s, m, thresh, hb))
    assert CB.LAUNCHES == before
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        SM.bnb_keep_cuda(s, m, 0.9, True)
    with pytest.raises(ValueError, match="unsupported device"):
        SM.bnb_keep(s.to("meta"), m.to("meta"), 0.9, True)
