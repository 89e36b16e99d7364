"""K4's shortcuts modelled on the CPU and held bit for bit against the
plain twin `cluster_edges_plain` (no JAX here; the twin is held against
JAX in tests/test_torch_ops.py, and K4 against the twin on the card in
tests/test_torch_cuda.py). The model does what csrc/cluster_edges.cu
does where it leaves the twin's form:
  - the cap's ranks only on rows where a label group exceeds the cap; on
    the others every member is kept and takes its group's least index;
  - every sum over the active slots only, started at the zero that the
    masked slots' terms fold to, on rows where each value is finite and
    |x|, |y| <= 2^62; over all slots on the others;
  - on those bounded rows, each slot's distance, weight and weighted
    values formed once, for its own group, and added with a 0/1 weight.
"""

import math

import numpy as np
import pytest
import torch

from edge_based_visual_odometry_tpu_torch.ops import clustering as CL
from tests import cluster_cases as CC

BIG = 2.0 ** 62        # K4's kBig


def _fold(terms, S, z):
    """K4's sum: terms[n, r, k] over the slots k of S[n] in ascending
    order, started at z (n, 1)."""
    acc = z.expand(terms.shape[:2]).clone()
    for k in range(terms.shape[-1]):
        acc = torch.where(S[:, k, None], acc + terms[..., k], acc)
    return acc


def _k4_model(x, y, theta, mask, dist_thresh, orient_thresh_deg,
              by_orientation, gauss_sigma, max_cluster_size):
    N, C = x.shape
    thresh, orient_rad, inv_sigma = CL._scalars(dist_thresh,
                                                orient_thresh_deg, gauss_sigma)
    iota = torch.arange(C)
    lab = CL._labels(x, y, theta, mask, thresh, orient_rad, by_orientation, 0)

    def own(v):                    # v[n, lab] of each slot's own group
        return torch.gather(v, 1, lab.clamp(max=C - 1))

    cap = max_cluster_size
    if cap and cap < C:
        M0 = (lab[:, None, :] == iota[:, None]) & mask[:, None, :]
        fits = M0.sum(-1).max(-1).values <= cap
        least = torch.where(M0, iota, C).min(-1).values
        capped = CL._labels(x, y, theta, mask, thresh, orient_rad,
                            by_orientation, cap)
        lab = torch.where(fits[:, None], torch.where(mask, own(least), C),
                          capped)

    M = (lab[:, None, :] == iota[:, None]) & mask[:, None, :]
    Mf = M.to(x.dtype)
    ok = ((x.abs() <= BIG) & (y.abs() <= BIG) & theta.isfinite()).all(1)
    ok &= math.isfinite(inv_sigma)
    S = torch.where(ok[:, None], mask, torch.ones_like(mask))

    def zero(v):                   # the masked slots' terms folded
        neg = (~S & ~v.signbit()).any(1, keepdim=True)
        return torch.where(neg, 0.0, -0.0)

    zp = torch.where((~S).any(1, keepdim=True), 0.0, -0.0)
    safe = torch.clamp(Mf.sum(-1), min=1.0)
    cx = _fold(Mf * x[:, None, :], S, zero(x)) / safe
    cy = _fold(Mf * y[:, None, :], S, zero(y)) / safe

    def pick(fast, slow):
        return torch.where(ok[:, None, None], fast, slow)

    ddx, ddy = x[:, None, :] - cx[:, :, None], y[:, None, :] - cy[:, :, None]
    d_rk = torch.sqrt(ddx * ddx + ddy * ddy)
    dox, doy = x - own(cx), y - own(cy)
    d_own = torch.sqrt(dox * dox + doy * doy)
    mean = _fold(Mf * pick(d_own[:, None, :].expand(N, C, C), d_rk), S,
                 zp) / safe
    z_rk = (d_rk - mean[:, :, None]) * inv_sigma
    w_rk = torch.exp(-0.5 * (z_rk * z_rk)) * Mf
    z_own = (d_own - own(mean)) * inv_sigma
    w_own = torch.exp(-0.5 * (z_own * z_own))
    sw = torch.clamp(_fold(pick(Mf * w_own[:, None, :], w_rk), S, zp),
                     min=1e-12)
    g = [_fold(pick(Mf * (w_own * v)[:, None, :], w_rk * v[:, None, :]), S,
               zero(v)) / sw for v in (x, y, theta)]
    rep = (lab == iota) & mask
    zeros = torch.zeros_like(x)
    return CL.ClusterResult(*(torch.where(rep, v, zeros) for v in g),
                            mask=rep, label=lab, members=M)


def _same(a, b):
    for u, v in zip(a, b):
        assert u.shape == v.shape and u.dtype == v.dtype
        if u.is_floating_point():
            same = ((u.view(torch.int32) == v.view(torch.int32))
                    | (u.isnan() & v.isnan()))
            assert bool(same.all()), int((~same).sum())
        else:
            assert torch.equal(u, v)


@pytest.mark.parametrize("name", CC.CASES)
@pytest.mark.parametrize("N,C", [(256, 32), (48, 64)])
def test_k4_model_equals_the_twin(name, N, C):
    x, y, th, mask, kw = CC.case(name, N, C, seed=CC.CASES.index(name))
    args = [torch.from_numpy(a) for a in (x, y, th, mask)]
    _same(_k4_model(*args, **kw), CL.cluster_edges_plain(*args, **kw))


def test_k4_model_takes_both_forms_and_both_zeros():
    """The cases reach every branch the model (and K4) has: rows whose
    groups all fit the cap and rows with a larger group, rows on the
    active-slot sums and rows on every slot's, and the -0 that the
    masked slots' signs decide."""
    x, y, th, mask, kw = CC.case("nonfinite_masked", 64, 32)
    ok = (np.isfinite(x) & np.isfinite(y) & np.isfinite(th)).all(1)
    assert ok.any() and not ok.all()
    x, y, th, mask, kw = CC.case("long_chains", 64, 32)
    lab = CL._labels(*(torch.from_numpy(a) for a in (x, y, th, mask)),
                     *CL._scalars(1.0, 20.0, 2.0)[:2], False, 0)
    most = torch.stack([torch.bincount(r, minlength=33)[:32].max()
                        for r in lab])
    assert bool((most > kw["max_cluster_size"]).any())
    assert bool((most <= kw["max_cluster_size"]).any())
    x, y, th, mask, kw = CC.case("signed_zeros", 64, 32)
    out = CL.cluster_edges_plain(*(torch.from_numpy(a)
                                   for a in (x, y, th, mask)), **kw)
    zero = out.mask & (out.x == 0)
    assert bool((zero & out.x.signbit()).any())
    assert bool((zero & ~out.x.signbit()).any())


def test_k4_model_relabels_groups_that_fit_the_cap():
    """A cap of 24 that every chain of `long_chains` fits: no rank is
    formed, but where the label rounds stopped short a group can lack the
    slot its label names, and the relabel to the group's least index
    still moves its labels (4 of these 4,096 rows)."""
    x, y, th, mask, kw = CC.case("long_chains", 4096, 32, seed=1)
    kw["max_cluster_size"] = 24
    args = [torch.from_numpy(a) for a in (x, y, th, mask)]
    lab = CL._labels(*args, *CL._scalars(1.0, 20.0, 2.0)[:2], False, 0)
    named = torch.gather(lab, 1, lab.clamp(max=31))
    assert int(((named != lab) & args[3]).any(1).sum()) == 4
    _same(_k4_model(*args, **kw), CL.cluster_edges_plain(*args, **kw))
