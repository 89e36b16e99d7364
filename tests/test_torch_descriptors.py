"""The port's edge descriptor (`ops/descriptors.py`) on the CPU: the plain
twin of K5 against the JAX package's `edge_descriptors_tiled` on the
seeded cases of `tests/descriptor_cases.py`, the order of its sums (the
one K5 follows on the card), and its dispatch. K5 itself runs in
`tests/test_torch_cuda.py` (marker `gpu`).

bf16 outputs agree within 1 bf16 ulp of max(|a|, |b|, 1): the twin sums
in K5's order, JAX in XLA's."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from edge_based_visual_odometry_tpu.ops import descriptors as JD
from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.ops import descriptors as D
from tests import descriptor_cases as DC

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _bf16_ulp_close(a, b):
    """`tests/test_torch_ops.py`'s tolerance, NaN where both are NaN."""
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    np.testing.assert_array_equal(nan_a, nan_b)
    a, b = a[~nan_a], b[~nan_b]
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(a - b) <= ulp)


def _twin(name, N):
    maps, edges, kw = DC.case(name, N)
    return D.edge_descriptors(*(torch.from_numpy(a) for a in maps + edges),
                              **kw)


@pytest.mark.parametrize("name", DC.CASES)
def test_twin_matches_jax(name):
    """The twin against `edge_descriptors_tiled` on 64 edges (128
    keypoints) of each case."""
    maps, edges, kw = DC.case(name, 64)
    out = _twin(name, 64)
    ref = JD.edge_descriptors_tiled(*(jnp.asarray(a) for a in maps + edges),
                                    **kw)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape == (64, 256)
    out, ref = out.float().numpy(), np.asarray(ref, np.float32)
    _bf16_ulp_close(out, ref)
    if name == "flat_windows":
        assert np.all(out == 0)
    elif name == "nonfinite":
        assert np.isnan(out).any(1).sum() > 0
    else:
        assert np.isfinite(out).all() and np.all(np.abs(out).max(1) > 0)


def test_bin_edge_at_eight_takes_bin_zero():
    """theta 1e-8 under a gradient of angle 0: ob rounds to 8.0, and the
    circular hat gives bin 0 the weight 1, as theta 0 does (one gradient
    everywhere, so every row sees the same samples)."""
    out = _twin("bin_edges", 38).view(torch.int16)
    k = np.arange(38) % 19
    zero, tiny = out[k == 8], out[k == 17]
    assert torch.equal(zero, tiny)
    assert torch.equal(zero, zero[:1].expand_as(zero))


def test_chunking_never_changes_results():
    """Keypoint chunks of 24 (a chunk boundary inside the plus half and at
    N) against one chunk: bit-equal."""
    maps, edges, kw = DC.case("interior", 60)
    args = [torch.from_numpy(a) for a in maps + edges]
    a = D.edge_descriptors_plain(*args, chunk=24, **kw)
    b = D.edge_descriptors_plain(*args, chunk=4096, **kw)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_cell_lists_hold_the_nonzero_weights_in_ascending_order():
    """Each cell's list is the samples whose weight is not 0 in the table
    as computed (1e-14 counts), ascending, padded with sample 0 at weight
    0; term j of the 16 lists side by side. At VOConfig's spacing 0.66 on
    the CPU: 25 to 64 samples a cell, 784 in all, at most 4 cells a
    sample."""
    _, _, _, SP = D._static_tables(16, 4, 0.66, CPU)
    idx, w = (t.t() for t in D._cell_lists(16, 4, 0.66, CPU))
    assert idx.dtype == torch.int32 and idx.shape == (16, 64)
    nz = SP != 0
    assert nz.sum(0).min() == 25 and nz.sum(0).max() == 64
    assert int(nz.sum()) == 784 and int(nz.sum(1).max()) == 4
    for p in range(16):
        s = torch.nonzero(nz[:, p])[:, 0]
        n = s.numel()
        assert torch.equal(idx[p, :n].long(), s)
        assert torch.equal(w[p, :n], SP[s, p])
        assert bool((idx[p, n:] == 0).all() and (w[p, n:] == 0).all())


def test_histogram_equals_the_dense_sum_in_ascending_samples():
    """Skipping the weights that are exactly 0 leaves a float sum of finite
    terms unchanged: the twin's bins equal, bit for bit, the sum over all
    256 samples in ascending order of SP[s, p] * T[s, o] (the einsum's
    terms, one after another)."""
    g = np.random.default_rng(4)
    T = torch.from_numpy(g.random((5, 256, 8)).astype(np.float32) * 300)
    _, _, _, SP = D._static_tables(16, 4, 0.66, CPU)
    idx, w = D._cell_lists(16, 4, 0.66, CPU)
    twin = torch.zeros(5, 16, 8)
    for j in range(idx.shape[0]):
        twin = twin + w[j, :, None] * T[:, idx[j].long()]
    dense = torch.zeros(5, 16, 8)
    for s in range(256):
        dense = dense + SP[s][None, :, None] * T[:, s, None, :]
    assert torch.equal(twin, dense)


@pytest.mark.parametrize("n_bins", [128, 72, 256])
def test_warp_norm_is_the_lane_order(n_bins):
    """Lane l's q = ceil(n_bins / 32) squares in order (K5's 4 at 128 bins;
    72 bins padded to 96 with zeros), then the butterfly over 32 lanes."""
    d = torch.from_numpy(np.random.default_rng(5).random((3, n_bins))
                         .astype(np.float32) * 50)
    q = -(-n_bins // 32)
    sq = torch.nn.functional.pad(d * d, (0, 32 * q - n_bins)).reshape(3, 32, q)
    lanes = sq[..., 0]
    for i in range(1, q):
        lanes = lanes + sq[..., i]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes[:, :o] + lanes[:, o:2 * o]
    assert torch.equal(D._warp_norm(d)[:, 0], torch.sqrt(lanes[:, 0]))
    ref = np.linalg.norm(d.double().numpy(), axis=1)
    np.testing.assert_allclose(D._warp_norm(d)[:, 0].numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("n_spatial,n_orient", [(2, 8), (3, 8), (4, 16)])
def test_twin_matches_jax_at_other_bin_counts(n_spatial, n_orient):
    """Bin settings that K5 does not take (the card's wrapper refuses them)
    stay computed on the CPU, as in the JAX package: 32, 72 and 256 bins
    a keypoint, 1, 3 and 8 of them a lane in the norms."""
    maps, edges, kw = DC.case("interior", 32)
    kw.update(n_spatial=n_spatial, n_orient=n_orient)
    out = D.edge_descriptors(*(torch.from_numpy(a) for a in maps + edges),
                             **kw)
    ref = JD.edge_descriptors_tiled(*(jnp.asarray(a) for a in maps + edges),
                                    **kw)
    n_bins = 2 * n_spatial * n_spatial * n_orient
    assert out.shape == ref.shape == (32, n_bins)
    out = out.float().numpy()
    _bf16_ulp_close(out, np.asarray(ref, np.float32))
    assert np.isfinite(out).all() and np.all(np.abs(out).max(1) > 0)


def test_cpu_dispatch_never_builds_and_the_wrapper_refuses_cpu(monkeypatch):
    maps, edges, kw = DC.case("interior", 8)
    args = [torch.from_numpy(a) for a in maps + edges]

    def no_build():
        raise AssertionError("CPU tensors must not build or launch a kernel")

    monkeypatch.setattr(CB, "lib", no_build)
    before = dict(CB.LAUNCHES)
    out = D.edge_descriptors(*args, **kw)
    assert CB.LAUNCHES == before
    assert torch.equal(out.view(torch.int16),
                       D.edge_descriptors_plain(*args, **kw).view(torch.int16))
    with pytest.raises(ValueError):
        D.edge_descriptors_cuda(*args, **kw)
    with pytest.raises(ValueError):
        D.edge_descriptors(*(a.to("meta") for a in args), **kw)
