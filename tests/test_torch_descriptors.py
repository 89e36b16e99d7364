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
from scripts import k5_jax_reference as KJ
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
    elif name in DC.NAN_CASES:
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


@pytest.mark.parametrize("name", DC.CASES)
def test_jax_reference_file_is_current(name):
    """`tests/data/k5_jax_reference.npz`, which K5's output on the card is
    held against where JAX is missing, equals `edge_descriptors_tiled` on
    the case now, bit for bit."""
    with np.load(KJ.PATH) as ref:
        assert np.array_equal(ref[name], KJ.jax_bits(name))


def _twin_hat(ob, mag):
    """The twin's circular hat times the magnitude, (..., 8), as
    `edge_descriptors_plain` computes it."""
    orient = torch.arange(8, dtype=torch.float32)
    dd = torch.abs(ob[..., None] - orient)
    dd = torch.minimum(dd, 8 - dd)
    return mag[..., None] * torch.clamp(1.0 - dd, min=0.0)


def test_hat_is_nonzero_in_two_bins_only():
    """K5 evaluates the hat at o_lo = floor(ob) mod 8 and o_lo + 1 mod 8
    only. On the twin's expressions: for a finite magnitude the other 6
    bins are +0 exactly, at every ob in [0, 8] (the integers and their
    float32 neighbours, ob = 8.0, where bin 0 weighs 1 and bin 7 0, and
    the largest ob the float32 2 pi reaches); for an infinite or NaN
    magnitude, or a NaN ob, no bin is finite."""
    g = np.random.default_rng(6)
    ints = np.arange(9, dtype=np.float32)
    top = np.float32(np.float32(2 * np.pi) * (np.float32(1) / np.float32(
        2 * np.pi))) * np.float32(8)
    ob = np.concatenate([
        g.uniform(0, 8, 4096).astype(np.float32), ints,
        np.nextafter(ints, np.float32(-1)), np.nextafter(ints, np.float32(9)),
        [top]]).clip(0, max(8, top)).astype(np.float32)
    ob, mag = torch.from_numpy(ob), torch.full((ob.size,), 300.0)
    T = _twin_hat(ob, mag)
    lo = torch.floor(ob).long() % 8
    two = torch.zeros_like(T, dtype=torch.bool)
    two[torch.arange(T.shape[0]), lo] = True
    two[torch.arange(T.shape[0]), (lo + 1) % 8] = True
    assert bool((T.view(torch.int32)[~two] == 0).all())
    at8 = _twin_hat(torch.tensor([8.0]), torch.tensor([5.0]))[0]
    assert at8[0] == 5.0 and at8[7].view(torch.int32) == 0
    bad = _twin_hat(torch.tensor([3.3, 3.3, float("nan")]),
                    torch.tensor([float("inf"), float("nan"), 1.0]))
    assert not bool(bad.isfinite().any())


@pytest.mark.parametrize("name", DC.NAN_CASES)
def test_a_nonfinite_sample_makes_its_whole_half_nan(name):
    """In the twin a half (a keypoint's 128 bins) is NaN in all its bins or
    in none: a non-finite term reaches the norm. K5 adds the non-finite
    samples' 2 terms and nothing of their other 6 bins, and gets the same
    NaN halves."""
    out = _twin(name, 64).float()
    for half in (out[:, :128], out[:, 128:]):
        nan = half.isnan()
        assert torch.equal(nan.any(1), nan.all(1))
    assert bool(out.isnan().any())


def test_k5_terms_are_the_lists_without_their_padding():
    """K5's tables (`_k5_terms`, on the CPU's table at VOConfig's spacing):
    each cell's terms are its `_cell_lists` entries up to its length, the
    sample's place beside the weight's bits; the lengths are the cells'
    nonzero weights, 25 to 64, 784 in all. A place gives each sample a
    record slot of its own (< 272, at most 17 a colour slot % 16) and an
    o_lo byte of its own (< 320) in a word of the same bank colour; the
    samples read at one term step differ in colour but for a few."""
    terms, lens, place = D._k5_terms(16, 4, 0.66, CPU)
    idx, w = D._cell_lists(16, 4, 0.66, CPU)
    assert terms.dtype == lens.dtype == place.dtype == torch.int32
    assert terms.shape == (64, 16, 2) and lens.shape == (16,)
    assert lens.tolist() == [49, 56, 56, 35, 56, 64, 64, 40, 56, 64, 64, 40,
                             35, 40, 40, 25]
    for p in range(16):
        n = int(lens[p])
        assert torch.equal(terms[:n, p, 0], place[idx[:n, p].long()])
        assert torch.equal(terms[:n, p, 1].view(torch.float32), w[:n, p])
        assert bool((w[:n, p] > 0).all() and (w[n:, p] == 0).all())
    slot, byte = (place & 0xffff).numpy(), (place >> 16).numpy()
    assert len(set(slot)) == 256 and slot.max() < 272
    assert np.bincount(slot % 16).max() <= 17
    assert len(set(byte)) == 256 and byte.max() < 320
    assert np.array_equal(byte // 4 % 16, slot % 16)
    clashes = 0
    for j in range(64):
        read = np.unique(idx[j].numpy()[lens.numpy() > j])
        clashes += len(read) - len(set(slot[read] % 16))
    assert clashes <= 16


def _k5_model(maps, edges, kw):
    """K5's histogram on the CPU: the twin's samples, each kept as (o_lo,
    T[s, o_lo], T[s, o_hi]), each cell's list walked to its own length
    with 2 terms an entry; the rest as the twin."""
    gx_img, gy_img, x, y, theta = (torch.from_numpy(a) for a in maps + edges)
    n, nsp, sp = kw["n_samples"], kw["n_spatial"], kw["spacing"]
    ii, jj, gauss, _ = D._static_tables(n, nsp, sp, CPU)
    idx, w = D._cell_lists(n, nsp, sp, CPU)
    lens = D._k5_terms(n, nsp, sp, CPU)[1]
    kx, ky, kt, ct, st = D._keypoints(x, y, theta, kw["shift_mag"])
    sx = kx[:, None] + ct[:, None] * ii - st[:, None] * jj
    sy = ky[:, None] + st[:, None] * ii + ct[:, None] * jj
    gx, gy = D.P.sample_around(torch.stack([gx_img, gy_img]), kx, ky, sx, sy,
                               40, 8)
    mag = torch.sqrt(gx * gx + gy * gy) * gauss
    ang = torch.atan2(gy, gx) - kt[:, None]
    ob = torch.remainder(ang, D.TWO_PI) / D.TWO_PI * 8
    T = _twin_hat(ob, mag)
    lo = torch.floor(ob).nan_to_num(0).long() % 8
    hi = (lo + 1) % 8
    t_lo, t_hi = T.gather(2, lo[..., None])[..., 0], T.gather(
        2, hi[..., None])[..., 0]
    desc = torch.zeros(T.shape[0], 16, 8)
    for j in range(int(lens.max())):
        live = j < lens
        s = idx[j].long()
        for o, t in ((lo[:, s], t_lo[:, s]), (hi[:, s], t_hi[:, s])):
            cur = desc.gather(2, o[..., None])[..., 0]
            desc.scatter_(2, o[..., None],
                          torch.where(live, cur + w[j] * t, cur)[..., None])
    desc = desc.reshape(-1, 128)
    desc = desc / torch.clamp(D._warp_norm(desc), min=1e-7)
    desc = torch.clamp(desc, max=kw["clip"])
    out = (desc / torch.clamp(D._warp_norm(desc), min=1e-7)
           * kw["scale"]).to(torch.bfloat16)
    N = x.shape[0]
    return torch.cat([out[:N], out[N:]], 1)


@pytest.mark.parametrize("name", DC.CASES)
def test_k5_histogram_over_nonzero_terms_equals_the_twin(name):
    """K5's work, modelled on the CPU (`_k5_model`), equals the twin's bf16
    bits on every case (a NaN equal to a NaN): the 6 zero bins of each hat
    and the lists' padding may be left out."""
    maps, edges, kw = DC.case(name, 64)
    a, b = _k5_model(maps, edges, kw), _twin(name, 64)
    same = (a.view(torch.int16) == b.view(torch.int16)) | (a.isnan()
                                                            & b.isnan())
    assert bool(same.all())
