"""The contract of TOED's NMS, subpixel fit and raster-order compaction
(`toed.nms_compact`), held on the plain twin on the CPU: what the CUDA
kernel `csrc/toed_nms_compact.cu` reproduces bit for bit on the card
(tests/test_torch_cuda.py). No JAX here: the twin is held against JAX
in tests/test_torch_toed.py.

- the EdgeList is the first `max_edges` kept pixels in raster order, as
  numpy's `flatnonzero` orders them, with `count` clamped and the slots
  past it zero and not valid, at even and odd image sizes;
- past `max_edges` (overflow) the list is the start of a larger one;
- a (2, H, W) batch gives what two single-image calls give;
- a flat or zero-gradient image gives no edge and no NaN;
- pixels exactly at the border and `grad_mag_min` limits, and on the
  field's edge (zero padding), are kept or dropped as the comparisons
  say (`tests/toed_nms_cases.py`).
"""

import numpy as np
import pytest
import torch

from edge_based_visual_odometry_tpu_torch.io import synthetic as S
from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.ops import toed as T
from tests import toed_nms_cases as NC

torch.set_num_threads(2)

SIZES = {"even": (64, 90), "odd": (65, 91)}


def _image(name):
    h, w = SIZES[name]
    f = S.make_sequence(1, h, w).frames[0]
    return torch.from_numpy(np.stack([f.left, f.right]).astype(np.float32))


def _reference(fields, H, W, max_edges, grad_mag_min=2.0, border=10):
    """Each image's EdgeList as numpy arrays, compacted by numpy from the
    twin's NMS maps: the kept pixels in `flatnonzero` order."""
    sx, sy, smag, valid = (a.numpy() for a in T.toed_nms_subpixel(
        *fields, border=border, grad_mag_min=grad_mag_min))
    orient = fields[3].numpy()
    out = []
    for b in range(sx.shape[0]):
        ex = (sx[b] - np.float32(1.0)) * np.float32(0.5)
        ey = (sy[b] - np.float32(1.0)) * np.float32(0.5)
        keep = (valid[b] & (ex > border) & (ex < W - border)
                & (ey > border) & (ey < H - border))
        idx = np.flatnonzero(keep)
        n = min(idx.size, max_edges)
        lists = []
        for v in (ex, ey, orient[b], smag[b]):
            a = np.zeros(max_edges, np.float32)
            a[:n] = v.ravel()[idx[:n]]
            lists.append(a)
        ok = np.arange(max_edges) < n
        out.append((*lists, ok, n, idx.size))
    return out


def _assert_edges_equal(e, ref):
    for nm, a, b in zip(("x", "y", "theta", "mag", "valid"), e, ref[:5]):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=nm)
    assert e.count.dtype == torch.int32 and e.count.shape == ()
    assert int(e.count) == ref[5]


@pytest.mark.parametrize("max_edges", [4096, 64])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_twin_compacts_in_raster_order(size, max_edges):
    img = _image(size)
    H, W = img.shape[-2:]
    fields = T.toed_gradient_field(img)
    edges = T.nms_compact_plain(*fields, H, W, max_edges)
    refs = _reference(fields, H, W, max_edges)
    for e, ref in zip(edges, refs):
        _assert_edges_equal(e, ref)
        assert ref[6] > 64          # 64 overflows, 4096 does not
        assert (ref[6] < max_edges) == (max_edges == 4096)


@pytest.mark.parametrize("size", sorted(SIZES))
def test_overflow_keeps_the_first_in_raster_order(size):
    img = _image(size)
    big = T.detect_edges(img, max_edges=4096)
    for M in (1, 17, 64):
        small = T.detect_edges(img, max_edges=M)
        for s, b in zip(small, big):
            assert int(b.count) > M and int(s.count) == M
            assert bool(s.valid.all())
            for a, full in zip(s[:4], b[:4]):
                assert torch.equal(a, full[:M])
    for b in big:
        n = int(b.count)
        assert bool(b.valid[:n].all()) and not bool(b.valid[n:].any())
        for a in b[:4]:
            assert not bool(a[n:].any())


@pytest.mark.parametrize("size", sorted(SIZES))
def test_batch_equals_single_calls(size):
    img = _image(size)
    both = T.detect_edges(img, max_edges=2048)
    for b in range(2):
        one = T.detect_edges(img[b], max_edges=2048)
        for a, s in zip(both[b], one):
            assert a.dtype == s.dtype and torch.equal(a, s)


@pytest.mark.parametrize("value", [0.0, 128.0, 255.0])
def test_flat_image_gives_no_edges(value):
    e = T.detect_edges(torch.full((2, 33, 47), value), max_edges=256)
    for one in e:
        assert int(one.count) == 0 and not bool(one.valid.any())
        for a in one[:4]:
            assert bool(torch.isfinite(a).all()) and not bool(a.any())


def test_zero_gradient_fields_give_no_edges_and_no_nan():
    """|grad| = Ix = Iy = 0 makes the twin's unit normal 0 / 0: nothing is
    kept, and no NaN reaches the EdgeList."""
    z = torch.zeros((2, 40, 60))
    orient = torch.full_like(z, float("nan"))
    for e in T.nms_compact_plain(z, z, z, orient, 20, 30, 128,
                                 grad_mag_min=-1.0, border=0):
        assert int(e.count) == 0 and not bool(e.valid.any())
        for a in e[:4]:
            assert bool(torch.isfinite(a).all()) and not bool(a.any())


@pytest.mark.parametrize("name", sorted(NC.LIMIT_CASES))
def test_kept_at_the_limits(name):
    fields, (H, W, border, gmin), kept = NC.limit_fields(name)
    fields = [torch.from_numpy(f) for f in fields]
    (e,) = T.nms_compact_plain(*fields, H, W, 16, grad_mag_min=gmin,
                               border=border)
    n = len(kept)
    assert int(e.count) == n
    g, orient = fields[2][0].numpy(), fields[3][0].numpy()
    ii, jj = (np.array([k[a] for k in kept], np.float32) for a in (0, 1))
    v = np.array([g[i, j] for i, j in kept], np.float32)
    np.testing.assert_array_equal(e.x[:n].numpy(), (jj - 1) * 0.5)
    np.testing.assert_array_equal(e.y[:n].numpy(), (ii - 1) * 0.5)
    np.testing.assert_array_equal(e.theta[:n].numpy(),
                                  [orient[i, j] for i, j in kept])
    np.testing.assert_array_equal(e.mag[:n].numpy(), np.sqrt(v * v))
    assert bool(e.valid[:n].all()) and not bool(e.valid[n:].any())
    _assert_edges_equal(e, _reference(fields, H, W, 16, gmin, border)[0])


def test_cpu_tensor_takes_the_twin_and_kernel_wrapper_refuses_it(
        monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not build or launch a kernel")

    monkeypatch.setattr(CB, "lib", no_build)
    img = _image("odd")
    fields = T.toed_gradient_field(img)
    before = dict(CB.LAUNCHES)
    got = T.nms_compact(*fields, 65, 91, 512)
    assert CB.LAUNCHES == before
    for a, b in zip(got, T.nms_compact_plain(*fields, 65, 91, 512)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    with pytest.raises(ValueError):
        T.nms_compact_cuda(*fields, 65, 91, 512)
