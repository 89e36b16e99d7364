"""Port TOED vs the JAX reference: the gradient field (plain twin vs the
XLA formulation and vs the Pallas kernel in interpret mode) and
detect_edges end to end. The CUDA kernel is held against the twin on the
card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from edge_based_visual_odometry_tpu.io import synthetic as JS
from edge_based_visual_odometry_tpu.ops import toed as JT
from edge_based_visual_odometry_tpu.ops import toed_pallas as JTP
from edge_based_visual_odometry_tpu_torch.ops import toed as T

pytestmark = pytest.mark.heavy
torch.set_num_threads(2)


def _assert_field_close(out, ref):
    """Tolerances of tests/test_toed_pallas.py: rtol 2e-4 / atol 2e-3 on
    (Ix, Iy, |grad|); orientation 99.9% quantile < 1e-3 rad where |grad|
    > 2 (f32 sums in another order)."""
    for nm, a, b in zip(("Ix", "Iy", "mag", "orient"), out, ref):
        a, b = np.asarray(a), np.asarray(b)
        if nm == "orient":
            m = np.asarray(ref[2]) > 2.0
            d = np.abs(a[m] - b[m])
            d = np.minimum(d, 2 * np.pi - d)
            assert np.quantile(d, 0.999) < 1e-3, nm
        else:
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-3, err_msg=nm)


@pytest.fixture(scope="module")
def img():
    return (np.random.default_rng(42).random((96, 200)) * 255).astype(np.float32)


def test_field_plain_matches_xla(img):
    out = T.toed_gradient_field_plain(torch.from_numpy(img))
    _assert_field_close([o.numpy() for o in out],
                        JT.toed_gradient_field(jnp.asarray(img)))


def test_field_plain_matches_pallas_interpret(img):
    out = T.toed_gradient_field_plain(torch.from_numpy(img))
    ref = JTP.toed_gradient_field_pallas(jnp.asarray(img), block_h=32,
                                         interpret=True)
    _assert_field_close([o.numpy() for o in out], ref)


def test_field_batched_equals_single(img):
    both = torch.stack([torch.from_numpy(img), torch.from_numpy(img[::-1].copy())])
    ob = T.toed_gradient_field(both)
    for b in range(2):
        for a, s in zip(ob, T.toed_gradient_field(both[b])):
            torch.testing.assert_close(a[b], s, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("which", ["left", "right"])
def test_detect_edges_matches_jax(which):
    f = JS.make_sequence(1, 120, 160).frames[0]
    im = np.round(getattr(f, which)).clip(0, 255).astype(np.uint8)
    ref = JT.detect_edges(jnp.asarray(im, jnp.float32), max_edges=4096)
    out = T.detect_edges(torch.from_numpy(im), max_edges=4096)
    n_ref, n_out = int(ref.count), int(out.count)
    assert n_ref > 500
    # NMS threshold ties may flip O(1) edges between backends
    assert min(n_ref, n_out) / max(n_ref, n_out) >= 0.998
    rx = np.asarray(ref.x)[:n_ref]
    ry = np.asarray(ref.y)[:n_ref]
    rt = np.asarray(ref.theta)[:n_ref]
    ox, oy, ot = (a.numpy()[:n_out] for a in (out.x, out.y, out.theta))
    d = np.hypot(ox[:, None] - rx[None], oy[:, None] - ry[None])
    j = d.argmin(1)
    near = d[np.arange(n_out), j] < 1e-3
    assert near.mean() >= 0.998
    dt = np.abs(ot - rt[j])[near]
    assert np.quantile(np.minimum(dt, 2 * np.pi - dt), 0.999) < 1e-3
    assert out.valid.sum() == n_out and not out.valid[n_out:].any()


def test_cpu_tensor_takes_the_twin_and_kernel_wrapper_refuses_it(img,
                                                                 monkeypatch):
    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB

    def no_build():
        raise AssertionError("a CPU tensor must not build or launch a kernel")

    monkeypatch.setattr(CB, "lib", no_build)
    before = dict(CB.LAUNCHES)
    T.toed_gradient_field(torch.from_numpy(img))
    assert CB.LAUNCHES == before
    with pytest.raises(ValueError):
        T.toed_gradient_field_cuda(torch.from_numpy(img))
