"""The port's TOED (the plain twin of kernel K1 and the edge detector on
top of it) against the float64 NumPy oracle of the reference detector
(`tests/toed_oracle.py`), with the tolerances of `tests/test_toed.py`,
which holds the JAX package to the same oracle: field rtol 2e-4 /
atol 2e-3 (f32 tap sums against float64), orientation where the
magnitude is significant, 99th-percentile subpixel position < 0.05 px,
edge counts within max(3, 1%) (f32 ties at the NMS thresholds)."""

import numpy as np
import pytest
import torch

from edge_based_visual_odometry_tpu_torch.ops import toed
from tests import toed_oracle as oracle

torch.set_num_threads(2)


def _image(h=72, w=80, seed=0):
    """Smooth synthetic image with strong oriented structures (the image
    of tests/test_toed.py)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = (120.0 + 80.0 * np.sin(0.21 * xx + 0.13 * yy)
           + 50.0 * np.tanh((xx - 0.7 * yy - 15.0) / 1.5)
           + 40.0 * np.cos(0.17 * yy))
    img += rng.normal(0, 1.0, size=(h, w))
    return np.clip(img, 0, 255)


@pytest.fixture(scope="module")
def image():
    return _image()


@pytest.fixture(scope="module")
def oracle_field(image):
    return oracle.oracle_gradient_field(image)


def test_port_gradient_field_matches_oracle(image, oracle_field):
    Ix_o, Iy_o, mag_o, ori_o = oracle_field
    out = toed.toed_gradient_field_plain(
        torch.from_numpy(image.astype(np.float32)))
    Ix, Iy, mag, ori = (a.double().numpy() for a in out)
    np.testing.assert_allclose(Ix, Ix_o, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(Iy, Iy_o, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(mag, mag_o, rtol=2e-4, atol=2e-3)
    m = mag_o > 2.0
    dori = np.abs(ori[m] - ori_o[m])
    dori = np.minimum(dori, 2 * np.pi - dori)
    assert np.quantile(dori, 0.999) < 1e-2
    assert dori.mean() < 1e-4


def test_port_detect_edges_matches_oracle(image, oracle_field):
    ref_edges = oracle.oracle_nms(*oracle_field, *image.shape)
    got = toed.detect_edges(torch.from_numpy(image.astype(np.float32)),
                            max_edges=4096)
    n = int(got.count)
    gx, gy, gt = (a[:n].double().numpy() for a in (got.x, got.y, got.theta))
    assert len(ref_edges) > 50
    assert abs(n - len(ref_edges)) <= max(3, 0.01 * len(ref_edges))
    ref = np.array([(e[0], e[1]) for e in ref_edges])
    ref_theta = np.array([e[2] for e in ref_edges])
    d2 = ((gx[:, None] - ref[None, :, 0]) ** 2
          + (gy[:, None] - ref[None, :, 1]) ** 2)
    nn = d2.argmin(axis=1)
    assert np.quantile(np.sqrt(d2[np.arange(n), nn]), 0.99) < 0.05
    dth = np.abs(gt - ref_theta[nn])
    dth = np.minimum(dth, 2 * np.pi - dth)
    assert np.quantile(dth, 0.98) < 1e-2
