"""Port ops vs the JAX reference on the same numpy inputs: Sobel, patches
and NCC, descriptors (bf16), the sorted grid (query + compaction,
including ties), clustering, and the cascade's BNB / flat-list helpers.

Index, mask and ordering outputs must be exactly equal; floats agree to
1e-5 relative (f32 sums in another order); bf16 descriptors to 1 ulp.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from edge_based_visual_odometry_tpu.io import synthetic as JS
from edge_based_visual_odometry_tpu.models import stereo_matcher as JSM
from edge_based_visual_odometry_tpu.ops import clustering as JCL
from edge_based_visual_odometry_tpu.ops import descriptors as JD
from edge_based_visual_odometry_tpu.ops import grid as JG
from edge_based_visual_odometry_tpu.ops import image as JIMG
from edge_based_visual_odometry_tpu.ops import patches as JP
from edge_based_visual_odometry_tpu.ops import toed as JT
from edge_based_visual_odometry_tpu_torch.models import stereo_matcher as SM
from edge_based_visual_odometry_tpu_torch.ops import clustering as CL
from edge_based_visual_odometry_tpu_torch.ops import descriptors as D
from edge_based_visual_odometry_tpu_torch.ops import grid as G
from edge_based_visual_odometry_tpu_torch.ops import image as IMG
from edge_based_visual_odometry_tpu_torch.ops import patches as P

pytestmark = pytest.mark.heavy
torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol * max(1.0, float(np.abs(b).max())))


@pytest.fixture(scope="module")
def scene():
    """uint8-valued 120x160 pair, Sobel maps, left TOED edges."""
    f = JS.make_sequence(1, 120, 160).frames[0]
    left = np.round(f.left).clip(0, 255).astype(np.float32)
    right = np.round(f.right).clip(0, 255).astype(np.float32)
    gx, gy = (np.asarray(a) for a in JIMG.sobel_gradients(jnp.asarray(left)))
    e = JT.detect_edges(jnp.asarray(left), max_edges=1024)
    n = int(e.count)
    xy = [np.asarray(a)[:n] for a in (e.x, e.y, e.theta)]
    return dict(left=left, right=right, gx=gx, gy=gy, x=xy[0], y=xy[1],
                theta=xy[2])


def test_sobel_matches(scene):
    img = np.random.default_rng(0).random((37, 53)).astype(np.float32) * 255
    for im in (img, scene["left"]):
        for a, b in zip(IMG.sobel_gradients(t(im)),
                        JIMG.sobel_gradients(jnp.asarray(im))):
            close(a.numpy(), b)


def test_edge_patches_match(scene):
    s = scene
    # include points near and past the border (ok flags / clamped samples)
    x = np.concatenate([s["x"], [1.0, 158.5, 80.0]]).astype(np.float32)
    y = np.concatenate([s["y"], [60.0, 2.0, 119.2]]).astype(np.float32)
    th = np.concatenate([s["theta"], [0.3, 1.2, -2.0]]).astype(np.float32)
    out = P.edge_patches(t(s["left"]), t(x), t(y), t(th), 7, 5.0, chunk=100)
    ref = JP.edge_patches_tiled(jnp.asarray(s["left"]), jnp.asarray(x),
                                jnp.asarray(y), jnp.asarray(th), 7, 5.0)
    close(out[0].numpy(), ref[0])
    close(out[1].numpy(), ref[1])
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    assert not out[2][-3:].all()


def test_ncc4_matches():
    g = np.random.default_rng(1)
    p = [g.random((50, 49)).astype(np.float32) * 200 for _ in range(4)]
    p[1][3] = 7.0                                    # degenerate patch
    ok = [g.random(50) > 0.1 for _ in range(4)]
    args = (p[0], p[1], ok[0], ok[1], p[2], p[3], ok[2], ok[3])
    out = P.ncc4(*(t(a) for a in args))
    ref = JP.ncc4(*(jnp.asarray(a) for a in args))
    close(out.numpy(), ref)


def _bf16_ulp_close(a, b):
    """Within 1 bf16 ulp of max(|a|, |b|, 1): entries far below 1 on the
    descriptor's 512 scale (hat weights near 0) carry f32 cancellation
    error of a few 1e-5 absolute, many ulps of their own tiny value."""
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(a - b) <= ulp)


def test_descriptors_match_bf16(scene):
    s = scene
    kw = dict(shift_mag=8.0, n_samples=16, n_spatial=4, n_orient=8,
              spacing=0.66, clip=0.2, scale=512.0)
    out = D.edge_descriptors(t(s["gx"]), t(s["gy"]), t(s["x"]), t(s["y"]),
                             t(s["theta"]), chunk=256, **kw)
    ref = JD.edge_descriptors_tiled(jnp.asarray(s["gx"]), jnp.asarray(s["gy"]),
                                    jnp.asarray(s["x"]), jnp.asarray(s["y"]),
                                    jnp.asarray(s["theta"]), **kw)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    _bf16_ulp_close(out.float().numpy(), np.asarray(ref, np.float32))

    # cross distances from the same bf16 descriptors
    a = np.asarray(ref)[:40]
    b = np.asarray(ref)[np.random.default_rng(2).integers(0, len(ref), (40, 6))]
    dist = D.min_cross_distance_dot(
        torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16),
        torch.from_numpy(b.astype(np.float32)).to(torch.bfloat16))
    ref_d = JD.min_cross_distance_dot(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(dist.numpy(), np.asarray(ref_d), atol=0.05)


@pytest.fixture(scope="module")
def grid_case():
    g = np.random.default_rng(5)
    n, W, H = 600, 200, 100
    x = g.uniform(0, W, n).astype(np.float32)
    y = g.uniform(0, H, n).astype(np.float32)
    x[:40] = x[40:80]                     # duplicate keys: stable order
    y[:40] = y[40:80]
    valid = g.random(n) > 0.1
    attrs = np.stack([x, y, g.uniform(-3, 3, n).astype(np.float32)], -1)
    qx = g.uniform(-5, W + 5, 64).astype(np.float32)
    qy = g.uniform(-5, H + 5, 64).astype(np.float32)
    return x, y, valid, attrs, qx, qy, W, H


def test_grid_query_matches(grid_case):
    x, y, valid, attrs, qx, qy, W, H = grid_case
    kw = dict(rx=12.0, ry=6.0, slots_per_band=24, n_band_window=3)
    jg = JG.build_sorted_grid(jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(valid), W, H, band_h=8,
                              attrs=jnp.asarray(attrs))
    tg = G.build_sorted_grid(t(x), t(y), t(valid), W, H, band_h=8,
                             attrs=t(attrs))
    np.testing.assert_array_equal(tg.sorted_idx.numpy(),
                                  np.asarray(jg.sorted_idx))
    ji, ja, jm = JG.query_sorted_grid_attrs(jg, jnp.asarray(qx),
                                            jnp.asarray(qy), **kw)
    ti, ta, tm = G.query_sorted_grid_attrs(tg, t(qx), t(qy), **kw)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    # masked slots point at valid entries
    assert valid[ti.numpy()[tm.numpy()]].all()


@pytest.mark.parametrize("priority", [False, True])
@pytest.mark.parametrize("capacity", [4, 16])
def test_compaction_matches_with_ties(priority, capacity):
    g = np.random.default_rng(capacity)
    Q, S = 70, 40
    idx = g.integers(0, 1000, (Q, S)).astype(np.int32)
    mask = g.random((Q, S)) > 0.4
    idx = np.where(mask, idx, 0)
    attrs = g.normal(size=(3, Q, S)).astype(np.float32)
    pri = None
    if priority:
        pri = np.round(g.random((Q, S)) * 4).astype(np.float32)   # many ties
    ji, ja, jm = JG.compact_candidates_attrs(
        jnp.asarray(idx), jnp.asarray(attrs), jnp.asarray(mask), capacity,
        priority=None if pri is None else jnp.asarray(pri))
    ti, ta, tm = G.compact_candidates_attrs(
        t(idx).long(), t(attrs), t(mask), capacity,
        priority=None if pri is None else t(pri))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("by_orientation", [False, True])
def test_cluster_edges_matches(by_orientation):
    g = np.random.default_rng(7 + by_orientation)
    N, C = 64, 16
    cx = g.uniform(0, 50, (N, 1))
    x = (cx + g.normal(0, 0.6, (N, C))).astype(np.float32)   # dense clumps
    y = (g.uniform(0, 50, (N, 1)) + g.normal(0, 0.6, (N, C))).astype(np.float32)
    th = g.uniform(-1, 1, (N, C)).astype(np.float32)
    mask = g.random((N, C)) > 0.2
    kw = dict(dist_thresh=1.0, orient_thresh_deg=20.0,
              by_orientation=by_orientation, gauss_sigma=2.0,
              max_cluster_size=4)
    ref = JCL.cluster_edges(jnp.asarray(x), jnp.asarray(y), jnp.asarray(th),
                            jnp.asarray(mask), **kw)
    out = CL.cluster_edges(t(x), t(y), t(th), t(mask), chunk=24, **kw)
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(out.label.numpy(), np.asarray(ref.label))
    np.testing.assert_array_equal(out.members.numpy(), np.asarray(ref.members))
    for a, b in ((out.x, ref.x), (out.y, ref.y), (out.theta, ref.theta)):
        close(a.numpy(), b)


@pytest.mark.parametrize("higher_better", [True, False])
def test_bnb_keep_matches_with_ties(higher_better):
    g = np.random.default_rng(11)
    scores = np.round(g.uniform(0.5, 1.0, (200, 12)), 1).astype(np.float32)
    mask = g.random((200, 12)) > 0.3
    ref = JSM._bnb_keep(jnp.asarray(scores), jnp.asarray(mask), 0.8,
                        higher_better)
    out = SM._bnb_keep(t(scores), t(mask), 0.8, higher_better)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("max_pairs", [50, 400])
def test_flatten_and_scatter_back_match(max_pairs):
    g = np.random.default_rng(max_pairs)
    cmask = g.random((30, 8)) > 0.5
    rows, slots, fmask = SM._flatten_active(t(cmask), max_pairs)
    jr, js, jf = JSM._flatten_active(jnp.asarray(cmask), max_pairs)
    np.testing.assert_array_equal(fmask.numpy(), np.asarray(jf))
    live = fmask.numpy()         # slots past the active count are never read
    for a, b in ((rows, jr), (slots, js)):
        np.testing.assert_array_equal(a.numpy()[live], np.asarray(b)[live])
    tmpl = g.normal(size=(30, 8)).astype(np.float32)
    vals = g.normal(size=max_pairs).astype(np.float32)
    out = SM._scatter_back(t(tmpl), rows, slots, fmask, t(vals))
    ref = JSM._scatter_back(jnp.asarray(tmpl), jr, js, jf, jnp.asarray(vals))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
