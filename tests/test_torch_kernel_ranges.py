"""The settings the hand-written kernels take, checked when the pipeline is
built on CUDA (`ops/cuda_build.py::check_kernel_ranges`), not mid-frame:
one test a field, calling the function directly; `VOConfig()` passes;
the step builders and `VOPipeline` call it on CUDA, and on the CPU (the
plain twins) they take the settings the reference takes. The reference's
patch-coverage guard holds on both devices, at construction; the twins
at the patch sizes past the kernels' old range agree with JAX."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from edge_based_visual_odometry_tpu.ops import patches as JP

from edge_based_visual_odometry_tpu_torch.config import VOConfig
from edge_based_visual_odometry_tpu_torch.io import synthetic as S
from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB

OUT_OF_RANGE = [("max_candidates", 65), ("max_quad_candidates", 96),
                ("desc_spatial_bins", 3), ("desc_orient_bins", 16),
                ("desc_patch_samples", 17), ("patch_size", 8),
                ("patch_size", 13), ("toed_kernel_size", 13),
                ("toed_kernel_size", 21)]


@pytest.mark.parametrize("field,value", OUT_OF_RANGE)
def test_out_of_range_setting_names_its_field(field, value):
    with pytest.raises(ValueError, match=f"VOConfig.{field} = {value}"):
        CB.check_kernel_ranges(VOConfig(**{field: value}))


def test_default_config_is_in_range():
    CB.check_kernel_ranges(VOConfig())
    CB.check_kernel_ranges(VOConfig(max_candidates=64, patch_size=7,
                                    desc_patch_samples=12))
    CB.check_kernel_ranges(VOConfig(max_quad_candidates=64))


@pytest.fixture(scope="module")
def rig():
    return S.make_sequence(1, 40, 60).rig


BUILDERS = {
    "stereo": lambda rig, cfg, dev: PL.build_stereo_step(rig, cfg, dev),
    "temporal": lambda rig, cfg, dev: PL.build_temporal_step(rig, cfg, dev),
    "pipeline": lambda rig, cfg, dev: PL.VOPipeline(rig, cfg, device=dev),
}


@pytest.mark.parametrize("builder", BUILDERS)
def test_builders_refuse_out_of_range_settings_on_cuda(rig, builder,
                                                       monkeypatch):
    """With CUDA reported present, building raises before it touches the
    device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="VOConfig.max_quad_candidates"):
        BUILDERS[builder](rig, VOConfig(max_quad_candidates=65), "cuda")


@pytest.mark.parametrize("builder", BUILDERS)
def test_builders_take_any_setting_on_the_cpu(rig, builder):
    """Past the kernels' slots, and at P = 9 with the shift the
    reference's coverage guard admits there (<= 4.34 px)."""
    BUILDERS[builder](rig, VOConfig(max_candidates=80, patch_size=9,
                                    orthogonal_shift_mag=4.0), "cpu")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("builder", BUILDERS)
def test_builders_refuse_what_the_coverage_guard_refuses(rig, builder,
                                                         device,
                                                         monkeypatch):
    """P = 9 at the default 5 px shift: the reference's `edge_patches_tiled`
    asserts that the 32 / 8 atlas tile covers +-11.0 px where the patches
    need +-11.7; the port refuses it at construction on both devices,
    naming both fields, and takes P = 9 at 4 px and P = 11 at 2.9 px."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match=r"VOConfig.patch_size = 9 with "
                       r"VOConfig.orthogonal_shift_mag = 5.0: atlas tile "
                       r"32/stride 8 covers \+-11.0, patches need \+-11.7"):
        BUILDERS[builder](rig, VOConfig(patch_size=9), device)
    PL.check_config(VOConfig(patch_size=9, orthogonal_shift_mag=4.0),
                    torch.device(device))
    PL.check_config(VOConfig(patch_size=11, orthogonal_shift_mag=2.9),
                    torch.device(device))


@pytest.mark.parametrize("field,value,kernel", [
    ("max_candidates", 65, "K6 \\(dense_gates\\)"),
    ("max_quad_candidates", 96, "K6 \\(dense_gates\\)"),
    ("max_quad_candidates", 65, "the BNB filter \\(bnb_keep\\)"),
    ("desc_orient_bins", 16, "K6 \\(dense_gates\\) reads 128 bins"),
    ("desc_spatial_bins", 3, "K6 \\(dense_gates\\) reads 128 bins"),
    ("patch_size", 13, "K6 \\(dense_gates\\) and K7 \\(edge_patches\\)"),
    ("patch_size", 8, "K7 \\(edge_patches\\) take odd sizes")])
def test_k6_k7_limits_are_named(field, value, kernel):
    """K6 holds a row's live slots in 64 bits and reads K5's 2 x 128 bins
    (the BNB filter a row in one warp, two slots a lane); K6 and K7 hold a
    patch side on at most four samples a lane (odd P, P*P <= 121)."""
    with pytest.raises(ValueError, match=kernel):
        CB.check_kernel_ranges(VOConfig(**{field: value}))


@pytest.mark.parametrize("patch_size", [3, 5, 9, 11])
def test_k6_k7_twins_take_other_patch_sizes(patch_size):
    """The CPU twins at P = 3, 5, 9, 11 (the last two past the kernels'
    old P*P <= 64), through the wrappers' CPU dispatch, against JAX's
    `edge_patches_tiled` and `ncc4` on the same edges, at the shift the
    coverage guard admits: patches within 1e-5 of max(1, |b|), ok flags
    equal, the flat gate's NCC within 1e-5 of max(1, |b|)."""
    from edge_based_visual_odometry_tpu_torch.ops import patches as P
    shift = {9: 4.0, 11: 2.9}.get(patch_size, 5.0)
    pp = patch_size * patch_size
    g = np.random.default_rng(patch_size)
    img = (g.random((40, 60)) * 255).astype(np.float32)
    B = 24
    x = g.uniform(8, 52, B).astype(np.float32)
    y = g.uniform(8, 32, B).astype(np.float32)
    t = g.uniform(-np.pi, np.pi, B).astype(np.float32)
    pat, ok = P.edge_patches_flat(*(torch.from_numpy(a) for a in
                                    (img, x, y, t)), patch_size, shift)
    jp, jm, jokp, jokm = JP.edge_patches_tiled(
        *(jnp.asarray(a) for a in (img, x, y, t)), patch_size, shift)
    ref = np.concatenate([np.asarray(jp), np.asarray(jm)], 1)
    assert pat.shape == (B, 2 * pp) and ok.shape == (B, 2)
    np.testing.assert_allclose(pat.numpy(), ref, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())))
    assert np.array_equal(ok.numpy(), np.stack([jokp, jokm], 1))
    rows = torch.from_numpy(g.integers(0, B, B))
    live = torch.ones(B, dtype=torch.bool)
    s = P.dense_gates_flat(pat, ok, rows, pat.flip(0), ok.flip(0), live,
                           patch_size, 0.0).numpy()
    a, b = ref[rows.numpy()], ref[::-1]
    ao, bo = ok.numpy()[rows.numpy()], ok.numpy()[::-1]
    sref = np.asarray(JP.ncc4(*(jnp.asarray(v) for v in (
        a[:, :pp], a[:, pp:], ao[:, 0], ao[:, 1], b[:, :pp], b[:, pp:],
        bo[:, 0], bo[:, 1]))))
    assert np.isfinite(s).all()
    np.testing.assert_allclose(s, sref, rtol=0, atol=1e-5)
