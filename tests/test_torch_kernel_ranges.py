"""The settings the hand-written kernels take, checked when the pipeline is
built on CUDA (`ops/cuda_build.py::check_kernel_ranges`), not mid-frame:
one test a field, calling the function directly; `VOConfig()` passes;
the step builders and `VOPipeline` call it on CUDA, and on the CPU (the
plain twins) they take every setting."""

import numpy as np
import pytest
import torch

from edge_based_visual_odometry_tpu_torch.config import VOConfig
from edge_based_visual_odometry_tpu_torch.io import synthetic as S
from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB

OUT_OF_RANGE = [("max_candidates", 65), ("max_quad_candidates", 96),
                ("desc_spatial_bins", 3), ("desc_orient_bins", 16),
                ("desc_patch_samples", 17), ("patch_size", 8),
                ("patch_size", 9)]


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
    BUILDERS[builder](rig, VOConfig(max_candidates=80, patch_size=9), "cpu")


@pytest.mark.parametrize("field,value,kernel", [
    ("max_candidates", 65, "K6 \\(dense_gates\\)"),
    ("max_quad_candidates", 96, "K6 \\(dense_gates\\)"),
    ("desc_orient_bins", 16, "K6 \\(dense_gates\\) reads 128 bins"),
    ("desc_spatial_bins", 3, "K6 \\(dense_gates\\) reads 128 bins"),
    ("patch_size", 9, "K6 \\(dense_gates\\) and K7 \\(edge_patches\\)"),
    ("patch_size", 8, "K7 \\(edge_patches\\) take odd sizes")])
def test_k6_k7_limits_are_named(field, value, kernel):
    """K6 holds a row's live slots in 64 bits and reads K5's 2 x 128 bins;
    K6 and K7 hold a patch side on two samples a lane (odd P, P*P <= 64)."""
    with pytest.raises(ValueError, match=kernel):
        CB.check_kernel_ranges(VOConfig(**{field: value}))


@pytest.mark.parametrize("patch_size", [3, 5, 9, 11])
def test_k6_k7_twins_take_other_patch_sizes(patch_size):
    """The CPU twins take what the kernels refuse: P = 9, 11 (P*P > 64)
    and the smaller sizes, through the wrappers' CPU dispatch."""
    from edge_based_visual_odometry_tpu_torch.ops import patches as P
    g = np.random.default_rng(patch_size)
    img = torch.from_numpy((g.random((40, 60)) * 255).astype(np.float32))
    x = torch.tensor([30.0, 12.5], dtype=torch.float32)
    y = torch.tensor([20.0, 9.0], dtype=torch.float32)
    t = torch.tensor([0.3, -1.2], dtype=torch.float32)
    pat, ok = P.edge_patches_flat(img, x, y, t, patch_size, 5.0)
    assert pat.shape == (2, 2 * patch_size ** 2) and ok.shape == (2, 2)
    live = torch.tensor([True, True])
    s = P.dense_gates_flat(pat, ok, torch.tensor([0, 1]), pat.flip(0),
                           ok.flip(0), live, patch_size, 0.0)
    assert s.shape == (2,) and bool(torch.isfinite(s).all())
    same = P.dense_gates_flat(pat, ok, torch.tensor([0, 1]), pat, ok, live,
                              patch_size, 0.0)
    assert bool(((same == 1.0) | (same == -1.0)
                 | ((same - 1.0).abs() < 1e-6)).all())
