"""The settings the hand-written kernels take, checked when the pipeline is
built on CUDA (`ops/cuda_build.py::check_kernel_ranges`), not mid-frame:
one test a field, calling the function directly; `VOConfig()` passes;
the step builders and `VOPipeline` call it on CUDA, and on the CPU (the
plain twins) they take every setting."""

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
