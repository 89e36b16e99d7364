"""The port's numpy copies stay equal to the reference's, and the port runs
with no JAX importable at all."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from edge_based_visual_odometry_tpu import config as JC
from edge_based_visual_odometry_tpu.io import synthetic as JS
from edge_based_visual_odometry_tpu.ops import filters as JF
from edge_based_visual_odometry_tpu_torch import config as TC
from edge_based_visual_odometry_tpu_torch.io import synthetic as TS
from edge_based_visual_odometry_tpu_torch.models.types import config_from_fields
from edge_based_visual_odometry_tpu_torch.ops import filters as TF

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["VOConfig", "CameraConfig", "StereoRig"])
def test_config_fields_and_defaults_match(name):
    assert _fields(getattr(TC, name)) == _fields(getattr(JC, name))


def test_voconfig_checks_and_conversion():
    with pytest.raises(ValueError):
        TC.VOConfig(gate_layout="nope")
    with pytest.raises(ValueError):
        TC.VOConfig(temporal_gather_mode="nope")
    ref = JC.VOConfig(max_edges=1024, gn_tile=48)
    assert dataclasses.asdict(config_from_fields(dataclasses.asdict(ref))) \
        == dataclasses.asdict(ref)
    with pytest.raises(ValueError):
        config_from_fields({"no_such_field": 1})


def test_rig_from_yaml_matches():
    cam = {"resolution": [320, 240], "intrinsics": [300.0, 301.0, 160.0, 121.0],
           "distortion_coefficients": [0.0, 0.0, 0.0, 0.0]}
    cfg = {"left_camera": cam, "right_camera": cam,
           "stereo": {"R21": [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
                      "T21": [-0.12, 0.01, 0.0]},
           "frame_to_body": {"rotation": list(range(9)),
                             "translation": [1, 2, 3]}}
    a, b = JC.rig_from_yaml_dict(cfg), TC.rig_from_yaml_dict(cfg)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    np.testing.assert_array_equal(a.F21, b.F21)
    np.testing.assert_array_equal(a.F12, b.F12)


@pytest.mark.parametrize("kernel_size,sigma", [(17, 2.0), (13, 1.5)])
def test_toed_taps_bit_equal(kernel_size, sigma):
    for a, b in zip(JF.toed_separable_taps(kernel_size, sigma),
                    TF.toed_separable_taps(kernel_size, sigma)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(JF.toed_conv_kernels(kernel_size, sigma),
                                  TF.toed_conv_kernels(kernel_size, sigma))


def test_make_sequence_bit_equal():
    a, b = JS.make_sequence(3, 120, 160), TS.make_sequence(3, 120, 160)
    assert dataclasses.asdict(a.rig) == dataclasses.asdict(b.rig)
    for fa, fb in zip(a.frames, b.frames):
        for k in ("left", "right", "disparity", "R", "t"):
            np.testing.assert_array_equal(getattr(fa, k), getattr(fb, k))


_NO_JAX = textwrap.dedent("""
    import importlib, pkgutil, sys
    for k in [k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib")]:
        del sys.modules[k]
    sys.modules["jax"] = None          # any `import jax` now raises
    import numpy as np
    import edge_based_visual_odometry_tpu_torch as port
    for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        importlib.import_module(m.name)
    from edge_based_visual_odometry_tpu_torch.config import VOConfig
    from edge_based_visual_odometry_tpu_torch.io import synthetic as S
    from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
    seq = S.make_sequence(1, 120, 160)
    cfg = VOConfig(max_edges=1024, max_candidates=8, gather_slots=64,
                   max_mates=512, max_refine_pairs=1024,
                   max_quad_candidates=8, quad_gather_slots=144,
                   ransac_max_iterations=256, gn_max_iter=4)
    f = seq.frames[0]
    fr, tr = PL.VOPipeline(seq.rig, cfg, device="cpu").run_frame(
        np.round(f.left).astype(np.uint8), np.round(f.right).astype(np.uint8))
    assert tr is None and int(fr.mates.count) > 100, int(fr.mates.count)
    assert not [k for k in sys.modules
                if k.startswith("edge_based_visual_odometry_tpu.")
                or k == "edge_based_visual_odometry_tpu"]
    print("ok", int(fr.mates.count))
""")


def test_port_runs_without_jax():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok"), out.stdout
