"""The harness's guards: the modules it must not hold, and no fallback
to the CPU when the card is missing."""

import subprocess
import sys

import pytest
import torch

from vo_bench import run as RUN
from vo_bench.harness import spec as SPEC


def test_module_check_compares_whole_top_level_names():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla_client": 1, "flax": 1,
            "edge_based_visual_odometry_tpu.ops.toed": 1, "numpy": 1}
    assert RUN.forbidden_modules(mods) == [
        "edge_based_visual_odometry_tpu", "flax", "jax", "jaxlib"]
    assert RUN.forbidden_modules({
        "edge_based_visual_odometry_tpu_torch": 1,
        "edge_based_visual_odometry_tpu_torch.models.pipeline": 1,
        "jaxtyping": 1, "torch": 1}) == []


def test_no_card_is_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        RUN.require_cards(1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs 4 cards"):
        RUN.require_cards(4)


def test_run_without_a_card_prints_no_result():
    """Here there is no card: the command fails and its standard output
    holds no result line."""
    proc = subprocess.run(
        [sys.executable, "vo_bench/run.py", "--workload",
         "kitti.every_frame", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=SPEC.ROOT, capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit, match="unknown workload"):
        SPEC.load_cell("kitti.no_such_traffic")
