"""Every cell, configuration, scene and per-layer metric of BENCHMARK.json
loads and is found by name, and the file keeps the contract's shape."""

import json
import re

import pytest

from vo_bench.harness import spec as SPEC

BENCH = SPEC.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(cell):
    c = SPEC.load_cell(cell)
    assert c.config["name"] == c.workload["config"]
    assert (SPEC.BENCH_DIR / "harness" / f"{c.entry}_run.py").exists()
    assert c.entry == "frame"
    numbers = {"stereo_px", "temporal_px", "pose_px", "mates_min",
               "quads_min"}
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "frames_per_s"}
    assert c.per_layer, "every cell reports a per-layer metric"
    assert all(m["moves"] in {x["name"] for x in c.end_to_end}
               for m in c.per_layer)
    assert set(c.workload["check"]) >= numbers
    assert 0.5 <= c.workload["pose_quantile"] <= 1.0
    assert c.scene["trajectory"]["n_frames"] >= 32


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    mod = SPEC.load_metric(metric)
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])
    assert mod.read({}) is None, "a reader with nothing to read returns None"


def test_benchmark_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vo_bench"]
    assert BENCH["command"] == ["python3", "vo_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in BENCH["workloads"]}
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["reduced"] == []
        assert json.load(open(SPEC.ROOT / c["file"]))["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024
