"""What a cell is, read from the benchmark's own files by name.

A cell `<config>.<traffic>` of `BENCHMARK.json` has its workload file
`workloads/<cell>.json` (configuration, chips, entry, pipeline settings,
scene, warm-up, the pose quantile and the limits of its check, why); the configuration has
`configs/<config>.json` (the rig in the reference's YAML schema, the
`VOConfig` fields it sets, its guarantees and what was assumed); the
scene has `scene/<scene>.json` (planes, texture seed, periodic
trajectory); a per-layer metric has `metrics/<metric>.py`. Adding any of
them is adding files: nothing here names a cell, a configuration, a
scene or a metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    scene: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def entry(self) -> str:
        return self.workload["entry"]


def _applies(metric: dict, cell: str, cell_e2e: set) -> bool:
    """A metric with `workloads` applies to the cells listed; a per-layer
    metric without it, to every cell that reports what it moves; an
    end-to-end metric without it, to every cell."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in cell_e2e


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    workload = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    if workload["config"] != cells[name]["config"]:
        raise SystemExit(f"{name}: workload file's config "
                         f"{workload['config']!r} is not BENCHMARK.json's "
                         f"{cells[name]['config']!r}")
    if int(workload["chips"]) != int(cells[name]["chips"]):
        raise SystemExit(f"{name}: workload file's chips {workload['chips']}"
                         f" is not BENCHMARK.json's {cells[name]['chips']}")
    config = load_json(BENCH_DIR / "configs" / f"{workload['config']}.json")
    scene = load_json(BENCH_DIR / "scene" / f"{workload['scene']}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name, workload, config, scene, e2e, per_layer)


def load_metric(name: str):
    """The reader module `metrics/<name>.py`: LAYER, UNIT, SOURCE, MOVES
    and read(ctx) -> float or None (None: nothing to read here)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"vo_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer_metrics(cell: Cell, ctx: dict) -> dict:
    """The cell's per-layer metrics that find something to read in the
    run's context."""
    out = {}
    for m in cell.per_layer:
        value = load_metric(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def stereo_rig(config: dict):
    """The port's StereoRig from a configuration's rig."""
    from edge_based_visual_odometry_tpu_torch.config import rig_from_yaml_dict
    return rig_from_yaml_dict(config["rig"])


def vo_config(config: dict, seed: int):
    """`VOConfig` with the configuration's fields; RANSAC draws from the
    run's seed."""
    from edge_based_visual_odometry_tpu_torch.config import VOConfig
    return VOConfig(**config.get("vo_config", {}),
                    ransac_seed=int(seed) % (1 << 62))
