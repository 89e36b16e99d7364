#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card.

    python3 vo_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--control] [--frames] [--fault NAME] \
        [--vo KEY=VALUE ...]

In one process, for each seed: the cell's set-up, a window of
`--seconds`, and the numbers that decide `correct` (`harness/check.py`)
for the program; with `--control`, also for the control: the plain
reference in bfloat16 in the program's place, on the same frames. One
JSON line a seed; with `--frames`, each checked frame's numbers and each
BA solve's too. `--fault` plants one of `harness/faults.py`'s faults
under the timed path; `--vo` sets a `VOConfig` field (as `max_edges=16384`,
half the edges). The lower reading of a number is its largest (a count:
its smallest) over a dozen seeds or more of the program; the upper, its
smallest over the control's seeds or a fault's (a count: the fault's
largest). The benchmark's own runs never run the control or a fault.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--frames", action="store_true")
    ap.add_argument("--fault")
    ap.add_argument("--vo", action="append", default=[])
    args = ap.parse_args(argv)

    from vo_bench.run import require_cards, set_process_env
    set_process_env()
    import torch
    torch.set_num_threads(1)

    from vo_bench.harness import check as CHECK
    from vo_bench.harness import faults as FAULTS
    from vo_bench.harness import frames as FR
    from vo_bench.harness import spec as SPEC

    cell = SPEC.load_cell(args.workload)
    for kv in args.vo:
        key, value = kv.split("=")
        cell.config.setdefault("vo_config", {})[key] = json.loads(value)
    if args.fault:
        FAULTS.FAULTS[args.fault](setattr)
    require_cards(cell.chips)
    dev = torch.device("cuda", 0)
    pq = cell.workload["pose_quantile"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        fc = FR.FrameCell(cell, seed, dev)
        fc.warm_up()
        times, attempted, failed = fc.window(args.seconds)
        solves = list(fc.ba_solves) if fc.pipe.wba is not None else None
        scene, index = fc.scene, fc.scene_index
        fc.free()
        frames = CHECK.per_frame(scene, fc.records, dev)
        by_solve = (None if solves is None else
                    CHECK.per_solve(scene, solves, index, dev))
        row = dict(workload=cell.name, seed=seed, fault=args.fault,
                   vo=args.vo, frames=attempted, failed=failed,
                   checked=len(fc.records),
                   ba_solves=None if solves is None else len(solves),
                   program=CHECK.numbers_of(frames, by_solve, pq))
        if args.control:
            bf = torch.bfloat16
            row["control"] = CHECK.frame_numbers(
                scene, fc.records, solves, index, dev, pq, bf)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        if args.frames:
            more = {q: CHECK.per_frame(scene, fc.records, dev, q=q)
                    for q in (0.5, 0.75)}
            for i, (rec, f) in enumerate(zip(fc.records, frames)):
                f.update(ratio=float(rec["ratio"]), failed=rec["failed"])
                for q, rows in more.items():
                    for name in ("stereo_px", "temporal_px"):
                        f[f"{name}_q{int(100 * q)}"] = rows[i][name]
                print("frame", json.dumps(f), flush=True)
            if by_solve is not None:
                print("solves", json.dumps(by_solve), flush=True)
        del fc
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
