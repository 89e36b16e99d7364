#!/usr/bin/env python3
"""The readings that a `pair_step` cell's limits are set from, on the
cards.

    python3 vo_bench/calibrate_pairs.py --workload kitti.pairs4 \\
        --seeds 1,2,3 --steps 40 [--fault NAME ...] [--vo KEY=VALUE ...]

One group of the cell's ranks runs every episode: each seed unbroken,
then the first `--fault_seeds` seeds again with each `--fault` of
`harness/pair_faults.py` planted (and with `--vo`'s `VOConfig` fields,
as `max_edges=16384`, for the counts). An episode is a fresh step, its
warm-up and `--steps` loop steps, all checked. One JSON line an episode: the program's numbers
(`harness/pair_check.py`) and the bfloat16 control's `pair_px`. The lower
reading of a number is its largest (a count: its smallest) over the
program's seeds; the upper, its smallest over the faults and the control
(a count: the `--vo` reading).
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
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--vo", action="append", default=[])
    ap.add_argument("--fault_seeds", type=int, default=4,
                    help="the faults and --vo run on the first N seeds")
    args = ap.parse_args(argv)

    from vo_bench.run import require_cards, set_process_env
    set_process_env()
    import torch
    torch.set_num_threads(1)

    from vo_bench.harness import pair_step_run as PSR
    from vo_bench.harness import spec as SPEC

    cell = SPEC.load_cell(args.workload)
    require_cards(cell.chips)
    seeds = [int(s) for s in args.seeds.split(",")]
    vo = dict((kv.split("=")[0], json.loads(kv.split("=")[1]))
              for kv in args.vo)
    eps = [dict(seed=s, steps=args.steps) for s in seeds]
    few = seeds[:args.fault_seeds]
    eps += [dict(seed=s, steps=args.steps, fault=f)
            for f in args.fault for s in few]
    if vo:
        eps += [dict(seed=s, steps=args.steps, vo=vo) for s in few]
    t0 = time.perf_counter()
    for row in PSR.episodes(cell, eps):
        print(json.dumps(dict(workload=cell.name, **row)), flush=True)
    print(json.dumps({"seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
