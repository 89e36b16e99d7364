#!/usr/bin/env python3
"""The readings that a supervised (`gt_frame`) cell's limits are set
from, on the card.

    python3 vo_bench/calibrate_gt.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--control] [--frames] [--fault NAME]

In one process, for each seed: the cell's set-up, a window of
`--seconds`, and the numbers that decide `correct`
(`harness/gt_check.py`) for the program; with `--control`, also for the
control: the plain reference in bfloat16 in the program's place, on the
same frames. One JSON line a seed; with `--frames`, each checked
frame's evaluation numbers too. `--fault` plants one of
`harness/eval_faults.py`'s faults (or `harness/faults.py`'s) under the
timed path. The lower reading of a number is its largest (a count: its
smallest) over the program's seeds; the upper, its smallest over the
control's seeds or a fault's (a count: the fault's largest). The
benchmark's own runs never run the control or a fault.
"""

import argparse
import gc
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
    args = ap.parse_args(argv)

    from vo_bench.run import require_cards, set_process_env
    set_process_env()
    import torch
    torch.set_num_threads(1)

    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
    from vo_bench.harness import eval_faults as EF
    from vo_bench.harness import faults as FAULTS
    from vo_bench.harness import gt_check as GC
    from vo_bench.harness import gt_frame_run as GFR
    from vo_bench.harness import spec as SPEC

    cell = SPEC.load_cell(args.workload)
    if args.fault:
        {**FAULTS.FAULTS, **EF.FAULTS}[args.fault](setattr)
    require_cards(cell.chips)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    pq = cell.workload["pose_quantile"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        fc = GFR.GtFrameCell(cell, seed, dev)
        fc.warm_up()
        CB.reset_launch_counts()
        rows0, frames0 = GC.rows_logged(fc.pipe), fc.frames_run
        _, attempted, failed = fc.window(args.seconds)
        steps = {k: dict(v) for k, v in CB.GRAPH_STEPS.items()}
        missing = (2 * (fc.frames_run - frames0)
                   - (GC.rows_logged(fc.pipe) - rows0))
        logs = (fc.pipe.stereo_metrics_log, fc.pipe.temporal_metrics_log)
        cfg = fc.pipe.cfg
        scene, index = fc.scene, fc.scene_index
        fc.free()
        GC.add_right_edges(fc.records, cfg)
        rule = GC.rules(cfg)
        program = GC.frame_numbers(scene, fc.records, logs, rule, None, index,
                                   dev, pq)
        program["eval_rows_missing"] = missing
        row = dict(workload=cell.name, seed=seed, fault=args.fault,
                   frames=attempted, failed=failed,
                   checked=len(fc.records), graph_steps=steps,
                   memory_peak_bytes=int(torch.cuda.max_memory_allocated(dev)),
                   program=program)
        if args.control:
            row["control"] = GC.frame_numbers(
                scene, fc.records, logs, rule, None, index, dev, pq,
                torch.bfloat16)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        if args.frames:
            for f in GC.per_frame(scene, fc.records, logs, rule):
                print("frame", json.dumps(f), flush=True)
        del fc
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
