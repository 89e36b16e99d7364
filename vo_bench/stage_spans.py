#!/usr/bin/env python3
"""Where the program's host time and waits go in a cell, span by span.

    python3 vo_bench/stage_spans.py --workload <cell> --seeds 7,8 \
        [--out PATH]

In one process, for each seed: the cell's set-up and warm-up, a window
of `WINDOW_S` seconds (its mean frame time is reported: no profiler),
then `PAIRS` pairs of profiled slices of `frame_run.SLICE_FRAMES`
frames, each slice one lap of the periodic scene after the one before,
so that all see the same scene frames: the first of a pair with the
program's spans off, as a traced run's profiled slice, the second with
them on (`harness/spans.spans_slice`). The first spans slice's per-span
table (`harness/spans.table`) goes to standard error; one JSON line a
seed to standard output: the stage and frame readers' values
(`metrics/<name>.py` for each of `spans.METRICS`) in that slice, the
share of the idle time inside frames that a stage or wait holds, each
slice's mean frame time, the device's idle share in the first slice,
and the spans' cost (the spans slices' frame time over the others',
less one). `--out` writes each seed's reductions beside, as JSON
lines.

A stop-gap beside `run.py`: once a traced run of `run.py` holds the
spans slice itself (PERF.md, Open questions), this tool and
`spans.profile_events` go.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

WINDOW_S = 10.0     # the unprofiled window's seconds
PAIRS = 2           # pairs of spans-off / spans-on slices a seed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from vo_bench.run import require_cards, set_process_env
    set_process_env()
    import torch
    torch.set_num_threads(1)

    from vo_bench.harness import frames as FR
    from vo_bench.harness import spans as SP
    from vo_bench.harness import spec as SPEC
    from vo_bench.harness import trace as TR
    from vo_bench.harness.frame_run import SLICE_FRAMES

    cell = SPEC.load_cell(args.workload)
    require_cards(cell.chips)
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        fc = FR.FrameCell(cell, seed, dev)
        fc.warm_up()
        times, _, _ = fc.window(WINDOW_S)

        def plain():
            for _ in range(SLICE_FRAMES):
                fc.frame()
            return SLICE_FRAMES
        plain_ms, spans_ms, slices = [], [], []
        for k in range(PAIRS):
            if k:
                for _ in range(fc.n - SLICE_FRAMES):
                    fc.frame()
            ev_off, off_s, off_n = SP.profile_events(plain, dev)
            if not k:
                plain_idle = 100.0 * (1.0 - TR.parse(ev_off)["busy_s"] / off_s)
                plain_spans = SP.reduce(ev_off)["frames"]
            del ev_off
            ps = SP.spans_slice(fc, dev, fc.n - SLICE_FRAMES, SLICE_FRAMES)
            plain_ms.append(1e3 * off_s / off_n)
            if ps["frames"]:
                spans_ms.append(1e3 * ps["window_s"] / ps["units"])
            slices.append(ps)
        fc.free()
        ps = slices[0]
        ctx = {"program_spans": ps}
        row = dict(workload=cell.name, seed=seed, frames=ps["frames"],
                   metrics={m: SPEC.load_metric(m).read(ctx)
                            for m in SP.METRICS},
                   coverage=SP.coverage(ps) if ps["frames"] else None,
                   idle_outside_ms=(1e3 * ps["idle"]["outside_s"]
                                    / max(ps["frames"], 1)),
                   spans_in_plain_slice=plain_spans,
                   window_frame_ms=1e3 * sum(times) / max(len(times), 1),
                   plain_frame_ms=plain_ms, spans_frame_ms=spans_ms,
                   plain_idle_pct=plain_idle)
        if spans_ms:
            row["spans_cost_pct"] = 100.0 * (sum(spans_ms) / sum(plain_ms)
                                             - 1.0)
        print(f"{cell.name} seed {seed}:\n{SP.table(ps)}", file=sys.stderr,
              flush=True)
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(dict(row, program_spans=slices)) + "\n")
            out.flush()
    if out:
        out.close()


if __name__ == "__main__":
    main()
