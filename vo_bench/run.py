#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card(s) it asks for.

    python3 vo_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository's root. The cell is read by name from
`BENCHMARK.json` and `vo_bench/workloads/<cell>.json`. The run sets up
(kernels loaded, built on a checkout's first run; the scene rendered on
the card from the seed; the pipeline warmed up), measures for `--seconds`
on the host clock, then checks what the window produced against the
plain reference (`vo_bench/reference/`). With `--trace 0` it reports the
cell's end-to-end metrics; with `--trace 1` the same run carries
synchronised step spans, and a profiled slice after the window gives the
per-layer metrics, `device.busy_s` / `window_s` and `breakdown`.

The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, [`breakdown`], `checks`);
the last lines of standard error give each number compared beside its
limit. Without CUDA, with fewer cards than the cell asks for, or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "edge_based_visual_odometry_tpu")


def set_process_env():
    """Before torch is imported: every build and kernel cache of the
    program in the checkout, at fixed paths (the port's own nvcc build is
    `build/torch_kernels/`), and one host thread for the CPU-side
    libraries: the frame loop is paced by one Python thread's launches,
    and idle worker threads only add to the host clock's spread."""
    for var, sub in (("TRITON_CACHE_DIR", "triton_cache"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "vo_bench" / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def forbidden_modules(modules=None):
    """Top-level names in `modules` (sys.modules) that the run must not
    hold, compared whole: the port's own name begins with the JAX
    package's."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def require_cards(n: int):
    """The card(s) the cell asks for, or SystemExit: a run never falls
    back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("vo_bench: no CUDA device; the benchmark runs on "
                         "the card only")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"vo_bench: the cell needs {n} cards, "
                         f"{torch.cuda.device_count()} visible")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(1)

    from vo_bench.harness import spec as SPEC
    cell = SPEC.load_cell(args.workload)
    require_cards(cell.chips)
    # the entry the window drives: `harness/<entry>_run.py`
    entry = importlib.import_module(f"vo_bench.harness.{cell.entry}_run")
    result = entry.run(cell, args.seed, args.seconds, bool(args.trace),
                       T_START)
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"vo_bench: {bad} loaded in the measuring process")
    from vo_bench.harness import check as CHECK
    CHECK.print_checks(result["checks"])
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    set_process_env()
    main()
