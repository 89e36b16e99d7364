"""The `pair_step` entry: `build_sharded_pair_step` over the ranks of one
host, one card a rank, in a closed loop.

The process `run.py` runs is the supervisor. It opens no CUDA context:
it builds the kernel library once where the checkout has none (so that
the ranks do not race on `build/torch_kernels/`), then spawns the cell's
ranks, each of which starts its process group through the program's own
`init_distributed` (NCCL on the card, gloo on the CPU) from a `file://`
rendezvous under TMPDIR. It kills the whole group as soon as one rank
exits non-zero or the deadline passes, and names the rank: a run may
fail, it may not hang.

Each rank renders the whole lap on its own device in set-up (`PairCell`)
and hands the step its pairs as host uint8, as a dataset loader would.
Global step s (counted from the seed's start on the lap) takes the pairs
(k, k + 1) at lap positions k = s0 + s + stride * j, j = 0 .. 2R - 1,
dealt rank-major (rank r: j = 2r, 2r + 1); each is predicted by its
ground-truth relative pose, and its RANSAC seed comes from `--seed` and
the pair's global index.

The window: every rank runs the same number of steps, fixed before the
window from rank 0's warm-up rate (one broadcast), so that no collective
but the program's own runs in the timed steps. Only the pairs of the
steps that ended within `--seconds` on rank 0's clock count; a window
whose steps run out before `--seconds` is a failed run. A step's time on
rank 0 runs from handing it the pairs until the gathered poses are on
the host.

A reservoir sample of the loop's steps, drawn from the seed (the same on
every rank), keeps what the check (`pair_check.py`) compares: rank 0's
gathered rows and each rank's own block of its gathered output.
"""

from __future__ import annotations

import math
import multiprocessing
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import List, Optional

import numpy as np
import torch

from vo_bench.harness import frame_run as FRUN
from vo_bench.harness import spec as SPEC
from vo_bench.harness.frames import p95_ms, sync
from vo_bench.scene import render as RS

SAMPLE = 32          # global steps checked
POLL_S = 0.2         # how often the supervisor looks at its ranks
EXIT_GRACE_S = 30.0  # a rank's time to exit once every result is in


def pair_seed(seed: int, g: int) -> int:
    """The RANSAC seed of the run's global pair index `g`."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), int(g)])
    return int(ss.generate_state(1, np.uint32)[0] >> 1)


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------

class PairCell:
    """One rank's share of the cell: its device, the lap rendered on it,
    the sharded pair step, the loop's step counter and the sampled
    records."""

    def __init__(self, cell: SPEC.Cell, seed: int, device, mesh,
                 scene: Optional[RS.Scene] = None):
        from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM

        traffic = cell.workload["traffic"]
        self.cell, self.seed, self.device = cell, int(seed), device
        self.rank, self.n_ranks = mesh.get_local_rank(), mesh.size()
        self.per_rank = int(traffic["pairs_per_rank"])
        self.stride = int(traffic["lap_stride"])
        self.rig = RS.Rig.from_config(cell.config["rig"])
        self.scene = (RS.make_scene(self.rig, cell.scene, device)
                      if scene is None else scene)
        self.n = self.scene.left.shape[0]
        self.s0 = self.seed % self.n         # the seed's start on the lap
        self.rel = [relative_pose(self.scene, k, (k + 1) % self.n)
                    for k in range(self.n)]
        self.step = PM.build_sharded_pair_step(
            SPEC.stereo_rig(cell.config), SPEC.vo_config(cell.config, seed),
            mesh)
        self.s = 0                 # global steps run so far
        self.rng = np.random.default_rng(self.seed)
        self.records = {}          # reservoir slot -> record
        self.taken = 0             # steps offered to the reservoir

    def positions(self, s: int) -> List[int]:
        """Lap positions k of global step s's pairs, in rank-major
        order."""
        return [(self.s0 + s + self.stride * j) % self.n
                for j in range(self.per_rank * self.n_ranks)]

    def images(self, ks: List[int]):
        """This rank's (kf_l, kf_r, cf_l, cf_r) for its pairs at `ks`:
        the host uint8 frames (k, k + 1)."""
        sc, n = self.scene, self.n
        return ([sc.left[k] for k in ks], [sc.right[k] for k in ks],
                [sc.left[(k + 1) % n] for k in ks],
                [sc.right[(k + 1) % n] for k in ks])

    def inputs(self, s: int):
        ks_all = self.positions(s)
        lo = self.rank * self.per_rank
        ks = ks_all[lo:lo + self.per_rank]
        g0 = s * len(ks_all) + lo
        rel_R = np.stack([self.rel[k][0] for k in ks])
        rel_t = np.stack([self.rel[k][1] for k in ks])
        seeds = np.array([pair_seed(self.seed, g0 + i)
                          for i in range(len(ks))], np.int64)
        return (*self.images(ks), rel_R, rel_t, seeds), ks_all

    def run_step(self, keep: bool = False):
        """One global step; returns (host poses (B, 12) of the global
        batch, the step's seconds from handing it the pairs until those
        poses are on the host)."""
        args, ks_all = self.inputs(self.s)
        t0 = time.perf_counter()
        out = self.step(*args)
        host = torch.cat([out.R.reshape(-1, 9), out.t], 1).cpu().numpy()
        dt = time.perf_counter() - t0
        if keep:
            self._offer(ks_all, out)
        self.s += 1
        return host, dt

    def _offer(self, ks_all, out):
        """A reservoir sample of `SAMPLE` steps (each step of the loop
        equally likely; the same draws on every rank)."""
        i = self.taken
        self.taken += 1
        slot = i if i < SAMPLE else int(self.rng.integers(0, i + 1))
        if slot >= SAMPLE:
            return
        lo = self.rank * self.per_rank
        hi = lo + self.per_rank
        rows = dict(R=out.R, t=out.t, ratio=out.inlier_ratio,
                    n_kf=out.n_mates_kf, n_cf=out.n_mates_cf)
        rows = {k: v.cpu().numpy() for k, v in rows.items()}
        rec = dict(s=self.s, ks=ks_all,
                   own={k: v[lo:hi].copy() for k, v in rows.items()})
        if self.rank == 0:
            rec["rows"] = rows
        self.records[slot] = rec

    def warm_up(self, steps: int):
        for _ in range(steps):
            self.run_step()
        sync(self.device)

    def rate(self, steps: int) -> float:
        """Mean seconds a step over `steps` steps."""
        t0 = time.perf_counter()
        for _ in range(steps):
            self.run_step()
        return (time.perf_counter() - t0) / steps


def relative_pose(scene: RS.Scene, kf: int, cf: int):
    """The ground-truth relative pose kf -> cf, float32."""
    R = scene.R[cf] @ scene.R[kf].T
    t = scene.t[cf] - R @ scene.t[kf]
    return R.astype(np.float32), t.astype(np.float32)


def _agree(value: int, device) -> int:
    """Rank 0's `value` on every rank (one broadcast, before the
    window)."""
    import torch.distributed as dist
    x = torch.tensor([int(value)], dtype=torch.int64, device=device)
    dist.broadcast(x, src=0)
    return int(x.item())


def _counts():
    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
    from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM
    return dict(launches=dict(CB.LAUNCHES), exchanges=dict(PM.EXCHANGES))


def _reset_counts():
    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
    from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM
    CB.reset_launch_counts()
    PM.reset_exchanges()


def group_size(cell: SPEC.Cell) -> int:
    """The configuration's ranks, which the cell's traffic names too."""
    ranks = int(cell.config["deployment"]["ranks"])
    if ranks != int(cell.workload["traffic"]["ranks"]):
        raise SystemExit(f"{cell.name}: the traffic's ranks "
                         f"{cell.workload['traffic']['ranks']} are not the "
                         f"configuration's {ranks}")
    return ranks


def start_rank(rank: int, n_ranks: int, out_dir: str, device_kind: str):
    """This rank's process group (the program's own `init_distributed`)
    and device."""
    from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(1)
    store = os.path.join(out_dir, "store")
    mesh = PM.init_distributed(f"file://{store}", n_ranks, rank,
                               device=device_kind)
    return mesh, PM.local_device(mesh)


def rank_window(rank: int, n_ranks: int, out_dir: str, cell: SPEC.Cell,
                seed: int, seconds: float, trace: bool, wall_start: float,
                device_kind: str) -> dict:
    """One rank of a benchmark run: set-up, the window, with `trace` the
    synchronised step spans and the profiled slice; returns what the
    supervisor reduces."""
    from vo_bench.run import forbidden_modules

    mesh, dev = start_rank(rank, n_ranks, out_dir, device_kind)
    w = cell.workload["warmup"]
    pc = PairCell(cell, seed, dev, mesh)
    pc.warm_up(int(w["steps"]))
    dt = pc.rate(int(w["timed_steps"]))
    n_steps = _agree(math.ceil(float(cell.workload["window_margin"])
                               * seconds / dt) + 1, dev)
    sync(dev)
    _reset_counts()
    spans = {"pair_step": []} if trace and rank == 0 else None
    if spans is not None:
        real = pc.step

        def timed(*a):
            sync(dev)
            t0 = time.perf_counter()
            out = real(*a)
            sync(dev)
            spans["pair_step"].append(time.perf_counter() - t0)
            return out
        pc.step = timed
    setup_s = time.time() - wall_start
    times, failed, short = [], 0, False
    t_end = time.perf_counter() + seconds
    for _ in range(n_steps):
        host, step_s = pc.run_step(keep=True)
        if rank == 0 and time.perf_counter() <= t_end:
            times.append(step_s)
            failed += int((~np.isfinite(host).all(1)).sum())
    if rank == 0 and time.perf_counter() <= t_end:
        short = True
    res = dict(rank=rank, steps=n_steps, warm_step_s=dt, counts=_counts(),
               records=pc.records, batch=pc.per_rank * n_ranks,
               device=FRUN.device_info(n_ranks, dev),
               forbidden=forbidden_modules())
    if rank == 0:
        res.update(times=times, failed=failed, short=short, setup_s=setup_s)
    if trace:
        if spans is not None:
            pc.step = real
            res["spans"] = spans
        res.update(traced_slice(pc, dev, rank))
    return res


def traced_slice(pc: PairCell, device, rank: int) -> dict:
    """The workload's `trace_steps` steps on every rank under the
    profiler with the program's spans on: each rank's `program_spans`;
    rank 0's device trace too (busy time, window, breakdown)."""
    from edge_based_visual_odometry_tpu_torch.utils import timing
    from vo_bench.harness import spans as SP
    from vo_bench.harness import trace as TR

    steps = int(pc.cell.workload["trace_steps"])

    def run():
        with timing.spans_on():
            for _ in range(steps):
                pc.run_step()
        return steps
    events, window_s, units = SP.profile_events(run, device)
    out = {"program_spans": SP.reduce(events, window_s, units)}
    if rank == 0:
        tr = TR.parse(events)
        tr.update(window_s=window_s, units=units)
        out["trace"] = tr
    return out


def rank_episodes(rank: int, n_ranks: int, out_dir: str, cell: SPEC.Cell,
                  episodes: List[dict], device_kind: str) -> List[dict]:
    """One rank of a calibration: for each episode (`seed`, `steps`, and
    optionally a `fault` of `pair_faults.py` and `vo` fields of
    `VOConfig`) the fault planted, a fresh step on the lap rendered once,
    the warm-up, then `steps` loop steps, each kept for the check."""
    import copy

    from vo_bench.harness import pair_faults as PF

    mesh, dev = start_rank(rank, n_ranks, out_dir, device_kind)
    scene, out = None, []
    for ep in episodes:
        undo = []

        def plant(obj, name, value):
            undo.append((obj, name, getattr(obj, name)))
            setattr(obj, name, value)
        c = copy.deepcopy(cell)
        c.config.setdefault("vo_config", {}).update(ep.get("vo", {}))
        try:
            if ep.get("fault"):
                PF.FAULTS[ep["fault"]](plant)
            pc = PairCell(c, ep["seed"], dev, mesh, scene)
            scene = pc.scene
            pc.warm_up(int(c.workload["warmup"]["steps"]))
            _reset_counts()
            for _ in range(int(ep["steps"])):
                pc.run_step(keep=True)
            sync(dev)
            out.append(dict(rank=rank, steps=int(ep["steps"]),
                            counts=_counts(), records=pc.records))
        finally:
            for obj, name, value in reversed(undo):
                setattr(obj, name, value)
        del pc
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def episodes(cell: SPEC.Cell, eps: List[dict], device=None,
             deadline_s: float = 1800.0) -> List[dict]:
    """Each episode's numbers (`pair_check.run_numbers`) for the program,
    and the control's `pair_px`, from one group of ranks."""
    from vo_bench.harness import pair_check as PCHK

    require_program()
    kind = "cuda" if device is None else torch.device(device).type
    build_kernels(kind)
    n_ranks = group_size(cell)
    ranks = supervise(rank_episodes, n_ranks, (cell, eps, kind), deadline_s)
    out = []
    for i, ep in enumerate(eps):
        per = [r[i] for r in ranks]
        control = PCHK.run_numbers(cell, per, False, torch.bfloat16)
        out.append(dict(ep, program=PCHK.run_numbers(cell, per,
                                                     kind == "cuda"),
                        control_pair_px=control["pair_px"]))
    return out


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

def _rank_entry(target, rank, n_ranks, out_dir, args):
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        res = target(rank, n_ranks, out_dir, *args)
        with open(path + ".tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(path + ".tmp", path + ".pkl")
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)          # at once: the others may wait in a collective
    try:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    finally:
        os._exit(0)


class RankFailed(RuntimeError):
    """A rank exited non-zero, or the group outlived its deadline."""


def supervise(target, n_ranks: int, args=(), deadline_s: float = 600.0,
              out_dir: Optional[str] = None) -> list:
    """Run `target(rank, n_ranks, out_dir, *args)` in `n_ranks` spawned
    processes and return each rank's result. The first rank to exit
    non-zero, or the deadline, kills every rank still running and raises
    `RankFailed` naming the rank(s) and the failing rank's traceback."""
    own = out_dir is None
    out_dir = tempfile.mkdtemp(prefix="vo_bench_ranks_") if own else out_dir
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(target, r, n_ranks, out_dir, args),
                         daemon=True) for r in range(n_ranks)]
    t_dead = time.monotonic() + deadline_s
    t_done = None

    def err(r):
        p = os.path.join(out_dir, f"rank{r}.err")
        return open(p).read() if os.path.exists(p) else ""

    def kill_all():
        started = [p for p in procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(10)

    try:
        for p in procs:
            p.start()
        while True:
            codes = [p.exitcode for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                kill_all()
                raise RankFailed(
                    f"rank {bad[0]} of {n_ranks} exited with code "
                    f"{codes[bad[0]]}; the group was stopped:\n"
                    f"{err(bad[0])}")
            have = [os.path.exists(os.path.join(out_dir, f"rank{r}.pkl"))
                    for r in range(n_ranks)]
            if all(c == 0 for c in codes):
                break
            now = time.monotonic()
            if all(have):
                t_done = now if t_done is None else t_done
                if now - t_done > EXIT_GRACE_S:      # results in; teardown
                    kill_all()                        # hangs: not the work
                    break
            elif now > t_dead:
                late = [r for r, c in enumerate(codes) if c is None]
                kill_all()
                raise RankFailed(
                    f"rank(s) {late} of {n_ranks} still running after the "
                    f"{deadline_s:.0f} s deadline; the group was stopped")
            time.sleep(POLL_S)
        out = []
        for r in range(n_ranks):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        kill_all()
        if own:
            shutil.rmtree(out_dir, ignore_errors=True)


def require_program():
    """The program this entry measures: `mesh.EXCHANGES` and its reset
    (SystemExit, at once, where they are missing)."""
    from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM
    missing = [n for n in ("EXCHANGES", "reset_exchanges")
               if not hasattr(PM, n)]
    if missing:
        raise SystemExit(f"vo_bench: the program's parallel/mesh.py has no "
                         f"{', '.join(missing)}; the pair_step entry counts "
                         f"the pair step's collectives with them")


def build_kernels(device_kind: str):
    """The kernel library, built here once where the checkout has none,
    before any rank starts."""
    if device_kind == "cuda":
        from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
        CB.lib()


def deadline(cell: SPEC.Cell, seconds: float, trace: bool) -> float:
    d = cell.workload["deadline_s"]
    return (float(d["setup"]) + float(cell.workload["window_margin"])
            * seconds + float(d["after_window"])
            + (float(d["trace"]) if trace else 0.0))


def run(spec: SPEC.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device=None) -> dict:
    """The result of one run; `device` "cpu" runs gloo ranks on the CPU
    (the CPU tests' runs, never results), else each rank takes its card."""
    from vo_bench.harness import check as CHECK
    from vo_bench.harness import pair_check as PCHK

    require_program()
    kind = "cuda" if device is None else torch.device(device).type
    build_kernels(kind)
    n_ranks = group_size(spec)
    wall_start = time.time() - (time.perf_counter() - t_start)
    try:
        ranks = supervise(rank_window, n_ranks,
                          (spec, seed, seconds, trace, wall_start, kind),
                          deadline(spec, seconds, trace))
    except RankFailed as e:
        raise SystemExit(f"vo_bench: {spec.name}: {e}")
    r0 = ranks[0]
    bad = sorted({m for r in ranks for m in r["forbidden"]})
    if bad:
        raise SystemExit(f"vo_bench: {bad} loaded in a rank")
    if r0["short"]:
        raise SystemExit(
            f"vo_bench: {spec.name}: the {r0['steps']} steps fixed from the "
            f"warm-up rate ({1e3 * r0['warm_step_s']:.2f} ms a step) ended "
            f"before the {seconds:g} s window")
    print(f"vo_bench: {spec.name}: {r0['steps']} steps on each of "
          f"{n_ranks} ranks, {len(r0['times'])} of them within the window on "
          f"rank 0; warm-up {1e3 * r0['warm_step_s']:.2f} ms a step",
          file=sys.stderr)
    batch = r0["batch"]
    result = {"correct": False, "attempted": batch * len(r0["times"]),
              "failed": r0["failed"]}
    if trace:
        ctx = dict(spans=r0.get("spans"), trace=r0["trace"],
                   pair_spans=[r["program_spans"] for r in ranks])
        metrics = SPEC.per_layer_metrics(spec, ctx)
    else:
        metrics = {
            "frames_per_s": {"value": batch * len(r0["times"]) / seconds,
                             "unit": "frames/s"},
            "frame_ms_p95": {"value": p95_ms(r0["times"]), "unit": "ms"},
            "setup_s": {"value": r0["setup_s"], "unit": "s"}}
        metrics = {k: v for k, v in metrics.items()
                   if any(m["name"] == k for m in spec.end_to_end)}
    device = dict(r0["device"])
    device["memory_peak_bytes"] = max(r["device"]["memory_peak_bytes"]
                                      for r in ranks)
    if trace:
        device.update(busy_s=r0["trace"]["busy_s"],
                      window_s=r0["trace"]["window_s"])
    numbers = PCHK.run_numbers(spec, ranks, kind == "cuda")
    correct, checks = CHECK.judge(numbers, spec.workload.get("check", {}),
                                  r0["failed"])
    missing = numbers["kernels_not_launched"]
    checks["kernels_not_launched"] = {"value": missing, "limit": 0}
    correct = correct and missing == 0
    result.update(correct=correct, metrics=metrics, device=device)
    if trace:
        result["breakdown"] = r0["trace"]["breakdown"]
    result["checks"] = checks
    return result

