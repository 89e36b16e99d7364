"""Device-mesh scaling of the VO pipeline on torch.distributed.

Port of `edge_based_visual_odometry_tpu/parallel/mesh.py`. The reference
shards one jitted program over a `jax.sharding.Mesh` and lets XLA insert
the collectives; here each device has a process of its own (a rank, as
`torchrun --nproc_per_node=N` starts them) and the collectives are
written out. A 1-D `DeviceMesh` with axis "frame" spans the ranks:

  - frame-pair data parallelism: each rank runs the full pair step
    (undistort, Sobel + TOED with the gradient-field kernel, the stereo
    cascade with the epipolar GN kernel, temporal quads, RANSAC pose) on
    its own pairs, with no cross-pair dependency. The per-pair rows are
    all-gathered and the mean inlier ratio is all-reduced, so every rank
    holds the global batch, as the reference's global array does;
  - windowed BA (models/window_ba.py, `mesh=`) splits the landmark axis
    over the same ranks and all-reduces the Schur-complement sums.

On the card the process group is NCCL; gloo is used only when the caller
asks for the CPU.
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from edge_based_visual_odometry_tpu_torch.config import StereoRig, VOConfig
from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
from edge_based_visual_odometry_tpu_torch.models.types import resolve_device
from edge_based_visual_odometry_tpu_torch.utils.timing import span

# the reduced capacities of the reference's small dryrun
DRYRUN_CFG = dict(max_edges=512, max_candidates=8, gather_slots=32,
                  max_mates=256, max_refine_pairs=512, max_quad_candidates=8,
                  quad_gather_slots=80, ransac_max_iterations=64,
                  gn_max_iter=3)

# the sharded pair step's collectives on this rank since the last
# reset_exchanges(): the calls of each, and the bytes this rank put in
EXCHANGES = {"all_reduce": 0, "all_gather": 0, "bytes": 0}


def reset_exchanges():
    for k in EXCHANGES:
        EXCHANGES[k] = 0


def make_mesh(n_devices: Optional[int] = None, axis: str = "frame",
              device="cuda") -> DeviceMesh:
    """1-D mesh over the first `n_devices` ranks of the process group (all
    of them by default); its device type is that of `device`. Unlike the
    reference, whose devices are visible without a distributed runtime,
    the process group must exist (`init_distributed`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "init_distributed() first (one process per "
                           "device)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        # silent truncation would e.g. make analyze_production_memory
        # report an 8x workload as "per-device"
        raise ValueError(
            f"requested a {n}-device mesh but the process group has {world} "
            f"ranks (start one process per device, e.g. torchrun "
            f"--nproc_per_node={n})")
    dev_type = torch.device(device).type
    if n == world:
        return init_device_mesh(dev_type, (n,), mesh_dim_names=(axis,))
    return DeviceMesh(dev_type, torch.arange(n), mesh_dim_names=(axis,))


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device="cuda") -> DeviceMesh:
    """Start this process's rank and return the frame mesh over every rank.

    `coordinator_address`: "host:port" of rank 0 (or any init_method URL,
    e.g. "file:///path"), with `num_processes` and `process_id`. With all
    three None, torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT) is read; without it the process is a world
    of one. The backend is NCCL for `device="cuda"` (its absence is an
    error) and gloo for `device="cpu"`. On the card, rank r of a host uses
    cuda:LOCAL_RANK. A process group that already exists is kept.

    The per-pair pipeline has no cross-pair dependencies, so the same
    `build_sharded_pair_step` serves one card, one host and many hosts:
    each rank renders or decodes only its own pairs.
    """
    dev_type = torch.device(device).type
    if dev_type == "cuda":
        resolve_device("cuda")
        if not dist.is_nccl_available():
            raise RuntimeError("init_distributed: this PyTorch has no NCCL; "
                               "a CUDA mesh needs it")
        backend = "nccl"
    elif dev_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: device {device!r}")
    if not dist.is_initialized():
        if coordinator_address is not None:
            if num_processes is None or process_id is None:
                raise ValueError("init_distributed: a coordinator address "
                                 "needs num_processes and process_id")
            url = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
            kw = dict(init_method=url, world_size=num_processes,
                      rank=process_id)
            local = int(os.environ.get("LOCAL_RANK", process_id))
        elif "WORLD_SIZE" in os.environ:
            kw = dict(init_method="env://")
            local = int(os.environ.get("LOCAL_RANK", 0))
        else:
            kw = dict(store=dist.HashStore(), world_size=1, rank=0)
            local = 0
        if backend == "nccl":
            torch.cuda.set_device(local % torch.cuda.device_count())
        dist.init_process_group(backend, **kw)
    return make_mesh(device=device)


@contextlib.contextmanager
def _process_group(device):
    """The existing process group, or a new one (torchrun's or a world of
    one) that is destroyed on exit."""
    created = not dist.is_initialized()
    if created:
        init_distributed(device=device)
    try:
        yield
    finally:
        if created:
            dist.destroy_process_group()


def local_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its CUDA device on a CUDA mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class PairStepOutput(NamedTuple):
    R: torch.Tensor              # (B, 3, 3) relative poses KF->CF
    t: torch.Tensor              # (B, 3)
    inlier_ratio: torch.Tensor   # (B,)
    n_mates_kf: torch.Tensor     # (B,) int32
    n_mates_cf: torch.Tensor
    mean_inlier_ratio: torch.Tensor  # () all-reduced mean over the mesh


def build_pair_step(rig: StereoRig, cfg: VOConfig, device="cuda"):
    """Per-pair full pipeline: (kf_left, kf_right, cf_left, cf_right,
    rel_R_init, rel_t_init, seed) -> (R, t, inlier_ratio, n_mates_kf,
    n_mates_cf). Composed of `build_stereo_step` (undistortion where the
    rig needs it, TOED, the stereo cascade) on each stereo pair and
    `build_temporal_step` (quads, lifting, RANSAC pose, no GT)."""
    device = resolve_device(device)
    stereo = PL.build_stereo_step(rig, cfg, device)
    temporal = PL.build_temporal_step(rig, cfg, device, use_gt=False)

    def one_pair(kf_l, kf_r, cf_l, cf_r, rel_R0, rel_t0, seed):
        kf = stereo(kf_l, kf_r)
        cf = stereo(cf_l, cf_r)
        tr = temporal(kf.mates, kf.frame, cf.mates, cf.frame,
                      torch.as_tensor(rel_R0, dtype=torch.float32,
                                      device=device),
                      torch.as_tensor(rel_t0, dtype=torch.float32,
                                      device=device), int(seed))
        return (tr.R, tr.t, tr.inlier_ratio, kf.mates.count,
                cf.mates.count)

    return one_pair


def _all_reduce_sum(x: torch.Tensor, group) -> None:
    EXCHANGES["all_reduce"] += 1
    EXCHANGES["bytes"] += x.nbytes
    dist.all_reduce(x, group=group)


def _all_gather_rows(x: torch.Tensor, group, n_ranks: int) -> torch.Tensor:
    EXCHANGES["all_gather"] += 1
    EXCHANGES["bytes"] += x.nbytes
    parts = [torch.empty_like(x) for _ in range(n_ranks)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def build_sharded_pair_step(rig: StereoRig, cfg: VOConfig,
                            mesh: DeviceMesh):
    """The batched pair step over the mesh. Each rank calls it with its own
    pairs, the same number on every rank (its rank-major block of the
    global batch: leading axis of every argument); every rank gets back
    the PairStepOutput of the global batch, and `mean_inlier_ratio` is an
    all-reduce (sum over the ranks, divided by the global batch).

    A call is the span `vo/pair_step`: `vo/pair.work`, the rank's pairs
    one after another, then `vo/pair.exchange`, one all-reduce of (the
    ratios' sum, the pair count), the host's read of the count
    (`vo/wait.pair_count`: the rank's queued work and the wait for the
    slowest rank end there) and five all-gathers (R, t, ratio, the two
    mate counts). `EXCHANGES` counts each collective and its bytes."""
    device = local_device(mesh)
    one_pair = build_pair_step(rig, cfg, device)
    group = mesh.get_group()
    n_ranks = mesh.size()

    def step(kf_l, kf_r, cf_l, cf_r, rel_R0, rel_t0, seeds):
        with span("pair_step"):
            with span("pair.work"):
                rows = [one_pair(*(a[i] for a in (kf_l, kf_r, cf_l, cf_r,
                                                  rel_R0, rel_t0, seeds)))
                        for i in range(len(seeds))]
                R, t, ratio, n_kf, n_cf = (torch.stack(c)
                                           for c in zip(*rows))
            with span("pair.exchange"):
                total = torch.stack([ratio.sum(), torch.tensor(
                    float(len(rows)), device=device)])
                _all_reduce_sum(total, group)
                with span("wait.pair_count"):
                    count = int(total[1])
                if count != len(rows) * n_ranks:
                    raise ValueError(
                        f"sharded pair step: {len(rows)} pairs on this "
                        f"rank, {count} over {n_ranks} ranks; every rank "
                        f"takes the same number")
                R, t, ratio, n_kf, n_cf = (
                    _all_gather_rows(x, group, n_ranks)
                    for x in (R, t, ratio, n_kf.to(torch.int32),
                              n_cf.to(torch.int32)))
        return PairStepOutput(R, t, ratio, n_kf, n_cf, total[0] / total[1])

    return step


def analyze_production_memory(n_devices: int = 1, h: int = 376,
                              w: int = 1241,
                              cfg: Optional[VOConfig] = None) -> dict:
    """Run one sharded pair step at PRODUCTION shapes (default: KITTI
    376x1241, `VOConfig()`), one frame pair per device, on the card, and
    report this rank's device memory in MiB.

    The reference answers the same question without running: an XLA
    compile-only memory analysis against a 16 GiB TPU chip. Here the keys
    mean: `argument_mib` / `output_mib` the bytes of the inputs handed
    over and of the global outputs returned (as in the reference);
    `total_mib` the measured peak of the step over what was allocated
    before it (`torch.cuda.max_memory_allocated` after
    `reset_peak_memory_stats`; the reference's total is a static sum);
    `temp_mib` that peak less the arguments and outputs; `peak_mib` the
    absolute peak, `device_mib` the card's memory and `fits_hbm` whether
    the peak stays under it (the reference compares with a fixed budget).
    Uses the existing process group, or makes one for the call.
    """
    from edge_based_visual_odometry_tpu_torch.io import synthetic as S

    cfg = cfg or VOConfig()
    with _process_group("cuda"):
        mesh = make_mesh(n_devices, device="cuda")
        dev = local_device(mesh)
        seq = S.make_sequence(n_frames=2, h=h, w=w)
        step = build_sharded_pair_step(seq.rig, cfg, mesh)
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        f0, f1 = seq.frames
        args = [torch.as_tensor(a, dtype=torch.float32, device=dev)[None]
                for a in (f0.left, f0.right, f1.left, f1.right)]
        args += [torch.eye(3, device=dev)[None],
                 torch.zeros(1, 3, device=dev),
                 torch.zeros(1, dtype=torch.int32, device=dev)]
        out = step(*args)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        mib = float(2 ** 20)
        res = {
            "argument_mib": sum(a.nbytes for a in args) / mib,
            "output_mib": sum(o.nbytes for o in out) / mib,
            "total_mib": (peak - base) / mib,
        }
        res["temp_mib"] = (res["total_mib"] - res["argument_mib"]
                           - res["output_mib"])
        res["peak_mib"] = peak / mib
        res["device_mib"] = torch.cuda.get_device_properties(
            dev).total_memory / mib
        res["fits_hbm"] = res["peak_mib"] < res["device_mib"]
    return res


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def dryrun_multichip(n_devices: int, h: int = 64, w: int = 96,
                     device="cuda") -> None:
    """Run the full sharded pair step on an n-rank mesh with tiny shapes
    (one pair per rank), then a 3-frame VO loop whose windowed BA
    (ba_window=2) is split over the same mesh. Every rank of the mesh
    calls it; uses the existing process group, or makes one for the
    call."""
    from edge_based_visual_odometry_tpu_torch.io import synthetic as S

    cfg = VOConfig(**DRYRUN_CFG)
    with _process_group(device):
        mesh = make_mesh(n_devices, device=device)
        if mesh.get_coordinate() is None:
            return                     # this rank is outside the mesh
        dev = local_device(mesh)
        seq = S.make_sequence(n_frames=2, h=h, w=w)
        step = build_sharded_pair_step(seq.rig, cfg, mesh)
        f0, f1 = seq.frames
        rank = mesh.get_local_rank()
        out = step(f0.left[None], f0.right[None], f1.left[None],
                   f1.right[None], np.eye(3, dtype=np.float32)[None],
                   np.zeros((1, 3), np.float32),
                   np.array([rank], np.int32))
        _check(tuple(out.R.shape) == (n_devices, 3, 3),
               f"R of shape {tuple(out.R.shape)}")
        _check(bool(torch.isfinite(out.mean_inlier_ratio)),
               "non-finite mean inlier ratio")

        # the sharded windowed BA: a 3-frame VO loop with ba_window=2 runs
        # the in-loop solve on the mesh, not just the pair step
        pipe = PL.VOPipeline(rig=seq.rig, cfg=cfg, device=dev, ba_window=2,
                             ba_mesh=mesh)
        for f in S.make_sequence(n_frames=3, h=h, w=w).frames:
            pipe.run_frame(f.left, f.right)
        _check(len(pipe.trajectory) == 3, "trajectory length")
        for pose in pipe.trajectory:
            _check(bool(torch.isfinite(pose.R).all()
                        and torch.isfinite(pose.t).all()),
                   "non-finite pose")
        _check(bool(pipe.wba.kf_poses), "BA window never populated")
