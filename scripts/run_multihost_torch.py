"""Multi-host scaling harness for the port's sharded VO pair step.

Counterpart of `scripts/run_multihost.py` on torch.distributed: one
process per device, a 1-D frame mesh over every rank of every host
(`edge_based_visual_odometry_tpu_torch/parallel/mesh.py`). Same flags,
sizes and one-line JSON result, plus `--device`.

  One card, one process (a world of one):
    python scripts/run_multihost_torch.py --batch_per_device 1 --steps 4

  All cards of a host:
    torchrun --nproc_per_node=N scripts/run_multihost_torch.py

  Several hosts: torchrun on every host with --nnodes, --node_rank and
  --master_addr/--master_port of host 0; or one process per device with
      --coordinator HOST:PORT --num_processes N --process_id RANK

  CPU rehearsal (gloo; exactly the code path the tests run):
    torchrun --nproc_per_node=2 scripts/run_multihost_torch.py \
        --steps 2 --size small --device cpu

Protocol (docs/SCALING.md): steady-state frame pairs/s at a constant
batch_per_device for 1 device, 1 host, 2 hosts; scaling efficiency =
fps(N devices) / (N * fps(1 device)). Every rank renders only its own
pairs, so no process holds the global batch.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from edge_based_visual_odometry_tpu_torch.config import VOConfig  # noqa: E402
from edge_based_visual_odometry_tpu_torch.io import synthetic as S  # noqa: E402
from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM  # noqa: E402

SIZES = {
    # (h, w, cfg overrides) - 'small' for CPU rehearsal, 'kitti' for the card
    "small": (64, 96, PM.DRYRUN_CFG),
    "kitti": (376, 1241, {}),
}

ORDER = ("kf_l", "kf_r", "cf_l", "cf_r", "rel_R0", "rel_t0", "seeds")


def build_local_inputs(mesh, batch_per_device: int, h: int, w: int):
    """This rank's pairs: it renders only its own `batch_per_device` frame
    pairs (the global batch is rank-major), on its device."""
    dev = PM.local_device(mesh)
    n_local = batch_per_device
    seq = S.make_sequence(n_frames=2, h=h, w=w)
    f0, f1 = seq.frames

    def tile(img):
        return torch.as_tensor(np.asarray(img, np.float32), device=dev
                               ).expand(n_local, h, w).contiguous()

    local = {
        "kf_l": tile(f0.left), "kf_r": tile(f0.right),
        "cf_l": tile(f1.left), "cf_r": tile(f1.right),
        "rel_R0": torch.eye(3, device=dev).expand(n_local, 3, 3).contiguous(),
        "rel_t0": torch.zeros(n_local, 3, device=dev),
        "seeds": (torch.arange(n_local, dtype=torch.int32)
                  + mesh.get_local_rank() * n_local),
    }
    return local, seq.rig


def measure(step, arrays, steps: int, warmup: int = 1):
    """Mean seconds per step after `warmup` steps, and the last output;
    each timed step ends with the card idle."""
    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    args = [arrays[k] for k in ORDER]
    for _ in range(warmup):
        out = step(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        out = step(*args)
        sync()
    return (time.perf_counter() - t0) / steps, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None,
                    help="host:port (or init URL) of rank 0 (multi-host "
                         "without torchrun)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--batch_per_device", type=int, default=1)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--size", choices=sorted(SIZES), default="kitti")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (NCCL, default) or 'cpu' (gloo rehearsal)")
    args = ap.parse_args(argv)

    created = not dist.is_initialized()
    mesh = PM.init_distributed(args.coordinator, args.num_processes,
                               args.process_id, device=args.device)
    try:
        h, w, over = SIZES[args.size]
        cfg = VOConfig(**over)
        arrays, rig = build_local_inputs(mesh, args.batch_per_device, h, w)
        step = PM.build_sharded_pair_step(rig, cfg, mesh)
        dt, out = measure(step, arrays, args.steps)
        n_dev = mesh.size()
        hosts = [None] * n_dev
        dist.all_gather_object(hosts, socket.gethostname(),
                               group=mesh.get_group())
        fps = args.batch_per_device * n_dev / dt
        result = {
            "devices": n_dev,
            "hosts": len(set(hosts)),
            "batch_per_device": args.batch_per_device,
            "sec_per_step": round(dt, 4),
            "frame_pairs_per_s": round(fps, 3),
            "per_device_fps": round(fps / n_dev, 3),
            "mean_inlier_ratio": float(out.mean_inlier_ratio),
        }
        if mesh.get_local_rank() == 0:
            print(json.dumps(result))
        return result
    finally:
        if created:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
