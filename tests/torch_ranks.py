"""Spawned torch.distributed ranks for the port's multi-device tests, and
the corridor keyframe chain of tests/test_window_ba_drift.py (numpy only).

`spawn(worker, n_ranks, tmp_path, *args)` starts `n_ranks` processes with
the spawn method, joins them within a timeout of their own (a hung
collective fails the test instead of the whole suite) and returns each
rank's result, or raises RuntimeError. Each rank joins a gloo group on a
FileStore under `tmp_path` (unless `init=False`: the worker then starts
the group itself) and calls `worker(rank, n_ranks, *args)`. Workers live here, not in the
test files, so that a rank imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 120.0


def _entry(worker, rank, n_ranks, store, out_dir, init, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}")
    try:
        if init:
            from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM
            PM.init_distributed(f"file://{store}", n_ranks, rank,
                                device="cpu")
        res = worker(rank, n_ranks, *args)
        with open(path + ".pkl", "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(worker, n_ranks, tmp_path, *args, init=True,
          timeout=RANK_TIMEOUT_S):
    out_dir = str(tmp_path / f"ranks_{worker.__name__}_{n_ranks}")
    os.makedirs(out_dir)
    store = os.path.join(out_dir, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(worker, r, n_ranks, store,
                                              out_dir, init, args))
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errs = {}
    for r in range(n_ranks):
        e = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(e):
            errs[r] = open(e).read()
    if hung:
        raise RuntimeError(f"ranks {hung} of {n_ranks} still running after "
                           f"{timeout:.0f} s; errors of the others: {errs}")
    codes = [p.exitcode for p in procs]
    if errs or any(codes):
        raise RuntimeError(f"rank exit codes {codes}: {errs}")
    out = []
    for r in range(n_ranks):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# --------------------------------------------------------------------------
# the corridor keyframe chain (tests/test_window_ba_drift.py, numpy only)
# --------------------------------------------------------------------------

K_CAM = np.array([[300.0, 0.0, 160.0],
                  [0.0, 300.0, 120.0],
                  [0.0, 0.0, 1.0]], np.float32)
W, H = 320, 240


class FakeMates:
    """Just the StereoMates fields add_keyframe reads (models/types.py)."""

    def __init__(self, x, y, theta, gamma, valid):
        self.left_x = np.asarray(x, np.float32)
        self.left_y = np.asarray(y, np.float32)
        self.left_theta = np.asarray(theta, np.float32)
        self.gamma = np.asarray(gamma, np.float32)
        self.valid = np.asarray(valid, bool)
        self.count = np.int32(len(x))


def _rot(axis, deg):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.radians(deg)
    Kx = np.array([[0, -axis[2], axis[1]],
                   [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * Kx + (1 - np.cos(a)) * (Kx @ Kx)


def make_corridor(n_kf=24, n_lm=400, seed=3):
    """GT world->cam poses walking down +z, landmarks ahead of the camera,
    per-KF observations (slot == landmark id), and a NOISY relative-pose
    chain with enough per-step error to accumulate visible drift."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-8, 8, n_lm),
                  rng.uniform(-5, 5, n_lm),
                  rng.uniform(2.0, 2.0 + 0.35 * n_kf + 20, n_lm)], 1)
    frames, poses_gt, rels_noisy = [], [], []
    prev_T = None
    for k in range(n_kf):
        C = np.array([0.05 * np.sin(0.4 * k), 0.0, 0.35 * k])
        R = _rot([0, 1, 0], 1.5 * np.sin(0.3 * k))    # gentle yaw wiggle
        t = -R @ C
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        poses_gt.append(T)
        Xc = X @ R.T + t
        uvw = Xc @ K_CAM.T
        uv = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-9)
        valid = (Xc[:, 2] > 1.0) & (uv[:, 0] > 5) & (uv[:, 0] < W - 5) \
            & (uv[:, 1] > 5) & (uv[:, 1] < H - 5)
        uv_meas = uv + rng.normal(0, 0.2, uv.shape)
        gamma = Xc + rng.normal(0, 0.03, Xc.shape)      # stereo triang noise
        theta = rng.uniform(0, np.pi, n_lm)
        frames.append(FakeMates(uv_meas[:, 0], uv_meas[:, 1], theta,
                                gamma, valid))
        if prev_T is not None:
            rel_gt = T @ np.linalg.inv(prev_T)
            dR = _rot(rng.normal(size=3), rng.normal(0, 0.45))
            dt = rng.normal(0, 0.025, 3)
            rel = rel_gt.copy()
            rel[:3, :3] = dR @ rel_gt[:3, :3]
            rel[:3, 3] = rel_gt[:3, 3] + dt
            rels_noisy.append(rel)
        prev_T = T
    return X, poses_gt, frames, rels_noisy


def ate(traj, poses_gt):
    def center(T):
        return -T[:3, :3].T @ T[:3, 3]
    err = [np.linalg.norm(center(a) - center(b))
           for a, b in zip(traj, poses_gt)]
    return float(np.sqrt(np.mean(np.square(err))))


def run_chain(frames, rels_noisy, poses_gt, wba):
    """Incremental odometry as VOPipeline does it: compose the noisy
    relative pose onto the latest (BA-corrected) estimate, register the
    keyframe, then let BA refresh the newest pose."""
    from edge_based_visual_odometry_tpu_torch.geometry import Pose

    def pose(T):
        return Pose(torch.as_tensor(T[:3, :3], dtype=torch.float32),
                    torch.as_tensor(T[:3, 3], dtype=torch.float32))

    links = np.arange(len(frames[0].left_x))
    est = [poses_gt[0].copy()]
    if wba is not None:
        wba.add_keyframe(frames[0], pose(est[0]))
    for k in range(1, len(frames)):
        T = rels_noisy[k - 1] @ est[-1]
        if wba is None:
            est.append(T)
            continue
        wba.add_keyframe(frames[k], pose(T), links)
        out = wba.run()
        if out is not None:
            poses, _ = out
            T = np.eye(4)
            T[:3, :3] = poses[-1].R.cpu().numpy()
            T[:3, 3] = poses[-1].t.cpu().numpy()
        est.append(T)
    return est


# --------------------------------------------------------------------------
# rank workers
# --------------------------------------------------------------------------

def _small_pairs(n_pairs, h=64, w=96):
    from edge_based_visual_odometry_tpu_torch.io import synthetic as S
    seq = S.make_sequence(n_frames=2, h=h, w=w)
    f0, f1 = seq.frames

    def tile(img):
        return np.broadcast_to(np.asarray(img, np.float32),
                               (n_pairs, h, w)).copy()

    return seq.rig, [tile(f0.left), tile(f0.right), tile(f1.left),
                     tile(f1.right),
                     np.broadcast_to(np.eye(3, dtype=np.float32),
                                     (n_pairs, 3, 3)).copy(),
                     np.zeros((n_pairs, 3), np.float32)]


def pair_step_worker(rank, n_ranks, n_global):
    """The sharded pair step on this rank's block of a global batch, with
    identical seeds and with distinct ones; rank 0 also runs the
    single-process loop over the global batch."""
    from edge_based_visual_odometry_tpu_torch.config import VOConfig
    from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM

    cfg = VOConfig(**PM.DRYRUN_CFG)
    rig, args = _small_pairs(n_global)
    mesh = PM.make_mesh(device="cpu")
    step = PM.build_sharded_pair_step(rig, cfg, mesh)
    b = n_global // n_ranks
    sl = slice(rank * b, (rank + 1) * b)
    res = {}
    for name, seeds in (("same", np.zeros(n_global, np.int32)),
                        ("distinct", np.arange(n_global, dtype=np.int32))):
        out = step(*(a[sl] for a in args), seeds[sl])
        res[name] = {k: v.numpy() for k, v in out._asdict().items()}
        if rank == 0:
            one = PM.build_pair_step(rig, cfg, "cpu")
            rows = [one(*(a[i] for a in args), seeds[i])
                    for i in range(n_global)]
            res[name + "_single"] = [
                torch.stack(c).numpy() for c in zip(*rows)]
    return res


def window_ba_worker(rank, n_ranks, device="cpu", nccl_store=None):
    """The 8-keyframe corridor chain with the BA split over the ranks, its
    tensors on `device` (the group is gloo); rank 0 also runs it on one
    device. With `nccl_store` (spawn with init=False) the rank starts an
    NCCL group from that FileStore and uses a card of its own."""
    from edge_based_visual_odometry_tpu_torch.models.window_ba import (
        WindowBA, WindowBAConfig)
    from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM

    if nccl_store is None:
        mesh = PM.make_mesh(device="cpu")
    else:
        mesh = PM.init_distributed(f"file://{nccl_store}", n_ranks, rank,
                                   device="cuda")
        device = PM.local_device(mesh)
    _, poses_gt, frames, rels = make_corridor()
    cfg = WindowBAConfig(window=6, max_landmarks=512, max_obs=4096,
                         n_iters=4)
    res = {"device": str(device),
           "sharded": run_chain(frames[:8], rels[:7], poses_gt[:8],
                                WindowBA(K_CAM, cfg, mesh=mesh,
                                         device=device))}
    if rank == 0:
        res["single"] = run_chain(frames[:8], rels[:7], poses_gt[:8],
                                  WindowBA(K_CAM, cfg, device=device))
    return res


def dryrun_worker(rank, n_ranks):
    from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM

    PM.dryrun_multichip(n_ranks, device="cpu")
    try:
        PM.make_mesh(n_ranks + 1, device="cpu")
        too_many = "no error"
    except ValueError as e:
        too_many = str(e)
    sub = PM.make_mesh(1, device="cpu")
    return {"too_many": too_many, "sub_size": sub.size(),
            "sub_coord": sub.get_coordinate()}


def multihost_worker(rank, n_ranks, store):
    """The harness as each rank of a multi-host launch runs it: it starts
    the group itself from the coordinator flags."""
    from scripts.run_multihost_torch import main

    return main(["--steps", "1", "--size", "small", "--device", "cpu",
                 "--coordinator", f"file://{store}",
                 "--num_processes", str(n_ranks),
                 "--process_id", str(rank)])


def pair_spans_worker(rank, n_ranks):
    """One pair a rank through the sharded step: twice with spans off
    (the collectives counted), then once with spans on under the
    profiler; returns the counts, the outputs and the trace's `vo/`
    spans as (name, start, end)."""
    import json
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from edge_based_visual_odometry_tpu_torch.config import VOConfig
    from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM
    from edge_based_visual_odometry_tpu_torch.utils import timing as T

    rig, args = _small_pairs(n_ranks)
    seeds = np.arange(n_ranks, dtype=np.int32)
    mine = [a[rank:rank + 1] for a in args] + [seeds[rank:rank + 1]]
    step = PM.build_sharded_pair_step(rig, VOConfig(**PM.DRYRUN_CFG),
                                      PM.make_mesh(device="cpu"))
    PM.reset_exchanges()

    def host(out):
        return {k: v.numpy() for k, v in out._asdict().items()}
    off = [host(step(*mine)) for _ in range(2)]
    counts = dict(PM.EXCHANGES)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with T.spans_on():
            on = host(step(*mine))
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    spans = sorted(((e["name"][len(T.SPAN_PREFIX):], float(e["ts"]),
                     float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e["name"].startswith(T.SPAN_PREFIX)),
                   key=lambda s: (s[1], -s[2]))
    return dict(counts=counts, off=off, on=on, spans=spans)


def failing_rank_worker(rank, n_ranks, out_dir, how, culprit):
    """A group for the benchmark's supervisor in which rank `culprit`
    raises (`how` "raises": the others wait on, as in a collective) or
    sleeps past any deadline (`how` "sleeps": the others finish)."""
    if rank == culprit:
        if how == "raises":
            raise RuntimeError(f"rank {rank} fails on purpose")
        time.sleep(3600)
    if how == "raises":
        time.sleep(3600)
    return rank
