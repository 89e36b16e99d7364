"""Multi-keyframe track chaining + sliding-window BA integration.

Port of `edge_based_visual_odometry_tpu/models/window_ba.py` (the numpy
bookkeeping carries over as is; the solve runs on the pipeline's device).
With a re-keyframing policy, consecutive keyframes are chained into
landmark TRACKS through the temporal quad matches (each quad links a KF
mate row to a CF mate index, and the CF becomes the next keyframe), and a
sliding window of keyframe poses + tracked 3D edge points is refined by
the Schur-complement BA of models/ba.py.

Host-side bookkeeping is fully VECTORIZED numpy over the fixed mate-slot
axis: at production density a keyframe carries ~24k mates per frame under
the `every_frame` policy, so per-slot Python loops would cost more than
the device solve. Track propagation is a scatter, track counting is
np.unique, and window assembly is one flattened (keyframe, slot) pass.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from edge_based_visual_odometry_tpu_torch import geometry as geom
from edge_based_visual_odometry_tpu_torch.models import ba as BA
from edge_based_visual_odometry_tpu_torch.models.types import (
    resolve_device, to_numpy as _np)
from edge_based_visual_odometry_tpu_torch.utils.timing import span


@dataclasses.dataclass
class WindowBAConfig:
    window: int = 5            # keyframes in the optimization window
    min_track_len: int = 2
    # Capacities sized for production density: with window=5 and ~24k
    # mates per keyframe, qualifying tracks reach ~max_mates and
    # observations ~window * mates.
    max_landmarks: int = 32768
    max_obs: int = 131072
    n_iters: int = 8
    damping: float = 1e-3
    huber: float = 2.0
    # weight of the stereo-triangulation landmark prior (1/sigma^2 with
    # sigma ~ 0.2 m); essential for 2-view low-parallax tracks
    prior_weight: float = 25.0
    # landmark depth sanity bounds (camera frame, meters at rig scale):
    # near-zero-disparity stereo triangulations explode to huge depths and
    # ill-condition the Schur solve (observed: NaN poses poisoning the
    # whole trajectory). Out-of-range observations are skipped.
    min_depth: float = 1e-2
    max_depth: float = 1e3


class WindowBA:
    """Accumulates keyframe poses + landmark tracks; runs windowed BA on
    `device`: "cuda" (the default) raises where no CUDA device exists,
    "cpu" is for callers that ask for it.

    `mesh`: optional 1-D `DeviceMesh` (parallel/mesh.py) whose ranks share
    the solve. Rank 0 of the mesh assembles the window problem on the host
    and broadcasts it, so ranks whose VO loops run on different devices
    solve one problem; each rank takes a contiguous block of the landmarks
    with their observations, and the Schur-complement sums are all-reduced
    once per iteration (models/ba.py). Every rank calls `run` once per
    keyframe, as VO loops in lockstep do, and gets the same poses back.
    The landmarks are never gathered: `run` returns only poses and costs.
    """

    def __init__(self, K_cam: np.ndarray, cfg: WindowBAConfig = WindowBAConfig(),
                 mesh=None, device="cuda"):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.K_cam = np.asarray(K_cam, np.float32)
        self._next_track = 0
        # per-keyframe arrays over the fixed mate-slot axis:
        self.kf_poses: List[np.ndarray] = []   # (4, 4) homogeneous world->cam
        self.kf_tid: List[np.ndarray] = []     # (M,) int64 track id, -1 = none
        self.kf_uv: List[np.ndarray] = []      # (M, 2) f32 left-image locs
        self.kf_normal: List[np.ndarray] = []  # (M, 2) f32 edge normals
        self.kf_gamma: List[np.ndarray] = []   # (M, 3) f64 camera-frame 3D

    def add_keyframe(self, mates, pose_est: geom.Pose,
                     links: Optional[np.ndarray] = None):
        """Register a new keyframe.

        mates: StereoMates of the new keyframe.
        pose_est: world->cam pose estimate of the new keyframe.
        links: optional (M_prev,) int array mapping the PREVIOUS keyframe's
          mate rows to this keyframe's mate indices (-1 = no link) - the
          best temporal quad candidates. Linked mates continue the track.
        """
        valid = _np(mates.valid)
        lx = _np(mates.left_x)
        ly = _np(mates.left_y)
        lt = _np(mates.left_theta)
        gamma = _np(mates.gamma, np.float64)
        # drop degenerate triangulations (see WindowBAConfig depth bounds)
        depth_ok = (np.isfinite(gamma).all(axis=-1)
                    & (gamma[:, 2] > self.cfg.min_depth)
                    & (gamma[:, 2] < self.cfg.max_depth))
        valid = valid & depth_ok
        M = valid.shape[0]

        tid = np.full(M, -1, np.int64)
        if links is not None and self.kf_tid:
            prev_tid = self.kf_tid[-1]
            links = np.asarray(links)
            src = (prev_tid >= 0) & (links >= 0)
            cf_slot = links[src]
            ok = valid[cf_slot]
            # scatter: ascending-prev-slot order, last write wins (the
            # dict version iterated prev insertion order; collisions are
            # two prev tracks claiming one CF mate - either is a valid
            # continuation)
            tid[cf_slot[ok]] = prev_tid[src][ok]
        new_mask = valid & (tid < 0)
        n_new = int(new_mask.sum())
        tid[new_mask] = self._next_track + np.arange(n_new)
        self._next_track += n_new

        R = _np(pose_est.R, np.float64)
        t = _np(pose_est.t, np.float64)
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        self.kf_poses.append(T)
        self.kf_tid.append(tid)
        self.kf_uv.append(np.stack([lx, ly], -1).astype(np.float32))
        # edge normal (perpendicular to the edge direction)
        self.kf_normal.append(
            np.stack([-np.sin(lt), np.cos(lt)], -1).astype(np.float32))
        self.kf_gamma.append(gamma)

        w = self.cfg.window
        if len(self.kf_poses) > w:
            self.kf_poses = self.kf_poses[-w:]
            self.kf_tid = self.kf_tid[-w:]
            self.kf_uv = self.kf_uv[-w:]
            self.kf_normal = self.kf_normal[-w:]
            self.kf_gamma = self.kf_gamma[-w:]

    def run(self):
        """Assemble + solve the window problem. Returns
        (poses_w2c list of geom.Pose, info dict) or None if the window is
        too small. info includes host-assembly wall time so longseq runs
        can assert bookkeeping < solve cost."""
        with span("ba.assemble"):
            t_host0 = time.perf_counter()
            if self.mesh is None:
                prob = self._assemble()
            else:
                group = self.mesh.get_group()
                box = [self._assemble() if self.mesh.get_local_rank() == 0
                       else None]
                dist.broadcast_object_list(
                    box, src=dist.get_global_rank(group, 0), group=group,
                    device=self.device if dist.get_backend(group) == "nccl"
                    else None)
                prob = box[0]
            if prob is None:
                return None
            Kn, L, n_obs = prob["Kn"], prob["L"], prob["n_obs"]
            if len(self.kf_poses) != Kn:
                raise RuntimeError(
                    f"WindowBA: this rank's window holds {len(self.kf_poses)} "
                    f"keyframes, the mesh's rank 0 solves {Kn}: the ranks' VO "
                    f"loops are out of step")
            reduce = (None if self.mesh is None
                      else BA.all_reduce_sum(self.mesh.get_group()))
            arrays = self._local_block(prob)
            host_assembly_s = time.perf_counter() - t_host0
            ba_prob = self._problem(prob, *arrays)

        with span("ba.solve"):
            with span("wait.ba_sync"):
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            t_solve0 = time.perf_counter()
            res = BA.run_ba(ba_prob, n_iters=self.cfg.n_iters,
                            damping=self.cfg.damping, huber=self.cfg.huber,
                            reduce=reduce)
            # one transfer of the result to the host; it also ends the
            # solve
            packed = torch.cat([res.R[:Kn].reshape(-1),
                                res.t[:Kn].reshape(-1), res.cost_history])
            with span("wait.ba_readback"):
                out = packed.cpu().numpy()
            solve_s = time.perf_counter() - t_solve0
        R_all = out[:9 * Kn].reshape(Kn, 3, 3)
        t_all = out[9 * Kn:12 * Kn].reshape(Kn, 3)
        cost = out[12 * Kn:]

        # a diverged solve (ill-conditioned Schur system) must not poison
        # the odometry: reject non-finite results and keep the incoming
        # poses (the VO loop treats None as "no BA correction")
        if not (np.isfinite(R_all).all() and np.isfinite(t_all).all()
                and np.isfinite(float(cost[-1]))):
            import warnings
            warnings.warn("WindowBA: solve diverged (non-finite result); "
                          "keeping odometry poses", stacklevel=2)
            return None

        poses = []
        for k in range(Kn):
            T = np.eye(4)
            T[:3, :3] = R_all[k].astype(np.float64)
            T[:3, 3] = t_all[k].astype(np.float64)
            self.kf_poses[k] = T
            poses.append(geom.Pose(self._dev(R_all[k]), self._dev(t_all[k])))
        info = {
            "n_landmarks": L,
            "n_obs": n_obs,
            "cost": cost,
            "host_assembly_s": host_assembly_s,
            "solve_s": solve_s,
        }
        return poses, info

    def _dev(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _assemble(self) -> Optional[dict]:
        """The window problem as host arrays, or None if too small: poses
        R (K, 3, 3), t (K, 3); landmark initial positions X0 (L, 3); per
        observation its keyframe kk, landmark li (ascending track id),
        pixel uv and edge normal nrm (k-major, slot-ascending)."""
        Kn = len(self.kf_poses)
        if Kn < 2:
            return None

        # ---- track census over the window (vectorized np.unique) ----
        tids = np.stack(self.kf_tid)            # (K, M)
        vm = tids >= 0
        uniq, counts = np.unique(tids[vm], return_counts=True)
        cand = uniq[counts >= self.cfg.min_track_len]
        if cand.size > self.cfg.max_landmarks:
            import warnings
            warnings.warn(
                f"WindowBA: {cand.size} qualifying tracks exceed "
                f"max_landmarks={self.cfg.max_landmarks}; keeping the "
                "longest tracks - raise WindowBAConfig.max_landmarks to "
                "use all")
            # deterministic, quality-ranked truncation (longest tracks
            # constrain the solve most)
            ccnt = counts[counts >= self.cfg.min_track_len]
            order = np.lexsort((cand, -ccnt))
            keep = np.sort(cand[order][: self.cfg.max_landmarks])
        else:
            keep = cand                          # already sorted by unique
        L = int(keep.size)
        if L < 10:
            return None

        # ---- flatten (keyframe, slot) observations of kept tracks ----
        kk, ss = np.nonzero(vm)                  # k-major, slot-ascending
        t_flat = tids[kk, ss]
        pos = np.searchsorted(keep, t_flat)
        in_keep = (pos < L) & (keep[np.minimum(pos, L - 1)] == t_flat)
        kk, ss, li = kk[in_keep], ss[in_keep], pos[in_keep]
        n_obs = int(kk.size)
        if n_obs > self.cfg.max_obs:
            import warnings
            warnings.warn(
                f"WindowBA: truncating {n_obs} observations to "
                f"max_obs={self.cfg.max_obs}; raise WindowBAConfig.max_obs "
                f"to use all tracks", stacklevel=3)
            kk, ss, li = kk[: self.cfg.max_obs], ss[: self.cfg.max_obs], \
                li[: self.cfg.max_obs]
            n_obs = self.cfg.max_obs

        uvs = np.stack(self.kf_uv)               # (K, M, 2)
        nrm = np.stack(self.kf_normal)

        # ---- landmark init: FIRST (earliest-keyframe) observation's
        # stereo triangulation lifted to world. Reverse fancy assignment
        # leaves the first occurrence per landmark. ----
        first = np.full(L, -1, np.int64)
        first[li[::-1]] = np.arange(n_obs - 1, -1, -1)
        gammas = np.stack(self.kf_gamma)         # (K, M, 3)
        g0 = gammas[kk[first], ss[first]]
        Tinv = np.linalg.inv(np.stack(self.kf_poses))   # (K, 4, 4)
        Ti = Tinv[kk[first]]
        X0 = np.einsum("lij,lj->li", Ti[:, :3, :3], g0) + Ti[:, :3, 3]
        poses = np.stack(self.kf_poses)
        return {"Kn": Kn, "L": L, "n_obs": n_obs,
                "R": poses[:, :3, :3], "t": poses[:, :3, 3], "X0": X0,
                "kk": kk, "li": li, "uv": uvs[kk, ss], "nrm": nrm[kk, ss]}

    def _problem(self, prob, X, kk, li, uv, nrm, w) -> BA.BAProblem:
        return BA.BAProblem(
            R=self._dev(prob["R"]), t=self._dev(prob["t"]), X=self._dev(X),
            obs_kf=self._dev(kk, torch.int64),
            obs_lm=self._dev(li, torch.int64), obs_uv=self._dev(uv),
            obs_w=self._dev(w), K_cam=self._dev(self.K_cam),
            X_prior=self._dev(X), prior_w=self._dev(self.cfg.prior_weight),
            obs_n=self._dev(nrm))

    def _local_block(self, prob):
        """(X, kk, li, uv, nrm, w) of this rank's contiguous block of
        ceil(L / ranks) landmarks and the observations of those landmarks
        (their order kept), with landmark indices local to the block; on
        one device, the whole problem. Nothing is padded to the
        capacities: a weight-0 observation or an unobserved landmark
        would change no sum."""
        L = prob["L"]
        n_ranks, rank = ((1, 0) if self.mesh is None
                         else (self.mesh.size(), self.mesh.get_local_rank()))
        block = -(-L // n_ranks)
        lo, hi = min(rank * block, L), min((rank + 1) * block, L)
        li = prob["li"]
        m = (li >= lo) & (li < hi)
        return (prob["X0"][lo:hi], prob["kk"][m], li[m] - lo, prob["uv"][m],
                prob["nrm"][m], np.ones(int(m.sum()), np.float32))


def best_links_from_quads(tr) -> np.ndarray:
    """Extract the (M,) best CF-mate index per KF mate row from a
    TemporalResult (-1 where no surviving candidate)."""
    quads = tr.quads
    cmask = _np(quads.cmask)
    ncc = _np(quads.ncc_l)
    cf_idx = _np(quads.cf_idx)
    score = np.where(cmask, ncc, -np.inf)
    best = score.argmax(axis=1)
    has = score.max(axis=1) > -np.inf
    out = np.where(has, cf_idx[np.arange(len(best)), best], -1)
    return out.astype(np.int64)
