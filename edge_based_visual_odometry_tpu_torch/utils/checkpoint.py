"""Checkpoint / resume for the VO pipeline state.

Port of `edge_based_visual_odometry_tpu/utils/checkpoint.py`, with the same
layout on disk: `state.npz` (the keyframe FrameResult flattened field by
field under explicit names, the trajectory, the pose state) and
`meta.json` (the frame cursor and flags). State is saved as numpy and
restored onto the pipeline's device, so a checkpoint written by the
reference restores into the port.

Beyond the reference's layout, `meta.json` carries `have_velocity`
(whether the bootstrap temporal step is over; absent = False, which is
what the reference resumes with), and the windowed-BA track state is
stored from the vectorised per-keyframe arrays of `models/window_ba.py`
under the reference's `wba_*` names (only slots that carry a track). With
both, a resumed run continues exactly as the uninterrupted one would.
The per-frame metric logs are diagnostics and are not saved.
"""

from __future__ import annotations

import json
import os
import typing

import numpy as np
import torch


def _to_numpy(a):
    """(array, is_bf16): numpy copy of a tensor or array; bfloat16 (which
    numpy cannot hold) comes back as its uint16 bit view."""
    if torch.is_tensor(a):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16), True
        return a.numpy(), False
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), True
    return a, False


def _nt_to_arrays(nt, prefix, out):
    """Recursively flatten NamedTuples of tensors into {name: array};
    bfloat16 is stored as a uint16 bit view with a name suffix tag."""
    if nt is None or isinstance(nt, dict):
        # diagnostic payloads (FrameResult.distributions) are not part of
        # inter-frame state - don't serialize them
        return
    if hasattr(nt, "_fields"):
        for f in nt._fields:
            _nt_to_arrays(getattr(nt, f), f"{prefix}{f}.", out)
    else:
        a, bf16 = _to_numpy(nt)
        out[prefix[:-1] + ("@bf16" if bf16 else "")] = a


def _arrays_to_nt(cls, prefix, data, device):
    """Rebuild a NamedTuple class tree from {name: array} on `device`."""
    kwargs = {}
    hints = typing.get_type_hints(cls)
    for f in cls._fields:
        key = f"{prefix}{f}"
        if key in data:
            kwargs[f] = torch.from_numpy(np.array(data[key])).to(device)
        elif key + "@bf16" in data:
            bits = np.array(data[key + "@bf16"]).view(np.int16)
            kwargs[f] = torch.from_numpy(bits).view(torch.bfloat16).to(device)
        elif f in getattr(cls, "_field_defaults", {}) and not any(
                k.startswith(f"{prefix}{f}.") for k in data):
            # unserialized field with a default (e.g. diagnostics dicts)
            kwargs[f] = cls._field_defaults[f]
        else:
            # an Optional field that was saved holds its one class
            sub = [t for t in typing.get_args(hints[f]) if t is not type(None)]
            kwargs[f] = _arrays_to_nt(sub[0] if sub else hints[f],
                                      f"{prefix}{f}.", data, device)
    return cls(**kwargs)


def _wba_to_arrays(wba, arrays, meta):
    """Serialize WindowBA track state: keyframe poses and, per keyframe,
    the slots that carry a track with their ids, locations, normals and
    3D points."""
    meta["wba_n_kf"] = len(wba.kf_poses)
    meta["wba_next_track"] = int(wba._next_track)
    for k in range(len(wba.kf_poses)):
        arrays[f"wba_T_{k}"] = np.asarray(wba.kf_poses[k])
        slots = np.nonzero(wba.kf_tid[k] >= 0)[0].astype(np.int64)
        arrays[f"wba_slots_{k}"] = slots
        arrays[f"wba_tids_{k}"] = wba.kf_tid[k][slots]
        arrays[f"wba_n_slots_{k}"] = np.int64(wba.kf_tid[k].shape[0])
        for name, store in (("uv", wba.kf_uv), ("normal", wba.kf_normal),
                            ("gamma", wba.kf_gamma)):
            arrays[f"wba_{name}_{k}"] = store[k][slots]


def _wba_from_arrays(wba, data, meta):
    wba._next_track = int(meta["wba_next_track"])
    wba.kf_poses, wba.kf_tid = [], []
    wba.kf_uv, wba.kf_normal, wba.kf_gamma = [], [], []
    for k in range(int(meta["wba_n_kf"])):
        wba.kf_poses.append(np.asarray(data[f"wba_T_{k}"], np.float64))
        slots = data[f"wba_slots_{k}"].astype(np.int64)
        M = int(data[f"wba_n_slots_{k}"])
        tid = np.full(M, -1, np.int64)
        tid[slots] = data[f"wba_tids_{k}"]
        wba.kf_tid.append(tid)
        for name, store, width, dtype in (
                ("uv", wba.kf_uv, 2, np.float32),
                ("normal", wba.kf_normal, 2, np.float32),
                ("gamma", wba.kf_gamma, 3, np.float64)):
            full = np.zeros((M, width), dtype)
            full[slots] = data[f"wba_{name}_{k}"]
            store.append(full)


_POSES = ("kf_pose_est", "last_rel", "kf_pose_gt", "prev_cam_pose")


def save_pipeline_state(path: str, pipe) -> None:
    """Persist a VOPipeline's inter-frame state."""
    os.makedirs(path, exist_ok=True)
    meta = {
        "frame_idx": pipe.frame_idx,
        "kf_index": pipe.kf_index,
        "ba_kf_frames": list(pipe._ba_kf_frames),
        "n_traj": len(pipe.trajectory),
        "has_keyframe": pipe.keyframe is not None,
        "has_kf_pose_gt": pipe.kf_pose_gt is not None,
        "has_prev_cam_pose": pipe.prev_cam_pose is not None,
        "has_wba": pipe.wba is not None,
        "have_velocity": bool(pipe._have_velocity),
    }
    arrays = {}
    if pipe.keyframe is not None:
        _nt_to_arrays(pipe.keyframe, "kf.", arrays)
    if pipe.trajectory:
        # one transfer for the whole trajectory
        R = torch.stack([p.R for p in pipe.trajectory]).cpu().numpy()
        t = torch.stack([p.t for p in pipe.trajectory]).cpu().numpy()
        for i in range(len(pipe.trajectory)):
            arrays[f"traj_R_{i}"] = R[i]
            arrays[f"traj_t_{i}"] = t[i]
    for name in _POSES:
        pose = getattr(pipe, name)
        if pose is not None:
            arrays[f"{name}_R"] = _to_numpy(pose.R)[0]
            arrays[f"{name}_t"] = _to_numpy(pose.t)[0]
    if pipe.wba is not None:
        _wba_to_arrays(pipe.wba, arrays, meta)
    np.savez_compressed(os.path.join(path, "state.npz"), **arrays)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def restore_pipeline_state(path: str, pipe) -> bool:
    """Restore state saved by save_pipeline_state (or by the reference's)
    into a freshly constructed VOPipeline (same config), on the pipeline's
    device. Returns False if absent."""
    from edge_based_visual_odometry_tpu_torch.geometry import Pose
    from edge_based_visual_odometry_tpu_torch.models.pipeline import (
        FrameResult)

    meta_path = os.path.join(path, "meta.json")
    npz_path = os.path.join(path, "state.npz")
    if not (os.path.exists(meta_path) and os.path.exists(npz_path)):
        return False
    with open(meta_path) as f:
        meta = json.load(f)
    data = dict(np.load(npz_path))
    device = pipe.device

    def pose(r_key, t_key):
        return Pose(*(torch.from_numpy(np.array(data[k])).to(
            device=device, dtype=torch.float32) for k in (r_key, t_key)))

    pipe.frame_idx = int(meta["frame_idx"])
    pipe.kf_index = int(meta.get("kf_index", 0))
    pipe._ba_kf_frames = [int(i) for i in meta.get("ba_kf_frames", [])]
    pipe._have_velocity = bool(meta.get("have_velocity", False))
    pipe.trajectory = [pose(f"traj_R_{i}", f"traj_t_{i}")
                       for i in range(int(meta["n_traj"]))]
    pipe.kf_pose_est = pose("kf_pose_est_R", "kf_pose_est_t")
    pipe.last_rel = pose("last_rel_R", "last_rel_t")
    if meta.get("has_kf_pose_gt"):
        pipe.kf_pose_gt = pose("kf_pose_gt_R", "kf_pose_gt_t")
    if meta.get("has_prev_cam_pose"):
        pipe.prev_cam_pose = pose("prev_cam_pose_R", "prev_cam_pose_t")
    if meta["has_keyframe"]:
        pipe.keyframe = _arrays_to_nt(FrameResult, "kf.", data, device)
    if meta.get("has_wba") and pipe.wba is not None and "wba_n_kf" in meta:
        _wba_from_arrays(pipe.wba, data, meta)
    return True
