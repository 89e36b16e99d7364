"""Build, load and count the port's hand-written CUDA kernels.

The sources under `csrc/` (`*.cu`, and the `*.cuh` headers they include)
have a plain C interface. At first use they are compiled by nvcc for
Hopper (`sm_90a`), one process per `*.cu` in parallel, and linked into
one shared library under `build/torch_kernels/` at the repository root
and loaded with ctypes. The library name carries a hash of the sources,
headers included, and the nvcc command, so an edited source or header
builds anew; deleting the directory forces a rebuild.

Every kernel wrapper adds one to its entry of `LAUNCHES` where it
launches its kernel, and nowhere else, so a run can show that its main
path went through the kernels; a replay of a step's CUDA graph adds what
the wrappers counted while it was captured (`utils/graphs.py`), and
`GRAPH_STEPS` counts how each step's calls ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas=-v"]

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES = {"toed_gradient_field": 0, "refine_along_epipolar": 0,
            "refine_2dof": 0, "cluster_edges": 0, "edge_descriptors": 0,
            "dense_gates": 0, "edge_patches": 0, "ransac_score": 0,
            "pose_gn": 0, "toed_nms_compact": 0, "compact_candidates": 0,
            "bnb_keep": 0}
# step -> its calls on a CUDA device since the last reset_launch_counts():
# captured into a graph, replayed from it, or run eagerly
GRAPH_STEPS = {step: {"capture": 0, "replay": 0, "eager": 0}
               for step in ("stereo_step", "temporal_step")}
# the counters reset_launch_counts() zeroes; a module adds its own with
# `counter`
_COUNTERS = [LAUNCHES, *GRAPH_STEPS.values()]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_ulonglong
# K2's entry: images, H, W, lanes, B .. stride, tol, huber, outputs, stream
_GN_ARGS = [_P] * 2 + [_I] * 2 + [_P] * 8 + [_I] * 7 + [_F] * 2 + [_P] * 7
# C entry point -> argtypes; each returns cudaError_t as int
_SIGNATURES = {
    "toed_gradient_field_launch": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # Ix, Iy, |grad|, orientation, B, H, W, border, grad_mag_min,
    # max_edges, row_count, cols, x, y, theta, mag, ok, count, stream
    "toed_nms_compact_launch": ([_P] * 4 + [_I] * 4 + [_F, _I]
                                + [_P] * 9),
    "refine_along_epipolar_launch": _GN_ARGS,
    # K3's sides entry: images, H, W, packs, d0, nsides, active, B ..
    # stride, tol, huber, cum_done, budget, counter, outputs, stream
    "refine_2dof_sides_launch": ([_P] * 3 + [_I] * 2 + [_P] * 3 + [_I, _P]
                                 + [_I] * 7 + [_F] * 2 + [_P, _I, _P]
                                 + [_P] * 7),
    "refine_2dof_info": [_P],
    # K4: x, y, theta, mask, N, C, thresh, by_orient, orient_rad,
    # inv_sigma, cap, rounds, outputs, stream
    "cluster_edges_launch": ([_P] * 4 + [_I] * 2 + [_F, _I, _F, _F, _I, _I]
                             + [_P] * 7),
    # K5: gx, gy, maps texture, surface, H, W, x, y, theta, N, shift, ii,
    # jj, gauss, place, S, terms, lens, tile, stride, two_pi, inv_two_pi,
    # clip, scale, out, stream
    "edge_descriptors_launch": ([_P] * 2 + [_U] * 2 + [_I] * 2 + [_P] * 3
                                + [_I, _F] + [_P] * 4 + [_I] + [_P] * 2
                                + [_I] * 2 + [_F] * 4 + [_P] * 2),
    "edge_descriptors_maps_create": [_I, _I, _P],
    "edge_descriptors_info": [_P],
    # K6 stereo: l_desc, r_desc, cand, cmask, N, C, l_pat, l_ok, r_pat,
    # r_ok, Nr, r_terms, P, sift, inv_pp, eps, eps2, fill_dist, fill_ncc,
    # out, stream
    "dense_gates_stereo_launch": ([_P] * 4 + [_I] * 2 + [_P] * 4
                                  + [_I, _P, _I] + [_F] * 6 + [_P] * 2),
    # K6 temporal: KF patches and flags (left, right), KF descriptors, CF
    # patches, flags, descriptors, Mc, cf_terms, cf_idx, cmask, M, C, P,
    # inv_pp, eps, eps2, fill_ncc, fill_dist, out, stream
    "dense_gates_temporal_launch": ([_P] * 9 + [_I] + [_P] * 3 + [_I] * 3
                                    + [_F] * 5 + [_P] * 2),
    # K6 flat: l_pat, l_ok, rows, r_pat, r_ok, live, F, P, inv_pp, eps,
    # eps2, fill, out, stream
    "dense_gates_flat_launch": [_P] * 6 + [_I] * 2 + [_F] * 4 + [_P] * 2,
    "dense_gates_info": [_P],
    # K7: img, H, W, x, y, theta, live (or null), B, P, shift, tile,
    # stride, out, ok, stream
    "edge_patches_launch": ([_P, _I, _I] + [_P] * 4 + [_I] * 2 + [_F]
                            + [_I] * 2 + [_P] * 3),
    "edge_patches_info": [_P],
    # K8: KG, Kt, gate (or null), index (or null), n, gamma, cf, valid, Q,
    # thresh, z_min, out, stream
    "ransac_score_launch": [_P] * 4 + [_I] + [_P] * 3 + [_I, _F, _F] + [_P] * 2,
    # K9: R, t, K, gamma, cf, valid, Q, thresh, z_min, threads, per_thread,
    # partial (and ticket), out, stream
    "pose_gn_launch": [_P] * 6 + [_I, _F, _F, _I, _I] + [_P] * 3,
    # the gather windows' compaction: idx, attrs, mask, priority (or
    # null), Q, S, A, W, outputs, stream
    "compact_candidates_launch": [_P] * 4 + [_I] * 4 + [_P] * 4,
    # the best/nearly-best streak: scores, mask, N, C, thresh,
    # higher_better, out, stream
    "bnb_keep_launch": [_P] * 2 + [_I] * 2 + [_F, _I] + [_P] * 2,
}

_lock = threading.Lock()
_lib = None


def counter(*names: str) -> dict:
    """A dict of counts, each 0, reset with the launch counts."""
    counts = dict.fromkeys(names, 0)
    _COUNTERS.append(counts)
    return counts


def reset_launch_counts():
    for counts in _COUNTERS:
        for k in counts:
            counts[k] = 0


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libvo_kernels_{h.hexdigest()[:16]}.so"


def ptxas_log() -> str:
    """What `-Xptxas=-v` said about each kernel of the built library
    (registers, shared memory, spills)."""
    log = library_path().with_suffix(".ptxas.txt")
    return log.read_text() if log.exists() else ""


def _build(out: Path):
    """One nvcc per source, all started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [work / f"{s.stem}.o" for s in _sources()]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(s)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for s, o in zip(_sources(), objs)]
        logs = []
        for s, p in zip(_sources(), procs):
            msg = "".join(p.communicate())
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name} "
                                   f"({p.returncode}):\n{msg}")
            logs.append(f"== {s.name}\n{msg}")
        tmp = work / out.name
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        out.with_suffix(".ptxas.txt").write_text("".join(logs))
        os.replace(tmp, out)     # atomic: a concurrent loader sees all or none
    finally:
        shutil.rmtree(work, ignore_errors=True)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            handle = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = _I
            _lib = handle
        return _lib


def check_kernel_ranges(cfg):
    """Raise ValueError, naming the field, where a `VOConfig` setting lies
    outside what a hand-written kernel takes: K4's, K6's and the BNB
    filter's slots a row (`max_candidates`, `max_quad_candidates`), K5's
    4 x 4 cells x 8 bins and at most 16 x 16 samples (K6 reads its 2 x
    128-bin output), the odd patch size P <= 11 (2 P^2 <= 242) of K2, K3,
    K6 and K7, and K1's 19 taps (`toed_kernel_size` 17; 18 builds the
    same taps). K8 and K9 (the RANSAC scoring and pose GN) take every
    setting. The wrappers refuse such settings at their launch; the
    pipeline's step builders call this on CUDA so that they fail at
    construction. The plain twins
    (the CPU) take these settings wherever the reference does; the
    reference's patch-coverage guard, which holds on both devices, is
    `patches.check_coverage`."""
    from edge_based_visual_odometry_tpu_torch.models import (
        stereo_matcher as SM)
    from edge_based_visual_odometry_tpu_torch.ops import clustering as CL
    from edge_based_visual_odometry_tpu_torch.ops import descriptors as DESC
    from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
    from edge_based_visual_odometry_tpu_torch.ops import patches as PAT
    from edge_based_visual_odometry_tpu_torch.ops import toed as TOED

    def refuse(field, why):
        raise ValueError(f"VOConfig.{field} = {getattr(cfg, field)!r}: {why}")

    slots = min(CL.MAX_SLOTS, PAT.MAX_SLOTS, SM.BNB_MAX_SLOTS)
    for field in ("max_candidates", "max_quad_candidates"):
        if getattr(cfg, field) > slots:
            refuse(field, f"K4 (cluster_edges), K6 (dense_gates) and the BNB "
                          f"filter (bnb_keep) take at most {slots} slots a "
                          f"row")
    # K6 reads K5's output: 2 halves of 4 x 4 cells x 8 bins
    if cfg.desc_spatial_bins ** 2 != DESC.K5_CELLS:
        refuse("desc_spatial_bins", "K5 (edge_descriptors) computes 4 x 4 "
                                    "cells, K6 (dense_gates) reads 128 bins "
                                    "a half")
    if cfg.desc_orient_bins != DESC.K5_ORIENT:
        refuse("desc_orient_bins", f"K5 (edge_descriptors) computes "
                                   f"{DESC.K5_ORIENT} orientation bins, K6 "
                                   f"(dense_gates) reads 128 bins a half")
    if cfg.desc_patch_samples ** 2 > DESC.MAX_SAMPLES:
        refuse("desc_patch_samples", f"K5 (edge_descriptors) takes at most "
                                     f"{DESC.MAX_SAMPLES} samples")
    if TOED.tap_width(cfg.toed_kernel_size) != TOED.KERNEL_TAPS:
        refuse("toed_kernel_size", f"K1 (toed_gradient_field) takes "
                                   f"{TOED.KERNEL_TAPS} taps "
                                   f"(toed_kernel_size 17)")
    P = cfg.patch_size
    side = min(GN.MAX_PATCH_SAMPLES // 2, PAT.MAX_PATCH ** 2)
    if P % 2 == 0 or P * P > side:
        refuse("patch_size", f"K2, K3 (GN), K6 (dense_gates) and K7 "
                             f"(edge_patches) take odd sizes with P*P <= "
                             f"{side}")


def check(err: int, what: str):
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype, shape, device):
    """Validate one kernel operand: device, dtype, shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
