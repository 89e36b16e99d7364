#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each passes or exits non-zero):
  1. require CUDA; print the card (nvidia-smi name, power limit);
  2. build the hand-written kernels from csrc/ (nvcc, sm_90a);
  3. K1 (TOED gradient field) vs its plain twin on frame 0 of the
     376x1241 synthetic sequence, both images;
  4. K2 (1-DoF epipolar GN) vs its plain twin on the real stage-9 input
     of that frame;
  5. the port on the CPU (plain twins) vs the port on the GPU (kernels)
     on a small 120x160 sequence;
  6. the production frame: VOPipeline(VOConfig(), every_frame) over the 3
     frames, with launch counts, workload and pose-error checks.
Prints a JSON line of per-kernel results, then as the last line
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps):
    """Mean device ms per call over `reps` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def u8(a):
    """Production PNG path: integer-valued images."""
    return np.round(a).clip(0, 255).astype(np.uint8)


def rel_pose_err(tr, f_kf, f_cf):
    R_gt = f_cf.R @ f_kf.R.T
    t_gt = f_cf.t - R_gt @ f_kf.t
    dR = tr.R.double().cpu().numpy() @ R_gt.T
    ang = float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))
    return ang, float(np.linalg.norm(tr.t.double().cpu().numpy() - t_gt))


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    from edge_based_visual_odometry_tpu_torch.config import VOConfig
    from edge_based_visual_odometry_tpu_torch.io import synthetic as S
    from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
    from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
    from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
    from edge_based_visual_odometry_tpu_torch.ops import toed

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])    # card name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    CB.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{CB.library_path().relative_to(CB.BUILD_DIR.parents[1])}")

    H, W = 376, 1241
    seq = S.make_sequence(n_frames=3, h=H, w=W)
    frames = [(u8(f.left), u8(f.right)) for f in seq.frames]
    cfg = VOConfig()
    kernels = []

    # ---- 3. K1 vs plain ----
    img = torch.stack([torch.as_tensor(a) for a in frames[0]]).to(
        dev, torch.float32).contiguous()
    out_k = toed.toed_gradient_field_cuda(img, cfg.toed_kernel_size,
                                          cfg.toed_sigma)
    out_p = toed.toed_gradient_field_plain(img, cfg.toed_kernel_size,
                                           cfg.toed_sigma)
    torch.cuda.synchronize()
    err_k1 = 0.0
    for nm, a, b in zip(("Ix", "Iy", "mag"), out_k[:3], out_p[:3]):
        check(bool(torch.isfinite(a).all()), f"K1 {nm} not finite")
        d = (a - b).abs()
        bad = int((d > 2e-3 + 2e-4 * b.abs()).sum())
        err_k1 = max(err_k1, float(d.max()))
        check(bad == 0, f"K1 {nm}: {bad} values beyond rtol 2e-4 atol 2e-3 "
                        f"(max abs err {float(d.max()):.3g})")
    m = out_p[2] > 2.0
    d = (out_k[3] - out_p[3]).abs()[m]
    d = torch.minimum(d, 2 * np.pi - d)
    q_or = float(torch.quantile(d.double().cpu(), 0.999))
    check(q_or < 1e-3, f"K1 orient 99.9% quantile {q_or:.3g} rad >= 1e-3")
    ms_k1 = cuda_ms(lambda: toed.toed_gradient_field_cuda(img), 20)
    ms_p1 = cuda_ms(lambda: toed.toed_gradient_field_plain(img), 20)
    print(f"K1 toed_gradient_field (2x{H}x{W}): max abs err {err_k1:.3g}, "
          f"orient q99.9 {q_or:.3g} rad; kernel {ms_k1:.3f} ms, "
          f"plain {ms_p1:.3f} ms")
    kernels.append(dict(
        name="toed_gradient_field", route="cuda",
        source="edge_based_visual_odometry_tpu_torch/csrc/toed_gradient_field.cu",
        replaces="edge_based_visual_odometry_tpu/ops/toed_pallas.py:131",
        max_abs_err=err_k1, ms=ms_k1, plain_ms=ms_p1))

    # ---- 4. K2 vs plain on the real stage-9 input of frame 0 ----
    cap = {}
    PL.build_stereo_step(seq.rig, cfg, dev)(*frames[0], gn_capture=cap)
    a, kw = cap["args"], cap["kwargs"]
    act = kw["active"]
    B = act.shape[0]
    n_act = int(act.sum())
    alpha0 = torch.zeros(B, device=dev)
    gn_kw = dict(patch_size=kw["patch_size"], max_iter=kw["max_iter"],
                 tol=kw["tol"], huber_delta=kw["huber_delta"], tile=kw["tile"])
    rk, dk = GN.refine_along_epipolar_cuda(*a, alpha0, act, 0, kw["max_iter"],
                                           **gn_kw)
    rp, dp = GN.refine_along_epipolar_plain(*a, alpha0, act, 0,
                                            kw["max_iter"], **gn_kw)
    torch.cuda.synchronize()
    da = (rk.delta - rp.delta).abs()[act]
    check(bool(torch.isfinite(rk.delta[act]).all()), "K2 alpha not finite")
    frac_a = float((da <= 1e-3).float().mean())
    frac_v = float((rk.valid == rp.valid)[act].float().mean())
    err_k2 = float(da.max())
    check(frac_a >= 0.999, f"K2 |d alpha| <= 1e-3 on only {frac_a:.5f}")
    check(frac_v >= 0.995, f"K2 valid agrees on only {frac_v:.5f}")
    ms_k2 = cuda_ms(lambda: GN.refine_along_epipolar_cuda(
        *a, alpha0, act, 0, kw["max_iter"], **gn_kw), 10)
    ms_p2 = cuda_ms(lambda: GN.refine_along_epipolar_plain(
        *a, alpha0, act, 0, kw["max_iter"], **gn_kw), 3)
    print(f"K2 refine_along_epipolar (B={B}, active {n_act}): |d alpha|<=1e-3 "
          f"{frac_a:.5f}, valid agree {frac_v:.5f}, max abs err {err_k2:.3g}; "
          f"kernel {ms_k2:.3f} ms, plain {ms_p2:.3f} ms")
    kernels.append(dict(
        name="refine_along_epipolar", route="cuda",
        source="edge_based_visual_odometry_tpu_torch/csrc/epipolar_gn.cu",
        replaces="edge_based_visual_odometry_tpu/ops/gn_pallas.py:218",
        max_abs_err=err_k2, ms=ms_k2, plain_ms=ms_p2))

    # ---- 5. small input: plain twins on the CPU vs kernels on the GPU ----
    small_cfg = VOConfig(max_edges=1024, max_candidates=8, gather_slots=64,
                         max_mates=512, max_refine_pairs=1024,
                         max_quad_candidates=8, quad_gather_slots=144,
                         ransac_max_iterations=256, gn_max_iter=4)
    small = S.make_sequence(n_frames=2, h=120, w=160)
    runs = {}
    for d in ("cpu", dev):
        pipe = PL.VOPipeline(small.rig, small_cfg, device=d)
        runs[str(d)] = [pipe.run_frame(u8(f.left), u8(f.right))
                        for f in small.frames]
    for k, ((fc, tc), (fg, tg)) in enumerate(zip(runs["cpu"], runs[str(dev)])):
        sc = fc.stereo_metrics[:, 1].numpy()
        sg = fg.stereo_metrics[:, 1].cpu().numpy()
        check(bool(np.all(np.abs(sc - sg) <= 0.05 * sc + 5)),
              f"small frame {k}: stage rows differ cpu {sc} gpu {sg}")
        mc, mg = int(fc.mates.count), int(fg.mates.count)
        check(min(mc, mg) >= 0.97 * max(mc, mg),
              f"small frame {k}: mates cpu {mc} gpu {mg}")
    print(f"small 120x160: cpu vs gpu stage rows within 5%+5, mates "
          f"{[int(r[0].mates.count) for r in runs['cpu']]} vs "
          f"{[int(r[0].mates.count) for r in runs[str(dev)]]}")

    # ---- 6. the production frame through VOPipeline ----
    pipe = PL.VOPipeline(seq.rig, cfg, device=dev,
                         keyframe_policy="every_frame")
    step_ms = {}

    def timed(fn, key):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            step_ms[key] = (time.perf_counter() - t) * 1e3
            return out
        return wrapped

    pipe._stereo_step = timed(pipe._stereo_step, "stereo")
    pipe._temporal_step = timed(pipe._temporal_step, "temporal")
    pipe._temporal_step_boot = timed(pipe._temporal_step_boot, "temporal")
    torch.cuda.synchronize()
    CB.reset_launch_counts()
    per_frame = []
    for k, (l, r) in enumerate(frames):
        before = dict(CB.LAUNCHES)
        step_ms.clear()
        t = time.perf_counter()
        fr, tr = pipe.run_frame(l, r)
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t) * 1e3
        per_frame.append((fr, tr, {n: CB.LAUNCHES[n] - before[n]
                                   for n in before}, dict(step_ms), frame_ms))
    launches = dict(CB.LAUNCHES)

    for k, (fr, tr, dl, ms, frame_ms) in enumerate(per_frame):
        n_mates = int(fr.mates.count)
        rows = fr.stereo_metrics[:, 1].cpu().numpy().astype(int).tolist()
        check(dl["toed_gradient_field"] >= 1, f"frame {k}: K1 not launched")
        check(dl["refine_along_epipolar"] >= 1, f"frame {k}: K2 not launched")
        m = fr.mates
        v = m.valid
        check(m.gamma.shape == (cfg.max_mates, 3), f"frame {k}: gamma shape")
        check(bool(torch.isfinite(m.gamma[v]).all()
                   and torch.isfinite(m.right_x[v]).all()),
              f"frame {k}: non-finite mates")
        line = (f"frame {k}: edges L/R {int(fr.n_left_edges)}/"
                f"{int(fr.n_right_edges)}, mates {n_mates}, stage rows "
                f"{rows}, launches {dl}, stereo {ms['stereo']:.1f} ms")
        if k == 0:
            check(n_mates >= 21000, f"frame 0: mates {n_mates} < 21000")
        else:
            ang, terr = rel_pose_err(tr, seq.frames[k - 1], seq.frames[k])
            n_q = int(tr.n_quads)
            check(bool(tr.success), f"frame {k}: pose not successful")
            check(bool(torch.isfinite(tr.R).all() and torch.isfinite(tr.t).all()),
                  f"frame {k}: non-finite pose")
            check(n_q >= 500, f"frame {k}: quads {n_q} < 500")
            check(ang < 0.2 and terr < 0.010,
                  f"frame {k}: pose error {ang:.4f} deg / {terr * 1e3:.2f} mm")
            line += (f", temporal {ms['temporal']:.1f} ms, quads {n_q}, "
                     f"inlier ratio {float(tr.inlier_ratio):.3f}, pose err "
                     f"{ang:.4f} deg / {terr * 1e3:.2f} mm, temporal rows "
                     f"{tr.temporal_metrics[:, 1].cpu().numpy().astype(int).tolist()}")
        print(line + f", frame {frame_ms:.1f} ms")

    for kd in kernels:
        kd["launches"] = launches[kd["name"]]
        check(kd["launches"] >= 1, f"{kd['name']} not launched on the main path")
    print(json.dumps({"kernels": [
        {k: kd[k] for k in ("name", "route", "source", "replaces", "launches",
                            "max_abs_err", "ms", "plain_ms")}
        for kd in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
