#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each passes or exits non-zero):
  1. require CUDA; print the card (nvidia-smi name, power limit);
  2. build the hand-written kernels from csrc/ (nvcc, sm_90a) and print
     what ptxas says of each (registers, shared memory, spills);
  3. K1 (TOED gradient field) vs its plain twin on frame 0 of the
     376x1241 synthetic sequence, both images; timed beside the twin;
  4. K2 (1-DoF epipolar GN) vs its plain twin, bit for bit, on the real
     stage-9 input of that frame: as one 20-iteration launch and as the
     pipeline's two phases; each form timed on the interleaved maps the
     pipeline makes once per frame, and that interleave timed apart;
  5. the port on the CPU (plain twins) vs the port on the GPU (kernels)
     on a small 120x160 sequence;
  6. the production frame: VOPipeline(VOConfig(), every_frame) over the 3
     frames, with launch counts, workload and pose-error checks.
Prints a JSON line of per-kernel results (time, bound, % of bound), then
as the last line {"ok": true, "device": {...}}.

The bound of a kernel is the least time the card could take for its
work: the larger of its operations over the float32 peak and its bytes
(each input read once, each output written once) over the memory rate.
K2's arithmetic is FMA-free (each multiply and add rounds on its own, to
stay bit-equal to its twin), so it can reach at most half the FMA peak;
its line also gives the bound at that rate (`bound_ms_no_fma`).
The counting functions below need no GPU (tests/test_torch_bounds.py).
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM at its full 700 W: float32 outside the tensor cores, HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# the same units issuing one multiply or one add per lane and clock
PEAK_FLOPS_NO_FMA = PEAK_FLOPS / 2

# K1, per low-res pixel: 12 column + 36 row correlations of 19 taps (one
# FMA = 2 flops each), and per phase an epilogue of 46 flops for the two
# third-order sums, 4 for |grad| (its sqrt as one) and 15 for atan2.
K1_FMA_PER_PIXEL = 12 * 19 + 36 * 19
K1_EPILOGUE_FLOPS = 65
K1_OUTPUTS_PER_PIXEL = 16            # 4 phases x (Ix, Iy, |grad|, orient)

# K2, per sample of the 2 P^2: once per candidate the left sample (10
# coordinate, 18 tap, 9 bilinear, 1 mean, 1 centring); per iteration the
# right sample (10 coordinate, 18 tap, 3 x 9 bilinear, 1 mean, 16 residual,
# weight and the three sums) plus 12 scalar flops (step, mean scale,
# delta, rms, confidence).
K2_LEFT_SAMPLE_FLOPS = 39
K2_SAMPLE_FLOPS = 72
K2_ITER_FLOPS = 12
K2_LANE_IN_BYTES = 6 * 4 + 2 * 4 + 1    # lx ly theta rx ry alpha0, epi, active
K2_LANE_OUT_BYTES = 3 * 4 + 1 + 4 + 1   # alpha score conf, valid, iters, done


def bound(flops, nbytes, peak_flops=PEAK_FLOPS):
    """Least time in ms for `flops` and `nbytes` on the card, and what
    sets it ("operations" or "bytes")."""
    t_op, t_by = flops / peak_flops, nbytes / PEAK_BYTES
    return dict(flops=int(flops), bytes=int(nbytes),
                bound_ms=max(t_op, t_by) * 1e3,
                bound_by="operations" if t_op >= t_by else "bytes")


def k1_work(B, H, W):
    """(flops, bytes) of K1 on (B, H, W) images."""
    px = B * H * W
    flops = px * (2 * K1_FMA_PER_PIXEL + 4 * K1_EPILOGUE_FLOPS)
    return flops, px * 4 + K1_OUTPUTS_PER_PIXEL * px * 4


def k2_work(iters_run, active, patch_size, H, W):
    """(flops, bytes) of one K2 launch over B lanes: `iters_run` the
    iterations each lane ran in it, `active` the lanes it refined."""
    n = 2 * patch_size * patch_size
    iters_run = np.asarray(iters_run, np.int64)
    B = iters_run.shape[0]
    flops = (int(np.count_nonzero(active)) * n * K2_LEFT_SAMPLE_FLOPS
             + int(iters_run.sum()) * (n * K2_SAMPLE_FLOPS + K2_ITER_FLOPS))
    nbytes = 4 * H * W * 4 + B * (K2_LANE_IN_BYTES + K2_LANE_OUT_BYTES)
    return flops, nbytes


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


def with_bound(ms, flops, nbytes, fma_free=False):
    b = bound(flops, nbytes)
    b.update(ms=ms, pct_of_bound=100.0 * b["bound_ms"] / ms)
    if fma_free:
        nf = bound(flops, nbytes, PEAK_FLOPS_NO_FMA)["bound_ms"]
        b.update(bound_ms_no_fma=nf, pct_of_bound_no_fma=100.0 * nf / ms)
    return b


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
    card = smi.stdout.strip().splitlines()[0]
    print(card)    # card name, power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    CB.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{CB.library_path().relative_to(CB.BUILD_DIR.parents[1])}")
    for ln in CB.ptxas_log().splitlines():
        if ln.startswith("==") or "entry function" in ln or "spill" in ln \
                or "Used" in ln:
            print("ptxas: " + ln.strip())

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
    n_diff = [int((a != b).sum()) for a, b in zip(out_k, out_p)]
    ms_k1 = cuda_ms(lambda: toed.toed_gradient_field_cuda(img), 50)
    ms_p1 = cuda_ms(lambda: toed.toed_gradient_field_plain(img), 20)
    w1 = with_bound(ms_k1, *k1_work(*img.shape))
    print(f"K1 toed_gradient_field (2x{H}x{W}): max abs err {err_k1:.3g}, "
          f"orient q99.9 {q_or:.3g} rad, values not bit-equal to the twin "
          f"(Ix, Iy, mag, orient) {n_diff}; kernel {ms_k1:.4f} ms, plain "
          f"{ms_p1:.3f} ms; bound {w1['bound_ms'] * 1e3:.1f} us "
          f"({w1['bound_by']}: {w1['flops']} flop, {w1['bytes']} B), "
          f"{w1['pct_of_bound']:.1f}% of bound")
    kernels.append(dict(
        name="toed_gradient_field", route="cuda",
        source="edge_based_visual_odometry_tpu_torch/csrc/toed_gradient_field.cu",
        replaces="edge_based_visual_odometry_tpu/ops/toed_pallas.py:131",
        max_abs_err=err_k1, plain_ms=ms_p1, library_ms=None, **w1,
        values_not_bit_equal=n_diff))

    # ---- 4. K2 vs plain, bit for bit, on the real stage-9 input ----
    cap = {}
    PL.build_stereo_step(seq.rig, cfg, dev)(*frames[0], gn_capture=cap)
    a, kw = cap["args"], cap["kwargs"]
    act = kw["active"]
    B = act.shape[0]
    n_act = int(act.sum())
    P, max_iter = kw["patch_size"], kw["max_iter"]
    alpha0 = torch.zeros(B, device=dev)
    gn_kw = dict(patch_size=P, max_iter=max_iter, tol=kw["tol"],
                 huber_delta=kw["huber_delta"], tile=kw["tile"])

    def same(x, y, mask, what):
        for nm, u, v in zip(("alpha", "score", "conf", "valid", "iters",
                             "done"), x, y):
            n_bad = int((u != v)[mask].sum())
            check(n_bad == 0, f"K2 {what}: {nm} differs on {n_bad} of "
                              f"{int(mask.sum())} active lanes")

    rp, dp = GN.refine_along_epipolar_plain(*a, alpha0, act, 0, max_iter,
                                            **gn_kw)
    rk, dk = GN.refine_along_epipolar_cuda(*a, alpha0, act, 0, max_iter,
                                           **gn_kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(rk.delta[act]).all()), "K2 alpha not finite")
    same((*rk, dk), (*rp, dp), act, f"one {max_iter}-iteration launch")
    err_k2 = float((rk.delta - rp.delta).abs()[act].max())

    # the pipeline's two phases, recording each launch's operands; the
    # kernel reads the maps interleaved once, as refine_along_epipolar_batch
    # makes them
    maps4 = GN.interleave_maps(*a[1:4])

    def recorder(fn, calls, **extra):
        def run(args, delta0, it0, it_stop, active):
            calls.append((args, delta0, it0, it_stop, active))
            return fn(*a[:4], *args, delta0, active, it0, it_stop, **gn_kw,
                      **extra)
        return run

    lanes = tuple(t.contiguous() for t in a[4:])
    phase_kw = dict(phase1_iters=kw["phase1_iters"],
                    phase2_budget=kw["phase2_budget"], max_iter=max_iter,
                    chunk=kw["chunk"])
    calls_k, calls_p = [], []
    r2k = GN._two_phase(recorder(GN.refine_along_epipolar_cuda, calls_k,
                                 maps4=maps4), B, lanes, act, alpha0,
                        **phase_kw)
    r2p = GN._two_phase(recorder(GN.refine_along_epipolar_plain, calls_p), B,
                        lanes, act, alpha0, **phase_kw)
    r2b = GN.refine_along_epipolar_batch(*a, **kw)
    torch.cuda.synchronize()
    same(r2k, r2p, act, "two phases")
    same(r2k, r2b, act, "two phases vs refine_along_epipolar_batch")
    check(len(calls_k) == 2, f"K2: {len(calls_k)} launches for two phases")

    # timing: each form on the interleaved maps; bound from the iterations
    # run. The interleave is timed apart: the pipeline makes it once per
    # frame for both phases.
    ms_maps4 = cuda_ms(lambda: GN.interleave_maps(*a[1:4]), 50)
    print(f"K2 maps interleave (torch.stack of right, gx, gy into "
          f"{H}x{W}x4 float32): {ms_maps4:.4f} ms once per frame")
    forms = {f"one_launch_{max_iter}": ((*a[4:],), alpha0, 0, max_iter, act)}
    forms["phase1"], forms["phase2"] = calls_k
    k2 = {}
    for form, (args, d0, it0, it_stop, fact) in forms.items():
        def launch():
            return GN.refine_along_epipolar_cuda(*a[:4], *args, d0, fact, it0,
                                                 it_stop, maps4=maps4, **gn_kw)
        res, _ = launch()
        run_it = (res.iters.long() - it0).clamp(min=0) * fact
        work = k2_work(run_it.cpu().numpy(), fact.cpu().numpy(), P, H, W)
        row = with_bound(cuda_ms(launch, 20), *work, fma_free=True)
        row.update(lanes=int(fact.shape[0]), active=int(fact.sum()),
                   iterations=int(run_it.sum()))
        k2[form] = row
        print(f"K2 {form}: {row['lanes']} lanes, {row['active']} active, "
              f"{row['iterations']} lane-iterations; {row['ms']:.4f} ms; "
              f"bound {row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}), "
              f"{row['pct_of_bound']:.1f}% of it; FMA-free bound "
              f"{row['bound_ms_no_fma'] * 1e3:.1f} us, "
              f"{row['pct_of_bound_no_fma']:.1f}% of it")
    ms_p2 = cuda_ms(lambda: GN.refine_along_epipolar_plain(
        *a, alpha0, act, 0, max_iter, **gn_kw), 3)
    w2 = k2[f"one_launch_{max_iter}"]
    print(f"K2 refine_along_epipolar (B={B}, active {n_act}): bit-equal to "
          f"its twin on every active lane, as one launch and as two phases; "
          f"plain {ms_p2:.3f} ms; one frame's two phases "
          f"{k2['phase1']['ms'] + k2['phase2']['ms']:.4f} ms + interleave "
          f"{ms_maps4:.4f} ms")
    kernels.append(dict(
        name="refine_along_epipolar", route="cuda",
        source="edge_based_visual_odometry_tpu_torch/csrc/epipolar_gn.cu",
        replaces="edge_based_visual_odometry_tpu/ops/gn_pallas.py:218",
        max_abs_err=err_k2, plain_ms=ms_p2, library_ms=None,
        maps_interleave_ms=ms_maps4, **w2,
        forms={f: {k: r[k] for k in (
            "ms", "bound_ms", "bound_by", "pct_of_bound", "bound_ms_no_fma",
            "pct_of_bound_no_fma", "lanes", "active", "iterations")}
            for f, r in k2.items()}))

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

    record = []
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
            record.append(n_mates)
        else:
            ang, terr = rel_pose_err(tr, seq.frames[k - 1], seq.frames[k])
            n_q = int(tr.n_quads)
            check(bool(tr.success), f"frame {k}: pose not successful")
            check(bool(torch.isfinite(tr.R).all() and torch.isfinite(tr.t).all()),
                  f"frame {k}: non-finite pose")
            check(n_q >= 500, f"frame {k}: quads {n_q} < 500")
            check(ang < 0.2 and terr < 0.010,
                  f"frame {k}: pose error {ang:.4f} deg / {terr * 1e3:.2f} mm")
            record += [n_q, round(ang, 4), round(terr * 1e3, 2)]
            line += (f", temporal {ms['temporal']:.1f} ms, quads {n_q}, "
                     f"inlier ratio {float(tr.inlier_ratio):.3f}, pose err "
                     f"{ang:.4f} deg / {terr * 1e3:.2f} mm, temporal rows "
                     f"{tr.temporal_metrics[:, 1].cpu().numpy().astype(int).tolist()}")
        print(line + f", frame {frame_ms:.1f} ms")
    # this workload's record with the first version of the kernels
    pr1 = [23863, 32768, 0.051, 4.6, 32768, 0.0293, 1.83]
    print(f"workload record (mates; quads, deg, mm per frame): {record}; "
          f"{'equals' if record == pr1 else 'differs from'} the first "
          f"port's {pr1}")

    for kd in kernels:
        kd["launches"] = launches[kd["name"]]
        kd["launches_per_frame"] = kd["launches"] / len(frames)
        check(kd["launches"] >= 1, f"{kd['name']} not launched on the main path")
    for kd in kernels:
        kd["card"] = card
        # bound_us and limiter ("flops" | "bytes") restate bound_ms and
        # bound_by in the units and words of PERF.md's kernel table
        kd["bound_us"] = kd["bound_ms"] * 1e3
        kd["limiter"] = ("flops" if kd["bound_by"] == "operations"
                         else "bytes")
    print(json.dumps({"kernels": [
        {k: kd[k] for k in (
            "name", "route", "source", "replaces", "launches",
            "launches_per_frame", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "bound_us", "limiter", "pct_of_bound", "library_ms",
            "flops", "bytes", "card")}
        | {k: v for k, v in kd.items() if k in (
            "bound_ms_no_fma", "pct_of_bound_no_fma", "maps_interleave_ms",
            "values_not_bit_equal", "forms")}
        for kd in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
