"""K1-K9 in a trace, and the work each launch did.

`kernel_of` names the hand kernel (K1-K9) a device operation of the
trace belongs to, from the kernel names in `csrc/*.cu`; K2's map
interleave (`interleave_kernel`) belongs to K2's wrapper, to no K.

`WorkRecorder` wraps the port's kernel wrappers while it is entered and
keeps, for each launch, what `work.py`'s counts need: shapes, masks, and
for the GN kernels the iterations each lane ran (read from the launch's
own output). It copies small tensors on the card as it goes, so the
traced slice whose device time it is held against runs without it.
"""

from __future__ import annotations

import inspect
from collections import defaultdict

import torch

from vo_bench.harness import work as W

KERNEL_NAMES = {
    "K1": ("toed_gradient_field_kernel",),
    "K2": ("epipolar_gn_kernel",),
    "K3": ("gn_2dof_direct", "gn_2dof_queue"),
    "K4": ("cluster_edges_kernel",),
    "K5": ("edge_descriptors_kernel",),
    "K6": ("dense_gates_",),
    "K7": ("edge_patches_kernel",),
    "K8": ("ransac_score_kernel",),
    "K9": ("pose_gn_kernel",),
}


def kernel_of(name: str):
    for k, subs in KERNEL_NAMES.items():
        if any(s in name for s in subs):
            return k
    return None


def _np(t):
    return t.detach().cpu().numpy()


class WorkRecorder:
    """`with WorkRecorder() as rec:` ... `rec.work()`: the work of the
    launches made inside, by kernel."""

    def __enter__(self):
        from edge_based_visual_odometry_tpu_torch.ops import clustering as CL
        from edge_based_visual_odometry_tpu_torch.ops import descriptors as DESC
        from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
        from edge_based_visual_odometry_tpu_torch.ops import patches as PAT
        from edge_based_visual_odometry_tpu_torch.ops import pose as POSE
        from edge_based_visual_odometry_tpu_torch.ops import toed as TOED

        self.DESC = DESC
        self.pending = []              # (K, callable giving (flops, bytes))
        self.saved = []
        targets = [(TOED, "toed_gradient_field_cuda", self._k1),
                   (GN, "_launch_gn", self._k2),
                   (GN, "_k3_launch", self._k3),
                   (CL, "cluster_edges_cuda", self._k4),
                   (DESC, "edge_descriptors_cuda", self._k5),
                   (PAT, "dense_gates_stereo_cuda", self._k6_stereo),
                   (PAT, "dense_gates_flat_cuda", self._k6_flat),
                   (PAT, "dense_gates_temporal_cuda", self._k6_temporal),
                   (PAT, "edge_patches_cuda", self._k7),
                   (POSE, "ransac_counts_cuda", self._k8),
                   (POSE, "pose_gn_normal_equations_cuda", self._k9)]
        for mod, name, hook in targets:
            fn = getattr(mod, name)
            sig = inspect.signature(fn)

            def run(*a, _fn=fn, _sig=sig, _hook=hook, **kw):
                args = _sig.bind(*a, **kw)
                args.apply_defaults()
                return _hook(_fn, args.arguments, a, kw)
            self.saved.append((mod, name, fn))
            setattr(mod, name, run)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)

    def work(self):
        """{K: {"flops", "bytes", "launches", "bound_s"}}: sums over the
        launches, `bound_s` the sum of each launch's own bound."""
        torch.cuda.synchronize()
        out = defaultdict(lambda: dict(flops=0, bytes=0, launches=0,
                                       bound_s=0.0))
        for k, count in self.pending:
            f, b = count()
            o = out[k]
            o["flops"] += int(f)
            o["bytes"] += int(b)
            o["launches"] += 1
            o["bound_s"] += W.bound(f, b)["bound_ms"] * 1e-3
        return dict(out)

    # ---- one hook a wrapper: run it, keep what its count needs ----
    def _k1(self, fn, a, pa, kw):
        out = fn(*pa, **kw)
        shape = tuple(a["img"].shape)
        B, H, W_ = (1, *shape) if len(shape) == 2 else shape
        self.pending.append(("K1", lambda: W.k1_work(B, H, W_)))
        return out

    def _k2(self, fn, a, pa, kw):
        res, done = fn(*pa, **kw)
        act, it0 = a["active"].clone(), int(a["it0"])
        iters = res.iters.clone()
        H, W_ = a["img"][1].shape
        P = int(a["patch_size"])

        def count():
            run = (iters.long() - it0).clamp(min=0) * act
            return W.k2_work(_np(run), _np(act), P, H, W_)
        self.pending.append(("K2", count))
        return res, done

    def _k3(self, fn, a, pa, kw):
        out, act = a["out"], a["active"].clone()
        before = out[4].clone()
        ret = fn(*pa, **kw)
        after = out[4].clone()
        it0, queue = int(a["it0"]), a["queue"]
        H, W_ = a["kf_imgs"][0].shape
        P = int(a["patch_size"])

        def count():
            # phase 2 (a queue) samples the KF patch of the lanes it takes
            base = before.long() if queue is not None else it0
            run = (after.long() - base).clamp(min=0) * act
            f = b = 0
            for s in range(run.shape[0]):
                lanes = act if queue is None else act & (run[s] > 0)
                fs, bs = W.k3_work(_np(run[s]), _np(lanes), P, H, W_)
                f, b = f + fs, b + bs
            return f, b
        self.pending.append(("K3", count))
        return ret

    def _k4(self, fn, a, pa, kw):
        out = fn(*pa, **kw)
        mask = a["mask"].clone()
        by_o, cap = bool(a["by_orientation"]), int(a["max_cluster_size"])
        self.pending.append(("K4", lambda: W.k4_work(mask, by_o, cap)))
        return out

    def _k5(self, fn, a, pa, kw):
        out = fn(*pa, **kw)
        N = a["x"].shape[0]
        H, W_ = a["gx_img"].shape
        ns = int(a["n_samples"])
        SP = self.DESC._static_tables(ns, a["n_spatial"], a["spacing"],
                                      a["x"].device)[3]
        nonzero = int((SP != 0).sum())
        self.pending.append(("K5", lambda: W.k5_work(2 * N, ns * ns, nonzero,
                                                     H, W_)))
        return out

    def _k6_stereo(self, fn, a, pa, kw):
        out = fn(*pa, **kw)
        live, idx = a["cmask"].clone(), a["cand_idx"].clone()
        surv = live & (out[0] < a["sift_threshold"])
        pp = int(a["patch_size"]) ** 2
        self.pending.append(("K6", lambda: W.k6_work("stereo", live, pp, idx,
                                                     surv)))
        return out

    def _k6_flat(self, fn, a, pa, kw):
        out = fn(*pa, **kw)
        live, idx = a["live"].clone(), a["rows"].clone()
        pp = int(a["patch_size"]) ** 2
        self.pending.append(("K6", lambda: W.k6_work("flat", live, pp, idx)))
        return out

    def _k6_temporal(self, fn, a, pa, kw):
        out = fn(*pa, **kw)
        live, idx = a["cmask"].clone(), a["cf_idx"].clone()
        pp = int(a["patch_size"]) ** 2
        self.pending.append(("K6", lambda: W.k6_work("temporal", live, pp,
                                                     idx)))
        return out

    def _k7(self, fn, a, pa, kw):
        out = fn(*pa, **kw)
        B = a["x"].shape[0]
        H, W_ = a["img"].shape
        pp = int(a["patch_size"]) ** 2
        live = a.get("live")
        live = None if live is None else live.clone()
        self.pending.append(("K7", lambda: W.k7_work(B, pp, H, W_, live)))
        return out

    def _k8(self, fn, a, pa, kw):
        out = fn(*pa, **kw)
        gate, index = a["gate"], a["index"]
        n_out = out.numel()
        sel = (None if gate is None
               else (gate if index is None else gate[index]).clone())
        valid = a["valid"].clone()
        Q = a["gamma"].shape[0]

        def count():
            n_gated = n_out if sel is None else int(sel.sum())
            return W.k8_work(n_out, n_gated, Q, int(valid.sum()),
                             index is not None)
        self.pending.append(("K8", count))
        return out

    def _k9(self, fn, a, pa, kw):
        out = fn(*pa, **kw)
        Q = a["gamma"].shape[0]
        self.pending.append(("K9", lambda: W.k9_work(Q)))
        return out
