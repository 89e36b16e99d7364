"""Seeded numpy inputs for K6 (the dense NCC and descriptor gates) and K7
(two-side edge patches): the cases the port's CPU tests hold the twins
against JAX with, and its `gpu` tests hold the kernels against the twins
with. No JAX here, and torch only inside the helpers at the end
(`gate_tensors`, `k6_args`, `gate_errors`, and the kernels against the
JAX fixture, `k6_against_jax` and `k7_against_jax`).

`stereo_case(name)` returns the operands of the stereo entry: bf16-valued
float32 descriptors l_desc (N, 256) and r_desc (Nr, 256), cand (N, C)
int64, cmask (N, C) bool, FLAT float32 patches l_pat (N, 2 P^2) and r_pat
(Nr, 2 P^2) with ok flags (., 2). The first N right rows are noisy copies
of the left rows, and about a third of the candidates point at the row's
own copy, so that both gates pass on some slots and fail on others.
`flat_case(name)` lays a stereo case out as stage 11's flat list.
`temporal_case(name)` returns the temporal entry's operands: the KF side
of two stereo cases against their right tables as the CF mates, CF
patches still float32 (the caller rounds them to bf16).
`patch_case(name, B)` returns an image (H, W) and edges x, y, theta (B,).
The gate cases take another `patch_size` (P = 7 by default: the JAX
fixture's); at P = 7 their draws are the same.
"""

import numpy as np

P = 7
PP = P * P
SHIFT = 5.0                    # VOConfig().orthogonal_shift_mag
SIFT = 500.0                   # VOConfig().sift_threshold
H, W = 60, 90
N_ROWS, N_RIGHT = 64, 96

GATE_CASES = ("interior", "degenerate", "not_ok", "live_counts", "wide_33",
              "wide_64", "equal_halves", "nonfinite")
PATCH_CASES = ("interior", "borders", "off_image", "nan_positions",
               "axis_angles")
N_EDGES = 64


def bf16(a):
    """float32 values rounded to the nearest bf16, ties to even (NaN kept),
    as float32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    out = r.view(np.float32)
    return np.where(np.isnan(a), np.float32(np.nan), out).astype(np.float32)


def _slots(name):
    return {"wide_33": 33, "wide_64": 64}.get(name, 32)


def stereo_case(name, seed=0, patch_size=P):
    g = np.random.default_rng(seed)
    N, Nr, C = N_ROWS, N_RIGHT, _slots(name)
    PP = patch_size * patch_size
    l_desc = g.random((N, 256)) * 120.0
    r_desc = g.random((Nr, 256)) * 120.0
    r_desc[:N] = np.maximum(l_desc + g.normal(0, 6.0, (N, 256)), 0.0)
    l_pat = g.random((N, 2 * PP)) * 255.0
    r_pat = g.random((Nr, 2 * PP)) * 255.0
    r_pat[:N] = 0.8 * l_pat + 20.0 + g.normal(0, 8.0, (N, 2 * PP))
    l_ok = np.ones((N, 2), bool)
    r_ok = np.ones((Nr, 2), bool)
    own = g.random((N, C)) < 0.35
    cand = np.where(own, np.arange(N)[:, None], g.integers(0, Nr, (N, C)))
    cmask = g.random((N, C)) < 0.5
    if name == "degenerate":
        # constant sides: a sum of squares of 0, the pairing scores -1
        l_pat[::3, :PP] = 77.0
        l_pat[1::5, PP:] = 3.0
        r_pat[::4, PP:] = 12.0
        r_pat[N + 1::3, :PP] = 0.0
    elif name == "not_ok":
        l_ok = g.random((N, 2)) > 0.3
        r_ok = g.random((Nr, 2)) > 0.3
    elif name == "live_counts":
        # rows with no live slot, one, and every slot
        k = np.arange(N) % 3
        cmask[k == 0] = False
        one = np.zeros_like(cmask)
        one[np.arange(N), g.integers(0, C, N)] = True
        cmask = np.where((k == 1)[:, None], one, cmask)
        cmask[k == 2] = True
    elif name == "equal_halves":
        # halves equal to each other (ties in the 4-way min), candidates
        # near the row or near the row with its halves swapped (the cross
        # pairing wins); `copies` makes them exact
        half = l_desc[:, :128]
        l_desc[::2] = np.concatenate([half, half], 1)[::2]
        swapped = np.concatenate([l_desc[:, 128:], l_desc[:, :128]], 1)
        noise = g.uniform(-1.5, 1.5, (N, 256))
        k = (np.arange(N) % 3)[:, None]
        r_desc[:N] = np.where(k == 0, l_desc + noise, r_desc[:N])
        r_desc[:N] = np.where(k == 1, swapped + noise, r_desc[:N])
        r_pat[:N:2] = l_pat[::2]
    elif name == "nonfinite":
        # K5 writes a whole half NaN; a patch with NaN samples is not ok
        l_desc[::7, :128] = np.nan
        r_desc[3::5, 128:] = np.nan
        l_pat[::6, :5] = np.nan
        l_ok[::6, 0] = False
        r_pat[2::4, PP + 3] = np.nan
        r_ok[2::4, 1] = False
    return dict(l_desc=bf16(l_desc), r_desc=bf16(r_desc),
                cand=cand.astype(np.int64), cmask=cmask,
                l_pat=l_pat.astype(np.float32), l_ok=l_ok,
                r_pat=r_pat.astype(np.float32), r_ok=r_ok)


def copies(seed=0):
    """The `equal_halves` case with its near candidates made exact: each
    own-row candidate equals the row, or is the row with its halves
    swapped, so that one cross distance is exactly 0 in exact
    arithmetic."""
    s = stereo_case("equal_halves", seed)
    a = s["l_desc"]
    k = (np.arange(N_ROWS) % 3)[:, None]
    swapped = np.concatenate([a[:, 128:], a[:, :128]], 1)
    s["r_desc"][:N_ROWS] = np.where(k == 0, a, np.where(k == 1, swapped,
                                                        s["r_desc"][:N_ROWS]))
    return s


def flat_case(name, seed=0, patch_size=P):
    """The stereo case's (row, slot) pairs as stage 11's flat list: rows
    (N C,), the candidates' patches (N C, 2 P^2) and flags, live = cmask."""
    s = stereo_case(name, seed, patch_size)
    N, C = s["cmask"].shape
    j = s["cand"].reshape(-1)
    return dict(l_pat=s["l_pat"], l_ok=s["l_ok"],
                rows=np.repeat(np.arange(N, dtype=np.int64), C),
                r_pat=s["r_pat"][j], r_ok=s["r_ok"][j],
                live=s["cmask"].reshape(-1))


def temporal_case(name, seed=0, patch_size=P):
    a, b = (stereo_case(name, seed + k, patch_size) for k in (0, 1))
    return dict(kf_pat_l=a["l_pat"], kf_ok_l=a["l_ok"],
                kf_pat_r=b["l_pat"], kf_ok_r=b["l_ok"],
                kf_desc_l=a["l_desc"], kf_desc_r=b["l_desc"],
                cf_pat=np.concatenate([a["r_pat"], b["r_pat"]], 1),
                cf_ok=np.concatenate([a["r_ok"], b["r_ok"]], 1),
                cf_desc=np.concatenate([a["r_desc"], b["r_desc"]], 1),
                cf_idx=a["cand"], cmask=a["cmask"])


def _image(g):
    """A smooth random image of 0-255 with some texture."""
    img = g.random((H + 8, W + 8)) * 255
    for axis in (0, 1):                       # two 5-tap box blurs
        c = np.cumsum(img, axis=axis)
        img = (np.take(c, range(5, c.shape[axis]), axis=axis)
               - np.take(c, range(c.shape[axis] - 5), axis=axis)) / 5
    return img[:H, :W].astype(np.float32)


def patch_case(name, B=N_EDGES, seed=0):
    g = np.random.default_rng(seed)
    img = _image(g)
    x, y = g.uniform(12, W - 12, B), g.uniform(12, H - 12, B)
    th = g.uniform(-np.pi, np.pi, B)
    if name == "borders":
        # patches across the four borders: ok flags off, reads clamped
        side = np.arange(B) % 4
        x = np.where(side == 0, g.uniform(0, 4, B), x)
        x = np.where(side == 1, g.uniform(W - 4, W - 1, B), x)
        y = np.where(side == 2, g.uniform(0, 4, B), y)
        y = np.where(side == 3, g.uniform(H - 4, H - 1, B), y)
    elif name == "off_image":
        x = np.where(g.random(B) < 0.5, g.uniform(-40, -6, B),
                     g.uniform(W + 6, W + 40, B))
        y = g.uniform(-40, H + 40, B)
    elif name == "nan_positions":
        k = np.arange(B) % 4
        x = np.where(k == 1, np.nan, x)
        y = np.where(k == 2, np.nan, y)
        th = np.where(k == 3, np.nan, th)
    elif name == "axis_angles":
        th = np.array([0.0, np.pi / 2, -np.pi / 2, np.pi, -np.pi])[
            np.arange(B) % 5]
    else:
        assert name == "interior", name
    return img, tuple(a.astype(np.float32) for a in (x, y, th))


def gate_tensors(case, dev):
    """A case (numpy) as tensors on `dev`, the descriptors and the CF
    patches in bf16."""
    import torch

    out = {}
    for k, v in case.items():
        v = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        out[k] = v.to(torch.bfloat16) if "desc" in k or k == "cf_pat" else v
    return out


def k6_args(kind, t, patch_size=None):
    """(args, kwargs) of K6's `kind` entry ("stereo", "temporal", "flat")
    on a case's tensors (made at `patch_size`, the cases' P = 7 if None),
    with the fills the cascades use."""
    P_ = P if patch_size is None else patch_size
    if kind == "stereo":
        return ((t["l_desc"], t["r_desc"], t["cand"], t["cmask"], t["l_pat"],
                 t["l_ok"], t["r_pat"], t["r_ok"], SIFT, P_),
                dict(fill_dist=2 * SIFT, fill_ncc=0.0))
    if kind == "temporal":
        return ((t["kf_pat_l"], t["kf_ok_l"], t["kf_pat_r"], t["kf_ok_r"],
                 t["kf_desc_l"], t["kf_desc_r"], t["cf_pat"], t["cf_ok"],
                 t["cf_desc"], t["cf_idx"], t["cmask"], P_),
                dict(fill_ncc=-1.0, fill_dist=900.0))
    assert kind == "flat", kind
    return ((t["l_pat"], t["l_ok"], t["rows"], t["r_pat"], t["r_ok"],
             t["live"], P_), dict(fill=0.6 + 1e-6))


def gate_errors(a, b, mask, tol, relative=False):
    """Entries of `mask` where a and b (numpy) differ past the CPU tests'
    tolerance against JAX: NaN in one only, or |a - b| > atol + rtol |b|
    (relative: rtol = tol, atol = tol max(1, max |b|) as
    tests/test_torch_ops.py's `close`; else atol = tol). Returns (that
    count, the largest |a - b| over the entries finite in both)."""
    mask = np.asarray(mask, bool)
    a = np.asarray(a, np.float64)[mask]
    b = np.asarray(b, np.float64)[mask]
    fin = np.isfinite(a) & np.isfinite(b)
    scale = max(1.0, float(np.abs(b[fin]).max())) if fin.any() else 1.0
    atol, rtol = (tol * scale, tol) if relative else (tol, 0.0)
    d = np.abs(np.where(fin, a - b, 0.0))
    bad = ((np.isnan(a) != np.isnan(b))
           | (fin & (d > atol + rtol * np.abs(np.where(fin, b, 0.0))))
           | (~fin & ~np.isnan(a) & (a != b)))
    return int(bad.sum()), float(d.max()) if d.size else 0.0


def k6_against_jax(dev):
    """K6 on the card against the JAX package's `min_cross_distance_dot`
    and `ncc4` on every case (`tests/data/k6_k7_jax_reference.npz`):
    {case: (entries past the CPU tests' tolerance, the largest distance
    and NCC differences)}; the distances within 0.05 on the live slots,
    the NCC within 1e-5 of max(1, |b|) on the pairs it computed."""
    from edge_based_visual_odometry_tpu_torch.ops import patches as PAT
    from scripts import k6_k7_jax_reference as KJ

    res = {}
    with np.load(KJ.PATH) as ref:
        for name in GATE_CASES:
            s = stereo_case(name)
            a, kw = k6_args("stereo", gate_tensors(s, dev))
            d, n = (x.cpu().numpy() for x in PAT.dense_gates_stereo_cuda(*a,
                                                                        **kw))
            f = flat_case(name)
            a, kw = k6_args("flat", gate_tensors(f, dev))
            fl = PAT.dense_gates_flat_cuda(*a, **kw).cpu().numpy()
            tc = temporal_case(name)
            a, kw = k6_args("temporal", gate_tensors(tc, dev))
            tm = PAT.dense_gates_temporal_cuda(*a, **kw).cpu().numpy()
            rd, rn = ref[f"stereo/{name}/dist"], ref[f"stereo/{name}/ncc"]
            rt = ref[f"temporal/{name}"]
            live, tlive = s["cmask"], tc["cmask"]
            errs = [gate_errors(d, rd, live, 0.05),
                    gate_errors(n, rn, live & (d < SIFT), 1e-5, True),
                    gate_errors(fl, rn.reshape(-1), f["live"], 1e-5, True)]
            errs += [gate_errors(tm[q], rt[q], tlive, 1e-5, True)
                     for q in (0, 1)]
            errs += [gate_errors(tm[q], rt[q], tlive, 0.05) for q in (2, 3)]
            res[name] = (sum(e[0] for e in errs),
                         max(errs[0][1], errs[5][1], errs[6][1]),
                         max(errs[1][1], errs[2][1], errs[3][1],
                             errs[4][1]))
    return res


def k7_against_jax(dev):
    """K7 on the card against the JAX package's `edge_patches_tiled` on
    every patch case (the same file): {case: (values past 1e-5 of
    max(1, |b|) or NaN in one only, the largest difference, ok flags that
    differ)}."""
    import torch

    from edge_based_visual_odometry_tpu_torch.ops import patches as PAT
    from scripts import k6_k7_jax_reference as KJ

    res = {}
    with np.load(KJ.PATH) as ref:
        for name in PATCH_CASES:
            img, edges = patch_case(name)
            pat, ok = (x.cpu().numpy() for x in PAT.edge_patches_cuda(
                *(torch.from_numpy(a).to(dev) for a in (img, *edges)),
                P, SHIFT))
            n_bad, err = gate_errors(pat, ref[f"patches/{name}/pat"],
                                     np.ones(pat.shape, bool), 1e-5, True)
            res[name] = (n_bad, err,
                         int((ok != ref[f"patches/{name}/ok"]).sum()))
    return res
