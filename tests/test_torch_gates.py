"""K6's and K7's plain twins (`ops/patches.py`: `dense_gates_*_plain`,
`edge_patches_plain`) against the JAX package on the seeded cases of
`tests/gate_cases.py`, against the port's JAX-faithful forms (`ncc4`,
`min_cross_distance_dot`), their kernel's lane order, the bf16 rounding of
the CF patches, the JAX fixture the card reads, the CPU dispatch, and a
120x160 run showing that no reader of the gate scores takes a slot the
gates did not compute. The kernels themselves run only on the card
(`tests/test_torch_cuda.py`, marker `gpu`).

Tolerances against JAX are those of `tests/test_torch_ops.py`: NCC and
patch values within 1e-5 (relative, and absolute at 1e-5 max(1, |b|):
float32 sums in another order), descriptor distances within 0.05
(|a|^2 + |b|^2 - 2 a.b cancels at small distances); masks, flags and
NaN positions exactly equal.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax.numpy as jnp

from edge_based_visual_odometry_tpu.ops import descriptors as JD
from edge_based_visual_odometry_tpu.ops import patches as JP
from edge_based_visual_odometry_tpu_torch import geometry as G
from edge_based_visual_odometry_tpu_torch.config import VOConfig
from edge_based_visual_odometry_tpu_torch.io import synthetic as S
from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.ops import descriptors as D
from edge_based_visual_odometry_tpu_torch.ops import patches as P
from scripts import k6_k7_jax_reference as KJ
from tests import gate_cases as GC

torch.set_num_threads(2)
CPU = torch.device("cpu")
NCC_TOL, DIST_TOL, PATCH_TOL = 1e-5, 0.05, 1e-5


def _near(a, b, mask, tol, relative):
    n_bad, err = GC.gate_errors(a, b, mask, tol, relative)
    assert n_bad == 0, f"{n_bad} entries past {tol} (largest {err})"


def _stereo(name):
    s = GC.stereo_case(name)
    a, kw = GC.k6_args("stereo", GC.gate_tensors(s, CPU))
    return s, a, kw


@pytest.mark.parametrize("name", GC.GATE_CASES)
def test_stereo_twin_matches_jax(name):
    """Distances on the live slots, NCC on the slots past the descriptor
    gate, the fills elsewhere, against JAX's `min_cross_distance_dot` and
    `ncc4` on the same arrays."""
    s, a, kw = _stereo(name)
    dist, ncc = (x.numpy() for x in P.dense_gates_stereo_plain(*a, **kw))
    live = s["cmask"]
    surv = live & (dist < GC.SIFT)
    assert surv.any() and (live & ~surv).any()
    j = s["cand"]
    ref_d = np.asarray(JD.min_cross_distance_dot(
        jnp.asarray(s["l_desc"]).astype(jnp.bfloat16),
        jnp.asarray(s["r_desc"][j]).astype(jnp.bfloat16)))
    pp = GC.PP
    lp, rp = s["l_pat"][:, None], s["r_pat"][j]
    lo, ro = s["l_ok"][:, None], s["r_ok"][j]
    ref_n = np.asarray(JP.ncc4(*(jnp.asarray(x) for x in (
        lp[..., :pp], lp[..., pp:], lo[..., 0], lo[..., 1], rp[..., :pp],
        rp[..., pp:], ro[..., 0], ro[..., 1]))))
    _near(dist, ref_d, live, DIST_TOL, False)
    _near(ncc, ref_n, surv, NCC_TOL, True)
    assert np.all(dist[~live] == kw["fill_dist"])
    assert np.all(ncc[~surv] == kw["fill_ncc"])


@pytest.mark.parametrize("name", GC.GATE_CASES)
def test_temporal_twin_matches_jax(name):
    """Both sides' NCC (the CF patches rounded to bf16) and distances on
    the live slots against JAX (the fixture's arrays, which
    `test_jax_reference_file_is_current` recomputes), fills elsewhere."""
    t = GC.temporal_case(name)
    a, kw = GC.k6_args("temporal", GC.gate_tensors(t, CPU))
    out = P.dense_gates_temporal_plain(*a, **kw).numpy()
    ref = KJ.temporal(name)
    live = t["cmask"]
    for q in range(4):
        _near(out[q], ref[q], live, NCC_TOL if q < 2 else DIST_TOL, q < 2)
    assert np.all(out[:2][:, ~live] == -1.0)
    assert np.all(out[2:][:, ~live] == 900.0)


@pytest.mark.parametrize("name", GC.GATE_CASES)
def test_flat_twin_matches_jax(name):
    f = GC.flat_case(name)
    a, kw = GC.k6_args("flat", GC.gate_tensors(f, CPU))
    out = P.dense_gates_flat_plain(*a, **kw).numpy()
    _, ref = KJ.stereo(name)
    _near(out, ref.reshape(-1), f["live"], NCC_TOL, True)
    assert np.all(out[~f["live"]] == kw["fill"])


@pytest.mark.parametrize("name", GC.PATCH_CASES)
def test_patches_twin_matches_jax(name):
    img, edges = GC.patch_case(name)
    pat, ok = P.edge_patches_plain(*(torch.from_numpy(x) for x in
                                     (img, *edges)), GC.P, GC.SHIFT)
    ref_pat, ref_ok = KJ.patches(name)
    _near(pat.numpy(), ref_pat, np.ones(ref_pat.shape, bool), PATCH_TOL,
          True)
    assert np.array_equal(ok.numpy(), ref_ok)
    # the 4-tuple wrapper is views of the same arrays
    pp_, pm_, okp, okm = P.edge_patches(*(torch.from_numpy(x) for x in
                                          (img, *edges)), GC.P, GC.SHIFT)
    _equal(torch.cat([pp_, pm_], 1), pat, "patches")
    _equal(torch.stack([okp, okm], 1), ok, "ok flags")


@pytest.mark.parametrize("name", GC.GATE_CASES)
def test_twins_match_the_jax_faithful_forms(name):
    """The twins' lane order against the port's `ncc4` (torch's mean and
    sums) and `min_cross_distance_dot` (an einsum) on every slot."""
    s, a, kw = _stereo(name)
    t = GC.gate_tensors(s, CPU)
    j = t["cand"]
    rows = t["l_desc"][:, None].expand(-1, j.shape[1], -1)
    d_lane = P.desc_distance_lanes(rows, t["r_desc"][j])
    d_ref = D.min_cross_distance_dot(t["l_desc"], t["r_desc"][j])
    _near(d_lane.numpy(), d_ref.numpy(), np.ones(j.shape, bool), DIST_TOL,
          False)
    pp = GC.PP
    lp, rp = t["l_pat"][:, None], t["r_pat"][j]
    lo, ro = t["l_ok"][:, None], t["r_ok"][j]
    n_lane = P.ncc4_lanes(lp, lo, rp, ro, GC.P)
    n_ref = P.ncc4(lp[..., :pp], lp[..., pp:], lo[..., 0], lo[..., 1],
                   rp[..., :pp], rp[..., pp:], ro[..., 0], ro[..., 1])
    _near(n_lane.numpy(), n_ref.numpy(), np.ones(j.shape, bool), NCC_TOL,
          True)


def _lane_sum_before_p9(v):
    """K6's `_lane_sum` as it was while K6 took P*P <= 64 only, frozen:
    two samples a lane, then the butterfly."""
    s = F.pad(v, (0, 64 - v.shape[-1])).reshape(*v.shape[:-1], 2, 32)
    s = s[..., 0, :] + s[..., 1, :]
    for o in (16, 8, 4, 2, 1):
        s = s[..., :o] + s[..., o:2 * o]
    return s[..., 0]


@pytest.mark.parametrize("n", range(1, 65))
def test_lane_sum_is_bit_equal_to_its_form_before_p9(n):
    """At every side it took (n <= 64), `_lane_sum` gives the bits it gave
    before it took 128 samples a side."""
    v = torch.from_numpy(np.random.default_rng(n).normal(0, 100, (7, n))
                         .astype(np.float32))
    assert torch.equal(P._lane_sum(v), _lane_sum_before_p9(v))


@pytest.mark.parametrize("n", [18, 50, 81, 98, 121])
def test_lane_sum_is_near_the_float64_sum(n):
    """Four samples a lane past 64 (P = 9: 81, P = 11: 121): every sample
    added once, within float32 rounding of the float64 sum (n ulps of the
    sum of magnitudes)."""
    a = np.random.default_rng(n).normal(0, 100, (9, n)).astype(np.float32)
    ref = a.astype(np.float64).sum(-1)
    tol = n * np.finfo(np.float32).eps * np.abs(a).astype(np.float64).sum(-1)
    got = P._lane_sum(torch.from_numpy(a)).numpy().astype(np.float64)
    assert np.all(np.abs(got - ref) <= tol), (got - ref, tol)
    # a lane's 4 slots in order, then the butterfly
    lanes = torch.zeros(9, 32)
    for s_ in range(n):
        lanes[:, s_ % 32] = lanes[:, s_ % 32] + torch.from_numpy(a[:, s_])
    for o in (16, 8, 4, 2, 1):
        lanes = lanes[:, :o] + lanes[:, o:2 * o]
    assert torch.equal(P._lane_sum(torch.from_numpy(a)), lanes[:, 0])


@pytest.mark.parametrize("patch_size", [3, 5, 9, 11])
def test_ncc4_lanes_matches_jax_at_other_patch_sizes(patch_size):
    """`ncc4_lanes` (K6's twin) against JAX's `ncc4` on 256 random patch
    pairs with random ok flags and some constant sides, at the tolerance
    of the P = 7 cases (1e-5 of max(1, |b|))."""
    pp = patch_size * patch_size
    g = np.random.default_rng(100 + patch_size)
    a = (g.random((256, 2 * pp)) * 255).astype(np.float32)
    b = (0.7 * a + 30 + g.normal(0, 20, a.shape)).astype(np.float32)
    b[::3] = (g.random((b[::3].shape)) * 255).astype(np.float32)
    a[::17, :pp] = 40.0
    b[5::19, pp:] = 7.0
    ao, bo = g.random((256, 2)) > 0.2, g.random((256, 2)) > 0.2
    out = P.ncc4_lanes(*(torch.from_numpy(x) for x in (a, ao, b, bo)),
                       patch_size).numpy()
    ref = np.asarray(JP.ncc4(*(jnp.asarray(x) for x in (
        a[:, :pp], a[:, pp:], ao[:, 0], ao[:, 1], b[:, :pp], b[:, pp:],
        bo[:, 0], bo[:, 1]))))
    _near(out, ref, np.ones(out.shape, bool), NCC_TOL, True)
    assert (ref > 0.5).any() and (ref == -1.0).any()


@pytest.mark.parametrize("patch_size", [9, 11])
@pytest.mark.parametrize("name", ["interior", "degenerate", "nonfinite"])
def test_k6_pair_model_equals_the_twins_past_p7(name, patch_size):
    """K6's pair arithmetic at 4 samples a lane (P = 9, 11) and the built
    8 slots a step (`_k6_pairs`) bit-equal to the twins on every slot of
    the case made at that P."""
    t = GC.gate_tensors(GC.stereo_case(name, patch_size=patch_size), CPU)
    j = t["cand"]
    a_pat, a_ok = t["l_pat"][:, None], t["l_ok"][:, None]
    gate, dist = _k6_pairs(a_pat, a_ok, t["r_pat"][j], t["r_ok"][j],
                           t["l_desc"][:, None], t["r_desc"][j], patch_size,
                           8)
    _equal(gate, P.ncc4_lanes(a_pat, a_ok, t["r_pat"][j], t["r_ok"][j],
                              patch_size), "NCC gate")
    rows = t["l_desc"][:, None].expand(-1, j.shape[1], -1)
    _equal(dist, P.desc_distance_lanes(rows, t["r_desc"][j]), "distance")


@pytest.mark.parametrize("n", [49, 25, 9, 64, 1])
def test_lane_sum_is_two_samples_a_lane_then_a_butterfly(n):
    v = torch.from_numpy(np.random.default_rng(n).normal(0, 100, (5, n))
                         .astype(np.float32))
    lanes = torch.zeros(5, 32)
    for s in range(n):
        lanes[:, s % 32] = lanes[:, s % 32] + v[:, s]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes[:, :o] + lanes[:, o:2 * o]
    assert torch.equal(P._lane_sum(v), lanes[:, 0])


# K6's gates take SLOTS live slots a warp step, 32 / SLOTS lanes a slot:
# a lane adds its own leaves of a sum (those congruent to it modulo the
# lanes) in the butterfly's order, then the slot's lanes finish the
# butterfly (csrc/dense_gates.cu `lane_tree`, `slot_sum`).
SLOTS = (2, 4, 8, 32)


def _node(leaves, h, lanes, t, m):
    """csrc/dense_gates.cu `lane_tree`: lane h's node t mod m over its T =
    N / lanes leaves h + lanes t (a recursion, depth first)."""
    T = leaves.shape[-1] // lanes
    if m == T:
        return leaves[..., h + lanes * t]
    return (_node(leaves, h, lanes, t, 2 * m)
            + _node(leaves, h, lanes, t + m, 2 * m))


def _stack_sum(leaves, h, lanes):
    """The same in-lane sum as a stream: the lane visits its leaves in
    bit-reversed order and keeps a stack of partials, adding the top two
    while they cover equal counts; at most log2(T) + 1 are kept."""
    T = leaves.shape[-1] // lanes
    bits = T.bit_length() - 1
    stack, deepest = [], 0
    for i in range(T):
        t = int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
        stack.append((leaves[..., h + lanes * t], 1))
        while len(stack) > 1 and stack[-1][1] == stack[-2][1]:
            (a, n), (b, _) = stack[-2], stack.pop()
            stack[-1] = (a + b, 2 * n)
        deepest = max(deepest, len(stack) + 1)
    assert len(stack) == 1 and deepest <= bits + 2
    return stack[0][0]


def _slot_sums(leaves, lanes, stack=False):
    """Every lane's result of a sum over (..., N) leaves with `lanes`
    lanes a slot: the in-lane part, then the butterfly over the lanes."""
    v = [(_stack_sum(leaves, h, lanes) if stack
          else _node(leaves, h, lanes, 0, 1)) for h in range(lanes)]
    o = lanes // 2
    while o:
        v = [v[h] + v[h ^ o] for h in range(lanes)]
        o //= 2
    return v


def _side_leaves(v):
    """A side sum's 32 leaves: lane l's samples l + 32 j in order (2 slots
    up to 64 samples, 4 up to 128), 0 past the side."""
    return P._lane_leaves(v)


def _chunk_leaves(a, b):
    """A half dot's 16 leaves: chunk q's 8 products in order."""
    p = a * b
    p = p.reshape(*p.shape[:-1], 16, 8)
    s = p[..., 0]
    for t in range(1, 8):
        s = s + p[..., t]
    return s


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("n", [49, 25, 9, 64, 1])
def test_in_lane_levels_equal_the_lane_sum(slots, n):
    """Every lane of a slot, at every slot count the gates were built
    with, ends with `_lane_sum`'s bits, by the recursion and by the
    bit-reversed stack (one lane a slot: no butterfly left)."""
    v = torch.from_numpy(np.random.default_rng(n).normal(0, 100, (5, n))
                         .astype(np.float32))
    ref = P._lane_sum(v)
    for stack in (False, True):
        for x in _slot_sums(_side_leaves(v), 32 // slots, stack):
            assert torch.equal(x, ref)


@pytest.mark.parametrize("slots", SLOTS)
def test_in_lane_levels_equal_the_half_dot(slots):
    g = np.random.default_rng(slots)
    a, b = (torch.from_numpy(GC.bf16(g.random((7, 128)) * 100))
            for _ in range(2))
    ref = P._half_dot(a, b)
    lanes = min(32 // slots, 16)        # a descriptor half has 16 chunks
    for stack in (False, True):
        for x in _slot_sums(_chunk_leaves(a, b), lanes, stack):
            assert torch.equal(x, ref)


def _k6_pairs(a, a_ok, b, b_ok, ad, bd, patch_size, slots):
    """K6's pair arithmetic modelled on the CPU at `slots` slots a step:
    the candidate's terms (its sides' means and sums of squares, its
    halves' |b|^2) formed once a row as the prep pass forms them, a
    candidate sample centred by one subtraction of the stored mean, the 4
    cross sums of a pairing or of a descriptor pair summed leaf by leaf in
    the slot's order. Returns (NCC gate, distance)."""
    pp = patch_size * patch_size
    inv = P._recip(pp)
    lanes = 32 // slots

    def terms(x):          # the prep pass: a side's mean and centring
        mean = P._lane_sum(x) * inv
        c = x - mean[..., None]
        return mean, P._lane_sum(c * c)

    ca = [P._centred(a[..., k * pp:(k + 1) * pp], inv) for k in (0, 1)]
    tb = [terms(b[..., k * pp:(k + 1) * pp]) for k in (0, 1)]
    cb = [b[..., k * pp:(k + 1) * pp] - tb[k][0][..., None] for k in (0, 1)]
    ncc = []
    for i, j in ((0, 0), (1, 1), (0, 1), (1, 0)):
        cross = _slot_sums(_side_leaves(ca[i][0] * cb[j]), lanes)[0]
        ssa, ssb = ca[i][1], tb[j][1]
        score = cross / torch.sqrt(torch.clamp(ssa * ssb,
                                               min=P.NCC_EPS * P.NCC_EPS))
        bad = ((ssa < P.NCC_EPS) | (ssb < P.NCC_EPS)
               | ~(a_ok[..., i] & b_ok[..., j]))
        ncc.append(torch.where(bad, torch.full_like(score, -1.0), score))
    gate = torch.maximum(torch.maximum(ncc[0], ncc[1]),
                         torch.maximum(ncc[2], ncc[3]))
    ad, bd = ad.to(torch.float32), bd.to(torch.float32)
    ah, bh = (ad[..., :128], ad[..., 128:]), (bd[..., :128], bd[..., 128:])
    dl = min(lanes, 16)
    a2 = [P._half_dot(h, h) for h in ah]
    b2 = [P._half_dot(h, h) for h in bh]        # the prep pass's
    d2 = [[(a2[i] + b2[j]) - 2.0 * _slot_sums(_chunk_leaves(ah[i], bh[j]),
                                              dl)[0]
           for j in (0, 1)] for i in (0, 1)]
    d = torch.minimum(torch.minimum(d2[0][0], d2[0][1]),
                      torch.minimum(d2[1][0], d2[1][1]))
    return gate, torch.sqrt(torch.clamp(d, min=0.0))


@pytest.mark.parametrize("slots", SLOTS)
@pytest.mark.parametrize("name", GC.GATE_CASES)
def test_k6_pair_model_equals_the_twins(name, slots):
    """K6's pair arithmetic at each slot count (`_k6_pairs`: the prep
    pass's stored terms, the in-lane levels) bit-equal to the twins'
    `ncc4_lanes` and `desc_distance_lanes` on every slot of the case, the
    CF patches of the temporal case rounded to bf16 as well."""
    s = GC.stereo_case(name)
    t = GC.gate_tensors(s, CPU)
    j = t["cand"]
    for b in (t["r_pat"], t["r_pat"].to(torch.bfloat16).to(torch.float32)):
        a_pat, a_ok = t["l_pat"][:, None], t["l_ok"][:, None]
        gate, dist = _k6_pairs(a_pat, a_ok, b[j], t["r_ok"][j],
                               t["l_desc"][:, None], t["r_desc"][j], GC.P,
                               slots)
        _equal(gate, P.ncc4_lanes(a_pat, a_ok, b[j], t["r_ok"][j], GC.P),
               "NCC gate")
        rows = t["l_desc"][:, None].expand(-1, j.shape[1], -1)
        _equal(dist, P.desc_distance_lanes(rows, t["r_desc"][j]),
               "distance")


def test_half_dot_is_eight_bins_a_lane_then_a_butterfly():
    g = np.random.default_rng(3)
    a, b = (torch.from_numpy(GC.bf16(g.random((7, 128)) * 100))
            for _ in range(2))
    terms = (a * b).reshape(7, 16, 8).unbind(-1)
    s = terms[0]
    for x in terms[1:]:
        s = s + x
    for o in (8, 4, 2, 1):
        s = s[:, :o] + s[:, o:2 * o]
    assert torch.equal(P._half_dot(a, b), s[:, 0])


def test_exact_copies_give_distance_zero():
    """A candidate equal to the row, or with its halves swapped: the lane
    order is the same on both sides of |a|^2 + |b|^2 - 2 a.b, so the
    twin's distance is exactly 0 (JAX's and the einsum's leave up to a few
    ulp of |a|^2 under the sqrt)."""
    s = GC.copies()
    a, kw = GC.k6_args("stereo", GC.gate_tensors(s, CPU))
    dist, _ = P.dense_gates_stereo_plain(*a, **kw)
    rows = np.arange(GC.N_ROWS)[:, None]
    exact = s["cmask"] & (s["cand"] == rows) & (rows % 3 < 2)
    assert exact.any() and bool((dist.numpy()[exact] == 0).all())


def test_cf_patch_rounding_equals_jax_bf16():
    """The temporal gates read the CF patches through `.to(bfloat16)`:
    round to nearest, ties to even, bit for bit JAX's `astype(bfloat16)`
    (values of the image range, exact ties and NaN)."""
    g = np.random.default_rng(0)
    v = np.concatenate([g.random(20000) * 255, np.arange(0, 256, 0.5),
                        [1.00390625, 1.01171875, 255.5, np.nan]])
    v = v.astype(np.float32)
    port = torch.from_numpy(v).to(torch.bfloat16).view(torch.int16).numpy()
    ref = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).view(jnp.int16))
    nan = np.isnan(v)
    assert np.array_equal(port[~nan], ref[~nan])
    assert np.array_equal(GC.bf16(v)[~nan].view(np.int32) >> 16,
                          ref[~nan].astype(np.int32) & 0xFFFF)


@pytest.mark.parametrize("name", GC.GATE_CASES)
def test_chunking_never_changes_results(name):
    s, a, kw = _stereo(name)
    whole = P.dense_gates_stereo_plain(*a, **kw)
    parts = P.dense_gates_stereo_plain(*a, **kw, chunk=37)
    for x, y in zip(whole, parts):
        _equal(x, y, "stereo gates")
    img, edges = GC.patch_case("nan_positions")
    args = [torch.from_numpy(x) for x in (img, *edges)] + [GC.P, GC.SHIFT]
    for x, y in zip(P.edge_patches_plain(*args),
                    P.edge_patches_plain(*args, chunk=5)):
        _equal(x, y, "patches")


@pytest.mark.parametrize("name", GC.GATE_CASES + GC.PATCH_CASES)
def test_jax_reference_file_is_current(name):
    """`tests/data/k6_k7_jax_reference.npz`, which K6's and K7's outputs on
    the card are held against where JAX is missing, equals JAX on the
    case now, bit for bit."""
    if name in GC.GATE_CASES:
        now = dict(zip((f"stereo/{name}/dist", f"stereo/{name}/ncc"),
                       KJ.stereo(name)))
        now[f"temporal/{name}"] = KJ.temporal(name)
    if name in GC.PATCH_CASES:
        now = dict(zip((f"patches/{name}/pat", f"patches/{name}/ok"),
                       KJ.patches(name)))
    with np.load(KJ.PATH) as ref:
        for k, v in now.items():
            assert np.array_equal(ref[k], v, equal_nan=True), k


def test_cpu_dispatch_never_builds_and_cuda_wrappers_refuse_cpu(monkeypatch):
    def no_build():
        raise AssertionError("CPU tensors must not build or launch a kernel")

    monkeypatch.setattr(CB, "lib", no_build)
    before = dict(CB.LAUNCHES)
    _, a, kw = _stereo("interior")
    P.dense_gates_stereo(*a, **kw)
    t = GC.gate_tensors(GC.temporal_case("interior"), CPU)
    at, kwt = GC.k6_args("temporal", t)
    P.dense_gates_temporal(*at, **kwt)
    f = GC.gate_tensors(GC.flat_case("interior"), CPU)
    af, kwf = GC.k6_args("flat", f)
    P.dense_gates_flat(*af, **kwf)
    img, edges = GC.patch_case("interior")
    pa = [torch.from_numpy(x) for x in (img, *edges)] + [GC.P, GC.SHIFT]
    P.edge_patches_flat(*pa)
    assert CB.LAUNCHES == before
    for fn, args, kw_ in ((P.dense_gates_stereo_cuda, a, kw),
                          (P.dense_gates_temporal_cuda, at, kwt),
                          (P.dense_gates_flat_cuda, af, kwf),
                          (P.edge_patches_cuda, pa, {})):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            fn(*args, **kw_)


SMALL = dict(max_edges=1024, max_candidates=8, gather_slots=64,
             max_mates=512, max_refine_pairs=1024, max_quad_candidates=8,
             quad_gather_slots=144, ransac_max_iterations=256, gn_max_iter=4)


def _nan_on_dead(monkeypatch):
    """The K6 wrappers, writing NaN on every slot their gates did not
    compute instead of the fill, and K7's given a `live` mask (stage 11),
    NaN patches and flipped ok flags on every dead entry."""
    stereo, temporal, flat = (P.dense_gates_stereo, P.dense_gates_temporal,
                              P.dense_gates_flat)

    def stereo_nan(*a, **kw):
        dist, ncc = stereo(*a, **kw)
        live = a[3]
        ncc = torch.where(live & (dist < a[8]), ncc, float("nan"))
        return torch.where(live, dist, float("nan")), ncc

    def temporal_nan(*a, **kw):
        return torch.where(a[10], temporal(*a, **kw), float("nan"))

    def flat_nan(*a, **kw):
        return torch.where(a[5], flat(*a, **kw), float("nan"))

    patches = P.edge_patches_flat

    def patches_nan(*a, live=None, **kw):
        # stage 11's call: K7 leaves the dead entries' rows unwritten
        pat, ok = patches(*a, **kw)
        if live is None:
            return pat, ok
        return (torch.where(live[:, None], pat, float("nan")),
                torch.where(live[:, None], ok, ~ok))

    monkeypatch.setattr(P, "dense_gates_stereo", stereo_nan)
    monkeypatch.setattr(P, "dense_gates_temporal", temporal_nan)
    monkeypatch.setattr(P, "dense_gates_flat", flat_nan)
    monkeypatch.setattr(P, "edge_patches_flat", patches_nan)


def _run(seq, supervised, n_frames):
    cfg = VOConfig(**SMALL)
    kw = (dict(has_gt_disparity=True, use_gt_pose=True,
               record_distributions=True) if supervised else {})
    pipe = PL.VOPipeline(seq.rig, cfg, device="cpu", **kw)
    out = []
    for f in seq.frames[:n_frames]:
        left, right = (np.round(a).clip(0, 255).astype(np.uint8)
                       for a in (f.left, f.right))
        if supervised:
            gt = G.Pose(torch.from_numpy(f.R.astype(np.float32)),
                        torch.from_numpy(f.t.astype(np.float32)))
            out.append(pipe.run_frame(left, right, f.disparity, gt))
        else:
            out.append(pipe.run_frame(left, right))
    return out


def _equal(x, y, what):
    """Equal tensors, a NaN equal to a NaN."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    if x.is_floating_point():
        assert torch.equal(x.isnan(), y.isnan()), what
        x, y = torch.nan_to_num(x), torch.nan_to_num(y)
    assert torch.equal(x, y), what


def _same_result(a, b):
    """Equal mates, stage rows, distributions on their masks, quads and
    pose."""
    for (fa, ta), (fb, tb) in zip(a, b):
        for name, x, y in zip(fa.mates._fields, fa.mates, fb.mates):
            _equal(x, y, f"mates.{name}")
        _equal(fa.stereo_metrics, fb.stereo_metrics, "stereo rows")
        for k, v in (fa.distributions or {}).items():
            w = fb.distributions[k]
            if k.endswith("_state") or k == "right_edges_xyt":
                continue
            _equal(v[-1], w[-1], f"{k} mask")
            if len(v) == 3:             # (values, is_gt, mask)
                _equal(v[0][v[-1]], w[0][w[-1]], f"{k} values")
                _equal(v[1], w[1], f"{k} is_gt")
        assert (ta is None) == (tb is None)
        if ta is not None:
            _equal(ta.n_quads, tb.n_quads, "quads")
            _equal(ta.temporal_metrics, tb.temporal_metrics, "temporal rows")
            _equal(ta.R, tb.R, "R")
            _equal(ta.t, tb.t, "t")


@pytest.mark.parametrize("supervised", [False, True])
def test_no_reader_takes_a_dead_slot(monkeypatch, supervised):
    """A 120x160 run with the gates writing NaN on the slots they did not
    compute gives the same mates, stage rows, distributions (on their
    masks), quads and pose as with the fills the cascades name: every
    reader of the scores (`_bnb_keep`, the stage-9 scatter-back, stage
    12's argmax, the evaluation writers' masks) reads through the mask,
    and stage 11's NCC reads no patch row K7 may leave unwritten."""
    seq = S.make_sequence(2, 120, 160)
    ref = _run(seq, supervised, 2)
    _nan_on_dead(monkeypatch)
    _same_result(ref, _run(seq, supervised, 2))
