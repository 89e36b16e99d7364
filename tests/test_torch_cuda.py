"""The hand-written CUDA kernels (K1, TOED's NMS and compaction, K2, K3,
K3's both-sides launch, K4, K5, K6's three entries, K7, K8, K9, the
gather windows' compaction, the best/nearly-best streak filter) against
their plain-PyTorch twins, on the card: on seeded cases, and on every
call of a full-size frame of each benchmark cell (`tests/frame_calls.py`);
and the paths through them (the pipeline, BA, the CLI, the NCCL pair step
and its production memory). Every test here needs a CUDA device (marker
`gpu`) and skips without one. The file imports no JAX, so it also runs
where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import functools

import numpy as np
import pytest
import torch

from edge_based_visual_odometry_tpu_torch.config import VOConfig
from edge_based_visual_odometry_tpu_torch.io import synthetic as S
from edge_based_visual_odometry_tpu_torch.models import motion_tracker as MT
from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
from edge_based_visual_odometry_tpu_torch.models import stereo_matcher as SM
from edge_based_visual_odometry_tpu_torch.models import types as TY
from edge_based_visual_odometry_tpu_torch.ops import clustering as CL
from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.ops import descriptors as DESC
from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
from edge_based_visual_odometry_tpu_torch.ops import grid as GRID
from edge_based_visual_odometry_tpu_torch.ops import image as IMG
from edge_based_visual_odometry_tpu_torch.ops import patches as PAT
from edge_based_visual_odometry_tpu_torch.ops import pose as POSE
from edge_based_visual_odometry_tpu_torch.ops import toed as T
from scripts import k4_jax_reference as K4J
from scripts import k5_jax_reference as KJ
from tests import bnb_cases as BC
from tests import cluster_cases as CC
from tests import compact_cases as CPC
from tests import descriptor_cases as DC
from tests import frame_calls as FC
from tests import gate_cases as GC
from tests import pose_cases as PC
from tests import toed_nms_cases as NC

pytestmark = pytest.mark.gpu

SMALL = dict(max_edges=1024, max_candidates=8, gather_slots=64,
             max_mates=512, max_refine_pairs=1024, max_quad_candidates=8,
             quad_gather_slots=144, ransac_max_iterations=256, gn_max_iter=4)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _u8(a):
    return np.round(a).clip(0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def frame():
    f = S.make_sequence(1, 120, 160).frames[0]
    return _u8(f.left), _u8(f.right), f.disparity


@pytest.mark.parametrize("shape", [(2, 96, 200), (1, 17, 70), (2, 120, 160)])
def test_toed_kernel_matches_twin(dev, frame, shape):
    if shape == (2, 120, 160):
        img = np.stack(frame[:2]).astype(np.float32)
    else:
        img = (np.random.default_rng(0).random(shape) * 255).astype(np.float32)
    x = torch.from_numpy(img).to(dev)
    out = T.toed_gradient_field_cuda(x)
    ref = T.toed_gradient_field_plain(x)
    torch.cuda.synchronize()
    FC.assert_toed_close(out, ref)


def test_gn_kernel_matches_twin_bit_for_bit(dev, frame):
    left, right, disp = frame
    lf = torch.from_numpy(left.astype(np.float32))
    rf = torch.from_numpy(right.astype(np.float32))
    gx, gy = IMG.sobel_gradients(rf)
    e = T.detect_edges(lf, max_edges=1024)
    n = int(e.count)
    rng = np.random.default_rng(3)
    sel = torch.from_numpy(rng.choice(n, 300, replace=False))
    lx, ly, lt = e.x[sel], e.y[sel], e.theta[sel]
    d = torch.from_numpy(disp)[ly.round().long(), lx.round().long()]
    rx = lx - d + torch.from_numpy(rng.uniform(-1.5, 1.5, 300).astype(np.float32))
    epi = torch.tensor([[1.0, 0.0]]).repeat(300, 1)
    act = torch.from_numpy(rng.random(300) > 0.05)
    args = [a.to(dev).contiguous() for a in (lf, rf, gx, gy, lx, ly, lt, rx,
                                             ly.clone(), epi)]
    act = act.to(dev)
    alpha0 = torch.from_numpy(rng.uniform(-0.5, 0.5, 300).astype(np.float32)).to(dev)
    for tile in (32, 48):
        for it0, it_stop in ((0, 2), (2, 20), (0, 20)):
            k = GN.refine_along_epipolar_cuda(*args, alpha0, act, it0, it_stop,
                                              tile=tile)
            p = GN.refine_along_epipolar_plain(*args, alpha0, act, it0,
                                               it_stop, tile=tile)
            for a, b in zip((*k[0], k[1]), (*p[0], p[1])):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(1, 13, 70), (2, 45, 131), (1, 9, 65),
                                   (1, 8, 62)])
def test_toed_kernel_ragged_shapes(dev, shape):
    """Heights and widths that are not multiples of the 8 x 64 tile or of
    the 4 columns a thread owns."""
    img = (np.random.default_rng(1).random(shape) * 255).astype(np.float32)
    x = torch.from_numpy(img).to(dev)
    out = T.toed_gradient_field_cuda(x)
    ref = T.toed_gradient_field_plain(x)
    torch.cuda.synchronize()
    FC.assert_toed_close(out, ref)


def test_toed_kernel_taps_follow_sigma(dev, frame):
    """One sigma, then another, then the first again: each launch matches
    its own twin (the launch taps are cached per sigma)."""
    x = torch.from_numpy(np.stack(frame[:2]).astype(np.float32)).to(dev)
    for sigma in (2.0, 1.5, 2.0):
        out = T.toed_gradient_field_cuda(x, 17, sigma)
        ref = T.toed_gradient_field_plain(x, 17, sigma)
        torch.cuda.synchronize()
        for a, b in zip(out[:3], ref[:3]):
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-3)


# ---- TOED's NMS, subpixel fit and compaction (csrc/toed_nms_compact.cu)
@pytest.fixture(scope="module")
def bench_frames():
    """Three frames of each benchmark cell's scene (KITTI's street,
    EuRoC's room, as the cameras give them), host uint8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vo_bench.harness import spec as SPEC
    from vo_bench.scene import render as RS
    out = {}
    for name in ("kitti.every_frame", "euroc.every_frame"):
        cell = SPEC.load_cell(name)
        rig = RS.Rig.from_config(cell.config["rig"])
        sc = RS.make_scene(rig, cell.scene, torch.device("cuda", 0), 3)
        out[name] = [(sc.left[k], sc.right[k]) for k in range(3)]
    return out


@functools.lru_cache(maxsize=None)
def _synthetic_pair(h, w):
    f = S.make_sequence(1, h, w).frames[0]
    return np.stack([_u8(f.left), _u8(f.right)]).astype(np.float32)


def _both(pair, dev):
    return torch.stack([torch.as_tensor(a) for a in pair]).to(
        dev, torch.float32)


@pytest.mark.parametrize("max_edges", [32768, 1024])
@pytest.mark.parametrize("cell", ["kitti.every_frame", "euroc.every_frame"])
def test_toed_nms_kernel_matches_twin_on_bench_frames(dev, bench_frames,
                                                      cell, max_edges):
    """Both images in one call, at VOConfig()'s capacity (no overflow)
    and at 1,024 (overflow): the kernel's EdgeLists are the twin's, run on
    the same card, bit for bit."""
    cfg = VOConfig()
    both = _both(bench_frames[cell][0], dev)
    H, W = both.shape[-2:]
    fields = T.toed_gradient_field_cuda(both)
    kw = dict(grad_mag_min=cfg.toed_grad_mag_min, border=cfg.toed_border)
    got = T.nms_compact_cuda(*fields, H, W, max_edges, **kw)
    ref = T.nms_compact_plain(*fields, H, W, max_edges, **kw)
    full = T.nms_compact_plain(*fields, H, W, 1 << 20, **kw)
    for b in range(2):
        FC.edges_bit_equal(got[b], ref[b], f"{cell} image {b}")
        assert 1024 < int(full[b].count) < 32768


@pytest.mark.parametrize("border,grad_mag_min,max_edges", [
    (10, 2.0, 4096), (0, 2.0, 4096), (3, 0.5, 4096), (10, 2.0, 50),
    (10, 2.0, 0)])
@pytest.mark.parametrize("shape", [(1, 45, 67), (2, 65, 91), (2, 121, 163),
                                   (1, 377, 1243)])
def test_toed_nms_kernel_odd_sizes(dev, shape, border, grad_mag_min,
                                   max_edges):
    """Odd heights and widths (fields not a multiple of the 512-column
    chunk), the border at 0 (zero padding at the field's edge), another
    threshold, overflow and no capacity at all."""
    B, h, w = shape
    both = torch.from_numpy(_synthetic_pair(h, w)[:B]).to(dev)
    fields = T.toed_gradient_field_cuda(both)
    kw = dict(grad_mag_min=grad_mag_min, border=border)
    got = T.nms_compact_cuda(*fields, h, w, max_edges, **kw)
    ref = T.nms_compact_plain(*fields, h, w, max_edges, **kw)
    assert len(got) == B
    for b in range(B):
        FC.edges_bit_equal(got[b], ref[b], f"image {b}")


@pytest.mark.parametrize("name", sorted(NC.LIMIT_CASES))
def test_toed_nms_kernel_at_the_limits(dev, name):
    """The CPU contract's cases (`tests/toed_nms_cases.py`): pixels
    exactly at the border and `grad_mag_min` limits, and on the field's
    edge; the kernel keeps what the twin keeps, on the card and on the
    CPU."""
    fields, (H, W, border, gmin), kept = NC.limit_fields(name)
    cpu = [torch.from_numpy(f) for f in fields]
    on = [t.to(dev) for t in cpu]
    got = T.nms_compact_cuda(*on, H, W, 16, grad_mag_min=gmin, border=border)
    FC.edges_bit_equal(got[0], T.nms_compact_plain(
        *on, H, W, 16, grad_mag_min=gmin, border=border)[0])
    FC.edges_bit_equal([t.cpu() for t in got[0]], T.nms_compact_plain(
        *cpu, H, W, 16, grad_mag_min=gmin, border=border)[0])
    assert int(got[0].count) == len(kept)


def test_toed_nms_kernel_zero_and_nan_fields(dev):
    """Zero |grad| (the twin's normal is 0 / 0) and NaN fields keep
    nothing and write no NaN; a NaN orientation is read only at kept
    pixels."""
    z = torch.zeros((2, 40, 60), device=dev)
    nan = torch.full_like(z, float("nan"))
    for fields, gmin in (((z, z, z, nan), -1.0), ((nan, nan, nan, nan), 2.0),
                         ((nan, z, z, z), -1.0)):
        got = T.nms_compact_cuda(*fields, 20, 30, 128, grad_mag_min=gmin,
                                 border=0)
        ref = T.nms_compact_plain(*fields, 20, 30, 128, grad_mag_min=gmin,
                                  border=0)
        for a, b in zip(got, ref):
            FC.edges_bit_equal(a, b)
            assert int(a.count) == 0
            assert all(bool(torch.isfinite(t).all()) for t in a[:4])


def test_toed_nms_kernel_in_a_step_graph_equals_eager(dev, bench_frames):
    """detect_edges as the body of a step graph (`utils/graphs.StepGraph`):
    its warm-up, capture and replays give the eager EdgeLists bit for bit,
    and each replay counts the kernel's two launches."""
    from edge_based_visual_odometry_tpu_torch.utils import graphs as G

    def body(imgs, seed, generator):
        return tuple(T.detect_edges(torch.stack(imgs).to(torch.float32)))

    graph = G.StepGraph("stereo_step", body, dev)
    frames = bench_frames["kitti.every_frame"]
    CB.reset_launch_counts()
    for k in (0, 1, 2, 0, 1):
        imgs = tuple(torch.as_tensor(a).to(dev) for a in frames[k])
        got = graph((imgs,))
        eager = T.detect_edges(torch.stack(imgs).to(torch.float32))
        for b in range(2):
            FC.edges_bit_equal(got[b], eager[b], f"call {k} image {b}")
    assert CB.GRAPH_STEPS["stereo_step"] == dict(capture=1, replay=3,
                                                 eager=1)
    # 5 graph calls and 5 eager calls, two launches each
    assert CB.LAUNCHES["toed_nms_compact"] == 20
    assert CB.LAUNCHES["toed_gradient_field"] == 10


def test_toed_nms_dispatch_and_operands(dev, frame):
    """detect_edges on the card launches K1 once and the NMS kernel's two
    passes once, for both images; the wrapper refuses operands it does
    not take."""
    x = torch.from_numpy(np.stack(frame[:2]).astype(np.float32)).to(dev)
    before = dict(CB.LAUNCHES)
    got = T.detect_edges(x, max_edges=4096)
    assert CB.LAUNCHES["toed_gradient_field"] == before[
        "toed_gradient_field"] + 1
    assert CB.LAUNCHES["toed_nms_compact"] == before["toed_nms_compact"] + 2
    fields = T.toed_gradient_field_cuda(x)
    ref = T.nms_compact_plain(*fields, 120, 160, 4096)
    for a, b in zip(got, ref):
        FC.edges_bit_equal(a, b)
    one = T.detect_edges(x[0], max_edges=4096)
    FC.edges_bit_equal(one, ref[0])
    f = list(fields)
    with pytest.raises(ValueError):
        T.nms_compact_cuda(*f[:3], f[3].double(), 120, 160, 64)
    with pytest.raises(ValueError):
        T.nms_compact_cuda(f[0][:1], *f[1:], 120, 160, 64)
    with pytest.raises(ValueError):
        T.nms_compact_cuda(*f, 121, 160, 64)
    with pytest.raises(ValueError):
        T.nms_compact_cuda(f[0].transpose(1, 2).contiguous().transpose(1, 2),
                           *f[1:], 120, 160, 64)
    with pytest.raises(ValueError):
        T.nms_compact_cuda(*f, 120, 160, -1)


def _border_lanes(rng, B, H, W):
    """Candidates whose tiles clamp at each image border (origins at 0 and
    at the last atlas step, where the region runs past the image and the
    edge is replicated), corners, and the interior; random epipolar
    directions so the patch centre also travels vertically."""
    u = rng.uniform
    rx = np.concatenate([u(0, 4, B // 6), u(W - 5, W - 1, B // 6),
                         u(8, W - 8, B // 6), u(8, W - 8, B // 6),
                         u(0, 4, B // 12), u(W - 5, W - 1, B // 12)])
    ry = np.concatenate([u(8, H - 8, B // 6), u(8, H - 8, B // 6),
                         u(0, 4, B // 6), u(H - 5, H - 1, B // 6),
                         u(H - 5, H - 1, B // 12), u(0, 4, B // 12)])
    n = B - rx.shape[0]
    rx = np.concatenate([rx, u(0, W - 1, n)])
    ry = np.concatenate([ry, u(0, H - 1, n)])
    ang = np.where(rng.random(B) < 0.5, 0.0, u(-np.pi, np.pi, B))
    epi = np.stack([np.cos(ang), np.sin(ang)], -1)
    lx, ly = u(10, W - 10, B), u(10, H - 10, B)
    lt = u(-np.pi, np.pi, B)
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return [f32(a) for a in (lx, ly, lt, rx, ry, epi)]


@pytest.mark.parametrize("patch_size", [7, 5, 3, 9, 11])
@pytest.mark.parametrize("tile", [32, 48])
def test_gn_kernel_bit_for_bit_at_borders(dev, frame, tile, patch_size):
    """The kernel against the twin, bit for bit, at 301 lanes (not a
    multiple of the warps per block), on candidates clamped at every
    border; with the interleaved maps made by the launch and passed in;
    at every odd patch size up to 11 but 1 (6 and 8 samples a thread at
    P = 9 and 11)."""
    left, right, _ = frame
    lf = torch.from_numpy(left.astype(np.float32))
    rf = torch.from_numpy(right.astype(np.float32))
    gx, gy = IMG.sobel_gradients(rf)
    H, W = lf.shape
    rng = np.random.default_rng(tile + patch_size)
    B = 301
    lanes = _border_lanes(rng, B, H, W)
    args = [a.to(dev).contiguous() for a in (lf, rf, gx, gy, *lanes)]
    act = torch.from_numpy(rng.random(B) > 0.05).to(dev)
    alpha0 = torch.from_numpy(rng.uniform(-3, 3, B).astype(np.float32)).to(dev)
    maps4 = GN.interleave_maps(*args[1:4])
    for m4 in (None, maps4):
        for it0, it_stop in ((0, 2), (2, 20), (0, 20)):
            k = GN.refine_along_epipolar_cuda(
                *args, alpha0, act, it0, it_stop, patch_size=patch_size,
                tile=tile, maps4=m4)
            p = GN.refine_along_epipolar_plain(
                *args, alpha0, act, it0, it_stop, patch_size=patch_size,
                tile=tile)
            torch.cuda.synchronize()
            for a, b in zip((*k[0], k[1]), (*p[0], p[1])):
                torch.testing.assert_close(a[act], b[act], rtol=0, atol=0)


def k3_side(kf_img, cf_img, cf_gx, cf_gy, kx, ky, ktheta, cx, cy, ctheta,
            d0, active, it0, it_stop, patch_size=7, max_iter=20, tol=1e-3,
            huber_delta=3.0, tile=32, maps4=None):
    """`refine_2dof_plain`'s contract on K3: its sides entry over one
    side, from an explicit d0, iterations [it0, it_stop). `maps4`: the
    side's interleaved CF maps, made here if None."""
    if maps4 is None:
        maps4 = GN.interleave_maps(cf_img, cf_gx, cf_gy)
    out = GN.k3_outputs(1, kx.shape[0], kx.device)
    GN._k3_launch([kf_img], maps4[None], torch.stack([kx, ky, ktheta], -1),
                  torch.stack([cx, cy, ctheta], -1), active, out, it0,
                  it_stop, max_iter, patch_size, tol, huber_delta, tile,
                  d0=d0[None].contiguous())
    return GN.RefineResult(*(t[0] for t in out[:5])), out[5][0]


def _2dof_lanes(rng, B, H, W):
    """K3 lanes at every border (the candidates of `_border_lanes`), each
    KF edge within 3 px of its candidate, CF orientations at random, and
    the starting step kf - cf moved by up to 1 px."""
    u = rng.uniform
    _, _, kt, cx, cy, _ = (a.numpy() for a in _border_lanes(rng, B, H, W))
    kx = np.clip(cx + u(-3, 3, B), 0, W - 1)
    ky = np.clip(cy + u(-3, 3, B), 0, H - 1)
    ct = u(-np.pi, np.pi, B)
    d0 = np.stack([kx - cx, ky - cy], -1) + u(-1, 1, (B, 2))
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return [f32(a) for a in (kx, ky, kt, cx, cy, ct)], f32(d0)


def test_2dof_kernel_matches_twin_bit_for_bit(dev, frame):
    """K3 on KF = left, CF = right: TOED edges of the left image, their
    candidates at the GT disparity plus up to 1.5 px of noise, CF
    orientation the KF's plus up to 0.1 rad; iterations [0, 2), [2, 20)
    and [0, 20) from the same d0, and the two phases of
    `refine_2dof_batch` against `_two_phase` over the twin."""
    left, right, disp = frame
    lf = torch.from_numpy(left.astype(np.float32))
    rf = torch.from_numpy(right.astype(np.float32))
    gx, gy = IMG.sobel_gradients(rf)
    e = T.detect_edges(lf, max_edges=1024)
    rng = np.random.default_rng(5)
    B = 300
    sel = torch.from_numpy(rng.choice(int(e.count), B, replace=False))
    kx, ky, kt = e.x[sel], e.y[sel], e.theta[sel]
    d = torch.from_numpy(disp)[ky.round().long(), kx.round().long()]
    def noise(a):
        return torch.from_numpy(rng.uniform(-a, a, B).astype(np.float32))
    cx, cy, ct = kx - d + noise(1.5), ky + noise(1.5), kt + noise(0.1)
    imgs = [a.to(dev).contiguous() for a in (lf, rf, gx, gy)]
    lanes = [a.to(dev).contiguous() for a in (kx, ky, kt, cx, cy, ct)]
    act = torch.from_numpy(rng.random(B) > 0.05).to(dev)
    d0 = torch.stack([lanes[0] - lanes[3], lanes[1] - lanes[4]], -1)
    for tile in (32, 48):
        for it0, it_stop in ((0, 2), (2, 20), (0, 20)):
            k = k3_side(*imgs, *lanes, d0, act, it0, it_stop, tile=tile)
            p = GN.refine_2dof_plain(*imgs, *lanes, d0, act, it0, it_stop,
                                     tile=tile)
            FC.assert_same(k, p, act)
    kw = dict(patch_size=7, max_iter=20, tol=1e-3, huber_delta=3.0, tile=32)
    CB.reset_launch_counts()
    two = GN.refine_2dof_batch(*imgs, *lanes, active=act, chunk=8,
                               phase1_iters=2, phase2_budget=64, **kw)
    assert CB.LAUNCHES["refine_2dof"] == 2
    ref = GN._two_phase(
        lambda args, d0_, it0, it_stop, a: GN.refine_2dof_plain(
            *imgs, *args, d0_, a, it0, it_stop, **kw),
        B, tuple(lanes), act, d0, phase1_iters=2, phase2_budget=64,
        max_iter=20, chunk=8)
    for a, b in zip(two, ref):
        torch.testing.assert_close(a[act], b[act], rtol=0, atol=0,
                                   equal_nan=True)


@pytest.mark.parametrize("patch_size", [7, 5, 3, 9, 11])
@pytest.mark.parametrize("tile", [32, 48])
def test_2dof_kernel_bit_for_bit_at_borders(dev, frame, tile, patch_size):
    """K3 against its twin, bit for bit, at 301 lanes on candidates clamped
    at every border, from an explicit d0 over iterations [0, 2), [2, 20)
    and [0, 20); at every odd patch size up to 11 but 1."""
    left, right, _ = frame
    lf = torch.from_numpy(left.astype(np.float32))
    rf = torch.from_numpy(right.astype(np.float32))
    gx, gy = IMG.sobel_gradients(rf)
    H, W = lf.shape
    rng = np.random.default_rng(100 + tile + patch_size)
    B = 301
    lanes, d0 = _2dof_lanes(rng, B, H, W)
    imgs = [a.to(dev).contiguous() for a in (lf, rf, gx, gy)]
    lanes = [a.to(dev) for a in lanes]
    d0 = d0.to(dev)
    act = torch.from_numpy(rng.random(B) > 0.05).to(dev)
    maps4 = GN.interleave_maps(*imgs[1:])
    for it0, it_stop in ((0, 2), (2, 20), (0, 20)):
        k = k3_side(*imgs, *lanes, d0, act, it0, it_stop,
                    patch_size=patch_size, tile=tile, maps4=maps4)
        p = GN.refine_2dof_plain(*imgs, *lanes, d0, act, it0, it_stop,
                                 patch_size=patch_size, tile=tile)
        torch.cuda.synchronize()
        FC.assert_same(k, p, act)


def test_2dof_kernel_keeps_nan_steps_as_the_twin(dev, frame):
    """Flat CF maps with equal large gradients make every lane's 2x2
    system singular and its first step NaN: kernel and twin both take no
    such step and stop the lane there (done after one iteration, score
    1e6, valid=False, d = d0), bit for bit; one side from d0, and both
    sides through the sides entry's two phases."""
    kf = torch.from_numpy(frame[0].astype(np.float32))
    H, W = kf.shape
    rng = np.random.default_rng(9)
    lanes, d0 = _2dof_lanes(rng, 64, H, W)
    imgs = [a.to(dev).contiguous() for a in (
        kf, torch.full_like(kf, 100.0), torch.full_like(kf, 1000.0),
        torch.full_like(kf, 1000.0))]
    lanes, d0 = [a.to(dev) for a in lanes], d0.to(dev)
    act = torch.ones(64, dtype=torch.bool, device=dev)
    k = k3_side(*imgs, *lanes, d0, act, 0, 20)
    p = GN.refine_2dof_plain(*imgs, *lanes, d0, act, 0, 20)
    assert bool(torch.isfinite(k[0].delta).all())
    assert bool((k[0].iters == 1).all()) and bool(k[1].all())
    assert not bool(k[0].valid.any()) and bool((k[0].score == 1e6).all())
    torch.testing.assert_close(k[0].delta, d0, rtol=0, atol=0)
    FC.assert_same(k, p, act)
    maps4 = GN.interleave_maps(*imgs[1:])[None].repeat(2, 1, 1, 1)
    pack = lambda a: torch.stack(a * 2, -1).contiguous()     # noqa: E731
    res, done = GN.refine_2dof_sides_cuda(
        [imgs[0], imgs[0]], maps4, pack(lanes[:3]), pack(lanes[3:]), act,
        tile=32, chunk=8, phase1_iters=2, phase2_budget=16)
    ref = GN.refine_2dof_plain(*imgs, *lanes, torch.stack(
        [lanes[0] - lanes[3], lanes[1] - lanes[4]], -1), act, 0, 20, tile=32)
    for r, dn in zip(res, done):
        FC.assert_same((r, dn), ref, act)


def _pair_lanes(frame, dev, seed, B):
    """Both sides of a temporal step on the 120x160 frame: side 0 KF =
    left, CF = right; side 1 KF = right, CF = left; each with the border
    lanes of `_2dof_lanes` and about 5% inactive lanes (shared by the
    sides, as the temporal matcher's mask is). Returns the per-side plain
    args, the sides entry's args and `active`."""
    left, right, _ = frame
    lf = torch.from_numpy(left.astype(np.float32))
    rf = torch.from_numpy(right.astype(np.float32))
    H, W = lf.shape
    rng = np.random.default_rng(seed)
    sides = []
    for kf, cf in ((lf, rf), (rf, lf)):
        gx, gy = IMG.sobel_gradients(cf)
        lanes, _ = _2dof_lanes(rng, B, H, W)
        sides.append([a.to(dev).contiguous() for a in (kf, cf, gx, gy,
                                                       *lanes)])
    act = torch.from_numpy(rng.random(B) > 0.05).to(dev)
    maps4 = GN.interleave_pair_maps(*(tuple(sd[1:4]) for sd in sides))
    kpack = torch.stack([sd[k] for sd in sides for k in (4, 5, 6)], -1)
    cpack = torch.stack([sd[k] for sd in sides for k in (7, 8, 9)], -1)
    return sides, ([sides[0][0], sides[1][0]], maps4, kpack, cpack), act


@pytest.mark.parametrize("tile,patch_size", [(32, 7), (48, 5)])
def test_2dof_sides_launch_matches_twin_bit_for_bit(dev, frame, tile,
                                                    patch_size):
    """K3's both-sides launch against its twin, bit for bit, at 301 lanes
    a side mixing border, interior and inactive lanes: as one
    20-iteration launch (against the twin from kf - cf), and as two
    launches with phase 2's lanes picked on the device, at budgets below
    and above the lanes phase 1 leaves undone (against the plain
    in-place form and against `_two_phase` over one-side launches)."""
    sides, sargs, act = _pair_lanes(frame, dev, 200 + tile, 301)
    B = act.shape[0]
    kw = dict(patch_size=patch_size, max_iter=20, tol=1e-3, huber_delta=3.0,
              tile=tile)
    CB.reset_launch_counts()
    one, done = GN.refine_2dof_sides_cuda(*sargs, act, **kw)
    assert CB.LAUNCHES["refine_2dof"] == 1
    for sd, r, dn in zip(sides, one, done):
        d0 = torch.stack([sd[4] - sd[7], sd[5] - sd[8]], -1)
        p = GN.refine_2dof_plain(*sd, d0, act, 0, 20, **kw)
        FC.assert_same((r, dn), p, act)
    for budget in (16, 4096):
        ph = dict(chunk=8, phase1_iters=2, phase2_budget=budget)
        CB.reset_launch_counts()
        two, done = GN.refine_2dof_sides_cuda(*sargs, act, **kw, **ph)
        assert CB.LAUNCHES["refine_2dof"] == 2
        for sd, r, dn in zip(sides, two, done):
            d0 = torch.stack([sd[4] - sd[7], sd[5] - sd[8]], -1)

            def run(fn):
                return lambda a, d, it0, it_stop, ac: fn(
                    *sd[:4], *a, d, ac, it0, it_stop, **kw)
            lanes = tuple(sd[4:])
            ph2 = dict(phase1_iters=2, phase2_budget=budget, max_iter=20,
                       chunk=8)
            plain, pdone = GN._two_phase_in_place(
                run(GN.refine_2dof_plain), B, lanes, act, d0, **ph2)
            FC.assert_same((r, dn), (plain, pdone), act)
            old = GN._two_phase(run(k3_side), B, lanes, act, d0, **ph2)
            FC.assert_same((r, dn), (old, dn), act)


def test_wrappers_validate_operands(dev):
    x = torch.zeros(2, 40, 50, device=dev)
    with pytest.raises(ValueError):
        T.toed_gradient_field_cuda(x.double())
    with pytest.raises(ValueError):
        T.toed_gradient_field_cuda(x.transpose(1, 2))
    imgs = [torch.zeros(40, 50, device=dev) for _ in range(4)]
    lanes = [torch.zeros(8, device=dev) for _ in range(5)]
    epi = torch.zeros(8, 2, device=dev)
    act = torch.ones(8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        GN.refine_along_epipolar_cuda(*imgs, *lanes, epi, lanes[0],
                                      act.float(), 0, 20)
    with pytest.raises(ValueError):
        GN.refine_along_epipolar_cuda(*imgs, *lanes, epi[:4], lanes[0], act,
                                      0, 20)
    with pytest.raises(ValueError):
        GN.refine_along_epipolar_cuda(*imgs, *lanes, epi, lanes[0], act, 0,
                                      20, maps4=torch.zeros(40, 50, 3,
                                                            device=dev))
    # K3's sides entry: (B, 3 S) packs, (S, H, W, 4) maps, 1 or 2 sides
    kfs, m4 = imgs[:2], torch.zeros(2, 40, 50, 4, device=dev)
    pack = torch.zeros(8, 6, device=dev)
    with pytest.raises(ValueError):
        GN.refine_2dof_sides_cuda(kfs, m4, pack[:, :3], pack, act)
    with pytest.raises(ValueError):
        GN.refine_2dof_sides_cuda(kfs, m4, pack, pack, act.float())
    with pytest.raises(ValueError):
        GN.refine_2dof_sides_cuda([kfs[0], kfs[1][:, :40]], m4, pack, pack,
                                  act)
    with pytest.raises(ValueError):
        GN.refine_2dof_sides_cuda(kfs, m4, pack, pack, act, patch_size=8)
    with pytest.raises(ValueError):
        GN.refine_2dof_sides_cuda(kfs, m4[..., :3], pack, pack, act)
    with pytest.raises(ValueError):
        GN.refine_2dof_sides_cuda(kfs * 2, m4, pack, pack, act)
    # K4: float32 (N, C <= 64) contiguous coordinates, a bool mask
    xy = torch.zeros(8, 32, device=dev)
    m = torch.ones(8, 32, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        CL.cluster_edges_cuda(xy, xy, xy.double(), m)
    with pytest.raises(ValueError):
        CL.cluster_edges_cuda(xy, xy, xy, m.float())
    with pytest.raises(ValueError):
        CL.cluster_edges_cuda(xy, xy.t().contiguous().t(), xy, m)
    with pytest.raises(ValueError):
        CL.cluster_edges_cuda(xy, xy, xy, m[:4])
    big = torch.zeros(8, 65, device=dev)
    with pytest.raises(ValueError):
        CL.cluster_edges_cuda(big, big, big, torch.ones_like(big).bool())
    # K5: float32 contiguous (H, W) maps and (N,) edges, 4 x 4 x 8 bins,
    # at most 16 x 16 samples, an atlas stride that is a power of two
    g = torch.zeros(40, 50, device=dev)
    e = torch.zeros(8, device=dev)
    with pytest.raises(ValueError):
        DESC.edge_descriptors_cuda(g.double(), g, e, e, e)
    with pytest.raises(ValueError):
        DESC.edge_descriptors_cuda(g, torch.zeros(50, 40, device=dev).t(), e,
                                   e, e)
    with pytest.raises(ValueError):
        DESC.edge_descriptors_cuda(g, g, e, e[:4], e)
    with pytest.raises(ValueError):
        DESC.edge_descriptors_cuda(g, g, e, e, e.double())
    with pytest.raises(ValueError):
        DESC.edge_descriptors_cuda(g, g, e, e, e, n_orient=16)
    with pytest.raises(ValueError):
        DESC.edge_descriptors_cuda(g, g, e, e, e, n_samples=17)
    with pytest.raises(ValueError):
        DESC.edge_descriptors_cuda(g, g, e, e, e, stride=6)


def _cluster_args(name, N, C, dev, seed=0, **over):
    x, y, th, mask, kw = CC.case(name, N, C, seed)
    kw.update(over)
    return [torch.from_numpy(a).to(dev) for a in (x, y, th, mask)], kw


@pytest.mark.parametrize("name", CC.CASES)
def test_cluster_kernel_matches_twin_bit_for_bit(dev, name):
    """K4 against the twin run on the card, 4,096 rows of 32 slots, cap 10
    (`tests/cluster_cases.py`)."""
    args, kw = _cluster_args(name, 4096, 32, dev, seed=1)
    k = CL.cluster_edges_cuda(*args, **kw)
    p = CL.cluster_edges_plain(*args, **kw)
    torch.cuda.synchronize()
    FC.assert_cluster_same(k, p)
    assert int(k.mask.sum()) > 0 or name == "all_masked_rows"


@pytest.mark.parametrize("N,C,cap", [(4096, 16, 10), (1, 32, 10), (0, 32, 10),
                                     (1, 16, 4), (0, 16, 4), (300, 8, 3),
                                     (500, 32, 0), (500, 25, 10),
                                     (1, 64, 10), (0, 64, 10), (300, 40, 3),
                                     (500, 33, 0)])
def test_cluster_kernel_small_shapes(dev, N, C, cap):
    """C < 32 (lanes past C hold no slot), two slots a lane (C > 32), one
    row, no row, no cap."""
    args, kw = _cluster_args("clumps_oriented", N, C, dev, seed=N + C,
                             max_cluster_size=cap)
    k = CL.cluster_edges_cuda(*args, **kw)
    p = CL.cluster_edges_plain(*args, **kw)
    torch.cuda.synchronize()
    FC.assert_cluster_same(k, p)


def test_cluster_kernel_relabels_groups_that_fit_the_cap(dev):
    """`long_chains` with a cap of 24 that every chain fits: no rank is
    formed, yet where the label rounds stopped short the relabel to a
    group's least index moves labels (tests/test_torch_clustering.py)."""
    args, kw = _cluster_args("long_chains", 4096, 32, dev, seed=1,
                             max_cluster_size=24)
    k = CL.cluster_edges_cuda(*args, **kw)
    p = CL.cluster_edges_plain(*args, **kw)
    torch.cuda.synchronize()
    FC.assert_cluster_same(k, p)


@pytest.mark.parametrize("name", CC.CASES)
@pytest.mark.parametrize("slots", [48, 64])
def test_cluster_kernel_wide_rows(dev, slots, name):
    """Two slots a lane: K4 against the twin on the card at 1,024 rows of
    48 and 64 slots (8 label rounds at 64), cap 10."""
    args, kw = _cluster_args(name, 1024, slots, dev, seed=slots)
    k = CL.cluster_edges_cuda(*args, **kw)
    p = CL.cluster_edges_plain(*args, **kw, chunk=256)
    torch.cuda.synchronize()
    FC.assert_cluster_same(k, p)


@pytest.mark.parametrize("name", CC.CASES)
def test_cluster_kernel_matches_jax_reference(dev, name):
    """K4 on the card against the JAX package's `cluster_edges` on the case
    at 64 rows of 32 slots (`tests/data/k4_jax_reference.npz`, held
    current by a CPU test): label, mask and members equal, x / y / theta
    within `cluster_cases.K4_JAX_ULPS` ulps of max(|a|, |b|, 1) (the sums'
    order and exp's last bit), NaN where JAX has NaN."""
    x, y, th, mask, kw = K4J.inputs(name)
    k = CL.cluster_edges_cuda(
        *(torch.from_numpy(a).to(dev) for a in (x, y, th, mask)), **kw)
    with np.load(K4J.PATH) as refs:
        ref = {f: refs[K4J.key(name, f)] for f in K4J.FIELDS}
    for f in ("label", "mask", "members"):
        np.testing.assert_array_equal(getattr(k, f).cpu().numpy(), ref[f])
    for f in ("x", "y", "theta"):
        ulps, n_nan = CC.f32_ulps(getattr(k, f).cpu().numpy(), ref[f])
        assert n_nan == 0 and ulps <= CC.K4_JAX_ULPS, (f, ulps, n_nan)


def test_cluster_edges_dispatch_counts_one_launch(dev, monkeypatch):
    args, kw = _cluster_args("clumps", 64, 32, dev)
    before = CB.LAUNCHES["cluster_edges"]
    k = CL.cluster_edges(*args, **kw)
    torch.cuda.synchronize()
    assert CB.LAUNCHES["cluster_edges"] == before + 1
    FC.assert_cluster_same(k, CL.cluster_edges_plain(*args, **kw))

    def no_build():
        raise AssertionError("CPU tensors must not build or launch a kernel")

    monkeypatch.setattr(CB, "lib", no_build)
    CL.cluster_edges(*(a.cpu() for a in args), **kw)
    assert CB.LAUNCHES["cluster_edges"] == before + 1


def _desc_args(name, N, dev, seed=0):
    maps, edges, kw = DC.case(name, N, seed)
    return [torch.from_numpy(a).to(dev) for a in maps + edges], kw


@pytest.mark.parametrize("name", DC.CASES)
def test_descriptor_kernel_matches_twin_bit_for_bit(dev, name):
    """K5 against the twin run on the card, 2,048 edges (4,096 keypoints)
    of each case of `tests/descriptor_cases.py`."""
    args, kw = _desc_args(name, 2048, dev, seed=1)
    k = DESC.edge_descriptors_cuda(*args, **kw)
    p = DESC.edge_descriptors_plain(*args, **kw)
    torch.cuda.synchronize()
    FC.assert_bf16_same(k, p)
    assert k.shape == (2048, 256)


@pytest.mark.parametrize("name", DC.CASES)
@pytest.mark.parametrize("N", [0, 1, 3, 4097])
def test_descriptor_kernel_small_shapes(dev, N, name):
    """No edge, one edge, and counts whose edges end inside a block, on
    each case."""
    args, kw = _desc_args(name, N, dev, seed=N)
    k = DESC.edge_descriptors_cuda(*args, **kw)
    p = DESC.edge_descriptors_plain(*args, **kw)
    torch.cuda.synchronize()
    FC.assert_bf16_same(k, p)
    assert k.shape == (N, 256)


@pytest.mark.parametrize("name", DC.CASES)
@pytest.mark.parametrize("n_samples,spacing", [(12, 1.0), (16, 1.0),
                                               (9, 0.66)])
def test_descriptor_kernel_other_grids(dev, n_samples, spacing, name):
    """Grids of 144 and 81 samples (lanes past the sample count hold
    none) and another spacing (other cell lists), on each case."""
    args, kw = _desc_args(name, 1000, dev, seed=2)
    kw.update(n_samples=n_samples, spacing=spacing)
    k = DESC.edge_descriptors_cuda(*args, **kw)
    p = DESC.edge_descriptors_plain(*args, **kw)
    torch.cuda.synchronize()
    FC.assert_bf16_same(k, p)


@pytest.mark.parametrize("name", DC.CASES)
def test_descriptor_kernel_matches_jax_reference(dev, name):
    """K5 on the card against the JAX package's `edge_descriptors_tiled`
    on the case at 64 edges (`tests/data/k5_jax_reference.npz`, held
    current by a CPU test), within the CPU test's 1 bf16 ulp of
    max(|a|, |b|, 1), NaN where JAX has NaN. The card's spatial table
    (729 nonzero weights) is not the CPU's (784)."""
    args, kw = _desc_args(name, KJ.N_EDGES, dev)
    k = DESC.edge_descriptors_cuda(*args, **kw).cpu()
    with np.load(KJ.PATH) as refs:
        ref = torch.from_numpy(refs[name].astype(np.int16)).view(
            torch.bfloat16)
    n_bad, ulps = DC.bf16_ulps(k, ref)
    assert n_bad == 0, f"{n_bad} entries past 1 bf16 ulp (at most {ulps})"


def test_builders_refuse_out_of_range_settings(dev):
    rig = S.make_sequence(1, 40, 60).rig
    with pytest.raises(ValueError, match="VOConfig.max_candidates"):
        PL.VOPipeline(rig, VOConfig(max_candidates=65), device=dev)
    with pytest.raises(ValueError, match="VOConfig.desc_orient_bins"):
        PL.build_stereo_step(rig, VOConfig(desc_orient_bins=4), dev)
    with pytest.raises(ValueError, match="VOConfig.patch_size"):
        PL.build_temporal_step(rig, VOConfig(patch_size=6), dev)


def test_edge_descriptors_dispatch_counts_one_launch(dev, monkeypatch):
    args, kw = _desc_args("interior", 64, dev)
    before = CB.LAUNCHES["edge_descriptors"]
    k = DESC.edge_descriptors(*args, **kw)
    torch.cuda.synchronize()
    assert CB.LAUNCHES["edge_descriptors"] == before + 1
    FC.assert_bf16_same(k, DESC.edge_descriptors_plain(*args, **kw))

    def no_build():
        raise AssertionError("CPU tensors must not build or launch a kernel")

    monkeypatch.setattr(CB, "lib", no_build)
    DESC.edge_descriptors(*(a.cpu() for a in args), **kw)
    assert CB.LAUNCHES["edge_descriptors"] == before + 1


def _rows(case, n, seed, keys):
    """The case's arrays of `keys` (one a row) at n rows, drawn from its
    rows in a seeded order; the other arrays (the right tables) as they
    are."""
    pick = np.random.default_rng(seed).integers(0, GC.N_ROWS, n)
    return {k: (v[pick] if k in keys else v) for k, v in case.items()}


STEREO_ROWS = ("l_desc", "cand", "cmask", "l_pat", "l_ok")
TEMPORAL_ROWS = ("kf_pat_l", "kf_ok_l", "kf_pat_r", "kf_ok_r", "kf_desc_l",
                 "kf_desc_r", "cf_idx", "cmask")


def _gates_same(dev, name, n, seed, patch_size=GC.P):
    """K6's three entries against their twins run on the card at n rows
    (n C flat pairs) of the case made at `patch_size`."""
    s = GC.gate_tensors(_rows(GC.stereo_case(name, patch_size=patch_size),
                              n, seed, STEREO_ROWS), dev)
    a, kw = GC.k6_args("stereo", s, patch_size)
    k, p = (PAT.dense_gates_stereo_cuda(*a, **kw),
            PAT.dense_gates_stereo_plain(*a, **kw))
    t = GC.gate_tensors(_rows(GC.temporal_case(name, patch_size=patch_size),
                              n, seed, TEMPORAL_ROWS), dev)
    a, kw = GC.k6_args("temporal", t, patch_size)
    kt, pt = (PAT.dense_gates_temporal_cuda(*a, **kw),
              PAT.dense_gates_temporal_plain(*a, **kw))
    slots = s["cmask"].shape[1]
    j = s["cand"].reshape(-1)
    f = dict(l_pat=s["l_pat"], l_ok=s["l_ok"],
             rows=torch.arange(n, device=dev).repeat_interleave(slots),
             r_pat=s["r_pat"][j], r_ok=s["r_ok"][j],
             live=s["cmask"].reshape(-1))
    a, kw = GC.k6_args("flat", f, patch_size)
    kf, pf = (PAT.dense_gates_flat_cuda(*a, **kw),
              PAT.dense_gates_flat_plain(*a, **kw))
    torch.cuda.synchronize()
    for x, y in ((k[0], p[0]), (k[1], p[1]), (kt, pt), (kf, pf)):
        FC.same_f32(x, y)
    return k, kt, kf


@pytest.mark.parametrize("name", GC.GATE_CASES)
def test_dense_gates_kernel_matches_twin_bit_for_bit(dev, name):
    """K6's stereo, temporal and flat entries against the twins run on the
    card at 4,096 rows of each case of `tests/gate_cases.py`: every slot
    bit-equal, the slots not computed holding the fill."""
    k, kt, kf = _gates_same(dev, name, 4096, seed=1)
    assert k[0].shape == (4096, GC._slots(name))
    assert kt.shape == (4, 4096, GC._slots(name))


@pytest.mark.parametrize("name", GC.GATE_CASES)
@pytest.mark.parametrize("N", [0, 1, 4096])
def test_dense_gates_kernel_small_shapes(dev, N, name):
    _gates_same(dev, name, N, seed=N)


@pytest.mark.parametrize("name", GC.GATE_CASES)
@pytest.mark.parametrize("patch_size", [3, 5, 9, 11])
def test_dense_gates_kernel_other_patch_sizes(dev, patch_size, name):
    """K6's three entries against their twins at P = 3, 5 (2 samples a
    lane of a side) and 9, 11 (4 a lane), at 2,048 rows of each case made
    at that P: every slot bit-equal, the fills kept."""
    k, kt, kf = _gates_same(dev, name, 2048, seed=patch_size,
                            patch_size=patch_size)
    assert k[0].shape == (2048, GC._slots(name))


def test_dense_gates_empty_tables_and_rows(dev):
    """K6 where a row has live slots nowhere (every mask False) over an
    empty candidate table: the fills everywhere, and only the gates
    launched (no prep pass over no row)."""
    s = GC.gate_tensors(GC.stereo_case("interior"), dev)
    s["cmask"] = torch.zeros_like(s["cmask"])
    for k in ("r_desc", "r_pat", "r_ok"):
        s[k] = s[k][:0]
    a, kw = GC.k6_args("stereo", s)
    before = CB.LAUNCHES["dense_gates"]
    d, n = PAT.dense_gates_stereo_cuda(*a, **kw)
    torch.cuda.synchronize()
    assert CB.LAUNCHES["dense_gates"] == before + 1
    assert bool((d == kw["fill_dist"]).all() and (n == kw["fill_ncc"]).all())


def test_dense_gates_and_patches_kernels_do_not_spill(dev):
    """The built K6 kernels, at 2 and at 4 samples a lane of a side: no
    local (spill) memory; K6 and K7 at least 16 warps an SM. (K7's 32 local bytes are sinf's and cosf's argument
    reduction, as in K2, K3 and K5.)"""
    info = PAT.k6_info()
    for name in PAT.K6_KERNELS:
        for i in (info[name], info["wide"][name]):   # P <= 7; P = 9, 11
            assert i["local_bytes"] == 0, (name, i)
            assert i["warps_per_sm"] >= 16, (name, i)
    assert PAT.k7_info()["warps_per_sm"] >= 16


def test_dense_gates_kernel_gives_exact_copies_distance_zero(dev):
    """A candidate equal to the row, or with its halves swapped: kernel
    and twin both give a distance of exactly 0 (the same lane order on
    both sides of |a|^2 + |b|^2 - 2 a.b)."""
    s = GC.gate_tensors(GC.copies(), dev)
    a, kw = GC.k6_args("stereo", s)
    k = PAT.dense_gates_stereo_cuda(*a, **kw)
    p = PAT.dense_gates_stereo_plain(*a, **kw)
    torch.cuda.synchronize()
    FC.same_f32(k[0], p[0])
    FC.same_f32(k[1], p[1])
    rows = torch.arange(GC.N_ROWS, device=dev)[:, None]
    exact = s["cmask"] & (s["cand"] == rows) & (rows % 3 < 2)
    assert bool(exact.any()) and bool((k[0][exact] == 0).all())


def test_dense_gates_kernel_matches_jax_reference(dev):
    """K6 on the card against the JAX package's `min_cross_distance_dot`
    and `ncc4` on every case of `tests/gate_cases.py`
    (`tests/data/k6_k7_jax_reference.npz`, held current by a CPU test):
    distances within the CPU tests' 0.05 on the live slots, NCC within
    1e-5 of max(1, |b|) on the pairs K6 computed, NaN where JAX has NaN
    (`gate_cases.k6_against_jax`)."""
    res = GC.k6_against_jax(dev)
    assert set(res) == set(GC.GATE_CASES)
    assert all(n_bad == 0 for n_bad, _, _ in res.values()), res


def _patch_args(name, B, dev, seed=0, patch_size=GC.P):
    img, edges = GC.patch_case(name, B, seed)
    return ((torch.from_numpy(img).to(dev),
             *(torch.from_numpy(e).to(dev) for e in edges), patch_size,
             GC.SHIFT), {})


@pytest.mark.parametrize("name", GC.PATCH_CASES)
@pytest.mark.parametrize("B,patch_size", [(4096, 7), (0, 7), (1, 7),
                                          (1000, 5), (777, 3), (1000, 9),
                                          (777, 11)])
def test_edge_patches_kernel_matches_twin_bit_for_bit(dev, name, B,
                                                      patch_size):
    """K7 against the twin run on the card on each case of
    `tests/gate_cases.py`: patches bit-equal (NaN equal to NaN), ok flags
    equal; also at no edge, one edge and P = 5, 3 (lanes past the
    samples) and 9, 11 (up to 242 samples an edge)."""
    a, kw = _patch_args(name, B, dev, seed=B, patch_size=patch_size)
    k = PAT.edge_patches_cuda(*a, **kw)
    p = PAT.edge_patches_plain(*a, **kw)
    torch.cuda.synchronize()
    FC.same_f32(k[0], p[0])
    assert k[1].dtype == torch.bool and bool((k[1] == p[1]).all())
    assert k[0].shape == (B, 2 * patch_size * patch_size)


def test_edge_patches_kernel_matches_jax_reference(dev):
    """K7 on the card against the JAX package's `edge_patches_tiled` on
    every patch case of `tests/gate_cases.py` (the same file): values
    within 1e-5 of max(1, |b|), NaN where JAX has NaN, ok flags equal
    (`gate_cases.k7_against_jax`)."""
    res = GC.k7_against_jax(dev)
    assert set(res) == set(GC.PATCH_CASES)
    assert all(n == 0 and n_ok == 0 for n, _, n_ok in res.values()), res


@pytest.mark.parametrize("name", GC.PATCH_CASES)
@pytest.mark.parametrize("B,live_kind", [(4096, "prefix"), (4096, "random"),
                                         (1000, "none"), (1, "prefix")])
def test_edge_patches_kernel_with_live_mask(dev, name, B, live_kind):
    """K7 given a `live` mask (stage 11's flat list: a prefix; also a
    random mask and none live) against the twin run on the card: the live
    rows' patches bit-equal and ok flags equal."""
    a, kw = _patch_args(name, B, dev, seed=B)
    g = np.random.default_rng(B)
    live = {"prefix": np.arange(B) < (B * 3) // 7 + 1,
            "random": g.random(B) < 0.3,
            "none": np.zeros(B, bool)}[live_kind]
    live = torch.from_numpy(live).to(dev)
    k = PAT.edge_patches_cuda(*a, **kw, live=live)
    p = PAT.edge_patches_plain(*a, **kw)
    torch.cuda.synchronize()
    FC.same_f32(k[0][live], p[0][live])
    assert bool((k[1][live] == p[1][live]).all())


def test_edge_patches_kernel_leaves_dead_rows_unwritten(dev, monkeypatch):
    """K7 writes neither the patch row nor the ok flags of a dead edge: the
    outputs, pre-filled with a NaN sentinel and True through the wrapper's
    allocation, keep them on every dead row, whole blocks of dead edges
    among them."""
    B = 3000
    a, kw = _patch_args("borders", B, dev, seed=5)
    sentinel = 0x7FC0DEAD

    def prefilled(n, patch_size, device):
        pat = torch.full((n, 2 * patch_size * patch_size), sentinel,
                         dtype=torch.int32, device=device).view(torch.float32)
        return pat, torch.ones((n, 2), dtype=torch.bool, device=device)

    monkeypatch.setattr(PAT, "_patch_outputs", prefilled)
    live = torch.from_numpy(np.random.default_rng(7).random(B) < 0.5)
    live[1000:2000] = False
    live = live.to(dev)
    k = PAT.edge_patches_cuda(*a, **kw, live=live)
    p = PAT.edge_patches_plain(*a, **kw)
    torch.cuda.synchronize()
    dead = ~live
    assert bool((k[0][dead].view(torch.int32) == sentinel).all())
    assert bool(k[1][dead].all())
    FC.same_f32(k[0][live], p[0][live])
    assert bool((k[1][live] == p[1][live]).all())
    assert bool((~p[1][live]).any())    # some live sides are not ok


def test_dense_gates_and_patches_dispatch_count_one_launch(dev, monkeypatch):
    s = GC.gate_tensors(GC.stereo_case("interior"), dev)
    a, kw = GC.k6_args("stereo", s)
    t = GC.gate_tensors(GC.temporal_case("interior"), dev)
    at, kwt = GC.k6_args("temporal", t)
    pa, pkw = _patch_args("interior", 64, dev)
    before = dict(CB.LAUNCHES)
    PAT.dense_gates_stereo(*a, **kw)
    PAT.dense_gates_temporal(*at, **kwt)
    PAT.edge_patches(*pa, **pkw)
    PAT.edge_patches_flat(*pa, **pkw)
    torch.cuda.synchronize()
    # the stereo and temporal entries: the prep pass, then the gates
    assert CB.LAUNCHES["dense_gates"] == before["dense_gates"] + 4
    assert CB.LAUNCHES["edge_patches"] == before["edge_patches"] + 2

    def no_build():
        raise AssertionError("CPU tensors must not build or launch a kernel")

    monkeypatch.setattr(CB, "lib", no_build)
    PAT.dense_gates_stereo(*(x.cpu() if torch.is_tensor(x) else x
                             for x in a), **kw)
    PAT.edge_patches_flat(*(x.cpu() if torch.is_tensor(x) else x
                            for x in pa), **pkw)
    assert CB.LAUNCHES["dense_gates"] == before["dense_gates"] + 4
    assert CB.LAUNCHES["edge_patches"] == before["edge_patches"] + 2


def test_pipeline_gpu_matches_cpu_and_launches_kernels(dev):
    seq = S.make_sequence(3, 120, 160)
    cfg = VOConfig(**SMALL)
    runs = {}
    for d in ("cpu", dev):
        CB.reset_launch_counts()
        pipe = PL.VOPipeline(seq.rig, cfg, device=d)
        runs[str(d)] = ([pipe.run_frame(_u8(f.left), _u8(f.right))
                         for f in seq.frames], dict(CB.LAUNCHES))
    (cpu, n_cpu), (gpu, n_gpu) = runs["cpu"], runs[str(dev)]
    assert all(v == 0 for v in n_cpu.values())
    assert n_gpu["toed_gradient_field"] == 3
    assert n_gpu["refine_along_epipolar"] >= 3
    # K3: two phases, each one launch for both sides, in each of the two
    # temporal steps
    assert n_gpu["refine_2dof"] == 4
    # K4: once in each of the 3 stereo and 2 temporal steps
    assert n_gpu["cluster_edges"] == 5
    # K5: left edges, right edges and mates in each of the 3 stereo steps
    assert n_gpu["edge_descriptors"] == 9
    # K6: stages 4-5 (the prep pass and the gates) and stage 11 of each
    # stereo step, the prep pass and the gates of each temporal step
    assert n_gpu["dense_gates"] == 3 * 3 + 2 * 2
    # K7: left edges, right edges, stage 11 and mates of each stereo step
    assert n_gpu["edge_patches"] == 3 * 4
    # K8: the full count of each temporal step (4,096 quads at this size:
    # no prescore); K9: its 4 refinement steps
    assert n_gpu["ransac_score"] == 2
    assert n_gpu["pose_gn"] == 2 * 4
    # the gather windows' compaction: once in each stereo and temporal step
    assert n_gpu["compact_candidates"] == 3 + 2
    for (fc, tc), (fg, tg) in zip(cpu, gpu):
        a = fc.stereo_metrics.numpy()
        b = fg.stereo_metrics.cpu().numpy()
        assert np.all(np.abs(a - b) <= 0.05 * np.maximum(a, b) + 5)
        mc, mg = int(fc.mates.count), int(fg.mates.count)
        assert min(mc, mg) >= 0.97 * max(mc, mg)
        if tc is not None:
            assert bool(tg.success)
            qc, qg = int(tc.n_quads), int(tg.n_quads)
            assert min(qc, qg) >= 0.97 * max(qc, qg)


# ---- the gather windows' compaction (csrc/compact_candidates.cu) ----
# the callers' (S, C, A): the dry run's gathers, the stereo and temporal
# calls of every frame, the evaluation path's temporal call
COMPACT_SHAPES = {"dry_run": (32, 8, 3), "stereo": (160, 32, 3),
                  "temporal": (195, 32, 6), "evaluation": (576, 32, 6)}


def _compact_case(dev, Q, S, A, seed, **kw):
    return [None if a is None else torch.from_numpy(a).to(dev)
            for a in CPC.make_case(Q, S, A, seed, **kw)]


def _compact_same(idx, attrs, mask, C, pri):
    got = GRID.compact_candidates_cuda(idx, attrs, mask, C, pri)
    ref = GRID.compact_candidates_plain(idx, attrs, mask, C, pri)
    torch.cuda.synchronize()
    FC.assert_compact_same(got, ref)
    return got


@pytest.mark.parametrize("priority", ["random", "ties", "special", "nans",
                                      None])
@pytest.mark.parametrize("shape", sorted(COMPACT_SHAPES))
def test_compact_kernel_matches_twin_bit_for_bit(dev, shape, priority):
    """4,096 rows, each with its own live share, at a caller's (S, C, A),
    against the twin on the card on every output slot, the masked tail
    included. `special` puts live keys of +inf, +NaN, -0.0, +0.0 and at
    or past 3.0e38 on a quarter of the slots, `nans` NaNs of both signs
    and other payloads too: the kernel orders them as torch.sort's radix
    sort does there (-0.0 as +0.0, NaNs by their bits)."""
    S, C, A = COMPACT_SHAPES[shape]
    idx, attrs, mask, pri = _compact_case(dev, 4096, S, A, S + C,
                                          priority=priority)
    _compact_same(idx, attrs, mask, C, pri)


@pytest.mark.parametrize("S,C", [(1, 1), (33, 32), (160, 1), (160, 160),
                                 (195, 400), (576, 576), (1024, 32),
                                 (GRID.MAX_SLOTS, 32)])
def test_compact_kernel_other_widths(dev, S, C):
    """Rows of 1 to `MAX_SLOTS` slots, capacities of 1 to past S (the
    width min(C, S)), live keys of every kind."""
    idx, attrs, mask, pri = _compact_case(dev, 256, S, 3, S, priority="nans")
    _compact_same(idx, attrs, mask, C, pri)


@pytest.mark.parametrize("live_p", [0.0, 1.0])
@pytest.mark.parametrize("priority", ["ties", None])
def test_compact_kernel_all_masked_and_all_live(dev, live_p, priority):
    idx, attrs, mask, pri = _compact_case(dev, 1024, 195, 6, 4,
                                          live_p=live_p, priority=priority)
    got = _compact_same(idx, attrs, mask, 32, pri)
    assert bool((got[2] == bool(live_p)).all())


def test_compact_wrapper_refuses_operands(dev):
    """Other dtypes, shapes or devices, non-contiguous operands, more
    than `MAX_SLOTS` slots and a negative capacity raise ValueError."""
    idx, attrs, mask, pri = _compact_case(dev, 64, 160, 3, 0)
    GRID.compact_candidates_cuda(idx, attrs, mask, 32, pri)
    bad = [(idx.int(), attrs, mask, 32, pri),
           (idx, attrs.double(), mask, 32, pri),
           (idx, attrs, mask.to(torch.uint8), 32, pri),
           (idx, attrs, mask, 32, pri.double()),
           (idx, attrs, mask, 32, pri.cpu()),
           (idx.cpu(), attrs, mask, 32, pri),
           (idx[:, :80], attrs, mask, 32, pri),
           (idx, attrs[:, :32], mask, 32, pri),
           (idx, attrs[0], mask, 32, pri),
           (idx.t().contiguous().t(), attrs, mask, 32, pri),
           (idx, attrs.transpose(1, 2).contiguous().transpose(1, 2), mask,
            32, pri),
           (idx, attrs, mask, 32, pri.t().contiguous().t()),
           (idx, attrs, mask, -1, pri),
           (idx.cpu(), attrs.cpu(), mask.cpu(), 32, pri.cpu())]
    for k, args in enumerate(bad):
        with pytest.raises(ValueError):
            GRID.compact_candidates_cuda(*args)
            pytest.fail(f"case {k} was taken")
    wide = _compact_case(dev, 4, GRID.MAX_SLOTS + 1, 3, 0)
    with pytest.raises(ValueError, match="slots a row"):
        GRID.compact_candidates_cuda(*wide[:3], 32, wide[3])


def test_compact_dispatch_counts_one_launch(dev):
    """`compact_candidates_attrs` on the card launches the kernel once a
    call, and not where the output is empty (no rows, capacity 0)."""
    idx, attrs, mask, pri = _compact_case(dev, 64, 195, 6, 1)
    before = CB.LAUNCHES["compact_candidates"]
    got = GRID.compact_candidates_attrs(idx, attrs, mask, 32, priority=pri)
    assert CB.LAUNCHES["compact_candidates"] == before + 1
    FC.assert_compact_same(got, GRID.compact_candidates_plain(
        idx, attrs, mask, 32, pri))
    for args, shape in (((idx[:0], attrs[:, :0], mask[:0], 32, pri[:0]),
                         (0, 32)),
                        ((idx, attrs, mask, 0, pri), (64, 0))):
        out = GRID.compact_candidates_attrs(*args)
        assert tuple(out[0].shape) == shape and out[1].shape[0] == 6
        FC.assert_compact_same(out, GRID.compact_candidates_plain(*args))
    assert CB.LAUNCHES["compact_candidates"] == before + 1


def test_frame_replay_launches_no_long_row_radix_sort(dev):
    """Frame 4 of `make_sequence(5, 376, 1241)` through VOPipeline(
    VOConfig(), every_frame), both steps replaying their graphs: its
    trace holds the compaction kernel twice (stereo, temporal), the
    streak filter's kernel 4 times (stereo stages 6 and 7, the temporal
    step's two), and no `radixSortKVInPlace` (a row sort of any length:
    `_bnb_keep`'s 32-slot rows were the last) and no int64 multiplying
    scan (`_bnb_keep`'s cumprod)."""
    from edge_based_visual_odometry_tpu_torch.utils import timing

    seq = S.make_sequence(5, 376, 1241)
    frames = [(_u8(f.left), _u8(f.right)) for f in seq.frames]
    pipe = PL.VOPipeline(seq.rig, VOConfig(), device="cuda",
                         keyframe_policy="every_frame")
    for left, right in frames[:4]:
        pipe.run_frame(left, right)
    torch.cuda.synchronize()
    CB.reset_launch_counts()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        pipe.run_frame(*frames[4])
        torch.cuda.synchronize()
    replay = dict(capture=0, replay=1, eager=0)
    assert CB.GRAPH_STEPS == {"stereo_step": replay, "temporal_step": replay}
    assert CB.LAUNCHES["compact_candidates"] == 2
    assert CB.LAUNCHES["bnb_keep"] == 4
    ops = {e.key: e.count for e in timing.device_ops(
        prof, torch.autograd.DeviceType.CUDA)}
    assert sum(n for k, n in ops.items()
               if "compact_candidates_kernel" in k) == 2, ops
    assert sum(n for k, n in ops.items() if "bnb_keep_kernel" in k) == 4, ops
    radix = {k: n for k, n in ops.items() if "radixSortKVInPlace" in k}
    assert not radix, radix
    scans = {k: n for k, n in ops.items()
             if "scan" in k and "multiplies" in k}
    assert not scans, scans


# ---- the best/nearly-best streak filter (csrc/bnb_keep.cu) ----
def _bnb_same(dev, s, m, thresh, hb):
    s, m = (torch.from_numpy(a).to(dev) for a in (s, m))
    got = SM.bnb_keep_cuda(s, m, thresh, hb)
    ref = SM._bnb_keep(s, m, thresh, hb)
    torch.cuda.synchronize()
    FC.assert_bnb_same(got, ref)
    return got


def _bnb_rows(C, thresh, hb, R=4096):
    s, m = BC.edge_rows(C, thresh, hb, seed=C)
    rs, rm = BC.random_rows(R, C, hb, seed=C + 1)
    return np.concatenate([s, rs]), np.concatenate([m, rm])


@pytest.mark.parametrize("C", [32, 64])
@pytest.mark.parametrize("caller", sorted(BC.THRESHOLDS))
def test_bnb_kernel_matches_twin_bit_for_bit(dev, caller, C):
    """The hand-made rows of `tests/bnb_cases.py` (a best tied, ties
    mid-streak, a best of 0, -0.0 against +0.0, negative scores, NaNs of
    both signs and other payloads, +-inf, live keys at the fill 3.4e38,
    ratios one float32 ulp either side of the threshold, 0, 1, 2 and
    every slot live) and 4,096 seeded rows, at a caller's threshold and
    direction, against the twin on the card on every slot: the kernel
    orders the keys as torch.sort's radix sort does there, divides and
    compares as PyTorch does."""
    thresh, hb = BC.THRESHOLDS[caller]
    _bnb_same(dev, *_bnb_rows(C, thresh, hb), thresh, hb)


@pytest.mark.parametrize("C", [1, 2, 8, 25, 31, 33, 40, 63])
def test_bnb_kernel_other_widths(dev, C):
    """Rows of 1 to 63 slots (one slot a lane, or two past 32), every
    caller's threshold."""
    for thresh, hb in BC.THRESHOLDS.values():
        _bnb_same(dev, *_bnb_rows(C, thresh, hb, R=1024), thresh, hb)


def test_bnb_kernel_at_the_callers_sizes(dev):
    """32,768 rows (the stereo calls) and 24,576 (the temporal calls) of
    32 slots, as the callers make them: the twin's output on every slot,
    and the streak cuts some rows."""
    for R, callers in ((32768, ("stereo_ncc", "stereo_sift")),
                       (24576, ("temporal_ncc", "temporal_sift"))):
        for caller in callers:
            thresh, hb = BC.THRESHOLDS[caller]
            s, m = BC.random_rows(R, 32, hb, seed=R)
            got = _bnb_same(dev, s, m, thresh, hb)
            cut = got.cpu().numpy() != m
            assert 0 < cut.any(1).sum() < R


def test_bnb_wrapper_refuses_operands(dev):
    """Other dtypes, shapes or devices, non-contiguous operands and more
    than `BNB_MAX_SLOTS` slots raise ValueError."""
    s, m = (torch.from_numpy(a).to(dev)
            for a in BC.random_rows(64, 32, True, 0))
    SM.bnb_keep_cuda(s, m, 0.9, True)
    bad = [(s.double(), m), (s, m.to(torch.uint8)), (s[:, :16], m),
           (s.cpu(), m), (s, m[0]), (s.t().contiguous().t(), m),
           (s, m.t().contiguous().t()), (s.cpu(), m.cpu())]
    for k, (a, b) in enumerate(bad):
        with pytest.raises(ValueError):
            SM.bnb_keep_cuda(a, b, 0.9, True)
            pytest.fail(f"case {k} was taken")
    wide = torch.zeros(4, SM.BNB_MAX_SLOTS + 1, device=dev)
    with pytest.raises(ValueError, match="slots a row"):
        SM.bnb_keep_cuda(wide, wide > 0, 0.9, True)


def test_bnb_dispatch_counts_one_launch(dev):
    """`bnb_keep` on the card launches the kernel once a call and adds 1
    to `LAUNCHES["bnb_keep"]`, and launches nothing for no rows."""
    s, m = (torch.from_numpy(a).to(dev)
            for a in BC.random_rows(64, 32, True, 1))
    before = CB.LAUNCHES["bnb_keep"]
    for k, (thresh, hb) in enumerate(BC.THRESHOLDS.values(), 1):
        got = SM.bnb_keep(s, m, thresh, hb)
        assert CB.LAUNCHES["bnb_keep"] == before + k
        FC.assert_bnb_same(got, SM._bnb_keep(s, m, thresh, hb))
    out = SM.bnb_keep(s[:0], m[:0], 0.9, True)
    assert tuple(out.shape) == (0, 32) and out.dtype == torch.bool
    assert CB.LAUNCHES["bnb_keep"] == before + len(BC.THRESHOLDS)


# ---- every hand-kernel call of a full-size frame against its twin ----
# the patch sizes past the default, each at the largest shift the
# reference's coverage guard admits there (`patches.check_coverage`)
WIDE = {9: 4.0, 11: 2.9}
FRAME_CASES = ([(cell, 7, k) for cell in ("kitti.every_frame",
                                          "euroc.every_frame")
                for k in FC.FRAME_CALLS]
               + [("kitti.every_frame", P, k) for P in WIDE
                  for k in ("K2", "K3", "K6", "K7")])


@pytest.fixture(scope="module")
def frame2_calls(bench_frames):
    """(cell, P) -> `FC.frame_calls` of VOPipeline(VOConfig(), every_frame)
    (at P = 9, 11 with the shift of `WIDE`) on the cell's rig and its
    three bench frames, made once a module."""
    from vo_bench.harness import spec as SPEC
    cache = {}

    def get(cell, P):
        if (cell, P) not in cache:
            cfg = (VOConfig() if P == 7 else
                   VOConfig(patch_size=P, orthogonal_shift_mag=WIDE[P]))
            rig = SPEC.stereo_rig(SPEC.load_cell(cell).config)
            pipe = PL.VOPipeline(rig, cfg, device="cuda",
                                 keyframe_policy="every_frame")
            cache[(cell, P)] = FC.frame_calls(pipe, bench_frames[cell])
        return cache[(cell, P)]
    return get


@pytest.mark.parametrize("cell,P,kernel", FRAME_CASES)
def test_frame_kernel_calls_match_twins(dev, frame2_calls, cell, P, kernel):
    """Each call of `kernel` in frame 2 of a benchmark cell's bench frames
    (the eager stereo step and the prediction-mode temporal step), made
    again and held against its plain twin run on the card on the same
    operands: K1 within rtol 2e-4 / atol 2e-3 and its orientation's 99.9%
    quantile under 1e-3 rad, K5 as bf16 bit patterns, the rest bit for
    bit (K2 and K3 on the active lanes, K7's stage-11 call on its live
    entries). The frame makes the calls `FC.FRAME_CALLS` names, at patch
    size P; frames 1-2 pass the production guards (a successful, finite
    pose on >= 500 quads)."""
    calls, results = frame2_calls(cell, P)
    for _, tr in results[1:]:
        assert bool(tr.success) and int(tr.n_quads) >= 500
        assert bool(torch.isfinite(tr.R).all() and torch.isfinite(tr.t).all())
    mine = [c for c in calls if c.kernel == kernel]
    assert len(mine) == len(FC.FRAME_CALLS[kernel])
    if kernel == "K7":        # stage 11's call alone passes a live mask
        assert [c.bound()["live"] is not None for c in mine] == [
            name == "stage-11 centres" for name in FC.FRAME_CALLS["K7"]]
    for call in mine:
        assert call.bound().get("patch_size", P) == P
        got, ref = call.run(), call.twin()
        torch.cuda.synchronize()
        FC.assert_matches_twin(call, got, ref)


def _on(d, arrays):
    return [torch.from_numpy(np.array(a)).to(d) for a in arrays]


@pytest.mark.parametrize("n_hyp,Q,n_valid,n_index", [
    (5000, 4096, 4000, 0), (256, 32768, 30000, 0), (5000, 32768, 29000, 256),
    (77, 1001, 999, 0), (130, 300, 0, 0), (64, 0, 0, 0), (90, 700, 650, 1)])
def test_ransac_score_kernel_matches_twin(dev, n_hyp, Q, n_valid, n_index):
    """K8 against its twin on the card: counts equal, gated-out -1, with
    and without an index; sizes off the block and tile widths."""
    d = PC.scene_quads(Q, Q, n_valid)
    KG, Kt, gate = _on(dev, PC.hypotheses(Q, n_hyp))
    g, cf, v = _on(dev, (d["gamma"], d["cf_left"], d["valid"]))
    index = None
    if n_index:
        index = torch.from_numpy(np.random.default_rng(n_hyp).permutation(
            n_hyp)[:n_index]).to(dev)
    for gt in (gate, None):
        k = POSE.ransac_counts_cuda(KG, Kt, g, cf, v, 1.5, gate=gt,
                                    index=index)
        p = POSE.ransac_counts_plain(KG, Kt, g, cf, v, 1.5, gate=gt,
                                     index=index)
        torch.cuda.synchronize()
        assert k.dtype == p.dtype == torch.int32
        assert torch.equal(k, p)
    if Q > 1000 and n_valid:
        assert int(k.max()) > 0


@pytest.mark.parametrize("Q", [0, 1, 127, 511, 512, 513, 4096, 32768])
def test_pose_gn_kernel_matches_twin(dev, Q):
    """K9's 28 sums bit-equal to its twin's on the card; a NaN in an
    invalid quad poisons both."""
    d = PC.scene_quads(Q, Q, (9 * Q) // 10)
    R, t = PC.gn_pose(Q)
    args = _on(dev, (R, t, d["gamma"], d["cf_left"], d["valid"], PC.K_LEFT))
    k = POSE.pose_gn_normal_equations_cuda(*args, 1.5)
    p = POSE.pose_gn_normal_equations_plain(*args, 1.5)
    torch.cuda.synchronize()
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))
    if Q > 2:
        assert 0 < float(k[27]) <= (9 * Q) // 10
        args[2][-1, 0] = float("nan")
        k = POSE.pose_gn_normal_equations_cuda(*args, 1.5)
        p = POSE.pose_gn_normal_equations_plain(*args, 1.5)
        assert bool(k[:27].isnan().any())
        assert torch.equal(k.isnan(), p.isnan())
        assert torch.equal(k[~k.isnan()], p[~p.isnan()])


def test_estimate_pose_kernels_match_twins_and_launch(dev):
    """estimate_pose at VOConfig()'s RANSAC sizes (5,000 hypotheses,
    prescore on 4,096 of 32,768 quads, 256 kept): R, t and the count equal
    on K8 / K9 and on the twins; 2 + 4 launches; the call never waits for
    the card."""
    d = PC.scene_quads(0, 32768, 30000)
    cfg = VOConfig()
    rig = TY.rig_arrays_from_rig(S.default_rig(120, 160), dev)
    pq = MT.PoseQuads(**dict(zip(d, _on(dev, d.values()))))
    CB.reset_launch_counts()
    res = MT.estimate_pose(pq, rig, cfg, seed=5)
    torch.cuda.synchronize()
    assert CB.LAUNCHES["ransac_score"] == 2 and CB.LAUNCHES["pose_gn"] == 4
    with PC.pose_twins():
        ref = MT.estimate_pose(pq, rig, cfg, seed=5)
    assert bool(res.success) and int(res.inlier_count) > 15000
    assert torch.equal(res.R, ref.R) and torch.equal(res.t, ref.t)
    assert int(res.inlier_count) == int(ref.inlier_count)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        MT.estimate_pose(pq, rig, cfg, seed=5)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_estimate_pose_singular_case_on_the_card(dev):
    """The refinement's exactly singular solve: a finite pose, success and
    2 inliers on the card, within 1e-4 of the CPU's
    (`pose_cases.singular_on_card`, every seed of tests/pose_cases.py)."""
    assert PC.singular_on_card(dev) == PC.SINGULAR_SEEDS


def test_pose_dispatch(dev, monkeypatch):
    """CUDA tensors launch K8 / K9 (one count each); CPU tensors never
    build."""
    d = PC.scene_quads(1, 600, 500)
    KG, Kt, gate = _on(dev, PC.hypotheses(1, 70))
    g, cf, v = _on(dev, (d["gamma"], d["cf_left"], d["valid"]))
    R, t, K = _on(dev, (*PC.gn_pose(1), PC.K_LEFT))
    before = dict(CB.LAUNCHES)
    POSE.ransac_counts(KG, Kt, g, cf, v, 1.5, gate=gate)
    POSE.pose_gn_normal_equations(R, t, g, cf, v, K, 1.5)
    torch.cuda.synchronize()
    assert CB.LAUNCHES["ransac_score"] == before["ransac_score"] + 1
    assert CB.LAUNCHES["pose_gn"] == before["pose_gn"] + 1

    def no_build():
        raise AssertionError("CPU tensors must not build or launch a kernel")

    monkeypatch.setattr(CB, "lib", no_build)
    POSE.ransac_counts(KG.cpu(), Kt.cpu(), g.cpu(), cf.cpu(), v.cpu(), 1.5,
                       gate=gate.cpu())
    POSE.pose_gn_normal_equations(R.cpu(), t.cpu(), g.cpu(), cf.cpu(),
                                  v.cpu(), K.cpu(), 1.5)
    assert CB.LAUNCHES["ransac_score"] == before["ransac_score"] + 1
    assert CB.LAUNCHES["pose_gn"] == before["pose_gn"] + 1


def test_run_ba_on_the_card_matches_cpu(dev):
    """The BA's scatter-adds use atomics on the card: poses within 1e-4 of
    the CPU solve, costs rtol 1e-3."""
    from edge_based_visual_odometry_tpu_torch.models import ba as BA
    rng = np.random.default_rng(2)
    n_kf, n_lm = 3, 120
    X = np.stack([rng.uniform(-3, 3, n_lm), rng.uniform(-2, 2, n_lm),
                  rng.uniform(4, 12, n_lm)], 1).astype(np.float32)
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]], np.float32)
    t = np.stack([[-0.1 * k, 0.0, -0.3 * k] for k in range(n_kf)]).astype(
        np.float32)
    kf, lm = np.divmod(np.arange(n_kf * n_lm), n_lm)
    uvw = (X[lm] + t[kf]) @ K.T
    uv = uvw[:, :2] / uvw[:, 2:3] + rng.normal(0, 0.3, (kf.size, 2))
    th = rng.uniform(0, np.pi, kf.size)
    X0 = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    f = dict(R=np.stack([np.eye(3, dtype=np.float32)] * n_kf),
             t=t + rng.normal(0, 0.02, t.shape).astype(np.float32) * (
                 np.arange(n_kf)[:, None] > 0),
             X=X0, obs_kf=kf, obs_lm=lm, obs_uv=uv.astype(np.float32),
             obs_w=np.ones(kf.size, np.float32), K_cam=K, X_prior=X0,
             prior_w=np.float32(25.0),
             obs_n=np.stack([-np.sin(th), np.cos(th)], -1).astype(np.float32))
    out = {}
    for d in ("cpu", dev):
        p = BA.BAProblem(**{k: torch.as_tensor(np.asarray(v)).to(d)
                            for k, v in f.items()})
        out[str(d)] = BA.run_ba(p, n_iters=6, damping=1e-3)
    a, b = out["cpu"], out[str(dev)]
    assert b.R.device.type == "cuda"
    torch.testing.assert_close(b.cost_history.cpu(), a.cost_history,
                               rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(b.R.cpu(), a.R, rtol=0, atol=1e-4)
    torch.testing.assert_close(b.t.cpu(), a.t, rtol=0, atol=1e-4)


def test_gn_kernel_bit_for_bit_on_remapped_float_frames(dev):
    """The stage-9 input of a distorted rig: the images are bilinear remaps,
    so float-valued, and the GT supervision has narrowed the rows. The
    kernel equals its twin bit for bit there too. The operands are those
    the step hands `refine_along_epipolar_batch` (`tests/frame_calls.py`)."""
    import dataclasses
    seq = S.make_sequence(1, 120, 160)
    cam = dataclasses.replace(seq.rig.left,
                              distortion=(-0.05, 0.01, 0.0005, -0.0005))
    rig = dataclasses.replace(seq.rig, left=cam, right=cam)
    f = seq.frames[0]
    step = PL.build_stereo_step(rig, VOConfig(**SMALL), dev, has_gt=True)
    with FC.Recording([(GN, "refine_along_epipolar_batch")]) as calls:
        step(f.left, f.right, f.disparity,
             np.full(f.left.shape, 255.0, np.float32))
    (call,) = calls
    a, kw = call.args, call.kwargs
    act = kw["active"]
    assert int(act.sum()) > 100
    assert float((a[1] != a[1].round()).float().mean()) > 0.5
    gn_kw = dict(patch_size=kw["patch_size"], tol=kw["tol"],
                 huber_delta=kw["huber_delta"], tile=kw["tile"])
    alpha0 = torch.zeros(act.shape[0], device=dev)
    for it0, it_stop in ((0, 2), (0, 20)):
        k = GN.refine_along_epipolar_cuda(*a, alpha0, act, it0, it_stop,
                                          max_iter=20, **gn_kw)
        p = GN.refine_along_epipolar_plain(*a, alpha0, act, it0, it_stop,
                                           max_iter=20, **gn_kw)
        for u, v in zip((*k[0], k[1]), (*p[0], p[1])):
            torch.testing.assert_close(u[act], v[act], rtol=0, atol=0)


def test_undistort_on_the_card_matches_cpu(dev, frame):
    img = torch.from_numpy(frame[0].astype(np.float32))
    K = torch.tensor([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]])
    d = torch.tensor([-0.1, 0.02, 0.001, -0.001])
    torch.testing.assert_close(
        IMG.undistort(img.to(dev), K.to(dev), d.to(dev)).cpu(),
        IMG.undistort(img, K, d), rtol=0, atol=1e-3)


def test_cli_run_on_the_card(dev, tmp_path):
    """The sequence path on the card at a small size: GT supervision, GT
    poses, BA, dumps, a checkpoint, and the resume."""
    from edge_based_visual_odometry_tpu_torch import cli as CLI
    from edge_based_visual_odometry_tpu_torch.io.datasets import StereoSample
    seq = S.make_sequence(3, 120, 160)
    cam = {"resolution": [160, 120], "intrinsics": [300.0, 300.0, 80.0, 60.0],
           "distortion_coefficients": [0, 0, 0, 0]}
    cfg = {"dataset_type": "ETH3D_stereo", "output_dir": str(tmp_path / "o"),
           "left_camera": cam, "right_camera": cam,
           "stereo": {"R21": [list(r) for r in seq.rig.R21],
                      "T21": list(seq.rig.T21)}}
    samples = [StereoSample(left=_u8(f.left), right=_u8(f.right),
                            timestamp=float(k), gt_R=f.R.T,
                            gt_t=-f.R.T @ f.t, file_idx=k,
                            left_disparity=f.disparity)
               for k, f in enumerate(seq.frames)]
    flags = dict(device="cuda", max_edges=1024, use_gt_pose=True, ba_window=3,
                 dump_stereo_pairs=True, dump_quads=True,
                 record_filter_distributions=True,
                 checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1)
    CB.reset_launch_counts()
    res = CLI.run(cfg, CLI.default_args(max_frames=2, **flags), samples)
    assert res["frames"] == 2 and CB.LAUNCHES["toed_gradient_field"] == 2
    res = CLI.run(cfg, CLI.default_args(**flags), samples)
    assert res["frames"] == 3 and res["frames_processed"] == 1
    pipe = res["pipe"]
    assert pipe.trajectory[2].R.device.type == "cuda"
    assert res["metrics"]["ate_rmse"] < 0.2
    assert float(pipe.stereo_metrics_log[-1][-1, 1]) > 0.9
    assert np.isfinite(pipe.temporal_metrics_log[-1]).all()
    assert (tmp_path / "o" / "quads_frame_2.txt").exists()


def test_analyze_production_memory(dev):
    """One pair step at 376x1241 with VOConfig() fits the card; the
    arguments are the four float32 images and the prediction."""
    from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM
    r = PM.analyze_production_memory(1)
    assert r["fits_hbm"] and r["peak_mib"] < r["device_mib"], r
    # the analysis saw a real program: the step's own peak
    assert r["temp_mib"] > 100, r
    assert abs(r["argument_mib"] * 2 ** 20
               - (4 * 376 * 1241 * 4 + 9 * 4 + 3 * 4 + 4)) < 1, r


def test_nccl_pair_step_world_size_1(dev):
    """The sharded pair step on a one-rank NCCL group: both kernels launch
    for every stereo step, the mates agree with the CPU pair step, the
    all-reduced mean is the mean of the rows."""
    import torch.distributed as dist
    from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM
    seq = S.make_sequence(3, 120, 160)
    cfg = VOConfig(**SMALL)
    frames = [(_u8(f.left), _u8(f.right)) for f in seq.frames]
    pairs = [(0, 1), (1, 2)]
    args = [np.stack([frames[p[i]][j] for p in pairs])
            for i in (0, 1) for j in (0, 1)]
    args += [np.stack([np.eye(3, dtype=np.float32)] * 2),
             np.zeros((2, 3), np.float32), np.array([3, 4])]
    mesh = PM.init_distributed(device="cuda")
    try:
        assert dist.get_backend() == "nccl" and mesh.size() == 1
        step = PM.build_sharded_pair_step(seq.rig, cfg, mesh)
        CB.reset_launch_counts()
        out = step(*args)
        torch.cuda.synchronize()
        assert CB.LAUNCHES["toed_gradient_field"] == 4
        assert CB.LAUNCHES["refine_along_epipolar"] >= 4
    finally:
        dist.destroy_process_group()
    assert out.R.device.type == "cuda" and out.R.shape == (2, 3, 3)
    torch.testing.assert_close(out.mean_inlier_ratio,
                               out.inlier_ratio.mean(), rtol=0, atol=1e-6)
    one = PM.build_pair_step(seq.rig, cfg, "cpu")
    for i in range(2):
        ref = one(*(a[i] for a in args))
        for u, v in ((out.n_mates_kf[i], ref[3]), (out.n_mates_cf[i], ref[4])):
            assert min(int(u), int(v)) >= 0.97 * max(int(u), int(v))
        assert float(out.inlier_ratio[i]) > 0.3


def test_window_ba_sharded_over_nccl_ranks(dev, tmp_path):
    """One rank per visible card in an NCCL group split the windowed BA of
    the 8-keyframe corridor chain; every rank's poses within 1e-4 of one
    card's solve. Needs two cards or more."""
    from tests import torch_ranks as TR
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA devices")
    res = TR.spawn(TR.window_ba_worker, n, tmp_path, None,
                   str(tmp_path / "store"), init=False, timeout=300)
    assert [r["device"] for r in res] == [f"cuda:{k}" for k in range(n)]
    for r in res:
        for a, b in zip(res[0]["single"], r["sharded"]):
            np.testing.assert_allclose(a, b, atol=1e-4)
