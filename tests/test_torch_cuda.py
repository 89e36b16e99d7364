"""The hand-written CUDA kernels against their plain-PyTorch twins, on the
card. Every test here needs a CUDA device (marker `gpu`) and skips
without one. The file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from edge_based_visual_odometry_tpu_torch.config import VOConfig
from edge_based_visual_odometry_tpu_torch.io import synthetic as S
from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
from edge_based_visual_odometry_tpu_torch.ops import cuda_build as CB
from edge_based_visual_odometry_tpu_torch.ops import gauss_newton as GN
from edge_based_visual_odometry_tpu_torch.ops import image as IMG
from edge_based_visual_odometry_tpu_torch.ops import toed as T

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
    for a, b in zip(out[:3], ref[:3]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-3)
    m = ref[2] > 2.0
    d = (out[3] - ref[3]).abs()[m]
    d = torch.minimum(d, 2 * np.pi - d)
    assert float(torch.quantile(d.double().cpu(), 0.999)) < 1e-3


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
