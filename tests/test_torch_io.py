"""The port's numpy-only copies (`io/pfm.py`, `io/datasets.py`,
`io/native_loader.py`, `utils/metrics.py`) pinned to their originals, and
`utils/timing.py` held against the reference's report format: the
same functions with the same source (apart from the package they import
from), and the same results on a PFM round trip, on synthetic KITTI and
ETH3D trees, and on trajectories held as JAX arrays or as torch tensors."""

import dataclasses
import inspect
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from edge_based_visual_odometry_tpu import geometry as JGEO
from edge_based_visual_odometry_tpu.io import datasets as JD
from edge_based_visual_odometry_tpu.io import native_loader as JNL
from edge_based_visual_odometry_tpu.io import pfm as JPFM
from edge_based_visual_odometry_tpu.utils import metrics as JMET
from edge_based_visual_odometry_tpu_torch import geometry as GEO
from edge_based_visual_odometry_tpu_torch.io import datasets as TD
from edge_based_visual_odometry_tpu_torch.io import native_loader as TNL
from edge_based_visual_odometry_tpu_torch.io import pfm as TPFM
from edge_based_visual_odometry_tpu_torch.io import synthetic as S
from edge_based_visual_odometry_tpu_torch.utils import metrics as TMET

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "edge_based_visual_odometry_tpu", \
    "edge_based_visual_odometry_tpu_torch"


def _functions(mod):
    return {n: f for n, f in vars(mod).items()
            if (inspect.isfunction(f) or inspect.isclass(f))
            and f.__module__ == mod.__name__}


def _same_source(jf, tf):
    return (inspect.getsource(jf).replace(JAX_PKG + ".", PORT_PKG + ".")
            == inspect.getsource(tf))


@pytest.mark.parametrize("jmod,tmod,differ", [
    (JPFM, TPFM, set()),
    # StereoSample: one comment names the CLI instead of main_vo.py
    (JD, TD, {"StereoSample"}),
    # the build goes to build/native_loader/ instead of beside the source
    (JNL, TNL, {"_build"}),
    # poses may hold tensors: the readers of p.R / p.t go through to_numpy
    (JMET, TMET, {"_poses_to_positions", "rpe_stats",
                  "write_trajectory_tum"}),
], ids=["pfm", "datasets", "native_loader", "metrics"])
def test_copy_has_the_same_functions(jmod, tmod, differ):
    jf, tf = _functions(jmod), _functions(tmod)
    assert set(tf) == set(jf)
    for name in set(jf) - differ:
        assert _same_source(jf[name], tf[name]), name
    src = inspect.getsource(tmod)
    assert "import jax" not in src and f"from {JAX_PKG}." not in src
    assert f"import {JAX_PKG}." not in src


@pytest.mark.parametrize("shape,little", [((5, 7), True), ((5, 7), False),
                                          ((4, 6, 3), True)])
def test_pfm_round_trip(tmp_path, shape, little):
    img = np.random.default_rng(3).uniform(-5, 300, shape).astype(np.float32)
    img[0, 0] = np.inf
    a, b = str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm")
    JPFM.write_pfm(a, img, little_endian=little)
    TPFM.write_pfm(b, img, little_endian=little)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(TPFM.read_pfm(a), img)
    np.testing.assert_array_equal(JPFM.read_pfm(b), img)
    with pytest.raises(ValueError):
        TPFM.write_pfm(a, np.zeros((2, 2, 2), np.float32))
    (tmp_path / "bad.pfm").write_bytes(b"P6\n1 1\n-1\n")
    with pytest.raises(ValueError):
        TPFM.read_pfm(str(tmp_path / "bad.pfm"))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A KITTI tree and an ETH3D-stereo tree of 3 synthetic frames."""
    from PIL import Image
    root = tmp_path_factory.mktemp("io_trees")
    seq = S.make_sequence(3, 60, 80)
    kseq = root / "KITTI-gray" / "00"
    for d in ("image_0", "image_1"):
        (kseq / d).mkdir(parents=True)
    (root / "poses").mkdir()
    lines = []
    for k, f in enumerate(seq.frames):
        Image.fromarray(f.left.astype(np.uint8)).save(
            str(kseq / "image_0" / f"{k:06d}.png"))
        Image.fromarray(f.right.astype(np.uint8)).save(
            str(kseq / "image_1" / f"{k:06d}.png"))
        M = np.hstack([f.R.T, (-f.R.T @ f.t)[:, None]])
        lines.append(" ".join(f"{v:.9f}" for v in M.reshape(-1)))
        pair = root / "eth" / "stereo_pairs" / f"pair_{k}"
        pair.mkdir(parents=True)
        Image.fromarray(f.left.astype(np.uint8)).save(str(pair / "im0.png"))
        Image.fromarray(f.right.astype(np.uint8)).save(str(pair / "im1.png"))
        TPFM.write_pfm(str(pair / "disp0GT.pfm"), f.disparity)
        Image.fromarray(np.full((60, 80), 255, np.uint8)).save(
            str(pair / "mask0nocc.png"))
        q = GEO.R_to_quat(f.R)
        (pair / "images.txt").write_text(
            f"1 {q[0]} {q[1]} {q[2]} {q[3]} {f.t[0]} {f.t[1]} {f.t[2]} 0 "
            "im0.png\n")
    (root / "poses" / "00.txt").write_text("\n".join(lines) + "\n")
    return root, seq


def _same_samples(a, b):
    assert len(a) == len(b) > 0
    for sa, sb in zip(a, b):
        for f in dataclasses.fields(TD.StereoSample):
            va, vb = getattr(sa, f.name), getattr(sb, f.name)
            if va is None or vb is None:
                assert va is None and vb is None, f.name
            else:
                np.testing.assert_array_equal(np.asarray(va), np.asarray(vb))


@pytest.mark.parametrize("case", ["kitti_sync", "kitti_prefetch",
                                  "kitti_resume", "eth3d", "eth3d_resume"])
def test_dataset_iterators_match(trees, case):
    root, seq = trees
    if case.startswith("kitti"):
        kw = dict(image_hw=(60, 80), prefetch=case == "kitti_prefetch",
                  start=1 if case == "kitti_resume" else 0)
        args = ("KITTI", str(root), "KITTI-gray/00", "poses")
    else:
        kw = dict(start=1 if case == "eth3d_resume" else 0)
        args = ("ETH3D_stereo", str(root), "eth")
    a = list(TD.make_iterator(*args, **kw))
    b = list(JD.make_iterator(*args, **kw))
    _same_samples(a, b)
    assert len(a) == 3 and [s.file_idx for s in a] == [0, 1, 2]
    last = a[-1]
    assert last.left.shape == (60, 80) and last.left.dtype == np.float32
    np.testing.assert_array_equal(last.left,
                                  seq.frames[2].left.astype(np.uint8))
    np.testing.assert_allclose(last.gt_R, seq.frames[2].R.T, atol=1e-6)
    if kw["start"]:
        assert a[0].left is None           # metadata only before `start`
    if case.startswith("eth3d"):
        np.testing.assert_array_equal(last.left_disparity,
                                      seq.frames[2].disparity)
        assert float(last.left_occlusion.min()) == 255.0
    with pytest.raises(ValueError):
        TD.make_iterator("nope", str(root), "x")


def test_native_loader_builds_into_build_dir(trees):
    root, seq = trees
    if not TNL.native_available():
        pytest.skip("g++ or libpng not available: the decoders fall through "
                    "to cv2 / PIL")
    so = os.path.realpath(TNL._SO)
    assert so.startswith(os.path.join(REPO, "build", "native_loader"))
    assert os.path.exists(so)
    path = str(root / "KITTI-gray" / "00" / "image_0" / "000001.png")
    img = TNL.decode_gray(path, 60, 80)
    np.testing.assert_array_equal(img, seq.frames[1].left.astype(np.uint8))
    if JNL.native_available():
        np.testing.assert_array_equal(img, JNL.decode_gray(path, 60, 80))
    assert TNL.decode_gray(path, 61, 80) is None      # dims != rig: refused
    pairs = [(path, path.replace("image_0", "image_1"))]
    (idx, left, right), = list(TNL.PrefetchLoader(pairs, 60, 80))
    assert idx == 0
    np.testing.assert_array_equal(right, seq.frames[1].right.astype(np.uint8))


def _poses(n, seed, kind):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        w = rng.normal(0, 0.05, 3)
        R = np.asarray(JGEO.so3_exp(jnp.asarray(w, jnp.float32)), np.float32)
        t = (rng.normal(0, 0.3, 3) + [0, 0, 0.5 * k]).astype(np.float32)
        out.append(JGEO.Pose(jnp.asarray(R), jnp.asarray(t)) if kind == "jax"
                   else GEO.Pose(torch.from_numpy(R.copy()), torch.from_numpy(t)))
    return out


def test_trajectory_metrics_match(tmp_path):
    est_j, gt_j = _poses(6, 1, "jax"), _poses(6, 2, "jax")
    est_t, gt_t = _poses(6, 1, "torch"), _poses(6, 2, "torch")
    assert TMET.ate_rmse(est_t, gt_t) == JMET.ate_rmse(est_j, gt_j) > 0
    assert TMET.ate_rmse(est_t, gt_t, align=False) == \
        JMET.ate_rmse(est_j, gt_j, align=False)
    assert TMET.rpe_stats(est_t, gt_t) == JMET.rpe_stats(est_j, gt_j)
    assert TMET.rpe_stats(est_t[:1], gt_t[:1]) == (0.0, 0.0)
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    for ts in (None, [10.5 + k for k in range(6)]):
        TMET.write_trajectory_tum(a, est_t, timestamps=ts)
        JMET.write_trajectory_tum(b, est_j, timestamps=ts)
        assert open(a).read() == open(b).read()
    assert len(open(a).read().splitlines()) == 6


def test_stage_tables_match():
    rng = np.random.default_rng(5)
    rows = [rng.uniform(0, 1, (12, 4)) for _ in range(3)]
    avg = TMET.average_stage_metrics(rows)
    np.testing.assert_array_equal(avg, JMET.average_stage_metrics(rows))
    assert TMET.average_stage_metrics([]).shape == (0, 4)
    names = [f"stage {i}" for i in range(12)]
    assert TMET.format_stage_table(names, avg, "T") == \
        JMET.format_stage_table(names, avg, "T")


def test_stage_timer_and_device_trace(tmp_path):
    """StageTimer reports in the reference's table format; device_trace
    writes a Chrome trace of the block (CPU activity here)."""
    from edge_based_visual_odometry_tpu.utils import timing as JTIM
    from edge_based_visual_odometry_tpu_torch.utils import timing as TIM
    timer, jtimer = TIM.StageTimer(), JTIM.StageTimer()
    out = timer.timed("matmul", torch.matmul, torch.ones(8, 8), torch.ones(8, 8))
    assert float(out[0, 0]) == 8.0 and len(timer.times["matmul"]) == 1
    with timer.stage("host"):
        pass
    timer.times = {"a": [0.001, 0.003], "b": [0.5]}
    jtimer.times = {"a": [0.001, 0.003], "b": [0.5]}
    assert timer.report() == jtimer.report()
    assert "TOTAL" in timer.report().splitlines()[-1]
    with TIM.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 100
    assert any("mm" in e.key or "matmul" in e.key for e in prof.key_averages())
