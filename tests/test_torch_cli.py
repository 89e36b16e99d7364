"""The port's CLI end to end on synthetic dataset trees on disk, in-process
on the CPU (`--device cpu --max_edges 1024`): the files and printed lines
that tests/test_cli_dataset.py and tests/test_cli_eth3d.py assert of the
reference CLI, checkpoint resume (equal to the uninterrupted run), a
checkpoint written by the reference restoring into the port, and the dump
writers against the reference's on the same arrays (text equal where the
writer is pure numpy; rtol 1e-5 / atol 1e-5 where it triangulates)."""

import json
import os
import types

import numpy as np
import pytest
import torch
import yaml

from edge_based_visual_odometry_tpu_torch import cli as CLI
from edge_based_visual_odometry_tpu_torch import geometry as GEO
from edge_based_visual_odometry_tpu_torch.config import VOConfig
from edge_based_visual_odometry_tpu_torch.io import synthetic as S
from edge_based_visual_odometry_tpu_torch.io.pfm import write_pfm
from edge_based_visual_odometry_tpu_torch.models import pipeline as PL
from edge_based_visual_odometry_tpu_torch.models import types as TY
from edge_based_visual_odometry_tpu_torch.utils import checkpoint as CKPT
from edge_based_visual_odometry_tpu_torch.utils import debug_io as DIO

pytestmark = pytest.mark.heavy
torch.set_num_threads(2)

H, W = 120, 160
SMALL = dict(max_edges=1024, max_candidates=8, gather_slots=64,
             max_mates=512, max_refine_pairs=1024, max_quad_candidates=8,
             quad_gather_slots=144, ransac_max_iterations=256, gn_max_iter=4)


# the capacities --max_edges does not scale, cut through --set
SET_SMALL = [a for k in ("max_candidates", "gather_slots",
                         "max_quad_candidates", "quad_gather_slots",
                         "gn_max_iter")
             for a in ("--set", f"{k}={SMALL[k]}")]


def _cam_yaml(cam):
    return {"resolution": [W, H],
            "intrinsics": [float(cam.fx), float(cam.fy), float(cam.cx),
                           float(cam.cy)],
            "distortion_coefficients": [0, 0, 0, 0]}


def _rig_yaml(rig):
    return {"left_camera": _cam_yaml(rig.left),
            "right_camera": _cam_yaml(rig.right),
            "stereo": {"R21": np.asarray(rig.R21).tolist(),
                       "T21": np.asarray(rig.T21).ravel().tolist()}}


@pytest.fixture(scope="module")
def seq():
    return S.make_sequence(n_frames=3, h=H, w=W)


@pytest.fixture(scope="module")
def kitti_cfg(tmp_path_factory, seq):
    """KITTI layout: image_{0,1}/NNNNNN.png + cam-to-world pose lines."""
    from PIL import Image
    root = tmp_path_factory.mktemp("kitti_torch")
    seq_dir = root / "KITTI-gray" / "00"
    (seq_dir / "image_0").mkdir(parents=True)
    (seq_dir / "image_1").mkdir(parents=True)
    (root / "KITTI-gt" / "poses").mkdir(parents=True)
    lines = []
    for k, f in enumerate(seq.frames):
        for d, img in (("image_0", f.left), ("image_1", f.right)):
            Image.fromarray(img.astype(np.uint8)).save(
                str(seq_dir / d / f"{k:06d}.png"))
        M = np.hstack([f.R.T, (-f.R.T @ f.t)[:, None]])
        lines.append(" ".join(f"{v:.9f}" for v in M.reshape(-1)))
    (root / "KITTI-gt" / "poses" / "00.txt").write_text("\n".join(lines) + "\n")
    cfg = {"dataset_type": "KITTI", "dataset_dir": str(root),
           "sequence_name": "KITTI-gray/00", "output_dir": str(root / "out"),
           "gt_file_path": "KITTI-gt/poses", **_rig_yaml(seq.rig)}
    path = root / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return root, str(path)


@pytest.fixture(scope="module")
def eth3d_cfg(tmp_path_factory, seq):
    """ETH3D two-view layout: im{0,1}.png, disp0GT.pfm, masks, images.txt
    (COLMAP world->cam)."""
    from PIL import Image
    root = tmp_path_factory.mktemp("eth3d_torch")
    for k, f in enumerate(seq.frames):
        pair = root / "delivery_area" / "stereo_pairs" / f"pair_{k}"
        pair.mkdir(parents=True)
        Image.fromarray(np.asarray(f.left, np.uint8)).save(str(pair / "im0.png"))
        Image.fromarray(np.asarray(f.right, np.uint8)).save(str(pair / "im1.png"))
        write_pfm(str(pair / "disp0GT.pfm"), np.asarray(f.disparity, np.float32))
        for m in ("mask0nocc.png", "mask1nocc.png"):
            Image.fromarray(np.full((H, W), 255, np.uint8)).save(str(pair / m))
        qw, qx, qy, qz = GEO.R_to_quat(f.R)
        (pair / "images.txt").write_text(
            "# COLMAP image list\n"
            f"1 {qw} {qx} {qy} {qz} {f.t[0]} {f.t[1]} {f.t[2]} 0 im0.png\n"
            "0.0 0.0 -1\n")
    cfg = {"dataset_type": "ETH3D_stereo", "dataset_dir": str(root),
           "sequence_name": "delivery_area", "output_dir": str(root / "out"),
           **_rig_yaml(seq.rig)}
    path = root / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return root, str(path)


def _main(cfg_path, *flags):
    return CLI.main(["-c", cfg_path, "--device", "cpu", "--max_edges", "1024",
                     *SET_SMALL, *flags])


def _traj(out_dir):
    return np.loadtxt(os.path.join(out_dir, "trajectory_tum.txt"), ndmin=2)


def test_kitti_end_to_end(kitti_cfg, capsys):
    root, cfg_path = kitti_cfg
    assert _main(cfg_path, "--max_frames", "3") == 0
    out = capsys.readouterr().out
    assert "processed 3 frames" in out
    assert "frame 2: edges L/R = " in out and "quads = " in out
    assert "ATE RMSE = " in out and "trajectory written to" in out
    assert _traj(str(root / "out")).shape == (3, 8)
    m = json.load(open(root / "out" / "metrics.json"))
    assert m["frames"] == 3 and m["frames_processed"] == 3
    assert m["ate_rmse"] < 0.2
    assert "ba" not in m


def test_kitti_dump_files(kitti_cfg, capsys):
    """--dump_stereo_pairs / --dump_quads / --record_filter_distributions
    write the reference's per-frame formats."""
    root, cfg_path = kitti_cfg
    out_dir = str(root / "out_dump")
    assert _main(cfg_path, "--max_frames", "2", "--output_dir", out_dir,
                 "--dump_stereo_pairs", "--dump_quads",
                 "--record_filter_distributions") == 0
    for k in range(2):
        lines = open(os.path.join(
            out_dir, f"finalized_stereo_edge_pairs_frame_{k}.txt")
        ).read().splitlines()
        assert len(lines) > 1 and len(lines[1].split()) == 16
    qlines = open(os.path.join(out_dir, "quads_frame_1.txt")).read().splitlines()
    assert qlines[0].startswith("# keyframe 0")
    assert len(qlines) > 2 and len(qlines[2].split(",")) == 8
    for k in range(2):
        fdl = open(os.path.join(out_dir, f"sift_distance_frame_{k}.txt")
                   ).read().splitlines()
        assert fdl[2] == "filter_value\tis_GT"
        assert len(fdl) > 3 and len(fdl[3].split("\t")) == 2
        al = open(os.path.join(out_dir, f"ambiguity_sift_frame_{k}.txt")
                  ).read().splitlines()
        assert al[2] == "num_candidates" and len(al) > 3


def test_save_viz_renders_figures(kitti_cfg, capsys):
    """--save_viz renders every dump of the run into <output_dir>/viz
    through the port's own viz/ (as main_vo.py does with the
    reference's)."""
    root, cfg_path = kitti_cfg
    out_dir = str(root / "out_viz")
    assert _main(cfg_path, "--max_frames", "2", "--output_dir", out_dir,
                 "--dump_stereo_pairs", "--dump_quads", "--save_viz") == 0
    out = capsys.readouterr().out
    pngs = sorted(os.listdir(os.path.join(out_dir, "viz")))
    assert f"rendered {len(pngs)} figures" in out
    assert {"finalized_stereo_edge_pairs_frame_0.png",
            "finalized_stereo_edge_pairs_frame_1.png", "quads_frame_1.png",
            "trajectory_tum.png"} <= set(pngs)
    for name in pngs:
        assert os.path.getsize(os.path.join(out_dir, "viz", name)) > 1000


@pytest.mark.parametrize("ba_window", [0, 3])
def test_checkpoint_resume_equals_uninterrupted(kitti_cfg, capsys, ba_window):
    """Run 2 of 3 frames, resume and finish: the resumed run skips the
    processed frames and its trajectory equals the uninterrupted run's."""
    root, cfg_path = kitti_cfg
    tag = f"ba{ba_window}"
    flags = ["--ba_window", str(ba_window)]
    full_dir = str(root / f"out_full_{tag}")
    assert _main(cfg_path, "--output_dir", full_dir, *flags) == 0
    capsys.readouterr()

    out_dir, ck_dir = str(root / f"out_ck_{tag}"), str(root / f"ck_{tag}")
    base = ["--output_dir", out_dir, "--checkpoint_dir", ck_dir,
            "--checkpoint_every", "1", *flags]
    assert _main(cfg_path, "--max_frames", "2", *base) == 0
    assert os.path.exists(os.path.join(ck_dir, "state.npz"))
    assert os.path.exists(os.path.join(ck_dir, "meta.json"))
    cs = np.load(os.path.join(ck_dir, "cli_state.npz"))
    assert int(cs["file_pos"]) == 2 and cs["gt_R"].shape[0] == 2
    capsys.readouterr()

    assert _main(cfg_path, *base) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint at frame 2 (file 2)" in out
    assert "frame 2:" in out and "frame 1:" not in out
    np.testing.assert_array_equal(_traj(out_dir), _traj(full_dir))
    m = json.load(open(os.path.join(out_dir, "metrics.json")))
    assert m["frames"] == 3 and m["frames_processed"] == 1
    assert m["ate_rmse"] < 0.2
    if ba_window:
        full = json.load(open(os.path.join(full_dir, "metrics.json")))
        assert full["ba"]["solves"] == 2 and full["ba"]["mean_obs"] > 10
    # a pipeline state without its file position is refused, not guessed
    os.remove(os.path.join(ck_dir, "cli_state.npz"))
    with pytest.raises(FileNotFoundError, match="cli_state.npz"):
        _main(cfg_path, *base)
    capsys.readouterr()


@pytest.mark.parametrize("use_gt_pose", [False, True])
def test_eth3d_gt_supervised(eth3d_cfg, capsys, use_gt_pose):
    root, cfg_path = eth3d_cfg
    out_dir = str(root / f"out_{int(use_gt_pose)}")
    flags = ["--output_dir", out_dir, "--record_filter_distributions"]
    assert _main(cfg_path, *flags,
                 *(["--use_gt_pose"] if use_gt_pose else [])) == 0
    out = capsys.readouterr().out
    assert "Stereo Edge Matching Metrics" in out
    assert "Recall" in out and "Epipolar Proximity" in out
    assert ("Temporal Quad Matching Metrics" in out) == use_gt_pose
    assert "frame 2:" in out
    m = json.load(open(os.path.join(out_dir, "metrics.json")))
    assert m["frames"] == 3 and m["ate_rmse"] < 0.2
    final = [ln for ln in out.splitlines() if ln.strip().startswith("Final")]
    recall, precision = (float(v) for v in final[0].split("|")[1:3])
    assert recall > 0.5 and precision > 0.5, final[0]
    if use_gt_pose:
        rows = [ln for ln in out.splitlines()
                if ln.strip().startswith("Edge Clustering")]
        t_recall, t_precision = (float(v) for v in rows[-1].split("|")[1:3])
        assert t_recall > 0.3 and t_precision > 0.5, rows[-1]
    # GT datasets also get the per-cluster evaluation dumps
    for name in ("photo_refine_data_from_evaluation_statistics_frame_0.txt",
                 "matching_edge_clusters_data_frame_0.txt",
                 "false_negative_edge_clusters_frame_0.txt",
                 "false_negative_edge_clusters_contributing_edges_frame_0.txt",
                 "ncc_frame_0.txt", "ambiguity_edge_clustering_frame_0.txt"):
        assert os.path.exists(os.path.join(out_dir, name)), name


@pytest.mark.parametrize("flags,exc", [
    (["--keyframe_policy", "sometimes"], SystemExit),
    (["--ba_window", "3", "--keyframe_policy", "reference"], SystemExit),
])
def test_flags_refused_at_parse_time(kitti_cfg, capsys, flags, exc):
    with pytest.raises(exc) as e:
        CLI.main(["-c", kitti_cfg[1], "--device", "cpu", *flags])
    assert e.value.code != 0
    capsys.readouterr()


def test_default_device_is_cuda_and_never_silently_cpu(kitti_cfg, monkeypatch):
    assert CLI.default_args().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLI.main(["-c", kitti_cfg[1], "--max_edges", "1024"])


def test_run_takes_a_dict_and_in_memory_samples(seq, tmp_path, capsys):
    """`run` needs no YAML file, no dataset tree and no image decoder."""
    from edge_based_visual_odometry_tpu_torch.io.datasets import StereoSample
    cfg = {"dataset_type": "KITTI", "output_dir": str(tmp_path),
           **_rig_yaml(seq.rig)}
    samples = [StereoSample(left=f.left.astype(np.uint8),
                            right=f.right.astype(np.uint8), timestamp=float(k),
                            gt_R=f.R.T, gt_t=-f.R.T @ f.t, file_idx=k)
               for k, f in enumerate(seq.frames[:2])]
    res = CLI.run(cfg, CLI.default_args(device="cpu", max_edges=1024), samples)
    assert res["frames"] == 2 and res["metrics"]["frames"] == 2
    assert len(res["pipe"].trajectory) == 2
    assert _traj(str(tmp_path)).shape == (2, 8)
    capsys.readouterr()


# --------------------------------------------------------------------------
# against the reference package
# --------------------------------------------------------------------------

def _u8(a):
    return np.round(a).clip(0, 255).astype(np.uint8)


def test_reference_checkpoint_restores_into_port(seq, tmp_path):
    """A checkpoint written by the reference's save_pipeline_state restores
    into the port's pipeline: same state, and the next frame tracks."""
    from edge_based_visual_odometry_tpu.config import VOConfig as JVOConfig
    from edge_based_visual_odometry_tpu.models import pipeline as JPL
    from edge_based_visual_odometry_tpu.utils import checkpoint as JCKPT

    jpipe = JPL.VOPipeline(rig=seq.rig, cfg=JVOConfig(**SMALL))
    for f in seq.frames[:2]:
        jpipe.run_frame(_u8(f.left), _u8(f.right))
    JCKPT.save_pipeline_state(str(tmp_path), jpipe)

    pipe = PL.VOPipeline(seq.rig, VOConfig(**SMALL), device="cpu")
    assert CKPT.restore_pipeline_state(str(tmp_path), pipe)
    assert pipe.frame_idx == 2 and pipe.kf_index == jpipe.kf_index
    assert len(pipe.trajectory) == 2
    np.testing.assert_array_equal(pipe.trajectory[1].R.numpy(),
                                  np.asarray(jpipe.trajectory[1].R))
    km, jm = pipe.keyframe.mates, jpipe.keyframe.mates
    assert int(km.count) == int(jm.count) > 100
    assert km.left_desc.dtype == torch.bfloat16
    for name in ("left_x", "right_x", "gamma", "left_patches", "valid"):
        np.testing.assert_array_equal(getattr(km, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    np.testing.assert_array_equal(
        km.left_desc.view(torch.int16).numpy().view(np.uint16),
        np.asarray(jm.left_desc).view(np.uint16))
    np.testing.assert_array_equal(pipe.keyframe.frame.left_gx.numpy(),
                                  np.asarray(jpipe.keyframe.frame.left_gx))
    f = seq.frames[2]
    fr, tr = pipe.run_frame(_u8(f.left), _u8(f.right))
    assert bool(tr.success) and float(tr.inlier_ratio) > 0.3
    R_gt = f.R @ seq.frames[1].R.T
    c = (np.trace(tr.R.double().numpy() @ R_gt.T) - 1) / 2
    assert np.degrees(np.arccos(np.clip(c, -1, 1))) < 0.5
    # and the port's own round trip is exact
    CKPT.save_pipeline_state(str(tmp_path / "again"), pipe)
    pipe2 = PL.VOPipeline(seq.rig, VOConfig(**SMALL), device="cpu")
    assert CKPT.restore_pipeline_state(str(tmp_path / "again"), pipe2)
    assert pipe2._have_velocity and pipe2.frame_idx == 3
    for a, b in zip(pipe.keyframe.mates, pipe2.keyframe.mates):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_restores_a_supervised_keyframe(seq, tmp_path):
    """A GT-supervised keyframe carries the right edges its stereo step
    read (`FrameResult.right_edges`, an Optional field): they round-trip
    through the checkpoint, and the restored pipeline goes on."""
    pipe = PL.VOPipeline(seq.rig, VOConfig(**SMALL), device="cpu",
                         has_gt_disparity=True)
    for f in seq.frames[:2]:
        pipe.run_frame(_u8(f.left), _u8(f.right), disparity=f.disparity)
    red = pipe.keyframe.right_edges
    assert red is not None and int(red.count) > 100
    CKPT.save_pipeline_state(str(tmp_path), pipe)
    pipe2 = PL.VOPipeline(seq.rig, VOConfig(**SMALL), device="cpu",
                          has_gt_disparity=True)
    assert CKPT.restore_pipeline_state(str(tmp_path), pipe2)
    for a, b in zip(red, pipe2.keyframe.right_edges):
        assert a.dtype == b.dtype and torch.equal(a, b)
    f = seq.frames[2]
    fr, tr = pipe2.run_frame(_u8(f.left), _u8(f.right),
                             disparity=f.disparity)
    assert tr is not None and len(pipe2.stereo_metrics_log) == 1


def _as_numpy_nt(nt):
    """A port NamedTuple of tensors as a namespace of numpy arrays (bf16 as
    float32), which the reference's writers read."""
    def conv(v):
        if torch.is_tensor(v):
            return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        if hasattr(v, "_fields"):
            return _as_numpy_nt(v)
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return v
    return types.SimpleNamespace(**{f: conv(getattr(nt, f))
                                    for f in nt._fields})


@pytest.fixture(scope="module")
def eval_frames(seq):
    pipe = PL.VOPipeline(seq.rig, VOConfig(**SMALL), device="cpu",
                         has_gt_disparity=True, record_distributions=True)
    out = []
    for f in seq.frames[:2]:
        kf = pipe.keyframe
        out.append((kf, *pipe.run_frame(_u8(f.left), _u8(f.right),
                                        disparity=f.disparity)))
    return out


@pytest.mark.parametrize("writer", ["stereo_pairs", "quads", "distributions",
                                    "eval_clusters", "disparities", "toed"])
def test_dump_writers_match_reference(seq, eval_frames, tmp_path, writer):
    from edge_based_visual_odometry_tpu.models.types import RigArrays
    from edge_based_visual_odometry_tpu.utils import debug_io as JDIO

    (_, fr0, _), (kf, fr1, tr1) = eval_frames
    a_dir, b_dir = tmp_path / "port", tmp_path / "ref"
    a_dir.mkdir()
    b_dir.mkdir()
    mates_np = _as_numpy_nt(fr1.mates)
    dists_np = {k: (_as_numpy_nt(v) if hasattr(v, "_fields")
                    else tuple(x.numpy() for x in v))
                for k, v in fr1.distributions.items()}
    numeric = False
    if writer == "stereo_pairs":
        numeric = True
        DIO.write_finalized_stereo_pairs(
            str(a_dir / "f.txt"), fr1.mates,
            TY.rig_arrays_from_rig(seq.rig, "cpu"))
        JDIO.write_finalized_stereo_pairs(str(b_dir / "f.txt"), mates_np,
                                          RigArrays.from_rig(seq.rig))
    elif writer == "quads":
        DIO.write_quads(str(a_dir / "f.txt"), kf.mates, tr1.quads, 0, 1)
        JDIO.write_quads(str(b_dir / "f.txt"), _as_numpy_nt(kf.mates),
                         _as_numpy_nt(tr1.quads), 0, 1)
    elif writer == "distributions":
        DIO.write_distributions(str(a_dir), 1, fr1.distributions)
        JDIO.write_distributions(str(b_dir), 1, dists_np)
    elif writer == "eval_clusters":
        DIO.write_eval_cluster_dumps(str(a_dir), 1, fr1.distributions, tol=3.0)
        JDIO.write_eval_cluster_dumps(str(b_dir), 1, dists_np, tol=3.0)
    elif writer == "disparities":
        DIO.write_disparities(str(a_dir / "f.txt"), fr1.mates, 1)
        JDIO.write_disparities(str(b_dir / "f.txt"), mates_np, 1)
    else:
        edges = types.SimpleNamespace(
            count=fr1.mates.count, x=fr1.mates.left_x, y=fr1.mates.left_y,
            theta=fr1.mates.left_theta)
        DIO.write_toed_edges(str(a_dir / "f.txt"), edges)
        JDIO.write_toed_edges(str(b_dir / "f.txt"), types.SimpleNamespace(
            count=mates_np.count, x=mates_np.left_x, y=mates_np.left_y,
            theta=mates_np.left_theta))
    names = sorted(os.listdir(a_dir))
    assert names and names == sorted(os.listdir(b_dir))
    n_rows = 0
    for name in names:
        ta, tb = (open(d / name).read() for d in (a_dir, b_dir))
        n_rows += len(ta.splitlines()) - 1       # rows under the header
        if not numeric:
            assert ta == tb, name
            continue
        la, lb = ta.splitlines(), tb.splitlines()
        assert la[0] == lb[0] and len(la) == len(lb)
        np.testing.assert_allclose(
            np.array([ln.split() for ln in la[1:]], np.float64),
            np.array([ln.split() for ln in lb[1:]], np.float64),
            rtol=1e-5, atol=1e-5)
    assert n_rows > 0


def test_long_seq_validation_script(tmp_path, capsys):
    """scripts/long_seq_validation_torch.py at 120x160 over 5 frames: the
    reference script's judged record (plus the card), written under
    --out."""
    from scripts.long_seq_validation_torch import main
    res = main(["--n_frames", "5", "--h", "120", "--w", "160", "--device",
                "cpu", "--max_edges", "1024", "--out", str(tmp_path)])
    rec = json.load(open(tmp_path / "longseq_result.json"))
    assert rec == json.loads(json.dumps(res))
    assert set(rec) == {
        "n_frames", "resolution", "backend", "card", "ba_window",
        "keyframe_policy", "drift_frac", "gt_path_len_m", "ate_rmse_m",
        "ate_bound_m", "rpe_trans_m", "rpe_rot_deg", "frames_per_s", "ba",
        "collapsed_frames", "frames_without_pose", "pass"}
    assert rec["backend"] == "cpu" and rec["card"] == "cpu"
    assert rec["pass"] and rec["collapsed_frames"] == []
    assert rec["frames_without_pose"] == []
    assert 0 < rec["ate_rmse_m"] < rec["ate_bound_m"]
    assert _traj(str(tmp_path / "out")).shape == (5, 8)
    assert "processed 5 frames" in capsys.readouterr().out
