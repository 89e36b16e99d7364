"""The port's analysis suite (edge_based_visual_odometry_tpu_torch/viz/)
against the reference's viz/, mirroring tests/test_viz.py:

  - the loaders on dump files the PORT wrote (a 2-frame run of the port's
    CLI with GT disparity, plus its edge and disparity writers) return the
    same arrays as the reference's loaders;
  - the loaders on hand-written dumps, the triage counts, every plot, the
    `all` sweep (the same figures as the reference's sweep);
  - dump_ncc_debug: the reference's layout, and scores equal to the
    reference's within 1e-5 on the same images.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from edge_based_visual_odometry_tpu.viz import plots as JP
from edge_based_visual_odometry_tpu_torch.viz import plots as P

pytestmark = pytest.mark.heavy
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def dumps(tmp_path):
    d = tmp_path / "out"
    d.mkdir()
    (d / "toed_edges_frame_0.txt").write_text(
        "10.5 20.25 0.1\n30.0 40.0 -1.2\n")
    (d / "finalized_stereo_edge_pairs_frame_0.txt").write_text(
        "left_edge_location, left_edge_orientation, right_edge_location, "
        "right_edge_orientation, left_edge_3D_point, left_edge_tangent\n"
        + "".join(f"{10+i} {20+i} 0.3 {5+i} {20+i} 0.31 "
                  "1 2 3 0.1 0.2 0.97 0.5 0.86 0.5 0.86\n"
                  for i in range(6)))
    (d / "disparities_frame_0.txt").write_text(
        "# Disparity values for frame 0\n"
        "# Columns: left_x\tleft_y\tright_x\tright_y\test\tgt\terr\n"
        "10\t20\t5\t20\t5.0\t5.2\t-0.2\n"       # TP (|err|<=1)
        "11\t21\t5\t21\t6.0\t4.5\t1.5\n"        # inaccurate (1<|err|<=2)
        "12\t22\t5\t22\t7.0\t2.0\t5.0\n"        # false
        "13\t23\t5\t23\t8.0\tnan\tnan\n")       # no GT
    (d / "quads_frame_1.txt").write_text(
        "# keyframe 0 <-> current frame 1\n"
        "kf_left_x,kf_left_y,kf_right_x,kf_right_y,"
        "cf_left_x,cf_left_y,cf_right_x,cf_right_y\n"
        "10,20,5,20,11,21,6,21\n"
        "30,40,25,40,31,41,26,41\n")
    (d / "ncc_frame_0.txt").write_text(
        "# ncc distribution for frame 0\n"
        "# Total values: 3 (Veridical: 1, Non-veridical: 2)\n"
        "filter_value\tis_GT\n"
        "0.9\t1\n0.3\t0\n0.5\t0\n")
    (d / "ambiguity_orientation_frame_0.txt").write_text(
        "# Ambiguity distribution for stage: orientation | Frame: 0\n"
        "# Total edges: 4\n"
        "num_candidates\n"
        "3\n1\n0\n7\n")
    (d / "trajectory_tum.txt").write_text(
        "".join(f"{i} {float(i)} 0 {0.1*i} 0 0 0 1\n" for i in range(5)))
    return d


@pytest.fixture(scope="module")
def port_dumps(tmp_path_factory):
    """A 2-frame ETH3D-type run of the port's CLI with every dump on, and
    its TOED-edge and disparity writers on frame 0."""
    from edge_based_visual_odometry_tpu_torch import cli as CLI
    from edge_based_visual_odometry_tpu_torch.io import synthetic as S
    from edge_based_visual_odometry_tpu_torch.io.datasets import StereoSample
    from edge_based_visual_odometry_tpu_torch.ops import toed
    from edge_based_visual_odometry_tpu_torch.utils import debug_io as DIO

    out = tmp_path_factory.mktemp("port_dumps")
    seq = S.make_sequence(2, 120, 160)
    cam = {"resolution": [160, 120], "intrinsics": [
        seq.rig.left.fx, seq.rig.left.fy, seq.rig.left.cx, seq.rig.left.cy],
        "distortion_coefficients": [0, 0, 0, 0]}
    cfg = {"dataset_type": "ETH3D_stereo", "output_dir": str(out),
           "left_camera": cam, "right_camera": cam,
           "stereo": {"R21": [list(r) for r in seq.rig.R21],
                      "T21": list(seq.rig.T21)}}
    samples = [StereoSample(left=np.round(f.left).astype(np.uint8),
                            right=np.round(f.right).astype(np.uint8),
                            timestamp=float(k), gt_R=f.R.T, gt_t=-f.R.T @ f.t,
                            file_idx=k, left_disparity=f.disparity)
               for k, f in enumerate(seq.frames)]

    def on_frame(k, fr, tr):
        if k == 0:
            DIO.write_disparities(str(out / "disparities_frame_0.txt"),
                                  fr.mates, 0)
            DIO.write_toed_edges(str(out / "toed_edges_frame_0.txt"),
                                 toed.detect_edges(fr.frame.left,
                                                   max_edges=1024))
    CLI.run(cfg, CLI.default_args(device="cpu", max_edges=1024,
                                  dump_stereo_pairs=True, dump_quads=True,
                                  record_filter_distributions=True),
            samples, on_frame=on_frame)
    return out


LOADERS = [("toed_edges_*", "load_toed_edges"),
           ("finalized_stereo_edge_pairs_frame_*", "load_finalized_pairs"),
           ("disparities_frame_*", "load_disparities"),
           ("quads_frame_*", "load_quads"),
           ("ncc_frame_*", "load_filter_distribution"),
           ("sift_distance_frame_*", "load_filter_distribution"),
           ("ambiguity_*_frame_*", "load_ambiguity_distribution"),
           ("trajectory_tum*", "load_trajectory_tum")]


def test_loaders_on_port_dumps_equal_reference(port_dumps):
    import glob
    n = 0
    for pattern, loader in LOADERS:
        files = sorted(glob.glob(str(port_dumps / (pattern + ".txt"))))
        assert files, pattern
        for f in files:
            a, b = getattr(P, loader)(f), getattr(JP, loader)(f)
            if isinstance(b, dict):
                assert a.keys() == b.keys()
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k])
                    n += np.size(b[k])
            else:
                np.testing.assert_array_equal(a, b)
                n += np.size(b)
    assert n > 1000


def test_loaders_roundtrip(dumps):
    e = P.load_toed_edges(str(dumps / "toed_edges_frame_0.txt"))
    assert e["x"].tolist() == [10.5, 30.0] and e["theta"][1] == -1.2
    pairs = P.load_finalized_pairs(
        str(dumps / "finalized_stereo_edge_pairs_frame_0.txt"))
    assert pairs["left_x"].shape == (6,)
    assert pairs["point3d"].shape == (6, 3)
    np.testing.assert_allclose(pairs["right_x"], pairs["left_x"] - 5)
    disp = P.load_disparities(str(dumps / "disparities_frame_0.txt"))
    assert disp["est_disp"].tolist() == [5.0, 6.0, 7.0, 8.0]
    assert np.isnan(disp["disp_err"][3])
    q = P.load_quads(str(dumps / "quads_frame_1.txt"))
    assert q["cf_left_x"].tolist() == [11.0, 31.0]
    dist = P.load_filter_distribution(str(dumps / "ncc_frame_0.txt"))
    assert dist["values"].tolist() == [0.9, 0.3, 0.5]
    assert dist["is_gt"].tolist() == [True, False, False]
    amb = P.load_ambiguity_distribution(
        str(dumps / "ambiguity_orientation_frame_0.txt"))
    assert amb.tolist() == [3, 1, 0, 7]
    tr = P.load_trajectory_tum(str(dumps / "trajectory_tum.txt"))
    assert tr["pos"].shape == (5, 3) and tr["quat"][0, 3] == 1.0


def test_triage_counts(dumps, tmp_path):
    out = str(tmp_path / "triage.png")
    counts = P.plot_match_triage(out, P.load_disparities(
        str(dumps / "disparities_frame_0.txt")))
    assert counts == {"tp": 1, "inaccurate": 1, "false": 1, "no_gt": 1}
    assert os.path.getsize(out) > 0


def test_plots_render(dumps, tmp_path):
    img = np.zeros((50, 60), np.float32)
    P.plot_edges_on_image(str(tmp_path / "e.png"),
                          P.load_toed_edges(str(dumps / "toed_edges_frame_0.txt")),
                          image=img)
    P.plot_stereo_pairs(
        str(tmp_path / "p.png"),
        P.load_finalized_pairs(
            str(dumps / "finalized_stereo_edge_pairs_frame_0.txt")),
        left_image=img, right_image=img, n_links=3)
    P.plot_quads(str(tmp_path / "q.png"),
                 P.load_quads(str(dumps / "quads_frame_1.txt")))
    P.plot_filter_distribution(
        str(tmp_path / "d.png"),
        P.load_filter_distribution(str(dumps / "ncc_frame_0.txt")), "ncc")
    P.plot_ambiguity_distribution(
        str(tmp_path / "a.png"),
        P.load_ambiguity_distribution(
            str(dumps / "ambiguity_orientation_frame_0.txt")), "orientation")
    est = P.load_trajectory_tum(str(dumps / "trajectory_tum.txt"))
    P.plot_trajectory(str(tmp_path / "t.png"), est, gt=est, plane="xz")
    for name in ["e", "p", "q", "d", "a", "t"]:
        assert os.path.getsize(str(tmp_path / f"{name}.png")) > 0


@pytest.mark.parametrize("which", ["hand", "port"])
def test_cli_all_sweep(dumps, port_dumps, tmp_path, which):
    """`python -m edge_based_visual_odometry_tpu_torch.viz all` renders the
    figures the reference's sweep renders from the same directory."""
    src = str(dumps if which == "hand" else port_dumps)
    runs = {}
    for pkg in ("edge_based_visual_odometry_tpu_torch",
                "edge_based_visual_odometry_tpu"):
        viz_dir = str(tmp_path / f"viz_{pkg}")
        r = subprocess.run(
            [sys.executable, "-m", f"{pkg}.viz", "all", src, viz_dir],
            capture_output=True, text=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu"}, cwd=REPO)
        assert r.returncode == 0, r.stderr
        runs[pkg] = sorted(os.listdir(viz_dir))
    pngs = runs["edge_based_visual_odometry_tpu_torch"]
    assert pngs == runs["edge_based_visual_odometry_tpu"]
    if which == "hand":
        # one figure per recognized dump: edges, pairs, disparities, quads,
        # ambiguity, ncc distribution, trajectory
        assert len(pngs) == 7, pngs
    else:
        assert len(pngs) > 10 and "quads_frame_1.png" in pngs


def test_ncc_debug_dump(tmp_path):
    """dump_ncc_debug reproduces the reference's ncc_debug_* dir layout,
    ranks the true candidate best, and scores as the reference does."""
    rng = np.random.default_rng(3)
    left = rng.uniform(0, 255, (64, 80)).astype(np.float32)
    # right = left shifted 4 px in x, so the candidate at (x-4, y) with the
    # same orientation is photometrically identical
    right = np.roll(left, -4, axis=1)
    edge = (40.0, 32.0, 0.4)
    cands = {"x": np.array([36.0, 20.0, 50.0]),
             "y": np.array([32.0, 40.0, 10.0]),
             "theta": np.array([0.4, 1.2, -0.5])}
    d = str(tmp_path / "nccdbg")
    res = P.dump_ncc_debug(d, left, right, edge, cands, gt_xy=(36.0, 32.0))
    assert res["best"] == 0 and res["scores"][0] > 0.95
    ref = JP.dump_ncc_debug(str(tmp_path / "ref"), left, right, edge, cands,
                            gt_xy=(36.0, 32.0))
    np.testing.assert_allclose(res["scores"], np.asarray(ref["scores"]),
                               rtol=0, atol=1e-5)
    files = set(os.listdir(d))
    assert files == set(os.listdir(str(tmp_path / "ref")))
    assert {"candidate_scores.csv", "patch_statistics.txt",
            "all_patches_grid.png", "edge_patch_plus.png",
            "cand1_patch_plus.png", "cand3_patch_minus.png"} <= files
    rows = open(os.path.join(d, "candidate_scores.csv")).readlines()
    assert rows[0].startswith("Candidate,Position")
    assert len(rows) == 4 and ",Yes" in rows[1]
    assert rows == open(str(tmp_path / "ref" / "candidate_scores.csv")
                        ).readlines()
