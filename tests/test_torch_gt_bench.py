"""The benchmark's `gt_frame` entry (vo_bench/harness/gt_frame_run.py)
on the CPU, on a small crop of the ETH3D rig.

- a run gives a well-formed result that reads correct, untraced (the
  end-to-end metrics) and traced (the per-layer metrics, from the
  window's step spans and one profiled slice with the program's spans);
- the check (vo_bench/harness/gt_check.py) fails on each of the
  evaluation path's faults (vo_bench/harness/eval_faults.py): the GT pose
  handed inverted, the disparity one column off, the maps kept from the
  capture call. The fourth reading the limits are set from, the bfloat16
  control, reads small at this size (its pixels lie under 128, where a
  bfloat16 step is 0.5 px): it is read on the card;
- the map maker's disparity (vo_bench/scene/gt_maps.py) is the exact
  x-offset of `exact.stereo_truth` at each pixel centre, inf where no
  plane is hit, and its non-occlusion map is 255 exactly where the exact
  right pixel lies inside the right image;
- the port's supervised Final rows agree with the plain reference's
  (vo_bench/reference/eval_rows.py) within the small cell's limits.

The small cell: ETH3D's rig cropped to a 128 x 96 window about the image
centre (the focal length and baseline as published, so the disparities
are the cell's), small capacities and 4 GN iterations. Its limits
(`SMALL_CHECK`) come from its unbroken runs: from the lap's frame 7 (the
seed) it reads 0.25 / 0.20 / 0.30 px, gt_px 0.0, 403 / 335 / 273 at the
fewest, the stereo rows' errors 0.0005 and the temporal ones 0.010 /
0.003 (edges where two planes meet, whose GT disparity the map's
bilinear sample blends).
"""

import copy
import math
import time

import numpy as np
import pytest
import torch

from vo_bench.harness import eval_faults as EF
from vo_bench.harness import gt_check as GC
from vo_bench.harness import gt_frame_run as GFR
from vo_bench.harness import spec as SPEC
from vo_bench.reference import exact as REF
from vo_bench.scene import gt_maps as GM
from vo_bench.scene import render as RS

pytestmark = pytest.mark.heavy

CELL = "eth3d_delivery_area.gt_eval"
W, H = 128, 96
SEED = 2 ** 31 + 71           # the lap's frame 7
SMALL_VO = dict(max_edges=1024, max_candidates=8, gather_slots=64,
                max_mates=512, max_refine_pairs=2048, max_quad_candidates=8,
                quad_gather_slots=144, ransac_max_iterations=256,
                gn_max_iter=4)
SMALL_CHECK = {"stereo_px": 0.6, "temporal_px": 0.6, "pose_px": 0.8,
               "gt_px": 0.1, "stereo_recall_err": 0.1,
               "stereo_precision_err": 0.1, "temporal_recall_err": 0.05,
               "temporal_precision_err": 0.05, "eval_rows_missing": 0,
               "mates_min": 300, "quads_min": 150, "inliers_min": 100}
# windows long enough for a few frames on a CPU shared with other workers
SECONDS = {0: 8.0, 1: 6.0}
FAULTS = [("gt_pose_inverted", "quads_min"),
          ("disparity_one_column_off", "gt_px"), ("stale_maps", "gt_px")]


def small_cell():
    cell = copy.deepcopy(SPEC.load_cell(CELL))
    for cam in ("left_camera", "right_camera"):
        c = cell.config["rig"][cam]
        fx, fy, cx, cy = c["intrinsics"]
        w, h = c["resolution"]
        c["resolution"] = [W, H]
        c["intrinsics"] = [fx, fy, cx - (w - W) // 2, cy - (h - H) // 2]
    cell.config["vo_config"] = dict(SMALL_VO)
    cell.workload.update(warmup={"min_frames": 4}, trace_frames=2,
                         check=dict(SMALL_CHECK))
    return cell


@pytest.mark.parametrize("trace", [0, 1])
def test_entry_on_a_small_crop_reads_correct(trace):
    res = GFR.run(small_cell(), SEED, SECONDS[trace], bool(trace),
                  time.perf_counter(), device="cpu")
    assert res["correct"], res["checks"]
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["checks"]) == {"failed", "kernels_not_launched",
                                  *SMALL_CHECK}
    metrics = {k: v["value"] for k, v in res["metrics"].items()}
    if trace:
        assert set(metrics) == {"gt_stereo_step_ms", "gt_temporal_step_ms",
                                "gt_upload_ms"}
        assert all(v > 0 for v in metrics.values())
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert "breakdown" in res
    else:
        assert set(metrics) == {"frames_per_s", "frame_ms_p95", "setup_s"}
        assert metrics["frames_per_s"] == res["attempted"] / SECONDS[0]
        assert metrics["setup_s"] > 0 and metrics["frame_ms_p95"] > 0


@pytest.mark.parametrize("fault,number", FAULTS)
def test_check_fails_on_each_fault(monkeypatch, fault, number):
    EF.FAULTS[fault](monkeypatch.setattr)
    res = GFR.run(small_cell(), SEED, 3.0, False, time.perf_counter(),
                  device="cpu")
    assert not res["correct"]
    c = res["checks"][number]
    failed = (c["value"] < c["limit"] if number.endswith("_min")
              else c["value"] > c["limit"])
    assert failed, res["checks"]


def _scene(planes):
    cell = small_cell()
    rig = RS.Rig.from_config(cell.config["rig"])
    return rig, RS.planes_of(planes), cell.scene["trajectory"]


@pytest.mark.parametrize("k", [0, 29, 61])
def test_map_maker_disparity_is_the_exact_x_offset(k):
    cell = small_cell()
    rig, planes, traj = _scene(cell.scene["planes"])
    R, t = RS.trajectory_pose(traj, k)
    rays = RS.pixel_rays(rig.height, rig.width, rig.K_left, rig.dist_left,
                         "cpu")
    disp, vis = GM.frame_maps(rig, planes, R, t, rays)
    v, u = torch.meshgrid(torch.arange(rig.height, dtype=torch.float64),
                          torch.arange(rig.width, dtype=torch.float64),
                          indexing="ij")
    scene = RS.Scene(None, None, R[None], t[None], planes, rig)
    truth = REF.stereo_truth(scene, 0, u.reshape(-1), v.reshape(-1),
                             torch.float64).reshape(rig.height, rig.width, 2)
    assert torch.isfinite(disp).all()
    np.testing.assert_allclose(disp.double().numpy(),
                               (u - truth[..., 0]).numpy(), atol=1e-5)
    inside = ((truth[..., 0] >= 0) & (truth[..., 0] <= rig.width - 1)
              & (truth[..., 1] >= 0) & (truth[..., 1] <= rig.height - 1))
    np.testing.assert_array_equal(vis.numpy(), 255 * inside.numpy())
    assert 0 < int((vis == 0).sum()) < vis.numel() // 4   # the exit strip


def test_map_maker_marks_no_hit_inf_and_not_visible():
    """Above the horizon of a lone ground plane no ray meets a plane: the
    disparity is inf there and the pixel is not visible."""
    cell = small_cell()
    ground = [p for p in cell.scene["planes"] if p["n"][1] == 1.0]
    rig, planes, _ = _scene(ground)
    rays = RS.pixel_rays(rig.height, rig.width, rig.K_left, rig.dist_left,
                         "cpu")
    disp, vis = GM.frame_maps(rig, planes, np.eye(3), np.zeros(3), rays)
    sky = ~torch.isfinite(disp)
    assert sky[0].all() and not sky[-1].any()
    assert (vis[sky] == 0).all() and (disp[~sky] > 0).all()


def test_supervised_final_rows_agree_with_the_reference():
    fc = GFR.GtFrameCell(small_cell(), SEED, torch.device("cpu"))
    fc.warm_up()
    for slot in range(3):
        fc.frame(slot)
    logs = (fc.pipe.stereo_metrics_log, fc.pipe.temporal_metrics_log)
    assert len(logs[0]) == 7 and len(logs[1]) == 6
    # the right edges the timed step's cascade read, not detected anew
    assert all(r["right_edges"] is not None and r["images"] is None
               for r in fc.records)
    GC.add_right_edges(fc.records, fc.pipe.cfg)
    rows = GC.per_frame(fc.scene, fc.records, logs, GC.rules(fc.pipe.cfg))
    assert len(rows) == 3
    for r in rows:
        assert r["stereo_rows"] > 300 and r["temporal_rows"] > 150, r
        assert 0.9 < r["stereo_recall"] <= 1.0 and r["temporal_recall"] > 0.3
        for name in GC.ROW_ERRS:
            assert r[name] <= SMALL_CHECK[name], (name, r)
        assert r["gt_px"] <= SMALL_CHECK["gt_px"], r
