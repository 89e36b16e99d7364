"""The check catches a broken timed path: a CPU run at a small size (the
plain twins, the harness's look for a card skipped) with the program
broken underneath (`vo_bench/harness/faults.py`), once for each fault a
`frame` cell can have, comes out not correct; the unbroken run comes out
correct.

A `frame` cell has no exchange between cards. Of the contract's faults
it can have: a step that returns its state unchanged (the temporal
step's identity pose; windowed BA's poses as it was given them), half of
the batch left out (every other mate, every other keyframe row's
candidates), and an answer altered where it is produced (every mate or
quad, 2 in 5 of them, the pose).

At a fifth of the size the program reads other numbers than at the
cell's own, so the small cell has limits of its own (`SMALL_CHECK`,
`SMALL_BA_PX`), set from its unbroken runs: the faults read far past
them.
"""

import copy
import time

import pytest

from vo_bench.harness import faults as FAULTS
from vo_bench.harness import frame_run as FRUN
from vo_bench.harness import spec as SPEC

SCALE = 0.2
# the small cell's limits. At a fifth of the size the stereo step leaves
# more than a tenth of a frame's mates wrong on some frames of the lap (3
# to 11, 26 to 38: 1.3-6.2 px at the 90th percentile), so the small runs
# start at frame 44 (SEED) and end before frame 3; frames 44, 46-2 read
# 0.21-0.69 / 0.29-0.38 / 0.13-0.23 px and 569 / 392 / 376 at the fewest
SMALL_CHECK = {"stereo_px": 0.8, "temporal_px": 0.6, "pose_px": 0.6,
               "mates_min": 450, "quads_min": 300, "inliers_min": 280}
SEED = 2 ** 31 + 9            # the lap's frame 41, 3 warm-up frames
# the adaptive run's BA solve reads 4.8 px: the consecutive keyframes are
# 9 frames apart at a fifth of the size, and the VO pose between them 26
SMALL_BA_PX = 10.0
BA_SEED = 2 ** 31 + 11


def tiny_cell(name):
    """The cell at a fifth of its width and height (focal lengths with
    them) with small capacities; scene, trajectory and limits its own."""
    cell = copy.deepcopy(SPEC.load_cell(name))
    for cam in ("left_camera", "right_camera"):
        c = cell.config["rig"][cam]
        c["resolution"] = [int(v * SCALE) for v in c["resolution"]]
        c["intrinsics"] = [v * SCALE for v in c["intrinsics"]]
    cell.config["vo_config"] = dict(
        max_edges=2048, max_candidates=8, gather_slots=32, max_mates=1024,
        max_refine_pairs=4096, max_quad_candidates=8, quad_gather_slots=80,
        ransac_max_iterations=256, max_disparity=25 * SCALE * 2)
    cell.workload["warmup"] = {"min_frames": 3, "max_frames": 3}
    cell.workload["check"] = dict(SMALL_CHECK)
    return cell


def tiny_run(monkeypatch, fault=None):
    if fault is not None:
        FAULTS.FAULTS[fault](monkeypatch.setattr)
    return FRUN.run(tiny_cell("kitti.every_frame"), SEED, 6.0, False,
                    time.perf_counter(), device="cpu")


def tiny_ba_run(monkeypatch, fault=None):
    """The adaptive cell at a fifth of the size, through its first solve
    in set-up and its next one in the window."""
    if fault is not None:
        FAULTS.FAULTS[fault](monkeypatch.setattr)
    cell = tiny_cell("kitti.adaptive_ba5")
    cell.workload["warmup"] = {"min_frames": 3, "max_frames": 12}
    cell.workload["check"]["ba_px"] = SMALL_BA_PX
    return FRUN.run(cell, BA_SEED, 24.0, False, time.perf_counter(),
                    device="cpu")


def test_unbroken_run_is_correct(monkeypatch):
    res = tiny_run(monkeypatch)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault,number", [
    ("shift_mates", "stereo_px"), ("shift_quads", "temporal_px"),
    ("corrupt_mates", "stereo_px"), ("corrupt_quads", "temporal_px"),
    ("drop_half_mates", "mates_min"), ("drop_half_quads", "quads_min"),
    ("alter_pose", "pose_px"), ("pose_unchanged", "pose_px")])
def test_broken_timed_path_is_not_correct(monkeypatch, fault, number):
    res = tiny_run(monkeypatch, fault)
    assert not res["correct"]
    c = res["checks"][number]
    failed = (c["value"] < c["limit"] if number.endswith("_min")
              else c["value"] > c["limit"])
    assert failed, res["checks"]


def test_ba_left_unchanged_is_not_correct(monkeypatch):
    sound = tiny_ba_run(monkeypatch)["checks"]["ba_px"]
    assert sound["value"] <= sound["limit"], sound
    monkeypatch.undo()
    res = tiny_ba_run(monkeypatch, "ba_unchanged")
    assert not res["correct"]
    c = res["checks"]["ba_px"]
    assert c["value"] > c["limit"], res["checks"]
