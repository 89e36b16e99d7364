"""The benchmark's `pair_step` entry (vo_bench/harness/pair_step_run.py)
on the CPU: 4 gloo ranks spawned by its own supervisor.

- a run at 64 x 96 with `DRYRUN_CFG` gives a well-formed result that
  reads correct, untraced (the end-to-end metrics) and traced (the
  per-layer metrics, rank 0's trace);
- the check (vo_bench/harness/pair_check.py) fails on each of the
  program's faults (vo_bench/harness/pair_faults.py): the exchange left
  out, half the batch, a rank dealt the pairs one lap position on. The
  fourth reading the limits are set from, the bfloat16 control, reads
  below the program at this size (0.13-0.21 px): it is read on the
  card;
- the supervisor stops the whole group, and names the rank, when a rank
  raises or outlives the deadline;
- a program without `mesh.EXCHANGES` (as before the counter) is refused
  at once.

The small cell: KITTI's rig at 0.6 of its focal length, a 96 x 64
window about the image centre; `DRYRUN_CFG` with 256 RANSAC hypotheses
(its 64 lose 3 of the lap's 24 pairs at this size, 17-85 px); and the
lap's yaw wave at 4 turns a lap, so that consecutive pairs' motions
differ by more than the program's error here (a shifted rank's rows
read 0.2-5.5 px, median 4.2; the program's 0.06-0.76).
"""

import copy
import re
import time

import pytest

from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM
from tests import torch_ranks as TR
from vo_bench.harness import check as CHECK
from vo_bench.harness import pair_step_run as PSR
from vo_bench.harness import spec as SPEC

pytestmark = pytest.mark.heavy

H, W = 64, 96
FOCAL = 0.6
# the small cell's limits: over 6 seeds its unbroken runs read 0.34-0.56
# px at the worst rank and 135-149 mates, the three faults 4.9-14.2 px
SMALL_CHECK = {"pair_px": 1.3, "mates_min": 100, "exchange_mismatch": 0,
               "exchanges": 0}
SEED = 2 ** 31 + 9            # the lap's position 41
FAULTS = [("exchange_left_out", "exchange_mismatch"),
          ("half_batch", "pair_px"), ("shifted_rank", "pair_px")]


def tiny_cell():
    cell = copy.deepcopy(SPEC.load_cell("kitti.pairs4"))
    for cam in ("left_camera", "right_camera"):
        c = cell.config["rig"][cam]
        fx, fy, _, _ = c["intrinsics"]
        c["resolution"] = [W, H]
        c["intrinsics"] = [fx * FOCAL, fy * FOCAL, (W - 1) / 2, (H - 1) / 2]
    cell.config["vo_config"] = dict(PM.DRYRUN_CFG, ransac_max_iterations=256)
    cell.scene["trajectory"]["waves"]["yaw"] = [[3.0, 4, 1.0]]
    # a CPU shared with other tests' workers may slow between the warm-up
    # and the window: twice the steps the warm-up rate asks for
    cell.workload.update(warmup={"steps": 1, "timed_steps": 1},
                         window_margin=2.0, trace_steps=2,
                         check=dict(SMALL_CHECK))
    return cell


@pytest.mark.parametrize("trace", [0, 1])
def test_entry_on_four_gloo_ranks_reads_correct(trace):
    cell = tiny_cell()
    res = PSR.run(cell, SEED, 3.0 if trace else 5.0, bool(trace),
                  time.perf_counter(), device="cpu")
    assert res["correct"], res["checks"]
    assert set(res) >= {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert res["device"]["count"] == 4 and res["failed"] == 0
    assert set(res["checks"]) == {"failed", "kernels_not_launched",
                                  *SMALL_CHECK}
    metrics = {k: v["value"] for k, v in res["metrics"].items()}
    if trace:
        assert set(metrics) == {"collective_ms", "pair_step_ms"}
        assert all(v > 0 for v in metrics.values())
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert "breakdown" in res
    else:
        assert set(metrics) == {"frames_per_s", "frame_ms_p95", "setup_s"}
        assert res["attempted"] > 0 and res["attempted"] % 8 == 0
        assert metrics["frames_per_s"] == res["attempted"] / 5.0
        assert 0 < metrics["setup_s"] < 300 and metrics["frame_ms_p95"] > 0


@pytest.fixture(scope="module")
def episodes():
    eps = [dict(seed=SEED, steps=2)] + [dict(seed=SEED, steps=2, fault=f)
                                        for f, _ in FAULTS]
    return {ep.get("fault"): ep for ep in PSR.episodes(
        tiny_cell(), eps, device="cpu", deadline_s=400)}


def test_unbroken_episode_reads_correct(episodes):
    correct, checks = CHECK.judge(episodes[None]["program"], SMALL_CHECK, 0)
    assert correct, checks


@pytest.mark.parametrize("fault,number", FAULTS)
def test_check_fails_on_each_fault(episodes, fault, number):
    correct, checks = CHECK.judge(episodes[fault]["program"], SMALL_CHECK,
                                  0)
    assert not correct
    assert checks[number]["value"] > checks[number]["limit"], checks


@pytest.mark.parametrize("how", ["raises", "sleeps"])
def test_supervisor_stops_the_group_and_names_the_rank(how):
    deadline = 40.0 if how == "raises" else 15.0
    t0 = time.monotonic()
    with pytest.raises(PSR.RankFailed) as err:
        PSR.supervise(TR.failing_rank_worker, 4, (how, 2), deadline)
    took = time.monotonic() - t0
    msg = str(err.value)
    if how == "raises":
        assert "rank 2 of 4 exited" in msg and "fails on purpose" in msg
        assert took < deadline - 10
    else:
        late = re.search(r"rank\(s\) \[([0-9, ]+)\] of 4 still", msg)
        assert late and 2 in [int(r) for r in late.group(1).split(",")]
        assert took < deadline + 15


def test_entry_refuses_a_program_without_the_exchange_counter(monkeypatch):
    monkeypatch.delattr(PM, "EXCHANGES")
    t0 = time.monotonic()
    with pytest.raises(SystemExit, match="EXCHANGES"):
        PSR.run(tiny_cell(), SEED, 1.0, False, time.perf_counter(),
                device="cpu")
    assert time.monotonic() - t0 < 5
