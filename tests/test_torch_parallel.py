"""The port's multi-device layer (parallel/mesh.py, WindowBA(mesh=...),
scripts/run_multihost_torch.py) on the CPU: gloo groups of spawned ranks
(tests/torch_ranks.py), each group joined with a timeout of its own.

  - the pair step against the reference's `build_pair_step` on the same
    frames (make_sequence(2, 64, 96), the small config of
    tests/test_parallel.py): mates within 0.97, pose error against the
    synthetic GT within the reference's + 0.1 deg / + 10 mm;
  - the sharded pair step on 2 and 4 ranks against the single-process
    loop, bit for bit, identical seeds giving identical rows, the mean
    equal on every rank; its exchange counter (1 all-reduce and 5
    all-gathers a call) and its spans (nested as PERF.md's table has
    them, outputs bit-identical with spans on and off);
  - the sharded windowed BA at 2 and 4 ranks against one device on the
    8-keyframe corridor chain (tests/test_window_ba_drift.py), 1e-4;
  - dryrun_multichip(2), and the multi-host harness in one process and on
    2 ranks (tests/test_multihost_rehearsal.py).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from edge_based_visual_odometry_tpu.config import VOConfig as JVOConfig
from edge_based_visual_odometry_tpu.io import synthetic as JS
from edge_based_visual_odometry_tpu.parallel import mesh as JPM
from edge_based_visual_odometry_tpu_torch.config import VOConfig
from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM
from tests import torch_ranks as TR

pytestmark = pytest.mark.heavy
torch.set_num_threads(2)


def _rot_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T)
         - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def test_pair_step_matches_jax():
    """At this size the port's lifted quads have JAX's valid mask but are
    not JAX's row for row (the GN refinements differ in the last bits),
    so JAX's RANSAC draws would index other quads: the poses are held to
    the synthetic GT instead, each within JAX's own error + 0.1 deg and
    + 10 mm."""
    seq = JS.make_sequence(2, 64, 96)
    f0, f1 = seq.frames
    R_gt = f1.R @ f0.R.T
    t_gt = f1.t - R_gt @ f0.t
    jstep = jax.jit(JPM.build_pair_step(seq.rig, JVOConfig(**PM.DRYRUN_CFG)))
    step = PM.build_pair_step(seq.rig, VOConfig(**PM.DRYRUN_CFG), "cpu")
    for seed in (0, 5):
        ref = [np.asarray(a) for a in jstep(
            f0.left, f0.right, f1.left, f1.right,
            jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
            jnp.int32(seed))]
        out = [a.numpy() for a in step(f0.left, f0.right, f1.left, f1.right,
                                       np.eye(3), np.zeros(3), seed)]
        for a, b in zip(out[3:], ref[3:]):
            assert int(a) > 100
            assert min(int(a), int(b)) / max(int(a), int(b)) >= 0.97
        assert out[2] > 0.5 and abs(float(out[2]) - float(ref[2])) < 0.05
        assert _rot_deg(out[0], R_gt) <= _rot_deg(ref[0], R_gt) + 0.1
        assert (np.linalg.norm(out[1] - t_gt)
                <= np.linalg.norm(ref[1] - t_gt) + 0.01)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_sharded_pair_step_matches_single(tmp_path, n_ranks):
    """Two pairs a rank: every rank's gathered rows are the single-process
    loop's over the global batch, in rank-major order, bit for bit."""
    n_global = 2 * n_ranks
    res = TR.spawn(TR.pair_step_worker, n_ranks, tmp_path, n_global)
    r0 = res[0]
    for name in ("same", "distinct"):
        single = r0[name + "_single"]
        for r in res:
            out = r[name]
            assert out["R"].shape == (n_global, 3, 3)
            for k, ref in zip(("R", "t", "inlier_ratio", "n_mates_kf",
                               "n_mates_cf"), single):
                np.testing.assert_array_equal(out[k], ref, err_msg=k)
            np.testing.assert_allclose(out["mean_inlier_ratio"],
                                       single[2].mean(), atol=1e-6)
            assert out["mean_inlier_ratio"] == r0[name]["mean_inlier_ratio"]
    # identical inputs + identical seeds -> identical rows
    same = r0["same"]["R"]
    for k in range(1, n_global):
        np.testing.assert_array_equal(same[k], same[0])


@pytest.fixture(scope="module")
def pair_spans(tmp_path_factory):
    return TR.spawn(TR.pair_spans_worker, 2,
                    tmp_path_factory.mktemp("pair_spans"))


def test_exchanges_count_one_all_reduce_and_five_all_gathers(pair_spans):
    """Two calls of one pair a rank: 2 all-reduces of (sum, count) and 10
    all-gathers (R, t, ratio, two mate counts), 68 bytes a call."""
    per_call = 2 * 4 + (9 + 3 + 1) * 4 + 2 * 4
    for r in pair_spans:
        assert r["counts"] == {"all_reduce": 2, "all_gather": 10,
                               "bytes": 2 * per_call}


def test_pair_step_spans_nest_and_leave_outputs_bit_identical(pair_spans):
    """With spans on, a call records `vo/pair_step` once at the top,
    `vo/pair.work` (its stereo and temporal steps inside) and
    `vo/pair.exchange` (`vo/wait.pair_count` inside) within it, as
    PERF.md's span table has them; its outputs are the spans-off
    call's, bit for bit."""
    from tests.test_torch_trace import _parents, documented

    doc = documented()
    for r in pair_spans:
        for k, v in r["off"][1].items():
            np.testing.assert_array_equal(r["on"][k], v, err_msg=k)
        spans = r["spans"]
        parents = [None if p is None else spans[p][0]
                   for p in _parents(spans)]
        named = [(s[0], p) for s, p in zip(spans, parents)]
        for name in ("pair_step", "pair.work", "pair.exchange",
                     "wait.pair_count"):
            assert [p for n, p in named if n == name] == [doc[name]], name
        assert doc["pair_step"] is None
        inside_work = [n for n, p in named if p == "pair.work"]
        assert sorted(inside_work) == ["stereo_step", "stereo_step",
                                       "temporal_step"]


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_window_ba_sharded_matches_single(tmp_path, n_ranks):
    """In-loop sharded BA == single-device, on every rank."""
    res = TR.spawn(TR.window_ba_worker, n_ranks, tmp_path)
    single = res[0]["single"]
    assert len(single) == 8
    for r in res:
        for a, b in zip(single, r["sharded"]):
            np.testing.assert_allclose(a, b, atol=1e-4)
    # the raw chain is not what came back: BA moved the poses
    _, poses_gt, frames, rels = TR.make_corridor()
    raw = TR.run_chain(frames[:8], rels[:7], poses_gt[:8], None)
    assert max(np.abs(a - b).max() for a, b in zip(raw, single)) > 1e-3


def test_dryrun_multichip_2(tmp_path):
    res = TR.spawn(TR.dryrun_worker, 2, tmp_path)
    for rank, r in enumerate(res):
        assert "3-device mesh" in r["too_many"]
        assert r["sub_size"] == 1
        assert r["sub_coord"] == ((0,) if rank == 0 else None)


def test_make_mesh_needs_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        PM.make_mesh(device="cpu")


def test_run_multihost_main_single_process():
    """main() end to end in single-process mode (a world of one); the group
    it made is gone afterwards."""
    import torch.distributed as dist
    from scripts.run_multihost_torch import main

    res = main(["--steps", "1", "--size", "small", "--device", "cpu"])
    assert res["devices"] == 1
    assert res["hosts"] == 1
    assert res["frame_pairs_per_s"] > 0
    assert np.isfinite(res["mean_inlier_ratio"])
    assert not dist.is_initialized()


def test_run_multihost_rehearsal(tmp_path):
    """Two ranks start their group from the coordinator flags, each
    rendering only its own pair: the global batch is 2 and the mean is the
    same on both."""
    store = str(tmp_path / "coordinator")
    res = TR.spawn(TR.multihost_worker, 2, tmp_path, store, init=False)
    for r in res:
        assert r["devices"] == 2 and r["hosts"] == 1
        assert r["batch_per_device"] == 1 and r["sec_per_step"] > 0
        assert np.isfinite(r["mean_inlier_ratio"])
    assert res[0]["mean_inlier_ratio"] == res[1]["mean_inlier_ratio"]
