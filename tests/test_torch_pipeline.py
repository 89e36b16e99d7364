"""The production frame end to end: 3 frames of make_sequence through the
JAX VOPipeline and the port's VOPipeline (uint8-valued images, 120x160,
small config). Per frame: edges within 0.998, mates and quads within
0.97. Both pipelines meet the bounds of tests/test_pipeline.py (success,
inlier ratio > 0.3, ATE < 0.05 m, RPE < 0.05 m and < 1 deg), and their
relative rotations differ by at most 0.1 deg under the production
every_frame policy (the RANSAC draws differ: threefry vs
torch.Generator). The same at P = 9 with a 4 px shift (the largest
patch the reference's coverage guard admits there), held to the bounds
of the frame-0 policies. Every mode of the reference constructs."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from edge_based_visual_odometry_tpu import geometry as JGEO
from edge_based_visual_odometry_tpu.config import VOConfig as JVOConfig
from edge_based_visual_odometry_tpu.io import synthetic as JS
from edge_based_visual_odometry_tpu.models import pipeline as JPL
from edge_based_visual_odometry_tpu.utils import metrics as MET
from edge_based_visual_odometry_tpu_torch.config import VOConfig
from edge_based_visual_odometry_tpu_torch.io import synthetic as S
from edge_based_visual_odometry_tpu_torch.models import pipeline as PL

pytestmark = pytest.mark.heavy
torch.set_num_threads(2)

SMALL = dict(max_edges=1024, max_candidates=8, gather_slots=64,
             max_mates=512, max_refine_pairs=1024, max_quad_candidates=8,
             quad_gather_slots=144, ransac_max_iterations=256, gn_max_iter=4)


def _u8(a):
    return np.round(a).clip(0, 255).astype(np.uint8)


def _as_jax_pose(p):
    return JGEO.Pose(jnp.asarray(np.asarray(p.R)), jnp.asarray(np.asarray(p.t)))


def _rot_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T)
         - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


@pytest.mark.parametrize("policy,over", [
    pytest.param("every_frame", {}, id="every_frame"),
    pytest.param("reference", {}, id="reference"),
    pytest.param("adaptive", {}, id="adaptive"),
    # the largest patch the 32 / 8 atlas tile covers at a 4 px shift
    pytest.param("every_frame", dict(patch_size=9, orthogonal_shift_mag=4.0),
                 id="every_frame-P9")])
def test_slice_matches_jax(policy, over):
    seq = JS.make_sequence(3, 120, 160)
    gt = [JGEO.Pose(jnp.asarray(f.R, jnp.float32), jnp.asarray(f.t, jnp.float32))
          for f in seq.frames]
    jpipe = JPL.VOPipeline(rig=seq.rig, cfg=JVOConfig(**SMALL, **over),
                           keyframe_policy=policy)
    tpipe = PL.VOPipeline(S.default_rig(120, 160), VOConfig(**SMALL, **over),
                          device="cpu", keyframe_policy=policy)
    for k, f in enumerate(seq.frames):
        jfr, jtr = jpipe.run_frame(_u8(f.left), _u8(f.right))
        tfr, ttr = tpipe.run_frame(_u8(f.left), _u8(f.right))
        for a, b in ((tfr.n_left_edges, jfr.n_left_edges),
                     (tfr.n_right_edges, jfr.n_right_edges)):
            assert min(int(a), int(b)) / max(int(a), int(b)) >= 0.998
        ma, mb = int(tfr.mates.count), int(jfr.mates.count)
        assert min(ma, mb) / max(ma, mb) >= 0.97
        if k == 0:
            assert ttr is None and jtr is None
            continue
        qa, qb = int(ttr.n_quads), int(jtr.n_quads)
        assert min(qa, qb) / max(qa, qb) >= 0.97
        for tr in (ttr, jtr):
            assert bool(tr.success)
            assert float(tr.inlier_ratio) > 0.3
        if policy == "every_frame" and not over:
            # the production slice; across the wider 0 -> 2 baseline of the
            # frame-0 keyframe policies the two RNGs' winners differ by up
            # to ~0.11 deg, and those policies are held to the GT bounds.
            # So is the P = 9 case: on equal quads (377 / 377 on frame 1)
            # the winners differ by 0.10 deg (at P = 7 and a 4 px shift by
            # 0.73 deg on frame 2)
            assert _rot_deg(ttr.R.numpy(), jtr.R) <= 0.1
    assert tpipe.kf_index == jpipe.kf_index
    for traj in (tpipe.trajectory, jpipe.trajectory):
        assert len(traj) == 3
        traj = [_as_jax_pose(p) for p in traj]
        assert MET.ate_rmse(traj, gt, align=False) < 0.05
        rpe_t, rpe_r = MET.rpe_stats(traj, gt)
        assert rpe_t < 0.05 and rpe_r < 1.0


def test_unported_modes_raise(capsys):
    """Nothing of the reference is left refused: a BA mesh (multi-device)
    constructs on a process group, and the CLI parses --save_viz. GT
    supervision, GT poses, windowed BA and distorted rigs construct; an
    unknown keyframe policy still raises."""
    import torch.distributed as dist
    from edge_based_visual_odometry_tpu_torch import cli as CLI
    from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM
    seq = S.make_sequence(1, 120, 160)
    cfg = VOConfig(**SMALL)
    mesh = PM.init_distributed(device="cpu")
    try:
        pipe = PL.VOPipeline(seq.rig, cfg, device="cpu", ba_window=3,
                             ba_mesh=mesh)
        assert pipe.wba.mesh is mesh
    finally:
        dist.destroy_process_group()
    assert CLI.parse_args(["-c", "cfg.yaml", "--save_viz"]).save_viz
    cam = dataclasses.replace(seq.rig.left, distortion=(0.1, 0.0, 0.0, 0.0))
    for kw in (dict(ba_window=3), dict(has_gt_disparity=True),
               dict(use_gt_pose=True),
               dict(rig=dataclasses.replace(seq.rig, left=cam))):
        kw = dict(dict(rig=seq.rig, cfg=cfg, device="cpu"), **kw)
        assert PL.VOPipeline(**kw).frame_idx == 0
    with pytest.raises(ValueError):
        PL.VOPipeline(seq.rig, cfg, device="cpu", keyframe_policy="sometimes")


def test_default_device_is_cuda_and_needs_a_card(monkeypatch):
    """VOPipeline runs on the card unless the caller asks for the CPU; with
    no CUDA device it refuses to start instead of running on the CPU."""
    field = {f.name: f for f in dataclasses.fields(PL.VOPipeline)}["device"]
    assert field.default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seq = S.make_sequence(1, 120, 160)
    cfg = VOConfig(**SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.VOPipeline(seq.rig, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PL.build_temporal_step(seq.rig, cfg, "cuda")
    assert PL.VOPipeline(seq.rig, cfg, device="cpu").device.type == "cpu"
    # the windowed BA is an entry of its own and holds to the same rule
    from edge_based_visual_odometry_tpu_torch.models import window_ba as WBA
    assert inspect.signature(WBA.WindowBA).parameters["device"].default \
        == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WBA.WindowBA(seq.rig.left.K)
    assert WBA.WindowBA(seq.rig.left.K, device="cpu").device.type == "cpu"
