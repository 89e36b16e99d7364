"""Port stereo / temporal / pose stages fed exactly what the JAX reference
fed its own stages (converted with models/types.py), at 120x160 with a
small config:

  - match_stereo on JAX's EdgeLists and FrameData: stage survival rows
    within 5% + 5, mates within 0.97;
  - match_temporal on JAX's mates (bf16 descriptors included): rows within
    5% + 5, quads within 0.97;
  - lift_quads on JAX's quads: identical PROSAC order;
  - estimate_pose on JAX's lifted quads with JAX's RANSAC draws injected:
    R and t within 1e-4, inlier count within 2.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from edge_based_visual_odometry_tpu import geometry as JGEO
from edge_based_visual_odometry_tpu.config import VOConfig as JVOConfig
from edge_based_visual_odometry_tpu.io import synthetic as JS
from edge_based_visual_odometry_tpu.models import motion_tracker as JMT
from edge_based_visual_odometry_tpu.models import stereo_matcher as JSM
from edge_based_visual_odometry_tpu.models import temporal_matcher as JTM
from edge_based_visual_odometry_tpu.models.types import (
    FrameData as JFrameData, RigArrays as JRigArrays)
from edge_based_visual_odometry_tpu.ops import image as JIMG
from edge_based_visual_odometry_tpu.ops import toed as JT
from edge_based_visual_odometry_tpu_torch import geometry as GEO
from edge_based_visual_odometry_tpu_torch.models import motion_tracker as MT
from edge_based_visual_odometry_tpu_torch.models import stereo_matcher as SM
from edge_based_visual_odometry_tpu_torch.models import temporal_matcher as TM
from edge_based_visual_odometry_tpu_torch.models import types as TY

pytestmark = pytest.mark.heavy
torch.set_num_threads(2)

SMALL = dict(max_edges=1024, max_candidates=8, gather_slots=64,
             max_mates=512, max_refine_pairs=1024, max_quad_candidates=8,
             quad_gather_slots=144, ransac_max_iterations=256, gn_max_iter=4)
CPU = torch.device("cpu")


def _rows_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.all(np.abs(a - b) <= 0.05 * np.maximum(a, b) + 5), (a, b)


def _ratio(a, b):
    return min(a, b) / max(a, b, 1)


@pytest.fixture(scope="module")
def ref():
    """Two frames through the JAX stages (jitted), with every input and
    output kept as numpy."""
    cfg = JVOConfig(**SMALL)
    seq = JS.make_sequence(2, 120, 160)
    rig = JRigArrays.from_rig(seq.rig)

    @jax.jit
    def stereo(left, right):
        both = jnp.stack([left, right])
        gxs, gys = jax.vmap(JIMG.sobel_gradients)(both)
        fd = JFrameData(left, right, gxs[0], gys[0], gxs[1], gys[1])
        led = JT.detect_edges(left, max_edges=cfg.max_edges)
        red = JT.detect_edges(right, max_edges=cfg.max_edges)
        mates, _, metrics = JSM.match_stereo(led, red, fd, rig, cfg)
        return fd, led, red, mates, metrics

    frames = []
    for f in seq.frames:
        l, r = (jnp.asarray(np.round(a).clip(0, 255), jnp.float32)
                for a in (f.left, f.right))
        frames.append(jax.tree_util.tree_map(np.asarray, stereo(l, r)))
    p0 = JGEO.Pose(jnp.asarray(seq.frames[0].R, jnp.float32),
                   jnp.asarray(seq.frames[0].t, jnp.float32))
    p1 = JGEO.Pose(jnp.asarray(seq.frames[1].R, jnp.float32),
                   jnp.asarray(seq.frames[1].t, jnp.float32))
    rel = JGEO.relative_pose(p0, p1)

    @jax.jit
    def temporal(m0, fd0, m1, fd1, R, t):
        quads, metrics = JTM.match_temporal(m0, m1, fd0, fd1, JGEO.Pose(R, t),
                                            rig, cfg, use_gt=False)
        pq = JMT.lift_quads(m0, quads, rig, cfg, use_gt=False)
        idx1, idx2, _ = JMT._sample_quad_pairs(pq, cfg, 7,
                                               cfg.ransac_max_iterations)
        return quads, metrics, pq, idx1, idx2, JMT.estimate_pose(pq, rig, cfg, 7)

    (fd0, _, _, m0, _), (fd1, _, _, m1, _) = frames
    tout = jax.tree_util.tree_map(
        np.asarray, temporal(m0, fd0, m1, fd1, rel.R, rel.t))
    return dict(seq=seq, cfg=cfg, frames=frames, rel=rel, temporal=tout)


def _port_cfg(ref):
    return TY.config_from_fields(dataclasses.asdict(ref["cfg"]))


def test_match_stereo_on_jax_edges(ref):
    cfg = _port_cfg(ref)
    rig = TY.rig_arrays_from_rig(ref["seq"].rig, CPU)
    ry = SM.derive_gather_band(ref["seq"].rig, cfg)
    for fd, led, red, mates, metrics in ref["frames"]:
        out, _, rows = SM.match_stereo(
            TY.edge_list_from_numpy(led, CPU), TY.edge_list_from_numpy(red, CPU),
            TY.frame_data_from_numpy(fd, CPU), rig, cfg, gather_ry=ry)
        _rows_close(rows[:, 1].numpy(), metrics[:, 1])
        _rows_close(rows[:, 0].numpy(), metrics[:, 0])
        assert _ratio(int(out.count), int(mates.count)) >= 0.97
        n = int(out.count)
        assert out.valid[:n].all() and not out.valid[n:].any()
        assert out.left_desc.dtype == torch.bfloat16
        assert torch.isfinite(out.gamma[:n]).all()


def test_match_temporal_on_jax_mates(ref):
    cfg = _port_cfg(ref)
    rig = TY.rig_arrays_from_rig(ref["seq"].rig, CPU)
    (fd0, _, _, m0, _), (fd1, _, _, m1, _) = ref["frames"]
    quads_ref, metrics_ref = ref["temporal"][:2]
    rel = GEO.Pose(torch.from_numpy(np.asarray(ref["rel"].R)),
                   torch.from_numpy(np.asarray(ref["rel"].t)))
    quads, metrics = TM.match_temporal(
        TY.stereo_mates_from_numpy(m0, CPU), TY.stereo_mates_from_numpy(m1, CPU),
        TY.frame_data_from_numpy(fd0, CPU), TY.frame_data_from_numpy(fd1, CPU),
        rel, rig, cfg)
    _rows_close(metrics[:, 1].numpy(), metrics_ref[:, 1])
    _rows_close(metrics[:, 0].numpy(), metrics_ref[:, 0])
    n_out = int(quads.cmask.sum())
    n_ref = int(quads_ref.cmask.sum())
    assert n_ref > 100 and _ratio(n_out, n_ref) >= 0.97


def test_lift_and_pose_on_jax_quads(ref):
    cfg = _port_cfg(ref)
    rig = TY.rig_arrays_from_rig(ref["seq"].rig, CPU)
    m0 = TY.stereo_mates_from_numpy(ref["frames"][0][3], CPU)
    quads_ref, _, pq_ref, idx1, idx2, pose_ref = ref["temporal"]
    quads = TY._convert(TM.TemporalQuads, quads_ref, CPU)
    pq = MT.lift_quads(m0, quads, rig, cfg)
    assert int(pq.n_valid) == int(pq_ref.n_valid) > 100
    np.testing.assert_array_equal(pq.valid.numpy(), pq_ref.valid)
    v = pq_ref.valid
    for a, b in ((pq.gamma, pq_ref.gamma), (pq.gamma_bar, pq_ref.gamma_bar),
                 (pq.cf_left, pq_ref.cf_left)):
        np.testing.assert_allclose(a.numpy()[v], b[v], rtol=1e-5, atol=1e-5)

    # RANSAC on the reference's own lifted quads with its draws injected
    pq_j = TY._convert(MT.PoseQuads, pq_ref, CPU)
    res = MT.estimate_pose(pq_j, rig, cfg, idx=(idx1, idx2))
    assert bool(res.success) and bool(pose_ref.success)
    np.testing.assert_allclose(res.R.numpy(), pose_ref.R, atol=1e-4)
    np.testing.assert_allclose(res.t.numpy(), pose_ref.t, atol=1e-4)
    assert abs(int(res.inlier_count) - int(pose_ref.inlier_count)) <= 2


def test_pose_draws_from_generator_are_seeded(ref):
    cfg = _port_cfg(ref)
    pq = TY._convert(MT.PoseQuads, ref["temporal"][2], CPU)
    a = MT._sample_quad_pairs(pq, cfg, 42, 64)[:2]
    b = MT._sample_quad_pairs(pq, cfg, 42, 64)[:2]
    c = MT._sample_quad_pairs(pq, cfg, 43, 64)[:2]
    top_n = max(int(cfg.ransac_top_rank_percentage * int(pq.n_valid)), 2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    assert (a[0] != a[1]).all() and (a[0] < top_n).all() and (a[1] < top_n).all()
