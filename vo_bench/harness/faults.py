"""Faults planted under the timed path, for showing that the check sees
them: each takes a `setattr(obj, name, value)` (pytest's
`monkeypatch.setattr` in the CPU tests, the builtin in
`calibrate.py --fault` on the card) and breaks one stage where its
answer is produced.

- `shift_mates`, `shift_quads`: every mate's right point, every quad
  candidate moved by 1.5 px;
- `corrupt_mates`, `corrupt_quads`: the same on 2 of every 5 rows;
- `drop_half_mates`, `drop_half_quads`: every other mate, every other
  keyframe row's candidates left out (the rest kept as they are);
- `alter_pose`: the relative pose moved 0.3 m;
- `pose_unchanged`: the temporal step returns the identity pose;
- `ba_unchanged`: windowed BA returns the keyframe poses it was given.
"""

from __future__ import annotations

import torch


def _rows(n, device, keep):
    """(n,) bool: rows i with keep(i)."""
    return keep(torch.arange(n, device=device))


def _mates(setattr, change):
    from edge_based_visual_odometry_tpu_torch.models import stereo_matcher
    real = stereo_matcher.match_stereo

    def broken(*a, **kw):
        out = real(*a, **kw)
        return (change(out[0]), *out[1:])
    setattr(stereo_matcher, "match_stereo", broken)


def _quads(setattr, change):
    from edge_based_visual_odometry_tpu_torch.models import temporal_matcher
    real = temporal_matcher.match_temporal

    def broken(*a, **kw):
        q, metrics = real(*a, **kw)
        return change(q), metrics
    setattr(temporal_matcher, "match_temporal", broken)


def _pose(setattr, change):
    from edge_based_visual_odometry_tpu_torch.models import motion_tracker
    real = motion_tracker.estimate_pose

    def broken(*a, **kw):
        return change(real(*a, **kw))
    setattr(motion_tracker, "estimate_pose", broken)


def _shift_mates_where(m, where):
    return m._replace(right_x=torch.where(where, m.right_x + 1.5,
                                          m.right_x))


def _shift_quads_where(q, where):
    w = where[:, None]
    return q._replace(lcx=torch.where(w, q.lcx + 1.5, q.lcx),
                      lcy=torch.where(w, q.lcy + 1.5, q.lcy))


def shift_mates(setattr):
    _mates(setattr, lambda m: m._replace(right_x=m.right_x + 1.5))


def shift_quads(setattr):
    _quads(setattr, lambda q: q._replace(lcx=q.lcx + 1.5, lcy=q.lcy + 1.5))


def corrupt_mates(setattr):
    _mates(setattr, lambda m: _shift_mates_where(
        m, _rows(m.right_x.shape[0], m.right_x.device, lambda i: i % 5 < 2)))


def corrupt_quads(setattr):
    _quads(setattr, lambda q: _shift_quads_where(
        q, _rows(q.lcx.shape[0], q.lcx.device, lambda i: i % 5 < 2)))


def _drop_half(m):
    valid = m.valid & _rows(m.valid.shape[0], m.valid.device,
                            lambda i: i % 2 == 0)
    return m._replace(valid=valid, count=valid.sum().to(m.count.dtype))


def drop_half_mates(setattr):
    _mates(setattr, _drop_half)


def drop_half_quads(setattr):
    _quads(setattr, lambda q: q._replace(cmask=q.cmask & _rows(
        q.cmask.shape[0], q.cmask.device, lambda i: i % 2 == 0)[:, None]))


def alter_pose(setattr):
    _pose(setattr, lambda r: r._replace(
        t=r.t + torch.tensor([0.3, 0.0, 0.0], device=r.t.device)))


def pose_unchanged(setattr):
    _pose(setattr, lambda r: r._replace(
        R=torch.eye(3, device=r.R.device), t=torch.zeros(3,
                                                          device=r.t.device)))


def ba_unchanged(setattr):
    from edge_based_visual_odometry_tpu_torch import geometry as geom
    from edge_based_visual_odometry_tpu_torch.models import window_ba
    real = window_ba.WindowBA.run

    def broken(self):
        given = [T.copy() for T in self.kf_poses]
        out = real(self)
        if out is None:
            return None
        self.kf_poses[:len(given)] = given
        return ([geom.Pose(self._dev(T[:3, :3]), self._dev(T[:3, 3]))
                 for T in given], out[1])
    setattr(window_ba.WindowBA, "run", broken)


FAULTS = {f.__name__: f for f in (
    shift_mates, shift_quads, corrupt_mates, corrupt_quads, drop_half_mates,
    drop_half_quads, alter_pose, pose_unchanged, ba_unchanged)}
