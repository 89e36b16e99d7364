"""Faults of the pair sweep, for showing that `pair_check` sees them: each
takes a `setattr(obj, name, value)` and breaks the sharded step (or what
a rank is dealt) in every rank that plants it.

- `exchange_left_out`: the five all-gathers skipped, each rank's own
  rows standing in for every rank's block;
- `half_batch`: a rank computes every other pair of its block and hands
  on the pair before's result for the rest;
- `shifted_rank`: the last rank is dealt the pairs one lap position on,
  (k + 1, k + 2), with the prediction and the truth of (k, k + 1).

The fourth reading the limits are set from, the bfloat16 control, is no
fault of the program: `pair_check.rows_px` computes it.
"""

from __future__ import annotations

import torch


def exchange_left_out(setattr):
    from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM

    def local_rows(x, group, n_ranks):
        return torch.cat([x] * n_ranks)
    setattr(PM, "_all_gather_rows", local_rows)


def half_batch(setattr):
    from edge_based_visual_odometry_tpu_torch.parallel import mesh as PM
    real = PM.build_pair_step

    def build(*a, **kw):
        one_pair = real(*a, **kw)
        state = {"calls": 0, "last": None}

        def half(*args):
            state["calls"] += 1
            if state["calls"] % 2 == 0 and state["last"] is not None:
                return state["last"]
            state["last"] = one_pair(*args)
            return state["last"]
        return half
    setattr(PM, "build_pair_step", build)


def shifted_rank(setattr):
    from vo_bench.harness import pair_step_run as PSR
    real = PSR.PairCell.images

    def images(self, ks):
        if self.rank == self.n_ranks - 1:
            ks = [(k + 1) % self.n for k in ks]
        return real(self, ks)
    setattr(PSR.PairCell, "images", images)


FAULTS = {f.__name__: f for f in (exchange_left_out, half_batch,
                                  shifted_rank)}
