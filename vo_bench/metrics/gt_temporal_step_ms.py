"""Mean wall time of the supervised pipeline's temporal-step callable a
frame, in the traced run's window: the benchmark's own span around
`build_temporal_step`'s step with the GT relative pose (`match_temporal`
and `lift_quads` with `use_gt`, `estimate_pose`), synchronised on both
sides. The reading is `temporal_step_ms`'s, in the supervised cell."""

from vo_bench.metrics.temporal_step_ms import read  # noqa: F401

LAYER = "step"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "frames_per_s"
