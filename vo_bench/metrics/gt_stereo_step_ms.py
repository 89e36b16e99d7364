"""Mean wall time of the supervised pipeline's stereo-step callable a
frame, in the traced run's window: the benchmark's own span around
`build_stereo_step`'s step with the GT maps (the images' and the maps'
uploads, Sobel, TOED, the supervised `match_stereo`), synchronised on
both sides. The reading is `stereo_step_ms`'s, in the supervised cell."""

from vo_bench.metrics.stereo_step_ms import read  # noqa: F401

LAYER = "step"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "frames_per_s"
