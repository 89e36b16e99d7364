"""Mean wall time of the pipeline's stereo-step callable a frame, in the
traced run's window: the benchmark's own span around
`build_stereo_step`'s step (undistort, Sobel, TOED, `match_stereo`),
synchronised on both sides."""

LAYER = "step"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "frames_per_s"


def read(ctx):
    spans = (ctx.get("spans") or {}).get("stereo_step")
    return 1e3 * sum(spans) / len(spans) if spans else None
