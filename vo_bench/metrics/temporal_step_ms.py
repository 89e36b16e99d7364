"""Mean wall time of the pipeline's temporal-step callables a frame
(`build_temporal_step`'s step and the bootstrap's: `match_temporal`,
`lift_quads`, `estimate_pose`), in the traced run's window: the
benchmark's own span, synchronised on both sides."""

LAYER = "step"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "frames_per_s"


def read(ctx):
    spans = (ctx.get("spans") or {}).get("temporal_step")
    return 1e3 * sum(spans) / len(spans) if spans else None
