"""Mean wall time of rank 0's call of the sharded pair step a step, in
the traced run's window: the benchmark's own span around
`build_sharded_pair_step`'s step (the rank's pairs, each two stereo
steps and a temporal step, and the exchange), synchronised on both
sides."""

LAYER = "step"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "frames_per_s"


def read(ctx):
    spans = (ctx.get("spans") or {}).get("pair_step")
    return 1e3 * sum(spans) / len(spans) if spans else None
