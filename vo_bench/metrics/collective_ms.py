"""Time a step the ranks' hosts spend in the pair step's exchange: the
program's `vo/pair.exchange` span (the all-reduce, the host's read of
the pair count, which waits for the rank's queued work and for the
slowest rank, and the five all-gathers' launches), wall time over the
span's calls on each rank in the traced run's profiled slice with spans
on, the largest over the ranks. Nothing to read without the program's
spans."""

LAYER = "exchange"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    per_rank = []
    for ps in ctx.get("pair_spans") or []:
        row = (ps or {}).get("rows", {}).get("pair.exchange")
        if row and row["calls"]:
            per_rank.append(1e3 * row["wall_s"] / row["calls"])
    return max(per_rank) if per_rank else None
