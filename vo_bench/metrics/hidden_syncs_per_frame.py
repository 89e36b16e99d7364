"""Synchronising CUDA calls a frame (`harness/spans.SYNC_CALLS`) inside
`vo/frame` that no declared wait (`vo/wait.*`) covers, in the spans
slice (`harness/spans.py`): waits the code does not declare, as a
`nonzero`, a mask index, an `.item()` or a pageable copy. A frame
captured as a CUDA graph has none. Nothing to read without the
program's spans."""

from vo_bench.harness import spans as SP

LAYER = "frame"
UNIT = "syncs"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    return SP.per_frame(ctx, lambda ps: ps["syncs"]["hidden"])
