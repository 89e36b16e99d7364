"""Time a frame the host spends inside the program's declared waits
(`vo/wait.*` spans: the images' pageable upload, the temporal step's
success flag, the adaptive keyframe reads, windowed BA's synchronise and
readback) in the spans slice (`harness/spans.py`), over its frames.
Nothing to read without the program's spans."""

from vo_bench.harness import spans as SP

LAYER = "frame"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    return SP.per_frame(ctx, lambda ps: 1e3 * ps["wait_s"])
