"""Host time a frame in the program's `vo/wait.gt_upload` span (the
pageable copy of the frame's GT disparity and non-occlusion maps to the
card, inside `vo/gt_upload`) in the traced run's slice with spans on
(`harness/spans.py`), over its frames. Nothing to read in a program
without the span."""

from vo_bench.harness import spans as SP

LAYER = "frame"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    return SP.stage_ms(ctx, "wait.gt_upload")
