"""Wall time a frame of lifting the quads into PROSAC order: the
`vo/lift_quads` span inside the temporal step, on the host's clock in
the spans slice (`harness/spans.py`), with no synchronise: the host's
time in the stage, its launches and waits included, over the slice's
frames. Nothing to read without the program's spans."""

from vo_bench.harness import spans as SP

LAYER = "stage"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    return SP.stage_ms(ctx, "lift_quads")
