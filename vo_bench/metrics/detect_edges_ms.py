"""Wall time a frame of TOED on both images (K1): the `vo/detect_edges`
span inside the stereo step, on the host's clock in the spans slice
(`harness/spans.py`), with no synchronise: the host's time in the
stage, its launches and waits included, over the slice's frames.
Nothing to read without the program's spans."""

from vo_bench.harness import spans as SP

LAYER = "stage"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    return SP.stage_ms(ctx, "detect_edges")
