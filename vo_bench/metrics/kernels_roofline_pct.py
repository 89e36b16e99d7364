"""K1-K9's share of their roofline: the sum of each launch's bound (the
larger of its flops / 67 TFLOP/s and its bytes / 3.35 TB/s, the H100
SXM's float32 and HBM3 peaks at 700 W: `vo_bench/harness/work.py`, a
frozen copy of chip_smoke.py's counts) over the sum of the launches'
device time in the profiled slice, both a frame.

The work is counted in a second slice of as many frames, one lap of the
periodic scene later (the same frames and keyframes), whose launches
keep their operands (`kernels.WorkRecorder`): reading live slots and
iterations run needs copies on the card that the profiled slice must
not carry. Every K1-K9 launch is counted; K2's map interleave
(`interleave_kernel`) is in neither sum."""

LAYER = "kernel"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(ctx):
    trace, work = ctx.get("trace"), ctx.get("work")
    if not trace or not work or not trace.get("units") \
            or not ctx.get("work_units"):
        return None
    ks = [k for k in work if trace["by_kernel"].get(k, 0.0) > 0]
    if not ks:
        return None
    bound = sum(work[k]["bound_s"] for k in ks) / ctx["work_units"]
    spent = sum(trace["by_kernel"][k] for k in ks) / trace["units"]
    return 100.0 * bound / spent
