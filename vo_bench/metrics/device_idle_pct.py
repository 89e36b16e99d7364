"""The share of the profiled slice's wall time in which no operation ran
on the card: 100 x (1 - the union of the device operations' intervals /
the slice's wall time on the host clock)."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not trace.get("busy_s") or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
