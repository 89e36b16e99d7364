"""Device operations a frame: the kernels, memcpys and memsets on the
card in the profiled slice (`torch.profiler`), divided by its frames."""

LAYER = "device"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(ctx):
    trace = ctx.get("trace")
    if not trace or not trace.get("units") or not trace.get("device_ops"):
        return None
    return trace["device_ops"] / trace["units"]
