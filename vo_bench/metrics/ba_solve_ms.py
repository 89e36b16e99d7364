"""Windowed BA's cost a frame: `WindowBA.run`'s own `solve_s` (the
device solve, ended by its one copy to the host) plus `host_assembly_s`
(the window problem built on the host), summed over the solves of the
traced run's window and divided by its frames. Nothing to read in a
cell without BA."""

LAYER = "window BA"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    infos, frames = ctx.get("ba_infos"), ctx.get("window_frames")
    if not infos or not frames:
        return None
    return 1e3 * sum(i["solve_s"] + i["host_assembly_s"]
                     for i in infos) / frames
