"""sppm.ordered_bodies_per_warp: the ordered walk's chunk bodies per live
warp over the traced stretch: the program's counters ``ordered.bodies``
over ``ordered.warps`` (every ordered bounce of the photon pass and the
measurement walk, captured or eager; summed on the device and read once
when the recording ends). A body is one warp testing one chunk of 512
triangles; a live warp is one with a lane alive.

Nothing to read (None) where the program counts no ``ordered.warps``:
flat tables, or a program without the counters."""

from harness import recorder


def read(ctx):
    rec = recorder.records(ctx)
    if rec is None:
        return None
    warps = rec["counters"].get("ordered.warps", 0)
    if not warps:
        return None
    return rec["counters"].get("ordered.bodies", 0) / warps
