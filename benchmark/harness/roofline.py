"""The least time of a flat sweep, frozen from ``chip_smoke.py``'s
arithmetic (``PEAK_*``, ``SPH/RECT/TRI_FLOPS``, ``bound``,
``sweep_bound``, ``REGEN_LANE_BYTES``) so that a later change to the
program cannot move the yardstick.

The count assumes the flat route's all-pairs sweep: every alive lane
tests every primitive of the scene. It is a function of the cell's inputs
(the scene's primitive counts) and of the rays the loop reports, never of
a kernel's own statistics or culls. A kernel that culls needs a revision
of this file first."""

from __future__ import annotations

# One H100 SXM (NVIDIA's data sheet, at 700 W): FP32 outside the tensor
# cores, and device memory.
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# FP32 operations per pair test, counted from the kernels' sources (a
# sqrt, a division or a reciprocal counts one; compares do not count):
# sphere 17, rect 6, triangle 38.
SPH_FLOPS, RECT_FLOPS, TRI_FLOPS = 17, 6, 38
# Bytes of one primitive in the packed tables, read once per launch: a
# sphere's row of 4 floats and its material id, a rect's row of 8 and its
# material id, a triangle's row of 16, its three vertex normals and its
# material id.
SPH_BYTES, RECT_BYTES, TRI_BYTES = 20, 36, 104
# The regeneration step's lane state per alive lane, read (o, d, tput,
# samp, acc 60, alive 1, depth and done 8, px and py 8, U 32) and written
# (o, d, tput, samp, acc 60, alive 1, depth and done 8).
REGEN_LANE_BYTES = 109 + 69


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take, in seconds: the larger of the
    operations over the FP32 peak and the bytes over the memory rate."""
    ops_s, bytes_s = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return {"bound_s": max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "flops": flops, "bytes": nbytes}


def sweep_bound(rays: int, launches: int, prims: dict,
                lane_bytes: int = REGEN_LANE_BYTES) -> dict:
    """``bound`` of ``launches`` flat sweeps that tested ``rays`` alive
    lanes in all against every primitive of ``prims`` ({"spheres",
    "rects", "triangles"}: counts), each launch reading the tables once
    and each lane's state read and written once."""
    s, r, t = prims["spheres"], prims["rects"], prims["triangles"]
    flops = rays * (s * SPH_FLOPS + r * RECT_FLOPS + t * TRI_FLOPS)
    nbytes = (rays * lane_bytes
              + launches * (s * SPH_BYTES + r * RECT_BYTES + t * TRI_BYTES))
    return bound(flops, nbytes)
