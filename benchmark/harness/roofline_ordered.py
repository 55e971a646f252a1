"""The least time of the ordered triangle walk's chunk bodies
(``csrc/sweep.cuh::walk`` in ``bounce_ordered.cu``), from the program's
count of them, frozen here so that a later change to the program cannot
move the yardstick. ``roofline.py`` (the flat sweep's) is left as it is;
its peaks and its count of a triangle test are reused.

A chunk body is one warp of 32 lanes testing one chunk of 512 triangles:
the warp's lanes run it together, alive or not, so its operations are
32 x 512 pair tests of ``roofline.TRI_FLOPS`` FP32 operations each. Its
bytes: each launch reads the stage's chunks (64 B a sorted triangle
record and its 4 B scene index) once from device memory; a body's rereads
come from the L2 cache and are not counted. Only the triangle walk is
counted: a cell whose spheres walk too needs a revision of this file."""

from __future__ import annotations

from harness.roofline import TRI_FLOPS, bound

LANES = 32              # a warp: the lanes that run a body together
TRI_CHUNK = 512         # triangles a chunk of the ordered stage
TRI_RECORD_BYTES = 68   # a sorted triangle's 16 floats and its index


def walk_bound(bodies: int, launches: int, triangles: int) -> dict:
    """``roofline.bound`` of ``bodies`` chunk bodies run by ``launches``
    launches of the ordered kernel over a stage of ``triangles``
    triangles."""
    chunks = -(-triangles // TRI_CHUNK)
    flops = bodies * LANES * TRI_CHUNK * TRI_FLOPS
    nbytes = launches * chunks * TRI_CHUNK * TRI_RECORD_BYTES
    return bound(flops, nbytes)
