"""Intersection dispatch: the counterpart of
``raytracer_tpu/ops/dispatch.py`` for the routes the port has.

``method`` "pallas" (and "auto", which resolves to it: the CUDA kernels
read any table size from global memory, so the JAX package's VMEM caps and
slab chain have no counterpart) runs the closest-hit kernel
(``ops/closest_hit.py``), the ordered one when ``pack_tables`` attached an
ordered stage. "leaf" runs the leaf kernel (``ops/leaf.py``) and needs the
scene's leaf tables (``ValueError`` without, as JAX ``pallas_bvh._run``).
"bvh" and "bruteforce" raise, naming the ROADMAP item that ports them. Rays
are (3, N) rows, as everywhere in the port.

Motion blur, as JAX ``_resolve``: a scene whose spheres move takes the
kernel route even when "leaf" is asked for (the leaf kernel has no motion
form), and with a per-ray ``time`` the closest hit tests the spheres at
c + v t. Without a time it is intersected at its t = 0 centres, the answer
JAX's brute-force route gives.
"""

from __future__ import annotations

from raytracer_tpu_torch.ops import closest_hit, leaf
from raytracer_tpu_torch.ops.fused_bounce import (
    BounceTables, moving, pack_tables,
)
from raytracer_tpu_torch.scene.types import Scene

UNPORTED = {
    "bvh": "the flat BVH is not ported yet (ROADMAP A10)",
    "bruteforce": "the brute-force XLA intersector is not ported yet "
                  "(ROADMAP A3)",
}
NO_LEAF = "scene has no leaf tables; call with_leaf_tables"


def resolve(method: str, moves: bool = False) -> str:
    """"auto" and "pallas" resolve to "pallas", "leaf" to itself, or to
    "pallas" for a scene whose spheres move (``moves``); "bvh" and
    "bruteforce" raise ``NotImplementedError`` naming their ROADMAP
    item."""
    if method in ("auto", "pallas"):
        return "pallas"
    if method == "leaf":
        return "pallas" if moves else method
    if method in UNPORTED:
        raise NotImplementedError(f"intersector {method!r}: "
                                  + UNPORTED[method])
    raise ValueError(f"unknown intersector {method!r}")


def _closest(scene, o, d, t_min, t_max, method, alive, tables, time):
    method = resolve(method, moving(scene))
    if method == "leaf" and scene.leaf is None:
        raise ValueError(NO_LEAF)
    if tables is None:
        tables = pack_tables(scene)
    if alive is None:
        alive = o.new_ones(o.shape[1], dtype=bool)
    if method == "leaf":
        return tables, leaf.leaf_closest(tables, o, d, t_min, t_max, alive)
    return tables, closest_hit.closest_tables(tables, o, d, t_min, t_max,
                                              alive, time=time)


def intersect_scene(scene: Scene, o, d, t_min, t_max, method: str = "auto",
                    alive=None, tables: BounceTables = None, time=None):
    """Closest hit (``closest_hit.Closest``: t, type, index, b1, b2) of
    rays ``o``/``d`` (3, N) within [t_min, t_max), at the rays' shutter
    ``time`` (N,) if given. ``tables``: ``pack_tables(scene)`` from an
    earlier call, if any."""
    return _closest(scene, o, d, t_min, t_max, method, alive, tables,
                    time)[1]


def intersect_and_attrs(scene: Scene, o, d, t_min, t_max,
                        method: str = "auto", alive=None,
                        tables: BounceTables = None, time=None):
    """Closest hit plus the winner's attributes and material features,
    at the rays' shutter ``time`` if given. Returns (``Closest``,
    ``HitSoA``, ``FeatSoA``)."""
    from raytracer_tpu_torch.models.wavefront_soa import attrs_soa
    tables, c = _closest(scene, o, d, t_min, t_max, method, alive, tables,
                         time)
    return (c, *attrs_soa(tables, o, d, c, time))
