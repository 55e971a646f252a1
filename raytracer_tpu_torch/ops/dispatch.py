"""Intersection dispatch: the counterpart of
``raytracer_tpu/ops/dispatch.py`` for the routes the port has.

``method`` "pallas" (and "auto", which resolves to it: the CUDA kernel
streams any table size through shared memory, so the JAX package's VMEM
caps and slabs have no counterpart) runs the closest-hit kernel
(``ops/closest_hit.py``). Every other route raises, naming the ROADMAP item
that ports it. Rays are (3, N) rows, as everywhere in the port.
"""

from __future__ import annotations

from raytracer_tpu_torch.ops import closest_hit
from raytracer_tpu_torch.ops.fused_bounce import BounceTables, pack_tables
from raytracer_tpu_torch.scene.types import Scene

UNPORTED = {
    "bvh": "the flat BVH is not ported yet (ROADMAP A10)",
    "leaf": "the leaf-culled kernel is not ported yet (ROADMAP A10, B4)",
    "bruteforce": "the brute-force XLA intersector is not ported yet "
                  "(ROADMAP A3)",
}


def resolve(method: str) -> str:
    """"auto" and "pallas" resolve to "pallas"; any other method raises
    ``NotImplementedError`` naming its ROADMAP item."""
    if method in ("auto", "pallas"):
        return "pallas"
    if method in UNPORTED:
        raise NotImplementedError(f"intersector {method!r}: "
                                  + UNPORTED[method])
    raise ValueError(f"unknown intersector {method!r}")


def _closest(scene, o, d, t_min, t_max, method, alive, tables):
    resolve(method)
    if tables is None:
        tables = pack_tables(scene)
    if alive is None:
        alive = o.new_ones(o.shape[1], dtype=bool)
    return tables, closest_hit.closest_tables(tables, o, d, t_min, t_max,
                                              alive)


def intersect_scene(scene: Scene, o, d, t_min, t_max, method: str = "auto",
                    alive=None, tables: BounceTables = None):
    """Closest hit (``closest_hit.Closest``: t, type, index, b1, b2) of
    rays ``o``/``d`` (3, N) within [t_min, t_max). ``tables``:
    ``pack_tables(scene)`` from an earlier call, if any."""
    return _closest(scene, o, d, t_min, t_max, method, alive, tables)[1]


def intersect_and_attrs(scene: Scene, o, d, t_min, t_max,
                        method: str = "auto", alive=None,
                        tables: BounceTables = None):
    """Closest hit plus the winner's attributes and material features.
    Returns (``Closest``, ``HitSoA``, ``FeatSoA``)."""
    from raytracer_tpu_torch.models.wavefront_soa import attrs_soa
    tables, c = _closest(scene, o, d, t_min, t_max, method, alive, tables)
    return (c, *attrs_soa(tables, o, d, c))
