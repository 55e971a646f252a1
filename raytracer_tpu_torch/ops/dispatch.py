"""Intersection dispatch: the counterpart of
``raytracer_tpu/ops/dispatch.py``.

``method`` "pallas" runs the closest-hit kernel (``ops/closest_hit.py``),
the ordered one when ``pack_tables`` attached an ordered stage. "auto"
resolves from the scene, as JAX ``_resolve`` does past its kernel caps
(``auto_route``): "pallas" while the sphere and triangle tables fit the
port's own cap (``ordered.MAX_SUPERS`` superchunks; the CUDA kernels read
any smaller table from global memory, so the JAX package's VMEM caps and
slab chain have no counterpart), past it "bvh" on a scene with a BVH
whose spheres stand still, else "bruteforce" (``route``; the tables
each route reads: ``route_tables``). "leaf" runs the leaf kernel
(``ops/leaf.py``) and needs the scene's leaf tables (``ValueError``
without, as JAX ``pallas_bvh._run``).
The (N, 3) routes have no kernel (their JAX functions are XLA):
"bruteforce" runs the chunked scan of ``ops/intersect.py``, "bvh" the
flat BVH's traversal of ``ops/bvh.py`` (``ValueError`` without a BVH, as
JAX ``intersect_scene``); their winners get the triangle barycentrics
recomputed. Rays are (3, N) rows, as everywhere in the port, but for
``aos_hit``, which takes the (N, 3) routes' own (N, 3) rays.

Motion blur, as JAX ``_resolve``: a scene whose spheres move takes the
kernel route even when "leaf" or "bvh" is asked for (neither has a motion
form), and with a per-ray ``time`` the closest hit tests the spheres at
c + v t. Without a time it is intersected at its t = 0 centres, the answer
JAX's brute-force route gives.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops import bvh, closest_hit, intersect, leaf
from raytracer_tpu_torch.ops import ordered
from raytracer_tpu_torch.ops.fused_bounce import (
    BounceTables, moving, pack_tables,
)
from raytracer_tpu_torch.scene.types import PRIM_TRIANGLE, Scene

NO_LEAF = "scene has no leaf tables; call with_leaf_tables"
NO_BVH = bvh.NO_BVH
AOS_ROUTES = ("bruteforce", "bvh")


def auto_route(scene: Scene) -> str:
    """The route "auto" takes on ``scene``: "pallas" unless its sphere or
    triangle table is past ``ordered.MAX_SUPERS`` superchunks; past it
    "bvh" where the scene has a BVH and its spheres stand still, else
    "bruteforce" (JAX ``_resolve`` past its caps, a moving scene
    included)."""
    if not (ordered.past_cap(scene.spheres.radius.shape[0], ordered.SPH_CHUNK)
            or ordered.past_cap(scene.triangles.mat_id.shape[0],
                                ordered.TRI_CHUNK)):
        return "pallas"
    return "bvh" if scene.bvh is not None and not moving(scene) \
        else "bruteforce"


def resolve(method: str, moves: bool = False) -> str:
    """An intersector other than "auto" resolved: "pallas" and
    "bruteforce" to themselves; "leaf" and "bvh" to themselves, or to
    "pallas" for a scene whose spheres move (``moves``). "auto" depends on
    the scene: ``route``."""
    if method in ("pallas", "bruteforce"):
        return method
    if method in ("leaf", "bvh"):
        return "pallas" if moves else method
    raise ValueError(f"unknown intersector {method!r}")


def route(scene: Scene, method: str) -> str:
    """``method`` resolved for ``scene`` ("auto": ``auto_route``; else
    ``resolve``) and checked against its tables (``check_route``)."""
    method = (auto_route(scene) if method == "auto"
              else resolve(method, moving(scene)))
    check_route(scene, method)
    return method


def route_tables(scene: Scene, method: str):
    """The tables ``method``'s route (``route``) reads: none on the
    (N, 3) routes, ``pack_tables`` with the ordered stages on "pallas",
    and without them on "leaf", whose kernel never walks them."""
    method = route(scene, method)
    if method in AOS_ROUTES:
        return None
    return pack_tables(scene, order=method == "pallas")


def check_route(scene: Scene, method: str):
    """Raise ``ValueError`` where the resolved ``method`` needs tables the
    scene lacks (leaf tables, a BVH)."""
    if method == "leaf" and scene.leaf is None:
        raise ValueError(NO_LEAF)
    if method == "bvh" and scene.bvh is None:
        raise ValueError(NO_BVH)


def aos_hit(scene: Scene, o, d, t_min, t_max, method: str, alive=None,
            time=None) -> intersect.Hit:
    """The closest hit of an (N, 3) route ("bruteforce" or "bvh") for rays
    ``o``/``d`` (N, 3); lanes outside ``alive`` miss. The BVH traverses
    the alive lanes only (JAX traverses every lane and the caller masks
    the dead ones: the same winners)."""
    if method == "bruteforce":
        return intersect.intersect_bruteforce(scene, o, d, t_min, t_max,
                                              time, alive)
    check_route(scene, method)
    if alive is None:
        return bvh.intersect_bvh(scene, o, d, t_min, t_max)
    idx = alive.nonzero()[:, 0]

    def lanes(x):
        return x[idx] if torch.is_tensor(x) and x.dim() else x

    h = bvh.intersect_bvh(scene, o[idx], d[idx], lanes(t_min), lanes(t_max))
    n = o.shape[0]
    out = intersect.Hit(torch.full((n,), torch.inf, device=o.device),
                        torch.full((n,), -1, dtype=torch.int32,
                                   device=o.device),
                        torch.full((n,), -1, dtype=torch.int32,
                                   device=o.device))
    for a, b in zip(out, h):
        a[idx] = b
    return out


def aos_closest(scene: Scene, o, d, t_min, t_max, method: str, alive=None,
                time=None) -> closest_hit.Closest:
    """``aos_hit`` on (3, N) rays as a ``Closest``, the triangle winners'
    barycentrics recomputed."""
    ot, dt = o.T, d.T
    h = aos_hit(scene, ot, dt, t_min, t_max, method, alive, time)
    b1 = b2 = torch.zeros_like(h.t)
    tr = scene.triangles
    if tr.mat_id.shape[0]:
        is_t = h.prim_type == PRIM_TRIANGLE
        i = h.prim_idx.long().clamp(0, tr.mat_id.shape[0] - 1)
        tb1, tb2 = intersect.tri_barycentrics(tr, i, ot, dt)
        b1 = torch.where(is_t, tb1, 0.0)
        b2 = torch.where(is_t, tb2, 0.0)
    return closest_hit.Closest(h.t, h.prim_type, h.prim_idx, b1, b2)


def _closest(scene, o, d, t_min, t_max, method, alive, tables, time):
    method = route(scene, method)
    if method in AOS_ROUTES:
        return tables, aos_closest(scene, o, d, t_min, t_max, method, alive,
                                   time)
    if tables is None:
        tables = route_tables(scene, method)
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
    if tables is None:                        # an (N, 3) route
        tables = pack_tables(scene, order=False)
    return (c, *attrs_soa(tables, o, d, c, time))
