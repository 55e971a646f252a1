"""Brute-force closest hit and hit attributes on (N, 3) rays: the
``--intersector bruteforce`` route.

The counterpart of ``raytracer_tpu/ops/intersect.py``'s
``intersect_bruteforce`` and ``hit_attributes``: each primitive table is
scanned in chunks of primitives, each chunk an (N, C) matrix of hit
distances reduced to the running (best t, best index), the reference's
closest-hit semantics (hit.rs:56-67) without its tree. Plain PyTorch, on
the rays' device; no kernel of its own (the JAX function is XLA, not
Pallas).

Chunks: the JAX package scans 512 spheres or rects and 128 triangles at
a time, a TPU tiling. Here a chunk holds at most ``PAIRS`` (ray,
primitive) pairs of the rays' device, so that its (N, C) temporaries stay
bounded at any wavefront width. On the card that is 2^28 pairs, 1 GiB a
float temporary (at 640,000 rays a chunk of 419 primitives):
``tools/bruteforce_chunks.py`` finds the scan's time falling as the chunk
grows, since each chunk costs a few dozen launches, and its peak memory
growing with it (~12 GiB at 2^28). The winner does not depend on the
chunking: within a chunk ``argmin`` takes the lowest index of equal t, and
a later chunk replaces the best only on a strictly smaller t.

Rays need not be unit length. ``t_min``/``t_max`` are floats or (N,)
tensors; a hit needs t_min <= t <= t_max.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_tpu_torch.ops import vec
from raytracer_tpu_torch.scene.types import (
    PRIM_RECT, PRIM_SPHERE, PRIM_TRIANGLE, Scene,
)

PI = 3.141592653589793
PAIRS = {"cuda": 1 << 28, "cpu": 1 << 19}


class Hit(NamedTuple):
    """The winner per ray: t (+inf on a miss), primitive type (-1 on a
    miss) and index in that type's table (-1 on a miss), each (N,)."""
    t: torch.Tensor
    prim_type: torch.Tensor
    prim_idx: torch.Tensor


class HitAttrs(NamedTuple):
    """The reference's HitRecord (hit.rs:7-14) as (N,) and (N, 3)
    tensors, the material by id."""
    valid: torch.Tensor       # (N,) bool
    t: torch.Tensor           # (N,)
    p: torch.Tensor           # (N, 3)
    normal: torch.Tensor      # (N, 3) unit, flipped against the ray
    front_face: torch.Tensor  # (N,) bool
    uv: torch.Tensor          # (N, 2)
    mat_id: torch.Tensor      # (N,) int32


def chunk_size(n_rays: int, device) -> int:
    """Primitives per chunk: at most ``PAIRS`` pairs of ``device``."""
    pairs = PAIRS.get(torch.device(device).type, PAIRS["cpu"])
    return max(1, pairs // max(n_rays, 1))


def _col(x):
    """A float, or an (N,) tensor as an (N, 1) column."""
    return x[:, None] if torch.is_tensor(x) and x.dim() else x


def _in_range(t, t_min, t_max):
    return (t >= _col(t_min)) & (t <= _col(t_max))


def sphere_ts(o, d, center, radius, valid, t_min, t_max, velocity=None,
              time=None):
    """Nearest root in range of the half-b quadratic (sphere.rs:24-55) for
    every (ray, sphere) pair: (N, C), +inf on a miss. With ``velocity``
    (C, 3) and ``time`` (N,) the centre is c + v t, subtracted directly."""
    a = vec.dot(d, d)[:, None]
    oc = [o[:, k:k + 1] - center[None, :, k] for k in range(3)]
    if velocity is not None and time is not None:
        oc = [oc[k] - time[:, None] * velocity[None, :, k] for k in range(3)]
    half_b = d[:, 0:1] * oc[0] + d[:, 1:2] * oc[1] + d[:, 2:3] * oc[2]
    c_term = (oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2]
              - (radius * radius)[None])
    disc = half_b * half_b - a * c_term
    sqrt_d = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_a = 1.0 / a
    r1 = (-half_b - sqrt_d) * inv_a
    r2 = (-half_b + sqrt_d) * inv_a
    t = torch.where(_in_range(r1, t_min, t_max), r1,
                    torch.where(_in_range(r2, t_min, t_max), r2, torch.inf))
    return torch.where((disc >= 0.0) & valid[None], t, torch.inf)


def rect_ts(o, d, axis, k, a0, a1, b0, b1, valid, t_min, t_max):
    """Axis-aligned rectangle: plane solve and bounds test
    (rectangle.rs:15-34, 53-72, 90-109). ``axis`` is the plane's normal
    axis; (a, b) are the two in-plane axes in ascending order. (N, C)."""
    axis = axis.long()
    ax_a = torch.where(axis == 0, 1, 0)
    ax_b = torch.where(axis == 2, 1, 2)
    d_n, o_n = d[:, axis], o[:, axis]
    safe = d_n.abs() > 1e-12
    t = (k[None] - o_n) / torch.where(safe, d_n, 1.0)
    pa = o[:, ax_a] + t * d[:, ax_a]
    pb = o[:, ax_b] + t * d[:, ax_b]
    inb = ((pa >= a0[None]) & (pa <= a1[None]) & (pb >= b0[None])
           & (pb <= b1[None]))
    ok = safe & inb & _in_range(t, t_min, t_max) & valid[None]
    return torch.where(ok, t, torch.inf)


def triangle_ts(o, d, v0, e1, e2, valid, t_min, t_max):
    """Möller–Trumbore with the reference's bound checks (mesh.rs:57-98),
    in the scalar-triple-product form of the JAX package (each dot a
    product of (N, 3) and (3, C)). (N, C)."""
    n_geo = vec.cross(e1, e2)
    e2xv0 = vec.cross(e2, v0)
    e1xv0 = vec.cross(e1, v0)
    v0_n = vec.dot(v0, n_geo)
    oxd = vec.cross(o, d)
    div = -(d @ n_geo.T)
    safe = div != 0.0
    inv = 1.0 / torch.where(safe, div, 1.0)
    b1 = (oxd @ e2.T - d @ e2xv0.T) * inv
    b2 = (-(oxd @ e1.T) + d @ e1xv0.T) * inv
    t = (o @ n_geo.T - v0_n[None]) * inv
    ok = (safe & (b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
          & _in_range(t, t_min, t_max) & valid[None])
    return torch.where(ok, t, torch.inf)


def _scan(tile, n_prims: int, o):
    """Reduce ``tile(lo, hi) -> (N, hi - lo)`` over chunks of primitives to
    per-ray (best t, best index)."""
    n = o.shape[0]
    best_t = torch.full((n,), torch.inf, device=o.device)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    step = chunk_size(n, o.device)
    for lo in range(0, n_prims, step):
        ts = tile(lo, min(lo + step, n_prims))
        ci = ts.argmin(1)                      # the first of equal minima
        ct = ts.gather(1, ci[:, None])[:, 0]
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_i = torch.where(better, (ci + lo).to(torch.int32), best_i)
    return best_t, best_i


def sphere_closest(o, d, spheres, t_min, t_max, time=None):
    moving = bool(spheres.motion_marker.shape[0]) and time is not None
    c, r, ok = spheres.center, spheres.radius, spheres.mat_id >= 0
    return _scan(lambda lo, hi: sphere_ts(
        o, d, c[lo:hi], r[lo:hi], ok[lo:hi], t_min, t_max,
        spheres.velocity[lo:hi] if moving else None,
        time if moving else None), r.shape[0], o)


def rect_closest(o, d, rects, t_min, t_max):
    ok = rects.mat_id >= 0
    return _scan(lambda lo, hi: rect_ts(
        o, d, *(x[lo:hi] for x in (rects.axis, rects.k, rects.a0, rects.a1,
                                   rects.b0, rects.b1, ok)), t_min, t_max),
        rects.k.shape[0], o)


def triangle_closest(o, d, tris, t_min, t_max):
    ok = tris.mat_id >= 0
    return _scan(lambda lo, hi: triangle_ts(
        o, d, tris.v0[lo:hi], tris.e1[lo:hi], tris.e2[lo:hi], ok[lo:hi],
        t_min, t_max), tris.mat_id.shape[0], o)


def intersect_bruteforce(scene: Scene, o, d, t_min, t_max, time=None,
                         alive=None) -> Hit:
    """Closest hit of rays ``o``/``d`` (N, 3) over every primitive table:
    spheres, then rects, then triangles, a later table winning only on a
    strictly smaller t. ``time`` (N,): the rays' shutter times (moving
    spheres at c + v t). ``alive`` (N,) bool: lanes outside it miss."""
    n = o.shape[0]
    best_t = torch.full((n,), torch.inf, device=o.device)
    best_ty = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    best_ix = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    for count, closest, code in (
            (scene.spheres.radius.shape[0], lambda: sphere_closest(
                o, d, scene.spheres, t_min, t_max, time), PRIM_SPHERE),
            (scene.rects.k.shape[0], lambda: rect_closest(
                o, d, scene.rects, t_min, t_max), PRIM_RECT),
            (scene.triangles.mat_id.shape[0], lambda: triangle_closest(
                o, d, scene.triangles, t_min, t_max), PRIM_TRIANGLE)):
        if count:
            t, i = closest()
            better = t < best_t
            best_t = torch.where(better, t, best_t)
            best_ty = torch.where(better, code, best_ty)
            best_ix = torch.where(better, i, best_ix)
    if alive is not None:
        best_t = torch.where(alive, best_t, torch.inf)
        best_ty = torch.where(alive, best_ty, -1)
        best_ix = torch.where(alive, best_ix, -1)
    return Hit(best_t, best_ty, best_ix)


def tri_barycentrics(tris, i, o, d):
    """(b1, b2) of rays ``o``/``d`` (N, 3) against triangles ``i`` (N,)
    (mesh.rs:69-104), recomputed for the winner as the JAX package does."""
    v0, e1, e2 = tris.v0[i], tris.e1[i], tris.e2[i]
    s0 = vec.cross(d, e2)
    div = vec.dot(s0, e1)
    inv = 1.0 / torch.where(div != 0.0, div, 1.0)
    dv = o - v0
    b1 = vec.dot(dv, s0) * inv
    b2 = vec.dot(d, vec.cross(dv, e1)) * inv
    return b1, b2


def sphere_uv(n_out):
    """Spherical (u, v) of outward unit normals (sphere.rs:16-21)."""
    theta = torch.arccos(torch.clamp(-n_out[..., 1], -1.0, 1.0))
    phi = torch.atan2(-n_out[..., 2], n_out[..., 0]) + PI
    return torch.stack([phi / (2.0 * PI), theta / PI], -1)


def hit_attributes(scene: Scene, o, d, hit: Hit, time=None) -> HitAttrs:
    """The HitRecord of each ray's winner: point, normal flipped against
    the ray (hit.rs:24-30), front face, uv and material. ``time`` (N,):
    the shutter times at which a moving sphere's centre is taken."""
    n = o.shape[0]
    valid = torch.isfinite(hit.t)
    p = o + torch.where(valid, hit.t, 0.0)[:, None] * d
    n_out = torch.zeros((n, 3), device=o.device)
    uv = torch.zeros((n, 2), device=o.device)
    mat_id = torch.zeros((n,), dtype=torch.int32, device=o.device)
    idx = hit.prim_idx.long()

    s = scene.spheres
    if s.radius.shape[0]:
        i = idx.clamp(0, s.radius.shape[0] - 1)
        c = s.center[i]
        if s.motion_marker.shape[0] and time is not None:
            c = c + s.velocity[i] * time[:, None]
        no = (p - c) / s.radius[i][:, None]
        sel = hit.prim_type == PRIM_SPHERE
        n_out = torch.where(sel[:, None], no, n_out)
        uv = torch.where(sel[:, None], sphere_uv(no), uv)
        mat_id = torch.where(sel, s.mat_id[i], mat_id)

    r = scene.rects
    if r.k.shape[0]:
        i = idx.clamp(0, r.k.shape[0] - 1)
        axis = r.axis[i].long()
        no = torch.nn.functional.one_hot(axis, 3).to(p.dtype)
        ax_a = torch.where(axis == 0, 1, 0)
        ax_b = torch.where(axis == 2, 1, 2)
        pa = p.gather(1, ax_a[:, None])[:, 0]
        pb = p.gather(1, ax_b[:, None])[:, 0]
        ruv = torch.stack([(pa - r.a0[i]) / (r.a1[i] - r.a0[i]),
                           (pb - r.b0[i]) / (r.b1[i] - r.b0[i])], -1)
        sel = hit.prim_type == PRIM_RECT
        n_out = torch.where(sel[:, None], no, n_out)
        uv = torch.where(sel[:, None], ruv, uv)
        mat_id = torch.where(sel, r.mat_id[i], mat_id)

    tr = scene.triangles
    if tr.mat_id.shape[0]:
        i = idx.clamp(0, tr.mat_id.shape[0] - 1)
        b1, b2 = tri_barycentrics(tr, i, o, d)
        b0 = 1.0 - b1 - b2
        no = vec.unit(b0[:, None] * tr.n0[i] + b1[:, None] * tr.n1[i]
                      + b2[:, None] * tr.n2[i])
        sel = hit.prim_type == PRIM_TRIANGLE
        n_out = torch.where(sel[:, None], no, n_out)
        uv = torch.where(sel[:, None], 0.0, uv)      # mesh.rs:130-136
        mat_id = torch.where(sel, tr.mat_id[i], mat_id)

    front = vec.dot(d, n_out) < 0.0
    normal = vec.unit(torch.where(front[:, None], n_out, -n_out))
    return HitAttrs(valid, hit.t, p, normal, front, uv, mat_id)
