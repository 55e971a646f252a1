"""Constant-density participating media (medium.rs:26-53): the
counterpart of ``raytracer_tpu/ops/media.py``.

Media are a table of analytic sphere or box boundaries
(``scene.types.Media``), not geometry. After a bounce's closest hit, each
ray draws one exponential free-flight distance per medium,
``hit_distance = -1/density * ln(u)`` (medium.rs:41), measured from where
the ray enters the medium (no earlier than t_min) and valid while it lies
inside the medium and before the geometric hit. The nearest such event
replaces the hit: its material is the medium's isotropic phase material,
its normal the dummy (1, 0, 0) of medium.rs:45 and its uv (0, 0).

The free-flight uniforms are an input, one (K, N) block in [1e-12, 1)
(``uniform_rows`` maps the loops' draws there), so that a test can feed the
JAX package's own draws (its ``jax.random.uniform(fold_in(key, 29), (N, K),
minval=1e-12)``, transposed).

- ``apply_media`` overrides the (N, 3) route's ``HitAttrs``
  (``ops/intersect.py``), as the brute-force loop of
  ``models/path_tracer.py`` needs;
- ``apply_media_soa`` overrides a closest-hit winner
  (``closest_hit.Closest``) on (3, N) rays: a medium event becomes a
  ``PRIM_MEDIA`` winner whose index is the medium's, which
  ``wavefront_soa.attrs_soa`` turns into the medium's material
  (``BounceTables.med_mat``) with the dummy normal.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops.closest_hit import Closest
from raytracer_tpu_torch.ops.intersect import HitAttrs
from raytracer_tpu_torch.scene.types import PRIM_MEDIA, Media

MEDIUM_SPHERE = 0
MEDIUM_BOX = 1
U_MIN = 1e-12           # the JAX draw's minval: ln(u) stays finite
BIG = 3e38


def uniform_rows(u):
    """Uniform rows in [0, 1) mapped onto [1e-12, 1), as JAX maps a draw
    onto [minval, maxval)."""
    return torch.clamp(u * (1.0 - U_MIN) + U_MIN, min=U_MIN)


def _boundary_window(media: Media, o, d):
    """Entry and exit parameters (t_enter, t_exit) of every ray with every
    medium's boundary, and whether the ray crosses it: each (N, K), for
    rays ``o``/``d`` (N, 3)."""
    oc = o[:, None, :] - media.p0[None]                  # (N, K, 3)
    a = (d * d).sum(-1)[:, None]
    half_b = (oc * d[:, None, :]).sum(-1)
    c = (oc * oc).sum(-1) - (media.r0 * media.r0)[None]
    disc = half_b * half_b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    s_enter = (-half_b - sq) / a
    s_exit = (-half_b + sq) / a
    s_ok = disc > 0.0
    # box slabs; a zero direction component gives +-BIG (+BIG for 0)
    inv_d = torch.where(d.abs() > 1e-20, 1.0 / d,
                        torch.sign(d) * BIG + BIG)
    t0 = (media.p0[None] - o[:, None, :]) * inv_d[:, None, :]
    t1 = (media.p1[None] - o[:, None, :]) * inv_d[:, None, :]
    b_enter = torch.minimum(t0, t1).amax(-1)
    b_exit = torch.maximum(t0, t1).amin(-1)
    b_ok = b_exit > b_enter
    is_sphere = (media.kind == MEDIUM_SPHERE)[None]
    return (torch.where(is_sphere, s_enter, b_enter),
            torch.where(is_sphere, s_exit, b_exit),
            torch.where(is_sphere, s_ok, b_ok))


def events(media: Media, u, o, d, t_geom, t_min: float):
    """The nearest medium event of each ray ``o``/``d`` (N, 3) before its
    geometric hit ``t_geom`` (N,) (+inf on a miss), from free-flight
    uniforms ``u`` (K, N). Returns (t (N,) +inf where no event, medium
    index (N,) int64, event (N,) bool)."""
    enter, exit_, ok = _boundary_window(media, o, d)
    # clamp like the reference: rec1.t >= t_min, rec2.t <= geometric hit
    enter = torch.clamp(enter, min=t_min)
    exit_ = torch.minimum(exit_, t_geom[:, None])
    ok = ok & (exit_ > enter)
    d_len = torch.sqrt((d * d).sum(-1))[:, None]
    dist_inside = (exit_ - enter) * d_len
    hit_dist = media.neg_inv_density[None] * torch.log(u.T)  # medium.rs:41
    scatters = ok & (hit_dist < dist_inside)
    t_med = torch.where(scatters,
                        enter + hit_dist / torch.clamp(d_len, min=1e-20),
                        torch.inf)
    j = t_med.argmin(1)                                   # nearest medium
    t_best = t_med.gather(1, j[:, None])[:, 0]
    return t_best, j, torch.isfinite(t_best)


def apply_media(media: Media, u, o, d, attrs: HitAttrs,
                t_min: float) -> HitAttrs:
    """Override the geometric hit ``attrs`` of rays ``o``/``d`` (N, 3)
    wherever a medium event comes first (JAX ``apply_media``)."""
    if media is None or media.kind.shape[0] == 0:
        return attrs
    t_geom = torch.where(attrs.valid, attrs.t, torch.inf)
    t_best, j, use = events(media, u, o, d, t_geom, t_min)
    p = o + t_best[:, None] * d
    dummy = (torch.arange(3, device=o.device) == 0).to(o.dtype).expand_as(o)
    u2 = use[:, None]
    return HitAttrs(
        valid=attrs.valid | use,
        t=torch.where(use, t_best, attrs.t),
        p=torch.where(u2, p, attrs.p),
        normal=torch.where(u2, dummy, attrs.normal),
        front_face=attrs.front_face | use,
        uv=torch.where(u2, 0.0, attrs.uv),
        mat_id=torch.where(use, media.mat_id[j], attrs.mat_id))


def apply_media_soa(media: Media, u, o, d, hit: Closest,
                    t_min: float) -> Closest:
    """Override the closest-hit winner ``hit`` of rays ``o``/``d`` (3, N)
    wherever a medium event comes first (JAX ``apply_media_soa``): there
    the winner becomes (t, ``PRIM_MEDIA``, medium index, 0, 0)."""
    t_best, j, use = events(media, u, o.T, d.T, hit.t, t_min)
    return Closest(torch.where(use, t_best, hit.t),
                   torch.where(use, PRIM_MEDIA, hit.ty).to(torch.int32),
                   torch.where(use, j.to(torch.int32), hit.ix),
                   torch.where(use, 0.0, hit.b1),
                   torch.where(use, 0.0, hit.b2))
