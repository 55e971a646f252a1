"""Next-event estimation for the path tracer's ``--nee`` mode: the
counterpart of ``raytracer_tpu/ops/nee.py::direct_light``, on (3, N) rows.

At each diffuse vertex a lane picks ONE light by the power-proportional
categorical and casts one shadow ray toward a point sampled on it; the
contribution is weighted by 1/prob, so its mean is the sum over lights:

    L_d = Le * (albedo/pi) * cos(theta) * cos(theta') / r^2 / pdf_area / prob

with pdf_area = 1/A (rect) or 1/(2 pi r0^2) (sphere, hemisphere facing the
shading point). The tracer skips emission on rays that left a diffuse
vertex, so light is counted once. The reference's quirks are kept:

- the geometry (distance and both cosines) is measured from the TRUE
  surface point; only the shadow ray's origin is offset, by
  ``eps_sh = min(1e-4 * scale, 0.1 * dist)`` along the normal;
- the shadow ray keeps the absolute ``t_min = 1e-3`` and ends at
  ``t_max = 0.999 * dist_sh`` (strictly below it, the closest-hit rule);
- rect lights emit two-sided, so their cosine is |cos|;
- no light table (zero lights) gives zero direct light;
- with motion blur the shadow ray carries its lane's shutter time, and a
  moving light is sampled at its centre p0 + vel * t (JAX
  ``nee.py:148-153, 211-216``).

The estimator is split in two so that a test can feed it the JAX package's
own draws: ``nee_draws`` turns uniform rows into (light index, uniforms),
and ``direct_light_from`` is a deterministic function of those, the
shading point and the tables.

``sample_li`` is the reference's own estimator (light.rs:107-124, 170-183;
never called by its integrators), on (N, 3) rows as in the JAX package:
``n_samples`` shadow rays a point, each toward one light picked by power
and weighted by 1/prob, from the TRUE surface point with the window
(1e-4, max(dist - 1e-4, 1e-4)), contribution flux x bsdf x max(0, n . dir)
with no distance falloff (light.rs:120 is commented out).
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops import dispatch, materials, vec
from raytracer_tpu_torch.ops.intersect import HitAttrs
from raytracer_tpu_torch.ops.lights import light_cols, pick_light
from raytracer_tpu_torch.ops.sampling import uniform_hemisphere, unit
from raytracer_tpu_torch.scene.types import LIGHT_SPHERE, Scene

PI = 3.141592653589793
NEE_ROWS = 5            # uniform rows per step: pick, hemisphere (2), rect uv
SHADOW_T_MIN = 1e-3     # absolute, as in the JAX package (ROADMAP C)
SHADOW_T_MAX_REL = 0.999


def nee_draws(lights, rows):
    """The draw step: (light index (N,) int64, uniforms (4, N)) from
    ``NEE_ROWS`` uniform rows: row 0 picks the light, rows 1-2 the
    hemisphere point of a sphere light, rows 3-4 the uv of a rect light."""
    return pick_light(lights, rows[0]), rows[1:NEE_ROWS]


def direct_light_from(scene: Scene, tables, idx, uni, p, normal, albedo,
                      valid, alive=None, intersector: str = "pallas",
                      time=None):
    """The deterministic part of NEE. ``idx`` (N,) light per lane, ``uni``
    (4, N) as ``nee_draws`` makes them; ``p``, ``normal``, ``albedo`` (3, N)
    rows of the shading point; ``valid`` (N,) bool: the lanes that shade
    (diffuse vertices); ``alive`` (N,) bool or None. ``tables``:
    ``fused_bounce.pack_tables`` of ``scene`` for the shadow rays, which
    take the render's ``intersector`` route (``dispatch.intersect_scene``,
    as JAX ``nee.py:213-214``) at the lanes' shutter ``time`` (N,) if
    given.

    Returns (direct radiance (3, N), the lanes that cast a shadow ray (N,)
    bool)."""
    lights = scene.lights
    n = p.shape[1]
    if lights.kind.shape[0] == 0:
        return (torch.zeros((3, n), device=p.device),
                torch.zeros((n,), dtype=torch.bool, device=p.device))
    inv_prob = torch.exp(-lights.log_prob)[idx]
    is_sph = lights.kind[idx] == LIGHT_SPHERE
    p0 = light_cols(lights.p0, idx)
    if time is not None:
        p0 = p0 + light_cols(lights.vel, idx) * time
    p1 = light_cols(lights.p1, idx)
    r0 = lights.r0[idx]
    flux = light_cols(lights.flux, idx)

    # sphere: uniform point on the hemisphere facing the shading point
    sph_pt = p0 + uniform_hemisphere(uni[0], uni[1], unit(p - p0)) * r0
    sph_n = unit(sph_pt - p0)
    sph_inv_pdf = 2.0 * PI * r0 * r0
    # rect (XZ plane at y = p0.y, normal facing down, light.rs:158-166)
    rect_pt = torch.stack([p0[0] + (p1[0] - p0[0]) * uni[2], p0[1],
                           p0[2] + (p1[2] - p0[2]) * uni[3]])
    rect_n = torch.tensor([0.0, -1.0, 0.0], device=p.device)[:, None]
    rect_inv_pdf = torch.abs((p1[0] - p0[0]) * (p1[2] - p0[2]))
    point = torch.where(is_sph, sph_pt, rect_pt)
    n_l = torch.where(is_sph, sph_n, rect_n)
    inv_pdf = torch.where(is_sph, sph_inv_pdf, rect_inv_pdf)

    # geometry from the true surface point
    to_light = point - p
    dist2 = torch.clamp((to_light * to_light).sum(0), min=1e-12)
    dist = torch.sqrt(dist2)
    dir_ = to_light / dist
    cos_p = torch.clamp((normal * dir_).sum(0), min=0.0)
    cos_lr = (n_l * -dir_).sum(0)
    cos_l = torch.where(is_sph, torch.clamp(cos_lr, min=0.0), cos_lr.abs())
    geom = cos_p * cos_l / dist2 * inv_pdf
    candidate = valid & (geom > 0.0)

    # the shadow ray: offset origin, absolute t_min, strict 0.999 * dist end
    eps_sh = torch.minimum(1e-4 * scene.scale, 0.1 * dist)
    p_sh = p + normal * eps_sh
    to_sh = point - p_sh
    dist_sh = torch.sqrt(torch.clamp((to_sh * to_sh).sum(0), min=1e-12))
    dir_sh = to_sh / dist_sh
    cast = candidate if alive is None else candidate & alive
    hit = dispatch.intersect_scene(
        scene, p_sh.contiguous(), dir_sh.contiguous(), SHADOW_T_MIN,
        (dist_sh * SHADOW_T_MAX_REL).contiguous(), method=intersector,
        alive=cast.contiguous(), tables=tables, time=time)
    visible = ~torch.isfinite(hit.t)
    contrib = flux * inv_prob * (albedo / PI) * geom
    return torch.where(visible & candidate, contrib, 0.0), cast


def direct_light(scene: Scene, tables, rows, p, normal, albedo, valid,
                 alive=None, intersector: str = "pallas", time=None):
    """NEE from ``NEE_ROWS`` uniform rows (``nee_draws`` then
    ``direct_light_from``). Returns (direct radiance (3, N), shadow-ray
    lanes (N,) bool)."""
    idx, uni = nee_draws(scene.lights, rows)
    return direct_light_from(scene, tables, idx, uni, p, normal, albedo,
                             valid, alive, intersector, time)


def sample_li(scene: Scene, attrs: HitAttrs, n_samples: int = 4,
              intersector: str = "auto", gen: torch.Generator = None,
              rows=None, tables=None):
    """Direct radiance (N, 3) at each shading point of ``attrs`` (JAX
    ``sample_li``): the mean over ``n_samples`` of flux / prob x bsdf x
    max(0, n . dir) where the shadow ray reaches the light. The uniforms
    are ``rows`` (n_samples, NEE_ROWS, N), laid out as ``nee_draws``
    takes them (pick, hemisphere pair, rect uv), or drawn from ``gen``.
    The shadow rays take ``intersector``'s route (``tables``:
    ``pack_tables`` of the scene, if any)."""
    n = attrs.p.shape[0]
    dev = attrs.p.device
    lights = scene.lights
    if lights.kind.shape[0] == 0:
        return torch.zeros((n, 3), device=dev)
    if rows is None:
        rows = torch.rand((n_samples, NEE_ROWS, n), generator=gen,
                          device=dev)
    bsdf = materials.bsdf(scene, attrs.mat_id, attrs.p, attrs.uv)
    p_t = attrs.p.T
    total = torch.zeros((n, 3), device=dev)
    for s in range(n_samples):
        idx, uni = nee_draws(lights, rows[s])
        inv_prob = torch.exp(-lights.log_prob)[idx]
        p0 = lights.p0[idx]
        p1 = lights.p1[idx]
        # sphere light: hemisphere toward the shading point (light.rs:110-113)
        sph_pt = p0 + uniform_hemisphere(
            uni[0], uni[1], unit(p_t - p0.T)).T * lights.r0[idx][:, None]
        # rect light: a uniform point of its area (light.rs:148-154)
        rect_pt = torch.stack([p0[:, 0] + (p1[:, 0] - p0[:, 0]) * uni[2],
                               p0[:, 1],
                               p0[:, 2] + (p1[:, 2] - p0[:, 2]) * uni[3]], -1)
        point = torch.where((lights.kind[idx] == LIGHT_SPHERE)[:, None],
                            sph_pt, rect_pt)
        to_light = point - attrs.p
        dist = torch.sqrt(vec.dot(to_light, to_light))
        dir_ = to_light / torch.clamp(dist, min=1e-12)[:, None]
        hit = dispatch.intersect_scene(
            scene, p_t.contiguous(), dir_.T.contiguous(), 1e-4,
            torch.clamp(dist - 1e-4, min=1e-4).contiguous(),
            method=intersector, tables=tables)
        visible = ~torch.isfinite(hit.t)
        cos_term = torch.clamp(vec.dot(attrs.normal, dir_), min=0.0)
        contrib = (lights.flux[idx] * inv_prob[:, None] * bsdf
                   * cos_term[:, None])
        total = total + torch.where((visible & attrs.valid)[:, None],
                                    contrib, 0.0)
    return total / n_samples
