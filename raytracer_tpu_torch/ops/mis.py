"""Mixture-PDF importance sampling at diffuse vertices (``--mis``): the
counterpart of ``raytracer_tpu/ops/mis.py``, on (3, N) rows.

With probability 1/2 a diffuse bounce keeps its cosine-sampled direction,
else it takes a direction toward a power-picked light (a uniform direction
in the cone subtending a sphere light, a uniform point of a rect light).
The attenuation is reweighted by pdf_cos / pdf_mix, with

    pdf_mix(d) = 0.5 * pdf_cos(d) + 0.5 * sum_j prob_j * pdf_j(d),

so the estimator keeps plain PT's mean. No shadow rays: the bounce ray
itself resolves occlusion. ``light_pdf`` evaluates every light for every
lane in closed form, in lane chunks of at most ``PDF_PAIRS`` (lane, light)
pairs, so its temporaries stay bounded (at 480,000 lanes x 501 lights a
single (N, L) f32 temporary would take 0.96 GB).

Each function is split into a draw step (``mis_draws``: uniform rows into a
light index and uniforms) and a deterministic part, so that a test can feed
the JAX package's own draws.

Motion blur: with a lane's shutter ``time``, a moving light is evaluated
at its centre p0 + vel * t (JAX ``mis._light_centers``). ``light_pdf``
forms per-lane centres, inside its lane chunks, only when some light
moves: at 480,000 lanes x 501 lights an (N, L, 3) tensor would take
2.9 GB.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.ops.lights import light_cols, pick_light
from raytracer_tpu_torch.ops.sampling import unit
from raytracer_tpu_torch.scene.types import LIGHT_SPHERE

PI = 3.141592653589793
TWO_PI = 6.283185307179586
MIS_ROWS = 4            # uniform rows per step: choice, pick, u1, u2
PDF_PAIRS = 1 << 26     # (lane, light) pairs per chunk of ``light_pdf``


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def mis_draws(lights, rows):
    """The draw step: (choice uniform (N,), light index (N,) int64, u1, u2)
    from ``MIS_ROWS`` uniform rows."""
    return rows[0], pick_light(lights, rows[1]), rows[2], rows[3]


def lights_move(lights) -> bool:
    """Does any light have a non-zero velocity? (One host read.)"""
    return bool(lights.vel.shape[0]) and bool((lights.vel != 0).any())


def sample_light_dir_from(lights, idx, u1, u2, p, time=None):
    """One unit direction (3, N) from ``p`` toward light ``idx`` of each
    lane: uniform in the cone subtending a sphere light, toward a uniform
    point of a rect light. ``time`` (N,): the lanes' shutter times, at
    which the lights' centres are taken."""
    c = light_cols(lights.p0, idx)
    if time is not None:
        c = c + light_cols(lights.vel, idx) * time
    p1 = light_cols(lights.p1, idx)
    r = lights.r0[idx]

    # sphere: uniform direction in the cone subtending the sphere
    to_c = c - p
    dist2 = torch.clamp((to_c * to_c).sum(0), min=1e-12)
    axis = to_c / torch.sqrt(dist2)
    cos_max = torch.sqrt(torch.clamp(1.0 - r * r / dist2, 0.0, 1.0))
    z = 1.0 + u1 * (cos_max - 1.0)
    phi = TWO_PI * u2
    s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    side = torch.tensor([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]],
                        device=p.device)
    h = torch.where(axis[0].abs() > 0.9, side[0][:, None], side[1][:, None])
    t1 = unit(_cross(axis, h), eps=1e-30)
    t2 = _cross(axis, t1)
    d_sph = axis * z + t1 * (s * torch.cos(phi)) + t2 * (s * torch.sin(phi))

    # rect: uniform point of the XZ rect (p0..p1 at y = p0.y)
    pt = torch.stack([c[0] + (p1[0] - c[0]) * u1, c[1],
                      c[2] + (p1[2] - c[2]) * u2])
    d_rect = unit(pt - p)
    return torch.where(lights.kind[idx] == LIGHT_SPHERE, d_sph, d_rect)


def light_pdf(lights, p, d, time=None):
    """Solid-angle pdf (N,) of ``sample_light_dir_from`` producing unit
    direction ``d`` (3, N) from ``p`` (3, N): the power-weighted mixture
    over all lights, in closed form, evaluated in lane chunks of at most
    ``PDF_PAIRS`` (lane, light) pairs. ``time`` (N,): the lanes' shutter
    times; a moving sphere light's cone is taken at its centre then (rect
    lights stay where they are, as in JAX)."""
    n = p.shape[1]
    n_lights = lights.kind.shape[0]
    out = torch.zeros((n,), device=p.device)
    if n_lights == 0:
        return out
    is_sph = lights.kind == LIGHT_SPHERE                     # (L,)
    cx, cy, cz = lights.p0.T                                 # (L,) each
    moves = time is not None and lights_move(lights)
    r2 = lights.r0 * lights.r0
    x0 = torch.minimum(lights.p0[:, 0], lights.p1[:, 0])
    x1 = torch.maximum(lights.p0[:, 0], lights.p1[:, 0])
    z0 = torch.minimum(lights.p0[:, 2], lights.p1[:, 2])
    z1 = torch.maximum(lights.p0[:, 2], lights.p1[:, 2])
    area = torch.clamp((x1 - x0) * (z1 - z0), min=1e-12)
    step = max(1, PDF_PAIRS // n_lights)
    for a in range(0, n, step):
        px, py, pz = (x[a:a + step, None] for x in p)        # (m, 1)
        dx, dy, dz = (x[a:a + step, None] for x in d)
        # sphere j: inside the cone of half-angle acos(cos_max)?
        if moves:
            tm = time[a:a + step, None]
            tcx, tcy, tcz = ((c + v * tm) - q for c, v, q in
                             zip((cx, cy, cz), lights.vel.T, (px, py, pz)))
        else:
            tcx, tcy, tcz = cx - px, cy - py, cz - pz        # (m, L)
        dist2 = torch.clamp(tcx * tcx + tcy * tcy + tcz * tcz, min=1e-12)
        cos_max = torch.sqrt(torch.clamp(1.0 - r2 / dist2, 0.0, 1.0))
        cos_d = (tcx * dx + tcy * dy + tcz * dz) / torch.sqrt(dist2)
        del tcx, tcy, tcz, dist2
        pdf = torch.where(
            cos_d >= cos_max,
            1.0 / (TWO_PI * torch.clamp(1.0 - cos_max, min=1e-8)), 0.0)
        del cos_d, cos_max
        # rect j: the direction pierces the XZ plane inside the bounds
        t = (cy - py) / torch.where(dy.abs() < 1e-9, 1e-9, dy)
        hx = px + t * dx
        hz = pz + t * dz
        on_rect = ((t > 1e-4) & (hx >= x0) & (hx <= x1) & (hz >= z0)
                   & (hz <= z1))
        del hx, hz
        pdf_rect = torch.where(
            on_rect, t * t / (torch.clamp(dy.abs(), min=1e-8) * area), 0.0)
        pdf = torch.where(is_sph, pdf, pdf_rect)
        del t, on_rect, pdf_rect
        out[a:a + step] = (lights.prob * pdf).sum(-1)
    return out


def mixture_reweight_from(lights, u_choice, idx, u1, u2, p, normal, d_cos,
                          diffuse, time=None):
    """The deterministic part of the ``--mis`` resample: (d_new (3, N), w
    (N,)). ``d_new`` replaces the scatter direction on diffuse lanes (the
    light direction where ``u_choice < 0.5``, else the unit cosine
    direction); ``w`` = pdf_cos / pdf_mix multiplies the attenuation there
    and is 1 on other lanes. ``time``: the lanes' shutter times."""
    d_unit = unit(d_cos, eps=1e-30)
    if lights.kind.shape[0] == 0:
        return d_unit, torch.ones_like(d_unit[0])
    d_light = sample_light_dir_from(lights, idx, u1, u2, p, time)
    d_new = torch.where((u_choice < 0.5) & diffuse, d_light, d_unit)
    pdf_cos = torch.clamp((normal * d_new).sum(0), min=0.0) / PI
    pdf_mix = 0.5 * pdf_cos + 0.5 * light_pdf(lights, p, d_new, time)
    w = torch.where(pdf_mix > 1e-12,
                    pdf_cos / torch.clamp(pdf_mix, min=1e-12), 0.0)
    return d_new, torch.where(diffuse, w, 1.0)


def mixture_reweight(lights, rows, p, normal, d_cos, diffuse, time=None):
    """The ``--mis`` resample from ``MIS_ROWS`` uniform rows (``mis_draws``
    then ``mixture_reweight_from``)."""
    return mixture_reweight_from(lights, *mis_draws(lights, rows), p, normal,
                                 d_cos, diffuse, time)
