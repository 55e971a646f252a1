"""The reference's transport in plain PyTorch: closest hits by brute force
over every primitive, the materials of material.rs, thin-lens camera rays,
and three walks of a camera path:

- ``"pt"``: the path tracer. Le at every hit, diffuse, specular and
  dielectric bounces, at most ``max_depth`` hits; with ``nee`` the
  emission of a hit reached from a diffuse vertex is skipped and each
  diffuse vertex adds one shadow ray's direct light (one light picked in
  proportion to its power; a sphere light sampled uniformly on the
  hemisphere facing the point, a rect light uniformly on its area; the
  geometry from the true point, the shadow ray from the point offset by
  min(1e-4 scale, 0.1 dist) along the normal, between 1e-3 and 0.999 of
  its length); with ``russian_roulette`` a path past its third bounce
  survives with probability clamp(max throughput, 0.05, 1).
- ``"gather"``: the SPPM final gather (photon_mapper.rs:326-365): Le at
  every hit, and at the first diffuse hit the pixel's density estimate,
  where the path stops.

Random numbers come from one ``torch.Generator``; the arithmetic runs in
the scene's dtype (float64 for the reference, lower for the control)."""

from __future__ import annotations

import math

import torch

from reference.scenes import (
    CHECKER, LAMBERTIAN, LIGHT, METAL, SPHERE_LIGHT, RefScene,
)

DIFFUSE, SPECULAR, ABSORB, REFLECT, REFRACT = range(5)
RR_START = 3
NEE_EPS_REL, SHADOW_T_MIN, SHADOW_T_MAX_REL = 1e-4, 1e-3, 0.999
CHUNK_PAIRS = 1 << 25      # (ray, primitive) pairs per intersection block


def dot(a, b):
    return (a * b).sum(-1)


def unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                    keepdim=True), min=1e-30)


def uniform_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    phi = 2.0 * math.pi * u2
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def _sphere_t(sc: RefScene, o, d, t_min, t_max):
    c, r = sc.sph_c, sc.sph_r
    a = dot(d, d)[:, None]
    half_b = dot(o, d)[:, None] - d @ c.T                     # d . (o - c)
    cterm = (dot(o, o)[:, None] - 2.0 * (o @ c.T) + dot(c, c)[None]
             - (r * r)[None])                                  # |o - c|^2 - r^2
    disc = half_b * half_b - a * cterm
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-half_b - sq) / a
    t2 = (-half_b + sq) / a
    t = torch.where(t1 > t_min, t1, t2)
    return torch.where((disc > 0) & (t > t_min) & (t < t_max), t, math.inf)


def _rect_t(sc: RefScene, o, d, t_min, t_max):
    ax = sc.rect_axis
    a_ax = torch.where(ax == 0, 1, 0)
    b_ax = torch.where(ax == 2, 1, 2)
    da = d[:, ax]
    safe = da != 0
    t = (sc.rect_k[None] - o[:, ax]) / torch.where(safe, da, 1.0)
    pa = o[:, a_ax] + t * d[:, a_ax]
    pb = o[:, b_ax] + t * d[:, b_ax]
    ok = (safe & (t > t_min) & (t < t_max)
          & (pa >= sc.rect_lo[None, :, 0]) & (pa <= sc.rect_hi[None, :, 0])
          & (pb >= sc.rect_lo[None, :, 1]) & (pb <= sc.rect_hi[None, :, 1]))
    return torch.where(ok, t, math.inf)


def _tri_t(sc: RefScene, o, d, t_min, t_max):
    """Moeller-Trumbore: (t, b1, b2), each (N, T)."""
    e1, e2 = sc.tri_e1[None], sc.tri_e2[None]
    pvec = torch.linalg.cross(d[:, None].expand(-1, e2.shape[1], -1),
                              e2.expand(d.shape[0], -1, -1), dim=-1)
    det = dot(pvec, e1)
    safe = det.abs() > 1e-12
    inv = 1.0 / torch.where(safe, det, 1.0)
    tvec = o[:, None] - sc.tri_v0[None]
    b1 = dot(tvec, pvec) * inv
    qvec = torch.linalg.cross(tvec, e1.expand(d.shape[0], -1, -1), dim=-1)
    b2 = dot(d[:, None], qvec) * inv
    t = dot(e2, qvec) * inv
    ok = (safe & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1) & (t > t_min)
          & (t < t_max))
    return torch.where(ok, t, math.inf), b1, b2


def closest(sc: RefScene, o, d, t_min, t_max=math.inf):
    """The closest hit of rays ``o``, ``d`` (N, 3) in (t_min, t_max):
    (t (N,), +inf on a miss; kind 0 sphere, 1 rect, 2 triangle; index;
    the triangle's barycentrics b1, b2)."""
    parts, bary = [], None
    if sc.sph_r.shape[0]:
        parts.append(_sphere_t(sc, o, d, t_min, t_max))
    if sc.rect_k.shape[0]:
        parts.append(_rect_t(sc, o, d, t_min, t_max))
    if sc.tri_m.shape[0]:
        tt, b1, b2 = _tri_t(sc, o, d, t_min, t_max)
        parts.append(tt)
        bary = (b1, b2)
    counts = [sc.sph_r.shape[0], sc.rect_k.shape[0], sc.tri_m.shape[0]]
    kinds = torch.cat([torch.full((n,), k, dtype=torch.int64,
                                  device=o.device)
                       for k, n in enumerate(counts) if n])
    starts = torch.tensor([0, counts[0], counts[0] + counts[1]],
                          device=o.device)
    t, j = torch.cat(parts, 1).min(1)
    kind = kinds[j]
    idx = j - starts[kind]
    b1 = b2 = None
    if bary is not None:
        ti = torch.clamp(idx, 0, counts[2] - 1)[:, None]
        b1 = bary[0].gather(1, ti)[:, 0]
        b2 = bary[1].gather(1, ti)[:, 0]
    return t, kind, idx, b1, b2


def hit(sc: RefScene, o, d, t_min):
    """Closest hits in blocks of rays: (valid, p, normal flipped against
    the ray, front face, material)."""
    n = o.shape[0]
    prims = max(1, sc.sph_r.shape[0] + sc.rect_k.shape[0]
                + sc.tri_m.shape[0])
    step = max(1024, CHUNK_PAIRS // prims)
    outs = [closest(sc, o[a:a + step], d[a:a + step], t_min)
            for a in range(0, n, step)]
    t, kind, idx = (torch.cat([x[i] for x in outs]) for i in range(3))
    valid = torch.isfinite(t)
    p = o + torch.where(valid, t, 0.0)[:, None] * d
    nrm = torch.zeros_like(p)
    mat = torch.zeros_like(idx)
    if sc.sph_r.shape[0]:
        i = torch.clamp(idx, 0, sc.sph_r.shape[0] - 1)
        sel = kind == 0
        nrm = torch.where(sel[:, None], (p - sc.sph_c[i]) / sc.sph_r[i][:, None],
                          nrm)
        mat = torch.where(sel, sc.sph_m[i], mat)
    if sc.rect_k.shape[0]:
        i = torch.clamp(idx, 0, sc.rect_k.shape[0] - 1)
        sel = kind == 1
        one = torch.nn.functional.one_hot(sc.rect_axis[i], 3).to(p.dtype)
        nrm = torch.where(sel[:, None], one, nrm)
        mat = torch.where(sel, sc.rect_m[i], mat)
    if sc.tri_m.shape[0]:
        b1 = torch.cat([x[3] for x in outs])
        b2 = torch.cat([x[4] for x in outs])
        i = torch.clamp(idx, 0, sc.tri_m.shape[0] - 1)
        sel = kind == 2
        tn = sc.tri_n[i]
        interp = ((1 - b1 - b2)[:, None] * tn[:, 0] + b1[:, None] * tn[:, 1]
                  + b2[:, None] * tn[:, 2])
        nrm = torch.where(sel[:, None], interp, nrm)
        mat = torch.where(sel, sc.tri_m[i], mat)
    front = dot(d, nrm) < 0
    nrm = unit(torch.where(front[:, None], nrm, -nrm))
    return valid, p, nrm, front, mat


def occluded(sc: RefScene, o, d, t_max):
    """Whether anything lies on each shadow ray in (SHADOW_T_MIN,
    t_max)."""
    n = o.shape[0]
    prims = max(1, sc.sph_r.shape[0] + sc.rect_k.shape[0]
                + sc.tri_m.shape[0])
    step = max(1024, CHUNK_PAIRS // prims)
    out = []
    for a in range(0, n, step):
        t = closest(sc, o[a:a + step], d[a:a + step], SHADOW_T_MIN,
                    t_max[a:a + step, None])[0]
        out.append(torch.isfinite(t))
    return torch.cat(out) if out else torch.zeros((0,), dtype=torch.bool)


def albedo(sc: RefScene, mat, p):
    c0, c1 = sc.mat_c0[mat], sc.mat_c1[mat]
    sines = (torch.sin(10.0 * p[:, 0]) * torch.sin(10.0 * p[:, 1])
             * torch.sin(10.0 * p[:, 2]))
    checker = torch.where((sines < 0)[:, None], c0, c1)
    return torch.where((sc.mat_tex[mat] == CHECKER)[:, None], checker, c0)


def reflect(v, n):
    return v - 2.0 * dot(v, n)[:, None] * n


def refract(uv, n, ratio):
    cos = torch.clamp(dot(-uv, n), max=1.0)
    perp = ratio[:, None] * (uv + cos[:, None] * n)
    par = -torch.sqrt(torch.abs(1.0 - dot(perp, perp)))[:, None] * n
    return perp + par


def scatter(sc: RefScene, u3, d, valid, p, nrm, front, mat):
    """material.rs's scatter: (interaction, direction, attenuation, Le),
    from three uniform columns ``u3`` (N, 3)."""
    kind = sc.mat_kind[mat]
    alb = albedo(sc, mat, p)
    sph = uniform_sphere(u3[:, 0], u3[:, 1])
    diff = nrm + sph
    small = (diff.abs() < 1e-8).all(-1)
    diff = torch.where(small[:, None], nrm, diff)
    unit_d = unit(d)
    refl = reflect(unit_d, nrm)
    mdir = refl + sc.mat_fuzz[mat][:, None] * sph
    m_ok = dot(mdir, nrm) > 0
    ir = torch.clamp(sc.mat_ir[mat], min=1e-6)
    ratio = torch.where(front, 1.0 / ir, ir)
    cos = torch.clamp(dot(-unit_d, nrm), max=1.0)
    sin = torch.sqrt(torch.clamp(1.0 - cos * cos, min=0.0))
    r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
    do_refl = (ratio * sin > 1.0) | (r0 + (1.0 - r0) * (1.0 - cos) ** 5
                                     > u3[:, 2])
    ddir = torch.where(do_refl[:, None], refl, refract(unit_d, nrm, ratio))
    is_light = kind == LIGHT
    diffish = (kind == LAMBERTIAN) | is_light
    direction = torch.where(diffish[:, None], diff, torch.where(
        (kind == METAL)[:, None], mdir, ddir))
    inter = torch.where(diffish, DIFFUSE, torch.where(
        kind == METAL, torch.where(m_ok, SPECULAR, ABSORB),
        torch.where(do_refl, REFLECT, REFRACT)))
    inter = torch.where(valid, inter, ABSORB)
    att = torch.where(is_light[:, None], 1.0 / math.pi, alb)
    le = torch.where((is_light & valid)[:, None], alb, 0.0)
    return inter, direction, att, le


def camera_rays(sc: RefScene, px, py, width: int, height: int, u4):
    """Jittered thin-lens rays through pixels (px, py), y flipped
    (camera.rs:57-64, 97-99)."""
    s = (px + u4[:, 0]) / (width - 1)
    t = 1.0 - (py + u4[:, 1]) / (height - 1)
    r = torch.sqrt(u4[:, 2]) * sc.lens_radius
    phi = 2.0 * math.pi * u4[:, 3]
    off = (sc.cam_lu[None] * (r * torch.cos(phi))[:, None]
           + sc.cam_lv[None] * (r * torch.sin(phi))[:, None])
    o = sc.cam_origin[None] + off
    d = (sc.cam_llc[None] + s[:, None] * sc.cam_h[None]
         + t[:, None] * sc.cam_v[None] - o)
    return o, d


def light_probs(sc: RefScene):
    power = torch.linalg.vector_norm(sc.light_power, dim=-1)
    return power / power.sum()


def direct_light(sc: RefScene, gen, p, nrm, att, diffuse, eps_scale):
    """One shadow ray's direct light at each diffuse vertex (N, 3)."""
    n = p.shape[0]
    dt, dev = p.dtype, p.device
    prob = light_probs(sc)
    u = torch.rand((n, 5), generator=gen, device=dev, dtype=dt)
    cdf = torch.cumsum(prob, 0)
    li = torch.clamp(torch.searchsorted(cdf, u[:, 0].contiguous(),
                                        right=True), max=prob.shape[0] - 1)
    inv_prob = 1.0 / prob[li]
    is_sph = sc.light_kind[li] == SPHERE_LIGHT
    p0, p1, r0 = sc.light_p0[li], sc.light_p1[li], sc.light_r[li]
    h = uniform_sphere(u[:, 1], u[:, 2])
    h = torch.where((dot(h, unit(p - p0)) > 0)[:, None], h, -h)
    sph_pt = p0 + h * r0[:, None]
    rect_pt = torch.stack([p0[:, 0] + (p1[:, 0] - p0[:, 0]) * u[:, 3],
                           p0[:, 1],
                           p0[:, 2] + (p1[:, 2] - p0[:, 2]) * u[:, 4]], -1)
    point = torch.where(is_sph[:, None], sph_pt, rect_pt)
    down = torch.zeros_like(h)
    down[:, 1] = -1.0
    n_l = torch.where(is_sph[:, None], h, down)
    inv_pdf = torch.where(is_sph, 2.0 * math.pi * r0 * r0,
                          ((p1[:, 0] - p0[:, 0])
                           * (p1[:, 2] - p0[:, 2])).abs())
    to_l = point - p
    dist2 = torch.clamp(dot(to_l, to_l), min=1e-12)
    dist = torch.sqrt(dist2)
    dir_ = to_l / dist[:, None]
    cos_p = torch.clamp(dot(nrm, dir_), min=0.0)
    cos_lr = dot(n_l, -dir_)
    cos_l = torch.where(is_sph, torch.clamp(cos_lr, min=0.0), cos_lr.abs())
    geom = cos_p * cos_l / dist2 * inv_pdf
    cand = diffuse & (geom > 0)
    eps = torch.minimum(NEE_EPS_REL * eps_scale * torch.ones_like(dist),
                        0.1 * dist)
    p_sh = p + nrm * eps[:, None]
    to_sh = point - p_sh
    dist_sh = torch.sqrt(torch.clamp(dot(to_sh, to_sh), min=1e-12))
    idx = cand.nonzero()[:, 0]
    vis = torch.zeros_like(cand)
    if idx.numel():
        vis[idx] = ~occluded(sc, p_sh[idx], to_sh[idx] / dist_sh[idx, None],
                             dist_sh[idx] * SHADOW_T_MAX_REL)
    contrib = (sc.light_power[li] * inv_prob[:, None] * (att / math.pi)
               * geom[:, None])
    return torch.where((vis & cand)[:, None], contrib, 0.0)


def trace(sc: RefScene, o, d, gen, *, mode: str, max_depth: int,
          t_min: float, spawn_eps: float, nee: bool = False,
          russian_roulette: bool = False, est=None):
    """Radiance (N, 3) of camera paths ``o``, ``d`` (N, 3) walked by
    ``mode`` ("pt" or "gather", the latter with per-path estimates
    ``est`` (N, 3))."""
    n = o.shape[0]
    dt, dev = o.dtype, o.device
    tput = torch.ones((n, 3), dtype=dt, device=dev)
    rad = torch.zeros((n, 3), dtype=dt, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_diff = torch.zeros_like(alive)
    for step in range(max_depth):
        if not bool(alive.any()):
            break
        u = torch.rand((n, 4), generator=gen, device=dev, dtype=dt)
        valid, p, nrm, front, mat = hit(sc, o, d, t_min)
        inter, nd, att, le = scatter(sc, u[:, :3], d, valid, p, nrm, front,
                                     mat)
        live = alive & valid
        rad = rad + torch.where((live & ~prev_diff)[:, None], tput * le, 0.0)
        diffuse = live & (inter == DIFFUSE)
        cont = live & (inter != ABSORB)
        if mode == "gather":
            rad = rad + torch.where(diffuse[:, None], tput * est, 0.0)
            cont = cont & ~diffuse
        elif nee:
            rad = rad + tput * direct_light(sc, gen, p, nrm, att, diffuse,
                                            sc.scale)
            prev_diff = diffuse
        tput = torch.where(cont[:, None], tput * att, tput)
        if russian_roulette and step >= RR_START:
            p_surv = torch.clamp(tput.amax(1), 0.05, 1.0)
            survive = u[:, 3] < p_surv
            tput = torch.where((cont & survive)[:, None],
                               tput / p_surv[:, None], tput)
            cont = cont & survive
        side = torch.sign(dot(nd, nrm))
        o = torch.where(cont[:, None],
                        p + nrm * (spawn_eps * side)[:, None], o)
        d = torch.where(cont[:, None], nd, d)
        alive = cont
    return rad


def render_pixels(sc: RefScene, pixels, width: int, height: int, spp: int,
                  gen, *, rays_per_chunk: int = 1 << 17, **walk):
    """``spp`` samples of each pixel of ``pixels`` (P,) flat ids (y * width
    + x): per pixel the sum and the sum of squares of the samples'
    radiance, (P, 3) each, in the scene's dtype. ``walk``: ``trace``'s
    keywords; a gather's ``est`` is per pixel (P, 3)."""
    dt, dev = sc.cam_origin.dtype, sc.cam_origin.device
    P = pixels.shape[0]
    est = walk.pop("est", None)
    s1 = torch.zeros((P, 3), dtype=dt, device=dev)
    s2 = torch.zeros((P, 3), dtype=dt, device=dev)
    per = max(1, rays_per_chunk // P)
    done = 0
    while done < spp:
        k = min(per, spp - done)
        slot = torch.arange(P, device=dev).repeat(k)
        pix = pixels[slot]
        px = (pix % width).to(dt)
        py = torch.div(pix, width, rounding_mode="floor").to(dt)
        u4 = torch.rand((slot.shape[0], 4), generator=gen, device=dev,
                        dtype=dt)
        o, d = camera_rays(sc, px, py, width, height, u4)
        rad = trace(sc, o, d, gen,
                    est=None if est is None else est[slot], **walk)
        s1.index_add_(0, slot, rad)
        s2.index_add_(0, slot, rad * rad)
        done += k
    return s1, s2
