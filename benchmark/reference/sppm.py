"""One SPPM iteration of the reference, for a set of pixels, from a given
per-pixel state (photon_mapper.rs's algorithm, with the port's density
radius init and radius cap, which the configuration states):

- a photon pass: ``photons`` photons, each from a light picked in
  proportion to its power (a rect light: a uniform point, a direction
  uniform over the hemisphere below, power flux x scale x cos; a sphere
  light: a uniform point of its surface, a direction uniform over the
  hemisphere outside it); at each hit Russian roulette against the
  attenuation's largest component h (material.rs:27-45), then a deposit
  of the power from before the bounce at every diffuse hit that survives,
  flagged caustic when it is the first diffuse hit after a specular-only
  prefix; the power is renormalised by h; at most ``max_photon_bounces``
  hits, rays from ``photon_t_min``;
- a measurement pass: one jittered camera ray per pixel walked through
  its specular chain to its first diffuse hit (at most
  ``max_camera_bounces``): the point, its normal and its bsdf colour;
- both queries (every deposit, and the caustic ones): per point the flux
  and count of the deposits within its radius and within its cap radius,
  each weighted by 1 - |n . unit(photon - point)| (photon_mapper.rs:
  77-79, 102-114), the radius being min(sqrt(r^2), cap) once the pixel
  holds photons, and the cap before, the cap being one cell of the grid
  that ``grid_resolution`` chooses;
- the update (photon_mapper.rs:49-63): a pixel's first photons set r^2 =
  min(cap^2 k / m_cap, cap^2), flux = bsdf flux_cap min(k / m_cap, 1),
  N = k; later iterations N' = N + alpha m, r^2' = r^2 N' / (N + m),
  flux' = (flux + bsdf flux_r) N' / (N + m).

A state is a dict of per-pixel tensors: ``flux_g`` (P, 3), ``r2_g``,
``n_g`` (P,), and ``flux_c``, ``r2_c``, ``n_c`` of the caustic map."""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import render
from reference.scenes import SPHERE_LIGHT, RefScene

HALVES = (("g", "k_global"), ("c", "k_caustic"))
STATE_KEYS = ("flux_g", "r2_g", "n_g", "flux_c", "r2_c", "n_c")
PHOTON_CHUNK = 1 << 19
QUERY_PAIRS = 1 << 24


def grid_resolution(lo, hi, photons: int, k: int, max_res: int):
    """Cells per axis: the cell is the expected kNN radius sqrt(k A /
    (pi photons)), A the bounding box's surface, clipped to [2,
    max_res]."""
    ext = np.maximum(np.asarray(hi) - np.asarray(lo), 1e-6)
    area = 2.0 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[0] * ext[2])
    r0 = math.sqrt(max(k, 1) * area / (math.pi * max(photons, 1)))
    return tuple(int(np.clip(math.ceil(e / max(r0, 1e-6)), 2, max_res))
                 for e in ext)


def cap_radius(sc: RefScene, sp: dict) -> float:
    res = grid_resolution(sc.bounds_lo, sc.bounds_hi,
                          sp["photons_per_iteration"], sp["k_global"],
                          sp["grid_max_res"])
    ext = np.maximum(np.asarray(sc.bounds_hi) - np.asarray(sc.bounds_lo),
                     1e-6)
    return float((ext / np.asarray(res)).min())


def emit(sc: RefScene, n: int, gen):
    dt, dev = sc.cam_origin.dtype, sc.cam_origin.device
    u = torch.rand((n, 7), generator=gen, device=dev, dtype=dt)
    prob = render.light_probs(sc)
    li = torch.clamp(torch.searchsorted(torch.cumsum(prob, 0),
                                        u[:, 0].contiguous(), right=True),
                     max=prob.shape[0] - 1)
    is_sph = sc.light_kind[li] == SPHERE_LIGHT
    p0, p1, r0 = sc.light_p0[li], sc.light_p1[li], sc.light_r[li]
    sn = render.uniform_sphere(u[:, 1], u[:, 2])
    s_orig = p0 + sn * (r0 + 1e-4)[:, None]
    r_orig = torch.stack([p0[:, 0] + (p1[:, 0] - p0[:, 0]) * u[:, 5],
                          p0[:, 1],
                          p0[:, 2] + (p1[:, 2] - p0[:, 2]) * u[:, 6]], -1)
    down = torch.zeros_like(sn)
    down[:, 1] = -1.0
    nrm = torch.where(is_sph[:, None], sn, down)
    h = render.uniform_sphere(u[:, 3], u[:, 4])
    d = torch.where((render.dot(h, nrm) > 0)[:, None], h, -h)
    w = torch.where(is_sph, 1.0, torch.clamp(-d[:, 1], min=0.0))
    return (torch.where(is_sph[:, None], s_orig, r_orig), d,
            sc.light_power[li] * w[:, None])


def photon_pass(sc: RefScene, sp: dict, eps: float, gen):
    """Deposits of ``photons_per_iteration`` photons: (position, power,
    normal, caustic flag)."""
    out = []
    n_total = sp["photons_per_iteration"]
    for a in range(0, n_total, PHOTON_CHUNK):
        n = min(PHOTON_CHUNK, n_total - a)
        o, d, w = emit(sc, n, gen)
        alive = torch.ones((n,), dtype=torch.bool, device=o.device)
        has_spec = torch.zeros_like(alive)
        has_diff = torch.zeros_like(alive)
        for _ in range(sp["max_photon_bounces"]):
            if not bool(alive.any()):
                break
            idx = alive.nonzero()[:, 0]
            valid, p, nrm, front, mat = render.hit(sc, o[idx], d[idx],
                                                   sp["photon_t_min"])
            u = torch.rand((idx.shape[0], 4), generator=gen,
                           device=o.device, dtype=o.dtype)
            inter, nd, att, _le = render.scatter(sc, u[:, :3], d[idx], valid,
                                                 p, nrm, front, mat)
            h = att.amax(1)
            survive = u[:, 3] <= h
            inter = torch.where(survive & valid, inter, render.ABSORB)
            diffuse = inter == render.DIFFUSE
            caustic = has_spec[idx] & ~has_diff[idx]
            out.append((p[diffuse], w[idx][diffuse], nrm[diffuse],
                        caustic[diffuse]))
            cont = inter != render.ABSORB
            side = torch.sign(render.dot(nd, nrm))
            o[idx] = torch.where(cont[:, None],
                                 p + nrm * (eps * side)[:, None], o[idx])
            d[idx] = torch.where(cont[:, None], nd, d[idx])
            w[idx] = torch.where(cont[:, None],
                                 w[idx] * att / torch.clamp(h, min=1e-12)[:, None],
                                 w[idx])
            has_spec[idx] = has_spec[idx] | (cont & ~diffuse)
            has_diff[idx] = has_diff[idx] | diffuse
            alive[idx] = cont
    return tuple(torch.cat([x[i] for x in out]) for i in range(4))


def measure(sc: RefScene, pixels, width: int, height: int, sp: dict,
            t_min: float, eps: float, gen):
    """(valid, point, normal, bsdf colour) of one jittered camera ray per
    pixel walked to its first diffuse hit."""
    dt, dev = sc.cam_origin.dtype, sc.cam_origin.device
    n = pixels.shape[0]
    px = (pixels % width).to(dt)
    py = torch.div(pixels, width, rounding_mode="floor").to(dt)
    o, d = render.camera_rays(sc, px, py, width, height,
                              torch.rand((n, 4), generator=gen, device=dev,
                                         dtype=dt))
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    valid = torch.zeros_like(alive)
    pt, pn, bsdf = (torch.zeros((n, 3), dtype=dt, device=dev)
                    for _ in range(3))
    for _ in range(sp["max_camera_bounces"]):
        if not bool(alive.any()):
            break
        u = torch.rand((n, 3), generator=gen, device=dev, dtype=dt)
        hv, p, nrm, front, mat = render.hit(sc, o, d, t_min)
        inter, nd, att, _le = render.scatter(sc, u, d, hv, p, nrm, front,
                                             mat)
        diffuse = alive & hv & (inter == render.DIFFUSE)
        valid = valid | diffuse
        pt = torch.where(diffuse[:, None], p, pt)
        pn = torch.where(diffuse[:, None], nrm, pn)
        bsdf = torch.where(diffuse[:, None], att, bsdf)
        alive = alive & hv & ~diffuse & (inter != render.ABSORB)
        side = torch.sign(render.dot(nd, nrm))
        o = torch.where(alive[:, None], p + nrm * (eps * side)[:, None], o)
        d = torch.where(alive[:, None], nd, d)
    return valid, pt, pn, bsdf


def query(ph_p, ph_w, ph_n, pts, r2, cap2, cell: float):
    """Per point (flux_r, count_r, flux_cap, count_cap) of the photons
    within r and within the cap (every radius at most ``cell``), found
    through a uniform grid of ``cell``-sized cells."""
    dt, dev = pts.dtype, pts.device
    n = pts.shape[0]
    out = torch.zeros((n, 8), dtype=dt, device=dev)
    if ph_p.shape[0] == 0 or n == 0:
        return out
    lo = torch.minimum(ph_p.amin(0), pts.amin(0)) - cell
    dims = (torch.floor((torch.maximum(ph_p.amax(0), pts.amax(0)) + cell
                         - lo) / cell).long() + 1)
    strides = torch.stack([dims[1] * dims[2], dims[2],
                           torch.ones_like(dims[2])])

    def cell_of(x):
        return torch.floor((x - lo) / cell).long()

    pid = (cell_of(ph_p) * strides).sum(1)
    order = torch.argsort(pid)
    sid = pid[order]
    offs = torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                         for c in (-1, 0, 1)], device=dev)
    pc = cell_of(pts)
    block = max(1, QUERY_PAIRS // max(1, 27 * 64))
    for a in range(0, n, block):
        nb = (pc[a:a + block, None, :] + offs[None]) * strides
        nb = nb.sum(-1).reshape(-1)
        start = torch.searchsorted(sid, nb)
        end = torch.searchsorted(sid, nb, right=True)
        cnt = end - start
        seg = torch.repeat_interleave(torch.arange(cnt.shape[0],
                                                   device=dev), cnt)
        first = torch.cumsum(cnt, 0) - cnt
        j = order[start[seg] + torch.arange(seg.shape[0], device=dev)
                  - first[seg]]
        i = a + torch.div(seg, 27, rounding_mode="floor")
        delta = ph_p[j] - pts[i]
        d2 = render.dot(delta, delta)
        s = 1.0 - render.dot(ph_n[j], delta).abs() / torch.sqrt(
            torch.clamp(d2, min=1e-20))
        in_r = d2 <= r2[i]
        in_c = d2 <= cap2[i]
        contrib = ph_w[j] * s[:, None]
        vals = torch.cat([torch.where(in_r[:, None], contrib, 0.0),
                          in_r.to(dt)[:, None],
                          torch.where(in_c[:, None], contrib, 0.0),
                          in_c.to(dt)[:, None]], 1)
        out.index_add_(0, i, vals)
    return out


def update(state: dict, half: str, k: float, alpha: float, valid, bsdf, q,
           cap: float) -> dict:
    flux, r2, nph = state[f"flux_{half}"], state[f"r2_{half}"], \
        state[f"n_{half}"]
    first = valid & (nph == 0)
    m_cap = q[:, 7]
    has = m_cap > 0
    r0_2 = torch.where(has, torch.clamp(cap * cap * k / torch.clamp(
        m_cap, min=1.0), max=cap * cap), 0.0)
    flux0 = bsdf * q[:, 4:7] * torch.clamp(
        k / torch.clamp(m_cap, min=1.0), max=1.0)[:, None]
    n0 = torch.where(has, float(k), 0.0)
    m = q[:, 3]
    n_new = nph + alpha * m
    frac = n_new / torch.clamp(nph + m, min=1.0)
    upd = valid & ~first
    return {f"flux_{half}": torch.where(
                first[:, None], flux0, torch.where(
                    upd[:, None], (flux + bsdf * q[:, 0:3]) * frac[:, None],
                    flux)),
            f"r2_{half}": torch.where(first, r0_2, torch.where(
                upd, r2 * frac, r2)),
            f"n_{half}": torch.where(first, n0, torch.where(upd, n_new,
                                                           nph))}


def iteration(sc: RefScene, state: dict, pixels, width: int, height: int,
              sp: dict, t_min: float, eps_rel: float, gen) -> dict:
    """The state of ``pixels`` one iteration after ``state``."""
    dt = sc.cam_origin.dtype
    eps = eps_rel * sc.scale
    cap = cap_radius(sc, sp)
    ph_p, ph_w, ph_n, ph_c = photon_pass(sc, sp, eps, gen)
    valid, pt, _pn, bsdf = measure(sc, pixels, width, height, sp, t_min,
                                   eps, gen)
    out = {}
    for half, k_key in HALVES:
        st = {k: v.to(dt) for k, v in state.items()}
        r2, nph = st[f"r2_{half}"], st[f"n_{half}"]
        r = torch.clamp(torch.sqrt(torch.clamp(r2, min=0.0)), max=cap)
        r = torch.where(nph > 0, r, torch.full_like(r, cap))
        sel = slice(None) if half == "g" else ph_c
        q = query(ph_p[sel], ph_w[sel], ph_n[sel], pt, r * r, r * r, cap)
        out.update(update(st, half, float(sp[k_key]), float(sp["alpha"]),
                          valid, bsdf, q, cap))
    return out
