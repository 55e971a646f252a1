"""One SPPM iteration of the reference on a scene with a large mesh
(``reference.mesh.MeshScene``): ``reference.sppm``'s photon pass,
measurement and iteration, each hit through ``mesh.hit`` (the closest hit
with the exact chunk cull) in place of ``render.hit``; the emission, the
queries, the update and the cap radius are ``reference.sppm``'s own. The
semantics are ``reference.sppm``'s, which its docstring sets out."""

from __future__ import annotations

import torch

from reference import mesh, render
from reference.sppm import HALVES, PHOTON_CHUNK, cap_radius, emit, query, \
    update


def photon_pass(ms: mesh.MeshScene, sp: dict, eps: float, gen):
    """Deposits of ``photons_per_iteration`` photons: (position, power,
    normal, caustic flag)."""
    sc = ms.sc
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
            valid, p, nrm, front, mat = mesh.hit(ms, o[idx], d[idx],
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


def measure(ms: mesh.MeshScene, pixels, width: int, height: int, sp: dict,
            t_min: float, eps: float, gen):
    """(valid, point, normal, bsdf colour) of one jittered camera ray per
    pixel walked to its first diffuse hit."""
    sc = ms.sc
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
        hv, p, nrm, front, mat = mesh.hit(ms, o, d, t_min)
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


def iteration(ms: mesh.MeshScene, state: dict, pixels, width: int,
              height: int, sp: dict, t_min: float, eps_rel: float,
              gen) -> dict:
    """The state of ``pixels`` one iteration after ``state``."""
    sc = ms.sc
    dt = sc.cam_origin.dtype
    eps = eps_rel * sc.scale
    cap = cap_radius(sc, sp)
    ph_p, ph_w, ph_n, ph_c = photon_pass(ms, sp, eps, gen)
    valid, pt, _pn, bsdf = measure(ms, pixels, width, height, sp, t_min,
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
