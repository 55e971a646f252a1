"""One fused bounce: closest hit over every primitive table, hit
attributes, constant/checker texture, material scatter and spawn offset.

The port of ``raytracer_tpu/ops/pallas_intersect.py::_bounce_kernel``
(reached through ``bounce_fused``/``_call_bounce``). The CUDA kernel lives
in ``csrc/bounce.cu``; ``bounce_fused_plain`` below is the same function in
plain PyTorch. The wrapper takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.

Table layout (the port's own; only the answer must match the TPU kernel,
whose Morton order and near-to-far chunk order exist for its culling):

- ``sph``  (S, 4): cx, cy, cz, r^2
- ``rect`` (R, 8): axis, k, a0, a1, b0, b1, 0, 0
- ``tri``  (T, 16): n_geo = e1 x e2, e1, e2, e2 x v0, e1 x v0, v0 . n_geo
  (the scalar-triple Möller–Trumbore form), with ``tri_nrm`` (T, 9): the
  corner normals n0, n1, n2
- ``*_mat`` (P,) int32 material ids, and ``mat`` (M, 12) material feature
  records: kind, fuzz, ir, tex_kind, color0 (3), color1 (3), image_id,
  mat_id (``_feature_rows`` of the JAX package, one row per material)

Winner rule, as in the TPU kernel: stages run spheres, then rects, then
triangles, each in table order; a hit replaces the best only on a strict
``t < best_t``, so the lowest index wins a tie.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from raytracer_tpu_torch.scene.types import (
    INTER_ABSORB, INTER_DIFFUSE, INTER_REFLECT, INTER_REFRACT,
    INTER_SPECULAR, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_LAMBERTIAN,
    MAT_METAL, PRIM_RECT, PRIM_SPHERE, PRIM_TRIANGLE, Scene, TEX_CHECKER,
)

BIG = 3.0e38          # the kernel's "no hit" t; the bounce ignores any tmax
TWO_PI = 6.283185307179586
FRAC_1_PI = 0.3183098861837907
# plain version: at most this many (ray, primitive) pairs per chunk
PLAIN_PAIRS = 1 << 24

# Kernel launches made by ``bounce_tables`` on CUDA tensors. A plain
# integer: a run reads it before and after to show it went through the
# kernel.
LAUNCHES = 0


class BounceTables(NamedTuple):
    """Scene tables packed for the fused bounce (layout in the module
    docstring). Built once per scene on the scene's device."""
    sph: torch.Tensor
    sph_mat: torch.Tensor
    rect: torch.Tensor
    rect_mat: torch.Tensor
    tri: torch.Tensor
    tri_nrm: torch.Tensor
    tri_mat: torch.Tensor
    mat: torch.Tensor


def unported(scene: Scene) -> list:
    """What of ``scene`` the fused bounce does not take yet, each naming
    the ROADMAP item that ports it; empty when the scene is eligible. The
    JAX package's ``bounce_fused_eligible`` sends such scenes (image or
    noise textures, media) through ``_closest_kernel`` and an unfused
    stage; it also caps the table size, which the CUDA kernel does not
    need: it streams any table through shared memory."""
    out = []
    if scene.images.shape[0] or scene.textures.noise_marker.shape[0]:
        out.append("image and noise textures are not ported yet "
                   "(ROADMAP A8)")
    if scene.media is not None and scene.media.kind.shape[0]:
        out.append("media are not ported yet (ROADMAP A7)")
    if scene.spheres.motion_marker.shape[0]:
        out.append("motion blur is not ported yet (ROADMAP A9)")
    return out


def pack_tables(scene: Scene) -> BounceTables:
    """Pack the scene's tables for the fused bounce, on the scene's
    device."""
    f32 = torch.float32
    s, r, tr = scene.spheres, scene.rects, scene.triangles
    sph = torch.cat([s.center, (s.radius * s.radius)[:, None]], 1).to(f32)
    z = torch.zeros_like(r.k)
    rect = torch.stack([r.axis.to(f32), r.k, r.a0, r.a1, r.b0, r.b1, z, z],
                       1).to(f32)
    n_geo = torch.linalg.cross(tr.e1, tr.e2, dim=-1)
    tri = torch.cat([n_geo, tr.e1, tr.e2,
                     torch.linalg.cross(tr.e2, tr.v0, dim=-1),
                     torch.linalg.cross(tr.e1, tr.v0, dim=-1),
                     torch.sum(tr.v0 * n_geo, -1)[:, None]], 1).to(f32)
    tri_nrm = torch.cat([tr.n0, tr.n1, tr.n2], 1).to(f32)
    m, t = scene.materials, scene.textures
    tex = m.tex_id.long()
    mat = torch.cat([
        m.kind.to(f32)[:, None], m.fuzz[:, None], m.ir[:, None],
        t.kind[tex].to(f32)[:, None], t.color0[tex], t.color1[tex],
        t.image_id[tex].to(f32)[:, None],
        torch.arange(m.kind.shape[0], device=m.kind.device)[:, None].to(f32),
    ], 1).to(f32)

    def c(x):
        return x.contiguous()

    i32 = torch.int32
    return BounceTables(c(sph), c(s.mat_id.to(i32)), c(rect),
                        c(r.mat_id.to(i32)), c(tri), c(tri_nrm),
                        c(tr.mat_id.to(i32)), c(mat))


# --------------------------------------------------------------- plain

def _closest_plain(tab: BounceTables, o, d, t_min: float, alive):
    """Brute-force chunked closest hit. Returns (best_t, best_ty, best_ix,
    b1, b2), each (N,); dead lanes miss (ty = -1)."""
    n = o.shape[1]
    dev = o.device
    ox, oy, oz = (x[:, None] for x in o)
    dx, dy, dz = (x[:, None] for x in d)
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    best_t = torch.full((n,), BIG, device=dev)
    best_ty = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_ix = torch.zeros((n,), dtype=torch.int64, device=dev)
    best_b1 = torch.zeros((n,), device=dev)
    best_b2 = torch.zeros((n,), device=dev)
    dead = ~alive.bool()
    chunk = max(1, PLAIN_PAIRS // max(n, 1))

    def fold(t, ok, code, base, b1=None, b2=None):
        tt = torch.where(ok, t, BIG)
        tt = torch.where(dead[:, None], BIG, tt)
        j = tt.argmin(dim=1)                      # first index on a tie
        m = tt.gather(1, j[:, None])[:, 0]
        better = m < best_t
        best_t.copy_(torch.where(better, m, best_t))
        best_ty.copy_(torch.where(better, code, best_ty))
        best_ix.copy_(torch.where(better, j + base, best_ix))
        if b1 is not None:
            best_b1.copy_(torch.where(better, b1.gather(1, j[:, None])[:, 0],
                                      best_b1))
            best_b2.copy_(torch.where(better, b2.gather(1, j[:, None])[:, 0],
                                      best_b2))

    for j0 in range(0, tab.sph.shape[0], chunk):
        blk = tab.sph[j0:j0 + chunk]
        ocx = ox - blk[None, :, 0]
        ocy = oy - blk[None, :, 1]
        ocz = oz - blk[None, :, 2]
        half_b = dx * ocx + dy * ocy + dz * ocz
        c_term = ocx * ocx + ocy * ocy + ocz * ocz - blk[None, :, 3]
        disc = half_b * half_b - a * c_term
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        r1 = (-half_b - sq) * inv_a
        r2 = (-half_b + sq) * inv_a
        ok1 = (r1 >= t_min) & (r1 <= BIG)
        ok2 = (r2 >= t_min) & (r2 <= BIG)
        t = torch.where(ok1, r1, torch.where(ok2, r2, BIG))
        fold(t, disc >= 0.0, PRIM_SPHERE, j0)

    o3, d3 = o.T, d.T                              # (N, 3)
    for j0 in range(0, tab.rect.shape[0], chunk):
        blk = tab.rect[j0:j0 + chunk]
        ax = blk[:, 0].long()
        a_ax = torch.where(ax == 0, 1, 0)
        b_ax = torch.where(ax == 2, 1, 2)
        d_n, o_n = d3[:, ax], o3[:, ax]            # (N, C)
        safe = d_n.abs() > 1e-12
        t = (blk[None, :, 1] - o_n) / torch.where(safe, d_n, 1.0)
        pa = o3[:, a_ax] + t * d3[:, a_ax]
        pb = o3[:, b_ax] + t * d3[:, b_ax]
        ok = (safe & (pa >= blk[None, :, 2]) & (pa <= blk[None, :, 3])
              & (pb >= blk[None, :, 4]) & (pb <= blk[None, :, 5])
              & (t >= t_min) & (t <= BIG))
        fold(t, ok, PRIM_RECT, j0)

    oxd_x = oy * dz - oz * dy
    oxd_y = oz * dx - ox * dz
    oxd_z = ox * dy - oy * dx
    for j0 in range(0, tab.tri.shape[0], chunk):
        p = [tab.tri[j0:j0 + chunk, k][None] for k in range(16)]
        (ngx, ngy, ngz, e1x, e1y, e1z, e2x, e2y, e2z,
         w2x, w2y, w2z, w1x, w1y, w1z, v0n) = p
        div = -(dx * ngx + dy * ngy + dz * ngz)
        safe = div != 0.0
        inv = 1.0 / torch.where(safe, div, 1.0)
        b1 = ((oxd_x * e2x + oxd_y * e2y + oxd_z * e2z)
              - (dx * w2x + dy * w2y + dz * w2z)) * inv
        b2 = (-(oxd_x * e1x + oxd_y * e1y + oxd_z * e1z)
              + (dx * w1x + dy * w1y + dz * w1z)) * inv
        t = ((ox * ngx + oy * ngy + oz * ngz) - v0n) * inv
        ok = (safe & (b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0)
              & (b1 + b2 <= 1.0) & (t >= t_min) & (t <= BIG))
        fold(t, ok, PRIM_TRIANGLE, j0, b1, b2)
    return best_t, best_ty, best_ix, best_b1, best_b2


def _unit3(x, y, z):
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-30))
    return x * inv, y * inv, z * inv


def _take(table, ix, hit):
    """Rows of ``table`` at ``ix`` where ``hit``, zeros elsewhere."""
    if table.shape[0] == 0:
        return torch.zeros((ix.shape[0],) + tuple(table.shape[1:]),
                           dtype=table.dtype, device=ix.device)
    rows = table[torch.where(hit, ix, 0).clamp(max=table.shape[0] - 1)]
    mask = hit.reshape((-1,) + (1,) * (rows.dim() - 1))
    return torch.where(mask, rows, torch.zeros_like(rows))


def _bounce_values(tab: BounceTables, o, d, uni, best_t, best_ty, best_ix,
                   b1, b2):
    """Hit attributes + texture + scatter on the winner (the epilogue of
    the TPU kernel, ``_bounce_values``). A miss behaves as the TPU
    kernel's all-zero winner record: zero normal and material features."""
    ox, oy, oz = o
    dx, dy, dz = d
    valid = best_ty >= 0
    t = torch.where(valid, best_t, 0.0)
    px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz

    is_s = best_ty == PRIM_SPHERE
    is_r = best_ty == PRIM_RECT
    is_t = best_ty == PRIM_TRIANGLE
    sph = _take(tab.sph, best_ix, is_s)
    inv_r = 1.0 / torch.sqrt(torch.clamp(sph[:, 3], min=1e-20))
    snx = (px - sph[:, 0]) * inv_r
    sny = (py - sph[:, 1]) * inv_r
    snz = (pz - sph[:, 2]) * inv_r
    axis = _take(tab.rect, best_ix, is_r)[:, 0]
    nrm = _take(tab.tri_nrm, best_ix, is_t)
    tb0 = 1.0 - b1 - b2
    tnx = tb0 * nrm[:, 0] + b1 * nrm[:, 3] + b2 * nrm[:, 6]
    tny = tb0 * nrm[:, 1] + b1 * nrm[:, 4] + b2 * nrm[:, 7]
    tnz = tb0 * nrm[:, 2] + b1 * nrm[:, 5] + b2 * nrm[:, 8]
    tnx, tny, tnz = _unit3(tnx, tny, tnz)
    one, zero = torch.ones_like(px), torch.zeros_like(px)
    nox = torch.where(is_s, snx, torch.where(
        is_r, torch.where(axis == 0, one, zero), tnx))
    noy = torch.where(is_s, sny, torch.where(
        is_r, torch.where(axis == 1, one, zero), tny))
    noz = torch.where(is_s, snz, torch.where(
        is_r, torch.where(axis == 2, one, zero), tnz))
    front = (dx * nox + dy * noy + dz * noz) < 0.0
    sgn = torch.where(front, 1.0, -1.0)
    nx, ny, nz = _unit3(nox * sgn, noy * sgn, noz * sgn)

    mid = torch.where(is_s, _take(tab.sph_mat, best_ix, is_s),
                      torch.where(is_r, _take(tab.rect_mat, best_ix, is_r),
                                  _take(tab.tri_mat, best_ix, is_t)))
    feat = _take(tab.mat, mid.long(), valid)
    kind, fuzz = feat[:, 0], feat[:, 1]
    ir = torch.clamp(feat[:, 2], min=1e-6)
    tex_kind = feat[:, 3]
    sines = torch.sin(10.0 * px) * torch.sin(10.0 * py) * torch.sin(10.0 * pz)
    chk = ((tex_kind - TEX_CHECKER).abs() < 0.5) & (sines >= 0.0)
    alr = torch.where(chk, feat[:, 7], feat[:, 4])
    alg = torch.where(chk, feat[:, 8], feat[:, 5])
    alb = torch.where(chk, feat[:, 9], feat[:, 6])

    u0, u1, u2, eps = uni[0], uni[1], uni[2], uni[3]
    z = 1.0 - 2.0 * u0
    phi = TWO_PI * u1
    rs = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    sx, sy = rs * torch.cos(phi), rs * torch.sin(phi)

    # Lambertian / diffuse light: n + unit sphere, near-zero guard
    ldx, ldy, ldz = nx + sx, ny + sy, nz + z
    small = (ldx * ldx + ldy * ldy + ldz * ldz) < 1e-16
    ldx = torch.where(small, nx, ldx)
    ldy = torch.where(small, ny, ldy)
    ldz = torch.where(small, nz, ldz)

    # metal: reflect(unit d) + fuzz * unit sphere; absorb below the surface
    ux, uy, uz = _unit3(dx, dy, dz)
    dn = ux * nx + uy * ny + uz * nz
    rfx, rfy, rfz = ux - 2.0 * dn * nx, uy - 2.0 * dn * ny, uz - 2.0 * dn * nz
    mdx, mdy, mdz = rfx + fuzz * sx, rfy + fuzz * sy, rfz + fuzz * z
    metal_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0

    # dielectric: Schlick + total internal reflection against u2
    ratio = torch.where(front, 1.0 / ir, ir)
    cos_t = torch.clamp(-(ux * nx + uy * ny + uz * nz), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    cannot = ratio * sin_t > 1.0
    r0 = (1.0 - ratio) / (1.0 + ratio)
    r0 = r0 * r0
    x = 1.0 - cos_t
    x2 = x * x
    refl = r0 + (1.0 - r0) * (x2 * x2 * x)
    do_refl = cannot | (refl > u2)
    ppx, ppy, ppz = (ratio * (ux + cos_t * nx), ratio * (uy + cos_t * ny),
                     ratio * (uz + cos_t * nz))
    par = -torch.sqrt((1.0 - (ppx * ppx + ppy * ppy + ppz * ppz)).abs())
    ddx = torch.where(do_refl, rfx, ppx + par * nx)
    ddy = torch.where(do_refl, rfy, ppy + par * ny)
    ddz = torch.where(do_refl, rfz, ppz + par * nz)

    is_lam = (kind - MAT_LAMBERTIAN).abs() < 0.5
    is_met = (kind - MAT_METAL).abs() < 0.5
    is_die = (kind - MAT_DIELECTRIC).abs() < 0.5
    is_lgt = (kind - MAT_DIFFUSE_LIGHT).abs() < 0.5
    diffish = is_lam | is_lgt
    odx = torch.where(diffish, ldx, torch.where(is_met, mdx, ddx))
    ody = torch.where(diffish, ldy, torch.where(is_met, mdy, ddy))
    odz = torch.where(diffish, ldz, torch.where(is_met, mdz, ddz))
    att = torch.stack([torch.where(is_lgt, FRAC_1_PI, c)
                       for c in (alr, alg, alb)])
    inter = torch.where(
        diffish, INTER_DIFFUSE,
        torch.where(is_met,
                    torch.where(metal_ok, INTER_SPECULAR, INTER_ABSORB),
                    torch.where(is_die,
                                torch.where(do_refl, INTER_REFLECT,
                                            INTER_REFRACT),
                                INTER_DIFFUSE)))
    inter = torch.where(valid, inter, INTER_ABSORB).to(torch.int32)
    lit = is_lgt & valid
    emit = torch.stack([torch.where(lit, c, 0.0) for c in (alr, alg, alb)])

    side = torch.sign(odx * nx + ody * ny + odz * nz) * eps
    no = torch.stack([px + nx * side, py + ny * side, pz + nz * side])
    return (inter, no, torch.stack([odx, ody, odz]), att, emit,
            torch.stack([px, py, pz]), torch.stack([nx, ny, nz]))


def bounce_fused_plain(tab: BounceTables, o_t, d_t, t_min: float, alive,
                       uni_t):
    """The fused bounce in plain PyTorch (any device). Same interface and
    outputs as ``bounce_tables``."""
    hit = _closest_plain(tab, o_t, d_t, float(t_min), alive)
    return _bounce_values(tab, o_t, d_t, uni_t, *hit)


# -------------------------------------------------------------- kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_float, _I,     # o d alive uni tmin n
             _P, _P, _I,                             # sph sph_mat n_sph
             _P, _P, _I,                             # rect rect_mat n_rect
             _P, _P, _P, _I,                         # tri tri_nrm tri_mat n
             _P,                                     # mat
             _P, _P, _P, _P, _P, _P, _P,             # outputs
             _P]                                     # stream


def _lib():
    from raytracer_tpu_torch.kernels import build
    lib = build.load_library("bounce")
    if lib.rt_bounce.argtypes is None:
        lib.rt_bounce.argtypes = _ARGTYPES
        lib.rt_bounce.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, x, dev, dtype, shape):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(
            f"bounce: {name} must be {dtype} {shape} on {dev}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"bounce: {name} must be contiguous")


def _bounce_cuda(tab: BounceTables, o_t, d_t, t_min: float, alive, uni_t):
    global LAUNCHES
    dev = o_t.device
    n = o_t.shape[1]
    f32 = torch.float32
    _check("o_t", o_t, dev, f32, (3, n))
    _check("d_t", d_t, dev, f32, (3, n))
    _check("alive", alive, dev, torch.bool, (n,))
    _check("uni_t", uni_t, dev, f32, (4, n))
    for name, x in zip(tab._fields, tab):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"bounce: table {name} must be contiguous on "
                             f"{dev}")
    rows = [torch.empty((3, n), dtype=f32, device=dev) for _ in range(6)]
    inter = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rt_bounce(
            o_t.data_ptr(), d_t.data_ptr(), alive.data_ptr(),
            uni_t.data_ptr(), float(t_min), n,
            tab.sph.data_ptr(), tab.sph_mat.data_ptr(), tab.sph.shape[0],
            tab.rect.data_ptr(), tab.rect_mat.data_ptr(), tab.rect.shape[0],
            tab.tri.data_ptr(), tab.tri_nrm.data_ptr(), tab.tri_mat.data_ptr(),
            tab.tri.shape[0], tab.mat.data_ptr(),
            *(r.data_ptr() for r in rows), inter.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("bounce kernel launch failed: "
                           + lib.rt_error_string(rc).decode())
    LAUNCHES += 1
    no, nd, att, emit, p, nrm = rows
    return inter, no, nd, att, emit, p, nrm


def bounce_tables(tab: BounceTables, o_t, d_t, t_min: float, alive, uni_t):
    """One fused bounce over packed tables. ``o_t``/``d_t`` (3, N) f32,
    ``alive`` (N,) bool, ``uni_t`` (4, N) f32: scatter uniforms in rows
    0-2 and the spawn epsilon in row 3. Returns (inter (N,) int32, new_o,
    new_d, att, emit, p, n), each (3, N) f32. Dead lanes get the miss
    outputs (inter ABSORB, zero emission, p = o).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if o_t.device.type == "cpu":
        return bounce_fused_plain(tab, o_t, d_t, t_min, alive, uni_t)
    if o_t.device.type != "cuda":
        raise NotImplementedError(f"bounce: no kernel for {o_t.device}")
    return _bounce_cuda(tab, o_t, d_t, t_min, alive, uni_t)


def bounce_fused(scene: Scene, o_t, d_t, t_min: float, alive, uni_t):
    """One fused bounce on a scene: the JAX ``bounce_fused`` interface,
    rays on the second axis (``o_t``/``d_t`` (3, N), ``uni_t`` (4, N)).
    Packs the tables on every call; loops pack once and call
    ``bounce_tables``."""
    missing = unported(scene)
    if missing:
        raise NotImplementedError("; ".join(missing))
    return bounce_tables(pack_tables(scene), o_t, d_t, t_min, alive, uni_t)
