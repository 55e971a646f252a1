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

Large tables: ``pack_tables`` also attaches a sorted copy of the sphere or
triangle table (``ops/ordered.py``) when it qualifies for the near-to-far
walk, and ``bounce_tables`` then launches the ordered kernel
(``csrc/bounce_ordered.cu``, the port of ``_bounce_kernel_ordered``), whose
plain twin is ``bounce_ordered_plain``. Its tie rule (t, then type, then
scene index) gives the flat sweep's winner on every lane.

Motion blur (the TPU kernels' ``has_time=True``): a scene whose spheres
move packs ``sph_vel`` (S, 4): vx, vy, vz, 0 beside ``sph`` (its ordered
stage the sorted velocities and shutter-dilated boxes). Given a per-ray
shutter ``time`` (N,), every sphere is tested at ``c + v * t`` (the product
and then the sum, each rounded on its own, in the kernels too) and the
winner's attributes come from that moved centre; the wrappers then launch
the kernels' motion entry points. Without a time, or on static tables, the
static code runs: a moving scene is then intersected at its t = 0 centres,
the answer of JAX's brute-force route without a time.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from raytracer_tpu_torch.kernels import launch
from raytracer_tpu_torch.ops import ordered as ordered_ops
from raytracer_tpu_torch.ops.ordered import OrderedStage
from raytracer_tpu_torch.scene.types import (
    INTER_ABSORB, INTER_DIFFUSE, INTER_REFLECT, INTER_REFRACT,
    INTER_SPECULAR, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_LAMBERTIAN,
    MAT_METAL, PRIM_RECT, PRIM_SPHERE, PRIM_TRIANGLE, Scene, TEX_CHECKER,
)

BIG = 3.0e38          # the kernels' "no hit" t; the bounce sweeps to it
TWO_PI = 6.283185307179586
FRAC_1_PI = 0.3183098861837907
# plain version: at most this many (ray, primitive) pairs per chunk; on the
# CPU fewer, so that a chunk's temporaries stay in cache (the winner does
# not depend on the chunking: the lowest index wins a tie either way)
PLAIN_PAIRS = 1 << 24
PLAIN_PAIRS_CPU = 1 << 19


class BounceTables(NamedTuple):
    """Scene tables packed for the fused bounce (layout in the module
    docstring). Built once per scene on the scene's device. ``osph`` and
    ``otri``: the sorted copies of a sphere or triangle table that takes
    the near-to-far walk, else None; ``leaf``: the leaf kernel's tables
    (``ops/leaf.py::LeafPack``) when the scene carries leaf tables;
    ``sph_vel``: (S, 4) f32 sphere velocities (vx, vy, vz, 0) when the
    spheres move, else None; ``med_mat``: (K,) int32 the material of each
    medium (``scene.media.mat_id``) when the scene has media, else None:
    the unfused stage's attributes read it for a medium event's winner
    (``ops/media.py::apply_media_soa``)."""
    sph: torch.Tensor
    sph_mat: torch.Tensor
    rect: torch.Tensor
    rect_mat: torch.Tensor
    tri: torch.Tensor
    tri_nrm: torch.Tensor
    tri_mat: torch.Tensor
    mat: torch.Tensor
    osph: Optional[OrderedStage] = None
    otri: Optional[OrderedStage] = None
    leaf: Optional[tuple] = None
    sph_vel: Optional[torch.Tensor] = None
    med_mat: Optional[torch.Tensor] = None

    @property
    def ordered(self) -> bool:
        """Does a stage of these tables take the walk?"""
        return self.osph is not None or self.otri is not None

    def moves(self, time) -> bool:
        """Does a call with shutter ``time`` (or None) take the motion
        form? Only moving tables with a time do."""
        return time is not None and self.sph_vel is not None


# the scene-order tables every kernel reads
FLAT = BounceTables._fields[:8]


def has_media(scene: Scene) -> bool:
    """Does the scene hold constant-density media?"""
    return scene.media is not None and scene.media.kind.shape[0] > 0


def fused_eligible(scene: Scene) -> bool:
    """The JAX ``bounce_fused_eligible`` rule without its table caps (the
    CUDA kernels stream any table): no image or noise texture, no medium.
    Other scenes take the unfused stage (``wavefront_soa.use_fused``)."""
    return (scene.images.shape[0] == 0
            and scene.textures.noise_marker.shape[0] == 0
            and not has_media(scene))


def moving(scene: Scene) -> bool:
    """Do the scene's spheres move (one velocity per sphere and the
    motion marker set, the JAX ``_pack_spheres(with_motion=True)`` rule)?"""
    s = scene.spheres
    return bool(s.motion_marker.shape[0] and s.radius.shape[0]
                and s.velocity.shape[0] == s.radius.shape[0])


def pack_tables(scene: Scene, order: bool = True) -> BounceTables:
    """Pack the scene's tables for the fused bounce, on the scene's
    device. A sphere or triangle table that qualifies for the near-to-far
    walk (``ordered.wants_order``) also gets its sorted copy, unless
    ``order`` is False, which forces the flat route; a scene with leaf
    tables gets the leaf kernel's; a scene whose spheres move gets
    ``sph_vel`` (its ordered stage the sorted velocities and boxes
    dilated over the camera's shutter)."""
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
    sph, tri = c(sph), c(tri)
    osph = otri = leaf = sph_vel = med_mat = None
    if moving(scene):
        sph_vel = c(torch.cat([s.velocity, torch.zeros_like(s.radius)[:, None]],
                              1).to(f32))
    if order:
        cam = scene.camera.origin
        osph = ordered_ops.sphere_stage(
            sph, s.center, s.radius, cam, sph_vel,
            (scene.camera.time0, scene.camera.time1))
        otri = ordered_ops.tri_stage(tri, tr.v0, tr.e1, tr.e2, cam)
    if scene.leaf is not None:
        from raytracer_tpu_torch.ops.leaf import pack_leaf
        leaf = pack_leaf(scene.leaf, sph)
    if has_media(scene):
        med_mat = c(scene.media.mat_id.to(i32))
    return BounceTables(sph, c(s.mat_id.to(i32)), c(rect),
                        c(r.mat_id.to(i32)), tri, c(tri_nrm),
                        c(tr.mat_id.to(i32)), c(mat), osph, otri, leaf,
                        sph_vel, med_mat)


# --------------------------------------------------------------- plain

def _row(x, n, dev):
    """A float or tensor as an (N,) f32 tensor."""
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=torch.float32).expand(n)
    return torch.full((n,), float(x), device=dev)


def _sphere_tt(rc, cx, cy, cz, rsq, vel=None, time=None):
    """t of ray/sphere pairs, BIG where the pair misses. ``rc``: the ray
    columns (ox, oy, oz, dx, dy, dz, a, 1/a, t_min, t_max) of
    ``_closest_plain``; the sphere columns broadcast against them. The
    flat sweep and the ordered walk share it, so both round alike. With
    ``vel`` (vx, vy, vz columns) and ``time`` (a ray column), each centre
    moves to c + v * t first."""
    if vel is not None:
        cx, cy, cz = (c + v * time for c, v in zip((cx, cy, cz), vel))
    ox, oy, oz, dx, dy, dz, a, inv_a, t_min, t_max = rc
    ocx = ox - cx
    ocy = oy - cy
    ocz = oz - cz
    half_b = dx * ocx + dy * ocy + dz * ocz
    c_term = ocx * ocx + ocy * ocy + ocz * ocz - rsq
    disc = half_b * half_b - a * c_term
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    r1 = (-half_b - sq) * inv_a
    r2 = (-half_b + sq) * inv_a
    ok1 = (r1 >= t_min) & (r1 <= t_max)
    ok2 = (r2 >= t_min) & (r2 <= t_max)
    t = torch.where(ok1, r1, torch.where(ok2, r2, BIG))
    return torch.where(disc >= 0.0, t, BIG)


def _tri_tt(rc, p):
    """(t, b1, b2) of ray/triangle pairs (scalar-triple Möller–Trumbore),
    t = BIG where the pair misses; ``p`` the 16 triangle columns."""
    ox, oy, oz, dx, dy, dz, _, _, t_min, t_max = rc
    oxd_x = oy * dz - oz * dy
    oxd_y = oz * dx - ox * dz
    oxd_z = ox * dy - oy * dx
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
          & (b1 + b2 <= 1.0) & (t >= t_min) & (t <= t_max))
    return torch.where(ok, t, BIG), b1, b2


def _walk_sph(rows, rc, vrows=None, tcol=None):
    vel = None if vrows is None else [vrows[:, None, :, k] for k in range(3)]
    return (_sphere_tt(rc, *(rows[:, None, :, k] for k in range(4)), vel,
                       tcol), None, None)


def _walk_tri(rows, rc):
    return _tri_tt(rc, [rows[:, None, :, k] for k in range(16)])


def _closest_plain(tab: BounceTables, o, d, t_min, alive, t_max=BIG,
                   ordered: bool = False, stats=None, time=None,
                   group: int = ordered_ops.GROUP):
    """Brute-force chunked closest hit. ``t_min`` and ``t_max`` are floats
    or (N,) tensors; a candidate counts when t_min <= t <= min(t_max, BIG)
    and the fold starts at best_t = min(t_max, BIG) and takes only t <
    best_t (the TPU kernel's rule), so a hit lies strictly below t_max.
    With ``ordered``, a stage that carries an ordered table (``tab.osph``,
    ``tab.otri``) runs ``ordered.walk_plain`` instead of the flat scan,
    adding its chunk bodies per group of ``group`` rays (a warp of the
    kernels) to ``stats`` (ceil(N / group), 2) (spheres, triangles) if
    given. ``time`` (N,): the rays' shutter times, which
    move the spheres of moving tables (``BounceTables.moves``). Returns
    (best_t, best_ty, best_ix, b1, b2), each (N,); dead lanes and misses
    have ty = -1 and best_t = min(t_max, BIG)."""
    n = o.shape[1]
    dev = o.device
    ox, oy, oz = (x[:, None] for x in o)
    dx, dy, dz = (x[:, None] for x in d)
    a = dx * dx + dy * dy + dz * dz
    inv_a = 1.0 / a
    tmin_v = _row(t_min, n, dev)
    tmax_v = torch.clamp(_row(t_max, n, dev), max=BIG)
    rc = (ox, oy, oz, dx, dy, dz, a, inv_a, tmin_v[:, None], tmax_v[:, None])
    best_t = tmax_v.clone()
    best_ty = torch.full((n,), -1, dtype=torch.int32, device=dev)
    best_ix = torch.zeros((n,), dtype=torch.int64, device=dev)
    best_b1 = torch.zeros((n,), device=dev)
    best_b2 = torch.zeros((n,), device=dev)
    best = [best_t, best_ty, best_ix, best_b1, best_b2]
    dead = ~alive.bool()
    pairs = PLAIN_PAIRS_CPU if dev.type == "cpu" else PLAIN_PAIRS
    chunk = max(1, pairs // max(n, 1))

    def fold(tt, code, base, b1=None, b2=None):
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

    motion = tab.moves(time)
    if motion:
        time = time.to(torch.float32)

    def walk(stage, tests, kind, col):
        ordered_ops.walk_plain(stage, o, d, tmin_v, tmax_v, alive.bool(),
                               best, tests, kind,
                               None if stats is None else stats[:, col],
                               time if motion else None, group)

    if ordered and tab.osph is not None:
        walk(tab.osph, _walk_sph, PRIM_SPHERE, 0)
    else:
        for j0 in range(0, tab.sph.shape[0], chunk):
            blk = tab.sph[j0:j0 + chunk]
            vel = tcol = None
            if motion:
                vel = [tab.sph_vel[j0:j0 + chunk, k][None] for k in range(3)]
                tcol = time[:, None]
            fold(_sphere_tt(rc, *(blk[None, :, k] for k in range(4)), vel,
                            tcol), PRIM_SPHERE, j0)

    t_min, t_max = rc[8], rc[9]
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
              & (t >= t_min) & (t <= t_max))
        fold(torch.where(ok, t, BIG), PRIM_RECT, j0)

    if ordered and tab.otri is not None:
        walk(tab.otri, _walk_tri, PRIM_TRIANGLE, 1)
    else:
        for j0 in range(0, tab.tri.shape[0], chunk):
            tt, b1, b2 = _tri_tt(rc, [tab.tri[j0:j0 + chunk, k][None]
                                      for k in range(16)])
            fold(tt, PRIM_TRIANGLE, j0, b1, b2)
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
                   b1, b2, time=None):
    """Hit attributes + texture + scatter on the winner (the epilogue of
    the TPU kernel, ``_bounce_values``). A miss behaves as the TPU
    kernel's all-zero winner record: zero normal and material features.
    ``time``: as for ``_closest_plain`` (a sphere's normal from its moved
    centre)."""
    ox, oy, oz = o
    dx, dy, dz = d
    valid = best_ty >= 0
    t = torch.where(valid, best_t, 0.0)
    px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz

    is_s = best_ty == PRIM_SPHERE
    is_r = best_ty == PRIM_RECT
    is_t = best_ty == PRIM_TRIANGLE
    sph = _take(tab.sph, best_ix, is_s)
    cx, cy, cz = sph[:, 0], sph[:, 1], sph[:, 2]
    if tab.moves(time):
        vel = _take(tab.sph_vel, best_ix, is_s)
        cx, cy, cz = (c + vel[:, k] * time for k, c in enumerate((cx, cy, cz)))
    inv_r = 1.0 / torch.sqrt(torch.clamp(sph[:, 3], min=1e-20))
    snx = (px - cx) * inv_r
    sny = (py - cy) * inv_r
    snz = (pz - cz) * inv_r
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
                       uni_t, time=None):
    """The fused bounce in plain PyTorch (any device), over the flat
    tables. Same interface and outputs as ``bounce_tables``."""
    hit = _closest_plain(tab, o_t, d_t, float(t_min), alive, time=time)
    return _bounce_values(tab, o_t, d_t, uni_t, *hit, time=time)


def bounce_ordered_plain(tab: BounceTables, o_t, d_t, t_min: float, alive,
                         uni_t, stats=None, time=None):
    """The ordered bounce in plain PyTorch (any device): the walk of
    ``ordered.walk_plain`` for each stage with an ordered table, in groups
    of the kernel's warp, with its culls and stop rule, then the
    same epilogue. ``stats``, ``time``: as for ``_closest_plain``."""
    hit = _closest_plain(tab, o_t, d_t, float(t_min), alive, ordered=True,
                         stats=stats, time=time)
    return _bounce_values(tab, o_t, d_t, uni_t, *hit, time=time)


# -------------------------------------------------------------- kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_float, _I,     # o d alive uni tmin n
             _P, _P, _I,                             # sph sph_mat n_sph
             _P, _P, _I,                             # rect rect_mat n_rect
             _P, _P, _P, _I,                         # tri tri_nrm tri_mat n
             _P]                                     # mat
_OUTS = [_P, _P, _P, _P, _P, _P, _P]                 # no nd att emit p n inter
# the scene-order tables, as every kernel that ends in the epilogue takes
# them (the tail of _ARGTYPES)
TABLE_ARGTYPES = _ARGTYPES[6:]
# an ordered stage: prim, orig, cull, scull, box, k_ch, chunk (all null/0
# for a flat stage)
STAGE_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I]


def stage_args(stage: Optional[OrderedStage], dev) -> list:
    """The C arguments of an ordered stage (null pointers for None)."""
    if stage is None:
        return [None] * 5 + [0, 0]
    for name, x in zip(stage._fields, stage):
        if x is not None and (x.device != dev or not x.is_contiguous()):
            raise ValueError(f"ordered stage: {name} must be contiguous on "
                             f"{dev}")
    return ([x.data_ptr() for x in stage[:5]]
            + [stage.cull.shape[0], stage.chunk])


def motion_args(tab: BounceTables, time, n: int, dev, who: str,
                ordered: bool) -> list:
    """The C arguments the motion entry points add: the sphere
    velocities, for the ordered kernels the sphere stage's sorted
    velocities (null when the spheres are swept flat), and the (N,) f32
    shutter time."""
    _check("time", time, dev, torch.float32, (n,), who)
    _check("sph_vel", tab.sph_vel, dev, torch.float32,
           (tab.sph.shape[0], 4), who)
    out = [tab.sph_vel.data_ptr()]
    if ordered:
        out.append(None if tab.osph is None else tab.osph.vel.data_ptr())
    return out + [time.data_ptr()]


def stats_arg(stats, n: int, dev):
    """The optional (G, 2) int32 per-warp chunk-body counter of the
    ordered kernels, G = ceil(n / 32) (null when None)."""
    if stats is None:
        return None
    g = -(-n // ordered_ops.GROUP)
    _check("stats", stats, dev, torch.int32, (g, 2), "ordered walk")
    return stats.data_ptr()


def _check(name, x, dev, dtype, shape, who="bounce"):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(
            f"{who}: {name} must be {dtype} {shape} on {dev}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def table_args(tab: BounceTables, dev, who: str = "bounce") -> list:
    """The C arguments of the scene-order tables (``TABLE_ARGTYPES``),
    each checked to be contiguous on ``dev``."""
    for name in FLAT:
        x = getattr(tab, name)
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{who}: table {name} must be contiguous on "
                             f"{dev}")
    return [tab.sph.data_ptr(), tab.sph_mat.data_ptr(), tab.sph.shape[0],
            tab.rect.data_ptr(), tab.rect_mat.data_ptr(), tab.rect.shape[0],
            tab.tri.data_ptr(), tab.tri_nrm.data_ptr(), tab.tri_mat.data_ptr(),
            tab.tri.shape[0], tab.mat.data_ptr()]


def sweep_forms(kernel: str, name: str, argtypes: list,
                outtypes: list = ()) -> dict:
    """The four forms of sweep kernel ``kernel`` ("bounce", "closest" or
    "regen"), made once for ``launch_sweep``: {(ordered, motion): (its
    ``launch_counts`` key ``<kernel><form>``, library (``<kernel>`` or
    ``<kernel>_ordered``), entry point ``rt_<kernel><form>``, argument
    types, what a refused launch's message calls it)}. The arguments, in
    the order of every form: ``argtypes``, both stages if ordered, the
    output pointers ``outtypes`` (regen has none), the stats if ordered,
    the motion pointers if moving, the stream. ``name`` names the kernel
    in the message."""
    forms = {}
    for ordered in (False, True):
        for motion in (False, True):
            key = kernel + "_ordered" * ordered + "_motion" * motion
            # the stats if ordered; sph_vel, (osph.vel,) time if moving
            types = [*argtypes, *STAGE_ARGTYPES * (2 * ordered), *outtypes,
                     *[_P] * (ordered + (2 + ordered) * motion), _P]
            forms[ordered, motion] = (
                key, kernel + "_ordered" * ordered, "rt_" + key, types,
                "ordered " * ordered + name + " kernel" + " (motion)" * motion)
    return forms


def launch_sweep(forms: dict, tab: BounceTables, args: list, n: int, dev,
                 who: str, outs=(), stats=None, time=None):
    """Launch the form of a sweep kernel (``forms``, from ``sweep_forms``)
    that the tables and the call take: ordered when a stage of ``tab``
    takes the walk, motion when ``tab.moves(time)``. ``args``, the
    arguments every form begins with, is extended in place by the rest of
    that form's, in the order ``sweep_forms`` gives (``outs``: the output
    pointers); ``who`` names the caller in a bad input's message."""
    ordered, motion = tab.ordered, tab.moves(time)
    key, library, symbol, types, what = forms[ordered, motion]
    if ordered:
        args += [*stage_args(tab.osph, dev), *stage_args(tab.otri, dev),
                 *outs, stats_arg(stats, n, dev)]
    else:
        args += outs
    if motion:
        args += motion_args(tab, time, n, dev, who, ordered)
    with torch.cuda.device(dev):
        args.append(torch.cuda.current_stream(dev).cuda_stream)
        launch(key, library, symbol, types, args, what)


_FORMS = sweep_forms("bounce", "bounce", _ARGTYPES, _OUTS)


def _bounce_cuda(tab: BounceTables, o_t, d_t, t_min: float, alive, uni_t,
                 stats=None, time=None):
    dev = o_t.device
    n = o_t.shape[1]
    f32 = torch.float32
    _check("o_t", o_t, dev, f32, (3, n))
    _check("d_t", d_t, dev, f32, (3, n))
    _check("alive", alive, dev, torch.bool, (n,))
    _check("uni_t", uni_t, dev, f32, (4, n))
    rows = [torch.empty((3, n), dtype=f32, device=dev) for _ in range(6)]
    inter = torch.empty((n,), dtype=torch.int32, device=dev)
    args = [o_t.data_ptr(), d_t.data_ptr(), alive.data_ptr(),
            uni_t.data_ptr(), float(t_min), n, *table_args(tab, dev)]
    outs = [r.data_ptr() for r in rows] + [inter.data_ptr()]
    launch_sweep(_FORMS, tab, args, n, dev, "bounce", outs, stats, time)
    no, nd, att, emit, p, nrm = rows
    return inter, no, nd, att, emit, p, nrm


def bounce_tables(tab: BounceTables, o_t, d_t, t_min: float, alive, uni_t,
                  stats=None, time=None):
    """One fused bounce over packed tables. ``o_t``/``d_t`` (3, N) f32,
    ``alive`` (N,) bool, ``uni_t`` (4, N) f32: scatter uniforms in rows
    0-2 and the spawn epsilon in row 3. Returns (inter (N,) int32, new_o,
    new_d, att, emit, p, n), each (3, N) f32. Dead lanes get the miss
    outputs (inter ABSORB, zero emission, p = o). Tables with an ordered
    stage take the ordered kernel; ``stats`` (G, 2) int32 zeros, G =
    ceil(N / 32), then receives its chunk bodies per warp (spheres,
    triangles). ``time`` (N,) f32: the rays' shutter times; on moving
    tables they take the kernels' motion form.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if o_t.device.type == "cpu":
        if tab.ordered:
            return bounce_ordered_plain(tab, o_t, d_t, t_min, alive, uni_t,
                                        stats, time)
        return bounce_fused_plain(tab, o_t, d_t, t_min, alive, uni_t, time)
    if o_t.device.type != "cuda":
        raise NotImplementedError(f"bounce: no kernel for {o_t.device}")
    return _bounce_cuda(tab, o_t, d_t, t_min, alive, uni_t, stats, time)


def bounce_fused(scene: Scene, o_t, d_t, t_min: float, alive, uni_t,
                 time=None):
    """One fused bounce on a scene: the JAX ``bounce_fused`` interface,
    rays on the second axis (``o_t``/``d_t`` (3, N), ``uni_t`` (4, N)),
    ``time`` (N,) for motion blur. Packs the tables on every call; loops
    pack once and call ``bounce_tables``."""
    if not fused_eligible(scene):
        raise ValueError("the fused bounce takes no image or noise "
                         "texture and no medium (JAX "
                         "bounce_fused_eligible): use the unfused stage")
    return bounce_tables(pack_tables(scene), o_t, d_t, t_min, alive, uni_t,
                         time=time)
