"""Path-regeneration wavefronts on tensors: the path tracer and the SPPM
passes.

The PyTorch counterpart of ``raytracer_tpu/models/wavefront_soa.py``:
``camera_rays_soa``, ``block_order``, the drain cascade ``_drain_sizes``,
``bounce_step`` (fused, and unfused: ``attrs_soa``, ``eval_texture_soa``,
``scatter_soa``), ``_mis_bounce``, ``trace_radiance_soa`` and
``render_regen_soa`` with NEE and MIS (and, where neither is on, its
one-kernel step, ``ops/regen.py``), and for SPPM ``gather_regen_soa``,
``measurement_soa`` (``measure_walk_soa`` of ``measure_step``),
``emit_photons_soa`` and the regenerating photon pass ``PhotonPass``
(``trace_photon_deposits_regen_soa`` runs it eagerly; with no spawn
window it is JAX's photon pass without regeneration), whose step after
the bounce is one kernel on CUDA (``ops/photon_step.py``).
The SPPM passes take the "pallas" or the "leaf" route (``intersector``);
``--debug-nans`` checks each loop's state after every step
(``utils/nans.py``).

Media, image and noise textures (JAX ``bounce_fused_eligible``): such a
scene leaves the fused bounce and the one-kernel step for the unfused
stage (``use_fused``), whose texture evaluation reads the image atlas and
the marble noise (``eval_texture_soa``). On a scene with K media the path
tracer's loops draw K free-flight rows after every row they already draw,
and the unfused bounce lets a medium event replace the closest hit
(``ops/media.py::apply_media_soa``); a media-free scene draws exactly what
it drew before.

Motion blur (JAX ``wavefront_soa.py``'s ``motion`` carry): on a scene whose
spheres move, each sample owns one shutter time in [time0, time1], drawn
with the sample (the first draw's fifth row, then U row 8 at every
respawn), carried per lane (``_Lanes.time``) through the drain cascade, and
handed to the bounce, the NEE shadow rays and the MIS light sampling. A
static scene carries no time and draws exactly the rows it drew before.

Lane state is kept as (3, N) rows (origin, direction, throughput, sample
radiance, accumulated radiance) and (N,) vectors (alive, depth, done), so
one tensor op updates all three components. The loop runs eagerly: a
Python ``while`` around one regeneration-kernel launch per step, or, with
NEE, MIS or the SPPM gather, one bounce-kernel launch plus the
bookkeeping ops, with one host sync per step for the loop condition.
The photon pass has a static step count and no host sync: on the card
SPPM replays it as a CUDA graph (``models/sppm.py::graphed_photon_pass``).
A measurement step (``measure_step``) reads nothing either, so SPPM
replays a head of the walk's steps the same way
(``graphed_measure_and_update``).

On tables with an ordered stage (``ops/ordered.py``) the photon pass and
the measurement walk count the walk's work on the device (``WalkCount``:
chunk bodies and live warps, counters ``ordered.bodies`` and
``ordered.warps``, read once when a recording ends); on flat tables they
count, launch and read nothing for it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from raytracer_tpu_torch.kernels import launch_counts, launches_since
from raytracer_tpu_torch.ops import dispatch
from raytracer_tpu_torch.ops import media as media_ops
from raytracer_tpu_torch.ops import mis as mis_ops
from raytracer_tpu_torch.ops import nee as nee_ops
from raytracer_tpu_torch.ops import ordered as ordered_ops
from raytracer_tpu_torch.ops import photon_step as photon_step_ops
from raytracer_tpu_torch.ops import regen as regen_ops
from raytracer_tpu_torch.ops.fused_bounce import (
    BounceTables, _take, _unit3, bounce_tables, fused_eligible, has_media,
)
from raytracer_tpu_torch.ops.lights import light_cols, pick_light
from raytracer_tpu_torch.ops.materials import image_texel
from raytracer_tpu_torch.ops.noise import marble
from raytracer_tpu_torch.ops.sampling import (
    camera_rays_soa, uniform_sphere_from,
)
from raytracer_tpu_torch.utils import nans, timing
from raytracer_tpu_torch.scene.types import (
    INTER_ABSORB, INTER_DIFFUSE, INTER_REFLECT, INTER_REFRACT,
    INTER_SPECULAR, LIGHT_SPHERE, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT,
    MAT_ISOTROPIC, MAT_LAMBERTIAN, MAT_METAL, PRIM_MEDIA, PRIM_RECT,
    PRIM_SPHERE, PRIM_TRIANGLE, TEX_CHECKER, TEX_IMAGE, TEX_NOISE, Lights,
    Scene,
)

PI = 3.141592653589793
TWO_PI = 6.283185307179586
FRAC_1_PI = 0.3183098861837907

# Per-step uniform rows: one (8, n) draw per step, consumed as in the JAX
# package. Rows 0-1 are the unit-sphere pair shared by the diffuse bounce
# and the metal fuzz, row 2 the dielectric reflect choice, row 3 Russian
# roulette, rows 4-7 the camera respawn (jitter x, jitter y, lens r, lens
# phi); a moving scene draws row 8, the respawn's shutter time.
U_SPH1, U_SPH2, U_DIEL, U_RR = 0, 1, 2, 3
U_TRACE_ROWS = 4                    # the photon pass stops here
U_JX, U_JY, U_LR, U_LPHI = 4, 5, 6, 7
U_REGEN_ROWS = 8
# With NEE (MIS), nee.NEE_ROWS (mis.MIS_ROWS) more rows follow the loop's
# own: the JAX package draws them from separate keys (fold 53, fold 61).
# On a scene with media, one free-flight row per medium comes last (JAX:
# fold 29).

RR_START_BOUNCE = 3

# Drain cascade: each time the live lane count falls below the next level,
# the survivors are compacted once (alive first, stable order) into a
# narrower wavefront, down to this floor.
DRAIN_MIN_LANES = 32768


class Bounce(NamedTuple):
    """One bounce's outcome, in the order ``bounce_tables`` returns it:
    interaction code (N,) and (3, N) rows of the candidate next ray
    (spawn-offset origin and scattered direction), attenuation, emission,
    hit point and shading normal. Emission and interaction are already
    miss-masked."""
    inter: torch.Tensor
    no: torch.Tensor
    nd: torch.Tensor
    att: torch.Tensor
    emit: torch.Tensor
    p: torch.Tensor
    n: torch.Tensor


def block_order(width: int, height: int, bs: int = 16):
    """Lane -> pixel permutation putting a bs x bs pixel block into each
    group of bs*bs consecutive lanes, so neighbouring lanes trace
    neighbouring rays. Returns (perm, inv): numpy int32 arrays,
    perm[lane_slot] = pixel id."""
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    nbx = -(-width // bs)
    key_ = (((ys // bs) * nbx + (xs // bs)) * (bs * bs)
            + (ys % bs) * bs + (xs % bs))
    perm = np.argsort(key_.reshape(-1), kind="stable").astype(np.int32)
    inv = np.argsort(perm, kind="stable").astype(np.int32)
    return perm, inv


def _drain_sizes(n: int):
    """Cascade level widths: n, n/2, ..., floor (256-aligned). The
    monotonic guard matters: 256-rounding can fail to shrink near small
    floors."""
    sizes = [n]
    while sizes[-1] > DRAIN_MIN_LANES:
        nxt = max(DRAIN_MIN_LANES, -(-(sizes[-1] // 2) // 256) * 256)
        if nxt >= sizes[-1]:
            break
        sizes.append(nxt)
    return sizes


class HitSoA(NamedTuple):
    """Hit attributes (hit.rs:24-30): (N,) vectors and (3, N) rows."""
    valid: torch.Tensor   # (N,) bool
    t: torch.Tensor       # (N,) +inf on a miss
    p: torch.Tensor       # (3, N) hit point
    n: torch.Tensor       # (3, N) unit normal, flipped against the ray
    front: torch.Tensor   # (N,) bool
    u: torch.Tensor       # (N,) surface uv
    v: torch.Tensor


class FeatSoA(NamedTuple):
    """The winner's material features."""
    kind: torch.Tensor      # (N,) int32 MAT_*
    fuzz: torch.Tensor      # (N,)
    ir: torch.Tensor        # (N,) at least 1e-6
    tex_kind: torch.Tensor  # (N,) int32 TEX_*
    c0: torch.Tensor        # (3, N) texture colour 0
    c1: torch.Tensor        # (3, N) texture colour 1 (checker)
    image_id: torch.Tensor  # (N,) int32


def attrs_soa(tables: BounceTables, o, d, hit, time=None) -> tuple:
    """Hit attributes and material features of the closest-hit winner
    ``hit`` (``closest_hit.Closest``: t, type, index, b1, b2), read from the
    packed tables (JAX ``attrs_soa`` reads them from the kernel's 28 winner
    slots). ``o``/``d`` (3, N); ``time`` (N,): the rays' shutter times, at
    which a moving sphere winner's centre is taken (JAX ``_run``'s centre
    fold). A miss gives zero normal and features, as the TPU kernel's
    all-zero winner record does. A medium event (``PRIM_MEDIA``, index
    the medium's) gets its medium's material (``tables.med_mat``), the
    dummy normal (1, 0, 0) of medium.rs:45 flipped to face the ray, and
    uv (0, 0). Returns (HitSoA, FeatSoA)."""
    valid = torch.isfinite(hit.t)
    p = o + torch.where(valid, hit.t, 0.0) * d
    ix = hit.ix.long()
    is_s = hit.ty == PRIM_SPHERE
    is_r = hit.ty == PRIM_RECT
    is_t = hit.ty == PRIM_TRIANGLE
    is_m = hit.ty == PRIM_MEDIA

    sph = _take(tables.sph, ix, is_s)
    c = sph[:, :3].T
    if tables.moves(time):
        c = c + _take(tables.sph_vel, ix, is_s)[:, :3].T * time
    inv_r = 1.0 / torch.sqrt(torch.clamp(sph[:, 3], min=1e-20))
    sn = (p - c) * inv_r
    # rect: axis, k, a0, a1, b0, b1; (a, b) are the two in-plane axes
    rect = _take(tables.rect, ix, is_r)
    axis = rect[:, 0]
    rn = torch.stack([(axis == a).to(p.dtype) for a in range(3)])
    pa = torch.where(axis == 0, p[1], p[0])
    pb = torch.where(axis == 2, p[1], p[2])
    a0, a1, b0, b1 = rect[:, 2], rect[:, 3], rect[:, 4], rect[:, 5]
    rect_u = (pa - a0) / torch.where(a1 != a0, a1 - a0, 1.0)
    rect_v = (pb - b0) / torch.where(b1 != b0, b1 - b0, 1.0)
    nrm = _take(tables.tri_nrm, ix, is_t).T.reshape(3, 3, -1)
    tb0 = 1.0 - hit.b1 - hit.b2
    tn = torch.stack(_unit3(*(tb0 * nrm[0] + hit.b1 * nrm[1]
                              + hit.b2 * nrm[2])))

    dummy = (torch.arange(3, device=p.device) == 0).to(p.dtype)[:, None]
    no = torch.where(is_s, sn, torch.where(is_r, rn,
                                           torch.where(is_m, dummy, tn)))
    # sphere uv (sphere.rs:16-21); triangles and media get (0, 0)
    theta = torch.arccos(torch.clamp(-sn[1], -1.0, 1.0))
    phi = torch.atan2(-sn[2], sn[0]) + PI
    u = torch.where(is_s, phi / TWO_PI, torch.where(is_r, rect_u, 0.0))
    v = torch.where(is_s, theta / PI, torch.where(is_r, rect_v, 0.0))
    front = (d * no).sum(0) < 0.0
    n = torch.stack(_unit3(*(no * torch.where(front, 1.0, -1.0))))

    mid = torch.where(is_s, _take(tables.sph_mat, ix, is_s),
                      torch.where(is_r, _take(tables.rect_mat, ix, is_r),
                                  _take(tables.tri_mat, ix, is_t)))
    if tables.med_mat is not None:
        mid = torch.where(is_m, _take(tables.med_mat, ix, is_m), mid)
    feat = _take(tables.mat, mid.long(), valid)
    i32 = torch.int32
    feats = FeatSoA(
        kind=torch.round(feat[:, 0]).to(i32), fuzz=feat[:, 1],
        ir=torch.clamp(feat[:, 2], min=1e-6),
        tex_kind=torch.round(feat[:, 3]).to(i32), c0=feat[:, 4:7].T,
        c1=feat[:, 7:10].T, image_id=torch.round(feat[:, 10]).to(i32))
    return HitSoA(valid, hit.t, p, n, front, u, v), feats


def eval_texture_soa(scene: Scene, f: FeatSoA, h: HitSoA):
    """The albedo (3, N): constant and checker textures (the checker picks
    colour 1 where sin(10x) sin(10y) sin(10z) >= 0), images at their
    nearest texel (``materials.image_texel``: u, v clamped, v flipped) and
    the marble noise with its scale in colour 0's first channel, the same
    in all three channels."""
    sines = (torch.sin(10.0 * h.p[0]) * torch.sin(10.0 * h.p[1])
             * torch.sin(10.0 * h.p[2]))
    out = torch.where((f.tex_kind == TEX_CHECKER) & (sines >= 0.0), f.c1,
                      f.c0)
    if scene.images.shape[0]:
        out = torch.where(f.tex_kind == TEX_IMAGE,
                          image_texel(scene, f.image_id, h.u, h.v).T, out)
    if scene.textures.noise_marker.shape[0]:
        out = torch.where(f.tex_kind == TEX_NOISE,
                          marble(h.p.T, f.c0[0]), out)
    return out


class ScatterSoA(NamedTuple):
    inter: torch.Tensor   # (N,) int32 INTER_*
    nd: torch.Tensor      # (3, N) scattered direction
    att: torch.Tensor     # (3, N) attenuation
    emit: torch.Tensor    # (3, N) emitted radiance


def scatter_soa(scene: Scene, uni, d, h: HitSoA, f: FeatSoA) -> ScatterSoA:
    """materials.scatter on rows (material.rs:92-231 semantics), from the
    uniform rows U_SPH1, U_SPH2 (the unit-sphere pair shared by the diffuse
    bounce, the metal fuzz and the isotropic phase: kinds are exclusive per
    lane) and U_DIEL (the dielectric's reflect choice)."""
    alb = eval_texture_soa(scene, f, h)
    n = h.n
    sph = uniform_sphere_from(uni[U_SPH1], uni[U_SPH2])

    # Lambertian / diffuse light: n + unit sphere, near-zero guard
    lam = n + sph
    lam = torch.where((lam * lam).sum(0) < 1e-16, n, lam)
    # metal: reflect(unit d) + fuzz * unit sphere; absorb below the surface
    ud = torch.stack(_unit3(*d))
    dn = (ud * n).sum(0)
    refl = ud - 2.0 * dn * n
    met = refl + f.fuzz * sph
    metal_ok = (met * n).sum(0) > 0.0
    # dielectric: Schlick + total internal reflection against U_DIEL
    ratio = torch.where(h.front, 1.0 / f.ir, f.ir)
    cos_t = torch.clamp(-(ud * n).sum(0), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    cannot = ratio * sin_t > 1.0
    r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
    schlick = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
    do_refl = cannot | (schlick > uni[U_DIEL])
    perp = ratio * (ud + cos_t * n)
    par = -torch.sqrt((1.0 - (perp * perp).sum(0)).abs())
    die = torch.where(do_refl, refl, perp + par * n)

    is_met = f.kind == MAT_METAL
    is_die = f.kind == MAT_DIELECTRIC
    is_lgt = f.kind == MAT_DIFFUSE_LIGHT
    is_iso = f.kind == MAT_ISOTROPIC
    diffish = (f.kind == MAT_LAMBERTIAN) | is_lgt
    nd = torch.where(diffish, lam, torch.where(
        is_met, met, torch.where(is_iso, sph, die)))
    att = torch.where(is_lgt, FRAC_1_PI, alb)
    inter = torch.where(
        diffish, INTER_DIFFUSE,
        torch.where(is_met,
                    torch.where(metal_ok, INTER_SPECULAR, INTER_ABSORB),
                    torch.where(is_die,
                                torch.where(do_refl, INTER_REFLECT,
                                            INTER_REFRACT),
                                INTER_DIFFUSE)))
    inter = torch.where(h.valid, inter, INTER_ABSORB).to(torch.int32)
    emit = torch.where(is_lgt & h.valid, alb, 0.0)
    return ScatterSoA(inter, nd, att, emit)


def use_fused(scene: Scene, intersector: str) -> bool:
    """The fused bounce kernel serves every scene the JAX package's
    ``use_fused`` gives it (``bounce_fused_eligible``: no image or noise
    textures, no media, the "pallas" route) and also scenes past the TPU
    kernel's table caps, which the CUDA kernels read from global memory.
    The "leaf" route is unfused, as in the JAX package."""
    return intersector == "pallas" and fused_eligible(scene)


def media_rows(scene: Scene) -> int:
    """Free-flight rows a path-tracer step draws: one per medium."""
    return int(scene.media.kind.shape[0]) if has_media(scene) else 0


def bounce_step(tables: BounceTables, uni, o, d, alive, *, t_min: float,
                spawn_eps, fused: bool = True, scene: Scene = None,
                intersector: str = "pallas", time=None,
                media_u=None, stats=None) -> Bounce:
    """Advance one bounce: intersect + attributes + texture + scatter.
    ``uni`` holds at least the three scatter rows; ``spawn_eps`` is a 0-d
    tensor (or float). The fused path is one kernel launch
    (``bounce_tables``); the unfused path (``fused=False``, which needs
    ``scene`` for its textures) is the closest hit of ``intersector``'s
    route (``dispatch.intersect_scene``: the closest-hit kernel, or the
    leaf kernel for "leaf") followed by ``attrs_soa`` and ``scatter_soa``
    in plain PyTorch. Both consume the same uniform rows and give dead
    lanes the miss outputs, so they agree lane for lane. ``time`` (N,):
    the lanes' shutter times (motion blur). ``media_u`` (K, N): free-flight
    uniforms (``ops/media.py``) on the unfused path of a scene with K
    media; a medium event then replaces the closest hit (JAX
    ``bounce_step``'s ``media_key``, applied after the "pallas" and the
    "leaf" route's closest hit alike), and the spawn offset follows its
    dummy normal. ``stats``: the fused ordered bounce's chunk bodies per
    warp (``bounce_tables``; ``WalkCount.slot``)."""
    n = o.shape[1]
    if fused:
        eps = torch.as_tensor(spawn_eps, dtype=torch.float32,
                              device=o.device)
        uni_t = torch.cat([uni[U_SPH1:U_DIEL + 1], eps.expand(1, n)], 0)
        return Bounce(*bounce_tables(tables, o, d, t_min, alive, uni_t,
                                     stats=stats, time=time))
    hit = dispatch.intersect_scene(scene, o, d, t_min, float("inf"),
                                   method=intersector, alive=alive,
                                   tables=tables, time=time)
    if media_u is not None:
        hit = media_ops.apply_media_soa(scene.media, media_u, o, d, hit,
                                        t_min)
    h, f = attrs_soa(tables, o, d, hit, time)
    sc = scatter_soa(scene, uni, d, h, f)
    side = torch.sign((sc.nd * h.n).sum(0)) * spawn_eps
    return Bounce(sc.inter, h.p + h.n * side, sc.nd, sc.att, sc.emit, h.p,
                  h.n)


def _mis_bounce(lights: Lights, rows, b: Bounce, diffuse_now,
                spawn_eps, time=None) -> Bounce:
    """``--mis``: resample the diffuse lanes' directions through the 50/50
    cosine/light mixture (``mis.mixture_reweight`` on ``mis.MIS_ROWS``
    uniform rows, moving lights at the lanes' ``time``), reweight their
    attenuation by pdf_cos/pdf_mix and offset the spawn origin against the
    new direction."""
    d_new, w = mis_ops.mixture_reweight(lights, rows, b.p, b.n, b.nd,
                                        diffuse_now, time)
    side = torch.sign((d_new * b.n).sum(0)) * spawn_eps
    return b._replace(att=torch.where(diffuse_now, b.att * w, b.att),
                      no=torch.where(diffuse_now, b.p + b.n * side, b.no),
                      nd=torch.where(diffuse_now, d_new, b.nd))


def _extra_rows(nee: bool, mis: bool) -> int:
    return nee_ops.NEE_ROWS if nee else (mis_ops.MIS_ROWS if mis else 0)


def _media_u(U, start: int, k: int):
    """The free-flight uniforms (K, N) in U's last ``k`` rows (from
    ``start``), or None on a media-free scene."""
    return media_ops.uniform_rows(U[start:start + k]) if k else None


def _shade(scene, tables, U, base: int, b: Bounce, alive, tput, samp,
           prev_diff, *, nee: bool, mis: bool, spawn_eps,
           intersector: str = "pallas", time=None):
    """The part of a step that NEE and MIS touch, in the JAX loop's order:
    emission (skipped after a diffuse vertex under NEE), then the MIS
    resample, then the NEE shadow ray. ``U[base:]`` holds the NEE or MIS
    rows; the shadow rays take ``intersector``'s route and the lanes'
    shutter ``time``. Returns (bounce, sample radiance, diffuse lanes,
    shadow-ray lanes or None)."""
    emit_ok = alive & ~prev_diff
    samp = samp + torch.where(emit_ok, tput * b.emit, 0.0)
    diffuse_now = alive & (b.inter == INTER_DIFFUSE)
    shadow = None
    if mis:
        b = _mis_bounce(scene.lights, U[base:base + mis_ops.MIS_ROWS], b,
                        diffuse_now, spawn_eps, time)
    if nee:
        dl, shadow = nee_ops.direct_light(
            scene, tables, U[base:base + nee_ops.NEE_ROWS], b.p, b.n, b.att,
            diffuse_now, alive=alive, intersector=intersector, time=time)
        samp = samp + torch.where(diffuse_now, tput * dl, 0.0)
    return b, samp, diffuse_now, shadow


def trace_radiance_soa(scene: Scene, tables: BounceTables, o, d,
                       gen: torch.Generator, *, max_depth: int,
                       t_min: float, spawn_eps, intersector: str = "pallas",
                       russian_roulette: bool = True, nee: bool = False,
                       mis: bool = False, time=None, stats: dict = None):
    """Trace a wavefront of rays ``o``/``d`` (3, N) to completion, at most
    ``max_depth`` bounces, with no regeneration (the loop of the JAX NEE and
    MIS oracles). ``time`` (N,): each ray's shutter time, kept through its
    bounces (motion blur). One host sync per step for the loop condition.
    ``stats``, if given, gets the NEE shadow rays cast added to
    ``shadow_lanes`` and the steps to ``steps``.
    Returns ((3, N) radiance, rays traced as an int: alive lanes summed
    over steps)."""
    n = o.shape[1]
    dev = o.device
    fused = use_fused(scene, intersector)
    base = U_TRACE_ROWS + _extra_rows(nee, mis)
    k_med = media_rows(scene)
    tput = torch.ones((3, n), device=dev)
    rad = torch.zeros((3, n), device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_diff = torch.zeros_like(alive)
    rays = 0
    step = 0
    shadow = torch.zeros((), dtype=torch.int64, device=dev)
    while step < max_depth:
        n_alive = int(alive.sum())
        if n_alive == 0:
            break
        rays += n_alive
        U = torch.rand((base + k_med, n), generator=gen, device=dev)
        b = bounce_step(tables, U, o, d, alive, t_min=t_min,
                        spawn_eps=spawn_eps, fused=fused, scene=scene,
                        intersector=intersector, time=time,
                        media_u=_media_u(U, base, k_med))
        b, rad, diffuse_now, cast = _shade(
            scene, tables, U, U_TRACE_ROWS, b, alive, tput, rad, prev_diff,
            nee=nee, mis=mis, spawn_eps=spawn_eps, intersector=intersector,
            time=time)
        cont = alive & (b.inter != INTER_ABSORB)
        tput = torch.where(cont, tput * b.att, tput)
        if russian_roulette and step >= RR_START_BOUNCE:
            p_surv = torch.clamp(tput.amax(0), 0.05, 1.0)
            survive = U[U_RR] < p_surv
            tput = tput * torch.where(cont & survive, 1.0 / p_surv, 1.0)
            cont = cont & survive
        o = torch.where(cont, b.no, o)
        d = torch.where(cont, b.nd, d)
        if nee:
            prev_diff = diffuse_now
            shadow += cast.sum()
        alive = cont
        step += 1
        nans.check("a path-tracer step", radiance=rad, throughput=tput,
                   origin=o, direction=d)
    if stats is not None:
        stats["shadow_lanes"] = stats.get("shadow_lanes", 0) + int(shadow)
        stats["steps"] = stats.get("steps", 0) + step
    return rad, rays


class _Lanes(NamedTuple):
    """Per-lane state of the regeneration loop."""
    o: torch.Tensor       # (3, n) ray origin
    d: torch.Tensor       # (3, n) ray direction
    tput: torch.Tensor    # (3, n) path throughput
    samp: torch.Tensor    # (3, n) radiance of the sample in flight
    acc: torch.Tensor     # (3, n) radiance of the lane's finished samples
    alive: torch.Tensor   # (n,) bool
    depth: torch.Tensor   # (n,) int32 bounces of the sample in flight
    done: torch.Tensor    # (n,) int32 samples finished
    px: torch.Tensor      # (n,) f32 pixel x
    py: torch.Tensor      # (n,) f32 pixel y
    slot: torch.Tensor    # (n,) int64 output slot
    # (n,) bool: the last bounce was diffuse and NEE already counted the
    # light it would find (gates emission; cleared on respawn)
    prev_diff: torch.Tensor
    # (3, n) the pixel's SPPM density estimate (final gather only)
    est: Optional[torch.Tensor] = None
    # (n,) f32 the shutter time of the sample in flight (motion blur only)
    time: Optional[torch.Tensor] = None


def _step(s: _Lanes, tables, scene, gen, *, width, height, quota, max_depth,
          t_min, spawn_eps, russian_roulette, fused, nee, mis, intersector):
    """One regeneration step: bounce, accumulate emission, MIS resample,
    NEE, update the throughput, Russian roulette, retire and respawn camera
    rays. With ``s.est`` (the SPPM final gather, photon_mapper.rs:326-365)
    the first diffuse hit adds the pixel's density estimate and ends the
    sample. Returns (lanes, shadow-ray lanes of the step or None)."""
    nl = s.o.shape[1]
    base = U_REGEN_ROWS + (s.time is not None)     # the time row, if moving
    rows = base + _extra_rows(nee, mis)
    k_med = media_rows(scene)
    U = torch.rand((rows + k_med, nl), generator=gen, device=s.o.device)
    b = bounce_step(tables, U, s.o, s.d, s.alive, t_min=t_min,
                    spawn_eps=spawn_eps, fused=fused, scene=scene,
                    intersector=intersector, time=s.time,
                    media_u=_media_u(U, rows, k_med))
    alive = s.alive
    b, samp, diffuse_now, shadow = _shade(
        scene, tables, U, base, b, alive, s.tput, s.samp,
        s.prev_diff, nee=nee, mis=mis, spawn_eps=spawn_eps,
        intersector=intersector, time=s.time)
    stop = None
    if s.est is not None:
        samp = samp + torch.where(diffuse_now, s.tput * s.est, 0.0)
        stop = diffuse_now
    s2, regen = regen_ops.regen_bookkeeping(
        s, scene.camera, U, b.inter, b.no, b.nd, b.att, samp, width=width,
        height=height, quota=quota, max_depth=max_depth,
        rr_on=russian_roulette, rr_start=RR_START_BOUNCE, stop=stop)
    prev_diff = (diffuse_now if nee else s.prev_diff) & ~regen
    return s2._replace(prev_diff=prev_diff), shadow


# Test hook: False sends the one-kernel step's route through the loop's own
# step (``_step``: a bounce launch and the bookkeeping in eager ops), the
# reference that the one-kernel step is held to.
_ONE_KERNEL_STEP = True


def render_regen_soa(scene, tables: BounceTables, gen: torch.Generator, *,
                     width: int, height: int, lanes_per_pixel: int,
                     samples_per_lane: int, max_depth: int, t_min: float,
                     spawn_eps, intersector: str = "pallas",
                     russian_roulette: bool = True, nee: bool = False,
                     mis: bool = False, est=None, stats: dict = None,
                     pixel_slots=None):
    """Path-regeneration wavefront renderer. When a lane's sample retires
    (miss, absorb, RR kill or depth cap) the lane spawns its pixel's next
    sample at once. Lane l serves pixel slot l % n_out for
    ``samples_per_lane`` samples, so per-pixel spp = lanes_per_pixel *
    samples_per_lane. Stragglers drain through the compaction cascade of
    ``_drain_sizes``. The slots are the whole image in ``block_order``,
    or ``pixel_slots`` (n_out,), the pixel ids of a shard
    (``parallel/render.py`` passes its block-permuted slice; an id may
    repeat). ``est`` (npix, 3), pixel-ordered, or (n_out, 3) in slot order
    with ``pixel_slots``: the SPPM density estimates of
    ``gather_regen_soa``. ``nee``/``mis`` add next-event
    estimation or the mixture resample at diffuse vertices. ``stats``, if
    given, gets ``shadow_lanes``: the NEE shadow rays cast, which are not
    counted as rays, and ``steps``. On the fused route without NEE, MIS
    or ``est`` (where JAX's ``RAYTRACER_TPU_REGEN_FUSED`` route runs) each
    step is one ``regen_ops.regen_step_tables`` launch on the loop's
    uniform draw, with the loop's own step's result; elsewhere it is
    ``_step``. Moving tables (``tables.sph_vel``) give every sample a
    shutter time (module docstring).

    Returns ((npix, 3) radiance sum over all samples in pixel order, or
    (n_out, 3) in slot order with ``pixel_slots``, rays traced (alive
    lanes summed over steps, an int), loop steps)."""
    # the lanes and the step's arguments
    with timing.span("regen.setup"):
        dev = tables.sph.device
        cam = scene.camera
        if pixel_slots is None:
            perm, inv = block_order(width, height)
            slots = torch.as_tensor(perm, device=dev).long()
        else:
            inv = None
            slots = torch.as_tensor(pixel_slots, device=dev).long()
        n_out = slots.shape[0]
        n = n_out * lanes_per_pixel
        slot_id = torch.arange(n, device=dev) % n_out
        pix = slots[slot_id]
        px = (pix % width).to(torch.float32)
        py = (pix // width).to(torch.float32)
        motion = tables.sph_vel is not None
        first = torch.rand((4 + motion, n), generator=gen, device=dev)
        o0, d0 = camera_rays_soa(cam, px, py, width, height, first[:4])
        times = (cam.time0 + first[4] * (cam.time1 - cam.time0) if motion
                 else None)
        ones = torch.ones((3, n), device=dev)
        zeros = torch.zeros((3, n), device=dev)
        izero = torch.zeros((n,), dtype=torch.int32, device=dev)
        if est is not None and pixel_slots is None:
            est = est[slots]                   # slot order
        lane_est = None if est is None else est[slot_id].T.contiguous()
        alive0 = torch.ones((n,), dtype=torch.bool, device=dev)
        s = _Lanes(o0, d0, ones, zeros, zeros.clone(), alive0, izero,
                   izero.clone(), px, py, slot_id, ~alive0, lane_est, times)
        kw = dict(width=width, height=height, quota=samples_per_lane,
                  max_depth=max_depth, t_min=t_min, spawn_eps=spawn_eps,
                  russian_roulette=russian_roulette,
                  fused=use_fused(scene, intersector), nee=nee, mis=mis,
                  intersector=intersector)
        one_kernel = (_ONE_KERNEL_STEP and kw["fused"] and not (nee or mis)
                      and est is None)
        if one_kernel:
            cam_pack = regen_ops.pack_camera(cam)
            with timing.span("regen.eps.sync"):
                eps = float(spawn_eps)         # one host read, not per step
            rkw = dict(width=width, height=height, quota=samples_per_lane,
                       max_depth=max_depth, rr_on=russian_roulette,
                       rr_start=RR_START_BOUNCE, t_min=t_min)

    rays = 0      # a Python int: exact at any count
    steps = 0
    shadow = torch.zeros((), dtype=torch.int64, device=dev)
    accum = torch.zeros((3, n_out), device=dev)
    sizes = _drain_sizes(n)
    for level, floor in enumerate(sizes[1:] + [0]):
        while True:
            with timing.span("regen.sync"):
                n_alive = int(s.alive.sum())   # the one host sync per step
            if n_alive <= floor:
                break
            rays += n_alive
            with timing.span("regen.dispatch"):
                if one_kernel:
                    with timing.span("regen.draw"):
                        U = torch.rand((U_REGEN_ROWS + motion, s.o.shape[1]),
                                       generator=gen, device=dev)
                    s = regen_ops.regen_step_tables(tables, cam_pack, U, eps,
                                                    s, **rkw)
                else:
                    with timing.span("regen.launch"):
                        s, cast = _step(s, tables, scene, gen, **kw)
                        if cast is not None:
                            shadow += cast.sum()
            steps += 1
            nans.check("a path-regeneration step", origin=s.o,
                       direction=s.d, throughput=s.tput,
                       sample_radiance=s.samp, radiance=s.acc)
        with timing.span("regen.drain"):
            if level == 0:
                # level 0 keeps its static lane -> slot map: a reshape-sum
                accum += s.acc.reshape(3, lanes_per_pixel, n_out).sum(1)
            else:
                accum.index_add_(1, s.slot, s.acc)
            if floor:
                # survivors first, in stable order; finished radiance stays
                # behind in ``accum``
                idx = torch.argsort((~s.alive).to(torch.int8),
                                    stable=True)[:floor]
                s = _Lanes(*(None if x is None else x[..., idx] for x in s))
                s = s._replace(acc=torch.zeros_like(s.acc))
    timing.count("regen.steps", steps)
    timing.count("regen.rays", rays)
    if stats is not None:
        with timing.span("regen.shadow.sync"):
            shadow = int(shadow)
        stats["shadow_lanes"] = stats.get("shadow_lanes", 0) + shadow
        stats["steps"] = stats.get("steps", 0) + steps
    if inv is None:
        return accum.T, rays, steps
    with timing.span("regen.finish"):
        return accum.T[torch.as_tensor(inv, device=dev).long()], rays, steps


def gather_regen_soa(scene, tables: BounceTables, est, gen: torch.Generator,
                     *, width: int, height: int, lanes_per_pixel: int,
                     samples_per_lane: int, max_depth: int, t_min: float,
                     spawn_eps, intersector: str = "pallas",
                     pixel_slots=None):
    """The SPPM final gather (sample_ray, photon_mapper.rs:326-365 with the
    depth cap) on the regeneration loop of ``render_regen_soa``: Le at
    every hit, the pixel's density estimate ``est`` at the first diffuse
    hit, specular chains multiply the throughput, no Russian roulette, on
    ``intersector``'s route ("pallas" or "leaf"). ``est`` (npix, 3) in
    pixel order, or with ``pixel_slots`` (n_out,) (a pixel shard) (n_out,
    3) in slot order. Returns ((npix, 3) radiance sum in pixel order, or
    (n_out, 3) in slot order with ``pixel_slots``, rays, steps)."""
    return render_regen_soa(
        scene, tables, gen, width=width, height=height,
        lanes_per_pixel=lanes_per_pixel, samples_per_lane=samples_per_lane,
        max_depth=max_depth, t_min=t_min, spawn_eps=spawn_eps,
        intersector=intersector, russian_roulette=False, est=est,
        pixel_slots=pixel_slots)


class MeasurePoints(NamedTuple):
    """The measurement pass's first diffuse hit per pixel, (N, 3) rows as
    in the JAX package."""
    valid: torch.Tensor   # (N,) bool
    p: torch.Tensor       # (N, 3)
    normal: torch.Tensor  # (N, 3)
    bsdf: torch.Tensor    # (N, 3) the point's bsdf colour (albedo or 1/pi)


class MeasureWalk(NamedTuple):
    """The measurement walk's lanes: (3, N) rows and (N,) flags."""
    o: torch.Tensor       # (3, N) the next ray's origin
    d: torch.Tensor       # (3, N) and direction
    alive: torch.Tensor   # (N,) bool: still walking the specular chain
    valid: torch.Tensor   # (N,) bool: reached its first diffuse hit
    p: torch.Tensor       # (3, N) that hit's point
    nrm: torch.Tensor     # (3, N) its normal
    bsdf: torch.Tensor    # (3, N) its bsdf colour


def measure_lanes(o, d) -> MeasureWalk:
    """The walk's lanes before its first step, from camera rays (3, N)."""
    n = o.shape[1]
    dev = o.device
    return MeasureWalk(o, d, torch.ones((n,), dtype=torch.bool, device=dev),
                       torch.zeros((n,), dtype=torch.bool, device=dev),
                       *(torch.zeros((3, n), device=dev) for _ in range(3)))


def measure_step(tables: BounceTables, gen: torch.Generator,
                 w: MeasureWalk, *, t_min: float, spawn_eps,
                 fused: bool = True, scene: Scene = None,
                 intersector: str = "pallas", count=None,
                 slot: int = 0) -> MeasureWalk:
    """One step of the walk, with no host read: the three scatter rows
    drawn from ``gen`` and one bounce (``bounce_step``), counted in slot
    ``slot`` of ``count`` (a ``WalkCount``) if given. A lane that is not
    alive keeps its values; the draws are the same whichever lanes
    are."""
    U = torch.rand((U_DIEL + 1, w.o.shape[1]), generator=gen,
                   device=w.o.device)
    b = bounce_step(tables, U, w.o, w.d, w.alive, t_min=t_min,
                    spawn_eps=spawn_eps, fused=fused, scene=scene,
                    intersector=intersector,
                    stats=None if count is None else count.slot(slot,
                                                                w.alive))
    diffuse_now = w.alive & (b.inter == INTER_DIFFUSE)
    alive = w.alive & ~diffuse_now & (b.inter != INTER_ABSORB)
    # the bsdf colour is the scatter's attenuation (albedo, 1/pi for a
    # diffuse light): no second texture lookup
    return MeasureWalk(torch.where(alive, b.no, w.o),
                       torch.where(alive, b.nd, w.d), alive,
                       w.valid | diffuse_now,
                       torch.where(diffuse_now, b.p, w.p),
                       torch.where(diffuse_now, b.n, w.nrm),
                       torch.where(diffuse_now, b.att, w.bsdf))


def measure_points(w: MeasureWalk) -> MeasurePoints:
    """The walk's first diffuse hits as (N, 3) rows."""
    return MeasurePoints(w.valid, w.p.T.contiguous(), w.nrm.T.contiguous(),
                         w.bsdf.T.contiguous())


def measure_walk_soa(scene: Scene, tables: BounceTables,
                     gen: torch.Generator, w: MeasureWalk, *,
                     max_depth: int, t_min: float, spawn_eps,
                     intersector: str = "pallas", step: int = 0):
    """update_sppm's specular walk to the first diffuse hit
    (photon_mapper.rs:277-300) from lanes ``w`` that have taken ``step``
    steps: ``measure_step`` while a lane is alive, up to ``max_depth``
    steps, with one host read per step for the loop condition. On
    ``intersector``'s route ("pallas" or "leaf"); the bounce is fused
    where ``use_fused`` says (an image or noise texture, or the leaf
    route, takes the unfused stage). Counts the steps (``walk.steps``,
    ``step`` included) and, on ordered tables, its bounces' walk
    (``WalkCount``, ``count_walk``). Returns (lanes, steps taken in
    all)."""
    fused = use_fused(scene, intersector)
    first = step
    count = WalkCount.of(tables, fused, max_depth - first, w.o.shape[1])
    while step < max_depth:
        with timing.span("walk.sync"):
            if not bool(w.alive.any()):
                break
        w = measure_step(tables, gen, w, t_min=t_min, spawn_eps=spawn_eps,
                         fused=fused, scene=scene, intersector=intersector,
                         count=count, slot=step - first)
        step += 1
        nans.check("a measurement step", point=w.p, normal=w.nrm,
                   bsdf=w.bsdf, origin=w.o, direction=w.d)
    timing.count("walk.steps", step)
    count_walk(None if count is None else count.total())
    return w, step


def measurement_soa(scene: Scene, tables: BounceTables,
                    gen: torch.Generator, o, d, *, max_depth: int,
                    t_min: float, spawn_eps,
                    intersector: str = "pallas") -> MeasurePoints:
    """The walk (``measure_walk_soa``) of camera rays ``o``/``d`` (3, N):
    no emission, no throughput. Returns each lane's first diffuse hit."""
    w, _steps = measure_walk_soa(scene, tables, gen, measure_lanes(o, d),
                                 max_depth=max_depth, t_min=t_min,
                                 spawn_eps=spawn_eps,
                                 intersector=intersector)
    return measure_points(w)


def emit_photons_soa(lights: Lights, gen: torch.Generator, n: int,
                     down=None):
    """Photon emission (light.rs:98-103, 158-166, 220-225) of ``n``
    photons from one (7, n) draw of ``gen`` (``emit_from``). Returns
    (origin, direction, power), each (3, n)."""
    U = torch.rand((photon_step_ops.EMIT_ROWS, n), generator=gen,
                   device=lights.p0.device)
    return emit_from(lights, U, down)


def emit_from(lights: Lights, U, down=None):
    """Photon emission from the uniform rows ``U`` (7, n): a light picked
    in proportion to its power (inverse CDF over ``exp(log_prob)``), a point
    on its surface, a direction in the hemisphere around its normal (power
    weighted by the cosine for rect lights). The rows: pick, sphere normal
    (2), hemisphere (2), rect uv (2). ``down``: the rect lights' normal
    (0, -1, 0) as a (3, 1) device tensor, made by the caller once for many
    calls (else here). Returns (origin, direction, power), each (3, n)."""
    dev = lights.p0.device
    idx = pick_light(lights, U[0])
    # (3, n) rows gathered from (3, L) columns come out contiguous, as the
    # bounce kernel takes them
    p0 = light_cols(lights.p0, idx)
    p1 = light_cols(lights.p1, idx)
    r0 = lights.r0[idx]
    base = light_cols(lights.flux * lights.scale[:, None], idx)

    # sphere lights: uniform surface normal, origin = centre + n (r + 1e-4)
    sn = uniform_sphere_from(U[1], U[2])
    s_origin = p0 + sn * (r0 + 1e-4)
    # xz-rect lights: a point of the rect, normal straight down
    r_origin = torch.stack([p0[0] + (p1[0] - p0[0]) * U[5], p0[1],
                            p0[2] + (p1[2] - p0[2]) * U[6]])
    is_sph = lights.kind[idx] == LIGHT_SPHERE
    if down is None:
        down = torch.tensor([0.0, -1.0, 0.0], device=dev)[:, None]
    nrm = torch.where(is_sph, sn, down)
    origin = torch.where(is_sph, s_origin, r_origin)
    # one hemisphere draw around the chosen normal serves both kinds
    h = uniform_sphere_from(U[3], U[4])
    d = h * torch.where((h * nrm).sum(0) > 0.0, 1.0, -1.0)
    w_scale = torch.where(is_sph, 1.0, torch.clamp(-d[1], min=0.0))
    return origin, d, base * w_scale


class Deposits(NamedTuple):
    """Photon deposits of one photon pass, flattened step-major (slot
    step * lanes + lane) as in the JAX package."""
    pos: torch.Tensor      # (3, P) hit point
    power: torch.Tensor    # (3, P) incoming power
    norm: torch.Tensor     # (3, P) shading normal at the hit
    valid: torch.Tensor    # (P,) bool: a diffuse deposit
    caustic: torch.Tensor  # (P,) bool: first diffuse after specular only


# The regenerating photon pass's wavefront width is ``photon_lanes``' rule:
# at least PHOTON_LANES (the JAX package's width, wavefront_soa.py:1247),
# at most PHOTON_LANES_MAX (past it, on an H100, the maps' sort of the
# wider slots costs what fewer steps save), and never more than the
# budget. The width fixes the deposit slots and the draws.
PHOTON_LANES = 16384
PHOTON_LANES_MAX = 262144
LANE_QUANTUM = 1024


def photon_lanes(n_photons: int) -> int:
    """The photon wavefront's width for a budget of ``n_photons``: half
    the budget rounded up to ``LANE_QUANTUM`` lanes, within
    [PHOTON_LANES, PHOTON_LANES_MAX], and the whole budget when that is
    smaller. Half the budget spawns the other half in ``spawn_window`` = 4
    steps, so a pass of 16 bounces takes 20 steps (500,000 photons:
    250,880 lanes; 16,384 lanes took 135 steps). On CUDA a step is a
    bounce, two draws and the step kernel. The deposit slots,
    S * L <= 4 n + 13 L (38 bytes each), come to at most ~10 n where the
    half rules (500,000 photons: 5,017,600 slots, 191 MB) and tend to 4 n
    past 2 * PHOTON_LANES_MAX photons."""
    B = int(n_photons)
    half = -(-B // (2 * LANE_QUANTUM)) * LANE_QUANTUM
    return min(B, max(PHOTON_LANES, min(half, PHOTON_LANES_MAX)))


# Test hook: False leaves the ordered walk uncounted (``WalkCount.of``
# answers None), so the count's own cost can be timed against it.
_COUNT_WALK = True


class WalkCount:
    """The ordered walk's work over a run of ``steps`` bounces of
    ``lanes`` lanes, kept on the device, a slot a bounce: its chunk bodies
    per warp (the ordered kernel's ``stats``, both walks) and its live
    warps (warps of ``ordered.GROUP`` lanes with a lane alive: those whose
    walk runs). ``reset`` zeroes the slots; ``slot(i, alive)`` records
    bounce i's live warps and returns the stats rows its bounce fills;
    ``total()`` is (2,) int64, bodies and live warps, over every slot. No
    host read; the buffers are made here, so a graph may hold one."""

    def __init__(self, steps: int, lanes: int, device):
        g = -(-lanes // ordered_ops.GROUP)
        self.stats = torch.zeros((steps, g, 2), dtype=torch.int32,
                                 device=device)
        self.live = torch.zeros((steps, g), dtype=torch.bool, device=device)
        self.pad = torch.zeros((g * ordered_ops.GROUP - lanes,),
                               dtype=torch.bool, device=device)

    @classmethod
    def of(cls, tables: BounceTables, fused: bool, steps: int, lanes: int):
        """A count for a run of fused bounces on ``tables``, or None where
        they take no ordered kernel (flat tables, the unfused stage)."""
        if not (_COUNT_WALK and fused and tables.ordered):
            return None
        return cls(steps, lanes, tables.sph.device)

    def reset(self):
        self.stats.zero_()
        self.live.zero_()

    def slot(self, i: int, alive):
        a = torch.cat([alive, self.pad]) if self.pad.numel() else alive
        torch.any(a.view(-1, ordered_ops.GROUP), 1, out=self.live[i])
        return self.stats[i]

    def total(self):
        return torch.stack((self.stats.sum(dtype=torch.int64),
                            self.live.sum(dtype=torch.int64)))


WALK_COUNTERS = ("ordered.bodies", "ordered.warps")


def count_walk(total):
    """Record a ``WalkCount.total()`` as the counters ``ordered.bodies``
    and ``ordered.warps``, summed on the device while recording
    (``timing.count_device``); nothing for None (no walk counted)."""
    if total is not None:
        timing.count_device(WALK_COUNTERS, total)


def count_pass(steps: int, lanes: int):
    """Record one photon pass of ``steps`` steps over ``lanes`` lanes
    (counters ``photon.steps``, ``photon.lanes``): host ints only."""
    timing.count("photon.steps", steps)
    timing.count("photon.lanes", lanes)


def step_kernel(device) -> bool:
    """Whether a photon pass on ``device`` steps through the kernel
    (``ops/photon_step.py``: CUDA) or the plain twin (the CPU)."""
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise NotImplementedError(f"photon step: no kernel for {kind}")
    return kind == "cuda"


def count_kernel_steps(launches: dict):
    """Record beside ``count_pass`` the steps of that pass that went
    through the step kernel (counter ``photon.kernel_steps``): its
    ``photon_step`` launches in ``launches`` (``kernels.launches_since``
    around an eager pass, a graph's launches a replay)."""
    timing.count("photon.kernel_steps", launches.get("photon_step", 0))


def spawn_window(n_photons: int, lanes: int) -> int:
    """Steps during which retired lanes may spawn the next photon: ~L/2.5
    lanes retire per step, so 4 (B - L) / L steps admit the remaining
    budget with ~1.6x margin."""
    return 0 if n_photons <= lanes else -(-4 * (n_photons - lanes) // lanes)


class PhotonPass:
    """The path-regeneration photon pass in static buffers: a fixed
    wavefront of L = ``min(lanes, n_photons)`` lanes traces photons; when
    a photon dies (Russian roulette, miss or the ``max_bounces`` cap) its
    lane emits the next photon while the spawn budget of ``n_photons``
    lasts. ``lanes`` defaults to ``photon_lanes(n_photons)``.

    The step count S = window + max_bounces is static (``spawn_window``;
    ``window`` overrides it), so every admitted photon gets its full
    bounce allowance and the loop needs no host sync. A per-step prefix
    sum over the retire mask admits exactly the budget. If the window
    closes before the budget is spent, deposit powers are scaled by
    n_photons / spawned, which keeps the estimate unbiased (the density
    estimate divides by the nominal count).

    Per photon (material.rs:27-45, photon_mapper.rs:244-252): Russian
    roulette against the attenuation's largest component with the power
    renormalised by it, a deposit of the power from before that
    renormalisation at every diffuse hit, and a caustic flag on the first
    diffuse hit after a specular-only prefix.

    The buffers: the lanes (origin, direction, power, alive, the
    specular and diffuse flags, depth), the deposits (9, S, L) (point,
    power, normal), their flags (2, S, L) (valid, caustic) and the spawn
    counter; on CUDA also the step kernel's lights (``light_table``, made
    by ``start``) and scratch words; on ordered tables the walk's count
    (``walk_count``, a ``WalkCount`` of its S bounces, reset by
    ``start``). ``step`` updates them in place and every constant tensor
    is made here, so one object runs the same pass eagerly and under a
    CUDA graph's capture (``models/sppm.py::graphed_photon_pass``). The
    bounce takes ``intersector``'s route ("pallas" or "leaf"); what
    follows it is one kernel on CUDA (``ops/photon_step.py``), whatever
    the route, and the plain twin ``_step_plain`` on the CPU.
    ``lights`` replaces the scene's emitters (a graph's own copies);
    ``spawn_eps``: a float or a 0-d tensor."""

    def __init__(self, scene, tables: BounceTables, n_photons: int,
                 max_bounces: int, t_min: float, spawn_eps,
                 lanes: int = None, window: int = None,
                 intersector: str = "pallas", lights: Lights = None):
        B = int(n_photons)
        L = min(B, photon_lanes(B) if lanes is None else int(lanes))
        if window is None:
            window = spawn_window(B, L)
        self.B, self.L, self.window = B, L, window
        self.S = window + max_bounces
        self.max_bounces, self.t_min = max_bounces, t_min
        self.tables, self.intersector = tables, intersector
        self.fused = use_fused(scene, intersector)
        self.scene = None if self.fused else scene   # unfused textures
        self.lights = scene.lights if lights is None else lights
        dev = tables.sph.device
        f32 = torch.float32
        self.eps = torch.as_tensor(spawn_eps, dtype=f32, device=dev)
        self.down = torch.tensor([0.0, -1.0, 0.0], device=dev)[:, None]
        self.dep = torch.empty((9, self.S, L), dtype=f32, device=dev)
        self.flags = torch.empty((2, self.S, L), dtype=torch.bool,
                                 device=dev)
        self.o, self.d, self.w = (torch.empty((3, L), dtype=f32, device=dev)
                                  for _ in range(3))
        self.alive, self.has_spec, self.has_diff = (
            torch.empty((L,), dtype=torch.bool, device=dev)
            for _ in range(3))
        self.depth = torch.empty((L,), dtype=torch.int32, device=dev)
        self.counter = torch.empty((), dtype=torch.int64, device=dev)
        self.kernel = step_kernel(dev)
        self.walk_count = WalkCount.of(tables, self.fused, self.S, L)
        self.light_table = self.scratch = None
        if self.kernel:
            self.light_table = torch.empty(
                (self.lights.kind.shape[0], photon_step_ops.LIGHT_W),
                dtype=f32, device=dev)
            self.scratch = torch.zeros(
                (photon_step_ops.scratch_words(L),), dtype=torch.int32,
                device=dev)

    def start(self, gen: torch.Generator):
        """Emit the first L photons and reset the lanes (and, for the
        kernel, read the lights once a pass: a graph's lights are
        refreshed before each replay)."""
        if self.kernel:
            self.light_table.copy_(
                photon_step_ops.emission_table(self.lights))
        for buf, x in zip((self.o, self.d, self.w),
                          emit_photons_soa(self.lights, gen, self.L,
                                           self.down)):
            buf.copy_(x)
        self.alive.fill_(True)
        self.has_spec.fill_(False)
        self.has_diff.fill_(False)
        self.depth.zero_()
        self.counter.fill_(self.L)
        if self.walk_count is not None:
            self.walk_count.reset()

    def step(self, gen: torch.Generator, step: int):
        """Bounce every lane once, deposit, and (within the window) spawn
        into the retired lanes: the bounce, the step's draws (the
        emission's inside the window, after the bounce), then one kernel
        on CUDA or ``_step_plain``."""
        L = self.L
        o, d, w = self.o, self.d, self.w
        U = torch.rand((U_TRACE_ROWS, L), generator=gen, device=o.device)
        stats = (None if self.walk_count is None
                 else self.walk_count.slot(step, self.alive))
        b = bounce_step(self.tables, U, o, d, self.alive, t_min=self.t_min,
                        spawn_eps=self.eps, fused=self.fused,
                        scene=self.scene, intersector=self.intersector,
                        stats=stats)
        E = (torch.rand((photon_step_ops.EMIT_ROWS, L), generator=gen,
                        device=o.device) if step < self.window else None)
        if self.kernel:
            b = Bounce(*(x.contiguous() for x in b))
            photon_step_ops.photon_step(self, U, b, E, step)
        else:
            self._step_plain(U, b, E, step)
        nans.check("a photon step", power=w, origin=o, direction=d)

    def _step_plain(self, U, b: Bounce, E, step: int):
        """The step after the bounce ``b`` in plain PyTorch (any device):
        the kernel's twin, from the same draws ``U`` and ``E`` (None
        outside the window)."""
        B = self.B
        o, d, w, alive = self.o, self.d, self.w, self.alive
        hmax = b.att.amax(0)
        survive = U[U_RR] <= hmax
        inter = torch.where(survive, b.inter, INTER_ABSORB)
        diffuse_now = alive & (inter == INTER_DIFFUSE)
        self.dep[0:3, step] = b.p
        self.dep[3:6, step] = w
        self.dep[6:9, step] = b.n
        self.flags[0, step] = diffuse_now
        self.flags[1, step] = diffuse_now & self.has_spec & ~self.has_diff

        cont = alive & (inter != INTER_ABSORB)
        self.depth += 1
        cont = cont & (self.depth < self.max_bounces)    # per-path cap
        renorm = torch.where(survive, b.att / torch.clamp(hmax, min=1e-12),
                             1.0)
        torch.where(cont, b.no, o, out=o)
        torch.where(cont, b.nd, d, out=d)
        torch.where(cont, w * renorm, w, out=w)
        self.has_spec |= cont & ~diffuse_now
        self.has_diff |= diffuse_now
        alive_next = alive & cont
        if step < self.window:
            retire = alive & ~cont
            rank = torch.cumsum(retire, 0)
            spawn = retire & (self.counter + rank <= B)
            self.counter += torch.minimum(rank[-1], B - self.counter)
            eo, ed, ew = emit_from(self.lights, E, self.down)
            torch.where(spawn, eo, o, out=o)
            torch.where(spawn, ed, d, out=d)
            torch.where(spawn, ew, w, out=w)
            self.has_spec &= ~spawn
            self.has_diff &= ~spawn
            self.depth.masked_fill_(spawn, 0)
            alive_next |= spawn
        alive.copy_(alive_next)

    def finish(self):
        """Rescale the deposit powers by n_photons / spawned."""
        self.dep[3:6] *= self.B / torch.clamp(self.counter,
                                              min=1).to(torch.float32)

    def run(self, gen: torch.Generator):
        """The whole pass, its draws from ``gen``."""
        self.start(gen)
        for step in range(self.S):
            self.step(gen, step)
        self.finish()

    def deposits(self):
        """(``Deposits`` of S * L slots, photons spawned as a 0-d device
        tensor): views of the buffers."""
        dep = self.dep.reshape(9, self.S * self.L)
        flags = self.flags.reshape(2, self.S * self.L)
        return (Deposits(dep[0:3], dep[3:6], dep[6:9], flags[0], flags[1]),
                self.counter)


def trace_photon_deposits_regen_soa(scene, tables: BounceTables,
                                    gen: torch.Generator, n_photons: int,
                                    max_bounces: int, t_min: float,
                                    spawn_eps, lanes: int = None,
                                    window: int = None,
                                    intersector: str = "pallas"):
    """The path-regeneration photon pass (``PhotonPass``) run eagerly,
    its draws from ``gen``. Returns (``Deposits`` of S * L slots, photons
    spawned as a 0-d device tensor). Counts the pass (``count_pass``), its
    kernel launches (``count_kernel_steps``) and, on ordered tables, the
    walk (``count_walk``)."""
    pas = PhotonPass(scene, tables, n_photons, max_bounces, t_min,
                     spawn_eps, lanes=lanes, window=window,
                     intersector=intersector)
    before = launch_counts()
    pas.run(gen)
    count_pass(pas.S, pas.L)
    count_kernel_steps(launches_since(before))
    count_walk(None if pas.walk_count is None else pas.walk_count.total())
    return pas.deposits()
