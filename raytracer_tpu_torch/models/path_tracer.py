"""Path tracer entry points: ``render_fn`` (one batch of samples),
``render`` (host batches) and ``trace_radiance`` (one wavefront to
completion), the PyTorch counterparts of
``raytracer_tpu/models/path_tracer.py``, with NEE (``nee``) and mixture
importance sampling (``mis``), motion blur on scenes whose spheres move
(one shutter time per sample), media and image and noise textures.

Routes: "pallas" and "leaf" run the regeneration wavefront of
``wavefront_soa`` on the kernels; "bruteforce" and "bvh" run the JAX
package's (N, 3) route: ``render_fn``'s loop over chunks of samples, each
a wavefront of camera rays (``models/camera.py``) traced to completion by
``trace_radiance_bruteforce`` with the chunked scan of
``ops/intersect.py`` or the flat BVH of ``ops/bvh.py``,
``ops/materials.py`` and the media override of
``ops/media.py::apply_media`` (``hit_and_attrs``).

Every random draw comes from one ``torch.Generator`` seeded from an int.
The JAX package draws from threefry keys, so the two packages agree in
distribution, not in bits.
"""

from __future__ import annotations

import torch

from typing import NamedTuple

from raytracer_tpu_torch.models.camera import camera_rays
from raytracer_tpu_torch.models.wavefront_soa import (
    RR_START_BOUNCE, U_RR, U_TRACE_ROWS, _extra_rows, _media_u, media_rows,
    render_regen_soa, trace_radiance_soa,
)
from raytracer_tpu_torch.ops import dispatch, intersect, materials, media, vec
from raytracer_tpu_torch.ops import mis as mis_ops
from raytracer_tpu_torch.ops import nee as nee_ops
from raytracer_tpu_torch.scene.types import INTER_ABSORB, INTER_DIFFUSE, Scene
from raytracer_tpu_torch.utils import nans, timing
from raytracer_tpu_torch.utils.config import RenderConfig
from raytracer_tpu_torch.utils.timing import Progress, sync_for


class TraceResult(NamedTuple):
    radiance: torch.Tensor   # (N, 3)
    rays_traced: int


def resolve_route(scene: Scene, intersector: str, nee: bool, mis: bool) -> str:
    """The route of a render: the kernel route ("pallas") for "pallas",
    and for "auto" while the scene's tables fit the kernels' cap (past it
    "bvh" or "bruteforce": ``dispatch.auto_route``), "leaf" for the leaf
    kernel (``ValueError`` when the scene has no leaf tables), "bruteforce"
    and "bvh" for the (N, 3) route (the BVH route raises ``ValueError``
    when the scene has none); a moving scene takes the kernel route for
    "leaf" and "bvh", as in JAX. ``nee`` and ``mis`` together raise
    ``ValueError``, as in the JAX package."""
    if mis and nee:
        raise ValueError("--mis and --nee are mutually exclusive")
    return dispatch.route(scene, intersector)


def spawn_origin(p, normal, new_dir, eps):
    """The next ray's origin: ``p`` offset by ``eps`` along the normal, to
    the side the new direction leaves by."""
    side = torch.sign(vec.dot(new_dir, normal))
    return p + normal * (eps * side)[:, None]


def hit_and_attrs(scene: Scene, o, d, t_min: float, media_u=None,
                  time=None, alive=None, intersector: str = "bruteforce",
                  tables=None) -> intersect.HitAttrs:
    """One bounce's hit in the (N, 3) loops: the closest hit of rays
    ``o``/``d`` (N, 3) on ``intersector``'s route (the brute-force scan or
    the BVH in (N, 3); the closest-hit or leaf kernel on (3, N) rows, with
    ``tables`` from ``pack_tables`` if given), its attributes, then the
    media override from free-flight uniforms ``media_u`` (K, N) where the
    scene has media (medium.rs semantics; JAX ``hit_and_attrs``)."""
    if intersector in dispatch.AOS_ROUTES:
        hit = dispatch.aos_hit(scene, o, d, t_min, torch.inf, intersector,
                               alive, time)
    else:
        c = dispatch.intersect_scene(scene, o.T.contiguous(),
                                     d.T.contiguous(), t_min, torch.inf,
                                     intersector, alive, tables, time)
        hit = intersect.Hit(c.t, c.ty, c.ix)
    attrs = intersect.hit_attributes(scene, o, d, hit, time)
    if media_u is not None:
        attrs = media.apply_media(scene.media, media_u, o, d, attrs, t_min)
    return attrs


def trace_radiance_bruteforce(scene: Scene, o, d, gen: torch.Generator, *,
                              max_depth: int, t_min: float, spawn_eps,
                              russian_roulette: bool = True,
                              nee: bool = False, mis: bool = False,
                              time=None, stats: dict = None,
                              intersector: str = "bruteforce",
                              tables=None) -> TraceResult:
    """The JAX package's (N, 3) loop (``trace_radiance``'s body): rays
    ``o``/``d`` (N, 3) traced to completion, at most ``max_depth``
    bounces, no regeneration. Each step draws the wavefront's uniform rows
    from ``gen`` as ``trace_radiance_soa`` does (scatter and RR, then NEE's
    or MIS's rows, then one free-flight row per medium), and casts its
    rays and NEE's shadow rays through ``intersector``'s route
    ("bruteforce" or "bvh"; ``tables``: ``pack_tables`` of the scene for
    the kernel routes, if any). ``time`` (N,): each ray's
    shutter time. ``stats``, if given, gets the NEE shadow rays cast added
    to ``shadow_lanes`` and the steps to ``steps``. Returns radiance
    (N, 3) and the rays traced (alive lanes summed over steps)."""
    n = o.shape[0]
    dev = o.device
    base = U_TRACE_ROWS + _extra_rows(nee, mis)
    k_med = media_rows(scene)
    tput = torch.ones((n, 3), device=dev)
    rad = torch.zeros((n, 3), device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_diff = torch.zeros_like(alive)
    rays = steps = 0
    shadow = torch.zeros((), dtype=torch.int64, device=dev)
    for step in range(max_depth):
        n_alive = int(alive.sum())
        if n_alive == 0:
            break
        rays += n_alive
        steps += 1
        U = torch.rand((base + k_med, n), generator=gen, device=dev)
        attrs = hit_and_attrs(scene, o, d, t_min, _media_u(U, base, k_med),
                              time, alive, intersector, tables)
        sc = materials.scatter(scene, U, d, attrs)
        live = alive & attrs.valid
        # with NEE, emission along a diffuse-scattered ray was counted by
        # the shadow ray at the vertex before
        rad = rad + torch.where((live & ~prev_diff)[:, None],
                                tput * sc.emitted, 0.0)
        diffuse_now = live & (sc.interaction == INTER_DIFFUSE)
        extra = U[U_TRACE_ROWS:base]
        if nee:
            dl, cast = nee_ops.direct_light(
                scene, tables, extra, attrs.p.T, attrs.normal.T,
                sc.attenuation.T, diffuse_now, alive=alive,
                intersector=intersector, time=time)
            shadow += cast.sum()
            rad = rad + torch.where(diffuse_now[:, None], tput * dl.T, 0.0)
        direction, attenuation = sc.direction, sc.attenuation
        if mis:
            d_mis, w = mis_ops.mixture_reweight(
                scene.lights, extra, attrs.p.T, attrs.normal.T,
                sc.direction.T, diffuse_now, time)
            direction = torch.where(diffuse_now[:, None], d_mis.T, direction)
            attenuation = attenuation * w[:, None]
        cont = live & (sc.interaction != INTER_ABSORB)
        tput = torch.where(cont[:, None], tput * attenuation, tput)
        if russian_roulette and step >= RR_START_BOUNCE:
            p_surv = torch.clamp(tput.amax(1), 0.05, 1.0)
            survive = U[U_RR] < p_surv
            tput = torch.where((cont & survive)[:, None],
                               tput / p_surv[:, None], tput)
            cont = cont & survive
        new_o = spawn_origin(attrs.p, attrs.normal, direction, spawn_eps)
        o = torch.where(cont[:, None], new_o, o)
        d = torch.where(cont[:, None], direction, d)
        if nee:
            prev_diff = diffuse_now
        alive = cont
        nans.check("a path-tracer step", radiance=rad, throughput=tput,
                   origin=o, direction=d)
    if stats is not None:
        stats["shadow_lanes"] = stats.get("shadow_lanes", 0) + int(shadow)
        stats["steps"] = stats.get("steps", 0) + steps
    return TraceResult(rad, rays)


def trace_radiance(scene: Scene, o, d, generator: torch.Generator, *,
                   max_depth: int, t_min: float, spawn_eps,
                   intersector: str = "auto",
                   russian_roulette: bool = True, nee: bool = False,
                   mis: bool = False, tables=None,
                   time=None, stats: dict = None) -> TraceResult:
    """Trace rays ``o``/``d`` (N, 3) to completion (at most ``max_depth``
    bounces) on their device; returns per-ray radiance (N, 3) and the rays
    traced. The kernel routes take the JAX package's SoA loop
    (``trace_radiance_soa``), "bruteforce" and "bvh" its (N, 3) loop
    (``trace_radiance_bruteforce``). ``time`` (N,): each ray's shutter
    time (motion blur; without it a moving scene stands at t = 0).
    ``stats``: as for ``render_fn``."""
    method = resolve_route(scene, intersector, nee, mis)
    scene = scene.to(o.device)
    if method in dispatch.AOS_ROUTES:
        return trace_radiance_bruteforce(
            scene, o, d, generator, max_depth=max_depth, t_min=t_min,
            spawn_eps=spawn_eps, russian_roulette=russian_roulette,
            nee=nee, mis=mis, time=time, stats=stats, intersector=method)
    if tables is None:
        tables = dispatch.route_tables(scene, method)
    rad, rays = trace_radiance_soa(
        scene, tables, o.T.contiguous(), d.T.contiguous(), generator,
        max_depth=max_depth, t_min=t_min, spawn_eps=spawn_eps,
        intersector=method, russian_roulette=russian_roulette, nee=nee,
        mis=mis, time=time, stats=stats)
    return TraceResult(rad.T, rays)


@timing.spanned("pt.render_fn")
def render_fn(scene: Scene, generator: torch.Generator, *, width: int,
              height: int, spp: int, spp_chunk: int, max_depth: int,
              t_min: float, spawn_eps_rel: float, intersector: str = "auto",
              russian_roulette: bool = True, nee: bool = False,
              mis: bool = False, device="cuda", tables=None,
              stats: dict = None):
    """Render ``spp`` samples of every pixel on ``device`` with the
    regeneration wavefront (``spp_chunk`` lanes per pixel). ``generator``
    must live on that device; ``tables`` may carry ``pack_tables`` of the
    scene on it from an earlier call; ``stats``, if given, gets the NEE
    shadow rays as ``shadow_lanes`` (they are not counted as rays) and the
    loop's ``steps``.
    Returns ((H, W, 3) linear image on the device, rays traced as an
    int)."""
    method = resolve_route(scene, intersector, nee, mis)
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, render on "
                         f"{device}")
    scene = scene.to(device)
    n_chunks = -(-spp // spp_chunk)
    spawn_eps = spawn_eps_rel * scene.scale      # float32, as in JAX
    if method in dispatch.AOS_ROUTES:
        accum, rays = render_chunks(
            scene, generator, torch.arange(width * height, device=device),
            width=width, height=height, spp_chunk=spp_chunk,
            n_chunks=n_chunks, max_depth=max_depth, t_min=t_min,
            spawn_eps=spawn_eps, russian_roulette=russian_roulette, nee=nee,
            mis=mis, stats=stats, intersector=method)
        img = accum / (n_chunks * spp_chunk)
        return img.reshape(height, width, 3), rays
    if tables is None:
        tables = dispatch.route_tables(scene, method)
    accum, rays, _steps = render_regen_soa(
        scene, tables, generator, width=width, height=height,
        lanes_per_pixel=spp_chunk, samples_per_lane=n_chunks,
        max_depth=max_depth, t_min=t_min, spawn_eps=spawn_eps,
        intersector=method, russian_roulette=russian_roulette, nee=nee,
        mis=mis, stats=stats)
    img = accum / (n_chunks * spp_chunk)
    return img.reshape(height, width, 3), rays


def render_chunks(scene: Scene, gen: torch.Generator, pixel_ids, *,
                  width: int, height: int, spp_chunk: int, n_chunks: int,
                  max_depth: int, t_min: float, spawn_eps,
                  russian_roulette: bool, nee: bool, mis: bool,
                  stats: dict = None, intersector: str = "bruteforce",
                  tables=None):
    """The JAX ``render_fn``'s loop over chunks of samples (its (N, 3)
    route, and the sharded render's loop for media and the (N, 3) routes):
    each chunk is ``spp_chunk`` camera rays of every pixel of
    ``pixel_ids`` (P,) (pixel-major within a sample, as JAX lays them
    out), with a shutter time each on a moving scene, traced to completion
    by ``trace_radiance`` on the resolved ``intersector``'s route
    (``tables``: those of a kernel route, if packed). Returns ((P, 3)
    radiance sum, rays as an int)."""
    dev = scene.camera.origin.device
    cam = scene.camera
    n = pixel_ids.shape[0]
    ids = pixel_ids.repeat(spp_chunk)
    accum = torch.zeros((n, 3), device=dev)
    rays = 0
    for _ in range(n_chunks):
        o, d = camera_rays(cam, gen, ids, width, height)
        time = None
        if scene.spheres.motion_marker.shape[0]:
            time = cam.time0 + torch.rand(
                (o.shape[0],), generator=gen, device=dev) * (cam.time1
                                                             - cam.time0)
        res = trace_radiance(
            scene, o, d, gen, max_depth=max_depth, t_min=t_min,
            spawn_eps=spawn_eps, intersector=intersector,
            russian_roulette=russian_roulette, nee=nee, mis=mis,
            tables=tables, time=time, stats=stats)
        accum += res.radiance.reshape(spp_chunk, n, 3).sum(0)
        rays += res.rays_traced
    return accum, rays


def render(scene: Scene, config: RenderConfig, seed: int, *,
           device="cuda", stats: dict = None):
    """Render ``config`` on ``device``: returns ((H, W, 3) linear image on
    the device, rays traced as an int). The sample budget is split into
    host batches of ``config.host_spp_batch``; ``spp_chunk`` is capped so a
    wavefront stays under ~1.5M lanes. ``stats``: as for ``render_fn``.
    A ``Progress`` line ticks per batch on a TTY."""
    device = torch.device(device)
    scene = scene.to(device)
    tables = dispatch.route_tables(scene, resolve_route(
        scene, config.intersector, config.nee, config.mis))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    total = config.samples_per_pixel
    npix = config.width * config.height
    batch = max(1, min(config.host_spp_batch, total))
    spp_chunk = max(1, min(config.spp_chunk, batch,
                           max(1, 1_500_000 // npix)))
    accum = torch.zeros((config.height, config.width, 3), device=device)
    rays = 0
    done = 0
    prog = Progress(total=total, label="pt spp")
    while done < total:
        spp = min(batch, total - done)
        img, r = render_fn(
            scene, gen, width=config.width, height=config.height, spp=spp,
            spp_chunk=min(spp_chunk, spp), max_depth=config.max_depth,
            t_min=config.t_min, spawn_eps_rel=config.spawn_eps_rel,
            intersector=config.intersector,
            russian_roulette=config.russian_roulette, nee=config.nee,
            mis=config.mis, device=device, tables=tables, stats=stats)
        accum += img * (spp / total)
        rays += r
        done += spp
        sync_for(prog, device)
        prog.tick(spp, rays=r)
    return accum, rays
