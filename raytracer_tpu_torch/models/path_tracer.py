"""Path tracer entry points: ``render_fn`` (one batch of samples),
``render`` (host batches) and ``trace_radiance`` (one wavefront to
completion), the PyTorch counterparts of
``raytracer_tpu/models/path_tracer.py`` on its kernel routes, with NEE
(``nee``) and mixture importance sampling (``mis``), and motion blur on
scenes whose spheres move (one shutter time per sample).

Every random draw comes from one ``torch.Generator`` seeded from an int.
The JAX package draws from threefry keys, so the two packages agree in
distribution, not in bits.
"""

from __future__ import annotations

import torch

from typing import NamedTuple

from raytracer_tpu_torch.models.wavefront_soa import (
    render_regen_soa, trace_radiance_soa,
)
from raytracer_tpu_torch.ops.dispatch import NO_LEAF, resolve
from raytracer_tpu_torch.ops.fused_bounce import (
    moving, pack_tables, unported,
)
from raytracer_tpu_torch.scene.types import Scene
from raytracer_tpu_torch.utils.config import RenderConfig


class TraceResult(NamedTuple):
    radiance: torch.Tensor   # (N, 3)
    rays_traced: int


def _resolve(scene: Scene, intersector: str, nee: bool, mis: bool) -> str:
    """The route of a render: the kernel route ("pallas") for "auto" and
    "pallas", "leaf" for the leaf kernel (``ValueError`` when the scene has
    no leaf tables; a moving scene takes the kernel route, as in JAX);
    other intersectors and the scenes the port cannot
    render yet raise ``NotImplementedError`` naming the ROADMAP item that
    ports them. ``nee`` and ``mis`` together raise ``ValueError``, as in
    the JAX package."""
    if mis and nee:
        raise ValueError("--mis and --nee are mutually exclusive")
    method = resolve(intersector, moving(scene))
    if method == "leaf" and scene.leaf is None:
        raise ValueError(NO_LEAF)
    missing = unported(scene)
    if missing:
        raise NotImplementedError("; ".join(missing))
    return method


def trace_radiance(scene: Scene, o, d, generator: torch.Generator, *,
                   max_depth: int, t_min: float, spawn_eps,
                   intersector: str = "auto",
                   russian_roulette: bool = True, nee: bool = False,
                   mis: bool = False, tables=None,
                   time=None) -> TraceResult:
    """Trace rays ``o``/``d`` (N, 3) to completion (at most ``max_depth``
    bounces) on their device; returns per-ray radiance (N, 3) and the rays
    traced. The kernel route only (the JAX package's SoA route,
    ``trace_radiance_soa``). ``time`` (N,): each ray's shutter time
    (motion blur; without it a moving scene stands at t = 0)."""
    method = _resolve(scene, intersector, nee, mis)
    scene = scene.to(o.device)
    if tables is None:
        tables = pack_tables(scene)
    rad, rays = trace_radiance_soa(
        scene, tables, o.T.contiguous(), d.T.contiguous(), generator,
        max_depth=max_depth, t_min=t_min, spawn_eps=spawn_eps,
        intersector=method, russian_roulette=russian_roulette, nee=nee,
        mis=mis, time=time)
    return TraceResult(rad.T, rays)


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
    method = _resolve(scene, intersector, nee, mis)
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, render on "
                         f"{device}")
    scene = scene.to(device)
    n_chunks = -(-spp // spp_chunk)
    spawn_eps = spawn_eps_rel * scene.scale      # float32, as in JAX
    if tables is None:
        tables = pack_tables(scene)
    accum, rays, _steps = render_regen_soa(
        scene, tables, generator, width=width, height=height,
        lanes_per_pixel=spp_chunk, samples_per_lane=n_chunks,
        max_depth=max_depth, t_min=t_min, spawn_eps=spawn_eps,
        intersector=method, russian_roulette=russian_roulette, nee=nee,
        mis=mis, stats=stats)
    img = accum / (n_chunks * spp_chunk)
    return img.reshape(height, width, 3), rays


def render(scene: Scene, config: RenderConfig, seed: int, *,
           device="cuda", stats: dict = None):
    """Render ``config`` on ``device``: returns ((H, W, 3) linear image on
    the device, rays traced as an int). The sample budget is split into
    host batches of ``config.host_spp_batch``; ``spp_chunk`` is capped so a
    wavefront stays under ~1.5M lanes. ``stats``: as for ``render_fn``."""
    device = torch.device(device)
    scene = scene.to(device)
    tables = pack_tables(scene)
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
    return accum, rays
