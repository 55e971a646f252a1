"""Path tracer entry points: ``render_fn`` (one batch of samples) and
``render`` (host batches), the PyTorch counterparts of
``raytracer_tpu/models/path_tracer.py`` on its path-regeneration route.

Every random draw comes from one ``torch.Generator`` seeded from an int.
The JAX package draws from threefry keys, so the two packages agree in
distribution, not in bits.
"""

from __future__ import annotations

import torch

from raytracer_tpu_torch.models.wavefront_soa import render_regen_soa
from raytracer_tpu_torch.ops.fused_bounce import pack_tables, unported
from raytracer_tpu_torch.scene.types import Scene
from raytracer_tpu_torch.utils.config import RenderConfig


def _resolve(scene: Scene, intersector: str, nee: bool, mis: bool) -> str:
    """The port's counterpart of ``ops/dispatch.py::_resolve``: only the
    fused-bounce kernel path exists so far. Anything else raises, naming
    the ROADMAP item that ports it."""
    if intersector not in ("auto", "pallas"):
        raise NotImplementedError(
            f"intersector {intersector!r} is not ported yet: only the fused "
            "bounce kernel ('auto'/'pallas') exists (ROADMAP A10, queue B)")
    if nee or mis:
        raise NotImplementedError(
            "NEE and MIS are not ported yet (ROADMAP A6)")
    missing = unported(scene)
    if missing:
        raise NotImplementedError("; ".join(missing))
    return "pallas"


def render_fn(scene: Scene, generator: torch.Generator, *, width: int,
              height: int, spp: int, spp_chunk: int, max_depth: int,
              t_min: float, spawn_eps_rel: float, intersector: str = "auto",
              russian_roulette: bool = True, nee: bool = False,
              mis: bool = False, device="cuda", tables=None):
    """Render ``spp`` samples of every pixel on ``device`` with the
    regeneration wavefront (``spp_chunk`` lanes per pixel). ``generator``
    must live on that device; ``tables`` may carry ``pack_tables`` of the
    scene on it from an earlier call. Returns ((H, W, 3) linear image on
    the device, rays traced as an int)."""
    _resolve(scene, intersector, nee, mis)
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
        russian_roulette=russian_roulette)
    img = accum / (n_chunks * spp_chunk)
    return img.reshape(height, width, 3), rays


def render(scene: Scene, config: RenderConfig, seed: int, *,
           device="cuda"):
    """Render ``config`` on ``device``: returns ((H, W, 3) linear image on
    the device, rays traced as an int). The sample budget is split into
    host batches of ``config.host_spp_batch``; ``spp_chunk`` is capped so a
    wavefront stays under ~1.5M lanes."""
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
            mis=config.mis, device=device, tables=tables)
        accum += img * (spp / total)
        rays += r
        done += spp
    return accum, rays
