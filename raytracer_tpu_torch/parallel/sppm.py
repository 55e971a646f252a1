"""Multi-device SPPM over ``torch.distributed``: the counterpart of
``raytracer_tpu/parallel/sppm.py``.

An iteration on an (n, 1) mesh (``parallel/render.py::make_mesh``): each
rank traces ceil(n_photons / n) photons from its own generator, seeded
from (seed, iteration, rank), their power rescaled so that the total flux
is exactly ``n_photons``; the deposits are all-gathered in rank order and
every rank builds the same two maps (``photon_maps_sharded``). Each rank
keeps the contiguous pixel shard of the ``SPPMState`` (the flat pixel axis
padded to a multiple of n; pixels past the image measure nothing) and runs
the measurement, both queries and the update on it
(``sppm.measure_and_update``). The shards are all-gathered into the whole
state only for ``checkpoint_cb``, for the gather and for the return
value: the gather (``sppm_gather_sharded``, any mesh) shards pixels in
block order, as the sharded path tracer does, and its density estimates
ride along in slot order.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from raytracer_tpu_torch.models import sppm
from raytracer_tpu_torch.models import wavefront_soa as wf
from raytracer_tpu_torch.models.sppm import (
    GATHER_STREAM, MEASURE_STREAM, PHOTON_STREAM, SPPMHalf, SPPMState,
)
from raytracer_tpu_torch.ops import dispatch
from raytracer_tpu_torch.parallel.render import (
    Mesh, all_gather_cat, block_slots, combine, make_mesh, pixel_shard,
    samples,
)
from raytracer_tpu_torch.scene.types import Scene
from raytracer_tpu_torch.utils.config import RenderConfig
from raytracer_tpu_torch.utils.rng import stream_generator
from raytracer_tpu_torch.utils.timing import Stages

# the gather's per-batch lane budgets of one px rank (JAX render_sppm)
GATHER_LANES = 16_000_000
GATHER_CHUNK_LANES = 1_500_000


def _check_mesh(mesh: Mesh):
    if mesh.n_spp != 1:
        raise ValueError("SPPM state is sharded over pixels; use an (n, 1) "
                         "mesh (photons already use every rank)")


def photon_maps_sharded(scene: Scene, tables, seed: int, iteration: int, *,
                        mesh: Mesh, n_photons: int, max_photon_bounces: int,
                        grid_res, spawn_eps, intersector: str = "auto",
                        stage=None):
    """The photon pass of this rank (ceil(n_photons / n) photons), its
    deposits all-gathered with every rank's, and both maps built from all
    of them: the same grids on every rank. On the card the pass is one
    replay of its captured graph (``sppm.trace_deposits``); the
    all-gather copies its deposits out of the graph's buffers, and the
    maps are built eagerly after it. Returns (global grid, caustic
    grid)."""
    n_dev = mesh.size
    n_local = -(-int(n_photons) // n_dev)
    stage = stage or Stages(None, mesh.device)
    with stage("sppm.photon_pass"):
        dep = sppm.trace_deposits(
            scene, tables, stream_generator(mesh.device, seed, PHOTON_STREAM,
                                            iteration, mesh.rank),
            n_photons=n_local, max_photon_bounces=max_photon_bounces,
            spawn_eps=spawn_eps, intersector=intersector)
    with stage("sppm.all-gather"):
        dep = gather_deposits(dep, n_photons, mesh)
    with stage("sppm.grid_build"):
        return sppm.build_maps(scene, dep, grid_res, n_local * n_dev)


def gather_deposits(dep: wf.Deposits, n_photons: int,
                    mesh: Mesh) -> wf.Deposits:
    """Every rank's deposits of ceil(n_photons / n) photons each (the
    same slot count on every rank), their power rescaled by n_photons /
    (photons emitted), concatenated in rank order: one all-gather."""
    n_local = -(-int(n_photons) // mesh.size)
    scale = n_photons / (n_local * mesh.size)
    rows = torch.cat([dep.pos, dep.power * scale, dep.norm,
                      dep.valid[None].float(), dep.caustic[None].float()])
    rows = all_gather_cat(rows, dim=1)
    return wf.Deposits(rows[0:3], rows[3:6], rows[6:9], rows[9] > 0,
                       rows[10] > 0)


def sppm_iteration_sharded(scene: Scene, tables, state: SPPMState,
                           seed: int, *, mesh: Mesh, width: int, height: int,
                           n_photons: int, max_photon_bounces: int,
                           max_camera_bounces: int, grid_res, alpha: float,
                           k_global: float, k_caustic: float, t_min: float,
                           spawn_eps_rel: float, intersector: str = "auto",
                           query_impl: str = "dense", k_per_cell: int = 64,
                           times: Optional[dict] = None) -> SPPMState:
    """One SPPM iteration over an (n, 1) ``mesh`` (module docstring).
    ``state``: this rank's pixel shard (``shard_state``); ``tables`` the
    scene's on the mesh's device (``dispatch.route_tables``). ``times``: as
    for ``sppm.sppm_iteration``, plus "all-gather". Every rank of the mesh
    must call it. Returns this rank's updated shard."""
    _check_mesh(mesh)
    it = int(state.iteration)
    spawn_eps = spawn_eps_rel * scene.scale
    stage = Stages(times, mesh.device)
    g_grid, c_grid = photon_maps_sharded(
        scene, tables, seed, it, mesh=mesh, n_photons=n_photons,
        max_photon_bounces=max_photon_bounces, grid_res=grid_res,
        spawn_eps=spawn_eps, intersector=intersector, stage=stage)
    lo, n_local = pixel_shard(width * height, mesh.size, mesh.rank)
    return sppm.measure_and_update(
        scene, tables, state, g_grid, c_grid,
        stream_generator(mesh.device, seed, MEASURE_STREAM, it, mesh.rank),
        width=width, height=height, max_camera_bounces=max_camera_bounces,
        grid_res=grid_res, alpha=alpha, k_global=k_global,
        k_caustic=k_caustic, t_min=t_min, spawn_eps=spawn_eps,
        intersector=intersector, query_impl=query_impl,
        k_per_cell=k_per_cell,
        pixel_ids=torch.arange(lo, lo + n_local, device=mesh.device),
        stage=stage)


# ------------------------------------------------------------ state shards

def _rows(state: SPPMState) -> torch.Tensor:
    return torch.cat([torch.cat([h.flux, h.radius2[:, None],
                                 h.photons[:, None]], 1)
                      for h in (state.glob, state.caustic)], 1)


def _from_rows(rows: torch.Tensor, iteration: int) -> SPPMState:
    def half(x):
        return SPPMHalf(x[:, 0:3].contiguous(), x[:, 3].contiguous(),
                        x[:, 4].contiguous())
    return SPPMState(half(rows[:, 0:5]), half(rows[:, 5:10]), iteration)


def shard_state(state: SPPMState, npix: int, mesh: Mesh) -> SPPMState:
    """This rank's contiguous pixel shard of the whole ``state`` (npix
    rows, any device), zero rows past the image, on the mesh's device."""
    lo, n_local = pixel_shard(npix, mesh.size, mesh.rank)
    rows = _rows(state).to(mesh.device)
    rows = torch.nn.functional.pad(rows, (0, 0, 0, n_local * mesh.size
                                          - npix))
    return _from_rows(rows[lo:lo + n_local], int(state.iteration))


def gather_state(shard: SPPMState, npix: int) -> SPPMState:
    """The whole state (npix rows) from every rank's shard, on every
    rank (a collective)."""
    return _from_rows(all_gather_cat(_rows(shard))[:npix],
                      int(shard.iteration))


# ------------------------------------------------------------------ gather

def sppm_gather_sharded(scene: Scene, tables, state: SPPMState, seed: int,
                        batch: int = 0, *, mesh: Mesh, width: int,
                        height: int, spp: int, spp_chunk: int,
                        max_depth: int, t_min: float, spawn_eps_rel: float,
                        n_total_photons: int, intersector: str = "auto"):
    """The final gather across any ``mesh`` (JAX ``sppm_gather_sharded``)
    from the whole ``state``: each rank gathers its px shard with
    ceil(spp / n_spp) samples from a generator seeded from (seed, batch,
    px_i, spp_i): the regeneration loop over its block-order slots on the
    SoA route, else the chunk loop (``sppm.gather_chunks``) over its
    contiguous ids. Every rank of the mesh must call it. Returns ((H, W,
    3) image, the same on every rank, rays as an int)."""
    method = dispatch.route(scene, intersector)
    npix = width * height
    spawn_eps = spawn_eps_rel * scene.scale
    chunk, n_chunks = samples(spp, spp_chunk, mesh.n_spp)
    lo, n_local = pixel_shard(npix, mesh.n_px, mesh.px_i)
    est = sppm.density_estimates(state, n_total_photons).to(mesh.device)
    est = torch.nn.functional.pad(est, (0, 0, 0, n_local * mesh.n_px - npix))
    gen = stream_generator(mesh.device, seed, GATHER_STREAM, batch,
                           mesh.px_i, mesh.spp_i)
    kw = dict(width=width, height=height, max_depth=max_depth, t_min=t_min,
              spawn_eps=spawn_eps, intersector=method)
    if sppm.soa_eligible(scene, method):
        slots, inv = block_slots(width, height, mesh)
        accum, rays, _steps = wf.gather_regen_soa(
            scene, tables, est[slots], gen, lanes_per_pixel=chunk,
            samples_per_lane=n_chunks, pixel_slots=slots, **kw)
    else:
        inv = None
        ids = torch.arange(lo, lo + n_local, device=mesh.device)
        accum, rays = sppm.gather_chunks(
            scene, tables, est[ids], gen, ids,
            spp_chunk=chunk, n_chunks=n_chunks, **kw)
    full, rays = combine(accum, rays, mesh, npix, inv)
    img = full / (n_chunks * chunk * mesh.n_spp)
    return img.reshape(height, width, 3), rays


# -------------------------------------------------------------- top level

def render_sppm(scene: Scene, config: RenderConfig, seed: int,
                mesh: Optional[Mesh] = None,
                state: Optional[SPPMState] = None, checkpoint_cb=None,
                times: Optional[dict] = None):
    """A whole SPPM render across an (n, 1) ``mesh`` (``make_mesh()`` by
    default; JAX ``render_sppm``): the iterations left after ``state``
    (the whole state, e.g. a loaded checkpoint; each rank takes its
    shard), then the gather in batches whose lane budgets scale with n_px.
    ``checkpoint_cb(state)`` gets the whole state after every iteration,
    on every rank. ``times``: per-stage seconds summed over the
    iterations, plus "gather". Every rank must call it. Returns ((H, W, 3)
    image, gather rays as an int, the whole final state), the same on
    every rank."""
    sppm.check_scene(scene)
    if mesh is None:
        mesh = make_mesh()
    _check_mesh(mesh)
    sp = config.sppm
    scene = scene.to(mesh.device)
    tables = dispatch.route_tables(scene, config.intersector)
    npix = config.width * config.height
    kw = sppm.iteration_kwargs(scene, config)
    if state is None:
        state = sppm.init_state(npix, mesh.device)
    shard = shard_state(state, npix, mesh)
    for _ in range(int(state.iteration), sp.n_iterations):
        shard = sppm_iteration_sharded(scene, tables, shard, seed,
                                       mesh=mesh, times=times, **kw)
        if checkpoint_cb is not None:
            checkpoint_cb(gather_state(shard, npix))
    state = gather_state(shard, npix)

    t0 = time.perf_counter()
    n_total = sp.n_iterations * sp.photons_per_iter
    total = config.samples_per_pixel
    lane_budget = max(1, GATHER_LANES * mesh.n_px // npix)
    chunk_budget = max(1, GATHER_CHUNK_LANES * mesh.n_px // npix)
    step = max(1, min(config.host_spp_batch, total, lane_budget))
    accum = None
    rays, done, b = 0, 0, 0
    while done < total:
        spp = min(step, total - done)
        img, r = sppm_gather_sharded(
            scene, tables, state, seed, b, mesh=mesh, width=config.width,
            height=config.height, spp=spp,
            spp_chunk=max(1, min(config.spp_chunk, spp, chunk_budget)),
            max_depth=config.max_depth, t_min=config.t_min,
            spawn_eps_rel=config.spawn_eps_rel, n_total_photons=n_total,
            intersector=config.intersector)
        img = img * (spp / total)
        accum = img if accum is None else accum + img
        rays += r
        done += spp
        b += 1
    if times is not None:
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        times["gather"] = times.get("gather", 0.0) + time.perf_counter() - t0
    return accum, rays, state
