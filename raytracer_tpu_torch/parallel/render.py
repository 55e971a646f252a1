"""Multi-device path tracing over ``torch.distributed``: the counterpart of
``raytracer_tpu/parallel/render.py``.

The JAX package shards a render over a ("px", "spp") device mesh with
``shard_map``. Here the mesh is a view of the initialised default process
group (``make_mesh``): rank = px_i * n_spp + spp_i, as JAX's
``reshape(n_px, n_spp)``, with one subgroup per px row for the spp-axis
sum and one per spp column for the px-axis gather. Every rank holds the
whole scene and:

- renders the pixels of its px shard: the flat pixel axis is padded to a
  multiple of n_px; on the kernel and leaf routes without media the shard
  is a contiguous slice of the ``block_order`` permutation (whole 16x16
  blocks, padded with pixel npix - 1, which the unpermutation drops), run
  by ``render_regen_soa(pixel_slots=...)``; media and the (N, 3) routes
  take ``path_tracer.render_chunks`` over a contiguous slice of ids;
- takes ceil(spp / n_spp) samples per pixel, in ``chunk`` x ``n_chunks``,
  from a generator seeded from (seed, px_i, spp_i);
- sums its radiance over its px row and the rays (int64) over the world,
  then all-gathers the px shards over its spp column (one copy of each
  shard travels to each rank), so every rank returns the whole image.

``nee``, ``mis`` and ``russian_roulette`` reach every rank (JAX's
``render`` passes only ``nee``). A collective on a gloo group stages a
CUDA tensor through host memory in plain sight (``_wire``): that is how
two ranks share one card, which NCCL refuses.
"""

from __future__ import annotations

import os
import tempfile
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from raytracer_tpu_torch.models import path_tracer
from raytracer_tpu_torch.models.wavefront_soa import (
    block_order, render_regen_soa,
)
from raytracer_tpu_torch.ops import dispatch
from raytracer_tpu_torch.ops.fused_bounce import has_media
from raytracer_tpu_torch.scene.types import Scene
from raytracer_tpu_torch.utils.config import RenderConfig
from raytracer_tpu_torch.utils.rng import stream_generator


class Mesh(NamedTuple):
    """An (n_px, n_spp) view of the default process group: this rank's
    coordinates, its device, the subgroup of its px row (None when n_spp
    is 1: nothing to sum) and the subgroup of its spp column (None: the
    whole group, when n_spp is 1)."""
    n_px: int
    n_spp: int
    px_i: int
    spp_i: int
    device: torch.device
    spp_group: Optional[dist.ProcessGroup]
    px_group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return self.n_px * self.n_spp

    @property
    def rank(self) -> int:
        return self.px_i * self.n_spp + self.spp_i


def make_mesh(n_px: Optional[int] = None, n_spp: int = 1,
              device=None) -> Mesh:
    """An (n_px, n_spp) mesh of the initialised default process group (all
    ranks on the px axis by default). Every rank must call it, in the same
    order as its other collectives: it creates each px row's and each spp
    column's subgroup.
    ``device``: this rank's device, by default ``cuda:(LOCAL_RANK %
    device_count)``. Raises ``RuntimeError`` when no group is initialised
    or, without ``device``, when there is no CUDA device."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group (torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n_px is None:
        n_px = world // n_spp
    if n_px < 1 or n_spp < 1 or n_px * n_spp != world:
        raise ValueError(f"mesh {n_px}x{n_spp} != {world} ranks")
    px_i, spp_i = divmod(dist.get_rank(), n_spp)
    spp_group = px_group = None
    if n_spp > 1:
        rows = [dist.new_group(list(range(p * n_spp, (p + 1) * n_spp)))
                for p in range(n_px)]
        cols = [dist.new_group(list(range(s, world, n_spp)))
                for s in range(n_spp)]
        spp_group, px_group = rows[px_i], cols[spp_i]
    if device is None:
        if not torch.cuda.device_count():
            raise RuntimeError("no CUDA device: pass device='cpu' to render "
                               "on the CPU")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        device = f"cuda:{local % torch.cuda.device_count()}"
    return Mesh(n_px, n_spp, px_i, spp_i, torch.device(device), spp_group,
                px_group)


def init_group(device):
    """Initialise the default process group for ``device``: NCCL on CUDA,
    gloo on the CPU; from ``torchrun``'s environment (``WORLD_SIZE`` set;
    each rank on card ``LOCAL_RANK``), else one rank on a file store in a
    temporary directory. Returns that directory, which the caller removes
    after the group (None under torchrun)."""
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.device_count():
        raise RuntimeError("no CUDA device: pass --device cpu")
    backend = "nccl" if cuda else "gloo"
    if "WORLD_SIZE" in os.environ:
        if cuda:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        dist.init_process_group(backend, init_method="env://")
        return None
    store = tempfile.TemporaryDirectory()
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(store.name, "store"),
        world_size=1, rank=0)
    return store


# ------------------------------------------------------------ collectives

def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective sends: gloo carries host memory, so a CUDA
    tensor is staged there (NCCL takes it as it is)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu()
    return t


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (the world by default), on t's
    device."""
    w = _wire(t, group).clone()
    dist.all_reduce(w, group=group)
    return w.to(t.device)


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0):
    """Every rank's ``t`` of ``group`` (the world by default), in rank
    order, concatenated along ``dim``, on t's device. ``t`` must have the
    same shape on every rank."""
    w = _wire(t, group).contiguous()
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim).to(t.device)


def sum_int(value: int, mesh: Mesh) -> int:
    """An int summed over the world, exactly (int64)."""
    t = torch.tensor([int(value)], dtype=torch.int64, device=mesh.device)
    return int(all_reduce_sum(t)[0])


# ------------------------------------------------------------- the shards

def pixel_shard(npix: int, n_px: int, px_i: int) -> tuple:
    """(first slot, slots per px shard) of the flat pixel axis padded to a
    multiple of ``n_px``."""
    n_local = -(-npix // n_px)
    return px_i * n_local, n_local


def block_slots(width: int, height: int, mesh: Mesh) -> tuple:
    """This px rank's slice of the ``block_order`` permutation padded with
    pixel npix - 1, and the inverse permutation. Returns (slots (n_local,)
    int64 on the mesh's device, inverse as a numpy array)."""
    npix = width * height
    perm, inv = block_order(width, height)
    lo, n_local = pixel_shard(npix, mesh.n_px, mesh.px_i)
    pad = np.full(n_local * mesh.n_px - npix, npix - 1, perm.dtype)
    slots = np.concatenate([perm, pad])[lo:lo + n_local]
    return torch.as_tensor(slots, device=mesh.device).long(), inv


def samples(spp: int, spp_chunk: int, n_spp: int) -> tuple:
    """(chunk, n_chunks) of a rank's ceil(spp / n_spp) samples per pixel."""
    spp_local = -(-spp // n_spp)
    chunk = max(1, min(spp_chunk, spp_local))
    return chunk, -(-spp_local // chunk)


def combine(accum: torch.Tensor, rays: int, mesh: Mesh, npix: int,
            inv=None) -> tuple:
    """A px shard's radiance sum (n_local, 3), summed over its px row and
    all-gathered over its spp column into the whole (npix, 3) image sum:
    unpermuted by ``inv`` (block order) or cut at npix (contiguous ids).
    Returns (that sum, rays summed over the world)."""
    if mesh.spp_group is not None:
        accum = all_reduce_sum(accum, mesh.spp_group)
    full = all_gather_cat(accum, mesh.px_group)
    if inv is None:
        full = full[:npix]
    else:
        full = full[torch.as_tensor(inv, device=full.device).long()]
    return full, sum_int(rays, mesh)


# ----------------------------------------------------------------- render

def render_sharded(scene: Scene, seed: int, *, mesh: Mesh, width: int,
                   height: int, spp: int, spp_chunk: int, max_depth: int,
                   t_min: float, spawn_eps_rel: float,
                   intersector: str = "auto", russian_roulette: bool = True,
                   nee: bool = False, mis: bool = False,
                   stats: dict = None):
    """Render the image across ``mesh`` (JAX ``render_sharded_fn``; the
    module docstring). Every rank of the mesh must call it. ``stats``, if
    given, gets the NEE shadow rays of every rank as ``shadow_lanes``.
    Returns ((H, W, 3) image on the mesh's device, the same on every rank,
    rays traced as an int)."""
    method = path_tracer.resolve_route(scene, intersector, nee, mis)
    scene = scene.to(mesh.device)
    npix = width * height
    chunk, n_chunks = samples(spp, spp_chunk, mesh.n_spp)
    spawn_eps = spawn_eps_rel * scene.scale      # float32, as in JAX
    gen = stream_generator(mesh.device, seed, mesh.px_i, mesh.spp_i)
    tables = dispatch.route_tables(scene, method)
    local = {}
    kw = dict(width=width, height=height, max_depth=max_depth, t_min=t_min,
              spawn_eps=spawn_eps, russian_roulette=russian_roulette,
              nee=nee, mis=mis, stats=local, intersector=method)
    if method in ("pallas", "leaf") and not has_media(scene):
        slots, inv = block_slots(width, height, mesh)
        accum, rays, _steps = render_regen_soa(
            scene, tables, gen, lanes_per_pixel=chunk,
            samples_per_lane=n_chunks, pixel_slots=slots, **kw)
    else:
        lo, n_local = pixel_shard(npix, mesh.n_px, mesh.px_i)
        inv = None
        accum, rays = path_tracer.render_chunks(
            scene, gen, torch.arange(lo, lo + n_local, device=mesh.device),
            spp_chunk=chunk, n_chunks=n_chunks, tables=tables, **kw)
    full, rays = combine(accum, rays, mesh, npix, inv)
    if stats is not None:
        stats["shadow_lanes"] = stats.get("shadow_lanes", 0) + sum_int(
            local.get("shadow_lanes", 0), mesh)
    img = full / (n_chunks * chunk * mesh.n_spp)
    return img.reshape(height, width, 3), rays


def render(scene: Scene, config: RenderConfig, seed: int,
           mesh: Optional[Mesh] = None, stats: dict = None):
    """Render ``config`` across ``mesh`` (``make_mesh()`` by default):
    returns ((H, W, 3) linear image on every rank, rays traced as an
    int)."""
    if mesh is None:
        mesh = make_mesh()
    return render_sharded(
        scene, seed, mesh=mesh, width=config.width, height=config.height,
        spp=config.samples_per_pixel, spp_chunk=config.spp_chunk,
        max_depth=config.max_depth, t_min=config.t_min,
        spawn_eps_rel=config.spawn_eps_rel, intersector=config.intersector,
        russian_roulette=config.russian_roulette, nee=config.nee,
        mis=config.mis, stats=stats)
