"""Uniform-grid photon map: photons binned over the scene bounds and
sorted by linearized cell id.

The PyTorch counterpart of ``raytracer_tpu/ops/photon_grid.py``:
``PhotonGrid``, ``QueryResult``, ``build_grid``, ``choose_grid_resolution``
and the 27-cell gather query ``query_grid`` / ``query_grid_chunked``, the
``SPPMConfig.query_impl="grid"`` route: each point gathers up to
``k_per_cell`` photons from each of the 27 cells around its own (valid
because query radii are capped at one cell), plain PyTorch. The default
"dense" route queries the sorted arrays with ``ops/photon_query.py``.

Photon arrays keep the JAX package's (P, 3) layout, so both packages hold
the same photon map after the sort, down to the bits: the same float32 cell
ids, the same stable sort, the same bfloat16 payload rounding.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from raytracer_tpu_torch.ops import vec


class PhotonGrid(NamedTuple):
    pos: torch.Tensor         # (P, 3) f32, sorted by cell id
    power: torch.Tensor       # (P, 3) f32, or bf16 when compact
    norm: torch.Tensor        # (P, 3) f32, or bf16 when compact
    cell_start: torch.Tensor  # (C+1,) int32 prefix offsets
    bmin: torch.Tensor        # (3,)
    inv_cell: torch.Tensor    # (3,)
    n_valid: torch.Tensor     # () int32, on the device: no host sync


class QueryResult(NamedTuple):
    flux_r: torch.Tensor     # (N, 3) sum of power * (1 - disk) within r
    count_r: torch.Tensor    # (N,)
    flux_cap: torch.Tensor   # (N, 3) the same within the cap radius
    count_cap: torch.Tensor  # (N,)


@functools.lru_cache(maxsize=16)
def res_tensor(res: Tuple[int, int, int], device) -> torch.Tensor:
    """The grid resolution as a (3,) float32 tensor on ``device``, made
    once per (resolution, device): a grid build copies nothing from the
    host, so that a CUDA graph can capture it. Not to be written to."""
    return torch.tensor(res, dtype=torch.float32, device=device)


def cell_coords(pos, bmin, inv_cell, res: Tuple[int, int, int]):
    """Integer cell coordinates (N, 3) int32 of each (N, 3) position,
    clamped into the grid. The float product is rounded as in the JAX
    package; values are clamped before the integer cast, which changes
    nothing for finite positions and keeps out-of-range ones defined."""
    hi = res_tensor(tuple(res), pos.device)
    x = torch.nan_to_num((pos - bmin) * inv_cell, nan=0.0)
    ci = torch.minimum(torch.clamp(torch.floor(x), min=0.0), hi - 1.0)
    return ci.to(torch.int32)


def cell_ids(pos, bmin, inv_cell, res: Tuple[int, int, int]):
    """Linear cell id (N,) int32 of each (N, 3) position (``cell_coords``
    linearised)."""
    ci = cell_coords(pos, bmin, inv_cell, res)
    return (ci[..., 0] * res[1] + ci[..., 1]) * res[2] + ci[..., 2]


def build_grid(pos, power, norm, valid, bmin, bmax,
               res: Tuple[int, int, int], compact: bool = False,
               max_valid: int = None) -> PhotonGrid:
    """Sort photons by cell; invalid photons take the sentinel cell past
    the last one and so sort behind every valid photon. The sort is stable,
    as ``jnp.argsort`` is.

    ``compact`` stores power and normal as bf16 (positions stay f32 for the
    distance test). ``max_valid``: a static upper bound on the valid count
    (the caustic map's: at most one deposit per photon path); the sorted
    arrays are cut to it, which is exact because every valid photon sorts
    before the sentinel tail."""
    n_cells = res[0] * res[1] * res[2]
    extent = torch.clamp(bmax - bmin, min=1e-6)
    inv_cell = res_tensor(tuple(res), pos.device) / extent
    cid = cell_ids(pos, bmin, inv_cell, res)
    cid = torch.where(valid, cid, n_cells)
    order = torch.argsort(cid, stable=True)
    if max_valid is not None and max_valid < order.shape[0]:
        order = order[:max_valid]
    cid_sorted = cid[order].contiguous()
    cells = torch.arange(n_cells + 1, dtype=torch.int32, device=pos.device)
    cell_start = torch.searchsorted(cid_sorted, cells).to(torch.int32)
    payload = torch.bfloat16 if compact else torch.float32
    return PhotonGrid(
        pos=pos[order].to(torch.float32), power=power[order].to(payload),
        norm=norm[order].to(payload), cell_start=cell_start, bmin=bmin,
        inv_cell=inv_cell, n_valid=valid.sum().to(torch.int32))


# the 27 neighbour cells' offsets, x slowest (JAX's order)
_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]


def query_grid(grid: PhotonGrid, res: Tuple[int, int, int], points, radius,
               cap_radius, k_per_cell: int) -> QueryResult:
    """Dual fixed-radius gather around each point (N, 3): up to
    ``k_per_cell`` photons from each of the 27 cells around the point's
    own. ``radius`` (N,) is clamped by the caller to at most
    ``cap_radius`` (a scalar or (N,)), which must be at most one cell.
    Each photon within a radius adds power x (1 - |n . unit(p_ph - p)|)
    (the disk factor, photon_mapper.rs:77-79) to that radius's flux and 1
    to its count."""
    n = points.shape[0]
    dev = points.device
    n_cells = res[0] * res[1] * res[2]
    p_total = grid.pos.shape[0]
    ci = cell_coords(points, grid.bmin, grid.inv_cell, res)
    r2 = radius * radius
    cap2 = torch.as_tensor(cap_radius, dtype=torch.float32,
                           device=dev).expand(n) ** 2
    offs = torch.tensor(_OFFSETS, dtype=torch.int32, device=dev)
    cc = ci[:, None, :] + offs[None]                              # (N, 27, 3)
    res_t = torch.tensor(res, dtype=torch.int32, device=dev)
    in_grid = ((cc >= 0) & (cc < res_t)).all(-1)                 # (N, 27)
    cid = (cc[..., 0] * res[1] + cc[..., 1]) * res[2] + cc[..., 2]
    cid = cid.clamp(0, n_cells - 1).long()
    start = grid.cell_start[cid].long()
    end = grid.cell_start[cid + 1].long()
    k_ar = torch.arange(k_per_cell, device=dev)
    idx = start[..., None] + k_ar                                 # (N,27,K)
    m = ((idx < end[..., None]) & in_grid[..., None]).reshape(n, -1)
    # masked lanes fetch row 0 (one hot line instead of junk rows)
    idx = torch.where(m, idx.reshape(n, -1).clamp(0, p_total - 1), 0)

    ppos = grid.pos[idx]                                          # (N,27K,3)
    ppow = grid.power[idx].float()
    pnrm = grid.norm[idx].float()
    delta = ppos - points[:, None, :]
    d2 = (delta * delta).sum(-1)
    disk = (pnrm * vec.unit(delta)).sum(-1).abs()
    w = (1.0 - disk)[..., None] * ppow
    in_r = m & (d2 <= r2[:, None])
    in_cap = m & (d2 <= cap2[:, None])
    return QueryResult(torch.where(in_r[..., None], w, 0.0).sum(1),
                       in_r.sum(1).to(torch.float32),
                       torch.where(in_cap[..., None], w, 0.0).sum(1),
                       in_cap.sum(1).to(torch.float32))


def query_grid_chunked(grid: PhotonGrid, res, points, radius, cap_radius,
                       k_per_cell: int, chunk: int = 2048) -> QueryResult:
    """``query_grid`` over chunks of ``chunk`` points, which bounds the
    (chunk, 27 k_per_cell) gather's memory."""
    n = points.shape[0]
    cap = torch.as_tensor(cap_radius, dtype=torch.float32,
                          device=points.device).expand(n)
    parts = [query_grid(grid, res, points[i:i + chunk], radius[i:i + chunk],
                        cap[i:i + chunk], k_per_cell)
             for i in range(0, n, chunk)]
    return QueryResult(*(torch.cat(xs) for xs in zip(*parts)))


def choose_grid_resolution(bounds_min, bounds_max, n_photons: int,
                           k_nearest: int, max_res: int = 64):
    """Host-side heuristic: cell size ~ the expected kNN init radius
    r0 = sqrt(k * A / (pi * P)) with A ~ the bbox surface area. Static per
    render. Takes numpy arrays or CPU tensors."""
    bmin = np.asarray(bounds_min, np.float64)
    bmax = np.asarray(bounds_max, np.float64)
    ext = np.maximum(bmax - bmin, 1e-6)
    area = 2.0 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[0] * ext[2])
    r0 = float(np.sqrt(max(k_nearest, 1) * area / (np.pi * max(n_photons, 1))))
    res = tuple(int(np.clip(np.ceil(e / max(r0, 1e-6)), 2, max_res))
                for e in ext)
    return res, r0
