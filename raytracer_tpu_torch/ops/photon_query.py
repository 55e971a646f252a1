"""Dense dual-radius photon query: for each point, the flux and count of
the photons within its radius r and within its cap radius, each photon
weighted by 1 - |n . unit(delta)| (photon_mapper.rs:77-79, 102-114).

The port of ``raytracer_tpu/ops/pallas_photon.py::_query_kernel`` (reached
through ``_call_query``/``query_photons``). The CUDA kernel lives in
``csrc/photon_query.cu``; ``query_photons_plain`` below is the same
function in plain PyTorch. The wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.

Photons are packed as in the JAX package (``_pack_photons``): component
planes (3, P) f32 with invalid photons at ``BIG``, a (6, P) bf16 payload
(power, normal), and per-chunk AABBs over CHUNK consecutive photons; the
port adds the AABBs of groups of GROUP photons. Every cull compares the
squared gap between a photon box and a box of points with the largest r^2
or cap^2 of those points, each quantity rounded as the per-pair distance
is, so no cull drops a photon in reach and every version counts the same
photons, bit for bit.

The kernel splits its work into items (``plan_items``, its plain twin):
tiles of TILE cell-sorted points, each tile's live chunks cut into items of
at most ``ic`` chunks, and within a chunk only the photon groups the tile
can reach (``query_items_plain`` runs that decomposition in plain PyTorch).
A tile's partial sums are added in item order, so results do not vary
from run to run.

No TPU mechanism carries over: no cull bit words, no 384k-photon slabs, no
bf16 flux matmul. The sums are kept in float32 from float32 weights, which
is more exact than the TPU kernel's bf16 product (its ~0.4% rounding is the
JAX tests' 2e-2 band).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from raytracer_tpu_torch.kernels import build, launch
from raytracer_tpu_torch.ops.photon_grid import QueryResult
from raytracer_tpu_torch.utils import timing

TILE = 64       # points per kernel tile: a warp, 2 points a lane
CHUNK = 1024    # photons per chunk box
GROUP = 32      # photons per group box (one per lane of a chunk)
ITEM = 4        # live chunks per work item, at least
BUDGET = 16384  # work items beyond one per tile, at most
BIG = 3.0e38
# plain version: points per cull block, and at most this many (point,
# photon) pairs per piece
PLAIN_POINTS = 2048
PLAIN_PAIRS = 1 << 24


class PhotonPlanes(NamedTuple):
    """Photons packed for the query (``_pack_photons``)."""
    posf: torch.Tensor     # (3, Ppad) f32, invalid and padding at BIG
    payload: torch.Tensor  # (6, Ppad) bf16: power rgb, normal xyz
    cull: torch.Tensor     # (6, Ppad / CHUNK) f32: AABB lo xyz, hi xyz
    gcull: torch.Tensor    # (6, Ppad / GROUP) f32: the same per group
    n_live: torch.Tensor   # (1,) int32 on the device: one past the last
    #                        valid photon (the valid count for build_grid's
    #                        valid-first order); chunks past it are not read


def _pack_photons(pos, power, norm, valid) -> PhotonPlanes:
    """Component planes and per-chunk AABBs. ``pos``/``power``/``norm``
    (P, 3), ``valid`` (P,) bool. An all-invalid chunk gets an inverted AABB
    (lo = BIG, hi = -BIG) and never passes the cull."""
    p = pos.shape[0]
    p_pad = max(CHUNK, -(-p // CHUNK) * CHUNK)
    pad = p_pad - p
    dev = pos.device
    f32 = torch.float32
    posx = torch.where(valid[:, None], pos.to(f32), BIG)
    pw, nm = power, norm
    if pad:
        posx = torch.cat([posx, torch.full((pad, 3), BIG, device=dev)])
        pw = torch.cat([pw, torch.zeros((pad, 3), dtype=pw.dtype,
                                        device=dev)])
        nm = torch.cat([nm, torch.zeros((pad, 3), dtype=nm.dtype,
                                        device=dev)])
    posf = posx.T.contiguous()
    payload = torch.cat([pw.T, nm.T], 0).to(torch.bfloat16).contiguous()
    cull, gcull = _boxes(posx, CHUNK), _boxes(posx, GROUP)
    idx = torch.arange(1, p + 1, dtype=torch.int32, device=dev)
    n_live = torch.where(valid, idx, 0).amax().reshape(1) if p else \
        torch.zeros((1,), dtype=torch.int32, device=dev)
    return PhotonPlanes(posf, payload, cull, gcull, n_live.to(torch.int32))


def _boxes(posx, size: int):
    """(6, P / size) AABBs of ``size`` consecutive photons (P, 3), over the
    valid ones (< BIG); inverted (lo = BIG, hi = -BIG) where none is."""
    pc = posx.reshape(-1, size, 3)
    live = pc < BIG
    lo = torch.where(live, pc, BIG).amin(1).T
    hi = torch.where(live, pc, -BIG).amax(1).T
    return torch.cat([lo, hi], 0).contiguous()


# --------------------------------------------------------------- plain

def _gap2(lo, hi, clo, chi):
    """Squared distance between each box [lo, hi] (T, 3) and each box
    [clo, chi] (3, K), (T, K), rounded in the per-pair order (x + y) + z."""
    g = torch.clamp(torch.maximum(clo[None] - hi[:, :, None],
                                  lo[:, :, None] - chi[None]), min=0.0)
    g2 = g * g
    return (g2[:, 0] + g2[:, 1]) + g2[:, 2]


def query_photons_plain(planes: PhotonPlanes, points, r2, cap2) -> QueryResult:
    """The query in plain PyTorch (any device). ``points`` (N, 3) f32,
    ``r2``/``cap2`` (N,) f32. Points go in blocks of PLAIN_POINTS, each
    against the photons of the chunks that pass the cull for the block.
    Float32 matmuls must run in full precision (PyTorch's default)."""
    n = points.shape[0]
    dev = points.device
    out = torch.zeros((n, 8), device=dev)
    k_live = _live_chunks(planes)
    if n == 0 or k_live == 0:
        return _result(out)
    clo, chi = planes.cull[0:3, :k_live], planes.cull[3:6, :k_live]
    lanes = torch.arange(CHUNK, device=dev)
    for a in range(0, n, PLAIN_POINTS):
        p = points[a:a + PLAIN_POINTS]
        rr, cc = r2[a:a + PLAIN_POINTS], cap2[a:a + PLAIN_POINTS]
        reach2 = torch.maximum(rr, cc).amax()
        near = _gap2(p.amin(0)[None], p.amax(0)[None], clo, chi)[0] <= reach2
        with timing.span("query.sync"):
            sel = (near.nonzero()[:, 0, None] * CHUNK + lanes).reshape(-1)
        step = max(CHUNK, PLAIN_PAIRS // p.shape[0] // CHUNK * CHUNK)
        acc = out[a:a + PLAIN_POINTS]
        for b in range(0, sel.shape[0], step):
            _fold_plain(planes, sel[b:b + step], p, rr, cc, acc)
    return _result(out)


def _live_chunks(planes: PhotonPlanes) -> int:
    """The chunks up to the last valid photon's (a host read)."""
    with timing.span("query.sync"):
        return -(-int(planes.n_live[0]) // CHUNK)


def _result(out) -> QueryResult:
    return QueryResult(flux_r=out[:, 0:3], count_r=out[:, 3],
                       flux_cap=out[:, 4:7], count_cap=out[:, 7])


class Plan(NamedTuple):
    """The kernel's work items (``csrc/photon_query.cu``: query_cull and
    query_plan): tiles of TILE consecutive points, each tile's live chunks
    cut into items of at most ``ic`` chunks."""
    lo: torch.Tensor      # (tiles, 3) each tile's points' box
    hi: torch.Tensor      # (tiles, 3)
    reach2: torch.Tensor  # (tiles,) its largest r^2 or cap^2
    live: torch.Tensor    # (tiles, k_live) bool: chunk passes the tile cull
    count: torch.Tensor   # (tiles,) int64 live chunks per tile
    ic: int               # live chunks per item, at most
    item0: torch.Tensor   # (tiles + 1,) int64 first item of each tile


def tile_boxes(points, r2, cap2, tile: int = TILE) -> tuple:
    """(lo, hi, reach2) of each tile of ``tile`` points; the ragged last
    tile takes its points only."""
    n = points.shape[0]
    tiles = -(-n // tile)
    pad = tiles * tile - n
    dev = points.device
    v = (torch.arange(tiles * tile, device=dev) < n).reshape(tiles, tile, 1)
    p = torch.cat([points, torch.zeros((pad, 3), device=dev)]).reshape(
        tiles, tile, 3)
    reach = torch.cat([torch.maximum(r2, cap2),
                       torch.full((pad,), -BIG, device=dev)])
    return (torch.where(v, p, BIG).amin(1), torch.where(v, p, -BIG).amax(1),
            reach.reshape(tiles, tile).amax(1))


def plan_items(planes: PhotonPlanes, points, r2, cap2,
               tile: int = TILE) -> Plan:
    """The plain twin of the kernel's item list: T live (tile, chunk)
    pairs, ic = max(ITEM, ceil(T / BUDGET)), max(1, ceil(count / ic))
    items per tile. ``tile``: points per tile (the kernel's TILE)."""
    lo, hi, reach2 = tile_boxes(points, r2, cap2, tile)
    k_live = _live_chunks(planes)
    live = _gap2(lo, hi, planes.cull[0:3, :k_live],
                 planes.cull[3:6, :k_live]) <= reach2[:, None]
    count = live.sum(1)
    with timing.span("query.sync"):
        total = int(count.sum())
    ic = max(ITEM, -(-total // BUDGET))
    items = torch.clamp(-(-count // ic), min=1)
    item0 = torch.cat([items.new_zeros(1), torch.cumsum(items, 0)])
    return Plan(lo, hi, reach2, live, count, ic, item0)


def item_chunks(plan: Plan, tile: int) -> list:
    """The chunks of each item of ``tile``, in item order."""
    with timing.span("query.sync"):
        c = torch.nonzero(plan.live[tile])[:, 0]
        n = int(plan.item0[tile + 1] - plan.item0[tile])
    return [c[k * plan.ic:(k + 1) * plan.ic] for k in range(n)]


def live_groups(planes: PhotonPlanes, plan: Plan, tile: int, chunk: int):
    """The groups (global indices) of ``chunk`` that ``tile`` can reach."""
    g = torch.arange(chunk * (CHUNK // GROUP), (chunk + 1) * (CHUNK // GROUP),
                     device=planes.gcull.device)
    box = planes.gcull[:, g]
    near = _gap2(plan.lo[tile:tile + 1], plan.hi[tile:tile + 1], box[0:3],
                 box[3:6])[0] <= plan.reach2[tile]
    return g[near]


def query_items_plain(planes: PhotonPlanes, points, r2, cap2) -> QueryResult:
    """The kernel's decomposition in plain PyTorch: per tile, per item, the
    reachable groups of its chunks, partial sums added in item order. The
    same function as ``query_photons_plain``; a loop over tiles, for tests
    at small sizes."""
    n = points.shape[0]
    out = torch.zeros((n, 8), device=points.device)
    if n == 0:
        return _result(out)
    plan = plan_items(planes, points, r2, cap2)
    lanes = torch.arange(GROUP, device=points.device)
    for tile in range(plan.lo.shape[0]):
        a = tile * TILE
        p, rr, cc = points[a:a + TILE], r2[a:a + TILE], cap2[a:a + TILE]
        for chunks in item_chunks(plan, tile):
            part = torch.zeros((p.shape[0], 8), device=points.device)
            with timing.span("query.sync"):
                chunks = chunks.tolist()
            groups = [live_groups(planes, plan, tile, c) for c in chunks]
            if groups:
                j = (torch.cat(groups)[:, None] * GROUP + lanes).reshape(-1)
                _fold_plain(planes, j, p, rr, cc, part)
            out[a:a + TILE] += part
    return _result(out)


def _fold_plain(planes: PhotonPlanes, j, p, rr, cc, acc):
    """Add the photons ``j`` to the sums ``acc`` (M, 8) of the points
    ``p`` (M, 3) with squared radii ``rr``, ``cc``."""
    dx = planes.posf[0, j] - p[:, 0, None]
    dy = planes.posf[1, j] - p[:, 1, None]
    dz = planes.posf[2, j] - p[:, 2, None]
    d2 = (dx * dx + dy * dy) + dz * dz
    in_r = d2 <= rr[:, None]
    in_c = d2 <= cc[:, None]
    pay = planes.payload[:, j].to(torch.float32)
    nd = pay[3] * dx + pay[4] * dy + pay[5] * dz
    s = 1.0 - nd.abs() * torch.rsqrt(torch.clamp(d2, min=1e-20))
    pw = pay[0:3].T
    acc[:, 0:3] += torch.where(in_r, s, 0.0) @ pw
    acc[:, 3] += in_r.sum(1)
    acc[:, 4:7] += torch.where(in_c, s, 0.0) @ pw
    acc[:, 7] += in_c.sum(1)


def kernel_pairs(planes: PhotonPlanes, points, r2, cap2) -> tuple:
    """(live (tile, chunk) pairs, live (tile, group) pairs) of the kernel's
    culls on these inputs: it tests TILE x GROUP (point, photon) pairs for
    each live (tile, group) pair."""
    plan = plan_items(planes, points, r2, cap2)
    k_live = plan.live.shape[1]
    gb = planes.gcull[:, :k_live * (CHUNK // GROUP)]
    groups = 0
    for a in range(0, plan.lo.shape[0], 256):
        near = _gap2(plan.lo[a:a + 256], plan.hi[a:a + 256], gb[0:3],
                     gb[3:6]) <= plan.reach2[a:a + 256, None]
        groups += int(near.sum())
    return int(plan.count.sum()), groups


# -------------------------------------------------------------- kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I,            # points r2 cap2 n
             _P, _P, _P, _P, _I, _P,    # posf payload cull gcull n_chunks
             #                            n_live
             _P, _P, _P, _P]            # out work slots stream


def _check(name, x, dev, dtype, shape):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(
            f"photon query: {name} must be {dtype} {shape} on {dev}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"photon query: {name} must be contiguous")


def _library():
    """The kernel's library, its shapes checked against this module's."""
    lib = build.load_library("photon_query")
    if lib.rt_photon_query_work.argtypes is None:
        lib.rt_photon_query_work.argtypes = [_I, _I]
        lib.rt_photon_query_work.restype = _I
        lib.rt_photon_query_dims.argtypes = [_P]
        lib.rt_photon_query_dims.restype = _I
    dims = (ctypes.c_int * 6)()
    lib.rt_photon_query_dims(ctypes.cast(dims, _P))
    ours = (TILE, GROUP, CHUNK, ITEM, BUDGET)
    theirs = (dims[0], dims[2], dims[3], dims[4], dims[5])
    if theirs != ours:
        raise RuntimeError(
            f"photon query: the kernel's tile, group, chunk, item and budget "
            f"{theirs} are not this module's {ours} (plan_items)")
    return lib, dims[1]


def _query_cuda(planes: PhotonPlanes, points, r2, cap2) -> QueryResult:
    dev = points.device
    n = points.shape[0]
    p_pad = planes.posf.shape[1]
    k = p_pad // CHUNK
    f32 = torch.float32
    _check("points", points, dev, f32, (n, 3))
    _check("r2", r2, dev, f32, (n,))
    _check("cap2", cap2, dev, f32, (n,))
    _check("posf", planes.posf, dev, f32, (3, p_pad))
    _check("payload", planes.payload, dev, torch.bfloat16, (6, p_pad))
    _check("cull", planes.cull, dev, f32, (6, k))
    _check("gcull", planes.gcull, dev, f32, (6, k * (CHUNK // GROUP)))
    _check("n_live", planes.n_live, dev, torch.int32, (1,))
    if p_pad != k * CHUNK:
        raise ValueError(f"photon query: {p_pad} photons is not a whole "
                         f"number of {CHUNK}-photon chunks")
    out = torch.empty((n, 8), dtype=f32, device=dev)
    lib, slots_n = _library()
    work = torch.empty((lib.rt_photon_query_work(n, k),), dtype=torch.int32,
                       device=dev)
    slots = torch.empty((slots_n, TILE, 8), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch("photon_query", "photon_query", "rt_photon_query",
               _ARGTYPES, (
                   points.data_ptr(), r2.data_ptr(), cap2.data_ptr(), n,
                   planes.posf.data_ptr(), planes.payload.data_ptr(),
                   planes.cull.data_ptr(), planes.gcull.data_ptr(), k,
                   planes.n_live.data_ptr(), out.data_ptr(),
                   work.data_ptr(), slots.data_ptr(), stream),
               "photon query kernel")
    return _result(out)


def query_planes(planes: PhotonPlanes, points, r2, cap2) -> QueryResult:
    """Query packed photons. ``points`` (N, 3) f32, ``r2``/``cap2`` (N,)
    f32 squared radii. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if points.device.type == "cpu":
        return query_photons_plain(planes, points, r2, cap2)
    if points.device.type != "cuda":
        raise NotImplementedError(
            f"photon query: no kernel for {points.device}")
    return _query_cuda(planes, points, r2, cap2)


def query_photons(pos, power, norm, valid, points, radius,
                  cap_radius) -> QueryResult:
    """Dense dual-radius photon query, the JAX ``query_photons``
    interface: ``pos/power/norm`` (P, 3) photons with a (P,) validity
    mask, ``points`` (N, 3), ``radius`` and ``cap_radius`` scalars or (N,).
    Any photon order is correct; build_grid's cell-sorted, valid-first
    order makes the cull effective."""
    n = points.shape[0]
    dev = points.device

    def per_point(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return x.expand(n).contiguous() if x.dim() == 0 else x

    r, cap = per_point(radius), per_point(cap_radius)
    planes = _pack_photons(pos, power, norm, valid)
    return query_planes(planes, points.to(torch.float32).contiguous(),
                        r * r, cap * cap)
