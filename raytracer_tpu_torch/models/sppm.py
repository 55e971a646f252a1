"""SPPM integrator: the reference's render algorithm (photon_mapper.rs), the
PyTorch counterpart of ``raytracer_tpu/models/sppm.py``.

Each iteration: a photon pass and two photon maps (global and caustic,
sorted uniform grids), a measurement pass (one jittered camera ray per
pixel walks the specular chain to its first diffuse hit), both photon
queries with the points cell-sorted, and the per-pixel update with the
alpha radius shrink (photon_mapper.rs:49-63). Then a final gather adds the
pixels' density estimates at the first diffuse hit of every camera path
(photon_mapper.rs:326-365).

Routes, as in the JAX package (``soa_eligible``): on a scene without media
the "pallas" (and "auto") and "leaf" routes take the SoA passes of
``wavefront_soa`` on that route's kernel (a regenerating photon pass, the
measurement walk, the regenerating gather); a scene with media, and the
"bruteforce" and "bvh" routes, take the (N, 3) loops of this module
(``trace_photon_deposits``, the (N, 3) ``measurement_pass``, and
``gather_fn``'s chunk loop of ``gather_walk``), whose hit goes through
``path_tracer.hit_and_attrs`` on the route asked for (the closest-hit or
leaf kernel, the brute-force scan or the BVH) and then the media override.
The queries are the dense kernel (``query_impl="dense"``) or the 27-cell
gather of ``ops/photon_grid.py`` ("grid"). On a CUDA device the SoA
photon pass on the fused bounce and both maps are one CUDA graph replay
an iteration (``photon_graph``, ``graphed_photon_pass``: the JAX
``photon_grids``, one device dispatch), and the measurement, the queries
and the update two more, with one host read between them
(``graphed_measure_and_update``).

The whole image is one iteration: the JAX package's pixel-blocked
iteration exists because long TPU dispatches failed, and is not ported.

Random streams: iteration i draws from generators seeded from (seed, i)
and gather batch b from (seed, b), never from one generator carried
across, so a render resumed from a saved state equals a straight one.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

import torch

from raytracer_tpu_torch.models import wavefront_soa as wf
from raytracer_tpu_torch.models.camera import camera_rays
from raytracer_tpu_torch.models.path_tracer import hit_and_attrs, spawn_origin
from raytracer_tpu_torch.ops import dispatch, materials
from raytracer_tpu_torch.ops import photon_grid as pg
from raytracer_tpu_torch.ops.fused_bounce import has_media
from raytracer_tpu_torch.ops.photon_query import query_photons
from raytracer_tpu_torch.scene.types import INTER_ABSORB, INTER_DIFFUSE, Scene
from raytracer_tpu_torch.utils import graphs, nans, timing
from raytracer_tpu_torch.utils.config import RenderConfig, SPPMConfig
from raytracer_tpu_torch.utils.rng import stream_generator
from raytracer_tpu_torch.utils.timing import Progress, Stages, sync_for

PI = 3.141592653589793
PHOTON_T_MIN = 1e-4         # photon_mapper.rs:242
# stream tags of ``stream_generator``
PHOTON_STREAM, MEASURE_STREAM, GATHER_STREAM = 1, 2, 3


class SPPMHalf(NamedTuple):
    """Per-pixel stats for one map (global or caustic). SPPM struct,
    photon_mapper.rs:33-40."""
    flux: torch.Tensor     # (npix, 3)
    radius2: torch.Tensor  # (npix,)
    photons: torch.Tensor  # (npix,) float (alpha makes it real)


class SPPMState(NamedTuple):
    glob: SPPMHalf
    caustic: SPPMHalf
    iteration: int         # iterations done


def init_state(npix: int, device) -> SPPMState:
    """Zeroed per-pixel statistics of both maps on ``device``."""
    def half():
        return SPPMHalf(torch.zeros((npix, 3), device=device),
                        torch.zeros((npix,), device=device),
                        torch.zeros((npix,), device=device))
    return SPPMState(half(), half(), 0)


def state_to(state: SPPMState, device) -> SPPMState:
    return SPPMState(SPPMHalf(*(x.to(device) for x in state.glob)),
                     SPPMHalf(*(x.to(device) for x in state.caustic)),
                     int(state.iteration))


# ----------------------------------------------------------------- routes

def soa_eligible(scene: Scene, method: str) -> bool:
    """Whether SPPM takes the SoA passes (JAX ``_soa_eligible``): the
    resolved route ``method`` (``dispatch.route``) is "pallas" or "leaf"
    and the scene has no media."""
    return method in ("pallas", "leaf") and not has_media(scene)


def _media_u(scene: Scene, U, start: int):
    """The free-flight uniforms in U's rows from ``start`` (one per
    medium), or None on a media-free scene."""
    return wf._media_u(U, start, wf.media_rows(scene))


# ------------------------------------------------------------ photon pass

def trace_photon_deposits(scene: Scene, tables, gen, n_photons: int,
                          max_bounces: int, t_min: float, spawn_eps,
                          intersector: str) -> wf.Deposits:
    """The (N, 3) photon pass (JAX ``trace_photon_deposits``): all
    ``n_photons`` lanes emit once and bounce for a fixed ``max_bounces``
    steps (no host sync), each step's hit on ``intersector``'s route.
    Every surviving diffuse interaction deposits the photon's power from
    before the bounce's renormalisation (photon_mapper.rs:248 pushes
    ``power``, then updates it); the caustic flag marks the first diffuse
    hit after a specular-only prefix (photon_mapper.rs:249-251). Each step
    draws the four photon rows (scatter and roulette, ``materials.
    scatter_photon``) and one free-flight row per medium. Returns
    ``wf.Deposits`` of ``max_bounces * n_photons`` slots, step-major."""
    n = int(n_photons)
    dev = scene.bounds_min.device
    k_rows = wf.U_TRACE_ROWS + wf.media_rows(scene)
    o, d, w = (x.T.contiguous() for x in wf.emit_photons_soa(
        scene.lights, gen, n))
    pos = torch.empty((max_bounces, n, 3), device=dev)
    power = torch.empty_like(pos)
    norm = torch.empty_like(pos)
    flags = torch.empty((2, max_bounces, n), dtype=torch.bool, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    has_spec = torch.zeros_like(alive)
    has_diff = torch.zeros_like(alive)
    for step in range(max_bounces):
        U = torch.rand((k_rows, n), generator=gen, device=dev)
        attrs = hit_and_attrs(scene, o, d, t_min,
                              _media_u(scene, U, wf.U_TRACE_ROWS),
                              alive=alive, intersector=intersector,
                              tables=tables)
        sc, new_power = materials.scatter_photon(scene, U, d, attrs, w)
        live = alive & attrs.valid
        diffuse_now = live & (sc.interaction == INTER_DIFFUSE)
        pos[step] = attrs.p
        power[step] = w
        norm[step] = attrs.normal
        flags[0, step] = diffuse_now
        flags[1, step] = diffuse_now & has_spec & ~has_diff
        cont = live & (sc.interaction != INTER_ABSORB)
        c2 = cont[:, None]
        o = torch.where(c2, spawn_origin(attrs.p, attrs.normal, sc.direction,
                                         spawn_eps), o)
        d = torch.where(c2, sc.direction, d)
        w = torch.where(c2, new_power, w)
        has_spec = has_spec | (cont & ~diffuse_now)
        has_diff = has_diff | diffuse_now
        alive = cont
        nans.check("a photon step", power=w, origin=o, direction=d)
    flat = [x.reshape(-1, 3).T for x in (pos, power, norm)]
    flags = flags.reshape(2, -1)
    return wf.Deposits(*flat, flags[0], flags[1])


# ------------------------------------------------------------ photon maps

# the captured photon passes (``graphed_photon_pass``)
PHOTON_GRAPHS = graphs.GraphCache()


def photon_graph(scene: Scene, method: str, device) -> bool:
    """Whether the photon pass and the measurement run as captured CUDA
    graphs (``graphed_photon_pass``, ``graphed_measure_and_update``),
    from static facts only: on a CUDA device,
    on the SoA route's fused bounce (``wf.use_fused``: the flat or the
    ordered kernel), with ``--debug-nans`` off. The CPU, the "leaf" route
    and the unfused stage (their wrappers compact lanes with ``nonzero``
    and read ``any()``), the (N, 3) route and ``--debug-nans`` (each
    check reads the device) run both eagerly."""
    return (torch.device(device).type == "cuda"
            and soa_eligible(scene, method) and wf.use_fused(scene, method)
            and not nans.enabled())


def trace_deposits(scene: Scene, tables, gen, *, n_photons: int,
                   max_photon_bounces: int, spawn_eps,
                   intersector: str = "pallas") -> wf.Deposits:
    """The photon pass of ``_photon_maps`` of the JAX package. The SoA
    route regenerates (``trace_photon_deposits_regen_soa``, or its
    captured graph where ``photon_graph`` says so: then the deposits are
    the graph's buffers, which the next pass overwrites); the (N, 3)
    route scans ``trace_photon_deposits``. Every call of a route with
    the same ``n_photons`` returns the same number of slots."""
    method = dispatch.route(scene, intersector)
    if photon_graph(scene, method, scene.bounds_min.device):
        dep, _spawned, _maps = graphed_photon_pass(
            scene, tables, gen, n_photons=n_photons,
            max_photon_bounces=max_photon_bounces, spawn_eps=spawn_eps,
            intersector=method)
        return dep
    if soa_eligible(scene, method):
        dep, _spawned = wf.trace_photon_deposits_regen_soa(
            scene, tables, gen, n_photons, max_photon_bounces, PHOTON_T_MIN,
            spawn_eps, intersector=method)
        return dep
    return trace_photon_deposits(scene, tables, gen, n_photons,
                                 max_photon_bounces, PHOTON_T_MIN, spawn_eps,
                                 method)


def _maps(bmin, bmax, dep: wf.Deposits, grid_res, max_valid: int):
    pos, power, norm = dep.pos.T, dep.power.T, dep.norm.T
    g = pg.build_grid(pos, power, norm, dep.valid, bmin, bmax, grid_res,
                      compact=True)
    c = pg.build_grid(pos, power, norm, dep.valid & dep.caustic, bmin, bmax,
                      grid_res, compact=True, max_valid=max_valid)
    return g, c


def build_maps(scene: Scene, dep: wf.Deposits, grid_res, max_valid: int):
    """Both photon maps of deposits ``dep`` (the grids of ``_photon_maps``
    of the JAX package, compact): the global map sorts every deposit
    slot; a path deposits into the caustic set at most once, so the
    caustic map keeps at most ``max_valid``, the photons traced
    (photon_mapper.rs:249-251). Returns (global grid, caustic grid)."""
    return _maps(scene.bounds_min, scene.bounds_max, dep, grid_res,
                 max_valid)


def graphed_photon_pass(scene: Scene, tables, gen, *, n_photons: int,
                        max_photon_bounces: int, spawn_eps, grid_res=None,
                        intersector: str = "pallas",
                        cache: graphs.GraphCache = None):
    """The SoA photon pass (``wf.PhotonPass``), and both maps when
    ``grid_res`` is given, as one replay of a graph captured at the first
    call of its key (``utils/graphs.py``; the JAX ``photon_grids``, one
    device dispatch). The key: the tables' layout, ``n_photons``, the
    lanes (``wf.photon_lanes``, the eager pass's), window,
    ``max_photon_bounces``, ``grid_res`` and the route. Every replay
    counts the pass (``wf.count_pass``), its step kernel's launches
    (``wf.count_kernel_steps``) and, on ordered tables, the walk's chunk
    bodies and live warps (``wf.count_walk`` of the graph's own
    ``WalkCount`` total), as the eager pass does.
    The draws are ``gen``'s, as the eager pass's. Returns (``Deposits``,
    photons spawned, (global grid, caustic grid) or None): the graph's
    buffers, which its next replay overwrites."""
    cache = PHOTON_GRAPHS if cache is None else cache
    dev = scene.bounds_min.device
    eps = torch.as_tensor(spawn_eps, dtype=torch.float32, device=dev)
    inputs = (tables._replace(leaf=None), scene.lights, scene.bounds_min,
              scene.bounds_max, eps.reshape(()))
    lanes = wf.photon_lanes(n_photons)
    window = wf.spawn_window(int(n_photons), lanes)
    grid_res = None if grid_res is None else tuple(grid_res)
    key = ("photon pass", int(n_photons), lanes, window,
           int(max_photon_bounces), PHOTON_T_MIN, grid_res, intersector)

    def build(inp, g):
        tab, lights, bmin, bmax, eps = inp
        pas = wf.PhotonPass(scene, tab, n_photons, max_photon_bounces,
                            PHOTON_T_MIN, eps, lanes=lanes, window=window,
                            intersector=intersector, lights=lights)
        # made before the capture, held while the graph reads it
        res_t = None if grid_res is None else pg.res_tensor(grid_res, dev)

        def program():
            pas.run(g)
            dep, spawned = pas.deposits()
            maps = (None if grid_res is None else
                    _maps(bmin, bmax, dep, grid_res, int(n_photons)))
            walk = (None if pas.walk_count is None
                    else pas.walk_count.total())
            return dep, spawned, maps, walk

        def warm():                # one step and the maps, eagerly
            pas.start(g)
            pas.step(g, 0)
            pas.finish()
            if grid_res is not None:
                _maps(bmin, bmax, pas.deposits()[0], grid_res,
                      int(n_photons))

        return warm, program, (pas, res_t)

    dep, spawned, maps, walk = cache.run(key, inputs, gen, build)
    wf.count_pass(window + int(max_photon_bounces), lanes)
    wf.count_kernel_steps(cache.replayed)
    wf.count_walk(walk)
    return dep, spawned, maps


def photon_maps(scene: Scene, tables, gen, *, n_photons: int,
                max_photon_bounces: int, spawn_eps, grid_res,
                intersector: str = "pallas", stage=None):
    """The photon pass and both maps (the JAX ``photon_grids``). Where
    ``photon_graph`` says so they are one graph replay
    (``graphed_photon_pass``) and the stage "sppm.photon_pass" covers
    both; else the pass ("sppm.photon_pass") and then the grid builds
    ("sppm.grid_build"). Returns (global grid, caustic grid)."""
    stage = stage or Stages(None, scene.bounds_min.device)
    with stage("sppm.photon_pass"):
        method = dispatch.route(scene, intersector)
        if photon_graph(scene, method, scene.bounds_min.device):
            return graphed_photon_pass(
                scene, tables, gen, n_photons=n_photons,
                max_photon_bounces=max_photon_bounces, spawn_eps=spawn_eps,
                grid_res=grid_res, intersector=method)[2]
        dep = trace_deposits(scene, tables, gen, n_photons=n_photons,
                             max_photon_bounces=max_photon_bounces,
                             spawn_eps=spawn_eps, intersector=method)
    with stage("sppm.grid_build"):
        return build_maps(scene, dep, grid_res, n_photons)


# ------------------------------------------------------- measurement pass

def _camera_soa(camera, gen, width: int, height: int, pixel_ids, dev):
    """One jittered camera ray (3, P) per pixel of ``pixel_ids`` (P,), the
    whole image when None, drawn from ``gen``."""
    pix = (torch.arange(width * height, device=dev) if pixel_ids is None
           else pixel_ids)
    px = (pix % width).to(torch.float32)
    py = (pix // width).to(torch.float32)
    return wf.camera_rays_soa(
        camera, px, py, width, height,
        torch.rand((4, pix.shape[0]), generator=gen, device=dev))


def _served(pts: wf.MeasurePoints, pixel_ids, width: int, height: int):
    """``pts`` with the pixels past the image invalid."""
    if pixel_ids is None:
        return pts
    return pts._replace(valid=pts.valid & (pixel_ids < width * height))


def measurement_pass(scene: Scene, tables, gen, width: int, height: int,
                     max_depth: int, t_min: float, spawn_eps,
                     intersector: str = "pallas",
                     pixel_ids=None) -> wf.MeasurePoints:
    """One jittered camera ray per pixel, in pixel order, walked to its
    first diffuse hit: ``wf.measurement_soa`` on the SoA route, else the
    (N, 3) walk of ``_measurement_aos``. ``pixel_ids`` (P,): the pixels
    to serve, the whole image by default (a pixel shard: JAX's
    ``ids_shard``); an id past the image gives an invalid point."""
    method = dispatch.route(scene, intersector)
    o, d = _camera_soa(scene.camera, gen, width, height, pixel_ids,
                       scene.bounds_min.device)
    if soa_eligible(scene, method):
        pts = wf.measurement_soa(scene, tables, gen, o, d,
                                 max_depth=max_depth, t_min=t_min,
                                 spawn_eps=spawn_eps, intersector=method)
    else:
        pts = _measurement_aos(scene, tables, gen, o.T.contiguous(),
                               d.T.contiguous(), max_depth=max_depth,
                               t_min=t_min, spawn_eps=spawn_eps,
                               intersector=method)
    return _served(pts, pixel_ids, width, height)


def _measurement_aos(scene: Scene, tables, gen, o, d, *, max_depth: int,
                     t_min: float, spawn_eps,
                     intersector: str) -> wf.MeasurePoints:
    """update_sppm's specular walk (photon_mapper.rs:277-300) on (N, 3)
    rays (the JAX (N, 3) ``measurement_pass``): no emission, no
    throughput; the point's colour is the material's bsdf
    (``materials.bsdf_from``). Each step draws the three scatter rows and
    one free-flight row per medium."""
    n = o.shape[0]
    dev = o.device
    k_rows = wf.U_DIEL + 1 + wf.media_rows(scene)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    valid = torch.zeros_like(alive)
    p, nrm, bsdf = (torch.zeros((n, 3), device=dev) for _ in range(3))
    step = 0
    while step < max_depth:
        with timing.span("walk.sync"):
            if not bool(alive.any()):
                break
        U = torch.rand((k_rows, n), generator=gen, device=dev)
        attrs = hit_and_attrs(scene, o, d, t_min,
                              _media_u(scene, U, wf.U_DIEL + 1),
                              alive=alive, intersector=intersector,
                              tables=tables)
        feats = materials.fetch_mat_features(scene, attrs.mat_id)
        sc = materials.scatter(scene, U, d, attrs, feats)
        live = alive & attrs.valid
        diffuse_now = live & (sc.interaction == INTER_DIFFUSE)
        dn = diffuse_now[:, None]
        valid = valid | diffuse_now
        p = torch.where(dn, attrs.p, p)
        nrm = torch.where(dn, attrs.normal, nrm)
        bsdf = torch.where(dn, materials.bsdf_from(scene, feats, attrs.p,
                                                   attrs.uv), bsdf)
        cont = live & ~diffuse_now & (sc.interaction != INTER_ABSORB)
        o = torch.where(cont[:, None], spawn_origin(
            attrs.p, attrs.normal, sc.direction, spawn_eps), o)
        d = torch.where(cont[:, None], sc.direction, d)
        alive = cont
        step += 1
        nans.check("a measurement step", point=p, normal=nrm, bsdf=bsdf,
                   origin=o, direction=d)
    timing.count("walk.steps", step)
    return wf.MeasurePoints(valid, p, nrm, bsdf)


# ---------------------------------------------------------------- queries

def _query(grid: pg.PhotonGrid, grid_res, points, radius, cap_radius,
           k_per_cell: int, impl: str) -> pg.QueryResult:
    """Dual-radius query of one map: "dense" is the photon-query kernel
    (exact within-radius sums, the reference kd-tree's semantics,
    photon_mapper.rs:102-114); "grid" the 27-cell gather of
    ``photon_grid.query_grid_chunked`` (at most ``k_per_cell`` photons a
    cell)."""
    if impl == "dense":
        valid = (torch.arange(grid.pos.shape[0], device=grid.pos.device)
                 < grid.n_valid)
        return query_photons(grid.pos, grid.power.float(), grid.norm.float(),
                             valid, points, radius, cap_radius)
    if impl == "grid":
        return pg.query_grid_chunked(grid, grid_res, points, radius,
                                     cap_radius, k_per_cell)
    raise ValueError(f"unknown query_impl {impl!r}")


def _cell_order(pts_p, grid_res, bounds_min, bounds_max):
    """(order, inverse) of the points' one shared stable sort by grid
    cell, which both map queries take, so a kernel tile covers a compact
    patch of surface and culls most photon chunks; a query's results,
    indexed by the inverse, are those of the unsorted query."""
    extent = torch.clamp(bounds_max - bounds_min, min=1e-6)
    inv_cell = pg.res_tensor(tuple(grid_res), pts_p.device) / extent
    order = torch.argsort(pg.cell_ids(pts_p, bounds_min, inv_cell, grid_res),
                          stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(pts_p.shape[0], device=order.device)
    return order, inv


def cap_radius(bounds_min, bounds_max, grid_res):
    """The query radius cap: one grid cell, a 0-d tensor."""
    extent = torch.clamp(bounds_max - bounds_min, min=1e-6)
    return (extent / pg.res_tensor(tuple(grid_res), extent.device)).min()


def query_radii(half: SPPMHalf, cap):
    """(radius, cap radius) per pixel of one map: min(r, cap) once the
    pixel holds photons, the cap before. The cap sums feed only the first
    touch's density init, so an initialised pixel's own radius serves as
    its cap too, and the chunk cull tightens as radii shrink."""
    r = torch.minimum(torch.sqrt(torch.clamp(half.radius2, min=0.0)), cap)
    r = torch.where(half.photons > 0, r, cap)
    return r, torch.where(half.photons > 0, r, cap)


# ------------------------------------------------------------ stat update

def _update_half(half: SPPMHalf, pts: wf.MeasurePoints, q: pg.QueryResult,
                 k_init: float, alpha: float, cap_radius) -> SPPMHalf:
    """Branchless init-or-update (photon_mapper.rs:49-63). The kNN init is
    density-based: r0^2 = h^2 * k/m from the count m within the cap radius
    h (see the JAX ``ops/photon_grid.py`` docstring)."""
    first = pts.valid & (half.photons == 0.0)

    # ---- init path
    m_cap = q.count_cap
    has_any = m_cap > 0.0
    r0_2 = torch.where(has_any,
                       torch.minimum(cap_radius * cap_radius * k_init
                                     / torch.clamp(m_cap, min=1.0),
                                     cap_radius * cap_radius),
                       0.0)
    flux0 = (pts.bsdf * q.flux_cap
             * torch.clamp(k_init / torch.clamp(m_cap, min=1.0),
                           max=1.0)[:, None])
    n0 = torch.where(has_any, float(k_init), 0.0)

    # ---- update path (photon_mapper.rs:55-62)
    m = q.count_r
    n_new = half.photons + alpha * m
    frac = n_new / torch.clamp(half.photons + m, min=1.0)
    r2_new = half.radius2 * frac
    flux_new = (half.flux + pts.bsdf * q.flux_r) * frac[:, None]

    upd = pts.valid & ~first
    flux = torch.where(first[:, None], flux0,
                       torch.where(upd[:, None], flux_new, half.flux))
    radius2 = torch.where(first, r0_2,
                          torch.where(upd, r2_new, half.radius2))
    photons = torch.where(first, n0, torch.where(upd, n_new, half.photons))
    return SPPMHalf(flux, radius2, photons)


# -------------------------------------------------------------- iteration

@timing.spanned("sppm.iteration")
def sppm_iteration(scene: Scene, tables, state: SPPMState, seed: int, *,
                   width: int, height: int, n_photons: int,
                   max_photon_bounces: int, max_camera_bounces: int,
                   grid_res, alpha: float, k_global: float,
                   k_caustic: float, t_min: float, spawn_eps_rel: float,
                   intersector: str = "pallas", query_impl: str = "dense",
                   k_per_cell: int = 64,
                   times: Optional[dict] = None) -> SPPMState:
    """One SPPM iteration over the whole image, on ``intersector``'s
    route, the queries by ``query_impl``. ``times``: a dict that receives
    per-stage seconds (each stage ends in a device sync; on the graphs,
    "photon pass" covers the grid builds, ``photon_maps``, and "query
    global" the caustic query, the update and the measurement's read and
    tail, ``graphed_measure_and_update``): the keys of the stage spans
    (``timing.stage_key``)."""
    dev = scene.bounds_min.device
    it = int(state.iteration)
    spawn_eps = spawn_eps_rel * scene.scale
    stage = Stages(times, dev)
    g_grid, c_grid = photon_maps(
        scene, tables, stream_generator(dev, seed, PHOTON_STREAM, it),
        n_photons=n_photons, max_photon_bounces=max_photon_bounces,
        spawn_eps=spawn_eps, grid_res=grid_res, intersector=intersector,
        stage=stage)
    return measure_and_update(
        scene, tables, state, g_grid, c_grid,
        stream_generator(dev, seed, MEASURE_STREAM, it), width=width,
        height=height, max_camera_bounces=max_camera_bounces,
        grid_res=grid_res,
        alpha=alpha, k_global=k_global, k_caustic=k_caustic, t_min=t_min,
        spawn_eps=spawn_eps, intersector=intersector, query_impl=query_impl,
        k_per_cell=k_per_cell, stage=stage)


def measure_and_update(scene: Scene, tables, state: SPPMState, g_grid,
                       c_grid, gen, *, width: int, height: int,
                       max_camera_bounces: int, grid_res, alpha: float,
                       k_global: float, k_caustic: float, t_min: float,
                       spawn_eps, intersector: str = "pallas",
                       query_impl: str = "dense", k_per_cell: int = 64,
                       pixel_ids=None, stage=None) -> SPPMState:
    """The rest of an iteration once both maps are built: the measurement
    pass of ``pixel_ids`` (the whole image by default) drawn from ``gen``,
    both queries and the update of ``state``, whose rows are those
    pixels'. Where ``photon_graph`` says so this runs as two captured
    graphs (``graphed_measure_and_update``), else eagerly. Returns the
    updated state, one iteration further."""
    stage = stage or Stages(None, scene.bounds_min.device)
    kw = dict(grid_res=tuple(grid_res), alpha=alpha, k_global=k_global,
              k_caustic=k_caustic, query_impl=query_impl,
              k_per_cell=k_per_cell)
    method = dispatch.route(scene, intersector)
    if photon_graph(scene, method, scene.bounds_min.device):
        glob, caus = graphed_measure_and_update(
            scene, tables, state, g_grid, c_grid, gen, width=width,
            height=height, max_camera_bounces=max_camera_bounces,
            t_min=t_min, spawn_eps=spawn_eps, intersector=method,
            pixel_ids=pixel_ids, stage=stage, **kw)
    else:
        with stage("sppm.measurement"):
            pts = measurement_pass(scene, tables, gen, width, height,
                                   max_camera_bounces, t_min, spawn_eps,
                                   intersector, pixel_ids)
        glob, caus = _query_update(state.glob, state.caustic, pts, g_grid,
                                   c_grid, scene.bounds_min,
                                   scene.bounds_max, stage=stage, **kw)
    return SPPMState(glob, caus, int(state.iteration) + 1)


def _query_update(glob: SPPMHalf, caus: SPPMHalf, pts: wf.MeasurePoints,
                  g_grid, c_grid, bounds_min, bounds_max, *, grid_res,
                  alpha: float, k_global: float, k_caustic: float,
                  query_impl: str, k_per_cell: int, stage):
    """Both queries of the points ``pts``, cell-sorted, and the update of
    both halves, each stage under ``stage``. Returns the new halves."""
    with stage("sppm.query.global"):
        cap = cap_radius(bounds_min, bounds_max, grid_res)
        rg, cap_g = query_radii(glob, cap)
        rc, cap_c = query_radii(caus, cap)
        order, inv = _cell_order(pts.p, grid_res, bounds_min, bounds_max)
        p_s = pts.p[order].contiguous()
        qg = _query(g_grid, grid_res, p_s, rg[order], cap_g[order],
                    k_per_cell, query_impl)
    with stage("sppm.query.caustic"):
        qc = _query(c_grid, grid_res, p_s, rc[order], cap_c[order],
                    k_per_cell, query_impl)
    with stage("sppm.update"):
        qg, qc = (pg.QueryResult(*(x[inv] for x in q)) for q in (qg, qc))
        glob = _update_half(glob, pts, qg, k_global, alpha, cap)
        caus = _update_half(caus, pts, qc, k_caustic, alpha, cap)
        for name, half in (("global", glob), ("caustic", caus)):
            nans.check(f"the {name} stat update", flux=half.flux,
                       radius2=half.radius2, photons=half.photons)
    return glob, caus


# ------------------------------------------------- captured measurement

WALK_MARGIN = 2     # steps a captured head walks past the first walk's


class MeasureGraphs(graphs.GraphCache):
    """The captured programs of ``graphed_measure_and_update`` (a head of
    the measurement walk, and the queries with the update), and each
    head's step count: ``head_steps`` of the first eager walk of its key
    (its camera, tables, pixels, image size and route). Apart from
    ``PHOTON_GRAPHS``, so that neither evicts the other; room for two
    renders' pairs."""

    def __init__(self, primitive=graphs.CudaGraph):
        super().__init__(2 * graphs.MAX_GRAPHS, primitive)
        self.steps = {}

    def clear(self):
        super().clear()
        self.steps.clear()


MEASURE_GRAPHS = MeasureGraphs()


def head_steps(walked: int, max_depth: int) -> int:
    """The steps of a captured head of the measurement walk: the
    ``walked`` steps of the first eager walk of its key and WALK_MARGIN
    more, at most ``max_depth``."""
    return min(walked + WALK_MARGIN, max_depth)


def _no_stage(name: str):
    return contextlib.nullcontext()


def graphed_measure_and_update(scene: Scene, tables, state: SPPMState,
                               g_grid, c_grid, gen, *, width: int,
                               height: int, max_camera_bounces: int,
                               grid_res, alpha: float, k_global: float,
                               k_caustic: float, t_min: float, spawn_eps,
                               intersector: str, query_impl: str,
                               k_per_cell: int, pixel_ids=None, stage=None,
                               cache: MeasureGraphs = None):
    """``measure_and_update`` as two graph replays and one host read,
    equal to the eager pass bit for bit (``utils/graphs.py``):

    - the head: the camera rays of ``pixel_ids`` and K = ``head_steps``
      steps of the walk (``wf.measure_step``), no host read, and a device
      flag, a lane alive after step K. Steps past the last lane's end are
      masked and draw what an eager step would, so steps 1..K draw what
      the eager walk draws. On ordered tables the head counts its
      bounces (a ``wf.WalkCount`` of K slots, ``wf.count_walk`` after the
      replay). The first call of a key walks eagerly instead, and that
      walk's steps fix its K;
    - the queries and the update (``_query_update``) of the walk's
      points, ``state`` and the maps (``photon_maps``' graph buffers),
      which the entry copies in, as every input. It is queued before the
      host reads the flag, so the card runs both replays back to back.
      Where the flag is set the walk goes on eagerly from step K + 1
      (``wf.measure_walk_soa``, a read a step) up to
      ``max_camera_bounces``, the update replays again on its points, and
      ``walk.tail`` counts the iteration.

    Stages: "sppm.measurement" covers the head, "sppm.query.global" the
    second replay, the read and any tail. Returns the new halves (global,
    caustic), the caller's own tensors."""
    cache = MEASURE_GRAPHS if cache is None else cache
    stage = stage or Stages(None, scene.bounds_min.device)
    dev = scene.bounds_min.device
    eps = torch.as_tensor(spawn_eps, dtype=torch.float32,
                          device=dev).reshape(())
    head_in = (tables._replace(leaf=None), scene.camera, eps, pixel_ids)
    head = ("measure head", width, height, t_min, intersector,
            graphs.layout(head_in))
    walk_kw = dict(max_depth=max_camera_bounces, t_min=t_min,
                   spawn_eps=eps, intersector=intersector)

    def build_head(inp, g):
        tab, cam, eps, pix = inp
        n = width * height if pix is None else pix.shape[0]
        count = wf.WalkCount.of(tab, True, k, n)

        def program():
            if count is not None:
                count.reset()
            o, d = _camera_soa(cam, g, width, height, pix, dev)
            w = wf.measure_lanes(o, d)
            for i in range(k):
                w = wf.measure_step(tab, g, w, t_min=t_min, spawn_eps=eps,
                                    count=count, slot=i)
            return (w, w.alive.any(),
                    None if count is None else count.total())
        return program, program, count

    def build_update(inp, g):
        w, pix, glob, caus, gg, cg, bmin, bmax = inp
        # made before the capture, held while the graph reads it
        res_t = pg.res_tensor(tuple(grid_res), dev)

        def program():
            pts = _served(wf.measure_points(w), pix, width, height)
            return _query_update(
                glob, caus, pts, gg, cg, bmin, bmax, grid_res=grid_res,
                alpha=alpha, k_global=k_global, k_caustic=k_caustic,
                query_impl=query_impl, k_per_cell=k_per_cell,
                stage=_no_stage)
        return program, program, res_t

    def update(walk):
        inputs = (walk._replace(o=None, d=None, alive=None), pixel_ids,
                  state.glob, state.caustic, g_grid, c_grid,
                  scene.bounds_min, scene.bounds_max)
        key = ("measure update", width, height, tuple(grid_res), alpha,
               k_global, k_caustic, query_impl, k_per_cell)
        # the entry's buffers, which its next replay overwrites: copied
        return graphs.clone(cache.run(key, inputs, gen, build_update))

    with stage("sppm.measurement"):
        k = cache.steps.get(head)
        if k is None:
            o, d = _camera_soa(scene.camera, gen, width, height, pixel_ids,
                               dev)
            walk, walked = wf.measure_walk_soa(
                scene, tables, gen, wf.measure_lanes(o, d), **walk_kw)
            cache.steps[head] = head_steps(walked, max_camera_bounces)
        else:
            walk, alive, counted = cache.run(head + (k,), head_in, gen,
                                             build_head)
            wf.count_walk(counted)
    with stage("sppm.query.global"):
        halves = update(walk)
        if k is not None:
            tail = False
            if k < max_camera_bounces:
                with timing.span("walk.sync"):
                    tail = bool(alive)
            timing.count("walk.tail", int(tail))
            if tail:
                walk, _ = wf.measure_walk_soa(scene, tables, gen, walk,
                                              step=k, **walk_kw)
                halves = update(walk)
            else:
                timing.count("walk.steps", k)
    return halves


# ----------------------------------------------------------- final gather

def density_estimates(state: SPPMState, n_total_photons) -> torch.Tensor:
    """Per-pixel caustic + global radiance estimates flux / (pi r^2
    N_total) (photon_mapper.rs:117-119). (npix, 3)."""
    inv = 1.0 / torch.tensor(float(n_total_photons), dtype=torch.float32)
    inv = inv.to(state.glob.flux.device)

    def one(h: SPPMHalf):
        rad = h.flux / (PI * torch.clamp(h.radius2, min=1e-12)[:, None]) * inv
        return torch.where((h.photons > 0)[:, None], rad, 0.0)

    return one(state.glob) + one(state.caustic)


def gather_walk(scene: Scene, tables, o, d, est, gen, *, max_depth: int,
                t_min: float, spawn_eps, intersector: str):
    """The sample_ray walk (photon_mapper.rs:326-365) of one wavefront
    ``o``/``d`` (N, 3) traced to completion (JAX ``gather_walk``): Le at
    every hit, the lane's density estimate ``est`` (N, 3) at its first
    diffuse hit, where it stops; specular chains multiply the throughput.
    It serves the routes off SoA (``soa_eligible``: media scenes, brute
    force and the BVH); each step draws the three scatter rows and one
    free-flight row per medium. Returns ((N, 3) radiance, rays as an int:
    alive lanes summed over steps)."""
    method = dispatch.route(scene, intersector)
    n = o.shape[0]
    dev = o.device
    k_rows = wf.U_DIEL + 1 + wf.media_rows(scene)
    tput = torch.ones((n, 3), device=dev)
    rad = torch.zeros((n, 3), device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    rays = 0
    steps = 0
    for _ in range(max_depth):
        with timing.span("walk.sync"):
            n_alive = int(alive.sum())
        if n_alive == 0:
            break
        rays += n_alive
        steps += 1
        U = torch.rand((k_rows, n), generator=gen, device=dev)
        attrs = hit_and_attrs(scene, o, d, t_min,
                              _media_u(scene, U, wf.U_DIEL + 1),
                              alive=alive, intersector=method, tables=tables)
        sc = materials.scatter(scene, U, d, attrs)
        live = alive & attrs.valid
        rad = rad + torch.where(live[:, None], tput * sc.emitted, 0.0)
        diffuse_now = live & (sc.interaction == INTER_DIFFUSE)
        rad = rad + torch.where(diffuse_now[:, None], tput * est, 0.0)
        cont = live & ~diffuse_now & (sc.interaction != INTER_ABSORB)
        c2 = cont[:, None]
        tput = torch.where(c2, tput * sc.attenuation, tput)
        o = torch.where(c2, spawn_origin(attrs.p, attrs.normal, sc.direction,
                                         spawn_eps), o)
        d = torch.where(c2, sc.direction, d)
        alive = cont
        nans.check("a gather-walk step", radiance=rad, throughput=tput,
                   origin=o, direction=d)
    timing.count("walk.steps", steps)
    return rad, rays


@timing.spanned("sppm.gather_fn")
def gather_fn(scene: Scene, tables, state: SPPMState, gen, *, width: int,
              height: int, spp: int, spp_chunk: int, max_depth: int,
              t_min: float, spawn_eps_rel: float, n_total_photons: int,
              intersector: str = "pallas"):
    """Final render from the accumulated per-pixel stats (sample_ray,
    photon_mapper.rs:326-365): the regeneration loop on the SoA route,
    else the JAX chunk loop: ceil(spp / spp_chunk) chunks of ``spp_chunk``
    camera rays per pixel, each traced by ``gather_walk``. Returns
    ((H, W, 3) image on the device, rays as an int)."""
    method = dispatch.route(scene, intersector)
    est = density_estimates(state, n_total_photons)
    n_chunks = -(-spp // spp_chunk)
    spawn_eps = spawn_eps_rel * scene.scale
    if soa_eligible(scene, method):
        accum, rays, _steps = wf.gather_regen_soa(
            scene, tables, est, gen, width=width, height=height,
            lanes_per_pixel=spp_chunk, samples_per_lane=n_chunks,
            max_depth=max_depth, t_min=t_min, spawn_eps=spawn_eps,
            intersector=method)
    else:
        accum, rays = gather_chunks(
            scene, tables, est, gen,
            torch.arange(width * height, device=est.device), width=width,
            height=height, spp_chunk=spp_chunk, n_chunks=n_chunks,
            max_depth=max_depth, t_min=t_min, spawn_eps=spawn_eps,
            intersector=method)
    img = accum / (n_chunks * spp_chunk)
    return img.reshape(height, width, 3), rays


def gather_chunks(scene: Scene, tables, est, gen, pixel_ids, *, width: int,
                  height: int, spp_chunk: int, n_chunks: int,
                  max_depth: int, t_min: float, spawn_eps,
                  intersector: str):
    """The JAX gather's loop over chunks of samples (``gather_fn`` off the
    SoA route, and the sharded gather's): ``n_chunks`` chunks of
    ``spp_chunk`` camera rays of every pixel of ``pixel_ids`` (P,)
    (pixel-major within a sample), each traced by ``gather_walk`` with the
    pixels' estimates ``est`` (P, 3). Returns ((P, 3) radiance sum, rays
    as an int)."""
    n = pixel_ids.shape[0]
    ids = pixel_ids.repeat(spp_chunk)
    est_rep = est.repeat(spp_chunk, 1)
    accum = torch.zeros((n, 3), device=est.device)
    rays = 0
    for _ in range(n_chunks):
        o, d = camera_rays(scene.camera, gen, ids, width, height)
        rad, r = gather_walk(scene, tables, o, d, est_rep, gen,
                             max_depth=max_depth, t_min=t_min,
                             spawn_eps=spawn_eps, intersector=intersector)
        accum += rad.reshape(spp_chunk, n, 3).sum(0)
        rays += r
    return accum, rays


# -------------------------------------------------------------- top level

def check_scene(scene: Scene):
    """Refuse what SPPM cannot render, with the JAX package's messages:
    a scene without lights, and moving spheres."""
    if scene.lights.kind.shape[0] == 0:
        raise ValueError(
            "SPPM requires at least one light in the scene (photon emission "
            "has nothing to sample); use --integrator pt for light-free "
            "scenes")
    if scene.spheres.motion_marker.shape[0]:
        raise ValueError(
            "SPPM does not support motion blur (photon/visible-point maps "
            "have no shutter-time dimension — the whole iteration would "
            "silently freeze at t=0); use --integrator pt, which draws "
            "per-sample shutter times")


def iteration_kwargs(scene: Scene, config: RenderConfig) -> dict:
    """The keyword arguments of ``sppm_iteration`` for ``config``."""
    sp: SPPMConfig = config.sppm
    grid_res, _ = pg.choose_grid_resolution(
        scene.bounds_min.cpu().numpy(), scene.bounds_max.cpu().numpy(),
        sp.photons_per_iter, sp.k_global)
    return dict(width=config.width, height=config.height,
                n_photons=sp.photons_per_iter,
                max_photon_bounces=sp.max_photon_bounces,
                max_camera_bounces=sp.max_camera_bounces, grid_res=grid_res,
                alpha=sp.alpha, k_global=sp.k_global,
                k_caustic=sp.k_caustic, t_min=config.t_min,
                spawn_eps_rel=config.spawn_eps_rel,
                intersector=config.intersector, query_impl=sp.query_impl,
                k_per_cell=sp.max_photons_per_cell)


def render(scene: Scene, config: RenderConfig, seed: int, *,
           state: Optional[SPPMState] = None, checkpoint_cb=None,
           device="cuda", times: Optional[dict] = None):
    """Full SPPM render on ``device``: the iterations left after ``state``
    (a fresh state by default), then the final gather, on
    ``config.intersector``'s route. ``checkpoint_cb(state)`` is called
    after every iteration. ``times``: a dict that receives per-stage
    seconds summed over the iterations, plus "gather". ``Progress`` lines
    tick per iteration and per gather batch on a TTY. Returns ((H, W, 3)
    linear image on the device, rays of the gather as an int, the final
    state)."""
    check_scene(scene)
    sp: SPPMConfig = config.sppm
    device = torch.device(device)
    scene = scene.to(device)
    tables = dispatch.route_tables(scene, config.intersector)
    npix = config.width * config.height
    state = init_state(npix, device) if state is None else \
        state_to(state, device)
    kw = iteration_kwargs(scene, config)
    start = int(state.iteration)
    prog = Progress(total=sp.n_iterations, label="sppm iter")
    if start:
        prog.tick(start)          # resumed from a checkpoint
    for _ in range(start, sp.n_iterations):
        state = sppm_iteration(scene, tables, state, seed, times=times, **kw)
        if checkpoint_cb is not None:
            checkpoint_cb(state)
        sync_for(prog, device)
        prog.tick(1)

    # final gather in host batches; spp_chunk is capped so a wavefront
    # stays under ~1.5M lanes
    t0 = time.perf_counter()
    n_total = sp.n_iterations * sp.photons_per_iter
    total = config.samples_per_pixel
    batch = max(1, min(config.host_spp_batch, total))
    chunk = max(1, min(config.spp_chunk, batch, max(1, 1_500_000 // npix)))
    accum = torch.zeros((config.height, config.width, 3), device=device)
    rays, done, b = 0, 0, 0
    prog = Progress(total=total, label="gather spp")
    while done < total:
        spp = min(batch, total - done)
        img, r = gather_fn(
            scene, tables, state,
            stream_generator(device, seed, GATHER_STREAM, b),
            width=config.width, height=config.height, spp=spp,
            spp_chunk=min(chunk, spp), max_depth=config.max_depth,
            t_min=config.t_min, spawn_eps_rel=config.spawn_eps_rel,
            n_total_photons=n_total, intersector=config.intersector)
        accum += img * (spp / total)
        rays += r
        done += spp
        b += 1
        sync_for(prog, device)
        prog.tick(spp, rays=r)
    if times is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        times["gather"] = time.perf_counter() - t0
    return accum, rays, state
