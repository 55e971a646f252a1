"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, render.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
   no CUDA device is an error;
2. build the three kernels from ``raytracer_tpu_torch/csrc`` (one nvcc
   per source, started together), with ptxas registers and spills;
3. the bounce kernel against its plain PyTorch version on the card, on the
   bounce cases of ``tests/test_torch_bounce.py`` and on scene_500 at the
   main path's width (800x600 = 480,000 lanes: camera rays, then a second
   bounce fed from the first one's outputs), with the kernel's and the
   plain version's times;
4. the photon-query kernel against its plain version: the four cases of
   ``tests/test_pallas_photon.py`` and both maps of one Cornell iteration
   at 800x800 points / 500,000 photons, counts bit-equal, with both times;
5. a 32x32 render of ``three_spheres`` and a 32x32 Cornell SPPM render on
   the card, held to the Monte-Carlo bands of ``tests/golden/
   three_spheres_32.npz`` and ``cornell_sppm_32.npz``;
6. the path tracer's main path: ``data/scene_500.json`` at 800x600,
   32 spp, depth 16, Russian roulette off and on, through
   ``path_tracer.render``, with the bounce kernel's launch count;
7. the SPPM path: Cornell with its mesh at 800x800, 500,000 photons per
   iteration, 4 iterations, a 16-spp gather at depth 50, through
   ``sppm.render``, with per-stage times and both kernels' launch counts;
8. the closest-hit kernel against its plain version: the cases of
   ``tests/test_torch_closest.py`` (half the lanes with a finite t_max),
   480,000 scene_500 camera rays, and the shadow rays of the first NEE
   step of an 800x600 scene_500 render, with both times; then the unfused
   bounce (closest-hit kernel + plain attributes and scatter) against the
   fused kernel at 480,000 lanes;
9. NEE and MIS: 32x32 ``three_spheres`` renders in the golden bands, the
   Cornell direct-light oracle, and scene_500 at 800x600, 32 spp, depth
   16, RR off, with NEE and then with MIS, through ``path_tracer.render``,
   each image mean within 3% of phase 6's plain-PT mean.

It imports no JAX. The line before the last is a JSON object with the
kernels' launches, errors, times and bounds; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT, SPP, DEPTH = 800, 600, 32, 16
T_MIN, EPS_REL = 1e-3, 1e-5
N_SMALL = 2048
INTER_AGREE = 0.999     # share of alive lanes whose interaction must agree
RTOL = ATOL = 1e-4      # n, nd, att, emit (plus the propagated point term)
P_TOL_REL = 1e-5        # p, no: atol = P_TOL_REL * scene.scale
EDGE_ULPS = 64          # width of a sphere silhouette's decision edge
DEV = "cuda"
KERNELS = ("bounce", "photon_query", "closest")
# photon query: flux |kernel - plain| <= Q_RTOL |plain| + Q_ATOL max|plain|.
# Both sum non-negative float32 terms, in another order (the kernel one
# photon at a time, the plain version by chunked matmuls); the kernel's
# rsqrtf is within 2 ulp. Counts must be bit-equal.
Q_RTOL, Q_ATOL = 1e-4, 1e-6
PLAIN_STRIDE = 10       # the query timings take every 10th point tile
SPPM_W = SPPM_H = 800
SPPM_PHOTONS, SPPM_ITERS, SPPM_SPP, SPPM_DEPTH = 500_000, 4, 16, 50
MEAN_TOL = 0.03         # NEE/MIS image mean against plain PT's
ORACLE, ORACLE_TOL = 0.01046, 0.05   # tests/test_nee.py, Cornell floor
# The card's peaks (NVIDIA's data sheet, H100 SXM at 700 W): FP32 outside
# the tensor cores, and device memory.
PEAK_FP32, PEAK_BYTES = 67e12, 3.35e12
# FP32 operations per pair test, counted from the sources (a sqrt, a
# division or a reciprocal counts one; compares do not count):
# csrc/sweep.cuh sphere 17 (oc 3, half_b 5, c 6, disc 3; the root's 5 more
# only where disc >= 0 are not counted), rect 6, triangle 38;
# csrc/photon_query.cu 8 per (point, photon) pair of a live chunk, 11 more
# per photon within either radius and 4 per sum it joins.
SPH_FLOPS, RECT_FLOPS, TRI_FLOPS = 17, 6, 38
Q_PAIR_FLOPS, Q_NEAR_FLOPS, Q_SUM_FLOPS = 8, 11, 4


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ phase 1

def card() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's smoke run needs one")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, {torch.cuda.device_count()} device(s)")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


# ------------------------------------------------------------------ phase 2

def build() -> float:
    from raytracer_tpu_torch.kernels import build as kbuild
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(kbuild.build, KERNELS))
    for name in KERNELS:
        kbuild.load_library(name)
    dt = time.perf_counter() - t0
    for name in KERNELS:
        ptxas = [ln.strip() for ln in kbuild.build_log(name).splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"build: lib{name}.so; " + " | ".join(ptxas))
    log(f"build: {len(KERNELS)} libraries in {dt:.2f} s (in parallel)")
    return dt


# ------------------------------------------------------------------ phase 3

def load(name: str, aspect: float):
    from raytracer_tpu_torch.scene import builtin, loader
    if name == "three_spheres":
        return builtin.three_spheres(aspect)
    if name == "cornell_mesh":
        return builtin.cornell_box(aspect, with_mesh=True)
    return loader.load_scene(os.path.join(ROOT, "data", f"{name}.json"),
                             aspect_ratio=aspect)


def make_rays(scene, seed: int, n: int, width: int, height: int,
              camera_share: float, dev):
    """Camera rays through random pixels (``camera_share`` of the lanes)
    and random rays inside the scene bounds; 3% dead lanes; scatter
    uniforms in rows 0-2, spawn epsilon in row 3. Numpy draws, as in the
    CPU tests."""
    from raytracer_tpu_torch.models.wavefront_soa import camera_rays_soa
    rng = np.random.default_rng(seed)
    h = int(n * camera_share)
    px = torch.from_numpy(rng.integers(0, width, h).astype(np.float32))
    py = torch.from_numpy(rng.integers(0, height, h).astype(np.float32))
    cam_uni = torch.from_numpy(rng.random((4, h), dtype=np.float32))
    co, cd = camera_rays_soa(scene.camera, px, py, width, height, cam_uni)
    lo = scene.bounds_min.numpy()[:, None]
    hi = scene.bounds_max.numpy()[:, None]
    o_rand = lo + rng.random((3, n - h)) * (hi - lo)
    d_rand = rng.normal(size=(3, n - h))
    o = np.concatenate([co.numpy(), o_rand], 1).astype(np.float32)
    d = np.concatenate([cd.numpy(), d_rand], 1).astype(np.float32)
    alive = rng.random(n) > 0.03
    eps = np.float32(EPS_REL) * scene.scale.numpy()
    uni = np.concatenate([rng.random((3, n), dtype=np.float32),
                          np.full((1, n), eps, np.float32)], 0)
    return tuple(torch.from_numpy(x).to(dev) for x in (o, d, alive, uni))


def plain_bounce(tab, o, d, alive, uni):
    """The plain version, with the winner's type and index kept for the
    tolerance of normals."""
    from raytracer_tpu_torch.ops import fused_bounce as fb
    hit = fb._closest_plain(tab, o, d, T_MIN, alive)
    return fb._bounce_values(tab, o, d, uni, *hit), hit[1], hit[2]


def grazes(tab, o, d, p, ty, ix) -> np.ndarray:
    """Per lane: does the ray graze the silhouette of a sphere that one of
    the two versions took as its winner (the plain version's ``ty``/``ix``,
    or the sphere whose surface holds the kernel's hit point ``p``)? In
    float64, disc / a = r^2 - perp^2, where perp is the ray's distance from
    the centre; the lane is on that decision edge when this lies within
    EDGE_ULPS float32 ulps of |o - c|^2, the term whose rounding decides
    the float32 test."""
    sph = tab.sph.double().cpu().numpy()
    if not len(sph) or not len(o.T):
        return np.zeros(len(o.T), bool)
    c, r2 = sph[:, :3], sph[:, 3]
    o, d, p = (x.T.astype(np.float64) for x in (o, d, p))
    kern = np.argmin(np.abs(np.linalg.norm(p[:, None] - c[None], axis=2)
                            - np.sqrt(r2)[None]), axis=1)
    out = np.zeros(len(o), bool)
    for cand, ok in ((ix, ty == 0), (kern, np.ones(len(o), bool))):
        oc = o - c[cand]
        along = (oc * d).sum(1) / np.linalg.norm(d, axis=1)
        oc2 = (oc * oc).sum(1)
        gap = np.abs(r2[cand] - (oc2 - along * along))
        out |= ok & (gap <= EDGE_ULPS * 2.0 ** -24 * oc2)
    return out


def compare(name, scene, tab, o, d, out, ref, ty, ix, alive) -> float:
    """Hold the kernel's outputs to the plain version's with the
    tolerances of tests/test_torch_bounce.py. A lane on a decision edge
    may differ: an interaction flip, or a ray that grazes a sphere's
    silhouette (``grazes``), where the two versions' float32 roundings
    (the kernel contracts to FMAs) can pick another winner or flip the
    front face. Such lanes may make up at most 1 - INTER_AGREE of the
    alive lanes; every other lane must be within tolerance. Returns the
    largest absolute difference over the float outputs of the lanes held
    to the tolerance (edge lanes, counted apart, left out)."""
    out = [x.cpu().numpy() for x in out]
    ref = [x.cpu().numpy() for x in ref]
    alive = alive.cpu().numpy()
    ty, ix = ty.cpu().numpy(), ix.cpu().numpy()
    agree = (out[0] == ref[0]) & alive
    p_tol = P_TOL_REL * float(scene.scale)
    no, nd, att, emit, p, n = out[1:]
    rno, rnd, ratt, remit, rp, rn = ref[1:]

    def off(a, b, slack=0.0):
        return (np.abs(a - b) > ATOL + RTOL * np.abs(b) + slack).any(0)

    bad_p = agree & (np.abs(p - rp) > p_tol).any(0)
    bad_no = agree & (np.abs(no - rno) > p_tol).any(0)
    colour = agree & (off(att, ratt) | off(emit, remit))
    checker_edge = (np.abs(np.sin(10.0 * rp.astype(np.float64))).min(0)
                    < 10 * p_tol)
    bad_colour = colour & ~checker_edge
    radius = tab.sph[:, 3].sqrt().cpu().numpy()
    r_win = (np.where(ty == 0, radius[np.clip(ix, 0, len(radius) - 1)],
                      np.inf) if len(radius) else np.full(ty.shape, np.inf))
    dp = np.abs(p - rp).max(0) / r_win
    same = agree & ~colour
    bad_n = same & off(n, rn, 2.0 * dp)
    bad_nd = same & off(nd, rnd, 8.0 * dp)
    beyond = bad_p | bad_no | bad_colour | bad_n | bad_nd
    lanes = np.where(beyond)[0]
    graze = np.zeros_like(beyond)
    graze[lanes] = grazes(tab, o.cpu().numpy()[:, lanes],
                          d.cpu().numpy()[:, lanes], p[:, lanes], ty[lanes],
                          ix[lanes])
    flips = int((alive & ~agree).sum())
    edge_share = (flips + int(graze.sum())) / max(int(alive.sum()), 1)
    held = agree & ~beyond & ~colour
    err = max(float(np.abs(a[:, held] - b[:, held]).max(initial=0.0))
              for a, b in zip(out[1:], ref[1:]))
    log(f"  {name}: lanes {alive.size}, alive {int(alive.sum())}; "
        f"inter flips {flips}; beyond tolerance: p {int(bad_p.sum())}, "
        f"no {int(bad_no.sum())}, att/emit {int(bad_colour.sum())}, "
        f"n {int(bad_n.sum())}, nd {int(bad_nd.sum())}, of which on a "
        f"grazing edge {int(graze.sum())}; edge share {edge_share:.3g}; "
        f"max |diff| elsewhere {err:.3g}")
    if (beyond & ~graze).any() or edge_share > 1.0 - INTER_AGREE:
        raise AssertionError(f"bounce kernel disagrees with the plain "
                             f"version on {name}")
    if len(np.unique(out[0][alive])) < 2:
        raise AssertionError(f"{name}: the case exercises one interaction")
    return err


def cuda_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory rate."""
    ops_ms, bytes_ms = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    log(f"  bound: {flops:.6g} FP32 operations = {ops_ms:.6f} ms, "
        f"{nbytes:.6g} bytes = {bytes_ms:.6f} ms")
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def sweep_bound(tab, alive, ray_bytes: int, extra_tables=()) -> dict:
    """``bound`` of one sweep: every alive lane tests every primitive;
    ``ray_bytes`` per lane read and written, each table read once."""
    lanes = int(alive.sum())
    flops = lanes * (tab.sph.shape[0] * SPH_FLOPS
                     + tab.rect.shape[0] * RECT_FLOPS
                     + tab.tri.shape[0] * TRI_FLOPS)
    tables = (tab.sph, tab.rect, tab.tri) + tuple(extra_tables)
    nbytes = (alive.numel() * ray_bytes
              + sum(x.numel() * x.element_size() for x in tables))
    return bound(flops, nbytes)


def check_kernel() -> dict:
    from raytracer_tpu_torch.ops import fused_bounce as fb
    dev = torch.device(DEV)
    log("kernel against its plain version on the card:")
    for seed, name in enumerate(("cornell_mesh", "scene_500",
                                 "three_spheres")):
        scene = load(name, 64 / 48)
        tab = fb.pack_tables(scene.to(dev))
        o, d, alive, uni = make_rays(scene, seed, N_SMALL, 64, 48, 0.5, dev)
        out = fb.bounce_tables(tab, o, d, T_MIN, alive, uni)
        torch.cuda.synchronize()
        ref, ty, ix = plain_bounce(tab, o, d, alive, uni)
        compare(f"{name} {N_SMALL} rays", scene, tab, o, d, out, ref, ty, ix,
                alive)

    # the main path's width: every lane a camera ray, then bounce 2
    scene = load("scene_500", WIDTH / HEIGHT)
    tab = fb.pack_tables(scene.to(dev))
    n = WIDTH * HEIGHT
    o, d, alive, uni = make_rays(scene, 7, n, WIDTH, HEIGHT, 1.0, dev)
    err = 0.0
    for bounce in (1, 2):
        out = fb.bounce_tables(tab, o, d, T_MIN, alive, uni)
        torch.cuda.synchronize()
        ref, ty, ix = plain_bounce(tab, o, d, alive, uni)
        err = max(err, compare(f"scene_500 {n} lanes, bounce {bounce}",
                               scene, tab, o, d, out, ref, ty, ix, alive))
        if bounce == 1:
            timing_in = (o, d, alive, uni)
            alive = alive & (out[0] != 2)        # INTER_ABSORB retires
            o, d = out[1].contiguous(), out[2].contiguous()
            gen = torch.Generator(device=dev).manual_seed(8)
            uni = torch.cat([torch.rand((3, n), generator=gen, device=dev),
                             uni[3:]], 0)

    o, d, alive, uni = timing_in
    ms = cuda_ms(lambda: fb.bounce_tables(tab, o, d, T_MIN, alive, uni))
    plain_ms = cuda_ms(lambda: fb.bounce_fused_plain(tab, o, d, T_MIN, alive,
                                                     uni))
    log(f"bounce at {n} camera rays x {tab.sph.shape[0]} spheres: kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of 10 CUDA-event "
        "timings)")
    # per lane: o, d, uni, alive in; six (3,) rows and inter out
    b = sweep_bound(tab, alive, 24 + 16 + 1 + 72 + 4,
                    (tab.sph_mat, tab.rect_mat, tab.tri_mat, tab.tri_nrm,
                     tab.mat))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None}


# ------------------------------------------------------------------ phase 4

def photon_case(seed, n_ph=3000, n_pts=300):
    """tests/test_pallas_photon.py::make, in float32."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n_ph, 3))
    power = rng.uniform(0, 2, (n_ph, 3))
    norm = rng.normal(size=(n_ph, 3))
    norm /= np.linalg.norm(norm, axis=1, keepdims=True)
    valid = rng.random(n_ph) < 0.8
    points = rng.uniform(-1, 1, (n_pts, 3))
    radius = rng.uniform(0.05, 0.3, n_pts)
    return [torch.from_numpy(np.asarray(x, np.float32 if x.dtype != bool
                                        else bool))
            for x in (pos, power, norm, valid, points, radius)]


def random_query_inputs(dev):
    """The four cases of tests/test_pallas_photon.py as (name, planes,
    points, r2, cap2) on the card: seed 2 queries the cell-sorted grid,
    seed 3 has no valid photon, seed 1 has radius 0.9."""
    from raytracer_tpu_torch.ops import photon_grid as pg
    from raytracer_tpu_torch.ops import photon_query as pq
    out = []
    for seed in range(4):
        if seed == 1:
            pos, power, norm, valid, pts, _ = photon_case(1, 2000, 100)
            radius, cap = torch.full((100,), 0.9), 0.9
        elif seed == 3:
            pos, power, norm, valid, pts, radius = photon_case(3, n_ph=500)
            valid, cap = torch.zeros(500, dtype=torch.bool), 0.3
        else:
            pos, power, norm, valid, pts, radius = photon_case(seed)
            cap = 0.35 if seed == 0 else 0.3
        pos, power, norm, valid, pts, radius = (
            x.to(dev) for x in (pos, power, norm, valid, pts, radius))
        if seed == 2:
            g = pg.build_grid(pos, power, norm, valid,
                              torch.full((3,), -1.2, device=dev),
                              torch.full((3,), 1.2, device=dev), (8, 8, 8))
            valid = torch.arange(pos.shape[0], device=dev) < g.n_valid
            pos, power, norm = g.pos, g.power, g.norm
        planes = pq._pack_photons(pos, power, norm, valid)
        cap2 = torch.full_like(radius, cap * cap)
        out.append((f"random case {seed}", planes, pts, radius * radius,
                    cap2))
    return out


def cornell_query_inputs(dev):
    """The inputs the SPPM main path gives the query kernel in the first
    iteration of a Cornell render at 800x800 / 500,000 photons (global and
    caustic map), captured from ``query_planes`` during one
    ``sppm_iteration``."""
    from raytracer_tpu_torch.models import sppm
    from raytracer_tpu_torch.ops import fused_bounce as fb
    from raytracer_tpu_torch.ops import photon_query as pq
    scene = load("cornell_mesh", 1.0).to(dev)
    cfg = sppm_config(SPPM_SPP)
    captured = []
    real = pq.query_planes

    def capture(planes, points, r2, cap2):
        captured.append((planes, points, r2, cap2))
        return real(planes, points, r2, cap2)

    pq.query_planes = capture
    try:
        sppm.sppm_iteration(scene, fb.pack_tables(scene),
                            sppm.init_state(SPPM_W * SPPM_H, dev), 0,
                            **sppm.iteration_kwargs(scene, cfg))
    finally:
        pq.query_planes = real
    torch.cuda.synchronize()
    if len(captured) != 2:
        raise AssertionError(f"one iteration made {len(captured)} queries")
    return [(f"cornell {name} map", *args)
            for name, args in zip(("global", "caustic"), captured)]


def live_pairs(planes, points, r2, cap2) -> tuple:
    """(live (tile, chunk) pairs, tiles, chunks below n_live): the kernel's
    cull, per TILE points against every chunk below n_live, in plain
    PyTorch. The ragged last tile is padded with copies of the last point,
    which leaves its box and reach as they are."""
    from raytracer_tpu_torch.ops import photon_query as pq
    pad = -points.shape[0] % pq.TILE
    tp = torch.cat([points, points[-1:].expand(pad, 3)]).reshape(
        -1, pq.TILE, 3)
    reach = torch.maximum(r2, cap2)
    reach2 = torch.cat([reach, reach[-1:].expand(pad)]).reshape(
        -1, pq.TILE).amax(1)
    lo, hi = tp.amin(1), tp.amax(1)
    k_live = -(-int(planes.n_live[0]) // pq.CHUNK)
    clo, chi = planes.cull[0:3, :k_live], planes.cull[3:6, :k_live]
    g = torch.clamp(torch.maximum(clo[None] - hi[:, :, None],
                                  lo[:, :, None] - chi[None]), min=0.0)
    g2 = g * g
    near = ((g2[:, 0] + g2[:, 1]) + g2[:, 2]) <= reach2[:, None]
    return int(near.sum()), tp.shape[0], k_live


def compare_query(name, out, ref) -> float:
    """Counts bit-equal; flux within Q_RTOL/Q_ATOL. Returns the largest
    absolute flux difference."""
    err = 0.0
    for c in ("count_r", "count_cap"):
        a, b = getattr(out, c), getattr(ref, c)
        if not torch.equal(a, b):
            raise AssertionError(
                f"{name}: {c} differs on {int((a != b).sum())} points")
    for c in ("flux_r", "flux_cap"):
        a, b = getattr(out, c).double(), getattr(ref, c).double()
        diff = (a - b).abs()
        lim = Q_RTOL * b.abs() + Q_ATOL * b.abs().max().clamp(min=1e-30)
        if (diff > lim).any():
            raise AssertionError(f"{name}: {c} beyond tolerance on "
                                 f"{int((diff > lim).any(1).sum())} points")
        err = max(err, float(diff.max()))
        rel = float((diff / b.abs().clamp(min=1e-30)).max())
        log(f"  {name} {c}: max |diff| {float(diff.max()):.6g}, max rel "
            f"{rel:.3g}")
    return err


def check_query() -> dict:
    from raytracer_tpu_torch.ops import photon_query as pq
    dev = torch.device(DEV)
    log("photon query kernel against its plain version on the card:")
    err = 0.0
    for name, planes, pts, r2, cap2 in random_query_inputs(dev):
        out = pq.query_planes(planes, pts, r2, cap2)
        torch.cuda.synchronize()
        ref = pq.query_photons_plain(planes, pts, r2, cap2)
        err = max(err, compare_query(name, out, ref))
        log(f"  {name}: {pts.shape[0]} points, counts r "
            f"{int(ref.count_r.sum())} cap {int(ref.count_cap.sum())}, "
            "bit-equal")
    stats = {}
    for name, planes, pts, r2, cap2 in cornell_query_inputs(dev):
        n = pts.shape[0]
        live, tiles, k_live = live_pairs(planes, pts, r2, cap2)
        log(f"  {name}: {n} points, {planes.posf.shape[1]} photon slots, "
            f"n_live {int(planes.n_live[0])}; live (tile, chunk) pairs "
            f"{live} of {tiles} tiles x {k_live} chunks "
            f"({live / tiles:.2f} chunks per tile)")
        out = pq.query_planes(planes, pts, r2, cap2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = pq.query_photons_plain(planes, pts, r2, cap2)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = max(err, compare_query(name, out, ref))
        full_ms = cuda_ms(lambda: pq.query_planes(planes, pts, r2, cap2))
        # timings on every PLAIN_STRIDE-th tile of TILE cell-sorted points:
        # the kernel's tiles stay as they are on the whole image
        keep = (torch.arange(n, device=dev) // pq.TILE) % PLAIN_STRIDE == 0
        args = (planes, pts[keep].contiguous(), r2[keep].contiguous(),
                cap2[keep].contiguous())
        ms = cuda_ms(lambda: pq.query_planes(*args))
        plain_ms = cuda_ms(lambda: pq.query_photons_plain(*args))
        log(f"  {name}: counts bit-equal at {n} points (plain once: "
            f"{plain_s:.4f} s); kernel {full_ms:.4f} ms at {n} points; on "
            f"every {PLAIN_STRIDE}th tile ({int(keep.sum())} points) kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of 10 CUDA-event "
            f"timings); counts r {int(out.count_r.sum())} cap "
            f"{int(out.count_cap.sum())}")
        if "global" in name:
            stats = {"ms": ms, "plain_ms": plain_ms,
                     **query_bound(planes, *args[1:]), "library_ms": None}
    return {"max_abs_err": err, **stats}


def query_bound(planes, pts, r2, cap2) -> dict:
    """``bound`` of one query: every (point, photon) pair of a live (tile,
    chunk) pair is tested; photons within either radius are weighted and
    summed. Points, radii and the 8 sums per point once; photon planes,
    payload and cull boxes once."""
    from raytracer_tpu_torch.ops import photon_query as pq
    live, _, _ = live_pairs(planes, pts, r2, cap2)
    res = pq.query_planes(planes, pts, r2, cap2)
    cr, cc = res.count_r.double(), res.count_cap.double()
    flops = (live * pq.TILE * pq.CHUNK * Q_PAIR_FLOPS
             + Q_NEAR_FLOPS * float(torch.maximum(cr, cc).sum())
             + Q_SUM_FLOPS * float((cr + cc).sum()))
    nbytes = pts.shape[0] * (12 + 4 + 4 + 32) + sum(
        x.numel() * x.element_size()
        for x in (planes.posf, planes.payload, planes.cull))
    return bound(flops, nbytes)


# ------------------------------------------------------------------ phase 5

def golden_band(golden: str, img: np.ndarray):
    """tests/test_golden.py::check_against in numpy: gamma-space mean
    within 5%, p95 |diff| < 0.30, mean |diff| < 0.08."""
    ref = np.load(os.path.join(ROOT, "tests", "golden", golden))["img"]
    if img.shape != ref.shape:
        raise AssertionError(f"{golden}: shape {img.shape} != {ref.shape}")
    a = np.sqrt(np.clip(img, 0, None))
    b = np.sqrt(np.clip(ref, 0, None))
    diff = np.abs(a - b)
    p95 = np.percentile(diff, 95)
    log(f"golden {golden}: gamma mean {a.mean():.4f} vs {b.mean():.4f}, "
        f"p95 |diff| {p95:.4f}, mean |diff| {diff.mean():.4f}")
    if not (abs(a.mean() - b.mean()) < 0.05 * max(b.mean(), 1e-6)
            and p95 < 0.30 and diff.mean() < 0.08):
        raise AssertionError(f"render outside the bands of {golden}")


def check_golden():
    from raytracer_tpu_torch.models import path_tracer
    from raytracer_tpu_torch.scene.builtin import three_spheres
    from raytracer_tpu_torch.utils.config import RenderConfig
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=64,
                       spp_chunk=8, max_depth=12)
    img, _ = path_tracer.render(three_spheres(1.0), cfg, 7, device=DEV)
    golden_band("three_spheres_32.npz", img.cpu().numpy())


def sppm_config(spp: int, **sp):
    from raytracer_tpu_torch.utils.config import RenderConfig, SPPMConfig
    kw = dict(n_iterations=SPPM_ITERS, photons_per_iter=SPPM_PHOTONS,
              max_photon_bounces=16, max_camera_bounces=SPPM_DEPTH)
    kw.update(sp)
    return RenderConfig(width=SPPM_W, height=SPPM_H, samples_per_pixel=spp,
                        max_depth=SPPM_DEPTH, sppm=SPPMConfig(**kw))


def check_golden_sppm():
    """tests/test_golden.py::test_golden_cornell_sppm on the card."""
    from raytracer_tpu_torch.models import sppm
    from raytracer_tpu_torch.scene.builtin import cornell_box
    cfg = sppm_config(32, n_iterations=4, photons_per_iter=20000,
                      max_photon_bounces=8, max_camera_bounces=12,
                      max_photons_per_cell=64)
    cfg = cfg.replace(width=32, height=32, spp_chunk=8, max_depth=12)
    img, _, _ = sppm.render(cornell_box(1.0, with_mesh=True), cfg, 7,
                            device=DEV)
    golden_band("cornell_sppm_32.npz", img.cpu().numpy())


# ------------------------------------------------------------------ phase 6

def main_path() -> tuple:
    """scene_500 at 800x600, 32 spp, depth 16, RR off then on. Returns the
    kernel launches of those two renders and the RR-off image mean."""
    from raytracer_tpu_torch.models import path_tracer
    from raytracer_tpu_torch.ops import fused_bounce as fb
    from raytracer_tpu_torch.scene.loader import load_scene
    from raytracer_tpu_torch.utils.config import RenderConfig
    from raytracer_tpu_torch.utils.image import save_render

    scene = load_scene(os.path.join(ROOT, "data", "scene_500.json"),
                       aspect_ratio=WIDTH / HEIGHT)

    def cfg(spp, rr):
        return RenderConfig(width=WIDTH, height=HEIGHT, samples_per_pixel=spp,
                            spp_chunk=1, max_depth=DEPTH, t_min=T_MIN,
                            spawn_eps_rel=EPS_REL, russian_roulette=rr)

    path_tracer.render(scene, cfg(1, True), 0, device=DEV)     # warm
    torch.cuda.synchronize()
    fb.LAUNCHES = 0
    means = {}
    for rr in (False, True):
        before = fb.LAUNCHES
        t0 = time.perf_counter()
        img, rays = path_tracer.render(scene, cfg(SPP, rr), 1, device=DEV)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        host = img.cpu().numpy()
        tag = "rr" if rr else "norr"
        log(f"main path scene_500 {WIDTH}x{HEIGHT} {SPP} spp depth {DEPTH} "
            f"RR {'on' if rr else 'off'}: {rays} rays in {dt:.4f} s = "
            f"{rays / dt / 1e6:.4f} Mrays/s; bounce launches "
            f"{fb.LAUNCHES - before}; image mean {host.mean():.6f}")
        if not (np.isfinite(host).all() and host.mean() > 0):
            raise AssertionError("main-path image is not finite and positive")
        if rays <= 0 or fb.LAUNCHES == before:
            raise AssertionError("main path traced no rays through the kernel")
        save_render(os.path.join(ROOT, "output", f"chip_smoke_{tag}.png"),
                    host)
        means[rr] = float(host.mean())
    return fb.LAUNCHES, means[False]


# ------------------------------------------------------------------ phase 7

def sppm_path() -> dict:
    """Cornell with its mesh at 800x800, 500,000 photons per iteration,
    SPPM_ITERS iterations and a SPPM_SPP-spp gather at depth 50, through
    ``sppm.render``. Returns both kernels' launches in that render."""
    from raytracer_tpu_torch.models import sppm
    from raytracer_tpu_torch.ops import fused_bounce as fb
    from raytracer_tpu_torch.ops import photon_query as pq
    from raytracer_tpu_torch.utils.image import save_render
    scene = load("cornell_mesh", SPPM_W / SPPM_H)
    times = {}
    per_iter = []

    def split(state):
        done = dict(times)
        prev = per_iter[-1][1] if per_iter else {}
        per_iter.append(({k: v - prev.get(k, 0.0) for k, v in done.items()},
                         done))

    torch.cuda.synchronize()
    fb.LAUNCHES = pq.LAUNCHES = 0
    t0 = time.perf_counter()
    img, rays, state = sppm.render(scene, sppm_config(SPPM_SPP), 0,
                                   checkpoint_cb=split, device=DEV,
                                   times=times)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"bounce": fb.LAUNCHES, "photon_query": pq.LAUNCHES}
    for i, (split_s, _) in enumerate(per_iter):
        log(f"sppm iteration {i}: {sum(split_s.values()):.4f} s = "
            + ", ".join(f"{k} {v:.4f}" for k, v in split_s.items()))
    host = img.cpu().numpy()
    log(f"sppm path cornell {SPPM_W}x{SPPM_H}, {SPPM_PHOTONS} photons x "
        f"{SPPM_ITERS} iterations, gather {SPPM_SPP} spp depth {SPPM_DEPTH}:"
        f" {dt:.4f} s; gather {times['gather']:.4f} s, {rays} rays = "
        f"{rays / times['gather'] / 1e6:.4f} Mrays/s; launches {launches}; "
        f"image mean {host.mean():.6f}")
    if not (np.isfinite(host).all() and host.mean() > 0):
        raise AssertionError("SPPM image is not finite and positive")
    if state.iteration != SPPM_ITERS or rays <= 0:
        raise AssertionError("SPPM path did not run its iterations")
    if min(launches.values()) == 0:
        raise AssertionError(f"SPPM path missed a kernel: {launches}")
    save_render(os.path.join(ROOT, "output", "chip_smoke_sppm.png"), host)
    return launches


# ------------------------------------------------------------------ phase 8

def with_tmax(scene, o, d, seed: int):
    """t_max rows as in tests/test_torch_closest.py: +inf on the first half
    of the lanes, 5% to 100% of the scene's size on the second."""
    n = o.shape[1]
    rng = np.random.default_rng(100 + seed)
    t_max = np.full(n, np.inf, np.float32)
    dn = d[:, n // 2:].norm(dim=0).cpu().numpy()
    t_max[n // 2:] = (rng.uniform(0.05, 1.0, n - n // 2)
                      * float(scene.scale) / dn)
    return torch.from_numpy(t_max.astype(np.float32)).to(o.device)


def compare_closest(name, scene, tab, o, d, t_min, t_max, alive, out,
                    ref) -> float:
    """Hold the kernel's winners to the plain version's: type and index on
    >= INTER_AGREE of the alive lanes and visibility (a finite t) too; t
    within 1e-5 * scale / |d| (+ 1e-5 relative) wherever the winners
    agree. Lanes on a decision edge (another winner, or a t beyond the
    tolerance on a ray that grazes a sphere's silhouette, ``grazes``) are
    counted apart and may make up at most 1 - INTER_AGREE of the alive
    lanes. Returns the largest |t| difference over the lanes held to the
    tolerance."""
    t, ty, ix = (x.cpu().numpy() for x in out[:3])
    rt, rty, rix = (x.cpu().numpy() for x in ref[:3])
    alive = alive.cpu().numpy()
    n_alive = max(int(alive.sum()), 1)
    agree = alive & (ty == rty) & (ix == rix)
    vis = alive & (np.isfinite(t) == np.isfinite(rt))
    dn = d.norm(dim=0).cpu().numpy()
    tol = 1e-5 * float(scene.scale) / dn + 1e-5 * np.abs(rt)
    hit = agree & np.isfinite(rt)
    diff = np.zeros_like(rt)
    diff[hit] = np.abs(t[hit] - rt[hit])
    beyond = hit & (diff > tol)
    lanes = np.where(beyond)[0]
    graze = np.zeros_like(beyond)
    if len(lanes):
        oc, dc = o.cpu().numpy()[:, lanes], d.cpu().numpy()[:, lanes]
        graze[lanes] = grazes(tab, oc, dc, oc + t[lanes] * dc, ty[lanes],
                              ix[lanes])
    flips = int((alive & ~agree).sum())
    edge = (flips + int(graze.sum())) / n_alive
    held = hit & ~beyond
    err = float(diff[held].max(initial=0.0))
    dead_ok = bool((ty[~alive] == -1).all() and np.isinf(t[~alive]).all())
    log(f"  {name}: lanes {alive.size}, alive {n_alive}, hits "
        f"{int(np.isfinite(rt[alive]).sum())}; winner flips {flips}, "
        f"visibility agrees on {vis.sum() / n_alive:.6f}; t beyond "
        f"tolerance {int(beyond.sum())}, of which grazing "
        f"{int(graze.sum())}; edge share {edge:.3g}; max |dt| elsewhere "
        f"{err:.3g}")
    if ((beyond & ~graze).any() or edge > 1.0 - INTER_AGREE
            or vis.sum() / n_alive < INTER_AGREE or not dead_ok):
        raise AssertionError(f"closest-hit kernel disagrees with the plain "
                             f"version on {name}")
    return err


def nee_shadow_inputs(dev):
    """The closest-hit inputs of the NEE shadow rays of the first step of
    an 800x600 scene_500 render (one sample, depth 1), captured from
    ``direct_light``'s call."""
    from raytracer_tpu_torch.models import path_tracer
    from raytracer_tpu_torch.ops import closest_hit as ch
    scene = load("scene_500", WIDTH / HEIGHT)
    captured = []
    real = ch.closest_tables

    def capture(*args):
        captured.append(args)
        return real(*args)

    ch.closest_tables = capture
    try:
        path_tracer.render_fn(
            scene, torch.Generator(device=dev).manual_seed(5), width=WIDTH,
            height=HEIGHT, spp=1, spp_chunk=1, max_depth=1, t_min=T_MIN,
            spawn_eps_rel=EPS_REL, nee=True, device=dev)
    finally:
        ch.closest_tables = real
    torch.cuda.synchronize()
    if len(captured) != 1:
        raise AssertionError(f"one NEE step made {len(captured)} casts")
    return scene, captured[0]


def check_closest() -> dict:
    from raytracer_tpu_torch.models import wavefront_soa as wf
    from raytracer_tpu_torch.ops import closest_hit as ch
    from raytracer_tpu_torch.ops import fused_bounce as fb
    dev = torch.device(DEV)
    log("closest-hit kernel against its plain version on the card:")
    err = 0.0
    for seed, name in enumerate(("cornell_mesh", "scene_500",
                                 "three_spheres")):
        scene = load(name, 64 / 48)
        tab = fb.pack_tables(scene.to(dev))
        o, d, alive, _ = make_rays(scene, seed, N_SMALL, 64, 48, 0.5, dev)
        t_max = with_tmax(scene, o, d, seed)
        out = ch.closest_tables(tab, o, d, T_MIN, t_max, alive)
        torch.cuda.synchronize()
        ref = ch.closest_hit_plain(tab, o, d, T_MIN, t_max, alive)
        err = max(err, compare_closest(f"{name} {N_SMALL} rays", scene, tab,
                                       o, d, T_MIN, t_max, alive, out, ref))

    scene = load("scene_500", WIDTH / HEIGHT)
    tab = fb.pack_tables(scene.to(dev))
    n = WIDTH * HEIGHT
    o, d, alive, uni = make_rays(scene, 7, n, WIDTH, HEIGHT, 1.0, dev)
    inf = float("inf")
    out = ch.closest_tables(tab, o, d, T_MIN, inf, alive)
    torch.cuda.synchronize()
    ref = ch.closest_hit_plain(tab, o, d, T_MIN, inf, alive)
    err = max(err, compare_closest(f"scene_500 {n} camera rays", scene, tab,
                                   o, d, T_MIN, inf, alive, out, ref))
    ms = cuda_ms(lambda: ch.closest_tables(tab, o, d, T_MIN, inf, alive))
    plain_ms = cuda_ms(lambda: ch.closest_hit_plain(tab, o, d, T_MIN, inf,
                                                    alive))
    log(f"closest hit at {n} camera rays x {tab.sph.shape[0]} spheres: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 10 "
        "CUDA-event timings)")
    # per lane: o, d, t_min, t_max, alive in; t, type, index, b1, b2 out
    stats = {"ms": ms, "plain_ms": plain_ms,
             **sweep_bound(tab, alive, 24 + 8 + 1 + 20), "library_ms": None}

    sh_scene, (sh_tab, so, sd, s_tmin, s_tmax, s_alive) = \
        nee_shadow_inputs(dev)
    out = ch.closest_tables(sh_tab, so, sd, s_tmin, s_tmax, s_alive)
    torch.cuda.synchronize()
    ref = ch.closest_hit_plain(sh_tab, so, sd, s_tmin, s_tmax, s_alive)
    err = max(err, compare_closest(
        "scene_500 NEE shadow rays of the first step", sh_scene, sh_tab,
        so, sd, s_tmin, s_tmax, s_alive, out, ref))
    sh_ms = cuda_ms(lambda: ch.closest_tables(sh_tab, so, sd, s_tmin, s_tmax,
                                              s_alive))
    log(f"closest hit on {int(s_alive.sum())} shadow rays of {so.shape[1]} "
        f"lanes: kernel {sh_ms:.4f} ms")

    # the unfused bounce (closest-hit kernel + plain attributes and
    # scatter) against the fused kernel, with phase 3's tolerances
    log("unfused bounce against the fused kernel on the card:")
    kw = dict(t_min=T_MIN, spawn_eps=uni[3, 0], scene=scene.to(dev))
    fused = wf.bounce_step(tab, uni, o, d, alive, fused=True, **kw)
    unfused = wf.bounce_step(tab, uni, o, d, alive, fused=False, **kw)
    win = ch.closest_tables(tab, o, d, T_MIN, inf, alive)
    torch.cuda.synchronize()
    compare(f"scene_500 {n} lanes, unfused vs fused", scene, tab, o, d,
            unfused, fused, win.ty, win.ix.long(), alive)
    return {"max_abs_err": err, **stats}


# ------------------------------------------------------------------ phase 9

def check_golden_nee_mis():
    """32x32 three_spheres with NEE and with MIS in the golden bands, the
    brightness held in linear space (tests/test_torch_nee.py::
    check_bands_linear_mean: a variance-reduced render's gamma-space mean
    sits above a noisier golden's), at 256 spp."""
    from raytracer_tpu_torch.models import path_tracer
    from raytracer_tpu_torch.scene.builtin import three_spheres
    from raytracer_tpu_torch.utils.config import RenderConfig
    ref = np.load(os.path.join(ROOT, "tests", "golden",
                               "three_spheres_32.npz"))["img"]
    for kw in (dict(nee=True), dict(mis=True)):
        cfg = RenderConfig(width=32, height=32, samples_per_pixel=256,
                           spp_chunk=8, max_depth=12, **kw)
        img, _ = path_tracer.render(three_spheres(1.0), cfg, 7, device=DEV)
        img = img.cpu().numpy()
        diff = np.abs(np.sqrt(np.clip(img, 0, None)) - np.sqrt(ref))
        p95 = np.percentile(diff, 95)
        log(f"golden three_spheres_32.npz with {kw}: linear mean "
            f"{img.mean():.5f} vs {ref.mean():.5f}, p95 |diff| {p95:.4f}, "
            f"mean |diff| {diff.mean():.4f}")
        if not (abs(img.mean() - ref.mean()) < 0.05 * ref.mean()
                and p95 < 0.30 and diff.mean() < 0.08):
            raise AssertionError(f"{kw} render outside the golden bands")


def check_oracle():
    """tests/test_nee.py's Cornell direct-light oracle: NEE at depth 1,
    16,384 straight-down rays from (278, 120, 278)."""
    from raytracer_tpu_torch.models import path_tracer
    from raytracer_tpu_torch.scene.builtin import cornell_box
    n = 16384
    o = torch.tensor([278.0, 120.0, 278.0], device=DEV).expand(n, 3)
    d = torch.tensor([0.0, -1.0, 0.0], device=DEV).expand(n, 3)
    res = path_tracer.trace_radiance(
        cornell_box(with_mesh=False), o, d,
        torch.Generator(device=DEV).manual_seed(0), max_depth=1, t_min=1e-3,
        spawn_eps=0.05, russian_roulette=False, nee=True)
    mean = float(res.radiance.double().mean())
    log(f"Cornell direct-light oracle: {mean:.6f} against {ORACLE} "
        f"({(mean / ORACLE - 1) * 100:+.3f}%), {res.rays_traced} rays")
    if abs(mean / ORACLE - 1) > ORACLE_TOL:
        raise AssertionError("NEE misses the Cornell direct-light oracle")


def nee_mis_path(pt_mean: float) -> dict:
    """scene_500 at 800x600, 32 spp, depth 16, RR off, with NEE and then
    with MIS, through ``path_tracer.render``. Every kernel count is set to
    0 before each render and read after it. Returns the launches per
    render."""
    from raytracer_tpu_torch.models import path_tracer
    from raytracer_tpu_torch.ops import closest_hit as ch
    from raytracer_tpu_torch.ops import fused_bounce as fb
    from raytracer_tpu_torch.ops import photon_query as pq
    from raytracer_tpu_torch.utils.config import RenderConfig
    from raytracer_tpu_torch.utils.image import save_render
    scene = load("scene_500", WIDTH / HEIGHT)
    launches = {}
    for kw in (dict(nee=True), dict(mis=True)):
        tag = "nee" if kw.get("nee") else "mis"
        cfg = RenderConfig(width=WIDTH, height=HEIGHT, samples_per_pixel=SPP,
                           spp_chunk=1, max_depth=DEPTH, t_min=T_MIN,
                           spawn_eps_rel=EPS_REL, russian_roulette=False,
                           **kw)
        stats = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fb.LAUNCHES = ch.LAUNCHES = pq.LAUNCHES = 0
        t0 = time.perf_counter()
        img, rays = path_tracer.render(scene, cfg, 1, device=DEV,
                                       stats=stats)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[tag] = {"bounce": fb.LAUNCHES, "closest": ch.LAUNCHES,
                         "photon_query": pq.LAUNCHES}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        host = img.cpu().numpy()
        mean = float(host.mean())
        log(f"{tag} path scene_500 {WIDTH}x{HEIGHT} {SPP} spp depth {DEPTH} "
            f"RR off: {rays} rays in {dt:.4f} s = {rays / dt / 1e6:.4f} "
            f"Mrays/s; launches {launches[tag]}; shadow lanes "
            f"{stats['shadow_lanes']}; image mean {mean:.6f} against plain "
            f"PT {pt_mean:.6f} ({(mean / pt_mean - 1) * 100:+.3f}%); peak "
            f"device memory {peak:.3f} GiB")
        if not np.isfinite(host).all() or abs(mean / pt_mean - 1) > MEAN_TOL:
            raise AssertionError(f"{tag} image is not finite or its mean is "
                                 "off plain PT's")
        if rays <= 0 or launches[tag]["bounce"] == 0:
            raise AssertionError(f"{tag} path traced no rays through the "
                                 "bounce kernel")
        if kw.get("nee") and (launches[tag]["closest"] == 0
                              or stats["shadow_lanes"] == 0):
            raise AssertionError("NEE cast no shadow ray through the "
                                 "closest-hit kernel")
        save_render(os.path.join(ROOT, "output", f"chip_smoke_{tag}.png"),
                    host)
    return launches


def main() -> int:
    device = card()
    sys.path.insert(0, ROOT)
    build()
    stats = check_kernel()
    q_stats = check_query()
    check_golden()
    check_golden_sppm()
    pt_launches, pt_mean = main_path()
    sppm_launches = sppm_path()
    c_stats = check_closest()
    check_golden_nee_mis()
    check_oracle()
    nm = nee_mis_path(pt_mean)
    kernels = [
        {"name": "bounce", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/bounce.cu",
         "replaces": "raytracer_tpu/ops/pallas_intersect.py:1731",
         "launches": pt_launches + sppm_launches["bounce"]
         + nm["nee"]["bounce"] + nm["mis"]["bounce"], **stats},
        {"name": "photon_query", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/photon_query.cu",
         "replaces": "raytracer_tpu/ops/pallas_photon.py:82",
         "launches": sppm_launches["photon_query"], **q_stats},
        {"name": "closest", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/closest.cu",
         "replaces": "raytracer_tpu/ops/pallas_intersect.py:1054",
         "launches": nm["nee"]["closest"] + nm["mis"]["closest"],
         **c_stats}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
