"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, render.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
   no CUDA device is an error;
2. build the nine kernels from ``raytracer_tpu_torch/csrc`` (one nvcc
   per source, started together), with ptxas registers and spills;
3. the bounce kernel against its plain PyTorch version on the card, on the
   bounce cases of ``tests/test_torch_bounce.py`` and on scene_500 at the
   main path's width (800x600 = 480,000 lanes: camera rays, then a second
   bounce fed from the first one's outputs), with the kernel's and the
   plain version's times;
4. the photon-query kernel against its plain version: the four cases of
   ``tests/test_pallas_photon.py``, both maps of one Cornell iteration
   at 800x800 points / 500,000 photons whole and at every 10th run of 256
   sorted points, and a heavy tile (one tile of points spread over the
   scene, whose chunks the kernel cuts into several items), counts
   bit-equal, with both times, the live chunks, items and photon groups;
5. a 32x32 render of ``three_spheres`` and a 32x32 Cornell SPPM render on
   the card, held to the Monte-Carlo bands of ``tests/golden/
   three_spheres_32.npz`` and ``cornell_sppm_32.npz``;
6. the path tracer's main path: ``data/scene_500.json`` at 800x600,
   32 spp, depth 16, Russian roulette off and on, through
   ``path_tracer.render``, with the regeneration kernel's launch count;
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
   each image mean within 3% of phase 6's plain-PT mean;
10. the ordered kernels (the near-to-far walk) on ``sphere_field(65536)``
   and ``bunny_field(25)`` at 480,000 camera rays and a second bounce fed
   from the first: winners against the flat kernels (the same on every
   alive lane but the decision-edge lanes counted apart), bounce outputs
   with phase 3's tolerances, the plain walk on every 10th block, the
   captured shadow rays of a field64k NEE step, the times of the ordered
   and flat kernels and of the plain walks on the same 480,000 lanes, the
   chunk bodies run and the bound from the pair tests they ran;
11. the leaf kernel on scene_500 at 480,000 camera rays and a second
   bounce, and on field64k's camera rays with its 2,048 leaves, against
   the flat (or ordered) closest hit and a plain walk
   (``leaf_closest_plain``, or ``leaf_walk_plain`` on field64k), each
   with its time, the leaves folded per ray and, on scene_500's camera
   rays, the bound;
12. the large scenes' renders through ``path_tracer.render``: field64k
   800x600 32 spp depth 16 RR on, the same scene at 8 spp through the
   ordered and the flat route (image means and ray counts within 0.5%),
   bunny_field(25) 8 spp, field64k with NEE 8 spp (the ordered bounce and
   closest hit), and scene_500 with the leaf route RR off (image mean
   within 0.5% of phase 6's), each with its seconds, Mrays/s and kernel
   launches;
13. the regeneration kernels (one loop step in one kernel) against
   ``regen_step_plain`` on a step captured from a scene_500 render (flat)
   and a field64k render (ordered) at 480,000 lanes, with both times and
   the bound; then scene_500 800x600 32 spp depth 16 RR off and on and
   field64k 32 spp RR on through ``path_tracer.render``, the loop's own
   step (the test hook ``wavefront_soa._ONE_KERNEL_STEP``) and the
   one-kernel step in turns: rays and steps equal, image means within
   0.5%;
14. the FMA-rate probe against ``fma_chain_plain`` (f32 and bf16, passes
   16 and 64, the script's weight and ``W_CHECK``), then its time,
   TFLOP/s and bound per (dtype, passes) at
   passes 16, 64, 256 and 1024, and the measured f32 rate beside the data
   sheet's;
15. motion blur: the six motion forms (per-ray shutter times, spheres at
   c + v t) against their plain versions with times drawn in the shutter:
   the flat bounce, closest hit and regen step on ``motion_field(1000)``
   at 480,000 lanes (camera rays, a second bounce, a motion NEE step's
   shadow rays, a captured regen step), the ordered ones on
   ``motion_field(65536)`` (against the flat motion kernels and the plain
   walk), with their times and bounds; then the renders at 800x600, 8
   spp, depth 16, RR on: ``motion_field(1000)`` through the one-kernel
   step and the loop's own step in turns (rays and steps equal, means
   within 0.5%), with MIS (mean within 3% of plain PT's) and with NEE
   (its mean ratio to plain PT's in ``MOTION_NEE_RATIO``: the reference's
   shadow-ray offset is larger than the spheres at this scene's scale),
   with a frozen shutter (the image must differ), and
   ``motion_field(65536)`` through the ordered and the flat route (means
   and rays within 0.5%) and with NEE.

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
# Width of a float32 decision edge, in 2^-24 of the terms that decide it
# (|o - c|^2 for a sphere): each float32 evaluation of disc / a = half_b^2
# / a - c is within ~11 of them (the three-term dot products, the square,
# the subtraction), so two versions differ by at most ~22. On an H100
# 80GB HBM3 (700 W) every excused lane of this script lay within 4.28.
EDGE_ULPS = 24
DEV = "cuda"
KERNELS = ("bounce", "photon_query", "closest", "closest_ordered",
           "bounce_ordered", "leaf", "regen", "regen_ordered", "fma_rate")
# photon query: flux |kernel - plain| <= Q_RTOL |plain| + Q_ATOL max|plain|.
# Both sum non-negative float32 terms, in another order (the kernel one
# photon at a time, the plain version by chunked matmuls); the kernel's
# rsqrtf is within 2 ulp. Counts must be bit-equal.
Q_RTOL, Q_ATOL = 1e-4, 1e-6
PLAIN_STRIDE = 10       # the query's tenth: every 10th run of
TENTH_TILE = 256        # 256 cell-sorted points (the rows of PERF.md)
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
# csrc/sweep.cuh slab test of one box: 6 subtractions and 6 products
BOX_FLOPS = 12
# csrc/sweep.cuh::moved, per moving sphere pair: 3 products and 3 sums
MOTION_FLOPS = 6
# Motion blur (phase 15): bench.py:96-102's motion_field(1000) at 8 spp,
# depth 16, RR on, and motion_field(65536), whose spheres take the walk
MOTION_N, MOTION_BIG, MOTION_SPP = 1000, 65536, 8
# the frozen shutter's image against the full one's: mean |pixel diff|
# above this share of the mean
FROZEN_DIFF = 0.01
# motion_field's NEE image is brighter than its plain PT's in both
# packages: the shadow ray's offset min(1e-4 scale, 0.1 dist) is 3.47 at
# the field's scale of 34,687 (its ground sphere's radius is 1e4) and
# lifts the ray over the spheres (r <= 0.32) that would block it. On the
# CPU the NEE/PT mean ratio is 1.137 in the JAX package (32x24, 32 spp, 2
# seeds) and 1.145 in the port (48x36, 32 spp, 3 seeds); MIS stays within
# MEAN_TOL of plain PT.
MOTION_NEE_RATIO = (1.08, 1.20)
# the regeneration step's lane state per lane, read (o, d, tput, samp, acc
# 60, alive 1, depth and done 8, px and py 8, U 32) and written (o, d,
# tput, samp, acc 60, alive 1, depth and done 8)
REGEN_LANE_BYTES = 109 + 69
RR_EDGE = 1e-6          # |u_RR - p_surv| below this: an RR decision edge
# the captured step of a 3-sample render: still all 480,000 lanes (the
# cascade compacts later), with lanes at depth 3 and lanes past quota
REGEN_STEP, REGEN_SPP = 3, 3
FMA_RTOL = {"float32": 2e-6, "bfloat16": 2.0 ** -6}
FIELD_N, BUNNIES = 65536, 25
LARGE_SPP = 8           # the route check, bunny_field and NEE renders
ROUTE_TOL = 0.005       # image means and ray counts, ordered vs flat route
LEAF_TOL = 0.005        # the leaf render's mean against phase 6's
# A winner flip is excused only where the ray's float64 distance from the
# winner's silhouette is within EDGE_ULPS and within EDGE_R2 of r^2, so
# that no band covers a whole sphere: at field64k distances (|o - c|^2 up
# to 7e4) 24 ulps reach 0.1 against r^2 of 0.014 to 0.1. On the H100 the
# flips lay within 0.304 of r^2 (3.45 ulps on a far, small sphere).
# Glancing hits (the same winner, t or p beyond tolerance) keep the ulp
# band alone: there float32 moves t across the whole disc of a small, far
# sphere.
EDGE_R2 = 0.5
# A kernel against its plain version on the large fields: float32 sphere
# tests at |o - c| ~ 100 flip 0.30% (closest hit) and 0.39% (bounce) of
# the alive lanes on a silhouette (on the H100); the ordered and flat
# kernels share their pair tests and are held to 1 - INTER_AGREE.
PLAIN_EDGE = 0.01


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
        log(f"build: lib{name}.so; " + " | ".join(ptxas(name)))
    log(f"build: {len(KERNELS)} libraries in {dt:.2f} s (in parallel)")
    return dt


def ptxas(name: str) -> list:
    """The register and spill lines of ``name``'s build, each tagged with
    its kernel's form where the kernel is a template on MOTION: "[static]"
    or "[motion]"."""
    from raytracer_tpu_torch.kernels import build as kbuild
    out, form = [], ""
    for ln in kbuild.build_log(name).splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            form = ("[motion] " if "ILb1E" in entry else
                    "[static] " if "ILb0E" in entry else "")
        elif "registers" in ln or "spill" in ln:
            out.append(form + ln.strip())
    return out


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


def image_rays(scene, seed: int, dev):
    """The main path's first wavefront: one camera ray per pixel of the
    800x600 image, in the regen loop's lane order (``block_order``: a
    16x16-pixel block per 256 lanes), jittered; 3% dead lanes; scatter
    uniforms in rows 0-2, spawn epsilon in row 3."""
    from raytracer_tpu_torch.models.wavefront_soa import (
        block_order, camera_rays_soa,
    )
    rng = np.random.default_rng(seed)
    perm, _ = block_order(WIDTH, HEIGHT)
    px = torch.from_numpy((perm % WIDTH).astype(np.float32))
    py = torch.from_numpy((perm // WIDTH).astype(np.float32))
    n = WIDTH * HEIGHT
    o, d = camera_rays_soa(scene.camera, px, py, WIDTH, HEIGHT,
                           torch.from_numpy(rng.random((4, n),
                                                       dtype=np.float32)))
    alive = torch.from_numpy(rng.random(n) > 0.03)
    eps = np.float32(EPS_REL) * scene.scale.numpy()
    uni = torch.from_numpy(np.concatenate(
        [rng.random((3, n), dtype=np.float32),
         np.full((1, n), eps, np.float32)], 0))
    return tuple(x.contiguous().to(dev) for x in (o, d, alive, uni))


def plain_bounce(tab, o, d, alive, uni):
    """The plain version, with the winner's type and index kept for the
    tolerance of normals."""
    from raytracer_tpu_torch.ops import fused_bounce as fb
    hit = fb._closest_plain(tab, o, d, T_MIN, alive)
    return fb._bounce_values(tab, o, d, uni, *hit), hit[1], hit[2]


def sphere_centres(tab, ix, time=None) -> np.ndarray:
    """Per lane, the centre of sphere ``ix`` (float64 of the float32
    value): at the lane's shutter ``time``, c + v t rounded as the kernels
    and the plain versions round it (a float32 product, then a float32
    sum), where the tables move; else the static centre."""
    c = tab.sph[:, :3].cpu().numpy()[ix]
    if time is None or tab.sph_vel is None:
        return c.astype(np.float64)
    v = tab.sph_vel[:, :3].cpu().numpy()[ix]
    t = np.asarray(time, np.float32).reshape(-1, *([1] * (v.ndim - 1)))
    return (c + v * t).astype(np.float64)


def grazes(tab, o, d, p, ty, ix, ty2=None, ix2=None, cap=float("inf"),
           time=None, t_lo=T_MIN, t_hi=float("inf")):
    """Per lane: is the ray on a float32 decision edge of a winner of one
    of the two versions (``ty``/``ix``, and ``ty2``/``ix2`` if given)?
    Spheres: the ray grazes the silhouette of such a sphere, or of the
    sphere whose surface holds the kernel's hit point ``p``; in float64,
    disc / a = r^2 - perp^2 (perp the ray's distance from the centre) lies
    within EDGE_ULPS * 2^-24 of |o - c|^2, the term whose rounding decides
    the float32 test, and within ``cap`` of r^2. Triangles
    (``tri_edges``): a barycentric coordinate within EDGE_ULPS * 2^-24 of
    its terms' magnitude of 0, or of the far edge, or the ray that close
    to tangent to the interpolated normal. Returns (on_edge, ulps, share,
    why) per lane: the nearest edge's float64 distance in those units
    ("ulps"), as a share of r^2 (0 for a triangle), and which edge it
    is. ``time`` (per lane, motion blur): the spheres stand at their
    centres at the lane's shutter time (``sphere_centres``). A sphere's
    other edge: a root of the ray within EDGE_ULPS of the ray's t range
    [``t_lo``, ``t_hi``] (floats or per lane), in the units one 2^-24 of
    |o - c|^2 and of |o - c| |d| move the root by (a ray that starts within
    float32 rounding of a large sphere's surface)."""
    n = len(o.T)
    score = np.full(n, np.inf)
    ulps, share = np.full(n, np.inf), np.zeros(n)
    why = np.full(n, "", object)

    def take(u, s, w):
        sc = np.maximum(u / EDGE_ULPS, s / cap)
        b = sc < score
        score[b], ulps[b], share[b], why[b] = sc[b], u[b], s[b], w[b]

    if not n:
        return score <= 1.0, ulps, share, why
    pairs = [(ty, ix)] + ([(ty2, ix2)] if ty2 is not None else [])
    for a, b in pairs:
        u, w = tri_edges(tab, o, d, a, b)
        take(u, np.zeros(n), w)
    sph = tab.sph.double().cpu().numpy()
    if len(sph):
        c, r2 = sph[:, :3], sph[:, 3]
        o, d, p = (x.T.astype(np.float64) for x in (o, d, p))
        kern = np.empty(n, np.int64)
        step = max(1, 2 ** 22 // (3 * len(c)))     # bounded host memory
        every = np.arange(len(c))[None]
        for i in range(0, n, step):
            cen = (c[None] if time is None
                   else sphere_centres(tab, every, time[i:i + step]))
            q = p[i:i + step, None] - cen
            kern[i:i + step] = np.argmin(np.abs(np.linalg.norm(q, axis=2)
                                                - np.sqrt(r2)[None]), axis=1)
        cands = [(np.clip(b, 0, len(c) - 1), a == 0) for a, b in pairs]
        for cand, ok in cands + [(kern, np.ones(n, bool))]:
            oc = o - sphere_centres(tab, cand, time)
            along = (oc * d).sum(1) / np.linalg.norm(d, axis=1)
            oc2 = (oc * oc).sum(1)
            gap = np.abs(r2[cand] - (oc2 - along * along))
            take(np.where(ok, gap / (2.0 ** -24 * oc2), np.inf),
                 gap / np.maximum(r2[cand], 1e-300),
                 np.full(n, "sphere", object))
            take(np.where(ok, range_ulps(oc, d, r2[cand], t_lo, t_hi),
                          np.inf), np.zeros(n),
                 np.full(n, "sphere t range", object))
    return score <= 1.0, ulps, share, why


def range_ulps(oc, d, r2, t_lo, t_hi) -> np.ndarray:
    """Per lane (float64 rows ``oc`` = o - c and ``d``): the distance of
    the ray's nearer root to either end of its t range, in the units one
    2^-24 of the terms that make the root moves it by: c = |oc|^2 - r^2
    moves a root by dc / (2 sqrt(disc)), half_b by d(half_b) / a; inf
    where the ray misses the sphere."""
    a = (d * d).sum(1)
    hb = (oc * d).sum(1)
    oc2 = (oc * oc).sum(1)
    disc = hb * hb - a * (oc2 - r2)
    sq = np.sqrt(np.maximum(disc, 0.0))
    unit = 2.0 ** -24 * (oc2 / (2.0 * np.maximum(sq, 1e-300))
                         + np.sqrt(oc2 * a) / a)
    dist = np.full(len(a), np.inf)
    for root in ((-hb - sq) / a, (-hb + sq) / a):
        for bound in (t_lo, t_hi):
            with np.errstate(invalid="ignore"):
                gap = np.abs(root - bound)
            dist = np.minimum(dist, np.where(np.isfinite(gap), gap, np.inf))
    return np.where(disc >= 0.0, dist / unit, np.inf)


def lane_rows(x, lanes) -> np.ndarray:
    """A float or an (N,) tensor as a numpy row on ``lanes``."""
    if torch.is_tensor(x):
        return x.cpu().numpy()[lanes]
    return np.full(len(lanes), float(x))


def log_lanes(name, lanes, **rows):
    """Log up to three failing lanes with their rows (numpy, per lane on
    the last axis)."""
    for i in lanes[:3]:
        log(f"  {name}: failing lane {i}: " + "; ".join(
            f"{k} {np.array2string(np.asarray(v)[..., i], precision=8)}"
            for k, v in rows.items()))


def edge_note(on, ulps, share, why) -> str:
    """The float64 margins of the lanes excused as on an edge."""
    if not on.any():
        return "none on an edge"
    u, s, w = ulps[on], share[on], why[on]
    kinds = {k: int((w == k).sum()) for k in np.unique(w)}
    deep = np.argsort(-u)[:3]
    return (f"{int(on.sum())} on an edge {kinds}, up to {u.max():.3g} ulps "
            f"and {s.max():.3g} of r^2; deepest "
            + ", ".join(f"{w[i]} {u[i]:.3g} ulps {s[i]:.3g} r^2"
                        for i in deep))


def tri_edges(tab, o, d, ty, ix) -> tuple:
    """Per lane whose winner ``ty``/``ix`` is a triangle: how many float32
    ulps (of the magnitude of the terms that make them,
    csrc/sweep.cuh::tri_t) lie between the ray's float64 barycentrics and
    an edge of the triangle, or between the ray and tangent to the
    interpolated normal? Within EDGE_ULPS the float32 inside test, or the
    front face, may go either way. Returns (ulps, which edge), inf where
    the winner is not a triangle."""
    out = np.full(len(o.T), np.inf)
    why = np.full(len(o.T), "", object)
    lanes = np.where(ty == 2)[0]
    if not len(lanes) or not tab.tri.shape[0]:
        return out, why
    q = tab.tri.double().cpu().numpy()[np.clip(ix[lanes], 0,
                                                tab.tri.shape[0] - 1)]
    o, d = o.T[lanes].astype(np.float64), d.T[lanes].astype(np.float64)
    ng, e1, e2, w2, w1 = (q[:, k:k + 3] for k in (0, 3, 6, 9, 12))
    oxd = np.cross(o, d)
    div = np.abs((d * ng).sum(1)) + 1e-300
    b1 = ((oxd * e2).sum(1) - (d * w2).sum(1)) / div
    b2 = ((d * w1).sum(1) - (oxd * e1).sum(1)) / div
    nrm = np.linalg.norm
    # one float32 ulp of each barycentric's terms
    u1 = 2.0 ** -24 * (nrm(oxd, axis=1) * nrm(e2, axis=1)
                       + nrm(d, axis=1) * nrm(w2, axis=1)) / div
    u2 = 2.0 ** -24 * (nrm(oxd, axis=1) * nrm(e1, axis=1)
                       + nrm(d, axis=1) * nrm(w1, axis=1)) / div
    sb1 = np.sign((d * ng).sum(1)) * -1.0      # div's sign
    # the front face: d . n of the interpolated normal, whose float32
    # value carries the barycentrics' rounding times the corner normals'
    # spread
    nn = tab.tri_nrm.double().cpu().numpy()[np.clip(ix[lanes], 0,
                                                    tab.tri.shape[0] - 1)]
    n0, n1, n2 = nn[:, 0:3], nn[:, 3:6], nn[:, 6:9]
    c1, c2 = b1 * sb1, b2 * sb1
    sh = (1.0 - c1 - c2)[:, None] * n0 + c1[:, None] * n1 + c2[:, None] * n2
    spread = np.maximum(nrm(n1 - n0, axis=1), nrm(n2 - n0, axis=1))
    cos = np.abs((d * sh).sum(1)) / (nrm(d, axis=1) * nrm(sh, axis=1)
                                     + 1e-300)
    front = cos / ((u1 + u2) * spread + 2.0 ** -24)
    b1, b2 = np.abs(b1), np.abs(b2)            # either sign of div
    edge = np.minimum(np.minimum(b1 / u1, b2 / u2),
                      np.abs(1.0 - b1 - b2) / (u1 + u2))
    out[lanes] = np.minimum(edge, front)
    why[lanes] = np.where(edge <= front, "tri edge", "tri front")
    return out, why


def on_checker_edge(rp, dp) -> np.ndarray:
    """Per lane: can the checker pick flip between two versions whose hit
    points differ by ``dp`` (per lane) around the plain version's ``rp``
    (3, N)? sin(10 p) changes sign only within 10 dp of a zero, plus the
    float32 rounding of the argument 10 p (half an ulp in each version,
    0.004 at |p| = 9,400) and of sin."""
    arg = 10.0 * rp.astype(np.float64)
    return (np.abs(np.sin(arg)) <= 10.0 * dp + 2.0 ** -23 * np.abs(arg)
            + 1e-6).any(0)


def compare(name, scene, tab, o, d, out, ref, ty, ix, alive,
            max_edge: float = 1.0 - INTER_AGREE, time=None) -> float:
    """Hold the kernel's outputs to the plain version's with the
    tolerances of tests/test_torch_bounce.py. A lane on a decision edge
    may differ: an interaction flip, or a ray that grazes a sphere's
    silhouette (``grazes``), where the two versions' float32 roundings
    (the kernel contracts to FMAs) can pick another winner or flip the
    front face. Such lanes may make up at most ``max_edge`` of the alive
    lanes; every other lane must be within tolerance. Returns the
    largest absolute difference over the float outputs of the lanes held
    to the tolerance (edge lanes, counted apart, left out). ``time``: the
    rays' shutter times (motion blur), for the edges' moved centres."""
    tn = None if time is None else time.cpu().numpy()
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
    checker_edge = on_checker_edge(rp, np.abs(p - rp).max(0))
    bad_colour = colour & ~checker_edge
    by_checker = colour & checker_edge
    radius = tab.sph[:, 3].sqrt().cpu().numpy()
    r_win = (np.where(ty == 0, radius[np.clip(ix, 0, len(radius) - 1)],
                      np.inf) if len(radius) else np.full(ty.shape, np.inf))
    dp = np.abs(p - rp).max(0) / r_win
    # the texture pick moves neither the normal nor the scatter direction
    same = agree
    bad_n = same & off(n, rn, 2.0 * dp)
    # the scatter propagates the normal's own difference (x2 for a mirror,
    # more near grazing refraction): a triangle's interpolated normal
    # inherits its barycentrics' float32 rounding
    dn = np.abs(n - rn).max(0)
    bad_nd = same & off(nd, rnd, 8.0 * np.maximum(dp, dn))
    by_dn = same & off(nd, rnd, 8.0 * dp) & ~bad_nd & ~bad_n
    beyond = bad_p | bad_no | bad_colour | bad_n | bad_nd
    lanes = np.where(beyond)[0]
    graze = np.zeros_like(beyond)
    on, ulps, share, why = grazes(tab, o.cpu().numpy()[:, lanes],
                                  d.cpu().numpy()[:, lanes], p[:, lanes],
                                  ty[lanes], ix[lanes],
                                  time=None if tn is None else tn[lanes])
    graze[lanes] = on
    if by_dn.any():
        dnd = np.abs(nd - rnd).max(0)[by_dn]
        log(f"  {name}: nd held by the normal's own difference on "
            f"{int(by_dn.sum())} lanes: |dn| up to "
            f"{float(dn[by_dn].max()):.3g} (n held to {ATOL:g} + {RTOL:g} "
            f"|n|), |d nd| / |dn| up to {float((dnd / dn[by_dn]).max()):.3g}")
    flips = int((alive & ~agree).sum())
    excused = graze | (by_checker & ~beyond)
    edge_share = (flips + int(excused.sum())) / max(int(alive.sum()), 1)
    held = agree & ~beyond & ~colour
    err = max(float(np.abs(a[:, held] - b[:, held]).max(initial=0.0))
              for a, b in zip(out[1:], ref[1:]))
    log(f"  {name}: lanes {alive.size}, alive {int(alive.sum())}; "
        f"inter flips {flips}; beyond tolerance: p {int(bad_p.sum())}, "
        f"no {int(bad_no.sum())}, att/emit {int(bad_colour.sum())}, "
        f"n {int(bad_n.sum())}, nd {int(bad_nd.sum())}, of which on a "
        f"grazing edge {int(graze.sum())}; att/emit on a checker edge "
        f"{int(by_checker.sum())}; edge share {edge_share:.3g}; "
        f"max |diff| elsewhere {err:.3g}; beyond-tolerance lanes: "
        f"{edge_note(on, ulps, share, why)}")
    if (beyond & ~graze).any() or edge_share > max_edge:
        bad = np.where(beyond & ~graze)[0]
        log_lanes(name, bad, o=o.cpu().numpy(), d=d.cpu().numpy(),
                  time=np.zeros(len(ty)) if tn is None else tn, ty=ty, ix=ix,
                  p=p, p_plain=rp)
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


def sweep_bound(tab, alive, ray_bytes: int, extra_tables=(),
                sph_flops: int = SPH_FLOPS) -> dict:
    """``bound`` of one sweep: every alive lane tests every primitive;
    ``ray_bytes`` per lane read and written, each table read once."""
    lanes = int(alive.sum())
    flops = lanes * (tab.sph.shape[0] * sph_flops
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


def live_pairs(planes, points, r2, cap2, tile: int) -> tuple:
    """(live (tile, chunk) pairs, tiles, chunks below n_live): the chunk
    cull per ``tile`` consecutive points against every chunk below n_live,
    in plain PyTorch (``photon_query.plan_items`` at that tile)."""
    from raytracer_tpu_torch.ops import photon_query as pq
    plan = pq.plan_items(planes, points, r2, cap2, tile)
    return int(plan.count.sum()), plan.lo.shape[0], plan.live.shape[1]


def query_inputs(dev):
    """(name, planes, points, r2, cap2) of phase 4's timed inputs: both
    Cornell maps whole (as the main path launches the kernel), each at
    every PLAIN_STRIDE-th run of TENTH_TILE sorted points, and the heavy
    tile: the global map's tenth with its first TILE points replaced by
    points spread over the whole sorted list, so that tile's box spans
    the scene and passes every chunk, and its chunks are cut into items."""
    from raytracer_tpu_torch.ops import photon_query as pq
    out = []
    for name, planes, pts, r2, cap2 in cornell_query_inputs(dev):
        n = pts.shape[0]
        out.append((name, planes, pts, r2, cap2))
        keep = (torch.arange(n, device=dev) // TENTH_TILE) % PLAIN_STRIDE == 0
        tenth = (planes, pts[keep].contiguous(), r2[keep].contiguous(),
                 cap2[keep].contiguous())
        out.append((f"{name}, tenth", *tenth))
        if "global" in name:
            spread = torch.linspace(0, n - 1, pq.TILE, device=dev).long()
            heavy = [x.clone() for x in tenth[1:]]
            for x, y in zip(heavy, (pts, r2, cap2)):
                x[:pq.TILE] = y[spread]
            out.append((f"{name}, heavy tile", planes, *heavy))
    return out


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
    for name, planes, pts, r2, cap2 in query_inputs(dev):
        n = pts.shape[0]
        chunks, groups = pq.kernel_pairs(planes, pts, r2, cap2)
        old, tiles, k_live = live_pairs(planes, pts, r2, cap2, TENTH_TILE)
        plan = pq.plan_items(planes, pts, r2, cap2)
        log(f"  {name}: {n} points, {planes.posf.shape[1]} photon slots, "
            f"n_live {int(planes.n_live[0])}; live (tile, chunk) pairs "
            f"{old} of {tiles} tiles of {TENTH_TILE} x {k_live} chunks; "
            f"the kernel's: {chunks} (tiles of {pq.TILE}), items "
            f"{int(plan.item0[-1])} of at most {plan.ic} chunks (tile 0: "
            f"{int(plan.count[0])} live chunks, "
            f"{int(plan.item0[1])} items), live (tile, group) pairs "
            f"{groups} ({groups * pq.GROUP / max(chunks * pq.CHUNK, 1):.4f}"
            " of the live chunks' photons)")
        out = pq.query_planes(planes, pts, r2, cap2)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        ref = pq.query_photons_plain(planes, pts, r2, cap2)
        b.record()
        b.synchronize()
        plain_ms = a.elapsed_time(b)
        err = max(err, compare_query(name, out, ref))
        ms = cuda_ms(lambda: pq.query_planes(planes, pts, r2, cap2))
        log(f"  {name}: counts bit-equal; kernel {ms:.4f} ms (median of 10 "
            f"CUDA-event timings), plain {plain_ms:.4f} ms (one call); "
            f"counts r {int(out.count_r.sum())} cap "
            f"{int(out.count_cap.sum())}")
        if name == "cornell global map":
            stats = {"ms": ms, "plain_ms": plain_ms,
                     **query_bound(planes, pts, r2, cap2, groups, out),
                     "library_ms": None}
    return {"max_abs_err": err, **stats}


def query_bound(planes, pts, r2, cap2, groups, res) -> dict:
    """``bound`` of one query at the kernel's culls: every (point, photon)
    pair of a live (tile, group) pair is tested; photons within either
    radius are weighted and summed. Points, radii and the 8 sums per
    point once; photon planes, payload and the boxes once."""
    from raytracer_tpu_torch.ops import photon_query as pq
    cr, cc = res.count_r.double(), res.count_cap.double()
    flops = (groups * pq.TILE * pq.GROUP * Q_PAIR_FLOPS
             + Q_NEAR_FLOPS * float(torch.maximum(cr, cc).sum())
             + Q_SUM_FLOPS * float((cr + cc).sum()))
    nbytes = pts.shape[0] * (12 + 4 + 4 + 32) + sum(
        x.numel() * x.element_size()
        for x in (planes.posf, planes.payload, planes.cull, planes.gcull))
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
    """scene_500 at 800x600, 32 spp, depth 16, RR off then on: each step
    one launch of the regeneration kernel. Returns its launches in those
    two renders and the RR-off image mean."""
    from raytracer_tpu_torch.models import path_tracer
    from raytracer_tpu_torch.ops import regen
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
    zero_counts()
    means = {}
    for rr in (False, True):
        before = regen.LAUNCHES
        t0 = time.perf_counter()
        img, rays = path_tracer.render(scene, cfg(SPP, rr), 1, device=DEV)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        host = img.cpu().numpy()
        tag = "rr" if rr else "norr"
        log(f"main path scene_500 {WIDTH}x{HEIGHT} {SPP} spp depth {DEPTH} "
            f"RR {'on' if rr else 'off'}: {rays} rays in {dt:.4f} s = "
            f"{rays / dt / 1e6:.4f} Mrays/s; regen launches "
            f"{regen.LAUNCHES - before}; image mean {host.mean():.6f}")
        if not (np.isfinite(host).all() and host.mean() > 0):
            raise AssertionError("main-path image is not finite and positive")
        if rays <= 0 or regen.LAUNCHES == before or counts()["bounce"]:
            raise AssertionError("main path traced no rays through the "
                                 f"regen kernel: {counts()}")
        save_render(os.path.join(ROOT, "output", f"chip_smoke_{tag}.png"),
                    host)
        means[rr] = float(host.mean())
    return regen.LAUNCHES, means[False]


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
                    ref, time=None) -> float:
    """Hold the kernel's winners to the plain version's: type and index on
    >= INTER_AGREE of the alive lanes and visibility (a finite t) too; t
    within 1e-5 * scale / |d| (+ 1e-5 relative) wherever the winners
    agree. Lanes on a decision edge (another winner, or a t beyond the
    tolerance on a ray that grazes a sphere's silhouette, ``grazes``) are
    counted apart and may make up at most 1 - INTER_AGREE of the alive
    lanes. Returns the largest |t| difference over the lanes held to the
    tolerance. ``time``: as for ``compare``."""
    tn = None if time is None else time.cpu().numpy()
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
    oc, dc = o.cpu().numpy()[:, lanes], d.cpu().numpy()[:, lanes]
    on, ulps, share, why = grazes(tab, oc, dc, oc + t[lanes] * dc,
                                  ty[lanes], ix[lanes],
                                  time=None if tn is None else tn[lanes],
                                  t_lo=lane_rows(t_min, lanes),
                                  t_hi=lane_rows(t_max, lanes))
    graze[lanes] = on
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
        f"{err:.3g}; t beyond tolerance: {edge_note(on, ulps, share, why)}")
    if ((beyond & ~graze).any() or edge > 1.0 - INTER_AGREE
            or vis.sum() / n_alive < INTER_AGREE or not dead_ok):
        log_lanes(name, np.where(beyond & ~graze)[0], o=o.cpu().numpy(),
                  d=d.cpu().numpy(),
                  time=np.zeros(len(t)) if tn is None else tn, t=t, t_plain=rt,
                  ty=ty, ix=ix)
        raise AssertionError(f"closest-hit kernel disagrees with the plain "
                             f"version on {name}")
    return err


def shadow_inputs(scene, dev) -> tuple:
    """The closest-hit inputs (arguments, keywords) of the NEE shadow rays
    of the first step of an 800x600 render of ``scene`` (one sample, depth
    1), captured from ``direct_light``'s call."""
    from raytracer_tpu_torch.models import path_tracer
    from raytracer_tpu_torch.ops import closest_hit as ch
    captured = []
    real = ch.closest_tables

    def capture(*args, **kw):
        captured.append((args, kw))
        return real(*args, **kw)

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
    return captured[0]


def nee_shadow_inputs(dev):
    """``shadow_inputs`` of scene_500: (scene, arguments)."""
    scene = load("scene_500", WIDTH / HEIGHT)
    return scene, shadow_inputs(scene, dev)[0]


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


# ----------------------------------------------------------------- phase 10

_SCENES = {}


def large_scene(name: str):
    """sphere_field(65536) or bunny_field(25) at 800x600's aspect, built
    once."""
    from raytracer_tpu_torch.scene import builtin
    if name not in _SCENES:
        t0 = time.perf_counter()
        _SCENES[name] = (builtin.sphere_field(FIELD_N, WIDTH / HEIGHT)
                         if name == "field64k"
                         else builtin.bunny_field(BUNNIES, WIDTH / HEIGHT))
        log(f"scene {name}: built in {time.perf_counter() - t0:.3f} s")
    return _SCENES[name]


def hit_t64(tab, o, d, ty, ix, t_ref, time=None) -> np.ndarray:
    """Per lane: the float64 t at which the ray (``o``, ``d`` (3, N))
    meets primitive (``ty``, ``ix``) of the flat tables (a sphere's root
    nearest ``t_ref``, at the lane's shutter ``time`` if given), NaN where
    it misses or there is no winner."""
    out = np.full(len(t_ref), np.nan)
    o, d = o.T.astype(np.float64), d.T.astype(np.float64)
    for kind, table in ((0, tab.sph), (1, tab.rect), (2, tab.tri)):
        lanes = np.where(ty == kind)[0]
        if not len(lanes):
            continue
        q = table.double().cpu().numpy()[ix[lanes]]
        ol, dl = o[lanes], d[lanes]
        if kind == 0:
            oc = ol - sphere_centres(tab, ix[lanes],
                                     None if time is None else time[lanes])
            a, hb = (dl * dl).sum(1), (oc * dl).sum(1)
            disc = hb * hb - a * ((oc * oc).sum(1) - q[:, 3])
            sq = np.sqrt(np.where(disc >= 0, disc, np.nan))
            r1, r2 = (-hb - sq) / a, (-hb + sq) / a
            tr = t_ref[lanes]
            out[lanes] = np.where(np.abs(r1 - tr) <= np.abs(r2 - tr), r1, r2)
        elif kind == 1:
            axis = q[:, 0].astype(int)
            k = np.arange(len(lanes))
            out[lanes] = (q[:, 1] - ol[k, axis]) / dl[k, axis]
        else:
            ng = q[:, :3]
            out[lanes] = ((ol * ng).sum(1) - q[:, 15]) / -(dl * ng).sum(1)
    return out


def compare_winners(name, scene, tab, o, d, out, ref, alive,
                    max_edge: float = 1.0 - INTER_AGREE,
                    time=None) -> float:
    """Two versions of one closest hit: the same winner (type, scene index)
    on every alive lane but the decision-edge lanes, counted apart: a ray
    on the float32 edge of a winner (``grazes``, a sphere's band capped at
    EDGE_R2 of r^2), or two primitives at one distance (a shared triangle
    edge, touching surfaces: the two t within tolerance, and each winner's
    float64 t within tolerance of its version's t). t within 1e-5 * scale
    / |d| + 1e-5 |t| where the winners agree, but on glancing hits
    (``grazes`` without the cap). The edge lanes may make up at most
    ``max_edge`` of the alive lanes. Returns the largest |t| difference
    over the lanes held to the tolerance. ``time``: as for ``compare``."""
    tn = None if time is None else time.cpu().numpy()
    t, ty, ix = (x.cpu().numpy() for x in out[:3])
    rt, rty, rix = (x.cpu().numpy() for x in ref[:3])
    al = alive.cpu().numpy()
    on, dn = o.cpu().numpy(), d.cpu().numpy()
    same = (ty == rty) & (ix == rix)
    tol = (1e-5 * float(scene.scale) / np.linalg.norm(dn, axis=0)
           + 1e-5 * np.abs(rt))
    both = np.isfinite(t) & np.isfinite(rt)
    diff = np.full(t.shape, np.inf, np.float32)
    diff[both] = np.abs(t[both] - rt[both])
    flips = al & ~same
    tie = flips & (diff <= tol)
    lanes = np.where(tie)[0]
    for ta, tya, ixa in ((t, ty, ix), (rt, rty, rix)):
        t64 = hit_t64(tab, on[:, lanes], dn[:, lanes], tya[lanes],
                      ixa[lanes], ta[lanes],
                      None if tn is None else tn[lanes])
        tie[lanes] &= np.abs(t64 - ta[lanes]) <= tol[lanes]
    beyond = al & same & np.isfinite(rt) & (diff > tol)
    check = (flips & ~tie) | beyond
    graze = np.zeros_like(check)
    n_alive = max(int(al.sum()), 1)
    edge = (int(flips.sum()) + int(beyond.sum())) / n_alive
    notes = []
    for sel, cap, what in ((flips & ~tie, EDGE_R2, "flips"),
                           (beyond, float("inf"), "t beyond tolerance")):
        lanes = np.where(sel)[0]
        if edge > max_edge:                # fails as it is: no margins
            break
        tp = np.where(np.isfinite(t[lanes]), t[lanes], rt[lanes])
        edge_ok, ulps, share, why = grazes(
            tab, on[:, lanes], dn[:, lanes], on[:, lanes] + tp * dn[:, lanes],
            rty[lanes], rix[lanes], ty[lanes], ix[lanes], cap=cap,
            time=None if tn is None else tn[lanes])
        graze[lanes] = edge_ok
        if len(lanes):
            notes.append(f"{what}: {edge_note(edge_ok, ulps, share, why)}")
    held = al & same & np.isfinite(rt) & ~beyond
    err = float(diff[held].max(initial=0.0))
    dead_ok = bool((ty[~al] == -1).all())
    log(f"  {name}: lanes {al.size}, alive {n_alive}, hits "
        f"{int(np.isfinite(rt[al]).sum())}; winner flips {int(flips.sum())}"
        f" (at one distance {int(tie.sum())}), t beyond tolerance "
        f"{int(beyond.sum())}, grazing {int(graze.sum())}; edge share "
        f"{edge:.3g}; max |dt| elsewhere {err:.3g}"
        + "".join(f"; {x}" for x in notes))
    if (check & ~graze).any() or edge > max_edge or not dead_ok:
        raise AssertionError(f"{name}: the two versions disagree")
    return err


def live_per_warp(alive) -> torch.Tensor:
    """Alive lanes per warp of 32 lanes (``ordered.GROUP``), the groups
    whose chunk bodies the ordered kernels count."""
    from raytracer_tpu_torch.ops import ordered
    n = alive.shape[0]
    g = -(-n // ordered.GROUP)
    a = torch.zeros(g * ordered.GROUP, dtype=torch.float64,
                    device=alive.device)
    a[:n] = alive.double()
    return a.reshape(g, ordered.GROUP).sum(1)


def warp_bodies(stats, alive) -> float:
    """Mean chunk bodies per live warp of the kernel's ``stats`` (both
    walks)."""
    return float(stats.double().sum(1)[live_per_warp(alive) > 0].mean())


def walk_bound(tab, stats, alive, ray_bytes: int, extra=(),
               sph_flops: int = SPH_FLOPS) -> tuple:
    """``bound`` of one ordered call from the chunk bodies it ran (the
    kernel's ``stats`` (G, 2), per warp of 32 lanes): every live lane of a
    warp tests every primitive of each chunk the warp runs; flat stages,
    every primitive. Bytes: ray I/O once per lane and each table the
    kernel reads once. Returns (bound, pairs)."""
    live = live_per_warp(alive)
    n_live = float(live.sum())
    st = stats.double()
    pairs = {"sph": n_live * tab.sph.shape[0], "rect": n_live *
             tab.rect.shape[0], "tri": n_live * tab.tri.shape[0]}
    tables = [tab.rect] + list(extra)
    for col, (key, stage, flat) in enumerate((("sph", tab.osph, tab.sph),
                                              ("tri", tab.otri, tab.tri))):
        if stage is None:
            tables.append(flat)
        else:
            pairs[key] = float((st[:, col] * live).sum()) * stage.chunk
            tables += [x for x in stage if x is not None]
    flops = (pairs["sph"] * sph_flops + pairs["rect"] * RECT_FLOPS
             + pairs["tri"] * TRI_FLOPS)
    nbytes = alive.numel() * ray_bytes + sum(
        x.numel() * x.element_size() for x in tables)
    return bound(flops, nbytes), pairs


def field_shadow_inputs(dev):
    """``shadow_inputs`` of field64k: the arguments."""
    return shadow_inputs(large_scene("field64k"), dev)[0]


def check_ordered() -> dict:
    """Phase 10. Returns the rows' numbers for the ordered kernels."""
    from raytracer_tpu_torch.ops import closest_hit as ch
    from raytracer_tpu_torch.ops import fused_bounce as fb
    from raytracer_tpu_torch.ops import ordered
    dev = torch.device(DEV)
    log("ordered kernels against the flat kernels and the plain walk:")
    n = WIDTH * HEIGHT
    inf = float("inf")
    rows = {"closest_ordered": {"max_abs_err": 0.0},
            "bounce_ordered": {"max_abs_err": 0.0}}
    for seed, name in enumerate(("field64k", "bunny_field"), start=20):
        scene = large_scene(name).to(dev)
        tab = fb.pack_tables(scene)
        flat = fb.pack_tables(scene, order=False)
        st = [s for s in (tab.osph, tab.otri) if s is not None][0]
        log(f" {name}: {tab.sph.shape[0]} spheres, {tab.tri.shape[0]} "
            f"triangles; ordered stage of {st.cull.shape[0]} chunks of "
            f"{st.chunk} in {st.scull.shape[0]} superchunks")
        o, d, alive, uni = image_rays(scene.to("cpu"), seed, dev)
        g = -(-n // ordered.GROUP)
        every = (torch.arange(n, device=dev) // ordered.BLOCK) % 10 == 0
        for bounce in (1, 2):
            tag = f"{name} {n} lanes, bounce {bounce}"
            stats = torch.zeros((g, 2), dtype=torch.int32, device=dev)
            win = ch.closest_tables(tab, o, d, T_MIN, inf, alive, stats=stats)
            fwin = ch.closest_tables(flat, o, d, T_MIN, inf, alive)
            out = fb.bounce_tables(tab, o, d, T_MIN, alive, uni)
            fout = fb.bounce_tables(flat, o, d, T_MIN, alive, uni)
            torch.cuda.synchronize()
            compare_winners(f"{tag}: ordered vs flat kernel", scene, flat, o,
                            d, win, fwin, alive)
            compare(f"{tag}: ordered vs flat bounce kernel", scene, flat, o,
                    d, out, fout, fwin.ty, fwin.ix.long(), alive)
            # the plain walk on every 10th block (whole blocks, so its
            # warps are the kernel's)
            sub = [x[..., every].contiguous() for x in (o, d, alive, uni)]
            pstats = torch.zeros((int(every.sum()) // ordered.GROUP, 2),
                                 dtype=torch.int64, device=dev)
            pwin = ch.closest_ordered_plain(tab, sub[0], sub[1], T_MIN, inf,
                                            sub[2], stats=pstats)
            kwin = ch.Closest(*(x[every] for x in win))
            r = rows["closest_ordered"]
            r["max_abs_err"] = max(r["max_abs_err"], compare_winners(
                f"{tag}: ordered kernel vs plain walk, every 10th block",
                scene, flat, sub[0], sub[1], kwin, pwin, sub[2], PLAIN_EDGE))
            pout = fb.bounce_ordered_plain(tab, *sub[:2], T_MIN, sub[2],
                                           sub[3])
            r = rows["bounce_ordered"]
            r["max_abs_err"] = max(r["max_abs_err"], compare(
                f"{tag}: ordered bounce kernel vs plain, every 10th block",
                scene, flat, sub[0], sub[1], [x[..., every] for x in out],
                pout, pwin.ty, pwin.ix.long(), sub[2], PLAIN_EDGE))
            kb = stats[every.reshape(g, ordered.GROUP)[:, 0]].double()
            log(f"  {tag}: chunk bodies per live warp "
                f"{warp_bodies(stats, alive):.3f} of {st.cull.shape[0]}; on "
                f"the 10th blocks kernel {float(kb.sum()):.0f}, plain "
                f"{float(pstats.sum()):.0f}, warps that differ "
                f"{int((kb != pstats.double()).any(1).sum())}")
            if bounce == 1:
                ms = cuda_ms(lambda: ch.closest_tables(tab, o, d, T_MIN, inf,
                                                       alive))
                fms = cuda_ms(lambda: ch.closest_tables(flat, o, d, T_MIN,
                                                        inf, alive))
                bms = cuda_ms(lambda: fb.bounce_tables(tab, o, d, T_MIN,
                                                       alive, uni))
                fbms = cuda_ms(lambda: fb.bounce_tables(flat, o, d, T_MIN,
                                                        alive, uni))
                # the plain walks on the same lanes as the kernels
                pms = cuda_ms(lambda: ch.closest_ordered_plain(
                    tab, o, d, T_MIN, inf, alive), reps=3)
                pbms = cuda_ms(lambda: fb.bounce_ordered_plain(
                    tab, o, d, T_MIN, alive, uni), reps=3)
                log(f"  {tag}: closest hit ordered {ms:.4f} ms, flat {fms:.4f}"
                    f" ms, plain walk {pms:.4f} ms; bounce ordered {bms:.4f} "
                    f"ms, flat {fbms:.4f} ms, plain walk {pbms:.4f} ms (median"
                    " of CUDA-event timings: 10, the plain walks' 3)")
                cb, pairs = walk_bound(tab, stats, alive, 24 + 8 + 1 + 20)
                bb, _ = walk_bound(tab, stats, alive, 24 + 16 + 1 + 72 + 4,
                                   (tab.sph, tab.sph_mat, tab.rect_mat,
                                    tab.tri_mat, tab.tri_nrm, tab.mat))
                log(f"  {tag}: pair tests run {pairs}")
                if name == "field64k":
                    rows["closest_ordered"].update(
                        ms=ms, flat_ms=fms, plain_ms=pms, **cb,
                        library_ms=None)
                    rows["bounce_ordered"].update(
                        ms=bms, flat_ms=fbms, plain_ms=pbms, **bb,
                        library_ms=None)
                alive = alive & (out[0] != 2)        # INTER_ABSORB retires
                o, d = out[1].contiguous(), out[2].contiguous()
                gen = torch.Generator(device=dev).manual_seed(seed)
                uni = torch.cat([torch.rand((3, n), generator=gen,
                                            device=dev), uni[3:]], 0)

    tab = fb.pack_tables(large_scene("field64k").to(dev))
    flat = fb.pack_tables(large_scene("field64k").to(dev), order=False)
    _, so, sd, s_tmin, s_tmax, s_alive = field_shadow_inputs(dev)
    out = ch.closest_tables(tab, so, sd, s_tmin, s_tmax, s_alive)
    ref = ch.closest_tables(flat, so, sd, s_tmin, s_tmax, s_alive)
    torch.cuda.synchronize()
    compare_winners("field64k NEE shadow rays of the first step: ordered "
                    "vs flat kernel", large_scene("field64k"), flat, so, sd,
                    out, ref, s_alive)
    sms = cuda_ms(lambda: ch.closest_tables(tab, so, sd, s_tmin, s_tmax,
                                            s_alive))
    sfms = cuda_ms(lambda: ch.closest_tables(flat, so, sd, s_tmin, s_tmax,
                                             s_alive))
    log(f"  field64k shadow rays ({int(s_alive.sum())} of {so.shape[1]} "
        f"lanes): ordered {sms:.4f} ms, flat {sfms:.4f} ms")
    rows["closest_ordered"]["shadow_ms"] = sms
    rows["closest_ordered"]["shadow_flat_ms"] = sfms
    return rows


# ----------------------------------------------------------------- phase 11

def leaf_scene_500(dev):
    from raytracer_tpu_torch.ops import leaf
    return leaf.with_leaf_tables(load("scene_500", WIDTH / HEIGHT)).to(dev)


def leaf_field(dev):
    """field64k (sphere_field(65536)) with leaf tables: 2,048 leaves."""
    from raytracer_tpu_torch.ops import leaf
    return leaf.with_leaf_tables(large_scene("field64k")).to(dev)


def leaf_inputs(dev) -> list:
    """(label, scene, tables, o, d, alive) of phase 11 and the leaf A/B:
    scene_500's 480,000 camera rays and their second bounce, and
    field64k's camera rays with its leaf tables."""
    from raytracer_tpu_torch.ops import fused_bounce as fb
    out = []
    scene = leaf_scene_500(dev)
    tab = fb.pack_tables(scene)
    o, d, alive, uni = image_rays(scene.to("cpu"), 7, dev)
    out.append(("scene_500 bounce 1", scene, tab, o, d, alive))
    b = fb.bounce_tables(tab, o, d, T_MIN, alive, uni)
    o2, d2, alive2, _ = next_bounce(b, alive, uni, 8)
    out.append(("scene_500 bounce 2", scene, tab, o2, d2, alive2))
    field = leaf_field(dev)
    o, d, alive, _ = image_rays(field.to("cpu"), 20, dev)
    out.append(("field64k bounce 1", field, fb.pack_tables(field), o, d,
                alive))
    return out


def check_leaf() -> dict:
    """Phase 11. Returns the leaf kernel's row numbers (scene_500's
    camera rays)."""
    from raytracer_tpu_torch.ops import closest_hit as ch
    from raytracer_tpu_torch.ops import leaf
    dev = torch.device(DEV)
    log("leaf kernel against the flat closest hit and its plain versions:")
    inf = float("inf")
    row = {"max_abs_err": 0.0}
    for tag, scene, tab, o, d, alive in leaf_inputs(dev):
        lp = tab.leaf
        n = o.shape[1]
        k = lp.sph.shape[0] // lp.box.shape[0]
        log(f"  {tag}: {n} lanes, {int(alive.sum())} alive; "
            f"{lp.box.shape[0]} leaves of {k}, {lp.node.shape[0]} nodes, "
            f"{lp.big.shape[0]} big sphere(s)")
        visits = torch.zeros(n, dtype=torch.int32, device=dev)
        out = leaf.leaf_closest(tab, o, d, T_MIN, inf, alive, visits=visits)
        ref = ch.closest_tables(tab, o, d, T_MIN, inf, alive)
        torch.cuda.synchronize()
        compare_winners(f"{tag}: leaf vs flat kernel", scene, tab, o, d, out,
                        ref, alive)
        # the table-order walk where it is quick, else the kernel's walk
        table_order = lp.box.shape[0] <= 64
        plain = (leaf.leaf_closest_plain if table_order
                 else leaf.leaf_walk_plain)
        pvis = torch.zeros(n, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        pout = plain(tab, o, d, T_MIN, inf, alive, visits=pvis)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        row["max_abs_err"] = max(row["max_abs_err"], compare_winners(
            f"{tag}: leaf kernel vs {plain.__name__}", scene, tab, o, d, out,
            pout, alive, PLAIN_EDGE))
        n_alive = max(int(alive.sum()), 1)
        ms = cuda_ms(lambda: leaf.leaf_closest(tab, o, d, T_MIN, inf, alive))
        fms = cuda_ms(lambda: ch.closest_tables(tab, o, d, T_MIN, inf, alive))
        log(f"  {tag}: leaves folded per alive ray "
            f"{float(visits.sum()) / n_alive:.4f} (kernel), "
            f"{float(pvis.sum()) / n_alive:.4f} ({plain.__name__}); leaf "
            f"kernel {ms:.4f} ms, closest-hit kernel {fms:.4f} ms (medians "
            f"of 10 CUDA-event timings), {plain.__name__} {plain_s:.4f} s "
            "(one call)")
        if tag != "scene_500 bounce 1":
            continue
        pms = cuda_ms(lambda: leaf.leaf_closest_plain(tab, o, d, T_MIN, inf,
                                                      alive), reps=3)
        # the leaves' sphere tests the rays need and the dense stages; the
        # box tests are left out (fewer than the bytes' time here)
        flops = (float(alive.sum()) * (
            lp.big.shape[0] * SPH_FLOPS + tab.rect.shape[0] * RECT_FLOPS
            + tab.tri.shape[0] * TRI_FLOPS)
            + float(visits.sum()) * k * SPH_FLOPS)
        nbytes = n * (24 + 8 + 1 + 20) + sum(
            x.numel() * x.element_size()
            for x in (lp.sph, lp.orig, lp.big, lp.big_orig, lp.nbox,
                      lp.node, tab.rect, tab.tri))
        row.update(ms=ms, flat_ms=fms, plain_ms=pms,
                   **bound(flops, nbytes), library_ms=None)
    return row


# ----------------------------------------------------------------- phase 12

def counts() -> dict:
    from raytracer_tpu_torch.experiments import bf16_rate_bench as probe
    from raytracer_tpu_torch.ops import closest_hit as ch
    from raytracer_tpu_torch.ops import fused_bounce as fb
    from raytracer_tpu_torch.ops import leaf
    from raytracer_tpu_torch.ops import photon_query as pq
    from raytracer_tpu_torch.ops import regen
    out = {"leaf": leaf.LAUNCHES, "photon_query": pq.LAUNCHES,
           "fma_rate": probe.LAUNCHES}
    for name, mod in (("bounce", fb), ("closest", ch), ("regen", regen)):
        out[name] = mod.LAUNCHES
        out[f"{name}_ordered"] = mod.ORDERED_LAUNCHES
        out[f"{name}_motion"] = mod.MOTION_LAUNCHES
        out[f"{name}_ordered_motion"] = mod.ORDERED_MOTION_LAUNCHES
    return out


def zero_counts():
    from raytracer_tpu_torch.experiments import bf16_rate_bench as probe
    from raytracer_tpu_torch.ops import closest_hit as ch
    from raytracer_tpu_torch.ops import fused_bounce as fb
    from raytracer_tpu_torch.ops import leaf
    from raytracer_tpu_torch.ops import photon_query as pq
    from raytracer_tpu_torch.ops import regen
    leaf.LAUNCHES = pq.LAUNCHES = probe.LAUNCHES = 0
    for mod in (fb, ch, regen):
        mod.LAUNCHES = mod.ORDERED_LAUNCHES = 0
        mod.MOTION_LAUNCHES = mod.ORDERED_MOTION_LAUNCHES = 0


def timed_render(tag, scene, dev, *, spp, rr=True, seed=1, tables=None,
                 loop_step=False, stats=None, **kw):
    """One render at 800x600, depth 16, spp_chunk 1, with every kernel
    count set to 0 just before and read just after. Through
    ``path_tracer.render``, or ``render_fn`` when ``tables`` forces a
    route; ``loop_step`` takes the loop's own step where the one-kernel
    step would run (the test hook ``wavefront_soa._ONE_KERNEL_STEP``);
    ``stats`` (a dict) receives the loop's shadow lanes and steps.
    Returns (image on the host, rays, seconds, launches)."""
    from raytracer_tpu_torch.models import path_tracer
    from raytracer_tpu_torch.models import wavefront_soa
    from raytracer_tpu_torch.utils.config import RenderConfig
    from raytracer_tpu_torch.utils.image import save_render
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, samples_per_pixel=spp,
                       spp_chunk=1, max_depth=DEPTH, t_min=T_MIN,
                       spawn_eps_rel=EPS_REL, russian_roulette=rr, **kw)
    stats = {} if stats is None else stats
    torch.cuda.synchronize()
    zero_counts()
    wavefront_soa._ONE_KERNEL_STEP = not loop_step
    t0 = time.perf_counter()
    try:
        if tables is None:
            img, rays = path_tracer.render(scene, cfg, seed, device=dev,
                                           stats=stats)
        else:
            img, rays = path_tracer.render_fn(
                scene, torch.Generator(device=dev).manual_seed(seed),
                width=WIDTH, height=HEIGHT, spp=spp, spp_chunk=1,
                max_depth=DEPTH, t_min=T_MIN, spawn_eps_rel=EPS_REL,
                intersector=cfg.intersector, russian_roulette=rr,
                nee=cfg.nee, mis=cfg.mis, device=dev, tables=tables,
                stats=stats)
        torch.cuda.synchronize()
    finally:
        wavefront_soa._ONE_KERNEL_STEP = True
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in counts().items() if v}
    host = img.cpu().numpy()
    extra = (f"; shadow lanes {stats['shadow_lanes']}; steps "
             f"{stats['steps']}" if "shadow_lanes" in stats else "")
    log(f"render {tag}: {WIDTH}x{HEIGHT} {spp} spp depth {DEPTH} RR "
        f"{'on' if rr else 'off'}: {rays} rays in {dt:.4f} s = "
        f"{rays / dt / 1e6:.4f} Mrays/s; launches {launches}{extra}; image "
        f"mean {host.mean():.6f}")
    if not (np.isfinite(host).all() and host.mean() > 0 and rays > 0):
        raise AssertionError(f"{tag}: image not finite and positive")
    save_render(os.path.join(ROOT, "output", f"chip_smoke_{tag}.png"), host)
    return host, rays, dt, launches


def slice_renders(pt_mean: float) -> dict:
    """Phase 12. Returns the summed launches of the slice's renders."""
    from raytracer_tpu_torch.ops import fused_bounce as fb
    dev = torch.device(DEV)
    field = large_scene("field64k").to(dev)
    total = {}

    def add(launches, *need):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        for k in need:
            if not launches.get(k):
                raise AssertionError(f"the render launched no {k} kernel")

    timed_render("field64k_warm", field, dev, spp=1)
    add(timed_render("field64k", field, dev, spp=SPP)[3], "regen_ordered")
    img_o, rays_o, _, l_o = timed_render("field64k_route_ordered", field,
                                         dev, spp=LARGE_SPP, seed=2,
                                         tables=fb.pack_tables(field))
    img_f, rays_f, _, l_f = timed_render(
        "field64k_route_flat", field, dev, spp=LARGE_SPP, seed=2,
        tables=fb.pack_tables(field, order=False))
    add(l_o, "regen_ordered")
    if l_f.get("regen_ordered") or not l_f.get("regen"):
        raise AssertionError("the forced flat route did not run flat")
    dm = abs(img_o.mean() / img_f.mean() - 1)
    dr = abs(rays_o / rays_f - 1)
    log(f"route check field64k {LARGE_SPP} spp: image means {img_o.mean():.6f}"
        f" (ordered) vs {img_f.mean():.6f} (flat), {dm * 100:.4f}%; rays "
        f"{rays_o} vs {rays_f}, {dr * 100:.4f}%; max |pixel diff| "
        f"{float(np.abs(img_o - img_f).max()):.3g}")
    if dm > ROUTE_TOL or dr > ROUTE_TOL:
        raise AssertionError("ordered and flat routes disagree")
    bunny = large_scene("bunny_field").to(dev)
    add(timed_render("bunny_field", bunny, dev, spp=LARGE_SPP)[3],
        "regen_ordered")
    add(timed_render("field64k_nee", field, dev, spp=LARGE_SPP,
                     nee=True)[3], "bounce_ordered", "closest_ordered")
    img, _, _, l_leaf = timed_render("scene_500_leaf", leaf_scene_500(dev),
                                     dev, spp=SPP, rr=False,
                                     intersector="leaf")
    add(l_leaf, "leaf")
    dl = abs(img.mean() / pt_mean - 1)
    log(f"leaf route scene_500 RR off: image mean {img.mean():.6f} against "
        f"phase 6's {pt_mean:.6f} ({dl * 100:+.4f}%)")
    if not dl <= LEAF_TOL:                 # a NaN mean fails too
        raise AssertionError("the leaf route's image is off phase 6's")
    return total


# ----------------------------------------------------------------- phase 13

LANE_FIELDS = ("o", "d", "tput", "samp", "acc", "alive", "depth", "done")


def lane_fields(lanes) -> tuple:
    """The lane fields a regen step writes: LANE_FIELDS, and the shutter
    time where the lanes carry one."""
    return LANE_FIELDS + (("time",) if lanes.time is not None else ())


def clone_lanes(lanes):
    return lanes._replace(**{k: getattr(lanes, k).clone()
                             for k in lane_fields(lanes)})


def regen_capture(scene, dev):
    """The arguments of step REGEN_STEP of a REGEN_SPP-sample render of
    ``scene`` at 800x600 (RR on), which takes the one-kernel step, the lanes
    cloned: by then lanes respawn, lanes have used up their quota and
    lanes are at depth >= 3."""
    from raytracer_tpu_torch.models import path_tracer
    from raytracer_tpu_torch.ops import regen
    captured = []
    real = regen.regen_step_tables

    def capture(tab, cam, U, eps, lanes, **kw):
        if len(captured) == REGEN_STEP:
            captured.append((tab, cam, U.clone(), eps, clone_lanes(lanes), kw))
        elif len(captured) < REGEN_STEP:
            captured.append(None)
        return real(tab, cam, U, eps, lanes, **kw)

    regen.regen_step_tables = capture
    try:
        path_tracer.render_fn(
            scene, torch.Generator(device=dev).manual_seed(9), width=WIDTH,
            height=HEIGHT, spp=REGEN_SPP, spp_chunk=1, max_depth=DEPTH,
            t_min=T_MIN, spawn_eps_rel=EPS_REL, device=dev)
    finally:
        regen.regen_step_tables = real
    torch.cuda.synchronize()
    if len(captured) <= REGEN_STEP:
        raise AssertionError("the render ended before the captured step")
    return captured[REGEN_STEP]


def kernel_ms(tab, cam, U, eps, lanes, kw, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of one in-place kernel launch,
    each on a fresh copy of the lanes (the copy is not timed)."""
    from raytracer_tpu_torch.ops import regen
    times = []
    for _ in range(reps + 1):
        work = clone_lanes(lanes)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        regen.regen_step_tables(tab, cam, U, eps, work, **kw)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times[1:]))


def compare_regen(name, scene, tab, cam, U, eps, lanes, kw,
                  max_edge: float) -> float:
    """Hold the kernel's step to ``regen_step_plain`` on one captured
    state. Dead lanes: every output equal. Alive lanes: o to the point
    tolerance, d to RTOL/ATOL plus 8 |dp| / r (phase 3's nd), tput, samp and
    acc to RTOL/ATOL, alive, depth, done (and time) equal, except on decision
    edges, counted apart: the bounce's interaction flips (the bounce
    kernel against its plain version on the same rays), a ray grazing a
    winner (``grazes``), a hit point within its own float32 difference of
    a checker edge, or an RR uniform within RR_EDGE of its survival
    probability. Returns the largest
    absolute difference of the float outputs over the lanes held."""
    from raytracer_tpu_torch.ops import closest_hit as ch
    from raytracer_tpu_torch.ops import fused_bounce as fb
    from raytracer_tpu_torch.ops import regen
    kern = regen.regen_step_tables(tab, cam, U, eps, clone_lanes(lanes), **kw)
    plain = regen.regen_step_plain(tab, cam, U, eps, clone_lanes(lanes), **kw)
    n = lanes.o.shape[1]
    tm = lanes.time
    uni = torch.cat([U[:3], torch.full((1, n), eps, device=U.device)], 0)
    kb = fb.bounce_tables(tab, lanes.o, lanes.d, T_MIN, lanes.alive, uni,
                          time=tm)
    hit = fb._closest_plain(tab, lanes.o, lanes.d, T_MIN, lanes.alive,
                            ordered=tab.ordered, time=tm)
    pb = fb._bounce_values(tab, lanes.o, lanes.d, uni, *hit, time=tm)
    win = ch.closest_tables(tab, lanes.o, lanes.d, T_MIN, float("inf"),
                            lanes.alive, time=tm)
    torch.cuda.synchronize()
    host = lambda x: x.cpu().numpy()            # noqa: E731
    fields = lane_fields(lanes)
    K = {k: host(getattr(kern, k)) for k in fields}
    P = {k: host(getattr(plain, k)) for k in fields}
    S = {k: host(getattr(lanes, k)) for k in fields}
    a = S["alive"]
    for k in fields:
        if not np.array_equal(K[k][..., ~a], P[k][..., ~a]):
            raise AssertionError(f"{name}: {k} differs on a dead lane")
        if K[k].dtype == np.float32 and not np.isfinite(K[k]).all():
            raise AssertionError(f"{name}: {k} is not finite")
    flips = a & (host(kb[0]) != host(pb[0]))
    p_tol = P_TOL_REL * float(scene.scale)
    rp, ty, ix = host(pb[5]), host(hit[1]), host(hit[2])
    radius = tab.sph[:, 3].sqrt().cpu().numpy()
    r_win = (np.where(ty == 0, radius[np.clip(ix, 0, len(radius) - 1)],
                      np.inf) if len(radius) else np.full(n, np.inf))
    dp = np.abs(K["o"] - P["o"]).max(0) / r_win

    def off(x, y, slack=0.0):
        return (np.abs(x - y) > ATOL + RTOL * np.abs(y) + slack).any(0)

    by = {"o": (np.abs(K["o"] - P["o"]) > p_tol).any(0),
          "d": off(K["d"], P["d"], 8.0 * dp),
          **{k: off(K[k], P[k]) for k in ("tput", "samp", "acc")},
          **{k: K[k] != P[k] for k in ("alive", "depth", "done", "time")
             if k in fields}}
    beyond = a & np.logical_or.reduce(list(by.values()))
    # the checker edge (on_checker_edge) with dp the two versions'
    # hit-point difference: the bounce kernel's p on the same rays, and
    # where both steps went on, their own new origins (p plus the spawn
    # offset), which may differ from the bounce kernel's by an ulp
    went_on = K["alive"] & (K["depth"] > 0) & P["alive"] & (P["depth"] > 0)
    dp_abs = np.maximum(np.abs(host(kb[5]) - rp).max(0),
                        np.where(went_on, np.abs(K["o"] - P["o"]).max(0), 0.0))
    checker = on_checker_edge(rp, dp_abs)
    tput1 = np.where(a & (host(pb[0]) != 2), S["tput"] * host(pb[3]),
                     S["tput"])
    p_surv = np.clip(tput1.max(0), 0.05, 1.0)
    rr_edge = (kw["rr_on"] & (S["depth"] >= kw["rr_start"])
               & (np.abs(host(U[regen.U_RR]) - p_surv) < RR_EDGE))
    check = beyond & ~flips & ~checker & ~rr_edge
    lanes_ = np.where(check)[0]
    graze = np.zeros_like(check)
    cont_k = K["alive"] & (K["depth"] > 0)      # went on: o is its hit
    pk = np.where(cont_k, K["o"], rp)
    on, ulps, share, why = grazes(
        tab, S["o"][:, lanes_], S["d"][:, lanes_], pk[:, lanes_], ty[lanes_],
        ix[lanes_], host(win.ty)[lanes_], host(win.ix)[lanes_],
        time=None if tm is None else S["time"][lanes_])
    graze[lanes_] = on
    edge = flips | (beyond & (checker | rr_edge | graze))
    held = a & ~beyond
    errs = {k: float(np.abs(K[k][..., held] - P[k][..., held]).max(initial=0))
            for k in ("o", "d", "tput", "samp", "acc")}
    err = max(errs.values())
    respawn = a & (P["done"] > S["done"]) & P["alive"]
    past = S["done"] >= kw["quota"]
    log(f"  {name}: lanes {n}, alive {int(a.sum())}; respawning "
        f"{int(respawn.sum())}, past their quota {int(past.sum())}, "
        f"alive at depth >= 3 {int((a & (S['depth'] >= 3)).sum())}; "
        f"beyond tolerance {int(beyond.sum())} ("
        + ", ".join(f"{k} {int((a & v).sum())}" for k, v in by.items())
        + f"): interaction flips "
        f"{int((beyond & flips).sum())} (of {int(flips.sum())}), checker "
        f"edge {int((beyond & checker).sum())}, RR edge "
        f"{int((beyond & rr_edge).sum())}, grazing {int(graze.sum())}; edge "
        f"share {edge.sum() / max(a.sum(), 1):.3g}; max |diff| elsewhere "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; grazing lanes: {edge_note(on, ulps, share, why)}")
    if (check & ~graze).any() or edge.sum() > max_edge * a.sum():
        log_lanes(name, np.where(check & ~graze)[0], o=S["o"], d=S["d"],
                  time=S.get("time", np.zeros(n)), ty=ty, ix=ix,
                  kernel_ty=host(win.ty), kernel_ix=host(win.ix),
                  o_kernel=K["o"], o_plain=P["o"], p_plain=rp,
                  tput_kernel=K["tput"], tput_plain=P["tput"],
                  **{f"{k}_kernel": K[k] for k in ("alive", "depth", "done")},
                  **{f"{k}_plain": P[k] for k in ("alive", "depth", "done")})
        raise AssertionError(f"{name}: the regen kernel disagrees with "
                             "regen_step_plain")
    if not (respawn.any() and past.any() and (a & (S["depth"] >= 3)).any()):
        raise AssertionError(f"{name}: the captured state misses a case")
    return err


def regen_row(key: str, scene, max_edge: float, ordered: bool) -> dict:
    """One regen kernel against ``regen_step_plain`` on the step captured
    from a render of ``scene`` (``regen_capture``), then its time, the
    plain version's and the bound. A key ending in "motion" needs lanes
    that carry a shutter time (the kernels' motion form). Returns the
    row's numbers."""
    from raytracer_tpu_torch.ops import ordered as ordered_ops
    from raytracer_tpu_torch.ops import regen
    dev = torch.device(DEV)
    tab, cam, U, eps, lanes, kw = regen_capture(scene, dev)
    n = lanes.o.shape[1]
    motion = lanes.time is not None
    if (tab.ordered != ordered or n != WIDTH * HEIGHT
            or motion != key.endswith("motion")):
        raise AssertionError(f"{key}: captured {n} lanes, ordered "
                             f"{tab.ordered}, shutter time {motion}")
    err = compare_regen(f"{key}, step {REGEN_STEP} of a {REGEN_SPP}-sample "
                        "render", scene, tab, cam, U, eps, lanes, kw,
                        max_edge)
    ms = kernel_ms(tab, cam, U, eps, lanes, kw)
    plain_ms = cuda_ms(lambda: regen.regen_step_plain(
        tab, cam, U, eps, lanes, **kw), reps=3)
    extra = (tab.sph_mat, tab.rect_mat, tab.tri_mat, tab.tri_nrm, tab.mat,
             cam) + ((tab.sph_vel,) if motion else ())
    # with motion: the time read and written and U's row 8, 4 bytes each
    lane_bytes = REGEN_LANE_BYTES + (12 if motion else 0)
    sph_flops = SPH_FLOPS + (MOTION_FLOPS if motion else 0)
    if tab.ordered:
        stats = torch.zeros((-(-n // ordered_ops.GROUP), 2),
                            dtype=torch.int32, device=dev)
        regen.regen_step_tables(tab, cam, U, eps, clone_lanes(lanes),
                                stats=stats, **kw)
        b, pairs = walk_bound(tab, stats, lanes.alive, lane_bytes,
                              (tab.sph,) + extra, sph_flops)
        log(f"  {key}: pair tests run {pairs}; chunk bodies per live warp "
            f"{warp_bodies(stats, lanes.alive):.3f}")
    else:
        b = sweep_bound(tab, lanes.alive, lane_bytes, extra, sph_flops)
    log(f"  {key} at {n} lanes ({int(lanes.alive.sum())} alive): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms (median of CUDA-event "
        "timings: 10, the plain version's 3)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None}


def check_regen() -> dict:
    """Phase 13, the kernels. Returns the rows' numbers of ``regen`` and
    ``regen_ordered``."""
    dev = torch.device(DEV)
    log("regen kernels against regen_step_plain on a captured step:")
    return {"regen": regen_row("regen", load("scene_500", WIDTH / HEIGHT)
                               .to(dev), 1.0 - INTER_AGREE, False),
            "regen_ordered": regen_row("regen_ordered",
                                       large_scene("field64k").to(dev),
                                       PLAIN_EDGE, True)}


def regen_renders() -> dict:
    """Phase 13, the renders: scene_500 RR off and on and field64k RR on,
    32 spp, the loop's own step and the one-kernel step in turns (loop,
    one kernel, one kernel, loop). Returns the summed launches of the
    one-kernel renders."""
    dev = torch.device(DEV)
    total = {}
    for tag, scene, rr in (
            ("scene_500", load("scene_500", WIDTH / HEIGHT).to(dev), False),
            ("scene_500", load("scene_500", WIDTH / HEIGHT).to(dev), True),
            ("field64k", large_scene("field64k").to(dev), True)):
        need = "regen_ordered" if tag == "field64k" else "regen"
        runs = []
        for fused in (False, True, True, False):
            st = {}
            name = (f"{tag}_rr{'on' if rr else 'off'}_"
                    f"{'one_kernel' if fused else 'loop'}")
            img, rays, dt, launches = timed_render(
                name, scene, dev, spp=SPP, rr=rr, loop_step=not fused,
                stats=st)
            runs.append((fused, img, rays, st["steps"], dt))
            if fused:
                if not launches.get(need) or launches.get("bounce") \
                        or launches.get("bounce_ordered"):
                    raise AssertionError(f"{name}: launches {launches}")
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
        ref = runs[0]
        secs = {f: [r[4] for r in runs if r[0] == f] for f in (False, True)}
        dm = max(abs(r[1].mean() / ref[1].mean() - 1) for r in runs)
        diff = max(float(np.abs(r[1] - ref[1]).max()) for r in runs)
        log(f"route check {tag} RR {'on' if rr else 'off'} {SPP} spp: loop "
            f"{secs[False]} s, one kernel {secs[True]} s; rays "
            f"{[r[2] for r in runs]}, steps {[r[3] for r in runs]}; image "
            f"means within {dm * 100:.4f}%, max |pixel diff| {diff:.3g}")
        if any((r[2], r[3]) != (ref[2], ref[3]) for r in runs) \
                or not dm <= ROUTE_TOL:
            raise AssertionError(f"{tag}: the one-kernel route differs from "
                                 "the loop's")
    return total


# ----------------------------------------------------------------- phase 14

def check_fma() -> dict:
    """Phase 14: the probe against its plain version, then its run (every
    count set to 0 before it). Returns the f32 passes-1024 row with the
    launches of the run."""
    from raytracer_tpu_torch.experiments import bf16_rate_bench as probe
    dev = torch.device(DEV)
    log("FMA-rate probe against fma_chain_plain:")
    x32, w32 = probe.make_inputs(probe.N_TILES, dev)
    err = 0.0
    cases = [(w, dtype, passes) for w in (probe.W, probe.W_CHECK)
             for dtype in probe.DTYPES for passes in (16, 64)]
    for w_val, dtype, passes in cases:
        x = x32.to(dtype)
        w = torch.full_like(x32, w_val).to(dtype)
        k = probe.fma_chain(x, w, passes).float()
        p = probe.fma_chain_plain(x, w, passes).float()
        rel = float(((k - p).abs() / p.abs()).max())
        exact = float((k == p).double().mean())
        name = str(dtype).removeprefix("torch.")
        log(f"  {name} w {w_val} passes {passes}: max relative difference "
            f"{rel:.3g} (held to {FMA_RTOL[name]:.3g}), {exact:.4f} of the "
            f"{k.numel()} elements equal")
        if not rel <= FMA_RTOL[name]:
            raise AssertionError(f"fma probe {name} w {w_val} passes "
                                 f"{passes} disagrees with its plain version")
        err = max(err, float((k - p).abs().max()))
    torch.cuda.synchronize()
    zero_counts()
    rows = probe.bench(device=dev)
    launches = counts()["fma_rate"]
    for r in rows:
        log(f"  probe {r['dtype']} passes {r['passes']}: {r['ms']:.4f} ms, "
            f"{r['tflops']:.4f} TFLOP/s; bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {r['flops']:.6g} flops, {r['bytes']:.6g} "
            "bytes)")
    top = [r for r in rows if r["dtype"] == "float32"
           and r["passes"] == max(probe.PASSES)][0]
    log(f"  measured f32 FMA rate {top['tflops']:.4f} TFLOP/s against the "
        f"data sheet's {PEAK_FP32 / 1e12:.0f} "
        f"({top['tflops'] * 1e12 / PEAK_FP32 * 100:.2f}%); launches "
        f"{launches}")
    plain_ms = cuda_ms(lambda: probe.fma_chain_plain(x32, w32, top["passes"]),
                       reps=3)
    return {"launches": launches, "max_abs_err": err, "ms": top["ms"],
            "plain_ms": plain_ms, "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None}


# ----------------------------------------------------------------- phase 15

def motion_scene(n: int):
    """motion_field(n) at 800x600's aspect, built once."""
    from raytracer_tpu_torch.scene import builtin
    key = f"motion{n}"
    if key not in _SCENES:
        t0 = time.perf_counter()
        _SCENES[key] = builtin.motion_field(n, WIDTH / HEIGHT)
        log(f"scene {key}: built in {time.perf_counter() - t0:.3f} s")
    return _SCENES[key]


def shutter_times(scene, seed: int, n: int, dev) -> torch.Tensor:
    """(n,) f32 shutter times in [time0, time1] (numpy draws)."""
    rng = np.random.default_rng(300 + seed)
    t0 = np.float32(float(scene.camera.time0))
    t1 = np.float32(float(scene.camera.time1))
    return torch.from_numpy(t0 + rng.random(n, dtype=np.float32)
                            * (t1 - t0)).to(dev)


def next_bounce(out, alive, uni, seed: int):
    """The rays, alive lanes and uniforms of the bounce after ``out``."""
    n = alive.shape[0]
    gen = torch.Generator(device=alive.device).manual_seed(seed)
    uni = torch.cat([torch.rand((3, n), generator=gen, device=alive.device),
                     uni[3:]], 0)
    return (out[1].contiguous(), out[2].contiguous(),
            alive & (out[0] != 2), uni)     # INTER_ABSORB retires


def check_motion_flat() -> dict:
    """Phase 15, the flat motion forms on motion_field(1000) at 480,000
    lanes with per-lane shutter times: the bounce and the closest hit
    against their plain versions on camera rays and a second bounce (and
    the winners against the t = 0 scene's, which must differ), the closest
    hit on a motion NEE step's shadow rays, and the regen step on a
    captured step. Returns the rows' numbers."""
    from raytracer_tpu_torch.ops import closest_hit as ch
    from raytracer_tpu_torch.ops import fused_bounce as fb
    dev = torch.device(DEV)
    log("motion forms (flat) against their plain versions, motion_field"
        f"({MOTION_N}):")
    scene = motion_scene(MOTION_N).to(dev)
    tab = fb.pack_tables(scene)
    if tab.sph_vel is None or tab.ordered:
        raise AssertionError("motion_field did not pack flat moving tables")
    n = WIDTH * HEIGHT
    inf = float("inf")
    o, d, alive, uni = image_rays(scene.to("cpu"), 30, dev)
    tm = shutter_times(scene, 30, n, dev)
    rows = {"bounce_motion": {"max_abs_err": 0.0},
            "closest_motion": {"max_abs_err": 0.0}}
    for bounce in (1, 2):
        tag = f"motion{MOTION_N} {n} lanes, bounce {bounce}"
        out = fb.bounce_tables(tab, o, d, T_MIN, alive, uni, time=tm)
        win = ch.closest_tables(tab, o, d, T_MIN, inf, alive, time=tm)
        still = ch.closest_tables(tab, o, d, T_MIN, inf, alive)
        torch.cuda.synchronize()
        hit = fb._closest_plain(tab, o, d, T_MIN, alive, time=tm)
        ref = fb._bounce_values(tab, o, d, uni, *hit, time=tm)
        r = rows["bounce_motion"]
        r["max_abs_err"] = max(r["max_abs_err"], compare(
            f"{tag}: bounce (motion) vs plain", scene, tab, o, d, out, ref,
            hit[1], hit[2], alive, time=tm))
        pwin = ch.closest_hit_plain(tab, o, d, T_MIN, inf, alive, time=tm)
        r = rows["closest_motion"]
        r["max_abs_err"] = max(r["max_abs_err"], compare_closest(
            f"{tag}: closest hit (motion) vs plain", scene, tab, o, d, T_MIN,
            inf, alive, win, pwin, time=tm))
        moved = int((alive & ((win.ty != still.ty)
                              | (win.ix != still.ix))).sum())
        log(f"  {tag}: winners other than at t = 0 on {moved} lanes")
        if not moved:
            raise AssertionError(f"{tag}: the shutter time moved no winner")
        if bounce == 1:
            ms = cuda_ms(lambda: fb.bounce_tables(tab, o, d, T_MIN, alive,
                                                  uni, time=tm))
            still_ms = cuda_ms(lambda: fb.bounce_tables(tab, o, d, T_MIN,
                                                        alive, uni))
            plain_ms = cuda_ms(lambda: fb.bounce_fused_plain(
                tab, o, d, T_MIN, alive, uni, tm), reps=3)
            cms = cuda_ms(lambda: ch.closest_tables(tab, o, d, T_MIN, inf,
                                                    alive, time=tm))
            cplain = cuda_ms(lambda: ch.closest_hit_plain(
                tab, o, d, T_MIN, inf, alive, time=tm), reps=3)
            log(f"  {tag}: bounce (motion) {ms:.4f} ms, its static form on "
                f"the same rays {still_ms:.4f} ms, plain {plain_ms:.4f} ms; "
                f"closest hit (motion) {cms:.4f} ms, plain {cplain:.4f} ms "
                "(median of CUDA-event timings: 10, the plain versions' 3)")
            flops = SPH_FLOPS + MOTION_FLOPS
            # per lane as the static rows, plus the 4-byte time
            rows["bounce_motion"].update(
                ms=ms, plain_ms=plain_ms, static_ms=still_ms,
                **sweep_bound(tab, alive, 24 + 16 + 1 + 72 + 4 + 4,
                              (tab.sph_mat, tab.rect_mat, tab.tri_mat,
                               tab.tri_nrm, tab.mat, tab.sph_vel), flops),
                library_ms=None)
            rows["closest_motion"].update(
                ms=cms, plain_ms=cplain,
                **sweep_bound(tab, alive, 24 + 8 + 1 + 20 + 4,
                              (tab.sph_vel,), flops), library_ms=None)
            o, d, alive, uni = next_bounce(out, alive, uni, 31)

    args, kw = shadow_inputs(scene, dev)
    sh_tab, so, sd, s_tmin, s_tmax, s_alive = args
    st = kw["time"]
    out = ch.closest_tables(sh_tab, so, sd, s_tmin, s_tmax, s_alive, time=st)
    torch.cuda.synchronize()
    ref = ch.closest_hit_plain(sh_tab, so, sd, s_tmin, s_tmax, s_alive,
                               time=st)
    r = rows["closest_motion"]
    r["max_abs_err"] = max(r["max_abs_err"], compare_closest(
        f"motion{MOTION_N} NEE shadow rays of the first step", scene, sh_tab,
        so, sd, s_tmin, s_tmax, s_alive, out, ref, time=st))
    rows["regen_motion"] = regen_row("regen_motion", scene,
                                     1.0 - INTER_AGREE, False)
    return rows


def check_motion_ordered() -> dict:
    """Phase 15, the ordered motion forms on motion_field(65536) at
    480,000 lanes with per-lane shutter times: the ordered closest hit and
    bounce against the flat motion kernels (every alive lane) and against
    the plain walk (every 10th block), on camera rays and a second bounce,
    and the ordered regen step on a captured step. Returns the rows'
    numbers."""
    from raytracer_tpu_torch.ops import closest_hit as ch
    from raytracer_tpu_torch.ops import fused_bounce as fb
    from raytracer_tpu_torch.ops import ordered
    dev = torch.device(DEV)
    log("motion forms (ordered) against the flat ones and the plain walk, "
        f"motion_field({MOTION_BIG}):")
    scene = motion_scene(MOTION_BIG).to(dev)
    tab = fb.pack_tables(scene)
    flat = fb.pack_tables(scene, order=False)
    st = tab.osph
    if st is None or st.vel is None or flat.sph_vel is None:
        raise AssertionError("motion_field did not pack a moving walk")
    log(f"  {tab.sph.shape[0]} spheres; ordered stage of {st.cull.shape[0]} "
        f"chunks of {st.chunk} in {st.scull.shape[0]} superchunks")
    n = WIDTH * HEIGHT
    inf = float("inf")
    g = -(-n // ordered.GROUP)
    every = (torch.arange(n, device=dev) // ordered.BLOCK) % 10 == 0
    o, d, alive, uni = image_rays(scene.to("cpu"), 40, dev)
    tm = shutter_times(scene, 40, n, dev)
    rows = {"closest_ordered_motion": {"max_abs_err": 0.0},
            "bounce_ordered_motion": {"max_abs_err": 0.0}}
    for bounce in (1, 2):
        tag = f"motion{MOTION_BIG} {n} lanes, bounce {bounce}"
        stats = torch.zeros((g, 2), dtype=torch.int32, device=dev)
        win = ch.closest_tables(tab, o, d, T_MIN, inf, alive, stats=stats,
                                time=tm)
        fwin = ch.closest_tables(flat, o, d, T_MIN, inf, alive, time=tm)
        out = fb.bounce_tables(tab, o, d, T_MIN, alive, uni, time=tm)
        fout = fb.bounce_tables(flat, o, d, T_MIN, alive, uni, time=tm)
        torch.cuda.synchronize()
        compare_winners(f"{tag}: ordered vs flat kernel (motion)", scene,
                        flat, o, d, win, fwin, alive, time=tm)
        compare(f"{tag}: ordered vs flat bounce kernel (motion)", scene,
                flat, o, d, out, fout, fwin.ty, fwin.ix.long(), alive,
                time=tm)
        sub = [x[..., every].contiguous() for x in (o, d, alive, uni, tm)]
        pwin = ch.closest_ordered_plain(tab, *sub[:2], T_MIN, inf, sub[2],
                                        time=sub[4])
        r = rows["closest_ordered_motion"]
        r["max_abs_err"] = max(r["max_abs_err"], compare_winners(
            f"{tag}: ordered kernel (motion) vs plain walk, every 10th "
            "block", scene, flat, sub[0], sub[1],
            ch.Closest(*(x[every] for x in win)), pwin, sub[2], PLAIN_EDGE,
            time=sub[4]))
        pout = fb.bounce_ordered_plain(tab, *sub[:2], T_MIN, sub[2], sub[3],
                                       time=sub[4])
        r = rows["bounce_ordered_motion"]
        r["max_abs_err"] = max(r["max_abs_err"], compare(
            f"{tag}: ordered bounce kernel (motion) vs plain, every 10th "
            "block", scene, flat, sub[0], sub[1],
            [x[..., every] for x in out], pout, pwin.ty, pwin.ix.long(),
            sub[2], PLAIN_EDGE, time=sub[4]))
        log(f"  {tag}: chunk bodies per live warp "
            f"{warp_bodies(stats, alive):.3f} of {st.cull.shape[0]}")
        if bounce == 1:
            ms = cuda_ms(lambda: ch.closest_tables(tab, o, d, T_MIN, inf,
                                                   alive, time=tm))
            fms = cuda_ms(lambda: ch.closest_tables(flat, o, d, T_MIN, inf,
                                                    alive, time=tm))
            bms = cuda_ms(lambda: fb.bounce_tables(tab, o, d, T_MIN, alive,
                                                   uni, time=tm))
            fbms = cuda_ms(lambda: fb.bounce_tables(flat, o, d, T_MIN, alive,
                                                    uni, time=tm))
            pms = cuda_ms(lambda: ch.closest_ordered_plain(
                tab, o, d, T_MIN, inf, alive, time=tm), reps=3)
            pbms = cuda_ms(lambda: fb.bounce_ordered_plain(
                tab, o, d, T_MIN, alive, uni, time=tm), reps=3)
            log(f"  {tag}: closest hit ordered {ms:.4f} ms, flat {fms:.4f} "
                f"ms, plain walk {pms:.4f} ms; bounce ordered {bms:.4f} ms, "
                f"flat {fbms:.4f} ms, plain walk {pbms:.4f} ms (motion forms;"
                " median of CUDA-event timings: 10, the plain walks' 3)")
            flops = SPH_FLOPS + MOTION_FLOPS
            cb, pairs = walk_bound(tab, stats, alive, 24 + 8 + 1 + 20 + 4,
                                   (tab.sph_vel,), flops)
            bb, _ = walk_bound(tab, stats, alive, 24 + 16 + 1 + 72 + 4 + 4,
                               (tab.sph, tab.sph_vel, tab.sph_mat,
                                tab.rect_mat, tab.tri_mat, tab.tri_nrm,
                                tab.mat), flops)
            log(f"  {tag}: pair tests run {pairs}")
            rows["closest_ordered_motion"].update(
                ms=ms, flat_ms=fms, plain_ms=pms, **cb, library_ms=None)
            rows["bounce_ordered_motion"].update(
                ms=bms, flat_ms=fbms, plain_ms=pbms, **bb, library_ms=None)
            o, d, alive, uni = next_bounce(out, alive, uni, 41)
    rows["regen_ordered_motion"] = regen_row("regen_ordered_motion", scene,
                                             PLAIN_EDGE, True)
    return rows


def motion_renders() -> dict:
    """Phase 15, the renders, 800x600, depth 16, RR on (bench.py:82-84,
    99-101): motion_field(1000) at 8 spp through the one-kernel step and
    the loop's own step in turns (rays and steps equal, means within
    ROUTE_TOL), with MIS (mean within MEAN_TOL of plain PT's) and NEE
    (``MOTION_NEE_RATIO``), with its shutter frozen (time1 = time0: the
    image must differ);
    motion_field(65536) at 8 spp through the ordered and the forced flat
    route (means and rays within ROUTE_TOL) and with NEE. Returns the
    summed launches of these renders."""
    from raytracer_tpu_torch.ops import fused_bounce as fb
    dev = torch.device(DEV)
    total = {}

    def add(tag, launches, need, never=()):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if not all(launches.get(k) for k in need) or any(
                launches.get(k) for k in never):
            raise AssertionError(f"{tag}: launches {launches}")

    static = ("bounce", "bounce_ordered", "closest", "closest_ordered",
              "regen", "regen_ordered")
    scene = motion_scene(MOTION_N).to(dev)
    timed_render("motion1k_warm", scene, dev, spp=1)
    runs = []
    for fused in (False, True, True, False):
        st = {}
        tag = f"motion1k_{'one_kernel' if fused else 'loop'}"
        img, rays, dt, launches = timed_render(
            tag, scene, dev, spp=MOTION_SPP, loop_step=not fused, stats=st)
        add(tag, launches, ["regen_motion" if fused else "bounce_motion"],
            static)
        runs.append((fused, img, rays, st["steps"], dt))
    ref = runs[1]
    dm = max(abs(r[1].mean() / ref[1].mean() - 1) for r in runs)
    log(f"route check motion1k {MOTION_SPP} spp: loop "
        f"{[r[4] for r in runs if not r[0]]} s, one kernel "
        f"{[r[4] for r in runs if r[0]]} s; rays {[r[2] for r in runs]}, "
        f"steps {[r[3] for r in runs]}; image means within {dm * 100:.4f}%, "
        f"max |pixel diff| "
        f"{max(float(np.abs(r[1] - ref[1]).max()) for r in runs):.3g}")
    if any((r[2], r[3]) != (ref[2], ref[3]) for r in runs) \
            or not dm <= ROUTE_TOL:
        raise AssertionError("motion1k: the one-kernel route differs from "
                             "the loop's")
    pt = ref[1]
    for kw, need, lo, hi in (
            (dict(nee=True), ["bounce_motion", "closest_motion"],
             *MOTION_NEE_RATIO),
            (dict(mis=True), ["bounce_motion"], 1 - MEAN_TOL, 1 + MEAN_TOL)):
        tag = "motion1k_" + ("nee" if kw.get("nee") else "mis")
        img, _, _, launches = timed_render(tag, scene, dev, spp=MOTION_SPP,
                                           **kw)
        add(tag, launches, need, static)
        ratio = img.mean() / pt.mean()
        log(f"{tag}: image mean {img.mean():.6f} against plain PT "
            f"{pt.mean():.6f}: ratio {ratio:.6f} (held to [{lo:g}, {hi:g}])")
        if not lo <= ratio <= hi:
            raise AssertionError(f"{tag}: image mean off plain PT's")
    cam = scene.camera
    frozen = scene._replace(camera=cam._replace(time1=cam.time0))
    img, _, _, launches = timed_render("motion1k_frozen", frozen, dev,
                                       spp=MOTION_SPP)
    add("motion1k_frozen", launches, ["regen_motion"], static)
    diff = float(np.abs(img - pt).mean())
    log(f"motion1k frozen shutter: mean |pixel diff| against the full "
        f"shutter {diff:.6g} ({diff / pt.mean():.4g} of the mean)")
    if not diff > FROZEN_DIFF * pt.mean():
        raise AssertionError("the frozen shutter renders the full shutter's "
                             "image")

    big = motion_scene(MOTION_BIG).to(dev)
    timed_render("motion64k_warm", big, dev, spp=1)
    img_o, rays_o, _, l_o = timed_render(
        "motion64k_route_ordered", big, dev, spp=MOTION_SPP, seed=2,
        tables=fb.pack_tables(big))
    add("motion64k_route_ordered", l_o, ["regen_ordered_motion"], static)
    img_f, rays_f, _, l_f = timed_render(
        "motion64k_route_flat", big, dev, spp=MOTION_SPP, seed=2,
        tables=fb.pack_tables(big, order=False))
    add("motion64k_route_flat", l_f, ["regen_motion"],
        static + ("regen_ordered_motion",))
    dm = abs(img_o.mean() / img_f.mean() - 1)
    dr = abs(rays_o / rays_f - 1)
    log(f"route check motion64k {MOTION_SPP} spp: image means "
        f"{img_o.mean():.6f} (ordered) vs {img_f.mean():.6f} (flat), "
        f"{dm * 100:.4f}%; rays {rays_o} vs {rays_f}, {dr * 100:.4f}%; max "
        f"|pixel diff| {float(np.abs(img_o - img_f).max()):.3g}")
    if dm > ROUTE_TOL or dr > ROUTE_TOL:
        raise AssertionError("motion64k: ordered and flat routes disagree")
    _, _, _, launches = timed_render("motion64k_nee", big, dev,
                                     spp=MOTION_SPP, nee=True)
    add("motion64k_nee", launches,
        ["bounce_ordered_motion", "closest_ordered_motion"], static)
    return total


def main() -> int:
    device = card()
    sys.path.insert(0, ROOT)
    build()
    stats = check_kernel()
    q_stats = check_query()
    check_golden()
    check_golden_sppm()
    pt_regen, pt_mean = main_path()
    sppm_launches = sppm_path()
    c_stats = check_closest()
    check_golden_nee_mis()
    check_oracle()
    nm = nee_mis_path(pt_mean)
    o_rows = check_ordered()
    l_row = check_leaf()
    sl = slice_renders(pt_mean)
    r_rows = check_regen()
    rl = regen_renders()
    f_row = check_fma()
    m_rows = {**check_motion_flat(), **check_motion_ordered()}
    ml = motion_renders()

    def row(d):
        return {k: v for k, v in d.items()
                if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms")}

    kernels = [
        {"name": "bounce", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/bounce.cu",
         "replaces": "raytracer_tpu/ops/pallas_intersect.py:1731",
         "launches": sppm_launches["bounce"] + nm["nee"]["bounce"]
         + nm["mis"]["bounce"], **stats},
        {"name": "photon_query", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/photon_query.cu",
         "replaces": "raytracer_tpu/ops/pallas_photon.py:82",
         "launches": sppm_launches["photon_query"], **q_stats},
        {"name": "closest", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/closest.cu",
         "replaces": "raytracer_tpu/ops/pallas_intersect.py:1054",
         "launches": nm["nee"]["closest"] + nm["mis"]["closest"],
         **c_stats},
        {"name": "closest_ordered", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/closest_ordered.cu",
         "replaces": "raytracer_tpu/ops/pallas_intersect.py:1068",
         "launches": sl.get("closest_ordered", 0),
         **row(o_rows["closest_ordered"])},
        {"name": "bounce_ordered", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/bounce_ordered.cu",
         "replaces": "raytracer_tpu/ops/pallas_intersect.py:1750",
         "launches": sl.get("bounce_ordered", 0),
         **row(o_rows["bounce_ordered"])},
        {"name": "leaf", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/leaf.cu",
         "replaces": "raytracer_tpu/ops/pallas_bvh.py:475",
         "launches": sl.get("leaf", 0), **row(l_row)},
        {"name": "regen", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/regen.cu",
         "replaces": "raytracer_tpu/ops/pallas_intersect.py:1873",
         "launches": pt_regen + sl.get("regen", 0) + rl.get("regen", 0),
         **row(r_rows["regen"])},
        {"name": "regen_ordered", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/regen_ordered.cu",
         "replaces": "raytracer_tpu/ops/pallas_intersect.py:1906",
         "launches": sl.get("regen_ordered", 0)
         + rl.get("regen_ordered", 0),
         **row(r_rows["regen_ordered"])},
        {"name": "fma_rate", "route": "cuda",
         "source": "raytracer_tpu_torch/csrc/fma_rate.cu",
         "replaces": "experiments/bf16_rate_bench.py:35", **f_row}]
    # the motion forms (has_time=True) of the same TPU kernels
    for name, line in (("bounce", 1731), ("closest", 1054),
                       ("closest_ordered", 1068), ("bounce_ordered", 1750),
                       ("regen", 1873), ("regen_ordered", 1906)):
        key = f"{name}_motion"
        kernels.append(
            {"name": key, "route": "cuda",
             "source": f"raytracer_tpu_torch/csrc/{name}.cu",
             "replaces": f"raytracer_tpu/ops/pallas_intersect.py:{line}",
             "launches": ml.get(key, 0), **row(m_rows[key])})
    if min(k["launches"] for k in kernels) <= 0:
        raise AssertionError("a kernel was launched no time on its path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
