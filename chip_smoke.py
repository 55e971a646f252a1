"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, render.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code non-zero):

1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
   no CUDA device is an error;
2. build the fused-bounce kernel from ``raytracer_tpu_torch/csrc`` (nvcc);
3. the kernel against its plain PyTorch version on the card, on the bounce
   cases of ``tests/test_torch_bounce.py`` and on scene_500 at the main
   path's width (800x600 = 480,000 lanes: camera rays, then a second
   bounce fed from the first one's outputs), with the kernel's and the
   plain version's times;
4. a 32x32 render of ``three_spheres`` on the card held to the Monte-Carlo
   bands of ``tests/golden/three_spheres_32.npz``;
5. the main path: ``data/scene_500.json`` at 800x600, 32 spp, depth 16,
   Russian roulette off and on, through ``path_tracer.render``, with the
   kernel's launch count over those two renders.

It imports no JAX. The line before the last is a JSON object with the
kernel's launches, error and times; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

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
    kbuild.load_library("bounce")
    dt = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in kbuild.build_log("bounce").splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"build: libbounce.so in {dt:.2f} s; " + " | ".join(ptxas))
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


def check_kernel() -> dict:
    from raytracer_tpu_torch.ops import fused_bounce as fb
    dev = torch.device("cuda")
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
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


# ------------------------------------------------------------------ phase 4

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
    img, _ = path_tracer.render(three_spheres(1.0), cfg, 7, device="cuda")
    golden_band("three_spheres_32.npz", img.cpu().numpy())


# ------------------------------------------------------------------ phase 5

def main_path() -> int:
    """scene_500 at 800x600, 32 spp, depth 16, RR off then on. Returns the
    kernel launches of those two renders."""
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

    path_tracer.render(scene, cfg(1, True), 0, device="cuda")     # warm
    torch.cuda.synchronize()
    fb.LAUNCHES = 0
    for rr in (False, True):
        before = fb.LAUNCHES
        t0 = time.perf_counter()
        img, rays = path_tracer.render(scene, cfg(SPP, rr), 1, device="cuda")
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
    return fb.LAUNCHES


def main() -> int:
    device = card()
    sys.path.insert(0, ROOT)
    build()
    stats = check_kernel()
    check_golden()
    launches = main_path()
    kernel = {"name": "bounce", "route": "cuda",
              "source": "raytracer_tpu_torch/csrc/bounce.cu",
              "replaces": "raytracer_tpu/ops/pallas_intersect.py:1731",
              "launches": launches, **stats}
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
