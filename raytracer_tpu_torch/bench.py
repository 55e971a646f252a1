"""The port's bench: every program of the JAX package's ``bench.py``, on
one CUDA card.

    python -m raytracer_tpu_torch.bench

Prints ONE JSON line on stdout with the keys of ``bench.py:252-290``,
under the same names, units and rounding, headline first: Mrays/s
rendering ``data/scene_500.json`` at 800x600, 32 spp, depth <= 16, on
the faster of the "pallas" and "leaf" routes. A ray is one executed
ray-bounce intersection, as the loops count them (``bench.py:3-6``). Each
program's rays, kernel launches, image mean and stage times go to stderr
lines before it.

Each program runs once to warm up and once timed (``bench.py:24-31``),
both calls from a fresh generator of the same seed, the clock started and
stopped after a device synchronise. The programs are functions of the
device and their sizes, with ``bench.py``'s values as defaults, so that
they also run small on the CPU; ``run`` and ``main`` measure the card and
have no CPU fallback. Differences from ``bench.py``:

- field160k takes the ordered walk (the port has no slab chain); its key
  keeps the name ``mrays_field160k_slabbed``;
- ``jax.clear_caches()`` before the media programs has no counterpart
  (it dropped JAX's live executables);
- the reference workload is warmed by one iteration and one gather batch
  at its own settings (``sppm.render`` with one iteration and
  ``host_spp_batch`` samples), in place of ``warm_render_programs``;
  ``sppm_full_800_compile_warmup_s`` is that warm-up's seconds, which
  include the nvcc build of a library only where no earlier program used
  it (a stderr line says which libraries this process built), and the
  capture of the photon pass's CUDA graph where no earlier program
  captured its key (``sppm.graphed_photon_pass``): every SPPM program's
  warm call captures, its timed call replays;
- the SPPM programs' timed calls run as ``bench.py``'s do, without stage
  timing; their stage split (``times``, each stage ending in a device
  synchronise) comes from one more call of the same program, logged to
  stderr beside its own seconds.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from raytracer_tpu_torch.kernels import build as kbuild
from raytracer_tpu_torch.kernels import launch_counts, launches_since
from raytracer_tpu_torch.models import path_tracer, sppm
from raytracer_tpu_torch.ops import dispatch
from raytracer_tpu_torch.ops import photon_grid as pg
from raytracer_tpu_torch.ops.leaf import with_leaf_tables
from raytracer_tpu_torch.scene import builtin
from raytracer_tpu_torch.scene.loader import load_scene
from raytracer_tpu_torch.utils.config import RenderConfig, SPPMConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
WIDTH, HEIGHT, SPP = 800, 600, 32
DEPTH, T_MIN, EPS_REL = 16, 1e-3, 1e-5
SEED = 1                # bench.py's jax.random.PRNGKey(1)
FULL_SEED = 9           # the reference workload's PRNGKey(9)
GOLDEN_SEED = 7         # numeric_ok's PRNGKey(7)

# The line's keys in bench.py:252-290's order (tests/test_torch_bench.py
# holds them to that dict literal).
KEYS = (
    "metric", "value", "unit", "vs_baseline", "best_intersector",
    "mrays_pallas", "mrays_leaf", "wallclock_s_per_32spp",
    "wallclock_s_per_32spp_rr", "s_to_1000spp_measured",
    "extrapolated_s_to_1000spp", "depth50_rr_s_per_32spp", "depth50_mrays",
    "depth50_extrapolated_s_to_1000spp", "sppm_iter_s_400x400_250k",
    "sppm_iter_s_800x800_500k", "sppm_full_800_s",
    "sppm_full_800_compile_warmup_s", "mrays_field64k",
    "field64k_s_per_32spp", "mrays_field160k_slabbed", "field160k_s_per_8spp",
    "mrays_mesh124k", "mesh124k_s_per_8spp", "mrays_motion1k",
    "motion1k_s_per_8spp", "mrays_scene10", "scene10_s_per_100spp_400x225",
    "mrays_scene200", "scene200_s_per_32spp", "smoke_s_per_32spp_400",
    "cornell_s_per_32spp_400", "media_tax_x", "numeric_ok",
    "numeric_failures", "backend", "device")


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _timed(fn, device):
    """``fn()`` once to warm up, then once timed (bench.py:24-31). Returns
    (the timed call's output, its seconds, its kernel launches)."""
    fn()
    _sync(device)
    before = launch_counts()
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    dt = time.perf_counter() - t0
    return out, dt, launches_since(before)


def _record(tag: str, s: float, launches: dict, rays: int = None,
            img=None) -> dict:
    """One program's numbers, logged on a stderr line."""
    rec = {"s": s, "launches": launches}
    msg = f"bench {tag}: {s:.4f} s"
    if rays is not None:
        rec["rays"] = int(rays)
        msg += f", {rays} rays = {rays / s / 1e6:.4f} Mrays/s"
    if img is not None:
        rec["mean"] = float(img.mean())
        rec["finite"] = bool(torch.isfinite(img).all())
        msg += f", image mean {rec['mean']:.6f}"
    log(f"{msg}; launches {launches}")
    return rec


def _split(tag: str, rec: dict, fn, device):
    """The stage split of a timed SPPM program, from one more call,
    ``fn(times)``, whose stages each end in a device synchronise (the
    timed call passed no ``times`` and synchronised only at its end).
    Adds the split ("times") and that call's seconds ("split_s") to
    ``rec`` and logs them."""
    times = {}
    _sync(device)
    t0 = time.perf_counter()
    fn(times)
    _sync(device)
    rec["times"], rec["split_s"] = times, time.perf_counter() - t0
    log(f"bench {tag} stage split (one more call, synchronised after each "
        f"stage): {rec['split_s']:.4f} s against the timed "
        f"{rec['s']:.4f} s; stages "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))


def render(tag: str, device, scene, *, width: int, height: int, spp: int,
           spp_chunk: int = 1, max_depth: int = DEPTH,
           intersector: str = "auto", russian_roulette: bool = True,
           seed: int = SEED) -> dict:
    """``path_tracer.render_fn`` of ``scene`` (already on ``device``),
    timed by ``_timed``."""
    def call():
        return path_tracer.render_fn(
            scene, _generator(device, seed), width=width, height=height,
            spp=spp, spp_chunk=spp_chunk, max_depth=max_depth, t_min=T_MIN,
            spawn_eps_rel=EPS_REL, intersector=intersector,
            russian_roulette=russian_roulette, device=device)
    (img, rays), dt, launches = _timed(call, device)
    return _record(tag, dt, launches, rays, img)


def _data_scene(name: str, width: int, height: int):
    return load_scene(os.path.join(ROOT, "data", name),
                      aspect_ratio=width / height)


# ----------------------------------------------------------- the programs

def scene500(device, width=WIDTH, height=HEIGHT, spp=SPP) -> dict:
    """bench.py:38-69: scene_500 at depth 16, RR off, on the "pallas" and
    "leaf" routes; the faster route ("best") again with RR, and at depth
    50 with RR. Returns the four records and "best"."""
    scene = _data_scene("scene_500.json", width, height)
    routes = {"pallas": scene.to(device),
              "leaf": with_leaf_tables(scene).to(device)}
    kw = dict(width=width, height=height, spp=spp)
    out = {r: render(f"scene_500 {r}", device, sc, intersector=r,
                     russian_roulette=False, **kw)
           for r, sc in routes.items()}
    mrays = {r: out[r]["rays"] / out[r]["s"] for r in routes}
    best = "leaf" if mrays["leaf"] >= mrays["pallas"] else "pallas"
    out["best"] = best
    out["rr"] = render(f"scene_500 {best} RR", device, routes[best],
                       intersector=best, **kw)
    out["depth50"] = render(f"scene_500 {best} RR depth 50", device,
                            routes[best], intersector=best, max_depth=50,
                            **kw)
    return out


def field64k(device, n=65536, width=WIDTH, height=HEIGHT, spp=SPP) -> dict:
    """bench.py:73-76: ``sphere_field(65536)`` on "pallas", RR on."""
    return render("field64k", device, builtin.sphere_field(n).to(device),
                  width=width, height=height, spp=spp, intersector="pallas")


def field160k(device, n=163840, width=WIDTH, height=HEIGHT, spp=8) -> dict:
    """bench.py:78-87: ``sphere_field(163840)`` through "auto": the
    ordered walk."""
    return render("field160k", device, builtin.sphere_field(n).to(device),
                  width=width, height=height, spp=spp)


def mesh124k(device, n_bunnies=25, width=WIDTH, height=HEIGHT,
             spp=8) -> dict:
    """bench.py:89-95: ``bunny_field(25)`` (124,200 triangles), "auto"."""
    return render("mesh124k", device,
                  builtin.bunny_field(n_bunnies).to(device), width=width,
                  height=height, spp=spp)


def motion1k(device, n=1000, width=WIDTH, height=HEIGHT, spp=8) -> dict:
    """bench.py:97-103: ``motion_field(1000)``, "auto"."""
    return render("motion1k", device, builtin.motion_field(n).to(device),
                  width=width, height=height, spp=spp)


def scene10(device, width=400, height=225, spp=100) -> dict:
    """bench.py:105-110: scene_10 at its stated 400x225, 100 spp."""
    return render("scene_10", device,
                  _data_scene("scene_10.json", width, height).to(device),
                  width=width, height=height, spp=spp, intersector="pallas")


def scene200(device, width=WIDTH, height=HEIGHT, spp=SPP) -> dict:
    """bench.py:111-114: scene_200_no_bvh (405 spheres), RR on."""
    return render("scene_200_no_bvh", device,
                  _data_scene("scene_200_no_bvh.json", width,
                             height).to(device),
                  width=width, height=height, spp=spp, intersector="pallas")


def spp1000(device, width=WIDTH, height=HEIGHT, spp=1000, warm_spp=100,
            batch=50) -> dict:
    """bench.py:116-136: scene_500 to 1000 spp through
    ``path_tracer.render`` in host batches of 50 spp (RR on, depth 16),
    after a 100-spp render through the same call."""
    scene = _data_scene("scene_500.json", width, height).to(device)
    cfg = RenderConfig(width=width, height=height, samples_per_pixel=spp,
                       max_depth=DEPTH, spp_chunk=1, host_spp_batch=batch,
                       intersector="pallas")
    path_tracer.render(scene, cfg.replace(samples_per_pixel=warm_spp),
                       SEED, device=device)
    _sync(device)
    before = launch_counts()
    t0 = time.perf_counter()
    img, rays = path_tracer.render(scene, cfg, SEED, device=device)
    _sync(device)
    return _record(f"scene_500 {spp} spp", time.perf_counter() - t0,
                   launches_since(before), rays, img)


def media(device, width=400, height=400, spp=SPP, spp_chunk=4) -> dict:
    """bench.py:138-157: ``cornell_smoke()`` and ``cornell_box()`` at the
    same settings, the media tax's two terms."""
    kw = dict(width=width, height=height, spp=spp, spp_chunk=spp_chunk)
    return {"smoke": render("smoke", device,
                            builtin.cornell_smoke().to(device), **kw),
            "cornell": render("cornell_box()", device,
                              builtin.cornell_box().to(device), **kw)}


def sppm_iteration(device, width=400, height=400, photons=250_000) -> dict:
    """bench.py:159-190: Cornell with its mesh, one SPPM iteration to warm
    up, then one timed on the updated state (the dense photon query,
    photon depth 16, camera depth 50); the stage split from a third
    (``_split``)."""
    scene = builtin.cornell_box(with_mesh=True).to(device)
    grid_res, _ = pg.choose_grid_resolution(
        scene.bounds_min.cpu().numpy(), scene.bounds_max.cpu().numpy(),
        photons, 100)
    kw = dict(width=width, height=height, n_photons=photons,
              max_photon_bounces=16, max_camera_bounces=50,
              grid_res=grid_res, k_per_cell=64, alpha=0.7, k_global=100,
              k_caustic=50, t_min=T_MIN, spawn_eps_rel=EPS_REL,
              intersector="auto", query_impl="dense")
    tables = dispatch.route_tables(scene, "auto")
    state = sppm.init_state(width * height, device)
    state = sppm.sppm_iteration(scene, tables, state, SEED, **kw)
    _sync(device)
    before = launch_counts()
    t0 = time.perf_counter()
    state = sppm.sppm_iteration(scene, tables, state, SEED, **kw)
    _sync(device)
    tag = f"sppm iteration {width}x{height} {photons} photons"
    rec = _record(tag, time.perf_counter() - t0, launches_since(before))
    _split(tag, rec, lambda times: sppm.sppm_iteration(
        scene, tables, state, SEED, times=times, **kw), device)
    return rec


def sppm_full(device, config: RenderConfig = RenderConfig(),
              seed: int = FULL_SEED) -> dict:
    """bench.py:192-208, the reference workload: ``sppm.render`` of
    Cornell with its mesh at ``RenderConfig()`` (800x800, 50 iterations x
    500,000 photons, a 256-spp gather at depth 50). Warmed by one
    iteration and one gather batch at the same settings; the record's
    "warmup_s" is that warm-up's seconds. The stage split comes from a
    third render (``_split``)."""
    scene = builtin.cornell_box(with_mesh=True).to(device)
    warm = config.replace(
        samples_per_pixel=min(config.host_spp_batch,
                              config.samples_per_pixel),
        sppm=dataclasses.replace(config.sppm, n_iterations=1))
    t0 = time.perf_counter()
    sppm.render(scene, warm, seed, device=device)
    _sync(device)
    warmup = time.perf_counter() - t0
    before = launch_counts()
    t0 = time.perf_counter()
    img, rays, state = sppm.render(scene, config, seed, device=device)
    _sync(device)
    tag = (f"sppm full {config.width}x{config.height}, "
           f"{config.sppm.n_iterations} x {config.sppm.photons_per_iter} "
           f"photons, {config.samples_per_pixel}-spp gather")
    rec = _record(f"{tag} (rays: the gather's)", time.perf_counter() - t0,
                  launches_since(before), rays, img)
    rec["warmup_s"] = warmup
    rec["iterations"] = int(state.iteration)
    _split(tag, rec, lambda times: sppm.render(
        scene, config, seed, device=device, times=times), device)
    return rec


def golden_failure(name: str, img: np.ndarray):
    """The Monte-Carlo bands of ``tests/test_golden.py::check_against``
    (bench.py:214-229): gamma-space mean within 5% of the golden image's,
    95th percentile of |diff| below 0.30, mean |diff| below 0.08. Returns
    a message if ``img`` is outside them, else None."""
    ref = np.load(os.path.join(GOLDEN, name))["img"]
    a = np.sqrt(np.clip(np.asarray(img), 0, None))
    b = np.sqrt(np.clip(ref, 0, None))
    if a.shape != b.shape:
        return f"{name}: shape {a.shape} vs {b.shape}"
    diff = np.abs(a - b)
    p95 = np.percentile(diff, 95)
    log(f"bench golden {name}: gamma mean {a.mean():.4f} vs "
        f"{b.mean():.4f}, p95 |diff| {p95:.4f}, mean |diff| "
        f"{diff.mean():.4f}")
    if (abs(a.mean() - b.mean()) < 0.05 * max(b.mean(), 1e-6)
            and p95 < 0.30 and diff.mean() < 0.08):
        return None
    return f"{name}: mean {a.mean():.4f} vs {b.mean():.4f}, p95 {p95:.3f}"


def numeric_failures(device) -> list:
    """bench.py:210-250: the two golden scenes at 32x32 on ``device``,
    each held to ``golden_failure``'s bands. Returns the failures."""
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=64,
                       spp_chunk=8, max_depth=12)
    img, _ = path_tracer.render(builtin.three_spheres(1.0), cfg,
                                GOLDEN_SEED, device=device)
    failures = [golden_failure("three_spheres_32.npz", img.cpu().numpy())]
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=32,
                       spp_chunk=8, max_depth=12,
                       sppm=SPPMConfig(n_iterations=4, photons_per_iter=20000,
                                       max_photon_bounces=8,
                                       max_camera_bounces=12,
                                       max_photons_per_cell=64))
    img, _, _ = sppm.render(builtin.cornell_box(with_mesh=True), cfg,
                            GOLDEN_SEED, device=device)
    failures.append(golden_failure("cornell_sppm_32.npz", img.cpu().numpy()))
    return [f for f in failures if f is not None]


# -------------------------------------------------------------- the line

def card_name() -> str:
    """``torch.cuda.get_device_name()`` and the power limit, as
    ``nvidia-smi --query-gpu=name,power.limit`` gives it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    limit = smi.stdout.strip().splitlines()[0].split(",")[-1].strip()
    return f"{torch.cuda.get_device_name()}, {limit}"


def _libraries() -> dict:
    """Whether each library of ``csrc/`` is built in ``_build/``."""
    return {p.stem: kbuild.library_path(p.stem).is_file()
            for p in sorted(kbuild.CSRC.glob("*.cu"))}


def run(device="cuda") -> tuple:
    """Every program of bench.py on ``device``, in its order. Returns
    (the line as a dict with ``KEYS``, each program's records)."""
    found = _libraries()
    ex = {}
    s5 = ex["scene_500"] = scene500(device)
    best = s5["best"]
    ex["field64k"] = field64k(device)
    ex["field160k"] = field160k(device)
    ex["mesh124k"] = mesh124k(device)
    ex["motion1k"] = motion1k(device)
    ex["scene_10"] = scene10(device)
    ex["scene_200"] = scene200(device)
    ex["spp1000"] = spp1000(device)
    ex["media"] = media(device)
    ex["sppm_400"] = sppm_iteration(device)
    ex["sppm_800"] = sppm_iteration(device, 800, 800, 500_000)
    full = ex["sppm_full_800"] = sppm_full(device)
    now = _libraries()
    log("bench libraries: built by this process (nvcc, at first use): "
        f"{[k for k in now if now[k] and not found[k]]}; loaded from "
        f"_build/: {[k for k in now if now[k] and found[k]]}")
    failures = ex["numeric_failures"] = numeric_failures(device)

    def mrays(rec):
        return rec["rays"] / rec["s"] / 1e6

    mrays_p, mrays_l = mrays(s5["pallas"]), mrays(s5["leaf"])
    headline = max(mrays_p, mrays_l)
    dt_rr, d50 = s5["rr"]["s"], s5["depth50"]
    sm, cb = ex["media"]["smoke"]["s"], ex["media"]["cornell"]["s"]
    result = {
        "metric": "Mrays/s/chip scene_500 800x600 (wavefront PT, depth<=16)",
        "value": round(headline, 2),
        "unit": "Mrays/s/chip",
        # bench.py:256's ratio, kept so that the two lines compare; its
        # divisor is the JAX package's own (BASELINE.md)
        "vs_baseline": round(headline / 100.0, 3),
        "best_intersector": best,
        "mrays_pallas": round(mrays_p, 2),
        "mrays_leaf": round(mrays_l, 2),
        "wallclock_s_per_32spp": round(s5[best]["s"], 3),
        "wallclock_s_per_32spp_rr": round(dt_rr, 3),
        "s_to_1000spp_measured": round(ex["spp1000"]["s"], 1),
        "extrapolated_s_to_1000spp": round(dt_rr * (1000 / SPP), 1),
        "depth50_rr_s_per_32spp": round(d50["s"], 3),
        "depth50_mrays": round(mrays(d50), 2),
        "depth50_extrapolated_s_to_1000spp": round(d50["s"] * (1000 / SPP),
                                                   1),
        "sppm_iter_s_400x400_250k": round(ex["sppm_400"]["s"], 2),
        "sppm_iter_s_800x800_500k": round(ex["sppm_800"]["s"], 2),
        "sppm_full_800_s": round(full["s"], 1),
        "sppm_full_800_compile_warmup_s": round(full["warmup_s"], 1),
        "mrays_field64k": round(mrays(ex["field64k"]), 2),
        "field64k_s_per_32spp": round(ex["field64k"]["s"], 3),
        "mrays_field160k_slabbed": round(mrays(ex["field160k"]), 2),
        "field160k_s_per_8spp": round(ex["field160k"]["s"], 3),
        "mrays_mesh124k": round(mrays(ex["mesh124k"]), 2),
        "mesh124k_s_per_8spp": round(ex["mesh124k"]["s"], 3),
        "mrays_motion1k": round(mrays(ex["motion1k"]), 2),
        "motion1k_s_per_8spp": round(ex["motion1k"]["s"], 3),
        "mrays_scene10": round(mrays(ex["scene_10"]), 2),
        "scene10_s_per_100spp_400x225": round(ex["scene_10"]["s"], 3),
        "mrays_scene200": round(mrays(ex["scene_200"]), 2),
        "scene200_s_per_32spp": round(ex["scene_200"]["s"], 3),
        "smoke_s_per_32spp_400": round(sm, 3),
        "cornell_s_per_32spp_400": round(cb, 3),
        "media_tax_x": round(sm / cb, 2),
        "numeric_ok": not failures,
        "numeric_failures": failures,
        "backend": torch.device(device).type,
        "device": card_name(),
    }
    if tuple(result) != KEYS:
        raise AssertionError("the bench line's keys differ from KEYS")
    return result, ex


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the bench measures the card and "
                           "has no CPU fallback")
    result, _ = run("cuda")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
