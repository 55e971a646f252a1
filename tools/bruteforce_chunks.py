"""How the brute-force route's chunk size trades time against memory on
the GPU: ``ops/intersect.py::intersect_bruteforce`` timed at several
values of ``intersect.PAIRS["cuda"]`` (the most (ray, primitive) pairs a
chunk holds), on 640,000 camera rays (800x800, one sample a pixel) of
scene_500 (1,005 spheres), cornell_box() (26 rects and triangles) and
field64k (65,538 spheres), then one scene_500 render through
``--intersector bruteforce`` (800x600, 4 spp, spp_chunk 1, depth 16) at
some of those values.

    python3 tools/bruteforce_chunks.py [--pairs 20 22 24 26 28]

``--pairs`` gives the values as powers of two. Prints, per scene and
value, the primitives a chunk holds, the median of CUDA-event timings,
the peak device memory the call allocated beyond its inputs, and whether
the winners are bit-equal to those at the first value (the winner does
not depend on the chunking); then the renders' seconds and rays. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 800
RENDER = dict(width=800, height=600, spp=4)


def median_ms(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm
    call."""
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


def scenes():
    from raytracer_tpu_torch.scene.builtin import cornell_box, sphere_field
    from raytracer_tpu_torch.scene.loader import load_scene
    return {"scene_500": load_scene(os.path.join(ROOT, "data",
                                                 "scene_500.json"), 1.0),
            "cornell_box": cornell_box(1.0),
            "field64k": sphere_field(65536, 1.0)}


def sweep(name, scene, pairs, dev) -> list:
    from raytracer_tpu_torch.models.camera import camera_rays
    from raytracer_tpu_torch.ops import intersect
    scene = scene.to(dev)
    n = SIDE * SIDE
    gen = torch.Generator(device=dev).manual_seed(0)
    o, d = camera_rays(scene.camera, gen,
                       torch.arange(n, device=dev), SIDE, SIDE)
    prims = (scene.spheres.radius.shape[0] + scene.rects.k.shape[0]
             + scene.triangles.mat_id.shape[0])
    reps = 3 if prims > 10_000 else 10
    rows, ref = [], None
    for p in pairs:
        intersect.PAIRS["cuda"] = 1 << p
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        hit = intersect.intersect_bruteforce(scene, o, d, 1e-3, float("inf"))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = median_ms(lambda: intersect.intersect_bruteforce(
            scene, o, d, 1e-3, float("inf")), reps)
        if ref is None:
            ref = hit
        same = all(bool(torch.equal(a, b)) for a, b in zip(hit, ref))
        row = dict(scene=name, rays=n, primitives=prims, pairs_log2=p,
                   chunk=intersect.chunk_size(n, dev), ms=ms,
                   peak_mib=peak / 2 ** 20, winners_equal=same)
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not same:
            raise AssertionError(f"{name}: winners depend on the chunking")
    return rows


def renders(pairs, dev) -> list:
    from raytracer_tpu_torch.models import path_tracer
    from raytracer_tpu_torch.ops import intersect
    from raytracer_tpu_torch.scene.loader import load_scene
    from raytracer_tpu_torch.utils.config import RenderConfig
    scene = load_scene(os.path.join(ROOT, "data", "scene_500.json"),
                       RENDER["width"] / RENDER["height"])
    cfg = RenderConfig(width=RENDER["width"], height=RENDER["height"],
                       samples_per_pixel=RENDER["spp"], spp_chunk=1,
                       max_depth=16, t_min=1e-3, spawn_eps_rel=1e-5,
                       intersector="bruteforce")
    rows = []
    for p in pairs:
        intersect.PAIRS["cuda"] = 1 << p
        path_tracer.render(scene, dataclasses.replace(
            cfg, samples_per_pixel=1), 0, device=dev)             # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, rays = path_tracer.render(scene, cfg, 0, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        row = dict(render="scene_500 bruteforce", pairs_log2=p,
                   seconds=dt, rays=rays, mrays_s=rays / dt / 1e6,
                   image_mean=float(img.mean()))
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, nargs="+",
                    default=[20, 22, 24, 26, 28])
    ap.add_argument("--render-pairs", type=int, nargs="+",
                    default=[24, 26, 28])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "bruteforce_chunks.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    rows = []
    for name, scene in scenes().items():
        # one primitive a chunk would take 65,536 steps: field64k starts
        # where a chunk holds several
        pairs = [p for p in args.pairs
                 if name != "field64k" or (1 << p) >= 4 * SIDE * SIDE]
        rows += sweep(name, scene, pairs, dev)
    rows += renders(args.render_pairs, dev)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
