"""What one traversal of the flat BVH (``ops/bvh.py``) costs on the GPU:
the native and numpy builds of bunny_field(25) (124,202 primitives) and
scene_500 (1,005), then ``intersect_bvh`` on their 480,000 camera rays
(800x600, one jittered ray a pixel): seconds, iterations (node pops of
the slowest lane), hits; and the cost of one iteration at that width,
eager (``_Walk.step``) against the CUDA graph the traversal replays
(``_Walk.run``).

    python3 tools/bvh_traversal.py [--reps 8]

Prints one line per measurement, the card's name and power limit first,
and a JSON object last. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, HEIGHT, T_MIN = 800, 600, 1e-3


def camera_rays(scene, seed: int, dev):
    """(o, d), each (N, 3), one jittered ray per pixel of the image."""
    from raytracer_tpu_torch.models.wavefront_soa import camera_rays_soa
    rng = np.random.default_rng(seed)
    pix = np.arange(WIDTH * HEIGHT)
    px = torch.from_numpy((pix % WIDTH).astype(np.float32))
    py = torch.from_numpy((pix // WIDTH).astype(np.float32))
    uni = torch.from_numpy(rng.random((4, pix.size), dtype=np.float32))
    o, d = camera_rays_soa(scene.camera, px, py, WIDTH, HEIGHT, uni)
    return o.T.contiguous().to(dev), d.T.contiguous().to(dev)


def walk(scene, o, d):
    """A fresh ``_Walk`` over every lane, as ``intersect_bvh`` starts."""
    from raytracer_tpu_torch.ops import bvh
    n, dev = o.shape[0], o.device
    inv_d = torch.where(d.abs() > 1e-20, 1.0 / d,
                        torch.sign(d) * 1e20 + 1e20)
    tmax = torch.full((n,), float("inf"), device=dev)
    return bvh._Walk(
        scene, bvh.LEAF_SIZE, torch.arange(n, device=dev), o, d, inv_d,
        torch.full((n,), T_MIN, device=dev), tmax,
        torch.zeros((n, bvh.MAX_STACK), dtype=torch.int64, device=dev),
        torch.ones((n,), dtype=torch.int64, device=dev),
        (tmax.clone(), torch.full((n,), -1, dtype=torch.int32, device=dev),
         torch.full((n,), -1, dtype=torch.int32, device=dev)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=8,
                    help="runs of CHECK_EVERY iterations timed per variant")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from raytracer_tpu_torch.ops import bvh
    from raytracer_tpu_torch.scene import builtin, loader
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    out = {}
    scenes = {"bunny_field": builtin.bunny_field(25, WIDTH / HEIGHT),
              "scene_500": loader.load_scene(
                  os.path.join(ROOT, "data", "scene_500.json"),
                  aspect_ratio=WIDTH / HEIGHT)}
    for name, scene in scenes.items():
        row = {}
        for native in (True, False):
            t0 = time.perf_counter()
            built = bvh.build_bvh(scene, use_native=native)
            row["build_native_s" if native else "build_numpy_s"] = \
                time.perf_counter() - t0
        row["nodes"] = int(built.bvh.left.shape[0])
        o, d = camera_rays(built, 31, dev)
        built = built.to(dev)
        iters = [0]
        real = bvh._Walk.run

        def counted(self, steps):
            iters[0] += steps
            return real(self, steps)

        bvh._Walk.run = counted
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = bvh.intersect_bvh(built, o, d, T_MIN, float("inf"))
            torch.cuda.synchronize()
            row["traversal_s"] = time.perf_counter() - t0
        finally:
            bvh._Walk.run = real
        row["iterations"] = iters[0]
        row["hits"] = int(torch.isfinite(h.t).sum())
        for label, fn in (("eager", lambda w: [w.step() for _ in
                                               range(bvh.CHECK_EVERY)]),
                          ("graph", lambda w: w.run(bvh.CHECK_EVERY))):
            w = walk(built, o, d)
            fn(w)
            fn(w)                       # the graph: captured, then warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn(w)
            torch.cuda.synchronize()
            row[f"iteration_ms_{label}"] = ((time.perf_counter() - t0) * 1e3
                                            / (args.reps * bvh.CHECK_EVERY))
        print(f"{name}: {row['nodes']} nodes; build native "
              f"{row['build_native_s']:.4f} s, numpy "
              f"{row['build_numpy_s']:.4f} s; traversal of {o.shape[0]} "
              f"camera rays {row['traversal_s']:.4f} s, {row['iterations']}"
              f" iterations, {row['hits']} hits; one iteration at "
              f"{o.shape[0]} lanes {row['iteration_ms_eager']:.4f} ms eager,"
              f" {row['iteration_ms_graph']:.4f} ms in a CUDA graph",
              flush=True)
        out[name] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
