"""Command-line entry point of the port: ``render --integrator pt`` on a chosen
device (the counterpart of ``raytracer_tpu/cli.py``).

Usage:
    python -m raytracer_tpu_torch render --scene data/scene_500.json \
        --width 800 --height 600 --spp 32 --max-depth 16 --device cuda

The other integrators and flags of the JAX CLI are accepted by name so that
a command written for it fails with a message naming the ROADMAP item that
ports the feature, instead of an argparse error.
"""

from __future__ import annotations

import argparse
import sys
import time

# flag -> ROADMAP item that ports it (queue A of ROADMAP.md)
UNPORTED = {
    "nee": "A6 (NEE and MIS)",
    "mis": "A6 (NEE and MIS)",
    "bvh": "A10 (large scenes)",
    "sharded": "A12 (multi-device)",
    "checkpoint": "A13 (the rest of the CLI)",
    "resume": "A13 (the rest of the CLI)",
    "preset": "A13 (the rest of the CLI)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracer_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    r = sub.add_parser("render", help="render a scene to a PNG")
    r.add_argument("--scene", default="cornell",
                   help="'cornell', 'spheres', 'field[:N]' (N-sphere field) "
                        "or a data/*.json|yaml path")
    r.add_argument("--integrator", choices=["pt", "sppm"], default="pt",
                   help="only the path tracer is ported (SPPM: ROADMAP A11)")
    r.add_argument("--width", type=int, default=800)
    r.add_argument("--height", type=int, default=800)
    r.add_argument("--spp", type=int, default=256)
    r.add_argument("--spp-chunk", type=int, default=4)
    r.add_argument("--max-depth", type=int, default=50)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--intersector", default="auto",
                   choices=["auto", "pallas", "bruteforce", "bvh", "leaf"])
    r.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' runs the CUDA kernel, 'cpu' "
                        "its plain PyTorch version")
    r.add_argument("--out", default="output/test.png")
    for flag in ("nee", "mis", "bvh", "sharded"):
        r.add_argument(f"--{flag}", action="store_true",
                       help=f"not ported yet (ROADMAP {UNPORTED[flag]})")
    for flag in ("checkpoint", "resume", "preset"):
        r.add_argument(f"--{flag}", default=None,
                       help=f"not ported yet (ROADMAP {UNPORTED[flag]})")
    return p


def load_scene_arg(name: str, aspect: float):
    from raytracer_tpu_torch.scene import builtin
    if name == "cornell":
        return builtin.cornell_box(aspect_ratio=aspect)
    if name == "spheres":
        return builtin.three_spheres(aspect_ratio=aspect)
    if name == "field" or name.startswith("field:"):
        n = int(name.split(":", 1)[1]) if ":" in name else 65536
        if n < 1:
            raise SystemExit(f"--scene {name!r}: expected a positive count")
        return builtin.sphere_field(n, aspect_ratio=aspect)
    from raytracer_tpu_torch.scene.loader import load_scene
    return load_scene(name, aspect_ratio=aspect)


def cmd_render(args) -> int:
    if args.integrator != "pt":
        print(f"raytracer_tpu_torch: --integrator {args.integrator} is not "
              "ported yet (ROADMAP A11, SPPM)", file=sys.stderr)
        return 2
    for flag, item in UNPORTED.items():
        if getattr(args, flag):
            print(f"raytracer_tpu_torch: --{flag} is not ported yet "
                  f"(ROADMAP {item})", file=sys.stderr)
            return 2

    import torch

    from raytracer_tpu_torch.models import path_tracer
    from raytracer_tpu_torch.utils.config import RenderConfig
    from raytracer_tpu_torch.utils.image import save_render

    cfg = RenderConfig(
        width=args.width, height=args.height, samples_per_pixel=args.spp,
        spp_chunk=args.spp_chunk, max_depth=args.max_depth, seed=args.seed,
        intersector=args.intersector, output=args.out)
    t0 = time.perf_counter()
    scene = load_scene_arg(args.scene, cfg.width / cfg.height)
    t1 = time.perf_counter()
    try:
        img, rays = path_tracer.render(scene, cfg, cfg.seed,
                                       device=args.device)
    except NotImplementedError as e:
        print(f"raytracer_tpu_torch: {e}", file=sys.stderr)
        return 2
    if img.is_cuda:
        torch.cuda.synchronize(img.device)
    t2 = time.perf_counter()
    save_render(cfg.output, img)
    print(f"scene build {t1 - t0:.3f} s; render {t2 - t1:.3f} s on "
          f"{args.device}; {rays} rays ({rays / (t2 - t1) / 1e6:.2f} "
          "Mrays/s)")
    print(f"wrote {cfg.output}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "render":
        return cmd_render(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
