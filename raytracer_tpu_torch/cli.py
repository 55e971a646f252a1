"""Command-line entry point of the port: ``render --integrator pt|sppm`` on a
chosen device (the counterpart of ``raytracer_tpu/cli.py``).

Usage:
    python -m raytracer_tpu_torch render --scene data/scene_500.json \
        --width 800 --height 600 --spp 32 --max-depth 16 --device cuda
    python -m raytracer_tpu_torch render --scene data/scene_500.json \
        --width 800 --height 600 --spp 32 --max-depth 16 --nee
    python -m raytracer_tpu_torch render --scene cornell --integrator sppm \
        --width 800 --height 800 --spp 256 --device cuda \
        --checkpoint output/sppm.npz
    python -m raytracer_tpu_torch render --scene cornell_bunny \
        --integrator sppm --width 800 --height 800 --spp 256 --device cuda
    python -m raytracer_tpu_torch render --scene motion --width 800 \
        --height 600 --spp 8 --max-depth 16 --device cuda
    python -m raytracer_tpu_torch render --scene smoke --width 400 \
        --height 400 --spp 32 --max-depth 16 --device cuda
    python -m raytracer_tpu_torch render --scene textured \
        --intersector bruteforce --width 64 --height 48 --spp 4 \
        --device cpu
    python -m raytracer_tpu_torch render --scene bunnies --intersector bvh \
        --width 800 --height 600 --spp 1 --max-depth 16 --device cuda
    python -m raytracer_tpu_torch render --scene smoke --integrator sppm \
        --preset ci --device cpu --profile-dir output/prof
    torchrun --standalone --nproc-per-node 2 -m raytracer_tpu_torch \
        render --sharded --scene cornell --integrator sppm --device cpu

``--sharded`` renders across the ranks of a ``torch.distributed`` group
(``parallel/``): those ``torchrun`` starts (``WORLD_SIZE`` set, ``env://``),
else a group of one rank on a file store in a temporary directory; NCCL on
CUDA, gloo on the CPU. Rank 0 alone writes the PNG, the checkpoint and the
summary. ``--jax-cache`` is accepted and does nothing (the port compiles
no XLA programs). ``--debug-nans`` checks every wavefront step's outputs
for NaN (``utils/nans.py``).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytracer_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    r = sub.add_parser("render", help="render a scene to a PNG")
    r.add_argument("--scene", default="cornell",
                   help="'cornell', 'cornell_bunny' (Cornell with the "
                        "Stanford bunny in the cube's place), 'spheres', "
                        "'smoke' (Cornell with two smoke volumes), "
                        "'textured' (image and "
                        "marble spheres), 'field[:N]' (N-sphere field), "
                        "'bunnies[:N]' (N bunnies), 'motion[:N]' (N "
                        "moving spheres) or a data/*.json|yaml path")
    r.add_argument("--integrator", choices=["pt", "sppm"], default="pt",
                   help="path tracer or SPPM (the reference's algorithm)")
    r.add_argument("--width", type=int, default=800)
    r.add_argument("--height", type=int, default=800)
    r.add_argument("--spp", type=int, default=256)
    r.add_argument("--spp-chunk", type=int, default=4)
    r.add_argument("--max-depth", type=int, default=50)
    r.add_argument("--seed", type=int, default=None,
                   help="seed (default 0; on --resume the checkpoint's "
                        "stored seed wins unless --seed is given)")
    r.add_argument("--intersector", default="auto",
                   choices=["auto", "pallas", "bruteforce", "bvh", "leaf"])
    r.add_argument("--device", default="cuda",
                   help="torch device: 'cuda' runs the CUDA kernel, 'cpu' "
                        "its plain PyTorch version")
    r.add_argument("--out", default="output/test.png")
    r.add_argument("--nee", action="store_true",
                   help="next-event estimation for the pt integrator "
                        "(a shadow ray toward one light at every diffuse "
                        "vertex; same mean, lower variance)")
    r.add_argument("--mis", action="store_true",
                   help="mixture-PDF importance sampling for the pt "
                        "integrator (50/50 cosine/light direction at "
                        "diffuse vertices). Exclusive with --nee")
    r.add_argument("--bvh", action="store_true",
                   help="build a BVH for the scene")
    r.add_argument("--sharded", action="store_true",
                   help="render across the ranks of a torch.distributed "
                        "group: those torchrun starts, else one rank "
                        "(pixels sharded, samples summed; SPPM photons "
                        "all-gathered)")
    r.add_argument("--preset", choices=["ci"], default=None,
                   help="small CI workload (RenderConfig.ci_preset)")
    r.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (trace.json) here, "
                        "the port's spans in it, and print the render's "
                        "counters")
    r.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError at the first wavefront "
                        "step whose outputs hold a NaN")
    r.add_argument("--jax-cache", default=None,
                   help="accepted for the JAX CLI's sake; no effect (the "
                        "port has no XLA compilation cache)")
    # SPPM knobs (reference defaults, photon_mapper.rs:17-19,148-149)
    r.add_argument("--sppm-iters", type=int, default=50)
    r.add_argument("--sppm-photons", type=int, default=500_000)
    r.add_argument("--sppm-alpha", type=float, default=0.7)
    r.add_argument("--checkpoint", default=None,
                   help="write the SPPM state here after every iteration")
    r.add_argument("--resume", default=None,
                   help="resume SPPM from a checkpoint file (either "
                        "package's)")
    return p


def load_scene_arg(name: str, aspect: float):
    from raytracer_tpu_torch.scene import builtin
    if name == "cornell":
        return builtin.cornell_box(aspect_ratio=aspect)
    if name == "cornell_bunny":
        return builtin.cornell_bunny(aspect_ratio=aspect)
    if name == "spheres":
        return builtin.three_spheres(aspect_ratio=aspect)
    if name == "smoke":
        return builtin.cornell_smoke(aspect_ratio=aspect)
    if name == "textured":
        return builtin.textured_spheres(aspect_ratio=aspect)

    def count(default: int) -> int:
        if ":" not in name:
            return default
        try:
            n = int(name.split(":", 1)[1])
        except ValueError:
            n = 0
        if n < 1:
            raise SystemExit(
                f"--scene {name!r}: expected a positive integer after ':'")
        return n

    if name == "field" or name.startswith("field:"):
        return builtin.sphere_field(count(65536), aspect_ratio=aspect)
    if name == "bunnies" or name.startswith("bunnies:"):
        return builtin.bunny_field(count(25), aspect_ratio=aspect)
    if name == "motion" or name.startswith("motion:"):
        return builtin.motion_field(count(1000), aspect_ratio=aspect)
    from raytracer_tpu_torch.scene.loader import load_scene
    return load_scene(name, aspect_ratio=aspect)


def cmd_render(args) -> int:
    if not args.sharded:
        return _render(args)
    import torch.distributed as dist
    from raytracer_tpu_torch.parallel.render import init_group
    store = init_group(args.device)
    try:
        return _render(args)
    finally:
        dist.destroy_process_group()
        if store is not None:
            store.cleanup()


def _render(args) -> int:
    if args.jax_cache is not None:
        print("raytracer_tpu_torch: --jax-cache has no effect: the port has "
              "no XLA compilation cache", file=sys.stderr)

    import torch

    from raytracer_tpu_torch.models import path_tracer, sppm
    from raytracer_tpu_torch.ops.fused_bounce import moving
    from raytracer_tpu_torch.utils import checkpoint as ckpt
    from raytracer_tpu_torch.utils import nans
    from raytracer_tpu_torch.utils.config import RenderConfig, SPPMConfig
    from raytracer_tpu_torch.utils.image import save_render
    from raytracer_tpu_torch.utils.timing import (
        StageTimer, maybe_profile, recorded)

    timer = StageTimer()
    cfg = RenderConfig(
        width=args.width, height=args.height, samples_per_pixel=args.spp,
        spp_chunk=args.spp_chunk, max_depth=args.max_depth,
        seed=args.seed if args.seed is not None else 0,
        intersector=args.intersector, output=args.out,
        nee=args.nee, mis=args.mis,
        sppm=SPPMConfig(n_iterations=args.sppm_iters,
                        photons_per_iter=args.sppm_photons,
                        alpha=args.sppm_alpha))
    if args.preset == "ci":
        ci = RenderConfig.ci_preset()
        cfg = cfg.replace(width=ci.width, height=ci.height,
                          samples_per_pixel=ci.samples_per_pixel,
                          max_depth=ci.max_depth, sppm=ci.sppm)
    stats = {}
    writer = True           # the rank that writes: rank 0 under --sharded
    try:
        mesh = None
        if args.sharded:
            from raytracer_tpu_torch.parallel import render as prender
            from raytracer_tpu_torch.parallel import sppm as psppm
            mesh = prender.make_mesh(
                device=None if args.device == "cuda" else args.device)
            writer = mesh.rank == 0
        with timer.stage("Scene build"):
            scene = load_scene_arg(args.scene, cfg.width / cfg.height)
            if args.bvh or args.intersector == "bvh":
                from raytracer_tpu_torch.ops.bvh import build_bvh
                scene = build_bvh(scene)
            # a moving scene takes the kernel route instead
            # (dispatch.resolve); a scene without spheres has no leaf
            # tables (ValueError, as JAX)
            if args.intersector == "leaf" and not moving(scene):
                from raytracer_tpu_torch.ops.leaf import build_leaf_tables
                scene = scene._replace(leaf=build_leaf_tables(scene))
        # one trace file: rank 0's
        with maybe_profile(args.profile_dir if writer else None,
                           args.device), \
                nans.debug_nans(args.debug_nans):
            if args.integrator == "sppm":
                state = None
                if args.resume:
                    # the stored seed reproduces the original random
                    # streams; an explicit --seed overrides it, with a
                    # warning
                    state, stored_seed = ckpt.load_state(args.resume)
                    if args.seed is None:
                        cfg = cfg.replace(seed=stored_seed)
                    elif args.seed != stored_seed:
                        print(f"warning: --seed {args.seed} != checkpoint "
                              f"seed {stored_seed}; resumed render will not "
                              "match the original", file=sys.stderr)
                    if writer:
                        print(f"resumed from {args.resume} at iteration "
                              f"{state.iteration}")
                cb = None
                if args.checkpoint:
                    # every rank calls it (the sharded render all-gathers
                    # the state for it); one writes
                    def cb(s):
                        if writer:
                            ckpt.save_state(args.checkpoint, s, cfg.seed)
                with timer.stage("SPPM"):
                    if mesh is not None:
                        img, rays, _ = psppm.render_sppm(
                            scene, cfg, cfg.seed, mesh=mesh, state=state,
                            checkpoint_cb=cb)
                    else:
                        img, rays, _ = sppm.render(
                            scene, cfg, cfg.seed, state=state,
                            checkpoint_cb=cb, device=args.device)
                    if img.is_cuda:
                        torch.cuda.synchronize(img.device)
            else:
                with timer.stage("RT"):
                    if mesh is not None:
                        img, rays = prender.render(scene, cfg, cfg.seed,
                                                   mesh, stats=stats)
                    else:
                        img, rays = path_tracer.render(
                            scene, cfg, cfg.seed, device=args.device,
                            stats=stats)
                    if img.is_cuda:
                        torch.cuda.synchronize(img.device)
    except (NotImplementedError, ValueError) as e:
        print(f"raytracer_tpu_torch: {e}", file=sys.stderr)
        return 2
    if not writer:
        return 0
    timer.count("traced_rays", rays)
    if args.profile_dir:
        # the recorder's counters of the profiled render
        for name, v in recorded()["counters"].items():
            timer.count(name, v)
    with timer.stage("Save"):
        save_render(cfg.output, img)
    build_s = timer.stages["Scene build"]
    render_s = timer.stages.get("SPPM", timer.stages.get("RT"))
    where = args.device if mesh is None else (
        f"{args.device}, {mesh.size} rank(s), mesh ({mesh.n_px}, "
        f"{mesh.n_spp})")
    if args.integrator == "sppm":
        print(f"scene build {build_s:.3f} s; render {render_s:.3f} s on "
              f"{where}; {rays} rays in the final gather")
    else:
        print(f"scene build {build_s:.3f} s; render {render_s:.3f} s on "
              f"{where}; {rays} rays ({rays / render_s / 1e6:.2f} "
              "Mrays/s)")
        if args.nee:
            print(f"{stats['shadow_lanes']} NEE shadow rays (not counted "
                  "as rays)")
    print(timer.summary())
    print(f"wrote {cfg.output}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "render":
        return cmd_render(args)
    return 2


if __name__ == "__main__":
    sys.exit(main())
