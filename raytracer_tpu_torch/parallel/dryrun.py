"""One sharded step of each kind on n ranks: the twin of
``__graft_entry__.dryrun_multichip``.

    python -m raytracer_tpu_torch.parallel.dryrun [N] [--device cuda|cpu]

runs on the card by default: it spawns N ranks (default 8) of a gloo
group, rank r on card r % device_count (ranks past the cards share them:
NCCL refuses two ranks on one device); under ``torchrun`` (``WORLD_SIZE``
set) the ranks join the NCCL group it describes, each on card
``LOCAL_RANK``. ``--device cpu`` runs every rank on the CPU over gloo.
Each runs, as the JAX dryrun does: a path-traced Cornell (with its mesh)
at 32x24, 4 spp, on an (n/2, 2) mesh (n, 1 for an odd n); one SPPM
iteration of 4,096 photons on an (n, 1) mesh; the sharded gather of its
state; and a motion_field(64) render. Shapes, finiteness and rays > 0 are
checked, and rank 0 prints one line.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from raytracer_tpu_torch.models import sppm
from raytracer_tpu_torch.ops import dispatch
from raytracer_tpu_torch.parallel import render as prender
from raytracer_tpu_torch.parallel.sppm import (
    gather_state, shard_state, sppm_gather_sharded, sppm_iteration_sharded,
)
from raytracer_tpu_torch.scene.builtin import cornell_box, motion_field
from raytracer_tpu_torch.utils.config import RenderConfig

W, H = 32, 24


def spawn(fn, n: int, *args, store_dir=None, threads=None):
    """Run ``fn(*args)`` on each of ``n`` spawned processes, ranks of one
    gloo group initialised through a file store in a fresh temporary
    directory (under ``store_dir`` if given), each with ``threads`` CPU
    threads (by default an n-th of this process's); each process destroys
    the group when ``fn`` returns. ``fn`` must be importable by name (the
    processes start from a fresh interpreter). Raises if any process
    fails."""
    if threads is None:
        threads = max(1, torch.get_num_threads() // n)
    with tempfile.TemporaryDirectory(dir=store_dir) as d:
        init = "file://" + os.path.join(d, "store")
        mp.start_processes(_entry, args=(n, init, threads, fn, args),
                           nprocs=n, join=True, start_method="spawn")


def _entry(rank: int, n: int, init: str, threads: int, fn, args):
    torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=init, world_size=n,
                            rank=rank)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(f"dryrun: {what}")


def dryrun(device=None) -> str:
    """The dryrun on the initialised default group, on ``device``: "cpu",
    or by default each rank's card (``make_mesh``). Returns the line rank
    0 prints."""
    world = dist.get_world_size()
    n_spp = 2 if world % 2 == 0 else 1
    mesh = prender.make_mesh(world // n_spp, n_spp, device=device)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    scene = cornell_box(with_mesh=True).to(mesh.device)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=4, spp_chunk=2,
                       max_depth=4)
    img, rays = prender.render(scene, cfg, 0, mesh)
    img = img.cpu().numpy()
    _check(img.shape == (H, W, 3) and np.isfinite(img).all(), "PT image")
    _check(rays > 0, "PT rays")

    # one SPPM iteration: per-rank photon passes, the deposits
    # all-gathered, the same grids everywhere, the pixel-sharded update
    mesh1 = prender.make_mesh(world, 1, device=device)
    tables = dispatch.route_tables(scene, "auto")
    shard = shard_state(sppm.init_state(W * H, mesh.device), W * H, mesh1)
    shard = sppm_iteration_sharded(
        scene, tables, shard, 1, mesh=mesh1, width=W, height=H,
        n_photons=4096, max_photon_bounces=4, max_camera_bounces=4,
        grid_res=(8, 8, 8), k_per_cell=16, alpha=0.7, k_global=100.0,
        k_caustic=50.0, t_min=1e-3, spawn_eps_rel=1e-5)
    state = gather_state(shard, W * H)
    _check(state.iteration == 1, "SPPM iteration count")
    _check(bool(torch.isfinite(state.glob.flux).all()), "SPPM flux")
    touched = float((state.glob.photons > 0).float().mean())

    # the sharded gather: the estimates ride the block-order pixel shard
    simg, srays = sppm_gather_sharded(
        scene, tables, state, 2, mesh=mesh, width=W, height=H, spp=4,
        spp_chunk=2, max_depth=4, t_min=1e-3, spawn_eps_rel=1e-5,
        n_total_photons=4096)
    simg = simg.cpu().numpy()
    _check(simg.shape == (H, W, 3) and np.isfinite(simg).all(),
           "gather image")
    _check(srays > 0, "gather rays")

    # motion blur: per-sample shutter times ride the sharded regen loop
    mimg, mrays = prender.render(motion_field(64, aspect_ratio=W / H), cfg,
                                 3, mesh)
    mimg = mimg.cpu().numpy()
    _check(mimg.shape == (H, W, 3) and np.isfinite(mimg).all(),
           "motion image")
    _check(mrays > 0, "motion rays")
    line = (f"dryrun_multichip ok: {dist.get_backend()} on {mesh.device}, "
            f"mesh=({mesh.n_px}, {mesh.n_spp}) "
            f"img={img.shape} rays={rays}; sppm step on mesh=({world}, 1) "
            f"touched={touched:.2f}; sharded gather mean={simg.mean():.4f};"
            f" motion mean={mimg.mean():.4f}")
    if dist.get_rank() == 0:
        print(line, flush=True)
    return line


def dryrun_multichip(n: int, device: str = "cuda"):
    """The dryrun on the initialised default group, or on ``n`` spawned
    ranks of a gloo group when there is none; on the CPU for ``device``
    "cpu", else on the cards (``dryrun``)."""
    on = "cpu" if torch.device(device).type == "cpu" else None
    if dist.is_initialized():
        dryrun(on)
    else:
        spawn(dryrun, n, on)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m raytracer_tpu_torch.parallel.dryrun",
        description="one sharded step of each kind on N ranks")
    p.add_argument("n", nargs="?", type=int, default=8,
                   help="ranks to spawn (ignored under torchrun)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    if "WORLD_SIZE" not in os.environ:
        dryrun_multichip(args.n, args.device)
        return
    prender.init_group(args.device)
    try:
        dryrun_multichip(args.n, args.device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
