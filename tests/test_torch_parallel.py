"""The port's sharded path tracer (``raytracer_tpu_torch.parallel.render``)
on gloo groups of 2-4 processes on the CPU, against the port's one-device
render and JAX's ``parallel.render.render`` on a (2, 1) mesh of its CPU
devices: the cases of the JAX package's slow-tier ``tests/test_parallel.py``,
small.

Each group size is spawned once, its mesh shapes made in turn in the same
processes (the (2, 1) and (1, 2) meshes share a module fixture); every
rank renders a list of cases on each mesh and saves them, and the tests
read rank 0's (every rank must hold the same image). Exact checks rebuild a sharded image in this process
from each rank's shard rendered alone with that rank's generator; images
from other streams are held to 4 standard errors of the mean per-pixel
difference of seed-pooled renders (pixels are independent samples), plus
the gamma bands of ``test_golden.check_against``.

Cornell without its mesh at 16x12, 256 spp, depth 8: one render's linear
mean spreads by 4.5% from seed to seed and its gamma mean by 1.4% (the
port, 8 seeds, on the CPU), so 4 seeds a side keep the 5% gamma band wide
of the noise.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from raytracer_tpu_torch.models import path_tracer
from raytracer_tpu_torch.models import wavefront_soa as twf
from raytracer_tpu_torch.ops import dispatch
from raytracer_tpu_torch.ops.fused_bounce import has_media
from raytracer_tpu_torch.parallel import render as prender
from raytracer_tpu_torch.parallel.dryrun import spawn
from raytracer_tpu_torch.scene import builtin as tbuiltin
from raytracer_tpu_torch.utils.config import RenderConfig
from raytracer_tpu_torch.utils.rng import stream_generator

ROOT = os.path.join(os.path.dirname(__file__), "..")
W, H = 16, 12
PT = dict(width=W, height=H, samples_per_pixel=256, spp_chunk=64,
          max_depth=8)
# 24 pixels wide: two 16x16 blocks a row, so ``block_order`` permutes
SMALL = dict(width=24, height=12, samples_per_pixel=16, spp_chunk=4,
             max_depth=6)
SEEDS = range(4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread in this process while the module runs, as in its
    spawned ranks: under xdist the workers already fill the cores, and a
    thread pool whose threads are descheduled waits on them at every
    operation (a 1 s check took 100 s so on 6 workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene(name: str, kw: dict):
    """The scene of a case, at its config's aspect ratio."""
    aspect = kw["width"] / kw["height"]
    if name == "cornell":
        return tbuiltin.cornell_box(aspect, with_mesh=False)
    if name == "spheres":
        return tbuiltin.three_spheres(aspect)
    if name == "smoke":
        return tbuiltin.cornell_smoke(aspect)
    motion = tbuiltin.motion_field(64, aspect_ratio=aspect)
    if name == "frozen":           # the shutter closed at its opening
        cam = motion.camera
        return motion._replace(camera=cam._replace(time1=cam.time0))
    return motion


# -------------------------------------------------------- the spawned ranks

def render_cases(out_dir: str, meshes: dict):
    """On each rank: for each mesh {(n_px, n_spp): cases}, in turn, every
    case {name: (scene, config kwargs, seed)} through
    ``parallel.render.render``; rank r saves {name: (image, rays, shadow
    rays)} to out_dir/rank{r}.pt."""
    out = {}
    for (n_px, n_spp), cases in meshes.items():
        mesh = prender.make_mesh(n_px, n_spp, device="cpu")
        for name, (scene_name, kw, seed) in cases.items():
            stats = {}
            img, rays = prender.render(scene(scene_name, kw),
                                       RenderConfig(**kw), seed, mesh,
                                       stats=stats)
            out[name] = (img, rays, stats["shadow_lanes"])
    torch.save(out, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))


def run_mesh(tmp_path_factory, meshes: dict) -> dict:
    """Spawn one gloo group (one thread a rank) that renders each mesh's
    cases ({(n_px, n_spp): cases}, every mesh of the group's size);
    returns rank 0's results after checking that every rank holds the
    same."""
    n_px, n_spp = next(iter(meshes))
    n = n_px * n_spp
    d = tmp_path_factory.mktemp(f"ranks{n}")
    spawn(render_cases, n, str(d), meshes, store_dir=str(d), threads=1)
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(n)]
    for other in ranks[1:]:
        for name, (img, rays, shadow) in ranks[0].items():
            assert torch.equal(other[name][0], img), name
            assert other[name][1:] == (rays, shadow), name
    return ranks[0]


# ----------------------------------------------------- rebuilt in-process

def shard_alone(scene_name: str, kw: dict, seed: int, n_px: int, n_spp: int,
                px_i: int, spp_i: int):
    """Rank (px_i, spp_i)'s shard rendered alone, with its generator and
    its pixels: (radiance sum in slot or id order, rays)."""
    cfg = RenderConfig(**kw)
    w, h = cfg.width, cfg.height
    sc = scene(scene_name, kw)
    method = path_tracer.resolve_route(sc, cfg.intersector, cfg.nee,
                                       cfg.mis)
    mesh = prender.Mesh(n_px, n_spp, px_i, spp_i, torch.device("cpu"), None)
    chunk, n_chunks = prender.samples(cfg.samples_per_pixel, cfg.spp_chunk,
                                      n_spp)
    gen = stream_generator("cpu", seed, px_i, spp_i)
    tables = dispatch.route_tables(sc, method)
    rkw = dict(width=w, height=h, max_depth=cfg.max_depth, t_min=cfg.t_min,
               spawn_eps=cfg.spawn_eps_rel * sc.scale,
               russian_roulette=cfg.russian_roulette, nee=cfg.nee,
               mis=cfg.mis, intersector=method)
    if method in ("pallas", "leaf") and not has_media(sc):
        slots, _ = prender.block_slots(w, h, mesh)
        accum, rays, _ = twf.render_regen_soa(
            sc, tables, gen, lanes_per_pixel=chunk,
            samples_per_lane=n_chunks, pixel_slots=slots, **rkw)
    else:
        lo, n_local = prender.pixel_shard(w * h, n_px, px_i)
        accum, rays = path_tracer.render_chunks(
            sc, gen, torch.arange(lo, lo + n_local), spp_chunk=chunk,
            n_chunks=n_chunks, tables=tables, **rkw)
    return accum, rays, chunk * n_chunks * n_spp


def check_rebuilt(result, case, n_px: int, n_spp: int):
    """The sharded image and rays equal those rebuilt from every rank's
    shard rendered alone: the spp partials summed, the px shards joined,
    unpermuted (block order) or cut at the image (contiguous ids)."""
    scene_name, kw, seed = case
    rows, rays = [], 0
    for px_i in range(n_px):
        acc = 0
        for spp_i in range(n_spp):
            a, r, n_samples = shard_alone(scene_name, kw, seed, n_px, n_spp,
                                          px_i, spp_i)
            acc, rays = acc + a, rays + r
        rows.append(acc)
    full = torch.cat(rows)
    w, h = kw["width"], kw["height"]
    sc = scene(scene_name, kw)
    if dispatch.route(sc, kw.get("intersector", "auto")) in (
            "pallas", "leaf") and not has_media(sc):
        _, inv = twf.block_order(w, h)
        full = full[torch.as_tensor(inv).long()]
    else:
        full = full[:w * h]
    img = (full / n_samples).reshape(h, w, 3)
    torch.testing.assert_close(result[0], img, rtol=1e-5, atol=1e-7)
    assert result[1] == rays


# ------------------------------------------------------------- statistics

def check_pooled(ours, ref, tmp_path):
    """Seed-pooled images: the mean per-pixel difference within 4 of its
    standard errors, and ``test_golden.check_against``'s gamma bands."""
    from test_golden import check_against
    a, b = np.mean(ours, 0), np.mean(ref, 0)
    d = (a - b).mean(-1).ravel()
    se = d.std(ddof=1) / np.sqrt(d.size)
    assert abs(d.mean()) < 4 * se, (a.mean(), b.mean(), se)
    np.savez(tmp_path / "ref.npz", img=b)
    check_against(str(tmp_path / "ref.npz"), a)


def one_device(scene_name: str, kw: dict, seeds) -> list:
    return [path_tracer.render(scene(scene_name, kw), RenderConfig(**kw), s,
                               device="cpu")[0].numpy() for s in seeds]


# ------------------------------------------------------------------ tests

def test_pixel_slots_of_the_whole_permutation_change_nothing():
    """``render_regen_soa`` and ``gather_regen_soa`` given the whole
    ``block_order`` permutation as ``pixel_slots`` (output and estimates
    in slot order) equal the calls without it, bit for bit."""
    sc = scene("spheres", SMALL)
    tables = dispatch.route_tables(sc, "pallas")
    w, h = SMALL["width"], SMALL["height"]
    perm, inv = twf.block_order(w, h)
    assert (perm != np.arange(w * h)).any()
    inv = torch.as_tensor(inv).long()
    kw = dict(width=w, height=h, lanes_per_pixel=2, samples_per_lane=3,
              max_depth=6, t_min=1e-3, spawn_eps=1e-5 * sc.scale)
    a, ra, sa = twf.render_regen_soa(sc, tables, torch.Generator().manual_seed(
        3), **kw)
    b, rb, sb = twf.render_regen_soa(sc, tables, torch.Generator().manual_seed(
        3), pixel_slots=torch.as_tensor(perm), **kw)
    assert torch.equal(a, b[inv]) and (ra, sa) == (rb, sb)
    est = torch.rand((w * h, 3), generator=torch.Generator().manual_seed(1))
    a, ra, _ = twf.gather_regen_soa(sc, tables, est,
                                    torch.Generator().manual_seed(4), **kw)
    b, rb, _ = twf.gather_regen_soa(
        sc, tables, est[torch.as_tensor(perm).long()],
        torch.Generator().manual_seed(4), pixel_slots=perm, **kw)
    assert torch.equal(a, b[inv]) and ra == rb


MESH12 = {"spp_axis": ("cornell", SMALL, 9)}
MESH21 = {
    **{f"cornell{s}": ("cornell", PT, s) for s in SEEDS},
    "motion": ("motion", SMALL, 5),
    "frozen": ("frozen", SMALL, 5),
    "pt": ("spheres", SMALL, 6),
    "mis": ("spheres", {**SMALL, "mis": True}, 6),
    "no_rr": ("spheres", {**SMALL, "russian_roulette": False}, 6),
    "nee": ("spheres", {**SMALL, "nee": True}, 6),
    "smoke": ("smoke", SMALL, 7),
    "bruteforce": ("cornell", {**SMALL, "intersector": "bruteforce"}, 8),
}


@pytest.fixture(scope="module")
def mesh21(tmp_path_factory):
    """Two ranks: the (2, 1) cases, then the (1, 2) ones."""
    return run_mesh(tmp_path_factory, {(2, 1): MESH21, (1, 2): MESH12})


def test_mesh21_matches_one_device_render(mesh21, tmp_path):
    ours = [mesh21[f"cornell{s}"][0].numpy() for s in SEEDS]
    for img in ours:
        assert img.shape == (H, W, 3) and np.isfinite(img).all()
    check_pooled(ours, one_device("cornell", PT, SEEDS), tmp_path)


def test_mesh21_matches_jax_sharded_render(mesh21, tmp_path):
    """Against JAX's ``parallel.render.render`` on a (2, 1) mesh of two
    of its CPU devices."""
    import jax
    from raytracer_tpu.parallel import render as jprender
    from raytracer_tpu.scene import builtin as jbuiltin
    from raytracer_tpu.utils.config import RenderConfig as JConfig
    mesh = jprender.make_mesh(n_px=2, n_spp=1, devices=jax.devices()[:2])
    js = jbuiltin.cornell_box(W / H, with_mesh=False)
    ref = [np.asarray(jprender.render(js, JConfig(**PT),
                                      jax.random.PRNGKey(s), mesh)[0])
           for s in SEEDS]
    check_pooled([mesh21[f"cornell{s}"][0].numpy() for s in SEEDS], ref,
                 tmp_path)


def test_mesh21_motion_draws_shutter_times(mesh21, tmp_path):
    """motion_field(64) on the mesh rides the motion regen loop with a
    shutter time per sample: its image agrees with the one-device render
    and differs from the frozen shutter's."""
    img, rays, _ = mesh21["motion"]
    frozen = mesh21["frozen"][0]
    assert rays > 0 and torch.isfinite(img).all()
    assert (img - frozen).abs().mean() > 0.05 * img.mean()
    ref = one_device("motion", SMALL, [0])[0]
    d = (img.numpy() - ref).mean(-1).ravel()
    assert abs(d.mean()) < 4 * d.std(ddof=1) / np.sqrt(d.size)


def test_mesh21_options_reach_the_ranks(mesh21):
    """``mis`` and ``russian_roulette`` reach every rank (JAX's sharded
    render drops both): on three_spheres MIS traces more rays than plain
    PT (~22% on the CPU), RR off more than RR on, and each image is the
    one rebuilt from shards rendered alone with the option; NEE casts
    shadow rays, summed over the ranks."""
    rays = {k: mesh21[k][1] for k in ("pt", "mis", "no_rr", "nee")}
    assert rays["mis"] > rays["pt"] and rays["no_rr"] > rays["pt"], rays
    assert mesh21["pt"][2] == 0 and mesh21["nee"][2] > 0
    for k in ("mis", "no_rr", "nee"):
        assert torch.isfinite(mesh21[k][0]).all()
    for k in ("mis", "no_rr"):
        check_rebuilt(mesh21[k], MESH21[k], 2, 1)


@pytest.mark.parametrize("name", ["smoke", "bruteforce"])
def test_mesh21_chunk_loop_rebuilds(mesh21, name):
    """Media and the brute-force route take the chunk loop over
    contiguous pixel ids: the image is the ranks' shards rendered alone."""
    check_rebuilt(mesh21[name], MESH21[name], 2, 1)


def test_mesh12_sums_the_spp_axis(mesh21):
    """(1, 2), on the two ranks of the (2, 1) cases: the image is the mean
    of the two ranks' partials (every pixel, half the samples each)
    rendered alone with the same generators, and the rays their sum."""
    check_rebuilt(mesh21["spp_axis"], MESH12["spp_axis"], 1, 2)


def test_three_ranks_pad_pixels_that_do_not_divide(tmp_path_factory):
    """3 ranks on 17x11 (187 pixels, padded to 189 with pixel 186 again):
    both the block-order shards and the chunk loop's contiguous ids give
    the image rebuilt from the shards, the padded slots dropped."""
    cases = {"spheres": ("spheres", {**SMALL, "width": 17, "height": 11},
                         10),
             "bruteforce": ("spheres", {**SMALL, "width": 17, "height": 11,
                                        "intersector": "bruteforce"}, 11)}
    res = run_mesh(tmp_path_factory, {(3, 1): cases})
    for name, case in cases.items():
        assert res[name][0].shape == (11, 17, 3)
        check_rebuilt(res[name], case, 3, 1)


def test_mesh22_rebuilds(tmp_path_factory):
    """A (2, 2) mesh: two px shards, each summed over two spp ranks."""
    cases = {"spheres": ("spheres", SMALL, 12)}
    res = run_mesh(tmp_path_factory, {(2, 2): cases})
    assert torch.isfinite(res["spheres"][0]).all()
    check_rebuilt(res["spheres"], cases["spheres"], 2, 2)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        prender.make_mesh(device="cpu")


def test_init_group_refuses_cuda_without_a_card(monkeypatch):
    """``--device cuda`` with no card fails before any group starts: no
    fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prender.init_group("cuda")
    assert not dist.is_initialized()


def test_dryrun_twin_on_two_ranks():
    """``--device cpu`` runs every rank on the CPU (the default is the
    card); one thread a rank."""
    res = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch.parallel.dryrun", "2",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    assert "dryrun_multichip ok: gloo on cpu, mesh=(1, 2)" in res.stdout
