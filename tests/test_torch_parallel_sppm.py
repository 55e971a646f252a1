"""The port's sharded SPPM (``raytracer_tpu_torch.parallel.sppm``) on a
gloo group of 2 processes on the CPU, against the port's one-device SPPM
and JAX's ``sppm_iteration_sharded``/``sppm_gather_sharded`` (through its
``render_sppm``) on a (2, 1) mesh of its CPU devices: the cases of the JAX
package's slow-tier ``tests/test_parallel_sppm.py``, small.

The (2, 1) group is spawned once (a module fixture). Renders: Cornell
without its mesh at 16x16, 2 iterations x 4,000 photons, a 4-spp gather,
``REPEATS`` seeds a side, whose linear image means are held within 4
standard errors of their difference, each side's error from the spread
of its renders (SPPM pixels share photons, so pixels are not independent
samples; ``test_torch_media.py::check_linear_means``), plus the gamma bands
of ``test_golden.check_against`` on the seed-pooled images. One render's
linear mean spreads by 3.0% from seed to seed and its gamma mean by 1.4%
(the one-device port, 16 seeds, on the CPU): pooled over 4 seeds a side,
the 5% gamma band stands at 5 standard deviations of the difference. A
gather of one fixed state is pixel-independent: the sharded one is held to
JAX's sharded gather of the same state by the mean per-pixel difference.
"""

import hashlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from raytracer_tpu_torch.models import sppm
from raytracer_tpu_torch.models.sppm import (
    PHOTON_STREAM, SPPMHalf, SPPMState,
)
from raytracer_tpu_torch.ops import dispatch
from raytracer_tpu_torch.parallel import render as prender
from raytracer_tpu_torch.parallel import sppm as psppm
from raytracer_tpu_torch.parallel.dryrun import spawn
from raytracer_tpu_torch.scene import builtin as tbuiltin
from raytracer_tpu_torch.utils import checkpoint as tckpt
from raytracer_tpu_torch.utils.config import RenderConfig, SPPMConfig
from raytracer_tpu_torch.utils.rng import stream_generator
from test_torch_parallel import one_thread  # noqa: F401

W = H = 16
REPEATS = 4
TINY = dict(width=W, height=H, samples_per_pixel=4, spp_chunk=2,
            max_depth=8)
TINY_SPPM = dict(n_iterations=2, photons_per_iter=4000,
                 max_photon_bounces=6, max_camera_bounces=8)
GATHER_SPP = 64
ODD_PHOTONS = 4097


def config() -> RenderConfig:
    return RenderConfig(**TINY, sppm=SPPMConfig(**TINY_SPPM))


def cornell():
    return tbuiltin.cornell_box(1.0, with_mesh=False)


def as_tuple(state: SPPMState) -> tuple:
    return (*state.glob, *state.caustic, int(state.iteration))


def from_tuple(t: tuple) -> SPPMState:
    return SPPMState(SPPMHalf(*t[0:3]), SPPMHalf(*t[3:6]), t[6])


def digest(*grids) -> str:
    h = hashlib.sha256()
    for g in grids:
        for x in g:
            h.update(x.reshape(-1).contiguous().view(torch.uint8).numpy()
                     .tobytes())
    return h.hexdigest()


# -------------------------------------------------------- the spawned ranks

def sppm_rank(out_dir: str):
    """One rank of the (2, 1) group: the grids of iteration 0, the
    deposits of ODD_PHOTONS photons, ``render_sppm`` for every seed (the
    first with a ``checkpoint_cb``) and a GATHER_SPP-spp sharded gather of
    seed 0's state; saved to out_dir/rank{r}.pt."""
    mesh = prender.make_mesh(2, 1, device="cpu")
    rank = dist.get_rank()
    sc = cornell()
    cfg = config()
    tables = dispatch.route_tables(sc, "auto")
    kw = sppm.iteration_kwargs(sc, cfg)
    eps = cfg.spawn_eps_rel * sc.scale
    out = {"grids": digest(*psppm.photon_maps_sharded(
        sc, tables, 0, 0, mesh=mesh, n_photons=4000, max_photon_bounces=6,
        grid_res=kw["grid_res"], spawn_eps=eps))}

    n_local = -(-ODD_PHOTONS // 2)
    dep = sppm.trace_deposits(
        sc, tables, stream_generator("cpu", 0, PHOTON_STREAM, 0, rank),
        n_photons=n_local, max_photon_bounces=6, spawn_eps=eps)
    every = psppm.gather_deposits(dep, ODD_PHOTONS, mesh)
    out["flux"] = (dep.power[:, dep.valid].double().sum().item(),
                   every.power[:, every.valid].double().sum().item(),
                   dep.pos.shape[1], every.pos.shape[1])

    calls = []
    for seed in range(REPEATS):
        img, rays, state = psppm.render_sppm(
            sc, cfg, seed, mesh, checkpoint_cb=None if seed else
            (lambda s: calls.append(as_tuple(s))))
        out[f"img{seed}"] = (img, rays, as_tuple(state))
    out["calls"] = calls
    state = from_tuple(out["img0"][2])
    out["gather"] = psppm.sppm_gather_sharded(
        sc, tables, state, 0, mesh=mesh, width=W, height=H, spp=GATHER_SPP,
        spp_chunk=8, max_depth=8, t_min=cfg.t_min,
        spawn_eps_rel=cfg.spawn_eps_rel,
        n_total_photons=2 * TINY_SPPM["photons_per_iter"])
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("sppm21")
    spawn(sppm_rank, 2, str(d), store_dir=str(d), threads=1)
    return [torch.load(d / f"rank{r}.pt") for r in range(2)]


# --------------------------------------------------------------- helpers

def check_means(ours, ref, tmp_path):
    from test_golden import check_against
    from test_torch_media import check_linear_means
    check_linear_means(ours, ref)
    np.savez(tmp_path / "ref.npz", img=np.mean(ref, 0))
    check_against(str(tmp_path / "ref.npz"), np.mean(ours, 0))


def check_means_1d(a, b):
    a, b = np.asarray(a), np.asarray(b)
    se = np.sqrt(a.var(ddof=1) / a.size + b.var(ddof=1) / b.size)
    assert abs(a.mean() - b.mean()) <= 4 * se + 1e-9, (a, b)


def jax_mesh():
    import jax
    from raytracer_tpu.parallel import render as jprender
    return jprender.make_mesh(n_px=2, n_spp=1, devices=jax.devices()[:2])


def jax_config():
    from raytracer_tpu.utils.config import RenderConfig as JConfig
    from raytracer_tpu.utils.config import SPPMConfig as JSPPMConfig
    return JConfig(**TINY, sppm=JSPPMConfig(**TINY_SPPM))


# ------------------------------------------------------------------ tests

def test_every_rank_builds_the_same_grids_and_image(ranks):
    assert ranks[0]["grids"] == ranks[1]["grids"]
    for seed in range(REPEATS):
        a, b = ranks[0][f"img{seed}"], ranks[1][f"img{seed}"]
        assert torch.equal(a[0], b[0]) and a[1] == b[1]
        assert all(torch.equal(x, y) for x, y in zip(a[2][:6], b[2][:6]))


def test_odd_photon_count_keeps_the_total_flux(ranks):
    """4,097 photons on 2 ranks: each traces 2,049, and the all-gathered
    deposits carry exactly 4,097/4,098 of the flux the ranks deposited,
    in twice one rank's slots."""
    raw = sum(r["flux"][0] for r in ranks)
    for r in ranks:
        _, gathered, local_slots, slots = r["flux"]
        assert slots == 2 * local_slots
        assert gathered == pytest.approx(
            raw * ODD_PHOTONS / (2 * -(-ODD_PHOTONS // 2)), rel=1e-6)
    assert ranks[0]["flux"][1] == ranks[1]["flux"][1]


def test_state_and_image_match_one_device(ranks, tmp_path):
    """The sharded render's images against ``sppm.render``'s, and its
    states' share of pixels touched by a photon alike."""
    ours = [ranks[0][f"img{s}"][0].numpy() for s in range(REPEATS)]
    ref, touched = [], []
    for seed in range(REPEATS):
        img, rays, state = sppm.render(cornell(), config(), seed,
                                       device="cpu")
        assert rays > 0
        ref.append(img.numpy())
        touched.append(float((state.glob.photons > 0).float().mean()))
    check_means(ours, ref, tmp_path)
    ours_t = [float((from_tuple(ranks[0][f"img{s}"][2]).glob.photons > 0)
                    .float().mean()) for s in range(REPEATS)]
    check_means_1d(ours_t, touched)


def test_state_and_image_match_jax_sharded(ranks, tmp_path):
    """Against JAX's ``render_sppm`` on a (2, 1) mesh of its CPU devices
    (its ``sppm_iteration_sharded`` and ``sppm_gather_sharded``)."""
    import jax
    from raytracer_tpu.parallel.sppm import render_sppm
    from raytracer_tpu.scene import builtin as jbuiltin
    js = jbuiltin.cornell_box(1.0, with_mesh=False)
    mesh, cfg = jax_mesh(), jax_config()
    ref, touched = [], []
    for seed in range(REPEATS):
        img, _, state = render_sppm(js, cfg, jax.random.PRNGKey(seed),
                                    mesh=mesh)
        ref.append(np.asarray(img))
        touched.append(float((np.asarray(state.glob.photons) > 0).mean()))
    check_means([ranks[0][f"img{s}"][0].numpy() for s in range(REPEATS)],
                ref, tmp_path)
    check_means_1d([float((from_tuple(ranks[0][f"img{s}"][2]).glob.photons
                           > 0).float().mean()) for s in range(REPEATS)],
                   touched)


def test_sharded_gather_of_a_state_matches_jax(ranks, tmp_path):
    """JAX's ``sppm_gather_sharded`` on (2, 1), given the port's state,
    against the port's sharded gather of it, and the one-device port's
    ``gather_fn``: the mean per-pixel difference within 4 standard
    errors and the gamma bands."""
    import jax
    import jax.numpy as jnp
    from raytracer_tpu.models import sppm as jsppm
    from raytracer_tpu.parallel.sppm import sppm_gather_sharded
    from raytracer_tpu.scene import builtin as jbuiltin
    from test_golden import check_against
    t = ranks[0]["img0"][2]
    jstate = jsppm.SPPMState(
        jsppm.SPPMHalf(*(jnp.asarray(x.numpy()) for x in t[0:3])),
        jsppm.SPPMHalf(*(jnp.asarray(x.numpy()) for x in t[3:6])),
        jnp.int32(t[6]))
    common = dict(width=W, height=H, spp=GATHER_SPP, spp_chunk=8,
                  max_depth=8, t_min=1e-3, spawn_eps_rel=1e-5,
                  n_total_photons=2 * TINY_SPPM["photons_per_iter"])
    ref, jrays = sppm_gather_sharded(
        jbuiltin.cornell_box(1.0, with_mesh=False), jstate,
        jax.random.PRNGKey(0), mesh=jax_mesh(), **common)
    sc = cornell()
    one, _ = sppm.gather_fn(sc, dispatch.route_tables(sc, "auto"),
                            from_tuple(t), torch.Generator().manual_seed(5),
                            **common)
    ours, rays = ranks[0]["gather"]
    assert ours.shape == (H, W, 3) and torch.isfinite(ours).all()
    assert rays > 0 and int(jrays) > 0
    for i, other in enumerate((np.asarray(ref), one.numpy())):
        d = (ours.numpy() - other).mean(-1).ravel()
        assert abs(d.mean()) < 4 * d.std(ddof=1) / np.sqrt(d.size)
        np.savez(tmp_path / f"ref{i}.npz", img=other)
        check_against(str(tmp_path / f"ref{i}.npz"), ours.numpy())


def test_checkpoint_cb_gets_the_whole_state(ranks):
    """``render_sppm`` calls ``checkpoint_cb`` after every iteration with
    the whole state (every pixel, gathered from the shards); the last
    call's is the state it returns."""
    calls = ranks[0]["calls"]
    assert [c[6] for c in calls] == [1, 2]
    for c in calls:
        assert c[0].shape == (W * H, 3) and c[1].shape == (W * H,)
    final = ranks[0]["img0"][2]
    assert all(torch.equal(x, y) for x, y in zip(calls[-1][:6], final[:6]))
    assert all(torch.equal(x, y) for x, y in
               zip(ranks[1]["calls"][0][:6], calls[0][:6]))


def test_sharded_checkpoint_resumes_in_the_one_device_port(ranks, tmp_path):
    """The state a sharded render wrote after its first iteration, saved
    in the JAX npz format, resumes in ``sppm.render``: one more
    iteration, then a finite gather."""
    path = str(tmp_path / "sharded.npz")
    tckpt.save_state(path, from_tuple(ranks[0]["calls"][0]), 0)
    state, seed = tckpt.load_state(path)
    assert state.iteration == 1 and seed == 0
    img, rays, final = sppm.render(cornell(), config(), seed, state=state,
                                   device="cpu")
    assert final.iteration == 2 and rays > 0
    assert torch.isfinite(img).all() and img.mean() > 0
    # a pixel's photon count never falls (photon_mapper.rs:55-62)
    assert (final.glob.photons >= state.glob.photons).all()


def test_sppm_mesh_must_have_one_spp_rank():
    mesh = prender.Mesh(1, 2, 0, 0, torch.device("cpu"), None)
    with pytest.raises(ValueError, match=r"\(n, 1\) mesh"):
        psppm.render_sppm(cornell(), config(), 0, mesh)
