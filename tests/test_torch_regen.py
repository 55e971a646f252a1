"""The port's one-kernel regeneration step (``raytracer_tpu_torch.ops.regen``:
``regen_step_plain``, the plain twin of ``csrc/regen.cu`` and
``csrc/regen_ordered.cu``) against the JAX package's Pallas
``regen_step_fused``, run as the JAX tests run it on the CPU (interpret
mode), and the route that takes it (``render_regen_soa`` without NEE, MIS
or a density estimate) against the loop's own step.

The same lane state, made with numpy from a seed, goes through both
packages: JAX takes alive, depth and done as f32 rows and a ``uni2`` with
the spawn offset in row 3; the port takes bool and int32 and the loop's
(8, n) draw with the offset as one float. The state covers respawning
lanes, lanes that run out of their quota and Russian roulette.

Tolerances, those of ``test_torch_bounce.py`` on the bounce inside the
step:
- the interaction agrees on >= 99.9% of the alive lanes (JAX's and the
  port's ``bounce_fused`` on the same rays); the rest are float32
  decision edges, left out below;
- where it agrees: o to atol 1e-5 * scale (the point tolerance), d to
  rtol = atol = 1e-4 plus 8 |dp| / r (a sphere normal's point error, as
  nd), tput, samp and acc to rtol = atol = 1e-4, and alive, depth and done
  equal, except on a lane whose hit point lies within the point tolerance
  of a checker edge (the texture pick may flip) or whose RR uniform lies
  within 1e-6 of its survival probability.
The ordered step and the one-kernel route are held to the loop's own
step bit for bit: both are plain PyTorch here, with the same operations.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from raytracer_tpu.ops import pallas_intersect  # noqa: E402
from raytracer_tpu.scene import builtin as jbuiltin  # noqa: E402
from raytracer_tpu.scene.types import INTER_ABSORB, PRIM_SPHERE  # noqa
from raytracer_tpu_torch.models import path_tracer as tpt  # noqa: E402
from raytracer_tpu_torch.models import wavefront_soa as twf  # noqa: E402
from raytracer_tpu_torch.ops import fused_bounce, leaf, ordered, regen  # noqa
from raytracer_tpu_torch.scene import builtin as tbuiltin  # noqa: E402
from raytracer_tpu_torch.scene.convert import scene_from_numpy  # noqa: E402
from test_golden import check_against  # noqa: E402
from test_torch_bounce import SCENES, make_rays  # noqa: E402
from test_torch_render import GOLDEN_CFG  # noqa: E402

T_MIN = 1e-3
W, H = 64, 48                 # make_rays' image
QUOTA, MAX_DEPTH = 3, 6
RR_START = twf.RR_START_BOUNCE


def make_lanes(jscene, seed, n=2048):
    """``make_rays``' rays, alive mask and scatter rows, then the rest of
    a lane's state: throughput 0.02-1 (below and above RR's 0.05 floor),
    depth 0 to MAX_DEPTH - 1, done 0 to QUOTA - 1 (QUOTA on dead lanes:
    past their quota), random radiance and pixels. Returns numpy arrays:
    o, d, tput, samp, acc (3, n), alive (n,) bool, depth, done (n,) int32,
    px, py (n,) f32, U (8, n) and the spawn offset."""
    o, d, alive, uni = make_rays(jscene, seed, n)
    rng = np.random.default_rng(100 + seed)
    f32 = np.float32
    tput = rng.uniform(0.02, 1.0, (3, n)).astype(f32)
    samp = rng.uniform(0.0, 2.0, (3, n)).astype(f32)
    acc = rng.uniform(0.0, 5.0, (3, n)).astype(f32)
    depth = rng.integers(0, MAX_DEPTH, n).astype(np.int32)
    done = np.where(alive, rng.integers(0, QUOTA, n), QUOTA).astype(np.int32)
    px = rng.integers(0, W, n).astype(f32)
    py = rng.integers(0, H, n).astype(f32)
    U = np.concatenate([uni[:3], rng.random((5, n), dtype=f32)], 0)
    return dict(o=o, d=d, tput=tput, samp=samp, acc=acc, alive=alive,
                depth=depth, done=done, px=px, py=py, U=U), float(uni[3, 0])


def port_lanes(st):
    t = {k: torch.from_numpy(v) for k, v in st.items() if k != "U"}
    n = t["alive"].shape[0]
    return twf._Lanes(t["o"], t["d"], t["tput"], t["samp"], t["acc"],
                      t["alive"], t["depth"], t["done"], t["px"], t["py"],
                      torch.arange(n), torch.zeros(n, dtype=torch.bool))


def port_step(tab, tscene, st, eps, rr_on):
    return regen.regen_step_plain(
        tab, regen.pack_camera(tscene.camera), torch.from_numpy(st["U"]),
        eps, port_lanes(st), width=W, height=H, quota=QUOTA,
        max_depth=MAX_DEPTH, rr_on=rr_on, rr_start=RR_START, t_min=T_MIN)


def jax_step(jscene, st, eps, rr_on):
    n = st["alive"].shape[0]
    uni2 = np.concatenate([st["U"][:3], np.full((1, n), eps, np.float32),
                           st["U"][3:]], 0)
    f = np.float32
    out = pallas_intersect.regen_step_fused(
        jscene, *(jnp.asarray(st[k]) for k in ("o", "d")), T_MIN,
        jnp.asarray(st["alive"].astype(f)), jnp.asarray(uni2),
        *(jnp.asarray(st[k]) for k in ("px", "py", "tput", "samp", "acc")),
        jnp.asarray(st["depth"].astype(f)), jnp.asarray(st["done"].astype(f)),
        width=W, height=H, quota=QUOTA, max_depth=MAX_DEPTH, rr_on=rr_on,
        rr_start=RR_START)
    o, d, tput, samp, acc, alive, depth, done = (np.asarray(x) for x in out)
    return dict(o=o, d=d, tput=tput, samp=samp, acc=acc, alive=alive[0] > 0,
                depth=depth[0].astype(np.int32), done=done[0].astype(np.int32))


def bounces(jscene, tscene, st, eps):
    """The interaction, hit point and winner of both packages' bounce on
    the step's rays (the bounce inside the step)."""
    uni = np.concatenate([st["U"][:3], np.full((1, st["U"].shape[1]), eps,
                                               np.float32)], 0)
    jb = pallas_intersect.bounce_fused(
        jscene, jnp.asarray(st["o"]), jnp.asarray(st["d"]), T_MIN,
        jnp.asarray(st["alive"]), jnp.asarray(uni))
    tab = fused_bounce.pack_tables(tscene)
    args = (torch.from_numpy(st["o"]), torch.from_numpy(st["d"]))
    tb = fused_bounce.bounce_fused(tscene, *args, T_MIN,
                                   torch.from_numpy(st["alive"]),
                                   torch.from_numpy(uni))
    _, ty, ix, _, _ = fused_bounce._closest_plain(
        tab, *args, T_MIN, torch.from_numpy(st["alive"]))
    return (np.asarray(jb[0]), tb[0].numpy(), np.asarray(jb[5]),
            tb[5].numpy(), tb[3].numpy(), ty.numpy(), ix.numpy())


CASES = {"three_spheres": True, "cornell_mesh": False, "scene_500": True}


@pytest.mark.parametrize("name", sorted(CASES))
def test_regen_step_matches_jax(name):
    rr_on = CASES[name]
    jscene, tscene = SCENES[name][0](), SCENES[name][1]()
    st, eps = make_lanes(jscene, sorted(CASES).index(name))
    out = port_step(fused_bounce.pack_tables(tscene), tscene, st, eps,
                    rr_on)
    t = {k: getattr(out, k).numpy() for k in
         ("o", "d", "tput", "samp", "acc", "alive", "depth", "done")}
    j = jax_step(jscene, st, eps, rr_on)
    j_inter, t_inter, j_p, t_p, t_att, ty, ix = bounces(jscene, tscene, st,
                                                        eps)
    alive = st["alive"]
    agree = (j_inter == t_inter) & alive
    assert agree.sum() >= 0.999 * alive.sum()

    # the state covers what the step does
    regen_ = alive & (t["done"] > st["done"]) & t["alive"]
    assert regen_.sum() >= 20, "respawning lanes"
    assert (alive & (t["done"] == QUOTA) & (st["done"] == QUOTA - 1)).sum() \
        >= 20, "lanes that run out of their quota"
    tput1 = np.where(t_inter != INTER_ABSORB, st["tput"] * t_att, st["tput"])
    p_surv = np.clip(tput1.max(0), 0.05, 1.0)
    do_rr = rr_on & (st["depth"] >= RR_START)
    if rr_on:
        killed = alive & (t_inter != INTER_ABSORB) & do_rr & \
            (st["U"][regen.U_RR] >= p_surv)
        assert killed.sum() >= 20, "Russian roulette kills"
    assert len(np.unique(t_inter[alive])) >= 2

    scale = float(np.asarray(jscene.scale))
    p_tol = 1e-5 * scale
    checker = np.abs(np.sin(10.0 * j_p.astype(np.float64))).min(0) \
        < 10.0 * p_tol
    rr_edge = do_rr & (np.abs(st["U"][regen.U_RR] - p_surv) < 1e-6)
    held = agree & ~checker & ~rr_edge
    for k in ("alive", "depth", "done"):
        bad = held & (t[k] != j[k])
        assert not bad.any(), f"{k} differs on lanes {np.where(bad)[0][:8]}"
    # dead lanes: the step only counts their depth
    dead = ~alive
    for k in ("o", "d", "tput", "samp", "acc"):
        np.testing.assert_array_equal(t[k][:, dead], st[k][:, dead])
        np.testing.assert_array_equal(j[k][:, dead], st[k][:, dead])
    np.testing.assert_array_equal(t["depth"][dead], st["depth"][dead] + 1)

    def off(a, b, slack=0.0):
        return (np.abs(a - b) > 1e-4 + 1e-4 * np.abs(b) + slack).any(0)

    np.testing.assert_allclose(t["o"][:, agree], j["o"][:, agree], rtol=0,
                               atol=p_tol, err_msg="o")
    radius = tscene.spheres.radius.numpy()
    r_win = np.where(ty == PRIM_SPHERE,
                     radius[np.clip(ix, 0, max(len(radius) - 1, 0))]
                     if len(radius) else np.inf, np.inf)
    dp = np.abs(t_p - j_p).max(0) / r_win
    bad_d = agree & off(t["d"], j["d"], 8.0 * dp)
    assert not bad_d.any(), f"d differs on lanes {np.where(bad_d)[0][:8]}"
    for k in ("tput", "samp", "acc"):
        bad = held & off(t[k], j[k])
        assert not bad.any(), f"{k} differs on lanes {np.where(bad)[0][:8]}"


@pytest.fixture(scope="module")
def field():
    """sphere_field(8192): ordered tables (the walk) and flat ones."""
    ts = scene_from_numpy(jbuiltin.sphere_field(8192))
    tab = fused_bounce.pack_tables(ts)
    assert tab.osph is not None
    return ts, tab, fused_bounce.pack_tables(ts, order=False)


def test_ordered_regen_step_equals_flat(field):
    """The ordered step (the walk) equals the flat step on every lane, as
    ``test_torch_ordered.py`` holds the walks, and really walks."""
    ts, tab, flat = field
    st, eps = make_lanes(jbuiltin.sphere_field(8192), 7, n=1024)
    stats = torch.zeros((1024 // ordered.GROUP, 2), dtype=torch.int32)
    kw = dict(width=W, height=H, quota=QUOTA, max_depth=MAX_DEPTH,
              rr_on=True, rr_start=RR_START, t_min=T_MIN)
    cam, U = regen.pack_camera(ts.camera), torch.from_numpy(st["U"])
    walk = regen.regen_step_tables(tab, cam, U, eps, port_lanes(st),
                                   stats=stats, **kw)
    sweep = regen.regen_step_tables(flat, cam, U, eps, port_lanes(st), **kw)
    for k in ("o", "d", "tput", "samp", "acc", "alive", "depth", "done"):
        assert torch.equal(getattr(walk, k), getattr(sweep, k)), k
    assert 0 < stats[:, 0].max() < tab.osph.cull.shape[0]
    assert (walk.done > torch.from_numpy(st["done"])).any()


def _spy(monkeypatch):
    """Count the loop's calls of the one-kernel step."""
    calls = []
    real = regen.regen_step_tables

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(regen, "regen_step_tables", spy)
    return calls


def _render(scene, seed, tables=None, **kw):
    stats = {}
    base = dict(width=16, height=16, spp=8, spp_chunk=2, max_depth=8,
                t_min=T_MIN, spawn_eps_rel=1e-5)
    img, rays = tpt.render_fn(scene, torch.Generator().manual_seed(seed),
                              device="cpu", tables=tables, stats=stats,
                              **{**base, **kw})
    return img, rays, stats["steps"]


@pytest.mark.parametrize("name", ["three_spheres", "cornell_mesh",
                                  "field_drain"])
def test_one_kernel_route_equals_loop(name, monkeypatch, field):
    """The render through the one-kernel step against the same render
    through the loop's own step (``wavefront_soa._ONE_KERNEL_STEP``, the
    test hook) at the same seed: the same image bit for bit, rays and
    steps; the field through the ordered tables and the drain cascade
    (three levels)."""
    kw = {}
    if name == "three_spheres":
        scene = tbuiltin.three_spheres(1.0)
    elif name == "cornell_mesh":
        scene = tbuiltin.cornell_box(1.0, with_mesh=True)
    else:
        scene = field[0]
        kw = dict(spp=4, spp_chunk=4, tables=field[1])
        monkeypatch.setattr(twf, "DRAIN_MIN_LANES", 128)
        assert len(twf._drain_sizes(16 * 16 * 4)) == 3
    calls = _spy(monkeypatch)
    img, rays, steps = _render(scene, 5, **kw)
    assert len(calls) == steps > 0
    monkeypatch.setattr(twf, "_ONE_KERNEL_STEP", False)
    ref, ref_rays, ref_steps = _render(scene, 5, **kw)
    assert len(calls) == steps
    assert (rays, steps) == (ref_rays, ref_steps)
    assert torch.equal(img, ref)
    assert img.mean() > 0


def test_one_kernel_route_golden(monkeypatch):
    """A 32x32 ``three_spheres`` render, which takes the one-kernel step,
    lies within the ``three_spheres_32.npz`` bands."""
    calls = _spy(monkeypatch)
    img, rays = tpt.render(tbuiltin.three_spheres(1.0), GOLDEN_CFG, 5,
                           device="cpu")
    assert calls and rays > 32 * 32 * 64
    check_against("three_spheres_32.npz", img.numpy())


def _leaf_scene():
    scene = tbuiltin.three_spheres(1.0)
    return scene._replace(leaf=leaf.build_leaf_tables(scene))


ROUTES = {"plain": dict(), "nee": dict(nee=True), "mis": dict(mis=True),
          "leaf": dict(intersector="leaf")}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("rr", [True, False])
def test_route_takes_the_one_kernel_step(route, rr, monkeypatch):
    """Every step of the plain fused route is one ``regen_step_tables``
    call, with Russian roulette on or off; NEE, MIS and the unfused leaf
    route keep the loop's own step, as JAX's route does."""
    scene = _leaf_scene() if route == "leaf" else tbuiltin.three_spheres(1.0)
    calls = _spy(monkeypatch)
    _, _, steps = _render(scene, 2, spp=2, max_depth=4, russian_roulette=rr,
                          **ROUTES[route])
    assert steps > 0
    assert len(calls) == (steps if route == "plain" else 0)


def test_sppm_gather_never_takes_the_route(monkeypatch):
    """The SPPM gather (a density estimate per lane) keeps the loop's own
    step."""
    scene = tbuiltin.cornell_box(1.0, with_mesh=True)
    tab = fused_bounce.pack_tables(scene)
    est = torch.full((8 * 8, 3), 0.1)
    kw = dict(width=8, height=8, lanes_per_pixel=1, samples_per_lane=2,
              max_depth=4, t_min=T_MIN, spawn_eps=1e-5 * scene.scale)
    calls = _spy(monkeypatch)
    img, rays, steps = twf.gather_regen_soa(scene, tab, est,
                                            torch.Generator(), **kw)
    assert steps > 0 and not calls
    assert torch.isfinite(img).all() and img.mean() > 0


def test_pack_camera_matches_jax():
    """The camera vector is JAX ``pack_camera``'s column, and unpacks to
    the camera it came from."""
    for name in sorted(SCENES):
        jscene, tscene = SCENES[name][0](), SCENES[name][1]()
        cam = regen.pack_camera(tscene.camera)
        assert cam.shape == (regen.CAM_WIDTH,) and cam.dtype == torch.float32
        np.testing.assert_array_equal(
            cam.numpy(), np.asarray(pallas_intersect.pack_camera(
                jscene.camera))[:, 0])
        back = regen.unpack_camera(cam)
        for f in ("origin", "lower_left_corner", "horizontal", "vertical",
                  "u", "v", "lens_radius"):
            assert torch.equal(getattr(back, f),
                               getattr(tscene.camera, f).float()), f


def test_regen_step_refuses_other_devices():
    st, eps = make_lanes(SCENES["three_spheres"][0](), 0, n=64)
    lanes = port_lanes(st)
    lanes = lanes._replace(o=lanes.o.to("meta"))
    with pytest.raises(NotImplementedError, match="meta"):
        regen.regen_step_tables(
            fused_bounce.pack_tables(tbuiltin.three_spheres()),
            torch.zeros(32), torch.from_numpy(st["U"]), eps, lanes, width=W,
            height=H, quota=QUOTA, max_depth=MAX_DEPTH, rr_on=True,
            rr_start=RR_START, t_min=T_MIN)


def test_port_imports_no_jax():
    """Every module of the port, and ``chip_smoke.py``, imports neither JAX
    nor the JAX package (in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import raytracer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'raytracer_tpu')))\n")
    root = os.path.join(os.path.dirname(__file__), "..")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
