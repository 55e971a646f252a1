"""SPPM's (N, 3) route in the port (``models/sppm.py``'s
``trace_photon_deposits``, (N, 3) ``measurement_pass``, ``gather_walk``
and ``gather_fn``'s chunk loop; ``materials.scatter_photon``;
``photon_grid.query_grid``; ``nee.sample_li``) against the JAX package's.

Function level, on the same numpy inputs:
- ``scatter_photon`` on JAX's uniform rows over all five materials: the
  interaction equal, direction, attenuation, Le and the new power within
  1e-5 (rtol and atol);
- ``query_grid``/``query_grid_chunked`` on each package's grid of the same
  photons: counts equal, flux within rtol 1e-5 (float32 sums of the same
  terms in another order); with no cell past the cap, the "grid" query
  gives the dense query's counts;
- ``sample_li`` on JAX's own draws (its categorical picks carried across
  as the midpoint of each light's interval of ``pick_light``'s CDF): on
  Cornell (one light) and a scene of three lights at least 99% of the
  lanes within rtol 1e-4 (a shadow ray can graze an edge in float32).

Route level: the port's SPPM takes the JAX package's route
(``soa_eligible`` against JAX ``_soa_eligible``, and the passes that run)
for every intersector on Cornell and cornell_smoke. Given the same rows
(the same generator seed), ``gather_walk`` on the kernel route (the
closest-hit kernel, as a media scene's gather takes it) and on the
brute-force route trace the same paths: radiance within 1e-4 on at least
99% of the lanes, rays within 0.1%; likewise the (N, 3) photon pass and
the regenerating SoA pass with no spawn window
(``wavefront_soa.trace_photon_deposits_regen_soa``), on the kernel route.

Image level (the packages draw from different streams): SPPM at 16x16,
2 iterations x 4,000 photons, a 4-spp gather, on cornell_smoke (the
port's default route, which is the (N, 3) loops there, against JAX's)
and on Cornell through "bruteforce", "bvh" and "leaf" (against JAX's
"bruteforce"): the linear image means over ``REPEATS`` seeds a side
within 4 standard errors of their difference, each side's error from the
spread of its renders (``test_torch_media.py::check_linear_means``). One
render's mean spreads by about 2.5% from seed to seed (JAX, seeds 0-2,
on the CPU), so the band is about 5% wide.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from raytracer_tpu.models import sppm as jsppm  # noqa: E402
from raytracer_tpu.ops import intersect as jix  # noqa: E402
from raytracer_tpu.ops import materials as jmat  # noqa: E402
from raytracer_tpu.ops import nee as jnee  # noqa: E402
from raytracer_tpu.ops import photon_grid as jpg  # noqa: E402
from raytracer_tpu.scene import builtin as jbuiltin  # noqa: E402
from raytracer_tpu.scene.builder import SceneBuilder as JBuilder  # noqa
from raytracer_tpu.utils.config import RenderConfig as JConfig  # noqa
from raytracer_tpu.utils.config import SPPMConfig as JSPPMConfig  # noqa
from raytracer_tpu_torch.models import sppm  # noqa: E402
from raytracer_tpu_torch.models import wavefront_soa as twf  # noqa: E402
from raytracer_tpu_torch.models.camera import camera_rays  # noqa: E402
from raytracer_tpu_torch.ops import bvh as tbvh  # noqa: E402
from raytracer_tpu_torch.ops import dispatch  # noqa: E402
from raytracer_tpu_torch.ops import intersect as tix  # noqa: E402
from raytracer_tpu_torch.ops import materials as tmat  # noqa: E402
from raytracer_tpu_torch.ops import nee as tnee  # noqa: E402
from raytracer_tpu_torch.ops import photon_grid as tpg  # noqa: E402
from raytracer_tpu_torch.ops import photon_query  # noqa: E402
from raytracer_tpu_torch.ops.fused_bounce import pack_tables  # noqa: E402
from raytracer_tpu_torch.ops.leaf import build_leaf_tables  # noqa: E402
from raytracer_tpu_torch.ops.lights import pick_light  # noqa: E402
from raytracer_tpu_torch.scene import builtin as tbuiltin  # noqa: E402
from raytracer_tpu_torch.scene.convert import scene_from_numpy  # noqa
from raytracer_tpu_torch.utils.config import (  # noqa: E402
    RenderConfig, SPPMConfig)
from test_torch_media import check_linear_means  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
DATA = os.path.join(ROOT, "data")
TOL = 1e-5
REPEATS = 8
SMALL = dict(width=16, height=16, samples_per_pixel=4, spp_chunk=2,
             max_depth=8)
SMALL_SPPM = dict(n_iterations=2, photons_per_iter=4000,
                  max_photon_bounces=6, max_camera_bounces=8)


@pytest.fixture(autouse=True, scope="module")
def _core_share():
    """Under pytest-xdist the workers share the machine's cores: run torch
    on this worker's share of them."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, min(old, (os.cpu_count() or 1) // workers)))
    yield
    torch.set_num_threads(old)


def t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ functions

def five_materials():
    """A JAX scene whose material table holds all five kinds (a checker
    Lambertian, a fuzzy metal, glass, a light, an isotropic medium's
    phase)."""
    b = JBuilder()
    mats = [b.lambertian(b.checker_texture((0.2, 0.3, 0.1),
                                           (0.9, 0.9, 0.9))),
            b.metal(b.constant_texture((0.8, 0.6, 0.2)), 0.3),
            b.dielectric(1.5),
            b.diffuse_light(b.constant_texture((4.0, 4.0, 4.0))),
            b.isotropic(b.constant_texture((0.5, 0.7, 0.9)))]
    for i, m in enumerate(mats):
        b.add_sphere((3.0 * i, 0.0, 0.0), 1.0, m)
    b.add_xzrect_light(0.0, 0.0, 1.0, 1.0, 5.0, (1.0, 1.0, 1.0), 1.0)
    b.set_camera(look_from=(0.0, 0.0, 10.0), look_at=(0.0, 0.0, 0.0))
    return b.compile()


def test_scatter_photon_matches_jax():
    js = five_materials()
    ts = scene_from_numpy(js)
    n = 4096
    rng = np.random.default_rng(11)
    f = np.float32
    normal = rng.normal(size=(n, 3)).astype(f)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    attrs = jix.HitAttrs(
        valid=jnp.asarray(rng.random(n) > 0.05),
        t=jnp.asarray(rng.uniform(0.1, 10, n).astype(f)),
        p=jnp.asarray(rng.uniform(-2, 2, (n, 3)).astype(f)),
        normal=jnp.asarray(normal),
        front_face=jnp.asarray(rng.random(n) > 0.3),
        uv=jnp.asarray(rng.random((n, 2)).astype(f)),
        mat_id=jnp.asarray(rng.integers(0, 5, n).astype(np.int32)))
    d = rng.normal(size=(n, 3)).astype(f)
    uni = rng.random((4, n), dtype=f)
    power = rng.uniform(0.1, 5.0, (n, 3)).astype(f)
    js_, jp = jmat.scatter_photon(js, jnp.asarray(uni), jnp.asarray(d),
                                  attrs, jnp.asarray(power))
    ta = tix.HitAttrs(*(t(x) for x in attrs))
    ts_, tp = tmat.scatter_photon(ts, t(uni), t(d), ta, t(power))
    inter = ts_.interaction.numpy()
    np.testing.assert_array_equal(inter, np.asarray(js_.interaction))
    assert len(np.unique(inter)) == 5          # every interaction code
    for field in ("direction", "attenuation", "emitted"):
        np.testing.assert_allclose(getattr(ts_, field).numpy(),
                                   np.asarray(getattr(js_, field)),
                                   rtol=TOL, atol=TOL, err_msg=field)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=TOL,
                               atol=TOL)


def photons_and_points(seed, n_ph=6000, n_pts=700):
    """Photons on Cornell's floor and walls and query points near them,
    with per-point radii up to one cell."""
    rng = np.random.default_rng(seed)
    f = np.float32
    lo, hi = np.zeros(3, f), np.full(3, 555.0, f)
    pos = rng.uniform(0, 555, (n_ph, 3)).astype(f)
    pos[: n_ph // 2, 1] = 0.0                       # half on the floor
    power = rng.uniform(0, 1e3, (n_ph, 3)).astype(f)
    norm = rng.normal(size=(n_ph, 3)).astype(f)
    norm /= np.linalg.norm(norm, axis=1, keepdims=True)
    valid = rng.random(n_ph) > 0.2
    res, _ = jpg.choose_grid_resolution(lo, hi, n_ph, 100)
    cell = float(np.min(555.0 / np.asarray(res)))
    pts = rng.uniform(0, 555, (n_pts, 3)).astype(f)
    pts[: n_pts // 2, 1] = rng.uniform(0, 2, n_pts // 2)
    radius = rng.uniform(0.1, 1.0, n_pts).astype(f) * cell
    return pos, power, norm, valid, lo, hi, res, pts, radius, cell


@pytest.mark.parametrize("chunked", [False, True])
def test_query_grid_matches_jax(chunked):
    pos, power, norm, valid, lo, hi, res, pts, radius, cell = \
        photons_and_points(5)
    k = 16                               # a cap some cells exceed
    jg = jpg.build_grid(*(jnp.asarray(x) for x in (pos, power, norm, valid,
                                                   lo, hi)), res,
                        compact=True)
    tg = tpg.build_grid(*(t(x) for x in (pos, power, norm, valid, lo, hi)),
                        res, compact=True)
    if chunked:
        ref = jpg.query_grid_chunked(jg, res, jnp.asarray(pts),
                                     jnp.asarray(radius), cell, k, 256)
        ours = tpg.query_grid_chunked(tg, res, t(pts), t(radius), cell, k,
                                      256)
    else:
        ref = jpg.query_grid(jg, res, jnp.asarray(pts), jnp.asarray(radius),
                             cell, k)
        ours = tpg.query_grid(tg, res, t(pts), t(radius), cell, k)
    for field in ("count_r", "count_cap"):
        np.testing.assert_array_equal(getattr(ours, field).numpy(),
                                      np.asarray(getattr(ref, field)))
    assert float(ours.count_cap.sum()) > 0
    for field in ("flux_r", "flux_cap"):
        np.testing.assert_allclose(getattr(ours, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=TOL, atol=1e-3, err_msg=field)


def test_grid_query_impl_equals_dense_below_the_cap():
    """``sppm._query``'s switch: with a cap no cell reaches, the 27-cell
    gather counts exactly the photons the dense query counts."""
    pos, power, norm, valid, lo, hi, res, pts, radius, cell = \
        photons_and_points(6)
    tg = tpg.build_grid(*(t(x) for x in (pos, power, norm, valid, lo, hi)),
                        res, compact=True)
    per_cell = int(np.diff(tg.cell_start.numpy()).max())
    cap = torch.full((pts.shape[0],), cell)
    grid = sppm._query(tg, res, t(pts), t(radius), cap, per_cell, "grid")
    dense = sppm._query(tg, res, t(pts), t(radius), cap, per_cell, "dense")
    for a, b in zip(grid, dense):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-2)
    assert torch.equal(grid.count_r, dense.count_r)
    with pytest.raises(ValueError, match="query_impl"):
        sppm._query(tg, res, t(pts), t(radius), cap, per_cell, "kd")


def shading_points(js, n, seed):
    """JAX hit attributes of ``n`` camera rays of a 64x48 image."""
    from raytracer_tpu.models.camera import camera_rays as jcamera_rays
    pix = jnp.asarray(np.random.default_rng(seed).integers(0, 64 * 48, n))
    o, d = jcamera_rays(js.camera, jax.random.PRNGKey(seed), pix, 64, 48)
    hit = jix.intersect_bruteforce(js, o, d, 1e-3, jnp.inf)
    return jix.hit_attributes(js, o, d, hit)


def jax_nee_rows(lights, key, n, n_samples):
    """JAX ``sample_li``'s draws as the port's rows: each sample's
    categorical pick as the midpoint of its light's interval of the
    port's CDF, then the hemisphere pair and the rect uv."""
    cdf = torch.cumsum(torch.softmax(t(lights.log_prob).double(), 0), 0)
    lo = torch.cat([torch.zeros(1, dtype=torch.float64), cdf[:-1]])
    rows = []
    for s in range(n_samples):
        k = jax.random.fold_in(key, s)
        k_pick, k1, k2 = jax.random.split(k, 3)
        if lights.kind.shape[0] == 1:
            idx = torch.zeros(n, dtype=torch.long)
        else:
            idx = t(jax.random.categorical(
                k_pick, jnp.asarray(lights.log_prob.numpy()),
                shape=(n,))).long()
        pick = ((lo[idx] + cdf[idx]) / 2).float()
        kk1, kk2 = jax.random.split(k1)
        uv = np.asarray(jax.random.uniform(k2, (n, 2)))
        rows.append(torch.stack([
            pick, t(jax.random.uniform(kk1, (n,))),
            t(jax.random.uniform(kk2, (n,))), t(uv[:, 0]), t(uv[:, 1])]))
    return torch.stack(rows)


def three_lights():
    """A floor, a blocking sphere, two rect lights of unequal power and a
    sphere light: a JAX scene whose light pick matters. (scene_500's
    shading points lie on spheres, whose shadow rays from the exact
    surface point with t_min 1e-4 hit their own sphere in float32 in both
    packages: its ``sample_li`` is black.)"""
    b = JBuilder()
    white = b.lambertian(b.constant_texture((0.7, 0.7, 0.7)))
    b.add_xz_rect(-10.0, -10.0, 10.0, 10.0, 0.0, white)
    b.add_sphere((0.0, 1.0, 0.0), 1.0, white)
    b.add_xzrect_light(-1.0, -1.0, 1.0, 1.0, 5.0, (1.0, 1.0, 1.0), 1.0)
    b.add_xzrect_light(2.0, 1.0, 3.0, 2.0, 4.0, (3.0, 2.0, 1.0), 1.0)
    b.add_sphere_light((-3.0, 2.0, 1.0), 0.4, (2.0, 2.0, 4.0), 1.0)
    b.set_camera(look_from=(0.0, 4.0, 9.0), look_at=(0.0, 0.0, 0.0))
    return b.compile(4.0 / 3.0)


@pytest.mark.parametrize("name", ["cornell", "three_lights"])
def test_sample_li_matches_jax(name):
    js = jbuiltin.cornell_box() if name == "cornell" else three_lights()
    ts = scene_from_numpy(js)
    n, n_samples = 512, 4
    ja = shading_points(js, n, 21)
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jnee.sample_li(js, key, ja, n_samples,
                                    intersector="bruteforce"))
    rows = jax_nee_rows(ts.lights, key, n, n_samples)
    idx = pick_light(ts.lights, rows[0, 0])
    if name == "three_lights":
        assert len(np.unique(idx.numpy())) == 3
        np.testing.assert_array_equal(idx.numpy(), np.asarray(
            jax.random.categorical(jax.random.split(jax.random.fold_in(
                key, 0), 3)[0], js.lights.log_prob, shape=(n,))))
    ta = tix.HitAttrs(*(t(x) for x in ja))
    ours = tnee.sample_li(ts, ta, n_samples, intersector="bruteforce",
                          rows=rows).numpy()
    close = np.isclose(ours, ref, rtol=1e-4, atol=1e-6 * ref.max())
    assert close.all(1).mean() >= 0.99
    assert (ref > 0).any(1).mean() > 0.2
    # drawn from a generator: the same law, a finite nonnegative estimate
    drawn = tnee.sample_li(ts, ta, n_samples, intersector="bruteforce",
                           gen=torch.Generator().manual_seed(1))
    assert torch.isfinite(drawn).all() and (drawn >= 0).all()


# -------------------------------------------------------------- routes

@pytest.mark.parametrize("route", ["auto", "pallas", "leaf", "bruteforce",
                                   "bvh"])
@pytest.mark.parametrize("name", ["cornell", "cornell_smoke"])
def test_routes_follow_jax(name, route, monkeypatch):
    """``soa_eligible`` is JAX's ``_soa_eligible``, and a render runs the
    SoA passes exactly where it says so."""
    js = getattr(jbuiltin, name if name != "cornell" else "cornell_box")()
    ts = getattr(tbuiltin, name if name != "cornell" else "cornell_box")()
    if route == "bvh":
        ts = tbvh.build_bvh(ts)
    soa = sppm.soa_eligible(ts, dispatch.auto_route(ts) if route == "auto"
                            else dispatch.resolve(route))
    assert soa == jsppm._soa_eligible(js, route)
    cfg = RenderConfig(width=4, height=4, samples_per_pixel=1, max_depth=3,
                       intersector=route,
                       sppm=SPPMConfig(n_iterations=1, photons_per_iter=500,
                                       max_photon_bounces=2))
    if route == "leaf" and name == "cornell_smoke":
        # no sphere, so no leaf tables (as in JAX): the route refuses
        pytest.raises(ValueError, build_leaf_tables, ts)
        with pytest.raises(ValueError, match="no leaf tables"):
            sppm.render(ts, cfg, 0, device="cpu")
        return
    if route == "leaf":
        ts = ts._replace(leaf=build_leaf_tables(ts))
    calls = {"soa": 0, "aos": 0}

    def spy(fn, key):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    for mod, fn, key in ((twf, "trace_photon_deposits_regen_soa", "soa"),
                         (twf, "measurement_soa", "soa"),
                         (twf, "gather_regen_soa", "soa"),
                         (sppm, "trace_photon_deposits", "aos"),
                         (sppm, "_measurement_aos", "aos"),
                         (sppm, "gather_walk", "aos")):
        monkeypatch.setattr(mod, fn, spy(getattr(mod, fn), key))
    img, _, _ = sppm.render(ts, cfg, 0, device="cpu")
    assert torch.isfinite(img).all()
    assert calls == ({"soa": 3, "aos": 0} if soa else {"soa": 0, "aos": 3})


def test_gather_walk_on_the_kernel_route_equals_bruteforce():
    """The same generator seed gives both walks the same rows: the (N, 3)
    walk on the kernel route ("pallas": the closest-hit kernel, the
    gather of a media scene such as cornell_smoke) and on the brute-force
    route trace the same paths."""
    scene = tbuiltin.cornell_box()
    tables = pack_tables(scene)
    w = h = 24
    pix = torch.arange(w * h).repeat(2)
    o, d = camera_rays(scene.camera, torch.Generator().manual_seed(4), pix,
                       w, h)
    est = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 2, (pix.shape[0], 3)).astype(np.float32))
    kw = dict(max_depth=8, t_min=1e-3, spawn_eps=1e-5 * scene.scale)
    rad_a, rays_a = sppm.gather_walk(scene, tables, o, d, est,
                                     torch.Generator().manual_seed(5),
                                     intersector="bruteforce", **kw)
    rad_k, rays_k = sppm.gather_walk(scene, tables, o, d, est,
                                     torch.Generator().manual_seed(5),
                                     intersector="pallas", **kw)
    close = torch.isclose(rad_k, rad_a, rtol=1e-4, atol=1e-4).all(1)
    assert close.float().mean() >= 0.99
    assert abs(rays_a - rays_k) <= 0.001 * rays_a and rays_a > pix.shape[0]


def test_photon_passes_equal_given_the_same_rows():
    """The regenerating pass with one lane a photon and no spawn window
    (``trace_photon_deposits_regen_soa``, kernel route) and the (N, 3)
    ``trace_photon_deposits`` (brute-force route) on one seed: the same
    deposits on at least 99% of the slots."""
    scene = tbuiltin.cornell_box()
    tables = pack_tables(scene)
    args = (scene, tables)
    kw = (3000, 6, sppm.PHOTON_T_MIN, 1e-5 * scene.scale)
    a = sppm.trace_photon_deposits(*args, torch.Generator().manual_seed(2),
                                   *kw, "bruteforce")
    s, spawned = twf.trace_photon_deposits_regen_soa(
        *args, torch.Generator().manual_seed(2), *kw, lanes=3000, window=0)
    assert int(spawned) == 3000
    assert a.valid.shape == s.valid.shape == (6 * 3000,)
    same = (a.valid == s.valid) & (a.caustic == s.caustic)
    assert same.float().mean() >= 0.99 and a.valid.sum() > 3000
    both = a.valid & s.valid
    for x, y in ((a.pos, s.pos), (a.power, s.power), (a.norm, s.norm)):
        close = torch.isclose(x, y, rtol=1e-4, atol=1e-3).all(0)
        assert close[both].float().mean() >= 0.99


# --------------------------------------------------------------- images

_RENDERS = {}


def renders(who, name, route):
    """``REPEATS`` SPPM images of "jax" or "port" (seeds 0..), made once."""
    key = (who, name, route)
    if key not in _RENDERS:
        out = []
        if who == "jax":
            js = (jbuiltin.cornell_smoke() if name == "smoke"
                  else jbuiltin.cornell_box())
            cfg = JConfig(**SMALL, intersector=route,
                          sppm=JSPPMConfig(**SMALL_SPPM))
            for k in range(REPEATS):
                img, _, _ = jsppm.render(js, cfg, jax.random.PRNGKey(k))
                out.append(np.asarray(img))
        else:
            ts = (tbuiltin.cornell_smoke() if name == "smoke"
                  else tbuiltin.cornell_box())
            if route == "bvh":
                ts = tbvh.build_bvh(ts)
            if route == "leaf":
                ts = ts._replace(leaf=build_leaf_tables(ts))
            cfg = RenderConfig(**SMALL, intersector=route,
                               sppm=SPPMConfig(**SMALL_SPPM))
            for seed in range(REPEATS):
                img, rays, state = sppm.render(ts, cfg, seed, device="cpu")
                assert torch.isfinite(img).all() and rays >= 16 * 16 * 4
                assert state.iteration == 2
                out.append(img.numpy())
        _RENDERS[key] = out
    return _RENDERS[key]


@pytest.mark.parametrize("name,route", [
    ("smoke", "auto"), ("cornell", "bruteforce"), ("cornell", "bvh"),
    ("cornell", "leaf")])
def test_sppm_image_means_match_jax(name, route):
    check_linear_means(renders("port", name, route),
                       renders("jax", name, "bruteforce"))


def test_photon_query_kernel_route_runs_on_smoke(monkeypatch):
    """On the card the (N, 3) route still queries with the photon-query
    kernel: SPPM on smoke calls ``query_planes`` twice an iteration."""
    n = {"q": 0}
    real = photon_query.query_planes

    def spy(*a, **k):
        n["q"] += 1
        return real(*a, **k)

    monkeypatch.setattr(photon_query, "query_planes", spy)
    cfg = RenderConfig(width=4, height=4, samples_per_pixel=1, max_depth=3,
                       sppm=SPPMConfig(n_iterations=2, photons_per_iter=500,
                                       max_photon_bounces=2))
    sppm.render(tbuiltin.cornell_smoke(), cfg, 0, device="cpu")
    assert n["q"] == 4
