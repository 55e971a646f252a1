"""The port's constant-density media (``raytracer_tpu_torch.ops.media``,
the media override of ``models/wavefront_soa.py::bounce_step`` and of the
brute-force loop) against the JAX package's ``ops/media.py``.

Function level, on the same rays and free-flight uniforms (JAX's own
``jax.random.uniform(key, (N, K), minval=1e-12)``, transposed):
- ``_boundary_window``: the same crossings, entry and exit within rtol
  1e-5 (atol 1e-5 x the distance);
- ``apply_media_soa`` and ``apply_media``: the scatter mask and the medium
  equal on every lane but those where the drawn distance and the distance
  inside the medium are within 1e-5 of each other (relative; at most 0.1%
  of the lanes, counted apart), t within rtol 1e-5, the other fields
  equal;
- the unfused ``bounce_step`` on ``cornell_smoke`` (camera rays and
  random rays, JAX's scatter rows and media rows): the interaction equal
  on >= 99.9% of alive lanes, the vectors within ``test_torch_bounce.py``'s
  tolerances (phase 3 of ``chip_smoke.py``).

Image level (the two packages draw from different streams): the bands of
``tests/test_extensions.py:296-300``, gamma mean within 5% and mean
|diff| < 0.08, on ``cornell_smoke`` 24x24, 24 spp, depth 10. A single
render's gamma mean spreads by about 9% from seed to seed in both
packages (0.0245-0.0268 in JAX, 0.0241-0.0281 in the port over seeds 0-3,
on the CPU), so each side is the mean over ``REPEATS`` renders of that
size (seeds 0.., JAX keys 0..; the difference of two such means then has
a spread of about 1.8%), the mean |diff| that of the renders taken in
pairs. With 64 spp at 16x16 over 12 renders each, the linear means of the
kernel route, the brute-force route and JAX agree within 2 standard
errors (1.4-2.2%) on ``cornell_smoke`` and on Cornell without media. NEE
and MIS are held in linear space (as ``test_torch_nee.py`` holds them):
their means over ``NEE_REPEATS`` renders within 4 standard errors of the
difference, each side's error from the spread of its renders (on
``cornell_smoke`` NEE is as noisy as plain PT: 1.3-2.9% over 8 renders).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from raytracer_tpu.models import path_tracer as jpt  # noqa: E402
from raytracer_tpu.models import wavefront_soa as jwf  # noqa: E402
from raytracer_tpu.ops import intersect as jix  # noqa: E402
from raytracer_tpu.ops import media as jmedia  # noqa: E402
from raytracer_tpu.ops.pallas_intersect import N_GEO_SLOTS  # noqa: E402
from raytracer_tpu.scene import builtin as jbuiltin  # noqa: E402
from raytracer_tpu.scene.builder import SceneBuilder as JBuilder  # noqa
from raytracer_tpu_torch.models import path_tracer  # noqa: E402
from raytracer_tpu_torch.models import wavefront_soa as twf  # noqa: E402
from raytracer_tpu_torch.ops import closest_hit, fused_bounce  # noqa: E402
from raytracer_tpu_torch.ops import intersect as tix  # noqa: E402
from raytracer_tpu_torch.ops import media as tmedia  # noqa: E402
from raytracer_tpu_torch.ops.leaf import build_leaf_tables  # noqa: E402
from raytracer_tpu_torch.scene import builtin as tbuiltin  # noqa: E402
from raytracer_tpu_torch.scene.builder import SceneBuilder as TBuilder  # noqa
from raytracer_tpu_torch.scene.types import PRIM_MEDIA  # noqa: E402
from test_torch_bounce import T_MIN, make_rays  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
RTOL = 1e-5
EDGE = 1e-5          # |hit_dist - dist_inside| <= EDGE * dist: an edge lane
EDGE_SHARE = 0.001
REPEATS = 12
NEE_REPEATS = 6
SMOKE = dict(width=24, height=24, spp=24, spp_chunk=4, max_depth=10,
             t_min=1e-3, spawn_eps_rel=1e-4, russian_roulette=True)


@pytest.fixture(autouse=True, scope="module")
def _core_share():
    """Under pytest-xdist the workers share the machine's cores: run torch
    on this worker's share of them."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, min(old, (os.cpu_count() or 1) // workers)))
    yield
    torch.set_num_threads(old)


def fog_scene(builder):
    """Spheres and both medium kinds, overlapping, with a light: a sphere
    medium around a small sphere, a box medium beside it."""
    b = builder()
    white = b.lambertian(b.constant_texture((0.8, 0.8, 0.8)))
    b.add_sphere((0.0, -100.0, -4.0), 99.0, white)
    b.add_sphere((0.0, 0.0, -4.0), 0.4, white)
    b.add_sphere_light((0.0, 3.0, -4.0), 0.5, (4.0, 4.0, 4.0), 10.0)
    b.add_constant_medium_sphere((0.0, 0.0, -4.0), 1.2, 0.8,
                                 b.constant_texture((0.9, 0.9, 0.9)))
    b.add_constant_medium_box((0.5, -1.0, -6.0), (2.5, 1.0, -3.0), 0.3,
                              b.constant_texture((0.3, 0.6, 0.9)))
    b.set_camera((0.0, 0.5, 2.0), (0.0, 0.0, -4.0), vfov=50.0,
                 aspect_ratio=1.0)
    return b.compile()


def fog_rays(seed, n=4096):
    """Rays from around the camera toward the media, some with a zero
    direction component; geometric hits t (+inf on a sixth of them)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32) + [0, 0.5, 2.0]
    tgt = rng.uniform(-2.0, 2.0, (n, 3)) + [1.0, 0.0, -4.5]
    d = (tgt - o).astype(np.float32)
    d[: n // 16, 1] = 0.0                    # axis-parallel in y
    t = rng.uniform(1.0, 12.0, n).astype(np.float32)
    t[rng.random(n) < 1 / 6] = np.inf
    return o.astype(np.float32), d, t


def jax_uniforms(key, n, k):
    """JAX ``apply_media``'s free-flight draw, as the port takes it
    (K, N)."""
    u = jax.random.uniform(key, (n, k), minval=1e-12, maxval=1.0)
    return np.ascontiguousarray(np.asarray(u).T)


def edge_lanes(media, u, o, d, t_geom, t_min):
    """Lanes where a medium's drawn distance lies within EDGE of the
    distance inside it (float64), where float32 may decide either way."""
    enter, exit_, ok = (np.asarray(x, np.float64) for x in
                        jmedia._boundary_window(media, jnp.asarray(o),
                                                jnp.asarray(d)))
    enter = np.maximum(enter, t_min)
    exit_ = np.minimum(exit_, t_geom[:, None])
    dl = np.linalg.norm(d.astype(np.float64), axis=1)[:, None]
    inside = (exit_ - enter) * dl
    hit = np.asarray(media.neg_inv_density, np.float64)[None] * np.log(
        u.T.astype(np.float64))
    near = np.abs(hit - inside) <= EDGE * np.maximum(np.abs(inside), 1e-30)
    return (near & (ok > 0.5)).any(1)


def test_boundary_window_matches_jax():
    js, ts = fog_scene(JBuilder), fog_scene(TBuilder)
    o, d, _ = fog_rays(1)
    je = [np.asarray(x) for x in jmedia._boundary_window(
        js.media, jnp.asarray(o), jnp.asarray(d))]
    te = [x.numpy() for x in tmedia._boundary_window(
        ts.media, torch.from_numpy(o), torch.from_numpy(d))]
    np.testing.assert_array_equal(te[2], je[2])
    assert je[2].any(0).all() and (~je[2]).any()
    ok = je[2]
    for a, b in zip(te[:2], je[:2]):
        np.testing.assert_allclose(a[ok], b[ok], rtol=RTOL,
                                   atol=RTOL * np.abs(b[ok]).max())


def test_apply_media_soa_matches_jax():
    js, ts = fog_scene(JBuilder), fog_scene(TBuilder)
    o, d, t = fog_rays(2)
    n, k = o.shape[0], 2
    key = jax.random.PRNGKey(29)
    ty = np.where(np.isfinite(t), 0.0, -1.0).astype(np.float32)
    data = np.zeros((N_GEO_SLOTS + 12, n), np.float32)
    jt, jty, jdata = (np.asarray(x) for x in jmedia.apply_media_soa(
        js, key, *(jnp.asarray(c) for c in o.T), *(jnp.asarray(c)
                                                   for c in d.T),
        jnp.asarray(t), jnp.asarray(ty), jnp.asarray(data), T_MIN))
    u = jax_uniforms(key, n, k)
    hit = closest_hit.Closest(torch.from_numpy(t),
                              torch.from_numpy(ty.astype(np.int32)),
                              torch.zeros(n, dtype=torch.int32),
                              torch.zeros(n), torch.zeros(n))
    out = tmedia.apply_media_soa(ts.media, torch.from_numpy(u),
                                 torch.from_numpy(o.T.copy()),
                                 torch.from_numpy(d.T.copy()), hit, T_MIN)
    j_med = jty == PRIM_MEDIA
    t_med = out.ty.numpy() == PRIM_MEDIA
    j_mat = jdata[N_GEO_SLOTS + 11].round().astype(np.int32)
    t_mat = ts.media.mat_id.numpy()[np.clip(out.ix.numpy(), 0, k - 1)]
    edge = edge_lanes(js.media, u, o, d, t, T_MIN)
    same = (j_med == t_med) & (~j_med | (j_mat == t_mat))
    assert edge.mean() <= EDGE_SHARE
    assert same[~edge].all(), np.where(~same & ~edge)[0][:8]
    assert 0.2 < j_med.mean() < 0.8 and len(np.unique(j_mat[j_med])) == 2
    keep = same & j_med
    np.testing.assert_allclose(out.t.numpy()[keep], jt[keep], rtol=RTOL)
    np.testing.assert_array_equal(out.t.numpy()[~t_med], t[~t_med])
    assert (out.b1.numpy()[t_med] == 0).all()


def test_apply_media_matches_jax():
    """The (N, 3) route's override of a ``HitAttrs``."""
    js, ts = fog_scene(JBuilder), fog_scene(TBuilder)
    o, d, t = fog_rays(3)
    n = o.shape[0]
    rng = np.random.default_rng(4)
    valid = np.isfinite(t)
    p = (o + np.where(valid, t, 0)[:, None] * d).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    attrs = (valid, t, p, nrm, rng.random(n) < 0.5,
             rng.random((n, 2), dtype=np.float32),
             rng.integers(0, 3, n).astype(np.int32))
    key = jax.random.PRNGKey(31)
    ja = jmedia.apply_media(js.media, key, jnp.asarray(o), jnp.asarray(d),
                            jix.HitAttrs(*(jnp.asarray(x) for x in attrs)),
                            T_MIN)
    ta = tmedia.apply_media(ts.media, torch.from_numpy(jax_uniforms(
        key, n, 2)), torch.from_numpy(o), torch.from_numpy(d),
        tix.HitAttrs(*(torch.from_numpy(np.array(x)) for x in attrs)),
        T_MIN)
    edge = edge_lanes(js.media, jax_uniforms(key, n, 2), o, d,
                      np.where(valid, t, np.inf), T_MIN)
    assert edge.mean() <= EDGE_SHARE
    moved = np.asarray(ja.t) != t
    assert 0.2 < moved.mean() < 0.8
    for field in ta._fields:
        ours = getattr(ta, field).numpy()[~edge]
        ref = np.asarray(getattr(ja, field))[~edge]
        if field in ("t", "p"):
            np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=1e-6,
                                       err_msg=field)
        else:
            np.testing.assert_array_equal(ours, ref, err_msg=field)


def test_unfused_bounce_on_smoke_matches_jax():
    """JAX ``bounce_step(fused=False, media_key=k)`` (the closest-hit
    kernel in interpret mode, then ``apply_media_soa`` on fold 29 of k)
    against the port's with JAX's scatter rows and free-flight draw."""
    js, ts = jbuiltin.cornell_smoke(), tbuiltin.cornell_smoke()
    o, d, alive, uni = make_rays(js, 41)
    n = o.shape[1]
    key = jax.random.PRNGKey(17)
    eps = float(uni[3, 0])
    jb = jwf.bounce_step(js, jnp.asarray(uni[:3]),
                         *(jnp.asarray(x) for x in o),
                         *(jnp.asarray(x) for x in d), jnp.asarray(alive),
                         t_min=T_MIN, spawn_eps=eps, intersector="pallas",
                         fused=False, media_key=key)
    u = jax_uniforms(jax.random.fold_in(key, 29), n, 2)
    tab = fused_bounce.pack_tables(ts)
    assert tab.med_mat is not None
    tb = twf.bounce_step(tab, torch.from_numpy(uni[:3]), torch.from_numpy(o),
                         torch.from_numpy(d), torch.from_numpy(alive),
                         t_min=T_MIN, spawn_eps=torch.tensor(eps),
                         fused=False, scene=ts,
                         media_u=torch.from_numpy(u))

    def rows(*names):
        return np.stack([np.asarray(getattr(jb, x)) for x in names])

    agree = (np.asarray(jb.inter) == tb.inter.numpy()) & alive
    assert agree.sum() >= 0.999 * alive.sum()
    # media events happen, and flow through as isotropic diffuse lanes
    hit = tmedia.apply_media_soa(ts.media, torch.from_numpy(u),
                                 torch.from_numpy(o), torch.from_numpy(d),
                                 closest_hit.closest_tables(
                                     tab, torch.from_numpy(o),
                                     torch.from_numpy(d), T_MIN,
                                     float("inf"), torch.from_numpy(alive)),
                                 T_MIN)
    med = (hit.ty.numpy() == PRIM_MEDIA) & alive
    assert med.sum() > 50
    p_tol = 1e-5 * float(np.asarray(js.scale))
    for name, ours, ref, tol in (
            ("p", tb.p, rows("px", "py", "pz"), p_tol),
            ("no", tb.no, rows("nox", "noy", "noz"), p_tol),
            ("n", tb.n, rows("nx", "ny", "nz"), 1e-4),
            ("nd", tb.nd, rows("ndx", "ndy", "ndz"), 1e-4),
            ("att", tb.att, rows("ar", "ag", "ab"), 1e-4),
            ("emit", tb.emit, rows("er", "eg", "eb"), 1e-4)):
        np.testing.assert_allclose(ours.numpy()[:, agree], ref[:, agree],
                                   rtol=1e-4 if tol == 1e-4 else 0,
                                   atol=tol, err_msg=name)
    # a medium event's normal is (1, 0, 0) flipped to face the ray
    n_med = tb.n.numpy()[:, med]
    np.testing.assert_array_equal(np.abs(n_med[0]), 1.0)
    assert (n_med[0] * d[0, med] <= 0).all()


def _gamma(img):
    return np.sqrt(np.clip(img, 0, None))


def jax_smoke(repeats=REPEATS, **kw):
    """``repeats`` renders of JAX's ``cornell_smoke`` through its (N, 3)
    route (keys 0..)."""
    scene = jbuiltin.cornell_smoke()
    return [np.asarray(jpt.render_fn(scene, jax.random.PRNGKey(k),
                                     intersector="bruteforce",
                                     **{**SMOKE, **kw})[0])
            for k in range(repeats)]


def port_smoke(route, repeats=REPEATS, **kw):
    """``repeats`` renders of the port's ``cornell_smoke`` (seeds 0..)."""
    scene = tbuiltin.cornell_smoke()
    out = []
    for seed in range(repeats):
        img, rays = path_tracer.render_fn(
            scene, torch.Generator().manual_seed(seed), intersector=route,
            device="cpu", **{**SMOKE, **kw})
        assert torch.isfinite(img).all() and rays > 24 * 24 * 24
        out.append(img.numpy())
    return out


def check_bands(ours, ref):
    """tests/test_extensions.py:296-300 on the mean over the renders:
    gamma mean within 5%, and mean |gamma diff| < 0.08."""
    a = np.mean([_gamma(x).mean() for x in ours])
    b = np.mean([_gamma(x).mean() for x in ref])
    assert abs(a - b) < 0.05 * b, (a, b)
    diff = np.mean([np.abs(_gamma(x) - _gamma(y)).mean()
                    for x, y in zip(ours, ref)])
    assert diff < 0.08, diff


def check_linear_means(ours, ref):
    """Linear means within 4 standard errors of their difference."""
    a, b = (np.array([x.mean() for x in imgs]) for imgs in (ours, ref))
    se = np.sqrt(a.var(ddof=1) / a.size + b.var(ddof=1) / b.size)
    assert abs(a.mean() - b.mean()) < 4 * se, (a.mean(), b.mean(), se)
    assert se < 0.05 * b.mean()


_RENDERS = {}


def renders(who):
    """The plain-PT renders of "jax" or of a port route, made once."""
    if who not in _RENDERS:
        _RENDERS[who] = jax_smoke() if who == "jax" else port_smoke(who)
    return _RENDERS[who]


@pytest.mark.parametrize("route", ["pallas", "bruteforce"])
def test_smoke_render_matches_jax(route):
    """The kernel route (the unfused step, ``apply_media_soa``) and the
    brute-force route (``apply_media``) against JAX's (N, 3) route."""
    check_bands(renders(route), renders("jax"))


def test_kernel_route_matches_bruteforce_route():
    check_bands(renders("pallas"), renders("bruteforce"))


_JAX_NEE = {}


@pytest.mark.parametrize("route", ["pallas", "bruteforce"])
@pytest.mark.parametrize("kw", [dict(nee=True), dict(mis=True)])
def test_smoke_nee_mis_match_jax(kw, route):
    """NEE (the shadow ray ignores media, as in JAX) and MIS at a medium
    event, on the kernel route and the brute-force route, against JAX's
    on its (N, 3) route."""
    key = tuple(kw)
    if key not in _JAX_NEE:
        _JAX_NEE[key] = jax_smoke(NEE_REPEATS, **kw)
    check_linear_means(port_smoke(route, NEE_REPEATS, **kw), _JAX_NEE[key])


def test_smoke_darker_than_cornell():
    """tests/test_extensions.py::test_cornell_smoke_builtin: finite,
    nonzero, and the smoke darkens the box."""
    cfg = dict(SMOKE, spp=16)
    img_s = port_smoke("pallas", 1, spp=16)[0]
    img_c, _ = path_tracer.render_fn(
        tbuiltin.cornell_box(with_mesh=False), torch.Generator().manual_seed(0),
        device="cpu", **cfg)
    assert np.isfinite(img_s).all() and img_s.mean() > 0
    assert img_s.mean() < float(img_c.mean())


def test_leaf_route_with_media_equals_kernel_route():
    """A media scene with spheres through "leaf" (leaf kernel's closest
    hit, then the same override): the kernel route's image and rays at the
    same seed, since both routes find the same winners and draw the same
    rows."""
    scene = fog_scene(TBuilder)
    leafy = scene._replace(leaf=build_leaf_tables(scene))
    kw = dict(SMOKE, spp=8, spp_chunk=2)
    a, ra = path_tracer.render_fn(scene, torch.Generator().manual_seed(3),
                                  device="cpu", **kw)
    b, rb = path_tracer.render_fn(leafy, torch.Generator().manual_seed(3),
                                  intersector="leaf", device="cpu", **kw)
    assert ra == rb and float(a.mean()) > 0
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-6)


def test_media_free_draws_are_unchanged():
    """A media-free scene draws no free-flight rows; a media scene draws
    one per medium after the loop's own."""
    assert twf.media_rows(tbuiltin.three_spheres()) == 0
    assert twf.media_rows(tbuiltin.cornell_smoke()) == 2
    assert twf._media_u(torch.rand(4, 8), 4, 0) is None


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch", "render", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("args,code,said", [
    (["--scene", "smoke"], 0, "rays"),
    (["--scene", "smoke", "--nee"], 0, "NEE shadow rays"),
    (["--scene", "smoke", "--intersector", "bruteforce"], 0, "rays"),
    pytest.param(["--scene", "smoke", "--integrator", "sppm",
                  "--sppm-iters", "1", "--sppm-photons", "1000"], 0,
                 "rays in the final gather", id="args3-2-ROADMAP A11"),
    (["--scene", "smoke", "--intersector", "leaf"], 2,
     "leaf tables need at least one sphere")])
def test_cli_smoke(args, code, said, tmp_path):
    """``--scene smoke`` renders on the CPU, SPPM on it too (its (N, 3)
    loops); the leaf route needs spheres, which it has none of (as in
    JAX)."""
    out = tmp_path / "smoke.png"
    res = _cli(*args, "--width", "16", "--height", "16", "--spp", "2",
               "--max-depth", "4", "--device", "cpu", "--out", str(out))
    assert res.returncode == code, res.stderr
    assert said in (res.stdout if code == 0 else res.stderr)
