"""The port's brute-force (N, 3) route (``--intersector bruteforce``:
``raytracer_tpu_torch.ops.intersect``, ``ops.materials``, ``ops.vec``,
``models.camera`` and ``models.path_tracer``'s (N, 3) loop) against the
JAX package's (``ops/intersect.py``, ``ops/materials.py``,
``models/camera.py``, ``path_tracer.render_fn(intersector="bruteforce")``).

Tolerances:
- function level, on the same numpy-seeded rays and uniform rows:
  ``intersect_bruteforce`` the same winner (type and index) on every lane
  and t within rtol 1e-5 or within the point tolerance 1e-5 x scene.scale
  along the ray (``test_torch_bounce.py``'s: the sphere quadratic cancels
  in float32, and XLA and PyTorch round it in another order: up to 4.6e-5
  relative on scene_500's small spheres); ``hit_attributes`` (fed JAX's
  winners) and ``materials.scatter`` (fed JAX's attributes) within 1e-5
  (rtol and atol), the interaction code equal; camera rays within 1e-6;
- image level (the two packages draw from different streams): the
  brute-force render of ``three_spheres`` 32x32 in the golden bands of
  ``tests/test_golden.py:24-38`` (NEE and MIS with the brightness in
  linear space, as ``test_torch_nee.py`` holds them), and the kernel route
  and the brute-force route of the port within 3% of each other in
  linear mean;
- the route's closest hit through ``dispatch`` gives the kernel route's
  winners on every lane off a float32 edge (at most 0.1% of them).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from raytracer_tpu.models import camera as jcamera  # noqa: E402
from raytracer_tpu.ops import intersect as jix  # noqa: E402
from raytracer_tpu.ops import materials as jmat  # noqa: E402
from raytracer_tpu.ops import vec as jvec  # noqa: E402
from raytracer_tpu_torch.models import camera as tcamera  # noqa: E402
from raytracer_tpu_torch.models import path_tracer  # noqa: E402
from raytracer_tpu_torch.ops import dispatch, fused_bounce  # noqa: E402
from raytracer_tpu_torch.ops import intersect as tix  # noqa: E402
from raytracer_tpu_torch.ops import materials as tmat  # noqa: E402
from raytracer_tpu_torch.ops import vec as tvec  # noqa: E402
from raytracer_tpu_torch.scene import builtin as tbuiltin  # noqa: E402
from test_golden import check_against  # noqa: E402
from test_torch_bounce import SCENES, T_MIN, make_rays  # noqa: E402
from test_torch_nee import check_bands_linear_mean  # noqa: E402
from test_torch_render import GOLDEN_CFG  # noqa: E402

NAMES = sorted(SCENES)
ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _core_share():
    """Under pytest-xdist the workers share the machine's cores: run torch
    on this worker's share of them."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, min(old, (os.cpu_count() or 1) // workers)))
    yield
    torch.set_num_threads(old)


def rays(name, seed):
    """(jscene, tscene, o (N, 3), d (N, 3), alive, uniform rows (3, N)) of
    ``test_torch_bounce.make_rays``."""
    jscene, tscene = SCENES[name][0](), SCENES[name][1]()
    o, d, alive, uni = make_rays(jscene, seed)
    return (jscene, tscene, np.ascontiguousarray(o.T),
            np.ascontiguousarray(d.T), alive, uni[:3])


def jax_hit(jscene, o, d):
    return jix.intersect_bruteforce(jscene, jnp.asarray(o), jnp.asarray(d),
                                    T_MIN, jnp.inf)


@pytest.mark.parametrize("name", NAMES)
def test_intersect_bruteforce_matches_jax(name):
    jscene, tscene, o, d, _, _ = rays(name, 60 + NAMES.index(name))
    jh = jax_hit(jscene, o, d)
    th = tix.intersect_bruteforce(tscene, torch.from_numpy(o),
                                  torch.from_numpy(d), T_MIN, float("inf"))
    np.testing.assert_array_equal(th.prim_type.numpy(),
                                  np.asarray(jh.prim_type))
    np.testing.assert_array_equal(th.prim_idx.numpy(),
                                  np.asarray(jh.prim_idx))
    t, ref = th.t.numpy(), np.asarray(jh.t)
    hit = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(t), hit)
    atol = TOL * float(np.asarray(jscene.scale)) / np.linalg.norm(d, axis=1)
    assert (np.abs(t[hit] - ref[hit]) <= (TOL * ref + atol)[hit]).all()
    assert hit.mean() > 0.5


def test_chunking_keeps_the_winner(monkeypatch):
    """A chunk of one primitive and the default chunk give the same
    winners bit for bit (the lowest index wins a tie either way)."""
    _, tscene, o, d, _, _ = rays("scene_500", 3)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    ref = tix.intersect_bruteforce(tscene, o, d, T_MIN, float("inf"))
    monkeypatch.setitem(tix.PAIRS, "cpu", 1)
    assert tix.chunk_size(o.shape[0], "cpu") == 1
    one = tix.intersect_bruteforce(tscene, o, d, T_MIN, float("inf"))
    for a, b in zip(ref, one):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("name", NAMES)
def test_hit_attributes_match_jax(name):
    jscene, tscene, o, d, _, _ = rays(name, 70 + NAMES.index(name))
    jh = jax_hit(jscene, o, d)
    ja = jix.hit_attributes(jscene, jnp.asarray(o), jnp.asarray(d), jh)
    th = tix.Hit(*(torch.from_numpy(np.array(x)) for x in jh))
    ta = tix.hit_attributes(tscene, torch.from_numpy(o), torch.from_numpy(d),
                            th)
    for field in ta._fields:
        ours, ref = getattr(ta, field).numpy(), np.asarray(getattr(ja, field))
        if ours.dtype == bool or field == "mat_id":
            np.testing.assert_array_equal(ours, ref, err_msg=field)
        else:
            keep = np.isfinite(ref)
            np.testing.assert_allclose(ours[keep], ref[keep], rtol=TOL,
                                       atol=TOL, err_msg=field)


@pytest.mark.parametrize("name", NAMES)
def test_scatter_matches_jax(name):
    """``materials.scatter`` on JAX's attributes and the same uniform
    rows."""
    jscene, tscene, o, d, _, uni = rays(name, 80 + NAMES.index(name))
    jh = jax_hit(jscene, o, d)
    ja = jix.hit_attributes(jscene, jnp.asarray(o), jnp.asarray(d), jh)
    js = jmat.scatter(jscene, jnp.asarray(uni), jnp.asarray(d), ja)
    ta = tix.HitAttrs(*(torch.from_numpy(np.array(x)) for x in ja))
    ts = tmat.scatter(tscene, torch.from_numpy(uni), torch.from_numpy(d), ta)
    np.testing.assert_array_equal(ts.interaction.numpy(),
                                  np.asarray(js.interaction))
    assert len(np.unique(ts.interaction.numpy())) >= 3
    for field in ("direction", "attenuation", "emitted"):
        np.testing.assert_allclose(getattr(ts, field).numpy(),
                                   np.asarray(getattr(js, field)), rtol=TOL,
                                   atol=TOL, err_msg=field)
    jb = jmat.bsdf(jscene, ja.mat_id, ja.p, ja.uv)
    tb = tmat.bsdf(tscene, ta.mat_id, ta.p, ta.uv)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=TOL,
                               atol=TOL)
    je = jmat.emitted(jscene, ja)
    np.testing.assert_allclose(tmat.emitted(tscene, ta).numpy(),
                               np.asarray(je), rtol=TOL, atol=TOL)


def test_vec_matches_jax():
    rng = np.random.default_rng(4)
    a, b = (rng.normal(size=(512, 3)).astype(np.float32) for _ in range(2))
    a[:4] = 0.0
    eta = rng.uniform(0.5, 2.0, 512).astype(np.float32)
    u = np.asarray(jvec.unit(jnp.asarray(a)))
    cases = [(jvec.dot, tvec.dot, (a, b)), (jvec.cross, tvec.cross, (a, b)),
             (jvec.unit, tvec.unit, (a,)), (jvec.near_zero, tvec.near_zero,
                                            (a * 1e-9,)),
             (jvec.reflect, tvec.reflect, (a, u)),
             (jvec.refract, tvec.refract, (u, np.asarray(jvec.unit(
                 jnp.asarray(b))), eta))]
    for jf, tf, args in cases:
        ref = np.asarray(jf(*(jnp.asarray(x) for x in args)))
        ours = tf(*(torch.from_numpy(np.array(x)) for x in args)).numpy()
        np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL,
                                   err_msg=tf.__name__)


def test_camera_rays_match_jax():
    """``camera_rays_from`` on the uniforms that JAX ``camera_rays`` draws
    from its key (jitter x, jitter y, then the lens disk's two), on a
    camera with a lens."""
    import jax
    from raytracer_tpu.scene.builder import SceneBuilder as JBuilder
    from raytracer_tpu_torch.scene.builder import SceneBuilder as TBuilder

    def scene(builder):
        b = builder()
        b.add_sphere((0, 0, -2), 0.5, b.lambertian(b.constant_texture(
            (0.5, 0.5, 0.5))))
        b.set_camera((0, 1, 3), (0, 0, -2), vfov=45, aspect_ratio=1.5,
                     aperture=0.3, focus_dist=4.0)
        return b.compile()

    key = jax.random.PRNGKey(3)
    ids = np.arange(0, 48 * 32, 3, dtype=np.int32)
    jo, jd = jcamera.camera_rays(scene(JBuilder).camera, key,
                                 jnp.asarray(ids), 48, 32)
    k_jx, k_jy, k_lens = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_lens)
    n = ids.shape[0]
    uni = np.stack([np.asarray(jax.random.uniform(k, (n,)))
                    for k in (k_jx, k_jy, k1, k2)])
    to, td = tcamera.camera_rays_from(scene(TBuilder).camera,
                                      torch.from_numpy(uni),
                                      torch.from_numpy(ids).long(), 48, 32)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_dispatch_route_matches_kernel_route(name):
    """``dispatch.intersect_scene(method="bruteforce")`` against the
    kernel route's plain closest hit on (3, N) rays: the same winners off
    a float32 edge, t as ``test_intersect_bruteforce_matches_jax`` holds
    it, triangle barycentrics within 1e-4."""
    jscene, tscene, o, d, alive, _ = rays(name, 90 + NAMES.index(name))
    ot, dt = torch.from_numpy(o.T.copy()), torch.from_numpy(d.T.copy())
    al = torch.from_numpy(alive)
    tab = fused_bounce.pack_tables(tscene)
    bf = dispatch.intersect_scene(tscene, ot, dt, T_MIN, float("inf"),
                                  "bruteforce", alive=al)
    kr = dispatch.intersect_scene(tscene, ot, dt, T_MIN, float("inf"),
                                  "pallas", alive=al, tables=tab)
    same = (bf.ty == kr.ty).numpy() & (bf.ix == kr.ix).numpy()
    assert (~same).mean() <= 0.001
    assert (bf.ty.numpy()[~alive] == -1).all()
    hit = same & np.isfinite(kr.t.numpy())
    atol = TOL * float(np.asarray(jscene.scale)) / np.linalg.norm(d, axis=1)
    t, ref = bf.t.numpy()[hit], kr.t.numpy()[hit]
    assert (np.abs(t - ref) <= TOL * ref + atol[hit]).all()
    for a, b in ((bf.b1, kr.b1), (bf.b2, kr.b2)):
        np.testing.assert_allclose(a.numpy()[hit], b.numpy()[hit],
                                   atol=1e-4)


def test_render_within_jax_golden_bands():
    img, rays_ = path_tracer.render(
        tbuiltin.three_spheres(1.0),
        GOLDEN_CFG.replace(intersector="bruteforce"), 7, device="cpu")
    assert img.shape == (32, 32, 3) and torch.isfinite(img).all()
    assert rays_ > 32 * 32 * 64
    check_against("three_spheres_32.npz", img.numpy())


@pytest.mark.parametrize("kw", [dict(nee=True), dict(mis=True)])
def test_nee_mis_within_jax_golden_bands(kw):
    """NEE and MIS on the brute-force route (shadow rays through the
    brute-force closest hit), brightness in linear space."""
    img, _ = path_tracer.render(
        tbuiltin.three_spheres(1.0),
        GOLDEN_CFG.replace(intersector="bruteforce", **kw), 7, device="cpu")
    assert torch.isfinite(img).all()
    check_bands_linear_mean("three_spheres_32.npz", img.numpy())


def test_render_fn_routes_agree_and_repeat():
    """The brute-force route against the kernel route at the same size
    (linear means within 3% at 128 spp), and the brute-force render
    bit-identical on a repeat; a moving scene renders through it with
    its shutter times."""
    kw = dict(width=24, height=16, spp=128, spp_chunk=8, max_depth=8,
              t_min=T_MIN, spawn_eps_rel=1e-5, device="cpu")
    scene = tbuiltin.three_spheres(1.5)
    means = {}
    for route in ("bruteforce", "pallas"):
        img, rays_ = path_tracer.render_fn(
            scene, torch.Generator().manual_seed(2), intersector=route, **kw)
        assert torch.isfinite(img).all() and rays_ >= 24 * 16 * 128
        means[route] = float(img.mean())
    assert abs(means["bruteforce"] / means["pallas"] - 1) < 0.03, means
    small = {**kw, "spp": 4, "spp_chunk": 2}
    a = path_tracer.render_fn(scene, torch.Generator().manual_seed(5),
                              intersector="bruteforce", **small)
    b = path_tracer.render_fn(scene, torch.Generator().manual_seed(5),
                              intersector="bruteforce", **small)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    assert a[1] == b[1]
    img, _ = path_tracer.render_fn(
        tbuiltin.motion_field(30, 1.5), torch.Generator().manual_seed(1),
        intersector="bruteforce", **small)
    assert torch.isfinite(img).all() and float(img.mean()) > 0


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch", "render", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120)


# "bvh" is ported (A10): it renders (the case keeps its id)
@pytest.mark.parametrize("args,code,said", [
    (["--intersector", "bruteforce"], 0, "rays"),
    (["--intersector", "bruteforce", "--nee"], 0, "NEE shadow rays"),
    pytest.param(["--intersector", "bvh"], 0, "rays",
                 id="args2-2-ROADMAP A10")])
def test_cli_bruteforce_renders_and_bvh_refuses(args, code, said,
                                                tmp_path):
    out = tmp_path / "bf.png"
    res = _cli(*args, "--scene", "spheres", "--width", "16", "--height",
               "12", "--spp", "2", "--max-depth", "4", "--device", "cpu",
               "--out", str(out))
    assert res.returncode == code, res.stderr
    assert said in (res.stdout if code == 0 else res.stderr)
    if code == 0:
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
