"""The port's image and noise textures (``raytracer_tpu_torch.ops.noise``,
``ops.materials.image_texel``, ``models/wavefront_soa.py::
eval_texture_soa`` on the unfused stage) against the JAX package's
(``ops/noise.py``, ``ops/materials.py``, ``models/wavefront_soa.py``).

Tolerances:
- the noise tables bit-equal; ``perlin`` and ``turbulence`` within atol
  1e-5, ``marble`` within 1e-4, on 4,096 points that include negative
  coordinates (the ``i & 255`` wrap);
- image texels equal on a u, v grid over ``texture/earthmap.jpg`` (and a
  second, smaller image in the same padded atlas), except lanes whose
  w u or h (1 - v) lies within an ulp of an integer, counted apart (on
  this grid 13% of the image lanes, most of them clamped to an end);
- the unfused ``bounce_step`` on ``textured_spheres`` (an image sphere, a
  marble sphere, a sphere light), the same rays and scatter rows as
  ``test_torch_bounce.py``: interaction equal on >= 99.9% of alive lanes,
  p and the spawn origin within 1e-5 x scene.scale, the other vectors
  within rtol = atol = 1e-4;
- images (different random streams): radiance and image means within 4
  standard errors of their difference, each side's error from its own
  rays or renders, against JAX's (N, 3) route (``trace_radiance``/
  ``render_fn(intersector="bruteforce")``); that error is below 5% of
  the mean for the traced radiance and 10% for the renders.
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
from raytracer_tpu.ops import materials as jmat  # noqa: E402
from raytracer_tpu.ops import noise as jnoise  # noqa: E402
from raytracer_tpu.scene.builder import SceneBuilder as JBuilder  # noqa
from raytracer_tpu.utils.image import load_image as jload_image  # noqa
from raytracer_tpu_torch.models import path_tracer, sppm  # noqa: E402
from raytracer_tpu_torch.models import wavefront_soa as twf  # noqa: E402
from raytracer_tpu_torch.ops import fused_bounce, materials  # noqa: E402
from raytracer_tpu_torch.ops import noise as tnoise  # noqa: E402
from raytracer_tpu_torch.ops.leaf import build_leaf_tables  # noqa: E402
from raytracer_tpu_torch.scene import builtin as tbuiltin  # noqa: E402
from raytracer_tpu_torch.scene.builder import SceneBuilder as TBuilder  # noqa
from raytracer_tpu_torch.scene.types import (  # noqa: E402
    TEX_IMAGE, TEX_NOISE,
)
from raytracer_tpu_torch.utils.config import (  # noqa: E402
    RenderConfig, SPPMConfig,
)
from raytracer_tpu_torch.utils.image import load_image  # noqa: E402
from test_torch_bounce import T_MIN, make_rays  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
EARTH = os.path.join(ROOT, "texture", "earthmap.jpg")


@pytest.fixture(autouse=True, scope="module")
def _core_share():
    """Under pytest-xdist the workers share the machine's cores: run torch
    on this worker's share of them."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, min(old, (os.cpu_count() or 1) // workers)))
    yield
    torch.set_num_threads(old)


def points(seed=0, n=4096):
    """Points in [-40, 40)^3 (half of each coordinate negative), float32."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-40.0, 40.0, (n, 3)).astype(np.float32)


def test_noise_tables_are_bit_equal():
    for ours, ref in ((tnoise.PERM_X, jnoise._PERM_X),
                      (tnoise.PERM_Y, jnoise._PERM_Y),
                      (tnoise.PERM_Z, jnoise._PERM_Z),
                      (tnoise.GRAD, jnoise._GRAD)):
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        assert ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize("name", ["perlin", "turbulence"])
def test_noise_matches_jax(name):
    p = points(1)
    assert (p < 0).any(1).mean() > 0.8
    ref = np.asarray(getattr(jnoise, name)(jnp.asarray(p)))
    ours = getattr(tnoise, name)(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    assert ref.std() > 0.05


def test_marble_matches_jax():
    p = points(2)
    scale = np.random.default_rng(3).uniform(0.5, 8.0, p.shape[0]).astype(
        np.float32)
    ref = np.asarray(jnoise.marble(jnp.asarray(p), jnp.asarray(scale)))
    ours = tnoise.marble(torch.from_numpy(p), torch.from_numpy(scale))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4)
    assert (ref >= 0).all() and (ref <= 1).all() and ref.std() > 0.1


def atlas(builder, earth, small):
    """An earthmap texture, a smaller second image (padded in the atlas)
    and a marble texture."""
    b = builder()
    ids = [b.image_texture(earth), b.image_texture(small),
           b.noise_texture(scale=3.0)]
    for t in ids:
        b.add_sphere((0.0, 0.0, -2.0), 0.5, b.lambertian(t))
    return b.compile(), ids


def test_image_texels_match_jax():
    earth = load_image(EARTH)
    np.testing.assert_array_equal(earth, jload_image(EARTH))
    small = (np.random.default_rng(5).random((37, 53, 3)) * 255).astype(
        np.uint8)
    js, ids = atlas(JBuilder, earth, small)
    ts, _ = atlas(TBuilder, earth, small)
    # a u, v grid past both ends (clamped), on both images and the marble
    g = np.linspace(-0.05, 1.05, 181, dtype=np.float32)
    u, v = (x.ravel() for x in np.meshgrid(g, g))
    n = u.shape[0]
    tex = np.repeat(np.array(ids, np.int32), n)
    uv = np.tile(np.stack([u, v], -1), (3, 1))
    p = np.tile(points(4, n), (3, 1))
    ref = np.asarray(jmat.eval_texture(js, jnp.asarray(tex), jnp.asarray(p),
                                       jnp.asarray(uv)))
    ours = materials.eval_texture(ts, torch.from_numpy(tex),
                                  torch.from_numpy(p), torch.from_numpy(uv))
    wh = ts.image_wh.numpy()[np.clip(ts.textures.image_id.numpy()[tex], 0,
                                     None)]
    x = wh * np.clip(uv, 0, 1) * np.array([1, -1], np.float32) \
        + np.array([0, 1], np.float32) * wh
    on_edge = ((np.abs(x - np.round(x)) <= np.spacing(np.abs(x)))
               .any(1) & (tex != ids[2]))
    img = tex != ids[2]
    assert (img & ~on_edge).sum() >= 0.8 * img.sum()
    np.testing.assert_array_equal(ours.numpy()[img & ~on_edge],
                                  ref[img & ~on_edge])
    np.testing.assert_allclose(ours.numpy()[~img], ref[~img], atol=1e-4)
    # the SoA evaluation reads the same texels
    f = twf.FeatSoA(kind=torch.zeros(3 * n, dtype=torch.int32),
                    fuzz=torch.zeros(3 * n), ir=torch.ones(3 * n),
                    tex_kind=ts.textures.kind[torch.from_numpy(tex).long()],
                    c0=ts.textures.color0[torch.from_numpy(tex).long()].T,
                    c1=ts.textures.color1[torch.from_numpy(tex).long()].T,
                    image_id=ts.textures.image_id[
                        torch.from_numpy(tex).long()])
    h = twf.HitSoA(torch.ones(3 * n, dtype=torch.bool), torch.ones(3 * n),
                   torch.from_numpy(p.T.copy()), torch.zeros(3, 3 * n),
                   torch.ones(3 * n, dtype=torch.bool),
                   torch.from_numpy(uv[:, 0].copy()),
                   torch.from_numpy(uv[:, 1].copy()))
    np.testing.assert_array_equal(twf.eval_texture_soa(ts, f, h).numpy(),
                                  ours.numpy().T)


def check_unfused_bounce(js, ts, o, d, alive, uni):
    """JAX ``bounce_step(fused=False)`` (the closest-hit kernel in
    interpret mode, then its SoA texture evaluation) against the port's on
    the same rays ``o``/``d`` (3, N) and scatter rows, with
    ``test_torch_bounce.py``'s tolerances: a sphere normal also inherits
    the point difference over the radius (2 |dp| / r on n, 8 |dp| / r on
    nd). Returns the port's (HitSoA, FeatSoA) of the rays."""
    eps = float(uni[3, 0])
    jb = jwf.bounce_step(js, jnp.asarray(uni[:3]),
                         *(jnp.asarray(x) for x in o),
                         *(jnp.asarray(x) for x in d), jnp.asarray(alive),
                         t_min=T_MIN, spawn_eps=eps, intersector="pallas",
                         fused=False)
    tab = fused_bounce.pack_tables(ts)
    tb = twf.bounce_step(tab, torch.from_numpy(uni[:3]), torch.from_numpy(o),
                         torch.from_numpy(d), torch.from_numpy(alive),
                         t_min=T_MIN, spawn_eps=torch.tensor(eps),
                         fused=False, scene=ts)

    def rows(*names):
        return np.stack([np.asarray(getattr(jb, x)) for x in names])

    agree = (np.asarray(jb.inter) == tb.inter.numpy()) & alive
    assert agree.sum() >= 0.999 * alive.sum()
    hit, h, f = twf.dispatch.intersect_and_attrs(
        ts, torch.from_numpy(o), torch.from_numpy(d), T_MIN, float("inf"),
        alive=torch.from_numpy(alive), tables=tab)
    r = ts.spheres.radius.numpy()[np.clip(hit.ix.numpy(), 0, None)]
    dp = np.abs(tb.p.numpy() - rows("px", "py", "pz")).max(0) / r
    p_tol = 1e-5 * float(np.asarray(js.scale))
    for name, ours, ref, tol in (
            ("p", tb.p, rows("px", "py", "pz"), p_tol),
            ("no", tb.no, rows("nox", "noy", "noz"), p_tol),
            ("n", tb.n, rows("nx", "ny", "nz"), 1e-4 + 2 * dp),
            ("nd", tb.nd, rows("ndx", "ndy", "ndz"), 1e-4 + 8 * dp),
            ("att", tb.att, rows("ar", "ag", "ab"), 1e-4),
            ("emit", tb.emit, rows("er", "eg", "eb"), 1e-4)):
        rtol = 0 if name in ("p", "no") else 1e-4
        bad = np.abs(ours.numpy() - ref) > tol + rtol * np.abs(ref)
        assert not (bad.any(0) & agree).any(), (
            name, np.where(bad.any(0) & agree)[0][:8])
    return h, f


def test_unfused_bounce_on_textured_scene_matches_jax():
    js = tbuiltin.textured_spheres(builder=JBuilder)
    ts = tbuiltin.textured_spheres()
    o, d, alive, uni = make_rays(js, 7)
    h, f = check_unfused_bounce(js, ts, o, d, alive, uni)
    kinds = f.tex_kind.numpy()[alive & h.valid.numpy()]
    assert (kinds == TEX_IMAGE).sum() > 50 and (kinds == TEX_NOISE).sum() > 50


def earth_scene(builder, img):
    """tests/test_wavefront_soa.py:105-130's earthmap sphere under a
    sphere light."""
    b = builder()
    b.add_sphere((0, 0, -4), 2.0, b.lambertian(b.image_texture(img)))
    b.add_sphere((0, 6, -4), 1.0, b.diffuse_light(b.constant_texture(
        (4, 4, 4))))
    return b.compile()


def marble_scene(builder):
    """The same with a marble sphere."""
    b = builder()
    b.add_sphere((0, 0, -4), 2.0, b.lambertian(b.noise_texture(4.0)))
    b.add_sphere((0, 6, -4), 1.0, b.diffuse_light(b.constant_texture(
        (4, 4, 4))))
    return b.compile()


def earth_rays(n=2048):
    """tests/test_wavefront_soa.py:105-130's rays, (N, 3)."""
    rng = np.random.default_rng(6)
    d = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                  -np.ones(n)], -1).astype(np.float32)
    return np.zeros((n, 3), np.float32), d


def scenes(which):
    if which == "earth":
        img = load_image(EARTH)
        return earth_scene(JBuilder, img), earth_scene(TBuilder, img)
    return marble_scene(JBuilder), marble_scene(TBuilder)


@pytest.mark.parametrize("which", ["earth", "marble"])
def test_earth_and_marble_bounce_matches_jax(which):
    """The first bounce of those rays, on the same scatter rows."""
    js, ts = scenes(which)
    o, d = earth_rays()
    n = o.shape[0]
    uni = np.random.default_rng(8).random((4, n), dtype=np.float32)
    uni[3] = 1e-5 * float(np.asarray(js.scale))
    h, f = check_unfused_bounce(js, ts, o.T.copy(), d.T.copy(),
                                np.ones(n, bool), uni)
    assert (f.tex_kind.numpy()[h.valid.numpy()]
            == (TEX_IMAGE if which == "earth" else TEX_NOISE)).mean() > 0.9


def check_means(ours, ref, max_se=0.1):
    """Per-ray or per-render means within 4 standard errors of their
    difference, that error below ``max_se`` of the mean."""
    se = np.sqrt(ours.var(ddof=1) / ours.size + ref.var(ddof=1) / ref.size)
    assert abs(ours.mean() - ref.mean()) < 4 * se, (ours.mean(), ref.mean(),
                                                    se)
    assert se < max_se * ref.mean(), (se, ref.mean())


# enough copies of the 2,048 rays that each side's standard error is
# below 5% of the mean (the earth's radiance is the sparser)
TILES = {"earth": 1536, "marble": 768}
_TRACES = {}


def jax_trace(which, js, o, d, kw):
    if which not in _TRACES:
        jo, jd = (jnp.asarray(np.tile(x, (TILES[which], 1)))
                  for x in (o, d))
        _TRACES[which] = np.asarray(jpt.trace_radiance(
            js, jo, jd, jax.random.PRNGKey(5), intersector="bruteforce",
            **kw).radiance)
    return _TRACES[which]


@pytest.mark.parametrize("which", ["earth", "marble"])
@pytest.mark.parametrize("route", ["pallas", "bruteforce"])
def test_trace_radiance_matches_jax(which, route):
    """Those rays (depth 4), traced ``TILES`` times over by each package
    (JAX through its (N, 3) loop): the light is found only by a bounce
    that hits it, so few rays carry radiance; each side's error is held
    below 5% of the mean."""
    js, ts = scenes(which)
    o, d = earth_rays()
    kw = dict(max_depth=4, t_min=1e-3, spawn_eps=1e-3)
    ref = jax_trace(which, js, o, d, kw)
    tiles = TILES[which]
    res = path_tracer.trace_radiance(
        ts, torch.from_numpy(np.tile(o, (tiles, 1))),
        torch.from_numpy(np.tile(d, (tiles, 1))),
        torch.Generator().manual_seed(5), intersector=route, **kw)
    ours = res.radiance.numpy()
    assert np.isfinite(ours).all() and res.rays_traced >= tiles * o.shape[0]
    for c in range(3):
        check_means(ours[:, c], ref[:, c], 0.05)


RENDER = dict(width=32, height=24, spp=16, spp_chunk=4, max_depth=8,
              t_min=1e-3, spawn_eps_rel=1e-5)
REPEATS = 4


def port_renders(route, **kw):
    scene = tbuiltin.textured_spheres()
    if route == "leaf":
        scene = scene._replace(leaf=build_leaf_tables(scene))
    out = []
    for seed in range(REPEATS):
        img, rays = path_tracer.render_fn(
            scene, torch.Generator().manual_seed(seed), intersector=route,
            device="cpu", **{**RENDER, **kw})
        assert torch.isfinite(img).all() and rays >= 32 * 24 * 16
        out.append(float(img.mean()))
    return np.array(out)


_JAX = []


def jax_renders():
    if not _JAX:
        scene = tbuiltin.textured_spheres(builder=JBuilder)
        _JAX.append(np.array([float(np.asarray(jpt.render_fn(
            scene, jax.random.PRNGKey(k), intersector="bruteforce",
            **RENDER)[0]).mean()) for k in range(REPEATS)]))
    return _JAX[0]


@pytest.mark.parametrize("kw", [{}, dict(nee=True), dict(mis=True)],
                         ids=["pt", "nee", "mis"])
@pytest.mark.parametrize("route", ["pallas", "leaf", "bruteforce"])
def test_textured_render_matches_jax(route, kw):
    """``textured_spheres`` through every route, plain PT and with NEE and
    MIS (whose means are plain PT's: the light is registered and
    constant), against JAX's plain PT through its (N, 3) route."""
    check_means(port_renders(route, **kw), jax_renders())


def test_sppm_renders_textured_scene_on_the_unfused_stage(monkeypatch):
    """SPPM's measurement pass, photon pass and gather take the unfused
    stage on a textured scene (the fused kernel evaluates constant and
    checker textures only): a finite, nonzero image with no fused
    launch."""
    calls = []
    monkeypatch.setattr(twf, "bounce_tables",
                        lambda *a, **k: calls.append(1))
    cfg = RenderConfig(
        width=16, height=12, samples_per_pixel=2, spp_chunk=2, max_depth=6,
        sppm=SPPMConfig(n_iterations=2, photons_per_iter=4000,
                        max_photon_bounces=4, max_camera_bounces=6,
                        max_photons_per_cell=32))
    img, rays, state = sppm.render(tbuiltin.textured_spheres(), cfg, 0,
                                   device="cpu")
    assert not calls
    assert torch.isfinite(img).all() and float(img.mean()) > 0 and rays > 0
    assert int(state.iteration) == 2


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch", "render", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("args", [
    [], ["--nee"], ["--intersector", "leaf", "--mis"],
    ["--intersector", "bruteforce", "--mis"],
    ["--integrator", "sppm", "--sppm-iters", "1", "--sppm-photons", "2000"]])
def test_cli_renders_textured_scene(args, tmp_path):
    out = tmp_path / "tex.png"
    res = _cli("--scene", "textured", *args, "--width", "16", "--height",
               "12", "--spp", "2", "--max-depth", "4", "--device", "cpu",
               "--out", str(out))
    assert res.returncode == 0, res.stderr
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
