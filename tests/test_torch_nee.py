"""The port's NEE and MIS (``raytracer_tpu_torch.ops.nee``, ``ops.mis`` and
the loops of ``models/wavefront_soa.py``) against the JAX package.

Estimator level, exact: the deterministic parts (``direct_light_from``,
``sample_light_dir_from``, ``mixture_reweight_from``, ``light_pdf``) are
fed the draws that the JAX functions make from their keys, reproduced
here with the same key splits (nee.py:137-164, mis.py:62-80 and 162-163
of the JAX package). Tolerance 1e-5 relative; a lane whose shadow ray's
visibility flips on a float32 edge may differ outright, on at most 0.1% of
the lanes.

Image level, statistical: the two packages draw from different streams, so
the NEE and MIS means are held to plain PT's with the bounds of the JAX
tests (tests/test_nee.py:41-50, tests/test_mis.py:143-147), the Cornell
direct-light oracle and the golden bands.
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

from raytracer_tpu.ops import mis as jmis  # noqa: E402
from raytracer_tpu.ops.nee import direct_light as jax_direct_light  # noqa
from raytracer_tpu_torch.models import path_tracer  # noqa: E402
from raytracer_tpu_torch.models import wavefront_soa as twf  # noqa: E402
from raytracer_tpu_torch.ops import closest_hit, fused_bounce  # noqa: E402
from raytracer_tpu_torch.ops import mis, nee  # noqa: E402
from raytracer_tpu_torch.ops.lights import pick_light  # noqa: E402
from raytracer_tpu_torch.scene import builtin as tbuiltin  # noqa: E402
from raytracer_tpu_torch.scene.builder import SceneBuilder  # noqa: E402
from test_golden import GOLDEN  # noqa: E402
from test_torch_bounce import SCENES, T_MIN, make_rays  # noqa: E402
from test_torch_render import GOLDEN_CFG  # noqa: E402

NAMES = sorted(SCENES)
ROOT = os.path.join(os.path.dirname(__file__), "..")
ORACLE = 0.01046        # tests/test_nee.py: Cornell floor direct light


def shading_points(name, seed):
    """Diffuse-vertex stand-ins: the port's closest hits of ``make_rays``
    (80% of the hits marked valid), random albedos. Returns the scenes,
    tables and numpy (3, N) p, n, albedo and (N,) valid, alive."""
    jscene, tscene = SCENES[name][0](), SCENES[name][1]()
    o, d, alive, _ = make_rays(jscene, seed)
    tab = fused_bounce.pack_tables(tscene)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    hit = closest_hit.closest_tables(tab, to, td, T_MIN, float("inf"),
                                     torch.from_numpy(alive))
    h, _ = twf.attrs_soa(tab, to, td, hit)
    rng = np.random.default_rng(50 + seed)
    valid = h.valid.numpy() & (rng.random(alive.shape[0]) < 0.8)
    albedo = rng.random(o.shape, dtype=np.float32)
    return (jscene, tscene, tab, h.p.numpy(), h.n.numpy(), albedo, valid,
            alive)


def jax_pick(lights, key, n):
    if lights.kind.shape[0] > 1:
        idx = jax.random.categorical(key, lights.log_prob, shape=(n,))
    else:
        idx = jnp.zeros((n,), jnp.int32)
    return torch.from_numpy(np.array(idx)).long()


def jax_nee_draws(jscene, key, n):
    """The light index and uniform rows of JAX ``direct_light``'s first
    sample: fold 1000 then 0, split into pick / hemisphere / rect uv keys;
    the hemisphere's ``uniform_sphere`` splits its key once more."""
    k = jax.random.fold_in(jax.random.fold_in(key, 1000), 0)
    k_pick, k1, k2 = jax.random.split(k, 3)
    ka, kb = jax.random.split(k1)
    uv = jax.random.uniform(k2, (n, 2))
    rows = [jax.random.uniform(ka, (n,)), jax.random.uniform(kb, (n,)),
            uv[:, 0], uv[:, 1]]
    return (jax_pick(jscene.lights, k_pick, n),
            torch.from_numpy(np.stack([np.asarray(r) for r in rows])))


def jax_mis_draws(jscene, key, n):
    """``mixture_reweight``'s draws: choice, then ``sample_light_dir``'s
    pick, u1, u2."""
    k_choice, k_light = jax.random.split(key)
    k_pick, k1, k2 = jax.random.split(k_light, 3)
    return (torch.from_numpy(np.array(jax.random.uniform(k_choice, (n,)))),
            jax_pick(jscene.lights, k_pick, n),
            *(torch.from_numpy(np.array(jax.random.uniform(k, (n,))))
              for k in (k1, k2)))


def assert_close_but_edges(ours, ref, what):
    """rtol 1e-5 (atol 1e-7 of the largest value) except on lanes that are
    zero in one package only (a visibility flip), at most 0.1% of them."""
    zero_o, zero_r = (np.abs(x).max(0) == 0 for x in (ours, ref))
    flip = zero_o != zero_r
    assert flip.sum() <= 0.001 * flip.size, f"{what}: {flip.sum()} flips"
    keep = ~flip
    np.testing.assert_allclose(ours[:, keep], ref[:, keep], rtol=1e-5,
                               atol=1e-7 * np.abs(ref).max(), err_msg=what)


@pytest.mark.parametrize("name", NAMES)
def test_direct_light_matches_jax(name):
    jscene, tscene, tab, p, n, albedo, valid, alive = shading_points(
        name, NAMES.index(name))
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jax_direct_light(
        jscene, key, jnp.asarray(p.T), jnp.asarray(n.T),
        jnp.asarray(albedo.T), jnp.asarray(valid),
        alive=jnp.asarray(alive))).T
    idx, uni = jax_nee_draws(jscene, key, p.shape[1])
    ours, cast = nee.direct_light_from(
        tscene, tab, idx, uni, torch.from_numpy(p), torch.from_numpy(n),
        torch.from_numpy(albedo), torch.from_numpy(valid),
        torch.from_numpy(alive))
    ours = ours.numpy()
    assert ours.shape == (3, p.shape[1]) and ours.dtype == np.float32
    assert_close_but_edges(ours, ref, "direct light")
    cast = cast.numpy()
    lit = np.abs(ours).max(0) > 0
    # real work: some shadow rays find the light, some are blocked
    assert lit.any() and (cast & ~lit).any()
    assert not (cast & ~(valid & alive)).any()


@pytest.mark.parametrize("name", NAMES)
def test_mixture_reweight_matches_jax(name):
    jscene, tscene, _, p, n, _, valid, _ = shading_points(
        name, 5 + NAMES.index(name))
    d_cos = np.random.default_rng(6).normal(size=p.shape).astype(np.float32)
    key = jax.random.PRNGKey(61)
    jd, jw = jmis.mixture_reweight(jscene, key, jnp.asarray(p.T),
                                   jnp.asarray(n.T), jnp.asarray(d_cos.T),
                                   jnp.asarray(valid))
    draws = jax_mis_draws(jscene, key, p.shape[1])
    d_new, w = mis.mixture_reweight_from(
        tscene.lights, *draws, torch.from_numpy(p), torch.from_numpy(n),
        torch.from_numpy(d_cos), torch.from_numpy(valid))
    np.testing.assert_allclose(d_new.numpy(), np.asarray(jd).T, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    took_light = valid & (draws[0].numpy() < 0.5)
    assert took_light.any() and (w.numpy()[valid] != 1.0).any()


@pytest.mark.parametrize("chunk_pairs", [None, 4096])
def test_light_pdf_matches_jax_on_scene_500(chunk_pairs, monkeypatch):
    """scene_500's 501 lights, seen from points 1 to 5 units from a random
    light: half the directions point at a light (so the pdf is non-zero),
    half are uniform; with ``PDF_PAIRS`` cut to 4096 the evaluation runs in
    256 chunks of 8 lanes and must not change.

    A sphere light's term is prob / (2 pi (1 - cos_max)), and for these
    lights (radius ~0.045) cos_max is 0.9997-0.99999: one float32 ulp of
    cos_max, which the two packages may round apart, moves the term by
    2^-24 / (1 - cos_max) relative. A lane's tolerance is 1e-5 relative
    plus four such ulps of the narrowest cone that contains its
    direction."""
    if chunk_pairs:
        monkeypatch.setattr(mis, "PDF_PAIRS", chunk_pairs)
    jscene, tscene = SCENES["scene_500"][0](), SCENES["scene_500"][1]()
    lights = tscene.lights
    assert lights.kind.shape[0] == 501
    rng = np.random.default_rng(7)
    n = 2048
    centres = lights.p0.numpy()
    off = rng.normal(size=(3, n))
    off *= rng.uniform(1.0, 5.0, n) / np.linalg.norm(off, axis=0)
    off[1] = np.abs(off[1])
    p = (centres[rng.integers(0, len(centres), n)].T + off).astype(np.float32)
    u = rng.normal(size=(3, n))
    u = (u / np.linalg.norm(u, axis=0)).astype(np.float32)
    draws = jax_mis_draws(jscene, jax.random.PRNGKey(3), n)
    d_light = mis.sample_light_dir_from(lights, *draws[1:],
                                        torch.from_numpy(p)).numpy()
    d = np.where(np.arange(n) % 2 == 0, d_light, u).astype(np.float32)
    ref = np.asarray(jmis.light_pdf(jscene, jnp.asarray(p.T),
                                    jnp.asarray(d.T)))
    ours = mis.light_pdf(lights, torch.from_numpy(p),
                         torch.from_numpy(d)).numpy()
    assert (ours[::2] > 0).mean() > 0.99

    to_c = centres[None].astype(np.float64) - p.T[:, None]      # (n, L, 3)
    dist2 = (to_c * to_c).sum(-1)
    cos_max = np.sqrt(np.clip(1.0 - lights.r0.numpy() ** 2 / dist2, 0, 1))
    cos_d = (to_c * d.T[:, None]).sum(-1) / np.sqrt(dist2)
    amp = np.where(cos_d >= cos_max - 1e-6,
                   1.0 / np.maximum(1.0 - cos_max, 1e-8), 0.0).max(1)
    rtol = 1e-5 + 4 * 2.0 ** -24 * amp
    assert (np.abs(ours - ref) <= rtol * np.abs(ref) + 1e-7 * ref.max()).all()


@pytest.mark.parametrize("name", ["three_spheres", "scene_500"])
def test_sample_light_dir_matches_jax(name):
    jscene, tscene, _, p, _, _, _, _ = shading_points(name, 40)
    key = jax.random.PRNGKey(17)
    ref = np.asarray(jmis.sample_light_dir(jscene, key, jnp.asarray(p.T)))
    # sample_light_dir splits its key into pick, u1, u2
    k_pick, k1, k2 = jax.random.split(key, 3)
    idx = jax_pick(jscene.lights, k_pick, p.shape[1])
    u1, u2 = (torch.from_numpy(np.array(jax.random.uniform(
        k, (p.shape[1],)))) for k in (k1, k2))
    ours = mis.sample_light_dir_from(tscene.lights, idx, u1, u2,
                                     torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(ours, ref.T, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=0), 1.0, rtol=1e-5)


def test_pick_light_follows_the_light_power():
    """Inverse-CDF picks over scene_500's 501 lights land in proportion to
    their probabilities (within 5 standard deviations per light)."""
    lights = SCENES["scene_500"][1]().lights
    n = 400_000
    u = torch.rand(n, generator=torch.Generator().manual_seed(3))
    counts = torch.bincount(pick_light(lights, u), minlength=501).double()
    prob = lights.prob.double()
    sd = torch.sqrt(n * prob * (1 - prob)).clamp(min=1.0)
    assert ((counts - n * prob).abs() <= 5 * sd).all()


def test_no_lights_gives_no_direct_light():
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -1.0), 0.5,
                 b.lambertian(b.constant_texture((0.5, 0.5, 0.5))))
    scene = b.compile()
    n = 8
    p = torch.zeros((3, n))
    nrm = torch.tensor([0.0, 1.0, 0.0])[:, None].expand(3, n)
    ones = torch.ones(n, dtype=torch.bool)
    dl, cast = nee.direct_light(scene, fused_bounce.pack_tables(scene),
                                torch.rand((nee.NEE_ROWS, n)), p, nrm,
                                torch.ones((3, n)), ones, ones)
    assert (dl == 0).all() and not cast.any()
    d_new, w = mis.mixture_reweight(scene.lights, torch.rand((4, n)), p,
                                    nrm, 2.0 * nrm, ones)
    assert (w == 1).all() and torch.allclose(d_new, nrm)


def check_bands_linear_mean(golden_name, img):
    """The golden bands of ``test_golden.check_against`` with the global
    brightness held in linear space: mean within 5% of the golden's, p95
    |diff| < 0.30 and mean |diff| < 0.08 in gamma space. A variance-reduced
    render's gamma-space mean is higher than a plain render's at the same
    sample count (E[sqrt X] < sqrt E[X] by an amount that grows with the
    variance), so next to the noisier 64-spp golden the gamma mean of an
    NEE or MIS render measures noise, not brightness."""
    ref = np.load(os.path.join(GOLDEN, golden_name))["img"]
    assert img.shape == ref.shape
    assert abs(img.mean() - ref.mean()) < 0.05 * ref.mean(), (
        f"linear mean {img.mean():.5f} vs golden {ref.mean():.5f}")
    diff = np.abs(np.sqrt(np.clip(img, 0, None)) - np.sqrt(ref))
    assert np.percentile(diff, 95) < 0.30 and diff.mean() < 0.08


def cornell_shot(n, seed, depth, **kw):
    """tests/test_nee.py::shoot: n straight-down rays from (278, 120, 278)
    in the Cornell box without its mesh."""
    scene = tbuiltin.cornell_box(with_mesh=False)
    o = torch.tensor([278.0, 120.0, 278.0]).expand(n, 3)
    d = torch.tensor([0.0, -1.0, 0.0]).expand(n, 3)
    res = path_tracer.trace_radiance(
        scene, o, d, torch.Generator().manual_seed(seed), max_depth=depth,
        t_min=1e-3, spawn_eps=0.05, russian_roulette=False, **kw)
    assert res.radiance.shape == (n, 3)
    assert torch.isfinite(res.radiance).all()
    return res.radiance.numpy().astype(np.float64), res.rays_traced


def test_nee_matches_analytic_direct_lighting():
    rad, rays = cornell_shot(16384, 0, 1, nee=True)
    assert rays == 16384         # shadow rays are not counted as rays
    np.testing.assert_allclose(rad.mean(0).mean(), ORACLE, rtol=0.05)


def test_nee_same_mean_as_plain_pt():
    r_pt, _ = cornell_shot(65536, 1, 2)
    r_ne, _ = cornell_shot(8192, 2, 1, nee=True)
    np.testing.assert_allclose(r_ne.mean(0).mean(), r_pt.mean(0).mean(),
                               rtol=0.12)


def test_mis_same_mean_as_plain_pt_with_lower_variance():
    """tests/test_mis.py::test_mis_runs_on_soa_fast_path's bounds."""
    n = 16384
    r_pt, _ = cornell_shot(n, 3, 4)
    r_mis, _ = cornell_shot(n, 4, 4, mis=True)
    se = r_pt.mean(-1).std() / np.sqrt(n)
    np.testing.assert_allclose(
        r_mis.mean(), r_pt.mean(),
        atol=4 * se + 4 * r_mis.mean(-1).std() / np.sqrt(n) + 1e-4)
    assert r_mis.mean(-1).std() < 0.8 * r_pt.mean(-1).std()


@pytest.mark.parametrize("kw", [dict(nee=True), dict(mis=True)])
def test_render_within_jax_golden_bands(kw):
    """three_spheres registers its one emitter, so NEE and MIS keep plain
    PT's image: the 32x32 render stays in the golden bands (brightness in
    linear space, ``check_bands_linear_mean``)."""
    stats = {}
    img, rays = path_tracer.render(tbuiltin.three_spheres(1.0),
                                   GOLDEN_CFG.replace(**kw), 7,
                                   device="cpu", stats=stats)
    assert torch.isfinite(img).all() and rays > 32 * 32 * 64
    assert (stats["shadow_lanes"] > 0) == bool(kw.get("nee"))
    check_bands_linear_mean("three_spheres_32.npz", img.numpy())


def test_nee_survives_the_drain_cascade(monkeypatch):
    """With the drain floor lowered the compaction runs five levels; the
    lanes' ``prev_diff`` flags must travel with them (a lost flag counts
    the light twice or not at all)."""
    monkeypatch.setattr(twf, "DRAIN_MIN_LANES", 256)
    img, _ = path_tracer.render(tbuiltin.three_spheres(1.0),
                                GOLDEN_CFG.replace(nee=True), 5,
                                device="cpu")
    check_bands_linear_mean("three_spheres_32.npz", img.numpy())


def test_unfused_route_renders_the_same_image(monkeypatch):
    """The regeneration loop on the unfused stage (closest hit + plain
    attributes and scatter) against the fused one, with NEE, from the same
    seed: the same draws reach both, so the images agree."""
    cfg = GOLDEN_CFG.replace(width=16, height=16, samples_per_pixel=8,
                             nee=True)
    scene = tbuiltin.three_spheres(1.0)
    fused, r1 = path_tracer.render(scene, cfg, 2, device="cpu")
    monkeypatch.setattr(twf, "use_fused", lambda scene, method: False)
    unfused, r2 = path_tracer.render(scene, cfg, 2, device="cpu")
    assert r1 == r2
    np.testing.assert_allclose(unfused.numpy(), fused.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_cli_renders_with_nee(tmp_path):
    out = tmp_path / "nee.png"
    res = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch", "render", "--scene",
         "cornell", "--width", "16", "--height", "16", "--spp", "2",
         "--max-depth", "3", "--nee", "--device", "cpu", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert "NEE shadow rays (not counted as rays)" in res.stdout
