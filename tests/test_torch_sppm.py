"""The port's SPPM integrator (``raytracer_tpu_torch.models.sppm``, its
photon pass and emission in ``models.wavefront_soa``, and
``utils.checkpoint``) against the JAX package's.

The two packages draw from different random streams (threefry against
torch's generator), so the random passes are compared in distribution and
the image within the Monte-Carlo bands of the JAX-made golden; the
deterministic parts (the stat update, the density estimates, the
checkpoint format) are compared on the same numpy inputs.

Bands of the photon pass (Cornell with its mesh, 8,000 photons, 8,000
lanes, at most 6 bounces): over JAX seeds 0-5 the deposit count has a
relative standard deviation of 1.43%, the deposited flux per photon 1.52%
and the caustic count 6.29%. One port seed is held to one JAX seed within
4 standard deviations of the difference of two draws (4 * sqrt(2) * those).
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

from raytracer_tpu.models import sppm as jsppm  # noqa: E402
from raytracer_tpu.models import wavefront_soa as jwf  # noqa: E402
from raytracer_tpu.ops.photon_grid import QueryResult  # noqa: E402
from raytracer_tpu.scene import builtin as jbuiltin  # noqa: E402
from raytracer_tpu.utils import checkpoint as jckpt  # noqa: E402
from raytracer_tpu_torch.models import sppm  # noqa: E402
from raytracer_tpu_torch.models import wavefront_soa as twf  # noqa: E402
from raytracer_tpu_torch.ops import photon_grid as tpg  # noqa: E402
from raytracer_tpu_torch.ops.fused_bounce import pack_tables  # noqa: E402
from raytracer_tpu_torch.scene import builtin as tbuiltin  # noqa: E402
from raytracer_tpu_torch.scene.builder import SceneBuilder  # noqa: E402
from raytracer_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from raytracer_tpu_torch.utils.config import (  # noqa: E402
    RenderConfig, SPPMConfig)
from test_golden import check_against  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
SPREAD = {"deposits": 0.0143, "flux": 0.0152, "caustic": 0.0629}
BAND = {k: 4 * np.sqrt(2) * v for k, v in SPREAD.items()}


def tiny_config(n_iterations=3):
    """tests/test_sppm.py::tiny_config."""
    return RenderConfig(
        width=24, height=24, samples_per_pixel=4, spp_chunk=2, max_depth=8,
        sppm=SPPMConfig(n_iterations=n_iterations, photons_per_iter=8000,
                        max_photon_bounces=6, max_camera_bounces=8,
                        max_photons_per_cell=32))


def random_stats(seed, n=600):
    """A numpy SPPM half, measurement points and query result: a third of
    the pixels untouched, a tenth of the points invalid, some empty
    queries."""
    rng = np.random.default_rng(seed)
    f = np.float32
    photons = np.where(rng.random(n) < 0.33, 0.0,
                       rng.uniform(1, 200, n)).astype(f)
    half = (rng.uniform(0, 5e7, (n, 3)).astype(f),
            rng.uniform(0.5, 120, n).astype(f), photons)
    pts = (rng.random(n) > 0.1, rng.uniform(0, 555, (n, 3)).astype(f),
           rng.normal(size=(n, 3)).astype(f),
           rng.uniform(0, 1, (n, 3)).astype(f))
    count_r = np.floor(rng.uniform(0, 40, n) * (rng.random(n) > 0.2))
    count_cap = count_r + np.floor(rng.uniform(0, 300, n))
    q = (rng.uniform(0, 1e7, (n, 3)).astype(f), count_r.astype(f),
         rng.uniform(0, 1e8, (n, 3)).astype(f), count_cap.astype(f))
    return half, pts, q


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("k,alpha", [(100, 0.7), (50, 0.5)])
def test_update_half_matches_jax(k, alpha):
    half, pts, q = random_stats(k)
    cap = np.float32(10.673077)
    jh = jsppm._update_half(
        jsppm.SPPMHalf(*map(jnp.asarray, half)),
        jsppm.MeasurePoints(*map(jnp.asarray, pts)),
        QueryResult(*map(jnp.asarray, q)), k, alpha, jnp.asarray(cap))
    th = sppm._update_half(
        sppm.SPPMHalf(*map(t, half)), twf.MeasurePoints(*map(t, pts)),
        tpg.QueryResult(*map(t, q)), k, alpha, t(cap))
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_density_estimates_match_jax():
    half_g, _, _ = random_stats(1)
    half_c, _, _ = random_stats(2)
    n_total = 4 * 20_000
    est_j = jsppm.density_estimates(
        jsppm.SPPMState(jsppm.SPPMHalf(*map(jnp.asarray, half_g)),
                        jsppm.SPPMHalf(*map(jnp.asarray, half_c)),
                        jnp.int32(4)), n_total)
    est_t = sppm.density_estimates(
        sppm.SPPMState(sppm.SPPMHalf(*map(t, half_g)),
                       sppm.SPPMHalf(*map(t, half_c)), 4), n_total)
    np.testing.assert_allclose(est_t.numpy(), np.asarray(est_j), rtol=1e-6)


def jax_state(seed=3):
    half_g, _, _ = random_stats(seed)
    half_c, _, _ = random_stats(seed + 1)
    return jsppm.SPPMState(jsppm.SPPMHalf(*map(jnp.asarray, half_g)),
                           jsppm.SPPMHalf(*map(jnp.asarray, half_c)),
                           jnp.int32(7))


def assert_same_state(port, ref):
    assert int(port.iteration) == int(np.asarray(ref.iteration))
    for a, b in zip(list(port.glob) + list(port.caustic),
                    list(ref.glob) + list(ref.caustic)):
        b = np.asarray(b)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_checkpoint_from_jax_resumes_in_port(tmp_path):
    path = str(tmp_path / "jax.npz")
    ref = jax_state()
    jckpt.save_state(path, ref, seed=11)
    state, seed = tckpt.load_state(path)
    assert seed == 11
    assert_same_state(state, ref)
    assert_same_state(tckpt.sppm_state_from_numpy(ref), ref)


def test_checkpoint_from_port_resumes_in_jax(tmp_path):
    path = str(tmp_path / "sub" / "port.npz")
    port = tckpt.sppm_state_from_numpy(jax_state(5))
    tckpt.save_state(path, port, seed=13)
    state, seed = jckpt.load_state(path)
    assert seed == 13 and state.iteration.dtype == jnp.int32
    assert_same_state(port, state)
    assert not os.path.exists(path + ".tmp")


def test_emission_matches_jax_in_distribution():
    """65,536 photons from the Cornell light: origins on the light rect at
    y = 554, directions into the lower hemisphere, and the mean power per
    photon (flux * scale * E[cos] = 5e5 per channel) equal to JAX's within
    4 standard deviations of the difference of two means (cos is uniform
    on [0, 1]: sd 0.289 / 0.5 / sqrt(65536) = 0.23% each)."""
    n = 65536
    lights_t = tbuiltin.cornell_box(with_mesh=True).lights
    o, d, w = twf.emit_photons_soa(lights_t, torch.Generator().manual_seed(0),
                                   n)
    assert o.shape == d.shape == w.shape == (3, n)
    # rows go to the bounce kernel as they are: it takes contiguous rows
    assert o.is_contiguous() and d.is_contiguous() and w.is_contiguous()
    assert torch.all(o[1] == 554.0)
    assert torch.all((o[0] >= 213) & (o[0] <= 343) & (o[2] >= 227)
                     & (o[2] <= 332))
    assert torch.all(d[1] <= 0.0) and (d[1] < 0).float().mean() > 0.999
    torch.testing.assert_close(d.norm(dim=0), torch.ones(n), rtol=1e-5,
                               atol=1e-5)
    j = jwf.emit_photons_soa(jbuiltin.cornell_box(with_mesh=True).lights,
                             jax.random.PRNGKey(0), n)
    jw = np.stack([np.asarray(x) for x in j[6:9]])
    band = 4 * np.sqrt(2) * 0.2887 / 0.5 / np.sqrt(n)
    np.testing.assert_allclose(w.double().mean(1).numpy(),
                               jw.astype(np.float64).mean(1), rtol=band)
    # both packages pick the rect uniformly: the same mean origin
    np.testing.assert_allclose(o.double().mean(1).numpy(),
                               [278.0, 554.0, 279.5], rtol=2e-3)


def test_photon_pass_matches_jax():
    B = L = 8000
    MB = 6
    scene_j = jbuiltin.cornell_box(with_mesh=True)
    eps = 1e-5 * float(scene_j.scale)
    comps, sp_j = jwf.trace_photon_deposits_regen_soa(
        scene_j, jax.random.PRNGKey(0), B, MB, 1e-4, eps, "pallas",
        lanes=L, return_spawned=True)
    scene_t = tbuiltin.cornell_box(with_mesh=True)
    dep, sp_t = twf.trace_photon_deposits_regen_soa(
        scene_t, pack_tables(scene_t), torch.Generator().manual_seed(0), B,
        MB, 1e-4, eps, lanes=L)
    assert int(sp_t) == int(sp_j) == B
    assert dep.pos.shape == (3, len(np.asarray(comps[0])))
    v = np.asarray(comps[9])
    ref = {"deposits": v.sum(), "caustic": np.asarray(comps[10]).sum(),
           "flux": np.stack([np.asarray(c) for c in comps[3:6]])[:, v].sum(1)
           / B}
    ours = {"deposits": int(dep.valid.sum()),
            "caustic": int(dep.caustic.sum()),
            "flux": dep.power[:, dep.valid].double().sum(1).numpy() / B}
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=BAND[k], err_msg=k)
    assert not (dep.caustic & ~dep.valid).any()


def test_photon_pass_at_the_rules_lanes_matches_jax(monkeypatch):
    """The regenerating pass at the lane rule's shape against JAX's on
    the same lanes: 8,000 photons with the rule's floor pinned to 1,024
    lanes take the rule's 4,096 lanes, a 4-step spawn window and 20 steps
    at 16 bounces (the cell's 500,000 photons take 250,880 lanes and the
    same 20 steps). Deposits, caustic count and flux per photon agree
    within BAND."""
    monkeypatch.setattr(twf, "PHOTON_LANES", 1024)
    B, MB = 8000, 16
    L = twf.photon_lanes(B)
    assert (L, twf.spawn_window(B, L)) == (4096, 4)
    scene_j = jbuiltin.cornell_box(with_mesh=True)
    eps = 1e-5 * float(scene_j.scale)
    comps, sp_j = jwf.trace_photon_deposits_regen_soa(
        scene_j, jax.random.PRNGKey(1), B, MB, 1e-4, eps, "pallas",
        lanes=L, return_spawned=True)
    scene_t = tbuiltin.cornell_box(with_mesh=True)
    dep, sp_t = twf.trace_photon_deposits_regen_soa(
        scene_t, pack_tables(scene_t), torch.Generator().manual_seed(1), B,
        MB, 1e-4, eps)
    assert int(sp_t) == int(sp_j) == B
    assert dep.pos.shape == (3, len(np.asarray(comps[0]))) == (3, 20 * L)
    v = np.asarray(comps[9])
    ref = {"deposits": v.sum(), "caustic": np.asarray(comps[10]).sum(),
           "flux": np.stack([np.asarray(c) for c in comps[3:6]])[:, v].sum(1)
           / B}
    ours = {"deposits": int(dep.valid.sum()),
            "caustic": int(dep.caustic.sum()),
            "flux": dep.power[:, dep.valid].double().sum(1).numpy() / B}
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=BAND[k], err_msg=k)
    assert not (dep.caustic & ~dep.valid).any()


def test_photon_pass_spawn_budget_and_rescale():
    """lanes < budget: the prefix-sum budget spawns exactly n_photons. A
    window closed early spawns fewer and scales deposit power by
    n_photons / spawned, so the flux per nominal photon stays the same
    (within 12%: ~2,000 photons spawn in the short run)."""
    scene = tbuiltin.cornell_box(with_mesh=True)
    tab = pack_tables(scene)
    eps = 1e-5 * float(scene.scale)
    B, L = 8000, 1024
    assert twf.spawn_window(B, L) == 28
    full, sp_full = twf.trace_photon_deposits_regen_soa(
        scene, tab, torch.Generator().manual_seed(1), B, 6, 1e-4, eps,
        lanes=L)
    short, sp_short = twf.trace_photon_deposits_regen_soa(
        scene, tab, torch.Generator().manual_seed(2), B, 6, 1e-4, eps,
        lanes=L, window=1)
    assert int(sp_full) == B
    assert L < int(sp_short) < B
    assert full.pos.shape[1] == (28 + 6) * L and short.pos.shape[1] == 7 * L

    def flux(dep):
        return dep.power[:, dep.valid].double().sum(1)

    torch.testing.assert_close(flux(short), flux(full), rtol=0.12, atol=0)


def test_photon_pass_at_the_rules_lanes_matches_narrow_lanes():
    """One budget on the rule's wavefront (64,000 photons on 32,768 lanes,
    20 steps at 16 bounces: the cell's ratio of photons to lanes) and on
    1,024 lanes (262 steps): both spawn the whole budget, and the deposit
    count, the caustic count and the flux per photon agree within BAND.
    Only the deposit slots and the order of the draws differ."""
    scene = tbuiltin.cornell_box(with_mesh=True)
    tab = pack_tables(scene)
    eps = 1e-5 * float(scene.scale)
    B = 64000
    assert twf.photon_lanes(B) == 32768
    out = {}
    for lanes in (None, 1024):
        dep, spawned = twf.trace_photon_deposits_regen_soa(
            scene, tab, torch.Generator().manual_seed(3), B, 16, 1e-4, eps,
            lanes=lanes)
        assert int(spawned) == B
        out[lanes] = {
            "deposits": int(dep.valid.sum()),
            "caustic": int(dep.caustic.sum()),
            "flux": dep.power[:, dep.valid].double().sum(1).numpy() / B}
    for k, v in out[None].items():
        np.testing.assert_allclose(v, out[1024][k], rtol=BAND[k], err_msg=k)


@pytest.mark.parametrize("drain_floor", [None, 256])
def test_cornell_sppm_within_jax_golden_bands(drain_floor, monkeypatch):
    """tests/test_golden.py::test_golden_cornell_sppm's config on the
    CPU; with the drain floor lowered, the gather's 8192 lanes compact
    through five cascade levels, density estimates included."""
    if drain_floor:
        monkeypatch.setattr(twf, "DRAIN_MIN_LANES", drain_floor)
        assert len(twf._drain_sizes(32 * 32 * 8)) == 6
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=32, spp_chunk=8,
                       max_depth=12,
                       sppm=SPPMConfig(n_iterations=4, photons_per_iter=20000,
                                       max_photon_bounces=8,
                                       max_camera_bounces=12,
                                       max_photons_per_cell=64))
    img, rays, state = sppm.render(tbuiltin.cornell_box(with_mesh=True), cfg,
                                   7, device="cpu")
    assert img.shape == (32, 32, 3) and torch.isfinite(img).all()
    assert isinstance(rays, int) and rays >= 32 * 32 * 32
    assert state.iteration == 4
    check_against("cornell_sppm_32.npz", img.numpy())


def test_resume_from_saved_state_equals_straight_run(tmp_path):
    """1 iteration, saved and loaded, then 2 more equal 3 straight: every
    iteration and gather batch draws from its own seeded generator."""
    scene = tbuiltin.cornell_box(with_mesh=False)
    img_a, _, state_a = sppm.render(scene, tiny_config(3), 5, device="cpu")
    saved = []
    sppm.render(scene, tiny_config(1), 5, device="cpu",
                checkpoint_cb=lambda s: tckpt.save_state(
                    str(tmp_path / "ck.npz"), s, 5) or saved.append(s))
    assert len(saved) == 1 and saved[0].iteration == 1
    state_1, seed = tckpt.load_state(str(tmp_path / "ck.npz"))
    img_b, _, state_b = sppm.render(scene, tiny_config(3), seed,
                                    state=state_1, device="cpu")
    assert state_b.iteration == 3
    for a, b in zip(list(state_a.glob) + list(state_a.caustic) + [img_a],
                    list(state_b.glob) + list(state_b.caustic) + [img_b]):
        assert torch.equal(a, b)
    # radii shrink where photons accumulate
    touched = (state_1.glob.photons > 0) & (state_a.glob.photons > 0)
    assert touched.sum() > 50
    assert (state_a.glob.radius2[touched]
            <= state_1.glob.radius2[touched] + 1e-6).all()


def no_light_scene():
    b = SceneBuilder()
    b.add_sphere((0.0, 0.0, -1.0), 0.5, b.lambertian(b.constant_texture(
        (0.5, 0.5, 0.5))))
    b.set_camera(look_from=(0.0, 0.0, 1.0), look_at=(0.0, 0.0, -1.0))
    return b.compile()


# SPPM on media renders since its (N, 3) loops are ported (A11): the case
# keeps its id and checks the render instead of the refusal
@pytest.mark.parametrize("make,err,match", [
    (no_light_scene, ValueError, "at least one light"),
    (lambda: tbuiltin.motion_field(8), ValueError, "motion blur"),
    pytest.param(tbuiltin.cornell_smoke, None, None,
                 id="cornell_smoke-NotImplementedError-A7")])
def test_render_refuses(make, err, match):
    if err is None:
        img, rays, state = sppm.render(make(), tiny_config(1), 0,
                                       device="cpu")
        assert torch.isfinite(img).all() and float(img.mean()) > 0
        assert rays >= 24 * 24 * 4 and state.iteration == 1
        return
    with pytest.raises(err, match=match):
        sppm.render(make(), tiny_config(1), 0, device="cpu")


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch", "render",
         "--integrator", "sppm", "--scene", "cornell", "--width", "16",
         "--height", "16", "--spp", "2", "--spp-chunk", "2",
         "--max-depth", "6", "--sppm-photons", "4000", "--device", "cpu",
         *args], cwd=ROOT, capture_output=True, text=True, timeout=120)


def test_cli_sppm_checkpoint_and_resume(tmp_path):
    out, ck = tmp_path / "sppm.png", tmp_path / "ck.npz"
    res = _cli("--sppm-iters", "2", "--seed", "4", "--out", str(out),
               "--checkpoint", str(ck))
    assert res.returncode == 0, res.stderr
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    state, seed = tckpt.load_state(str(ck))
    assert (state.iteration, seed) == (2, 4)
    # the checkpoint's seed is taken when --seed is not given
    res = _cli("--sppm-iters", "3", "--out", str(out), "--resume", str(ck),
               "--checkpoint", str(ck))
    assert res.returncode == 0, res.stderr
    assert f"resumed from {ck} at iteration 2" in res.stdout
    state, seed = tckpt.load_state(str(ck))
    assert (state.iteration, seed) == (3, 4)
