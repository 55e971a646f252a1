"""The port's main path as a whole (``raytracer_tpu_torch.models``) against
the JAX package: a render held to the JAX golden image's Monte-Carlo bands
(the two packages draw from different random streams, so the image is
compared statistically), the exact ray count, the lane layout and drain
cascade, the camera rays fed the same uniform rows, and the CLI."""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from raytracer_tpu.models import wavefront_soa as jwf  # noqa: E402
from raytracer_tpu.scene import builtin as jbuiltin  # noqa: E402
from raytracer_tpu.scene.loader import load_scene as jload  # noqa: E402
from raytracer_tpu_torch.models import path_tracer  # noqa: E402
from raytracer_tpu_torch.models import wavefront_soa as twf  # noqa: E402
from raytracer_tpu_torch.scene import builtin as tbuiltin  # noqa: E402
from raytracer_tpu_torch.scene.loader import load_scene as tload  # noqa: E402
from raytracer_tpu_torch.utils.config import RenderConfig  # noqa: E402
from test_golden import check_against  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN_CFG = RenderConfig(width=32, height=32, samples_per_pixel=64,
                          spp_chunk=8, max_depth=12)


def test_render_within_jax_golden_bands():
    img, rays = path_tracer.render(tbuiltin.three_spheres(1.0), GOLDEN_CFG,
                                   7, device="cpu")
    assert img.shape == (32, 32, 3) and img.dtype == torch.float32
    assert torch.isfinite(img).all()
    assert rays > 32 * 32 * 64
    check_against("three_spheres_32.npz", img.numpy())


def test_drain_cascade_render_within_bands(monkeypatch):
    """The same render with the drain floor lowered so that the
    compaction cascade runs five levels (8192 lanes down to 256) and the
    tails go through the scatter-add."""
    monkeypatch.setattr(twf, "DRAIN_MIN_LANES", 256)
    assert len(twf._drain_sizes(32 * 32 * 8)) == 6
    img, _ = path_tracer.render(tbuiltin.three_spheres(1.0), GOLDEN_CFG, 3,
                                device="cpu")
    check_against("three_spheres_32.npz", img.numpy())


@pytest.mark.parametrize("spp,chunk", [(4, 2), (3, 3), (5, 2)])
def test_depth_one_counts_one_ray_per_sample(spp, chunk):
    """Every sample is one ray at depth 1; as in the JAX package, spp is
    rounded up to whole chunks of lanes."""
    cfg = RenderConfig(width=24, height=16, samples_per_pixel=spp,
                       spp_chunk=chunk, max_depth=1, russian_roulette=False)
    img, rays = path_tracer.render(tbuiltin.three_spheres(1.5), cfg, 0,
                                   device="cpu")
    assert isinstance(rays, int)
    assert rays == 24 * 16 * -(-spp // chunk) * chunk
    assert img.shape == (16, 24, 3) and torch.isfinite(img).all()


@pytest.mark.parametrize("w,h", [(32, 32), (800, 600), (33, 17)])
def test_block_order_matches_jax(w, h):
    for a, b in zip(twf.block_order(w, h), jwf.block_order(w, h)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("n", [1000, 32768, 480000, 480000 * 2, 1 << 20,
                               32768 + 300])
def test_drain_sizes_match_jax(n):
    assert twf._drain_sizes(n) == jwf._drain_sizes(n)
    assert twf.DRAIN_MIN_LANES == jwf.DRAIN_MIN_LANES


@pytest.mark.parametrize("name", ["three_spheres", "scene_500"])
def test_camera_rays_match_jax(name):
    if name == "scene_500":
        path = os.path.join(ROOT, "data", "scene_500.json")
        jcam = jload(path, aspect_ratio=4 / 3).camera
        tcam = tload(path, aspect_ratio=4 / 3).camera
    else:
        jcam, tcam = jbuiltin.three_spheres().camera, \
            tbuiltin.three_spheres().camera
    rng = np.random.default_rng(5)
    n = 4096
    px = rng.integers(0, 800, n).astype(np.float32)
    py = rng.integers(0, 600, n).astype(np.float32)
    uni = rng.random((4, n), dtype=np.float32)
    jo = jwf.camera_rays_soa(jcam, None, jnp.asarray(px), jnp.asarray(py),
                             800, 600, uni=jnp.asarray(uni))
    to, td = twf.camera_rays_soa(tcam, torch.from_numpy(px),
                                 torch.from_numpy(py), 800, 600,
                                 torch.from_numpy(uni))
    ours = np.concatenate([to.numpy(), td.numpy()])
    np.testing.assert_allclose(ours, np.stack([np.asarray(c) for c in jo]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw,item", [
    (dict(nee=True), "A6"), (dict(mis=True), "A6"),
    (dict(intersector="leaf"), "A10")])
def test_render_fn_refuses_unported_options(kw, item):
    scene = tbuiltin.three_spheres(1.0)
    base = dict(width=4, height=4, spp=1, spp_chunk=1, max_depth=2,
                t_min=1e-3, spawn_eps_rel=1e-5, device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        path_tracer.render_fn(scene, torch.Generator(), **{**base, **kw})


@pytest.mark.parametrize("make,item", [
    (lambda: tbuiltin.cornell_smoke(), "A7"),
    (lambda: tbuiltin.motion_field(8), "A9")])
def test_render_fn_refuses_ineligible_scenes(make, item):
    with pytest.raises(NotImplementedError, match=item):
        path_tracer.render_fn(make(), torch.Generator(), width=4, height=4,
                              spp=1, spp_chunk=1, max_depth=2, t_min=1e-3,
                              spawn_eps_rel=1e-5, device="cpu")


def test_render_fn_takes_its_device_explicitly():
    scene = tbuiltin.three_spheres(1.0)
    kw = dict(width=8, height=4, spp=2, spp_chunk=2, max_depth=3,
              t_min=1e-3, spawn_eps_rel=1e-5)
    img, rays = path_tracer.render_fn(scene, torch.Generator(), **kw,
                                      device="cpu")
    assert img.shape == (4, 8, 3) and img.device.type == "cpu"
    assert rays >= 8 * 4 * 2
    with pytest.raises(ValueError, match="generator"):
        path_tracer.render_fn(scene, torch.Generator(), **kw, device="meta")


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch", "render", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120)


def test_cli_renders_png(tmp_path):
    out = tmp_path / "spheres.png"
    res = _cli("--scene", "spheres", "--width", "16", "--height", "16",
               "--spp", "4", "--max-depth", "4", "--device", "cpu",
               "--out", str(out))
    assert res.returncode == 0, res.stderr
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and b"IHDR" in data[:16]
    assert "rays" in res.stdout


@pytest.mark.parametrize("args", [["--integrator", "sppm"], ["--nee"],
                                  ["--sharded"]])
def test_cli_refuses_unported(args):
    res = _cli(*args, "--device", "cpu")
    assert res.returncode != 0
    assert "ROADMAP" in res.stderr
