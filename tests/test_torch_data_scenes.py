"""Whole-image parity on the bench's own scenes: ``data/scene_10.json``,
``scene_200_no_bvh.json``, ``scene_500.json`` and ``bunny_field(2)``,
each loaded or built by both packages, rendered by the port (its kernel
route, "auto", on the kernels' plain versions) and by the JAX package
(its (N, 3) brute-force route), with plain PT, NEE and MIS at 48x36, 8
spp, depth 16; and SPPM on scene_10. This file holds scene_10 and
scene_200_no_bvh; ``test_torch_data_scenes_{500,bunny,sppm}.py`` the
rest, so that each file stays short on one worker.

Two scenes take other sizes. bunny_field renders at 16x12 with 72 spp a
render (the same camera samples): at 48x36 and 8 spp its plain-PT image
is mostly noise in gamma space (the sky light is a small sphere), so two
halves of one package's renders differ by more than check_against's
bands. scene_500 renders at 32x24 (8 spp): at 48x36 the port's plain
sweep over its 1005 spheres costs ~9 s a render on one core, and the
bands hold per pixel, so fewer pixels keep their margin.

The two packages draw from different random streams, so the images are
compared statistically:
- linear image means within 4 standard errors of their difference, each
  side's error from its renders' spread (``SEEDS`` renders a side, each
  from its own seed), that error below 10% of the mean;
- the mean image of each side's renders inside the gamma-space bands of
  ``tests/test_golden.py::check_against``, with JAX's mean image as the
  golden one.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from raytracer_tpu.models import path_tracer as jpt  # noqa: E402
from raytracer_tpu.scene import builtin as jbuiltin  # noqa: E402
from raytracer_tpu.scene.loader import load_scene as jload  # noqa: E402
from raytracer_tpu_torch.models import path_tracer  # noqa: E402
from raytracer_tpu_torch.scene import builtin as tbuiltin  # noqa: E402
from raytracer_tpu_torch.scene.loader import load_scene as tload  # noqa
from test_golden import check_against  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
RENDER = dict(width=48, height=36, spp=8, spp_chunk=8, max_depth=16,
              t_min=1e-3, spawn_eps_rel=1e-5)
SEEDS = 4
MODES = {"pt": {}, "nee": dict(nee=True), "mis": dict(mis=True)}


@pytest.fixture(autouse=True, scope="module")
def _core_share():
    """Under pytest-xdist the workers share the machine's cores: run torch
    on this worker's share of them."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, min(old, (os.cpu_count() or 1) // workers)))
    yield
    torch.set_num_threads(old)


def _file(name, aspect):
    path = os.path.join(DATA, name)
    return (lambda: jload(path, aspect_ratio=aspect),
            lambda: tload(path, aspect_ratio=aspect))


ASPECT = RENDER["width"] / RENDER["height"]
# per-scene changes to RENDER (see above)
SIZES = {"bunny_field": dict(width=16, height=12, spp=72),
         "scene_500": dict(width=32, height=24)}
SCENES = {
    "scene_10": _file("scene_10.json", ASPECT),
    "scene_200_no_bvh": _file("scene_200_no_bvh.json", ASPECT),
    "scene_500": _file("scene_500.json", ASPECT),
    "bunny_field": (lambda: jbuiltin.bunny_field(2, aspect_ratio=ASPECT),
                    lambda: tbuiltin.bunny_field(2, aspect_ratio=ASPECT)),
}


def check_images(ours, ref, tmp_path):
    """The two sets of renders: linear means within 4 standard errors of
    their difference, and the mean images in check_against's bands."""
    a, b = (np.array([x.mean() for x in imgs]) for imgs in (ours, ref))
    se = np.sqrt(a.var(ddof=1) / a.size + b.var(ddof=1) / b.size)
    assert abs(a.mean() - b.mean()) < 4 * se, (a.mean(), b.mean(), se)
    assert se < 0.1 * b.mean(), (se, b.mean())
    golden = tmp_path / "jax_mean.npz"
    np.savez(golden, img=np.mean(ref, 0))
    # an absolute path as the golden name: os.path.join keeps it whole
    check_against(str(golden), np.mean(ours, 0))


_RENDERS = {}


def renders(who, name, mode):
    """``SEEDS`` renders of "jax" or "port" (seeds 0..), made once."""
    key = (who, name, mode)
    if key not in _RENDERS:
        kw = {**RENDER, **SIZES.get(name, {}), **MODES[mode]}
        out = []
        if who == "jax":
            js = SCENES[name][0]()
            for k in range(SEEDS):
                img, _ = jpt.render_fn(js, jax.random.PRNGKey(k),
                                       intersector="bruteforce", **kw)
                out.append(np.asarray(img))
        else:
            ts = SCENES[name][1]()
            for seed in range(SEEDS):
                img, rays = path_tracer.render_fn(
                    ts, torch.Generator().manual_seed(seed), device="cpu",
                    **kw)
                assert torch.isfinite(img).all()
                assert rays >= kw["width"] * kw["height"] * kw["spp"]
                out.append(img.numpy())
        _RENDERS[key] = out
    return _RENDERS[key]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", ["scene_10", "scene_200_no_bvh"])
def test_data_scene_matches_jax(name, mode, tmp_path):
    check_images(renders("port", name, mode), renders("jax", name, mode),
                 tmp_path)
