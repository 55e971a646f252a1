"""SPPM on scene_10 (32x24, 2 iterations of 20,000 photons, an 8-spp
gather), and bunny_field(2) with NEE, against the JAX package (its
brute-force route): the method and the tolerances of
``test_torch_data_scenes.py``. The two share a file so that each of the
data-scene files stays short on one worker."""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402

from raytracer_tpu.models import sppm as jsppm  # noqa: E402
from raytracer_tpu.scene.loader import load_scene as jload  # noqa: E402
from raytracer_tpu.utils.config import RenderConfig as JConfig  # noqa
from raytracer_tpu.utils.config import SPPMConfig as JSPPMConfig  # noqa
from raytracer_tpu_torch.models import sppm  # noqa: E402
from raytracer_tpu_torch.scene.loader import load_scene as tload  # noqa
from raytracer_tpu_torch.utils.config import (  # noqa: E402
    RenderConfig, SPPMConfig,
)
from test_torch_data_scenes import (  # noqa: E402
    DATA, SEEDS, _core_share, check_images, renders,
)

SPPM = dict(width=32, height=24, samples_per_pixel=8, spp_chunk=8,
            max_depth=16)
SPPM_ITER = dict(n_iterations=2, photons_per_iter=20_000,
                 max_photon_bounces=16, max_camera_bounces=16)


def test_sppm_scene_10_matches_jax(tmp_path):
    aspect = SPPM["width"] / SPPM["height"]
    path = os.path.join(DATA, "scene_10.json")
    jcfg = JConfig(**SPPM, intersector="bruteforce",
                   sppm=JSPPMConfig(**SPPM_ITER))
    js = jload(path, aspect_ratio=aspect)
    ref = [np.asarray(jsppm.render(js, jcfg, jax.random.PRNGKey(k))[0])
           for k in range(SEEDS)]
    cfg = RenderConfig(**SPPM, sppm=SPPMConfig(**SPPM_ITER))
    ts = tload(path, aspect_ratio=aspect)
    ours = []
    for seed in range(SEEDS):
        img, rays, state = sppm.render(ts, cfg, seed, device="cpu")
        assert torch.isfinite(img).all() and rays >= 32 * 24 * 8
        assert state.iteration == 2
        ours.append(img.numpy())
    check_images(ours, ref, tmp_path)


def test_bunny_field_nee_matches_jax(tmp_path):
    check_images(renders("port", "bunny_field", "nee"),
                 renders("jax", "bunny_field", "nee"), tmp_path)
