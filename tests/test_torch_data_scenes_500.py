"""scene_500 with plain PT, NEE and MIS, against the JAX package: the
cases of ``test_torch_data_scenes.py``, whose docstring gives the method,
the tolerances and this scene's render size."""

import pytest

pytest.importorskip("jax")

from test_torch_data_scenes import _core_share, check_images, renders  # noqa


@pytest.mark.parametrize("mode", ["mis", "nee", "pt"])
def test_scene_500_matches_jax(mode, tmp_path):
    check_images(renders("port", "scene_500", mode),
                 renders("jax", "scene_500", mode), tmp_path)
