"""bunny_field(2) with plain PT and MIS, against the JAX package: the
cases of ``test_torch_data_scenes.py``, whose docstring gives the method,
the tolerances and this scene's render size (NEE, the slowest, is in
``test_torch_data_scenes_sppm.py``)."""

import pytest

pytest.importorskip("jax")

from test_torch_data_scenes import _core_share, check_images, renders  # noqa


@pytest.mark.parametrize("mode", ["mis", "pt"])
def test_bunny_field_matches_jax(mode, tmp_path):
    check_images(renders("port", "bunny_field", mode),
                 renders("jax", "bunny_field", mode), tmp_path)
