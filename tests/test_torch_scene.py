"""The port's scene tables (``raytracer_tpu_torch.scene``) against the JAX
package's: built from the same builtin scenes and scene files, every table
is exactly equal, ``scale`` included. Also: the port imports no JAX, a JAX
scene carries across through ``scene_from_numpy``, and the kernel build
raises where there is no ``nvcc`` instead of falling back."""

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from raytracer_tpu.scene import builtin as jbuiltin  # noqa: E402
from raytracer_tpu.scene.loader import load_scene as jload  # noqa: E402
from raytracer_tpu_torch.ops import fused_bounce  # noqa: E402
from raytracer_tpu_torch.scene import builtin as tbuiltin  # noqa: E402
from raytracer_tpu_torch.scene import types as T  # noqa: E402
from raytracer_tpu_torch.scene.convert import scene_from_numpy  # noqa: E402
from raytracer_tpu_torch.scene.loader import load_scene as tload  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
DATA = os.path.join(ROOT, "data")


def _file(name):
    path = os.path.join(DATA, name)
    return lambda: jload(path), lambda: tload(path)


SCENES = {
    "three_spheres": (jbuiltin.three_spheres, tbuiltin.three_spheres),
    "cornell_mesh": (lambda: jbuiltin.cornell_box(with_mesh=True),
                     lambda: tbuiltin.cornell_box(with_mesh=True)),
    "scene_10": _file("scene_10.json"),
    "scene_200_no_bvh": _file("scene_200_no_bvh.json"),
    "scene_500": _file("scene_500.json"),
    "scene_10_yaml": _file("scene_10.yaml"),
    "scene_200_no_bvh_yaml": _file("scene_200_no_bvh.yaml"),
    "scene_500_yaml": _file("scene_500.yaml"),
    "test_json": _file("test.json"),
}


def assert_same_tables(a, b, path="scene"):
    """Walk two records by field name; every leaf must be array-equal with
    the same dtype (``a`` may hold JAX arrays, ``b`` holds tensors)."""
    if a is None or b is None:
        assert a is None and b is None, f"{path}: {a!r} vs {b!r}"
        return
    if isinstance(b, tuple):
        for name in b._fields:
            assert_same_tables(getattr(a, name), getattr(b, name),
                               f"{path}.{name}")
        return
    x = np.asarray(a)
    y = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert x.dtype == y.dtype, f"{path}: dtype {x.dtype} vs {y.dtype}"
    assert np.array_equal(x, y), f"{path}: values differ"


def test_port_imports_no_jax():
    code = (
        "import pkgutil, sys, importlib, raytracer_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 15, mods\n"
        "assert 'jax' not in sys.modules\n"
        "assert 'raytracer_tpu' not in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tables_equal_jax(name):
    jscene, tscene = SCENES[name][0](), SCENES[name][1]()
    assert isinstance(tscene, T.Scene)
    # the JAX scene carries an (empty) leaf-table slot the port leaves None
    assert jscene.leaf is None
    assert_same_tables(jscene, tscene)
    assert tscene.scale.dtype == torch.float32
    assert np.array_equal(np.asarray(jscene.scale), tscene.scale.numpy())


@pytest.mark.parametrize("name", ["cornell_mesh", "scene_500"])
def test_scene_from_numpy_matches_port_build(name):
    jscene, tscene = SCENES[name][0](), SCENES[name][1]()
    carried = scene_from_numpy(jscene)
    assert_same_tables(tscene, carried)
    assert_same_tables(jscene, carried)


def test_scene_moves_between_devices():
    scene = tbuiltin.cornell_box(with_mesh=True)
    moved = scene.to("cpu")
    assert_same_tables(scene, moved)
    assert moved.camera.origin.device.type == "cpu"


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from raytracer_tpu_torch.kernels import build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "CUDA_ROOT", str(tmp_path))
    monkeypatch.setattr(build, "BUILD", tmp_path / "_build")
    build.load_library.cache_clear()
    with pytest.raises(build.BuildError, match="nvcc not found"):
        build.load_library("bounce")
    assert not (tmp_path / "_build").exists()


def test_bounce_has_no_fallback_off_cpu():
    """A tensor on a device with no kernel raises; it never reaches the
    plain version."""
    tab = fused_bounce.pack_tables(tbuiltin.three_spheres())
    meta = torch.device("meta")
    o = torch.empty((3, 8), device=meta)
    alive = torch.empty((8,), dtype=torch.bool, device=meta)
    uni = torch.empty((4, 8), device=meta)
    with pytest.raises(NotImplementedError, match="no kernel"):
        fused_bounce.bounce_tables(tab, o, o, 1e-3, alive, uni)
