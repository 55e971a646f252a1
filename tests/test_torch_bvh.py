"""The port's flat BVH (``raytracer_tpu_torch.ops.bvh`` and its native
builder ``raytracer_tpu_torch/native``) against the JAX package's
``ops/bvh.py``.

- ``primitive_aabbs`` and the numpy build are bit-equal to JAX's on the
  sphere, mixed and scene_500 cases of ``tests/test_bvh.py``;
- the native build is not bit-equal to the numpy one:
  ``std::nth_element`` and ``np.argpartition`` put the two halves of a
  split in different orders, and where centroids tie at a split's median
  (scene_200's spheres do) they send different primitives to each half,
  so the boxes below differ too (on scene_200 76 of the 765 node-box
  values). It keeps the layout's contract and the numpy build's node
  count and root box, and its traversal finds the same winners, t
  included;
- ``intersect_bvh``'s winners equal JAX's ``intersect_bvh`` lane for lane
  (type and index), t within 1e-5 x the scene scale;
- a small render through ``--intersector bvh`` is within the golden bands
  of the brute-force route; ``resolve("bvh")`` on a moving scene gives
  "pallas"; with no BVH the route raises JAX's ``ValueError``.
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

from raytracer_tpu.ops import bvh as jbvh  # noqa: E402
from raytracer_tpu.scene import builtin as jbuiltin  # noqa: E402
from raytracer_tpu.scene.loader import load_scene as jload  # noqa: E402
from raytracer_tpu_torch.models import path_tracer  # noqa: E402
from raytracer_tpu_torch.native import runtime  # noqa: E402
from raytracer_tpu_torch.ops import bvh as tbvh  # noqa: E402
from raytracer_tpu_torch.ops import dispatch  # noqa: E402
from raytracer_tpu_torch.scene import builtin as tbuiltin  # noqa: E402
from raytracer_tpu_torch.scene.convert import scene_from_numpy  # noqa
from raytracer_tpu_torch.utils.config import RenderConfig  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
DATA = os.path.join(ROOT, "data")
T_MIN = 1e-3

# tests/test_bvh.py's scenes and random rays (n, lo, hi, seed)
CASES = {
    "spheres": (lambda: jload(os.path.join(DATA, "scene_200_no_bvh.json")),
                (2048, [-12, -6, -12], [12, 6, 12], 0)),
    "scene_500": (lambda: jload(os.path.join(DATA, "scene_500.json")),
                  (2048, [-12, -6, -12], [12, 6, 12], 1)),
    "mixed": (lambda: jbuiltin.cornell_box(with_mesh=True),
              (2048, [50, 50, -700], [500, 500, 500], 2)),
}
_SCENES = {}


@pytest.fixture(autouse=True, scope="module")
def _core_share():
    """Under pytest-xdist the workers share the machine's cores: run torch
    on this worker's share of them."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, min(old, (os.cpu_count() or 1) // workers)))
    yield
    torch.set_num_threads(old)


def scenes(name):
    """(JAX scene, port scene) of a case, made once."""
    if name not in _SCENES:
        js = CASES[name][0]()
        _SCENES[name] = (js, scene_from_numpy(js))
    return _SCENES[name]


def random_rays(n, lo, hi, seed):
    """tests/test_bvh.py::random_rays, as numpy."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("name", list(CASES))
def test_aabbs_and_build_bit_equal_to_jax(name):
    js, ts = scenes(name)
    ref = jbvh.primitive_aabbs(js)
    ours = tbvh.primitive_aabbs(ts)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    jb = jbvh.build_bvh(js, use_native=False).bvh
    tb = tbvh.build_bvh(ts, use_native=False).bvh
    for field in tb._fields:
        np.testing.assert_array_equal(getattr(tb, field).numpy(),
                                      np.asarray(getattr(jb, field)),
                                      err_msg=field)


def check_layout(b, n_prims):
    """The flat layout's contract: children in range, every leaf at most
    ``LEAF_SIZE`` primitives, the leaves covering every slot once, each
    node's box holding its children's."""
    left, right = b.left.numpy(), b.right.numpy()
    leaf = b.is_leaf.numpy()
    lo, hi = b.node_min.numpy(), b.node_max.numpy()
    n_nodes = left.shape[0]
    inner = np.flatnonzero(~leaf)
    assert (left[inner] < n_nodes).all() and (right[inner] < n_nodes).all()
    for c in (left[inner], right[inner]):
        assert (lo[inner] <= lo[c]).all() and (hi[inner] >= hi[c]).all()
    covered = np.zeros(n_prims, int)
    for s, c in zip(left[leaf], right[leaf]):
        assert 0 < c <= tbvh.LEAF_SIZE
        covered[s:s + c] += 1
    assert (covered == 1).all()
    keys = b.prim_type.numpy().astype(np.int64) << 32 | b.prim_idx.numpy()
    assert np.unique(keys).size == n_prims


@pytest.mark.parametrize("name", list(CASES))
def test_native_build_same_winners(name):
    """The native build keeps the layout's contract, with the numpy build's
    node count and root box, and its traversal finds the numpy build's
    winners on the case's rays (type, index and t)."""
    if not runtime.available():
        pytest.fail(f"native builder unavailable: {runtime.why()}")
    _, ts = scenes(name)
    nat = tbvh.build_bvh(ts, use_native=True)
    py = tbvh.build_bvh(ts, use_native=False)
    n_prims = py.bvh.prim_type.shape[0]
    check_layout(nat.bvh, n_prims)
    check_layout(py.bvh, n_prims)
    assert nat.bvh.left.shape == py.bvh.left.shape
    for field in ("node_min", "node_max"):
        assert torch.equal(getattr(nat.bvh, field)[0],
                           getattr(py.bvh, field)[0])
    n, lo, hi, seed = CASES[name][1]
    o, d = (torch.from_numpy(x) for x in random_rays(n, lo, hi, seed))
    a = tbvh.intersect_bvh(nat, o, d, T_MIN, float("inf"))
    b = tbvh.intersect_bvh(py, o, d, T_MIN, float("inf"))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_native_fallback_says_so(monkeypatch, capsys):
    """Without the library ``build_bvh`` builds with numpy and says so once
    on stderr."""
    _, ts = scenes("mixed")
    monkeypatch.setattr(runtime, "_state", {"lib": None, "tried": True,
                                            "why": "no g++",
                                            "warned": False})
    a = tbvh.build_bvh(ts, use_native=True).bvh
    b = tbvh.build_bvh(ts, use_native=True).bvh
    err = capsys.readouterr().err
    assert err.count("native BVH builder is unavailable (no g++)") == 1
    py = tbvh.build_bvh(ts, use_native=False).bvh
    for x, y, z in zip(a, b, py):
        assert torch.equal(x, z) and torch.equal(y, z)


@pytest.mark.parametrize("name", list(CASES))
def test_traversal_winners_equal_jax(name):
    js, ts = scenes(name)
    n, lo, hi, seed = CASES[name][1]
    o, d = random_rays(n, lo, hi, seed)
    jb = jbvh.build_bvh(js, use_native=False)
    ref = jax.jit(lambda o, d: jbvh.intersect_bvh(jb, o, d, T_MIN, jnp.inf))(
        jnp.asarray(o), jnp.asarray(d))
    tb = tbvh.build_bvh(ts, use_native=False)
    ours = tbvh.intersect_bvh(tb, torch.from_numpy(o), torch.from_numpy(d),
                              T_MIN, float("inf"))
    ty, ix = np.asarray(ref.prim_type), np.asarray(ref.prim_idx)
    np.testing.assert_array_equal(ours.prim_type.numpy(), ty)
    np.testing.assert_array_equal(ours.prim_idx.numpy(), ix)
    t_ref = np.asarray(ref.t)
    np.testing.assert_array_equal(np.isfinite(ours.t.numpy()),
                                  np.isfinite(t_ref))
    hit = np.isfinite(t_ref)
    assert hit.mean() > 0.2
    scale = float(ts.scale)
    np.testing.assert_allclose(ours.t.numpy()[hit], t_ref[hit], rtol=0,
                               atol=1e-5 * scale)


def test_traversal_compacts_and_respects_tmax(monkeypatch):
    """A wavefront wide enough to compact (the width floor lowered to 256
    lanes) gives the same winners as the same rays traced in small pieces,
    and a finite per-ray t_max cuts hits beyond it. The best t starts at
    t_max and a primitive wins only on a strictly smaller t, so a hit at
    exactly t_max is not taken (as in JAX)."""
    _, ts = scenes("scene_500")
    tb = tbvh.build_bvh(ts, use_native=False)
    o, d = (torch.from_numpy(x) for x in random_rays(
        2048, [-12, -6, -12], [12, 6, 12], 5))
    compactions = []
    real = tbvh._Walk.subset

    def subset(self, keep):
        compactions.append(keep.shape[0])
        return real(self, keep)

    monkeypatch.setattr(tbvh, "MIN_COMPACT", 256)
    monkeypatch.setattr(tbvh._Walk, "subset", subset)
    whole = tbvh.intersect_bvh(tb, o, d, T_MIN, float("inf"))
    assert compactions and compactions[0] < 2048
    monkeypatch.setattr(tbvh, "MIN_COMPACT", 1 << 30)
    parts = [tbvh.intersect_bvh(tb, o[i:i + 200], d[i:i + 200], T_MIN,
                                float("inf"))
             for i in range(0, o.shape[0], 200)]
    for k in range(3):
        assert torch.equal(whole[k], torch.cat([p[k] for p in parts]))
    t_max = torch.where(torch.arange(o.shape[0]) % 2 == 0, whole.t * 1.5,
                        whole.t * 0.5)
    cut = tbvh.intersect_bvh(tb, o, d, T_MIN, t_max)
    even = torch.arange(o.shape[0]) % 2 == 0
    hit = torch.isfinite(whole.t)
    assert torch.equal(cut.t[even & hit], whole.t[even & hit])
    odd = ~even & hit & torch.isfinite(cut.t)
    assert (cut.t[odd] < t_max[odd]).all()
    assert (~torch.isfinite(cut.t[~even & hit])).any()
    at_t = tbvh.intersect_bvh(tb, o, d, T_MIN, whole.t)
    assert not torch.isfinite(at_t.t[hit]).all()


def test_render_through_bvh_in_golden_bands():
    """three_spheres at the golden's settings (``tests/test_golden.py``)
    through the BVH route and the brute-force route, both within the
    golden's bands; the same seed draws the same rows and the winners are
    the same, so the two images agree to float rounding."""
    from test_golden import check_against
    scene = tbvh.build_bvh(tbuiltin.three_spheres(1.0))
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=64,
                       spp_chunk=8, max_depth=12)
    img_b, rays_b = path_tracer.render(
        scene, cfg.replace(intersector="bvh"), 7, device="cpu")
    img_f, rays_f = path_tracer.render(
        scene, cfg.replace(intersector="bruteforce"), 7, device="cpu")
    assert torch.isfinite(img_b).all() and rays_b > 32 * 32 * 64
    assert rays_b == rays_f
    np.testing.assert_allclose(img_b.numpy(), img_f.numpy(), atol=1e-5)
    check_against("three_spheres_32.npz", img_b.numpy())


def test_resolve_bvh():
    """JAX ``_resolve``: "bvh" stays itself, a moving scene takes
    "pallas"; without a BVH the route raises JAX's ``ValueError``."""
    assert dispatch.resolve("bvh") == "bvh"
    assert dispatch.resolve("bvh", True) == "pallas"
    scene = tbuiltin.three_spheres(1.0)
    assert dispatch.route(scene, "auto") == "pallas"
    o = torch.zeros((3, 4))
    d = torch.ones((3, 4))
    with pytest.raises(ValueError, match="scene has no BVH; build it with "
                                         "ops.bvh.build_bvh"):
        dispatch.intersect_scene(scene, o, d, T_MIN, float("inf"), "bvh")
    with pytest.raises(ValueError, match="scene has no BVH"):
        path_tracer.render_fn(scene, torch.Generator(), width=4, height=4,
                              spp=1, spp_chunk=1, max_depth=2, t_min=1e-3,
                              spawn_eps_rel=1e-5, intersector="bvh",
                              device="cpu")


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch", "render", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("args", [["--intersector", "bvh"], ["--bvh"],
                                  ["--intersector", "bvh", "--nee"]])
def test_cli_bvh_renders(args, tmp_path):
    out = tmp_path / "bvh.png"
    res = _cli(*args, "--scene", "spheres", "--width", "16", "--height",
               "12", "--spp", "2", "--max-depth", "4", "--device", "cpu",
               "--out", str(out))
    assert res.returncode == 0, res.stderr
    assert "rays" in res.stdout
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
