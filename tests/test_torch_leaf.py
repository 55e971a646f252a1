"""The port's leaf-culled traversal (``raytracer_tpu_torch.ops.leaf``: the
leaf tables, and ``leaf_closest_plain``, the plain twin of
``csrc/leaf.cu``) against the port's flat sweep and the JAX package's
``pallas_bvh`` (its leaf kernel in interpret mode) and brute force.

Tolerances:
- the partition, the big set and the float32 leaf boxes equal JAX's;
- leaf walk against flat sweep: the same winner and a bit-equal t on every
  alive lane (the flat sweep is the true answer whatever the culls);
- against JAX ``intersect_leaf``: ``test_pallas_bvh.py``'s
  ``check_agreement``; against JAX brute force: those of
  ``test_torch_closest.py`` off a sphere's float32 decision edge
  (``test_torch_ordered.py``'s ``jax_agreement``);
- the 32x32 render: ``test_golden.py``'s bands.
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

from raytracer_tpu.ops import intersect as jix  # noqa: E402
from raytracer_tpu.ops import pallas_bvh  # noqa: E402
from raytracer_tpu.scene import builtin as jbuiltin  # noqa: E402
from raytracer_tpu.scene.loader import load_scene as jload  # noqa: E402
from raytracer_tpu_torch import cli  # noqa: E402
from raytracer_tpu_torch.models import path_tracer as tpt  # noqa: E402
from raytracer_tpu_torch.models import wavefront_soa as twf  # noqa: E402
from raytracer_tpu_torch.ops import closest_hit, dispatch  # noqa: E402
from raytracer_tpu_torch.ops import fused_bounce, leaf, nee  # noqa: E402
from raytracer_tpu_torch.scene import builtin as tbuiltin  # noqa: E402
from raytracer_tpu_torch.scene.builder import SceneBuilder  # noqa: E402
from raytracer_tpu_torch.scene.convert import scene_from_numpy  # noqa: E402
from raytracer_tpu_torch.utils.config import RenderConfig  # noqa: E402
from test_golden import check_against  # noqa: E402
from test_torch_ordered import jax_agreement  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
DATA = os.path.join(ROOT, "data")
T_MIN = 1e-3
SCENES = {
    "scene_500": lambda: jload(os.path.join(DATA, "scene_500.json")),
    "scene_200": lambda: jload(os.path.join(DATA, "scene_200_no_bvh.json")),
    "field4096": lambda: jbuiltin.sphere_field(4096),
}
_CACHE = {}


@pytest.fixture(autouse=True, scope="module")
def _core_share():
    """Under pytest-xdist the workers share the machine's cores: these
    CPU-heavy tests run torch on this worker's share of them, so that the
    workers' thread pools do not oversubscribe the cores."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, min(old, (os.cpu_count() or 1) // workers)))
    yield
    torch.set_num_threads(old)


def scenes(name):
    """(JAX scene, port scene with leaf tables, its packed tables)."""
    if name not in _CACHE:
        js = SCENES[name]()
        ts = leaf.with_leaf_tables(scene_from_numpy(js))
        _CACHE[name] = (js, ts, fused_bounce.pack_tables(ts))
    return _CACHE[name]


def rays(n, lo, hi, seed):
    """``test_pallas_bvh.py``'s rays, (3, N) float32 rows."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o.T.copy(), d.T.copy()


def make_rays(ts, seed, n=768):
    """Random rays in the scene's middle on even lanes, camera rays on odd
    lanes; 15% dead; a finite t_max (1 to 20 units) on the second half."""
    rng = np.random.default_rng(seed)
    o, d = rays(n, [-12, -6, -12], [12, 6, 12], seed)
    h = n // 2
    co, cd = twf.camera_rays_soa(
        ts.camera, torch.from_numpy(rng.integers(0, 64, h).astype(np.float32)),
        torch.from_numpy(rng.integers(0, 48, h).astype(np.float32)), 64, 48,
        torch.from_numpy(rng.random((4, h), dtype=np.float32)))
    o[:, 1::2], d[:, 1::2] = co.numpy(), cd.numpy()
    alive = rng.random(n) > 0.15
    t_max = np.full(n, np.inf, np.float32)
    t_max[h:] = (rng.uniform(1.0, 20.0, n - h)
                 / np.linalg.norm(d[:, h:], axis=0)).astype(np.float32)
    return o, d, alive, t_max


def tt(*xs):
    return [torch.from_numpy(x) for x in xs]


def assert_same_winners(a, b, alive):
    for x, y, what in zip(a[:3], b[:3], ("t", "ty", "ix")):
        x, y = x.numpy()[alive], y.numpy()[alive]
        bad = ~((x == y) | (np.isinf(x) & np.isinf(y)))
        assert not bad.any(), f"{what} differs on {bad.sum()} alive lanes"


@pytest.mark.parametrize("name", sorted(SCENES))
def test_partition_matches_jax(name):
    """The port's ``build_leaf_tables`` gives JAX's big set, leaf
    membership (``table`` row 16) and leaf boxes; ``scene_from_numpy`` of
    a JAX scene with leaf tables carries the same tables across."""
    js, ts, _ = scenes(name)
    jt = pallas_bvh.build_leaf_tables(js)
    ours = leaf.build_leaf_tables(scene_from_numpy(js))
    carried = scene_from_numpy(js._replace(leaf=jt)).leaf
    for a in (ours, carried):
        assert torch.equal(a.members, carried.members)
        assert torch.equal(a.big, carried.big)
        assert torch.equal(a.aabb, carried.aabb)
    # JAX's own rows: membership and big set by their row-16 ids
    table, big = np.asarray(jt.table), np.asarray(jt.big)
    real = table[3] < np.float32(3e38)
    assert sorted(np.rint(table[16][real]).astype(int)) == sorted(
        ours.members[ours.members >= 0].tolist())
    assert sorted(ours.big.tolist()) == sorted(
        np.rint(big[16][big[3] < np.float32(3e38)]).astype(int).tolist())
    n_leaf = ours.members.shape[0]
    np.testing.assert_array_equal(ours.aabb.numpy(),
                                  np.asarray(jt.aabb)[:, :n_leaf].T)
    every = torch.cat([ours.members[ours.members >= 0], ours.big])
    assert torch.equal(every.sort().values,
                       torch.arange(js.spheres.radius.shape[0]))
    assert ts.leaf is not None


def test_with_leaf_tables_policy():
    """``test_pallas_bvh.py::test_with_leaf_tables_policy``, and motion
    scenes keep no leaf tables."""
    small = tbuiltin.cornell_box(with_mesh=False)
    assert leaf.with_leaf_tables(small).leaf is None
    big = scenes("scene_500")[1]
    s2 = leaf.with_leaf_tables(big._replace(leaf=None))
    assert s2.leaf is not None
    assert leaf.with_leaf_tables(s2) is s2
    assert leaf.with_leaf_tables(tbuiltin.motion_field(300)).leaf is None


@pytest.mark.parametrize("name", sorted(SCENES))
def test_leaf_plain_matches_flat(name):
    """The leaf walk equals the flat sweep on every alive lane, with a
    finite t_max on half the lanes, and it really culls."""
    _, ts, tab = scenes(name)
    o, d, alive, t_max = make_rays(ts, 1)
    args = (*tt(o, d), T_MIN, torch.from_numpy(t_max),
            torch.from_numpy(alive))
    visits = torch.zeros(o.shape[1], dtype=torch.int32)
    walk = leaf.leaf_closest(tab, *args, visits=visits)
    flat = closest_hit.closest_hit_plain(tab, *args)
    assert_same_winners(walk, flat, alive)
    assert (walk.ty.numpy()[~alive] == -1).all()
    hits = np.isfinite(flat.t.numpy()) & alive
    assert 0.1 < hits.sum() / alive.sum() < 0.99
    v = visits.numpy()[alive]
    assert (visits.numpy()[~alive] == 0).all()
    assert 0 < v.mean() < tab.leaf.box.shape[0] / 2


def test_leaf_matches_jax_interpret():
    """Against JAX ``intersect_leaf`` (interpret mode) on scene_200 with
    512 rays, at ``check_agreement``'s tolerances, and against JAX brute
    force on the same rays."""
    js, ts, tab = scenes("scene_200")
    o, d = rays(512, [-12, -6, -12], [12, 6, 12], 1)
    alive = np.ones(512, bool)
    jscene = js._replace(leaf=pallas_bvh.build_leaf_tables(js))
    jo, jd = jnp.asarray(o.T), jnp.asarray(d.T)
    h2 = jax.jit(lambda o, d: pallas_bvh.intersect_leaf(
        jscene, o, d, T_MIN, jnp.inf))(jo, jd)
    walk = leaf.leaf_closest(tab, *tt(o, d), T_MIN, float("inf"),
                             torch.from_numpy(alive))
    t1, t2 = walk.t.numpy(), np.asarray(h2.t)
    agree = np.isfinite(t1) == np.isfinite(t2)
    assert agree.mean() > 0.995
    both = np.isfinite(t1) & np.isfinite(t2)
    np.testing.assert_allclose(t1[both], t2[both], rtol=1e-4, atol=1e-3)
    assert (walk.ty.numpy()[both] == np.asarray(h2.prim_type)[both]).mean() \
        > 0.99
    close = both & np.isclose(t1, t2, rtol=1e-4, atol=1e-3)
    assert (walk.ix.numpy()[close] == np.asarray(h2.prim_idx)[close]).mean() \
        > 0.98
    jh = jix.intersect_bruteforce(js, jo, jd, T_MIN, jnp.inf)
    flips, _ = jax_agreement(js, ts, o, d, alive, walk, jh)
    assert flips <= 0.001 * 512                 # winners agree on >= 99.9%


def test_leaf_respects_tmax_tmin():
    """``test_pallas_bvh.py::test_leaf_respects_tmax_tmin``: eight spheres
    along -z in leaves of two; plus a hit at exactly t_max misses."""
    b = SceneBuilder()
    m = b.lambertian(b.constant_texture((1, 1, 1)))
    for i in range(8):
        b.add_sphere((0, 0, -3 - i), 0.4, m)
    scene = b.compile()
    scene = scene._replace(leaf=leaf.build_leaf_tables(scene, leaf_size=2))
    assert scene.leaf.members.shape == (4, 2)
    tab = fused_bounce.pack_tables(scene)
    o = torch.zeros((3, 1))
    d = torch.tensor([[0.0], [0.0], [-1.0]])
    alive = torch.ones(1, dtype=torch.bool)

    def hit(t_min, t_max):
        return leaf.leaf_closest(tab, o, d, t_min, t_max, alive)

    np.testing.assert_allclose(float(hit(T_MIN, float("inf")).t[0]), 2.6,
                               rtol=1e-5)
    assert np.isinf(float(hit(T_MIN, 1.5).t[0]))
    h = hit(3.5, float("inf"))
    np.testing.assert_allclose(float(h.t[0]), 3.6, rtol=1e-5)
    assert int(h.ix[0]) == 1
    t26 = float(hit(T_MIN, float("inf")).t[0])
    above = float(np.nextafter(np.float32(t26), np.float32(3.0)))
    assert np.isfinite(float(hit(T_MIN, above).t[0]))
    assert np.isinf(float(hit(T_MIN, t26).t[0]))  # strictly below t_max


def test_leaf_alive_masking():
    """``test_pallas_bvh.py::test_leaf_alive_masking``: live lanes are
    exact however many neighbours are dead; dead lanes miss."""
    _, ts, tab = scenes("scene_500")
    o, d = rays(512, [-12, -6, -12], [12, 6, 12], 5)
    alive = np.random.default_rng(6).random(512) < 0.25
    args = (*tt(o, d), T_MIN, float("inf"))
    walk = leaf.leaf_closest(tab, *args, torch.from_numpy(alive))
    full = closest_hit.closest_hit_plain(tab, *args,
                                         torch.ones(512, dtype=torch.bool))
    assert_same_winners(walk, full, alive)
    assert np.isinf(walk.t.numpy()[~alive]).all()


def test_leaf_golden_three_spheres():
    """A 32x32 ``three_spheres`` render through ``intersector="leaf"``
    lies within the ``three_spheres_32.npz`` bands."""
    scene = tbuiltin.three_spheres(1.0)
    scene = scene._replace(leaf=leaf.build_leaf_tables(scene))
    assert scene.leaf.big.tolist() == [0]           # the ground
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=64,
                       spp_chunk=8, max_depth=12, intersector="leaf")
    img, rays_ = tpt.render(scene, cfg, 7, device="cpu")
    assert rays_ > 0
    check_against("three_spheres_32.npz", img.numpy())


def test_leaf_unfused_bounce_matches_fused():
    """The leaf route is unfused (leaf kernel, then ``attrs_soa`` and
    ``scatter_soa``): it agrees with the fused bounce lane for lane, within
    the unfused-against-fused tolerance of ``test_torch_closest.py``."""
    _, ts, tab = scenes("scene_500")
    o, d, alive, _ = make_rays(ts, 3)
    uni = torch.from_numpy(np.random.default_rng(4).random(
        (3, o.shape[1]), dtype=np.float32))
    kw = dict(t_min=T_MIN, spawn_eps=1e-4, scene=ts)
    args = (tab, uni, *tt(o, d), torch.from_numpy(alive))
    fused = twf.bounce_step(*args, fused=True, **kw)
    unfused = twf.bounce_step(*args, fused=False, intersector="leaf", **kw)
    assert not twf.use_fused(ts, "leaf")
    assert torch.equal(fused.inter, unfused.inter)
    for a, b, field in zip(fused[1:], unfused[1:], fused._fields[1:]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=field)


def test_nee_shadow_rays_take_the_render_route(monkeypatch):
    """NEE casts its shadow rays through ``dispatch.intersect_scene`` with
    the render's intersector (JAX ``nee.py:213-214``): under "leaf" the leaf
    walk answers them, with the same direct light as the kernel route."""
    _, ts, tab = scenes("scene_500")
    o, d, alive, _ = make_rays(ts, 7)
    to, td, ta = tt(o, d, alive)
    b = twf.bounce_step(tab, torch.rand((3, o.shape[1]),
                                        generator=torch.Generator()),
                        to, td, ta, t_min=T_MIN, spawn_eps=1e-4)
    valid = ta & (b.inter == 0)
    rows = torch.from_numpy(np.random.default_rng(8).random(
        (nee.NEE_ROWS, o.shape[1]), dtype=np.float32))
    calls = []
    real = leaf.leaf_closest

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(leaf, "leaf_closest", counting)
    via_leaf, cast = nee.direct_light(ts, tab, rows, b.p, b.n, b.att, valid,
                                      alive=ta, intersector="leaf")
    assert len(calls) == 1 and int(cast.sum()) > 50
    via_kernel, cast2 = nee.direct_light(ts, tab, rows, b.p, b.n, b.att,
                                         valid, alive=ta)
    assert len(calls) == 1 and torch.equal(cast, cast2)
    assert torch.equal(via_leaf, via_kernel)
    assert (via_leaf > 0).any()
    with pytest.raises(ValueError, match="no leaf tables"):
        nee.direct_light(ts._replace(leaf=None), tab, rows, b.p, b.n, b.att,
                         valid, alive=ta, intersector="leaf")


def test_dispatch_leaf_route():
    _, ts, tab = scenes("scene_500")
    assert dispatch.resolve("leaf") == "leaf"
    o, d, alive, t_max = make_rays(ts, 9, n=256)
    args = (*tt(o, d), T_MIN, torch.from_numpy(t_max))
    via = dispatch.intersect_scene(ts, *args, method="leaf",
                                   alive=torch.from_numpy(alive),
                                   tables=tab)
    direct = leaf.leaf_closest(tab, *args, torch.from_numpy(alive))
    for a, b in zip(via, direct):
        assert torch.equal(a, b)


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch", "render", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=120)


def test_cli_leaf_and_bunnies(tmp_path):
    """``render --intersector leaf`` builds the leaf tables and writes its
    PNG; ``--scene bunnies:N`` loads the bunny field."""
    out = tmp_path / "leaf.png"
    res = _cli("--scene", "spheres", "--intersector", "leaf", "--width",
               "16", "--height", "16", "--spp", "4", "--max-depth", "4",
               "--nee", "--device", "cpu", "--out", str(out))
    assert res.returncode == 0, res.stderr
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    scene = cli.load_scene_arg("bunnies:1", 4.0 / 3.0)
    assert scene.triangles.v0.shape[0] == 4968
    assert cli.load_scene_arg("bunnies", 1.0).triangles.v0.shape[0] == 124200
    with pytest.raises(SystemExit):
        cli.load_scene_arg("bunnies:0", 1.0)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_leaf_tree_covers_the_leaves(name):
    """``leaf_tree``: every leaf at one node, each inner node's box the
    exact union of its children's, breadth-first order, within the
    kernel's stack."""
    _, _, tab = scenes(name)
    lp = tab.leaf
    node, nbox = lp.node.long(), lp.nbox
    inner = node[:, 2] < 0
    assert sorted(node[~inner, 2].tolist()) == list(range(lp.box.shape[0]))
    assert torch.equal(nbox[~inner], lp.box[node[~inner, 2]])
    kids = node[inner, :2]
    assert (kids > torch.nonzero(inner)).all()     # children come later
    assert sorted(kids.reshape(-1).tolist()) == list(range(1, node.shape[0]))
    lo = torch.minimum(nbox[kids[:, 0], :3], nbox[kids[:, 1], :3])
    hi = torch.maximum(nbox[kids[:, 0], 3:], nbox[kids[:, 1], 3:])
    assert torch.equal(nbox[inner], torch.cat([lo, hi], 1))
    depth, level = 0, [0]
    while level:
        depth += 1
        level = [c for k in level for c in node[k, :2].tolist() if c >= 0]
    assert depth <= leaf.STACK


@pytest.mark.parametrize("name", sorted(SCENES))
def test_leaf_walk_plain_matches_table_order(name):
    """The plain twin of the kernel's walk (warps of 32 rays down the
    hierarchy) gives ``leaf_closest_plain``'s outputs bit for bit, with a
    finite t_max on half the lanes, and folds few leaves."""
    _, ts, tab = scenes(name)
    o, d, alive, t_max = make_rays(ts, 11)
    args = (*tt(o, d), T_MIN, torch.from_numpy(t_max),
            torch.from_numpy(alive))
    visits = torch.zeros(o.shape[1], dtype=torch.int32)
    walk = leaf.leaf_walk_plain(tab, *args, visits=visits)
    ref = leaf.leaf_closest_plain(tab, *args)
    for a, b, field in zip(walk, ref, ref._fields):
        assert torch.equal(a, b), field
    assert (visits.numpy()[~alive] == 0).all()
    assert 0 < visits.float().mean() < tab.leaf.box.shape[0] / 2


def test_leaf_walk_plain_exact_ties():
    """Copies of spheres in leaves of one sphere each: at every tie of t
    the lower scene index wins, whichever leaf the walk visits first, as
    in ``leaf_closest_plain`` and the flat sweep."""
    b = SceneBuilder()
    m = b.lambertian(b.constant_texture((1, 1, 1)))
    rng = np.random.default_rng(12)
    centres = rng.uniform(-4, 4, (24, 3))
    centres[:, 2] -= 10
    for c in np.concatenate([centres, centres[::-1]]):
        b.add_sphere(tuple(c), 0.8, m)
    scene = b.compile()
    scene = scene._replace(leaf=leaf.build_leaf_tables(scene, leaf_size=1))
    tab = fused_bounce.pack_tables(scene)
    o, d = rays(512, [-1, -1, 2], [1, 1, 3], 13)
    d[2] = -np.abs(d[2]) * 4
    alive = torch.ones(512, dtype=torch.bool)
    args = (*tt(o, d), T_MIN, float("inf"), alive)
    walk = leaf.leaf_walk_plain(tab, *args)
    ref = leaf.leaf_closest_plain(tab, *args)
    flat = closest_hit.closest_hit_plain(tab, *args)
    hit = walk.ty.numpy() == 0
    assert hit.sum() > 50
    assert (walk.ix.numpy()[hit] < 24).all()       # the lower of each copy
    for a, b_, field in zip(walk, ref, ref._fields):
        assert torch.equal(a, b_), field
    assert_same_winners(walk, flat, np.ones(512, bool))
