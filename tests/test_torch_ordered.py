"""The port's ordered near-to-far walk (``raytracer_tpu_torch.ops.ordered``,
the plain twins ``closest_ordered_plain`` and ``bounce_ordered_plain`` of
``csrc/closest_ordered.cu`` and ``csrc/bounce_ordered.cu``) against the
port's flat sweep and against the JAX package.

The JAX ordered-walk kernels are slow in interpret mode, so the JAX side is
``intersect_bruteforce``, its plain reference, and ``render_fn(...,
intersector="bruteforce")``. The same rays, t_max rows and uniforms, made
with numpy from a seed, go through every version.

Tolerances:
- plain walk against flat sweep: the same winner (type and scene index)
  and a bit-equal t on every alive lane. The flat sweep gives the true
  answer whatever the culls, so this is the check that no cull drops a
  true winner; both run the same float32 pair tests.
- against JAX: those of ``test_torch_closest.py`` (the same winner on
  >= 99.9% of the alive lanes, and t to rtol 1e-5 and atol 1e-5 * scale /
  |d|), every other lane on a sphere's float32 decision edge
  (``sphere_edges``): JAX brute force rounds its own way (XLA contracts to
  FMAs). sphere_field(8192) is held to 99.5%, and the mixed scene's
  smallest spheres to t within float32's own rounding (``t_rounding``);
  ``test_ordered_matches_jax_bruteforce`` gives the lanes' margins.
- the 32x32 render against JAX: ``test_golden.py``'s bands, applied to
  2x2-pixel means of two 32-spp renders (whose noise then equals that of
  one 64-spp render against an exact reference, the case the bands were
  set for); against the port's own flat route at the same seed: 1e-5.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from raytracer_tpu.models import path_tracer as jpt  # noqa: E402
from raytracer_tpu.ops import intersect as jix  # noqa: E402
from raytracer_tpu.ops import pallas_intersect as pi  # noqa: E402
from raytracer_tpu.scene import SceneBuilder as JBuilder  # noqa: E402
from raytracer_tpu.scene import builtin as jbuiltin  # noqa: E402
from raytracer_tpu.scene.builder import trs_matrix  # noqa: E402
from raytracer_tpu.utils.obj import load_obj  # noqa: E402
from raytracer_tpu_torch.models import path_tracer as tpt  # noqa: E402
from raytracer_tpu_torch.models.wavefront_soa import (  # noqa: E402
    block_order, camera_rays_soa,
)
from raytracer_tpu_torch.ops import closest_hit, fused_bounce  # noqa: E402
from raytracer_tpu_torch.ops import ordered  # noqa: E402
from raytracer_tpu_torch.scene import builtin as tbuiltin  # noqa: E402
from raytracer_tpu_torch.scene.builder import SceneBuilder  # noqa: E402
from raytracer_tpu_torch.scene.convert import scene_from_numpy  # noqa: E402
from raytracer_tpu_torch.scene.loader import load_scene  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
T_MIN = 1e-3
N_RAYS = 768
# A sphere's float32 decision edge, as in chip_smoke.py: within EDGE_ULPS *
# 2^-24 of |o - c|^2 (two float32 evaluations of disc / a differ by at most
# ~22 of these) and within EDGE_R2 of r^2.
EDGE_ULPS = 24
EDGE_R2 = 0.5


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


def mixed_scene():
    """The bunny and 3000 small spheres around it: both stages walk."""
    b = JBuilder()
    m = b.lambertian(b.constant_texture((0.7, 0.6, 0.5)))
    mesh = load_obj(os.path.join(DATA, "mesh", "bun315.obj"))
    b.add_triangles(mesh.positions, mesh.indices, m, normals=mesh.normals,
                    transform=trs_matrix((0.0, 30.0, 0.0), (8.0, 8.0, 8.0),
                                         (0.0, -0.26, 0.0)))
    rng = np.random.default_rng(5)
    c = rng.uniform([-1.5, 0.0, -1.5], [1.5, 1.5, 1.5], (3000, 3))
    r = rng.uniform(0.01, 0.05, 3000)
    for ci, ri in zip(c, r):
        b.add_sphere(tuple(float(x) for x in ci), float(ri), m)
    b.set_camera(look_from=(0.0, 1.0, 4.0), look_at=(0.0, 0.5, 0.0),
                 vfov=50.0, aspect_ratio=4.0 / 3.0, aperture=0.0,
                 focus_dist=4.0)
    return b.compile()


# name -> (JAX scene, the extent of its walked geometry for finite t_max)
SCENES = {
    "field8192": (lambda: jbuiltin.sphere_field(8192), 100.0),
    "bunny1": (lambda: jbuiltin.bunny_field(1), 3.0),
    "mixed": (mixed_scene, 4.0),
}
_CACHE = {}


def scenes(name):
    """(JAX scene, port scene, port tables) of ``name``, built once."""
    if name not in _CACHE:
        js = SCENES[name][0]()
        ts = scene_from_numpy(js)
        _CACHE[name] = (js, ts, fused_bounce.pack_tables(ts))
    return _CACHE[name]


def make_rays(ts, name, seed, n=N_RAYS, extent=None):
    """Camera rays (random pixels of a 64x48 image) on even lanes, random
    rays around the walked geometry on odd lanes; 15% dead lanes; +inf
    t_max on the first half, 5% to 100% of the geometry's extent (that of
    ``SCENES`` unless given) on the second; scatter uniforms and a spawn
    epsilon for the bounce."""
    rng = np.random.default_rng(seed)
    h = n // 2
    cam_uni = rng.random((4, h), dtype=np.float32)
    px = rng.integers(0, 64, h).astype(np.float32)
    py = rng.integers(0, 48, h).astype(np.float32)
    co, cd = camera_rays_soa(ts.camera, torch.from_numpy(px),
                             torch.from_numpy(py), 64, 48,
                             torch.from_numpy(cam_uni))
    extent = SCENES[name][1] if extent is None else extent
    o_rand = rng.uniform(-0.5, 0.5, (3, n - h)) * extent
    o_rand[1] = np.abs(o_rand[1])
    d_rand = rng.normal(size=(3, n - h))
    o = np.empty((3, n), np.float32)
    d = np.empty((3, n), np.float32)
    o[:, 0::2], d[:, 0::2] = co.numpy(), cd.numpy()
    o[:, 1::2], d[:, 1::2] = o_rand, d_rand
    alive = rng.random(n) > 0.15
    t_max = np.full(n, np.inf, np.float32)
    dn = np.linalg.norm(d[:, h:], axis=0)
    t_max[h:] = rng.uniform(0.05, 1.0, n - h) * extent / dn
    uni = np.concatenate([rng.random((3, n), dtype=np.float32),
                          np.full((1, n), 1e-4, np.float32)], 0)
    return o, d, alive, t_max.astype(np.float32), uni


def tt(*xs):
    return [torch.from_numpy(x) for x in xs]


def assert_same_winners(a, b, alive):
    """Type, scene index and a bit-equal t on every alive lane."""
    for x, y, what in zip(a[:3], b[:3], ("t", "ty", "ix")):
        x, y = x.numpy()[alive], y.numpy()[alive]
        bad = ~((x == y) | (np.isinf(x) & np.isinf(y)))
        assert not bad.any(), f"{what} differs on {bad.sum()} alive lanes"


@pytest.mark.parametrize("name", sorted(SCENES))
def test_ordered_tables(name):
    """``orig`` is a permutation of the scene indices with pads -1; the
    sorted records are the flat table's rows; pads miss; every primitive's
    box lies inside its chunk's box and every chunk's inside its
    superchunk's."""
    _, ts, tab = scenes(name)
    for stage, flat, lo, hi in (
            (tab.osph, tab.sph,
             ts.spheres.center - ts.spheres.radius.abs()[:, None],
             ts.spheres.center + ts.spheres.radius.abs()[:, None]),
            (tab.otri, tab.tri, *_tri_box(ts))):
        if flat.shape[0] <= 2048:
            assert stage is None
            continue
        orig = stage.orig.long()
        real = orig >= 0
        assert torch.equal(orig[real].sort().values,
                           torch.arange(flat.shape[0]))
        assert stage.prim.shape[0] % stage.chunk == 0
        assert stage.cull.shape[0] % ordered.SUPER == 0
        assert stage.cull.shape[0] >= ordered.ORDER_MIN_CHUNKS
        assert torch.equal(stage.prim[real], flat[orig[real]])
        assert (stage.prim[~real, -1] <= 0).all()      # -3e38 r^2 or 0
        ch = torch.arange(orig.shape[0]) // stage.chunk
        box = stage.cull[ch[real]]
        assert (lo[orig[real]] >= box[:, :3]).all()
        assert (hi[orig[real]] <= box[:, 3:]).all()
        sup = stage.scull[torch.arange(stage.cull.shape[0]) // ordered.SUPER]
        live = stage.cull[:, 0] <= stage.cull[:, 3]
        assert (stage.cull[live, :3] >= sup[live, :3]).all()
        assert (stage.cull[live, 3:] <= sup[live, 3:]).all()
        assert torch.equal(stage.box, torch.cat([stage.scull[:, :3].amin(0),
                                                 stage.scull[:, 3:].amax(0)]))


def _tri_box(ts):
    tr = ts.triangles
    return (torch.minimum(torch.minimum(tr.v0, tr.v0 + tr.e1), tr.v0 + tr.e2),
            torch.maximum(torch.maximum(tr.v0, tr.v0 + tr.e1), tr.v0 + tr.e2))


@pytest.mark.parametrize("kind,n", [("sph", 2048), ("sph", 2049),
                                    ("tri", 4096), ("tri", 4097)])
def test_route_follows_jax(kind, n):
    """``pack_tables`` attaches the walk for the same counts as JAX
    ``_wants_order`` (and the stage conditions of ``_order_flags``):
    2048 against 2049 spheres, 4096 against 4097 triangles."""
    b = SceneBuilder()
    m = b.lambertian(b.constant_texture((0.5, 0.5, 0.5)))
    rng = np.random.default_rng(n)
    if kind == "sph":
        for c in rng.uniform(-10, 10, (n, 3)):
            b.add_sphere(tuple(float(x) for x in c), 0.1, m)
        full = pi.SPH_CHUNK
    else:
        pos = rng.uniform(-10, 10, (3 * n, 3)).astype(np.float32)
        b.add_triangles(pos, np.arange(3 * n, dtype=np.int32).reshape(n, 3),
                        m)
        full = pi.CHUNK
    b.set_camera(look_from=(0.0, 0.0, 30.0), look_at=(0.0, 0.0, 0.0))
    tab = fused_bounce.pack_tables(b.compile())
    stage = tab.osph if kind == "sph" else tab.otri
    want = pi._wants_order(n, pi.eff_chunk(n, full))
    assert (stage is not None) == want
    assert want == (n > (2048 if kind == "sph" else 4096))
    assert not fused_bounce.pack_tables(b.compile(), order=False).ordered


def test_scene_500_stays_flat():
    tab = fused_bounce.pack_tables(load_scene(os.path.join(
        DATA, "scene_500.json")))
    assert tab.osph is None and tab.otri is None and not tab.ordered


@pytest.mark.parametrize("name", sorted(SCENES))
def test_ordered_plain_matches_flat(name):
    """The plain walk equals the flat sweep on every alive lane, with a
    finite t_max on half the lanes, and it really culls."""
    _, ts, tab = scenes(name)
    o, d, alive, t_max, _ = make_rays(ts, name, 1)
    to, td, tmax, ta = tt(o, d, t_max, alive)
    flat = closest_hit.closest_hit_plain(tab, to, td, T_MIN, tmax, ta)
    stats = torch.zeros((N_RAYS // ordered.GROUP, 2), dtype=torch.int64)
    walk = closest_hit.closest_tables(tab, to, td, T_MIN, tmax, ta,
                                      stats=stats)
    assert_same_winners(walk, flat, alive)
    hits = np.isfinite(flat.t.numpy()) & alive
    assert 0.05 < hits.sum() / alive.sum() < 0.98
    assert (walk.ty.numpy()[~alive] == -1).all()
    for col, stage in enumerate((tab.osph, tab.otri)):
        if stage is not None:
            assert 0 < stats[:, col].max() < stage.cull.shape[0]


# the walk's cases: the scenes above, and a moving field whose sphere stage
# walks (3000 movers, boxes dilated over the shutter), with its extent
WALK_CASES = sorted(SCENES) + ["motion3000"]


@pytest.mark.parametrize("name", WALK_CASES)
def test_walk_groups_agree(name):
    """``walk_plain`` per warp (``GROUP``, as the kernels walk) and per
    block of 128 rays (``BLOCK``, the block-wide walk of before) give the
    flat sweep's winner on every lane, bit for bit: t, type, scene index
    and the barycentrics. Here the group changes only which chunks run (a
    float32 false hit can change a winner: the next test): the per-warp
    chunk bodies come in (ceil(n / 32), 2), each stage's are nonzero and
    below its chunk count."""
    tm = None
    if name == "motion3000":
        ts = tbuiltin.motion_field(3000, 4.0 / 3.0)
        tab = fused_bounce.pack_tables(ts)
        assert tab.osph is not None and tab.osph.vel is not None
        o, d, alive, t_max, _ = make_rays(ts, name, 2, extent=55.0)
        tm = torch.from_numpy(np.random.default_rng(3).uniform(
            0.0, 1.0, N_RAYS).astype(np.float32))
    else:
        _, ts, tab = scenes(name)
        o, d, alive, t_max, _ = make_rays(ts, name, 2)
    to, td, tmax, ta = tt(o, d, t_max, alive)
    flat = fused_bounce._closest_plain(tab, to, td, T_MIN, ta, tmax, time=tm)
    assert (flat[1][ta] >= 0).float().mean() > 0.05
    for group in (ordered.GROUP, ordered.BLOCK):
        stats = torch.zeros((-(-N_RAYS // group), 2), dtype=torch.int64)
        walk = fused_bounce._closest_plain(tab, to, td, T_MIN, ta, tmax,
                                           ordered=True, stats=stats,
                                           time=tm, group=group)
        for x, y, what in zip(walk, flat, ("t", "ty", "ix", "b1", "b2")):
            assert torch.equal(x, y), f"group {group}: {what} differs"
        for col, stage in enumerate((tab.osph, tab.otri)):
            if stage is not None:
                assert 0 < stats[:, col].max() < stage.cull.shape[0]
            else:
                assert not stats[:, col].any()


def test_walk_group_keeps_no_false_hit():
    """The one way a group changes a lane's winner: a float32 false hit.
    On one 128-lane block of sphere_field(65536)'s 800x600 camera rays
    (the lane order and jitter of ``chip_smoke.py``'s ``image_rays``, seed
    20), the float32 test hits sphere 8160 on lane 21 although float64
    misses it (disc < 0: |o - c|^2 - r^2 cancels 250 units away), at a t
    whose point lies outside the sphere's chunk box. The walk in groups of
    128 runs that chunk for other lanes and keeps the false hit, as the
    flat sweep does; the walk in warps of 32 culls it for this warp and
    finds the sphere behind it. Every other lane agrees bit for bit."""
    ts = tbuiltin.sphere_field(65536, 4.0 / 3.0)
    tab = fused_bounce.pack_tables(ts)
    width, height, lane0 = 800, 600, 240384
    rng = np.random.default_rng(20)
    perm, _ = block_order(width, height)
    uni = rng.random((4, width * height), dtype=np.float32)
    alive = torch.from_numpy(rng.random(width * height) > 0.03)
    lanes = slice(lane0, lane0 + ordered.BLOCK)
    px = torch.from_numpy((perm[lanes] % width).astype(np.float32))
    py = torch.from_numpy((perm[lanes] // width).astype(np.float32))
    o, d = camera_rays_soa(ts.camera, px, py, width, height,
                           torch.from_numpy(uni[:, lanes]))
    alive = alive[lanes].contiguous()
    win = {g: fused_bounce._closest_plain(tab, o, d, T_MIN, alive,
                                          ordered=True, group=g)
           for g in (ordered.GROUP, ordered.BLOCK)}
    flat = fused_bounce._closest_plain(tab, o, d, T_MIN, alive)
    differ = torch.zeros(ordered.BLOCK, dtype=torch.bool)
    for x, y in zip(win[ordered.GROUP], win[ordered.BLOCK]):
        differ |= x != y
    assert torch.nonzero(differ)[:, 0].tolist() == [21]
    assert int(win[ordered.BLOCK][2][21]) == int(flat[2][21]) == 8160
    assert int(win[ordered.GROUP][2][21]) == 4582
    for x, y in zip(win[ordered.BLOCK], flat):
        assert torch.equal(x, y)
    # sphere 8160 in float64: a miss, and the float32 point is outside
    # its chunk's box; sphere 4582: a hit
    c = ts.spheres.center.double()
    r = ts.spheres.radius.double()
    ol, dl = o[:, 21].double(), d[:, 21].double()
    for ix, hit in ((8160, False), (4582, True)):
        oc = ol - c[ix]
        disc = (oc @ dl) ** 2 - (dl @ dl) * (oc @ oc - r[ix] ** 2)
        assert bool(disc >= 0) == hit
    st = tab.osph
    box = st.cull[int(torch.nonzero(st.orig == 8160)[0, 0]) // st.chunk]
    p = ol + float(win[ordered.BLOCK][0][21]) * dl
    assert not ((p >= box[:3].double()) & (p <= box[3:].double())).all()


def sphere_terms(ts, o, d, ty, ix):
    """Per lane whose winner (``ty``, ``ix``) is a sphere, in float64:
    r^2 - perp^2 (perp the ray's distance from the centre; >= 0 where the
    ray meets the sphere), |o - c|^2 and r^2; NaN elsewhere."""
    c = ts.spheres.center.double().numpy()
    r2 = ts.spheres.radius.double().numpy() ** 2
    o, d = o.T.astype(np.float64), d.T.astype(np.float64)
    k = np.clip(ix, 0, len(c) - 1)
    oc = o - c[k]
    along = (oc * d).sum(1) / np.linalg.norm(d, axis=1)
    oc2 = (oc * oc).sum(1)
    sph = ty == 0
    return (np.where(sph, r2[k] - (oc2 - along * along), np.nan),
            np.where(sph, oc2, np.nan), np.where(sph, r2[k], np.nan))


def sphere_edges(ts, o, d, *winners):
    """Per lane: does the ray graze the silhouette of a sphere that one of
    ``winners`` ((ty, ix) pairs) took? In float64, |r^2 - perp^2| within
    EDGE_ULPS * 2^-24 of |o - c|^2, the term whose rounding decides the
    float32 test, and within EDGE_R2 of r^2 (``chip_smoke.py``'s
    ``grazes``). There the two packages' float32 roundings (XLA contracts
    to FMAs) may decide the hit either way."""
    out = np.zeros(o.shape[1], bool)
    for ty, ix in winners:
        gap, oc2, r2 = sphere_terms(ts, o, d, ty, ix)
        with np.errstate(invalid="ignore"):
            out |= ((np.abs(gap) <= EDGE_ULPS * 2.0 ** -24 * oc2)
                    & (np.abs(gap) <= EDGE_R2 * r2))
    return out


def t_rounding(ts, o, d, ty, ix):
    """Per lane whose winner is a sphere: how far float32 rounding can move
    its t. disc / a = r^2 - perp^2 carries up to EDGE_ULPS * 2^-24 |o - c|^2
    (e), which moves sqrt(disc / a) by e / (2 sqrt(r^2 - perp^2)), at most
    sqrt(e); half_b / |d| carries EDGE_ULPS * 2^-24 |o - c|. In t units
    (divided by |d|); 0 on other lanes."""
    gap, oc2, _ = sphere_terms(ts, o, d, ty, ix)
    e = EDGE_ULPS * 2.0 ** -24 * oc2
    with np.errstate(invalid="ignore", divide="ignore"):
        root = np.minimum(e / (2.0 * np.sqrt(np.abs(gap))), np.sqrt(e))
        out = (EDGE_ULPS * 2.0 ** -24 * np.sqrt(oc2) + root) / np.linalg.norm(
            d, axis=0)
    return np.nan_to_num(out, nan=0.0)


def jax_agreement(js, ts, o, d, alive, walk, jh):
    """Lanes where the winners differ must lie on a sphere's float32
    decision edge (``sphere_edges``). Where they agree, t within rtol 1e-5
    + atol 1e-5 * scale / |d|, or, on a sphere too small for float32 at
    its distance, within that plus ``t_rounding``. Returns the counts of
    (winner flips, t beyond rtol + atol) on alive lanes."""
    jt, jty, jixs = (np.asarray(x) for x in jh)
    t, ty, ix = (x.numpy() for x in walk[:3])
    agree = (jty == ty) & (jixs == ix)
    assert (np.isfinite(t) == np.isfinite(jt))[agree & alive].all()
    scale = float(np.asarray(js.scale))
    tol = 1e-5 * scale / np.linalg.norm(d, axis=0) + 1e-5 * np.abs(jt)
    hit = agree & np.isfinite(jt) & alive
    diff = np.zeros_like(jt)
    diff[hit] = np.abs(t[hit] - jt[hit])
    beyond = hit & (diff > tol)
    flip = alive & ~agree
    edge = sphere_edges(ts, o, d, (ty, ix), (jty, jixs))
    assert not (flip & ~edge).any(), np.where(flip & ~edge)[0]
    far = beyond & (diff > tol + t_rounding(ts, o, d, ty, ix))
    assert not far.any(), np.where(far)[0]
    return int(flip.sum()), int(beyond.sum())


@pytest.mark.parametrize("name", sorted(SCENES))
def test_ordered_matches_jax_bruteforce(name):
    """Winners agree with JAX brute force on >= 99.9% of the alive lanes
    (``test_torch_closest.py``), and every other lane is on a sphere's
    float32 decision edge. sphere_field(8192) needs more: 2 of its 637
    alive lanes flip, at 0.10 and 0.82 * 2^-24 |o - c|^2 (4.4e-5 and
    5.7e-4 of r^2) from the silhouette, so it is held to 99.5%. t agrees
    to rtol 1e-5 + atol 1e-5 * scale / |d| but on the mixed scene's
    smallest spheres (r 0.01 at 4 units), where 4 lanes lie within
    ``t_rounding``."""
    js, ts, tab = scenes(name)
    o, d, alive, t_max, _ = make_rays(ts, name, 2)
    walk = closest_hit.closest_tables(tab, *tt(o, d), T_MIN,
                                      torch.from_numpy(t_max),
                                      torch.from_numpy(alive))
    jh = jix.intersect_bruteforce(js, jnp.asarray(o.T), jnp.asarray(d.T),
                                  T_MIN, jnp.asarray(t_max))
    flips, _ = jax_agreement(js, ts, o, d, alive, walk, jh)
    assert flips <= (0.005 if name == "field8192" else 0.001) * alive.sum()
    ty = walk.ty.numpy()
    for stage, kind in ((tab.osph, 0), (tab.otri, 2)):
        if stage is not None:                  # the walked stage is hit
            assert (ty[alive] == kind).sum() >= 5


def test_grazing_boundary_rays():
    """The boundary rays of ``test_pallas_intersect.py``'s reach-clamp
    test on sphere_field(8192): tangent to the outermost spheres along x,
    from 50 units outside the stage box. The walk equals the flat sweep on
    every lane and agrees with JAX brute force on every lane, winners and
    t."""
    js, ts, tab = scenes("field8192")
    c = ts.spheres.center.numpy()
    r = ts.spheres.radius.numpy()
    i_hi = int(np.argmax(c[:, 0] + r))
    i_lo = int(np.argmin(c[:, 0] - r))
    o_list, d_list = [], []
    for i, side in ((i_hi, +1.0), (i_lo, +1.0), (i_hi, -1.0)):
        ci, ri = c[i], r[i]
        for frac in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0 - 1e-6, 1.0, 1.001):
            b = ri * frac
            o_list.append([ci[0] + side * 50.0, ci[1] + b, ci[2]])
            d_list.append([-side, 0.0, 0.0])
            o_list.append([ci[0] + side * 50.0, ci[1], ci[2] + b])
            d_list.append([-side, 0.0, 0.0])
    while len(o_list) % 64:
        o_list.append([500.0, 500.0, 500.0])
        d_list.append([0.0, 1.0, 0.0])
    o = np.asarray(o_list, np.float32).T.copy()
    d = np.asarray(d_list, np.float32).T.copy()
    alive = np.ones(o.shape[1], bool)
    args = (*tt(o, d), T_MIN, float("inf"), torch.from_numpy(alive))
    walk = closest_hit.closest_ordered_plain(tab, *args)
    flat = closest_hit.closest_hit_plain(tab, *args)
    assert_same_winners(walk, flat, alive)
    assert np.isfinite(walk.t.numpy()[:48]).sum() >= 30
    jh = jix.intersect_bruteforce(js, jnp.asarray(o.T), jnp.asarray(d.T),
                                  T_MIN, jnp.inf)
    assert sum(jax_agreement(js, ts, o, d, alive, walk, jh)) == 0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bounce_ordered_plain_equals_fused_plain(name):
    _, ts, tab = scenes(name)
    o, d, alive, _, uni = make_rays(ts, name, 3)
    args = (*tt(o, d), T_MIN, torch.from_numpy(alive), torch.from_numpy(uni))
    walk = fused_bounce.bounce_tables(tab, *args)
    flat = fused_bounce.bounce_fused_plain(tab, *args)
    for a, b, what in zip(walk, flat, ("inter", "no", "nd", "att", "emit",
                                       "p", "n")):
        assert torch.equal(a, b), what
    assert len(np.unique(walk[0].numpy()[alive])) >= 2


def test_ordered_render_matches_jax_and_flat_route():
    """The slice as a whole: a 32x32 render of sphere_field(2500) (16
    padded chunks of 256: the walk is on) at 32 spp, spp_chunk 8, depth 12
    through the port's ordered route, against JAX's brute-force render of
    the same scene and against the port's flat route at the same seed."""
    js = jbuiltin.sphere_field(2500, aspect_ratio=1.0)
    ts = scene_from_numpy(js)
    kw = dict(width=32, height=32, spp=32, spp_chunk=8, max_depth=12,
              t_min=T_MIN, spawn_eps_rel=1e-5)
    tab = fused_bounce.pack_tables(ts)
    assert tab.osph is not None and tab.osph.cull.shape[0] == 16
    img, rays = tpt.render_fn(ts, torch.Generator().manual_seed(4),
                              device="cpu", tables=tab, **kw)
    flat, flat_rays = tpt.render_fn(
        ts, torch.Generator().manual_seed(4), device="cpu",
        tables=fused_bounce.pack_tables(ts, order=False), **kw)
    assert rays == flat_rays
    np.testing.assert_allclose(img.numpy(), flat.numpy(), rtol=0, atol=1e-5)
    jimg, _ = jpt.render_fn(js, jax.random.PRNGKey(4),
                            intersector="bruteforce", **kw)
    img, jimg = img.numpy(), np.asarray(jimg)
    assert np.isfinite(img).all() and img.shape == jimg.shape
    a = np.sqrt(np.clip(img, 0, None))
    b = np.sqrt(np.clip(jimg, 0, None))
    assert abs(a.mean() - b.mean()) < 0.05 * b.mean()
    a2, b2 = (x.reshape(16, 2, 16, 2, 3).mean((1, 3)) for x in (a, b))
    diff = np.abs(a2 - b2)
    assert np.percentile(diff, 95) < 0.30
    assert diff.mean() < 0.08


def test_ordered_stage_cap_raises():
    """Past MAX_SUPERS superchunks the kernel's shared-memory sort cannot
    order the walk: packing raises instead of falling back."""
    n = ordered.MAX_SUPERS * ordered.SUPER * ordered.SPH_CHUNK + 1
    c = torch.zeros((n, 3))
    c[:, 0] = torch.arange(n, dtype=torch.float32)
    sph = torch.cat([c, torch.full((n, 1), 0.01)], 1)
    with pytest.raises(ValueError, match="superchunks"):
        ordered.sphere_stage(sph, c, torch.full((n,), 0.1),
                             torch.zeros(3))


def test_port_builtin_field_is_jax_field():
    """The port's own sphere_field (what the CLI and chip_smoke.py render)
    is the JAX package's, so the checks above on the converted JAX scene
    hold for it."""
    js, ts = jbuiltin.sphere_field(2500), tbuiltin.sphere_field(2500)
    for f in ("center", "radius", "mat_id"):
        np.testing.assert_array_equal(getattr(ts.spheres, f).numpy(),
                                      np.asarray(getattr(js.spheres, f)))
