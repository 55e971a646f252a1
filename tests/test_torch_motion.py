"""Motion blur in the port (per-lane shutter times; spheres tested at
c + v t): the plain versions of the six motion kernels' forms, the regen
wavefront's time, NEE and MIS, against the JAX package and against the
port's own flat route.

The same scenes (built with each package's ``SceneBuilder``, the moving
fields of ``test_motion_pallas.py``) and the same rays, times and uniforms,
made with numpy from a seed, go through both packages. JAX runs its XLA
brute force and ``hit_attributes`` with ``time=``, and its Pallas
``bounce_fused``/``regen_step_fused`` with ``time=`` in interpret mode, as
its own tests run them on the CPU.

Tolerances:
- closest hit against JAX brute force (``test_motion_pallas.py``'s): hit or
  miss equal, t to rtol 1e-5 and atol 2e-4, the winner equal but on exact
  ties (two primitives at one t);
- points and normals against ``hit_attributes(time=)``: rtol 1e-4, atol
  1e-3;
- the bounce and the regen step: ``test_torch_bounce.py``'s and
  ``test_torch_regen.py``'s; the respawned time to 1 ulp of JAX's;
- the ordered walk against the flat sweep: the same winner and t on every
  alive lane (both plain, the same float32 pair tests); with boxes that
  are not dilated over the shutter it must lose winners;
- ``light_pdf`` with a moving light: ``test_torch_nee.py``'s rule, 1e-5
  relative plus four float32 ulps of 1 - cos_max;
- a 64x48 render of ``test_motion_pallas.py``'s two moving spheres against
  JAX ``render_fn(intersector="bruteforce")``: means within 6% (that
  test's bound).
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
from raytracer_tpu.ops import mis as jmis  # noqa: E402
from raytracer_tpu.ops import pallas_intersect as pi  # noqa: E402
from raytracer_tpu.scene import SceneBuilder as JBuilder  # noqa: E402
from raytracer_tpu.scene.types import PRIM_SPHERE  # noqa: E402
from raytracer_tpu_torch.models import path_tracer as tpt  # noqa: E402
from raytracer_tpu_torch.models import wavefront_soa as twf  # noqa: E402
from raytracer_tpu_torch.ops import (  # noqa: E402
    closest_hit, dispatch, fused_bounce, mis, nee, ordered, regen,
)
from raytracer_tpu_torch.scene import builtin as tbuiltin  # noqa: E402
from raytracer_tpu_torch.scene.builder import (  # noqa: E402
    SceneBuilder as TBuilder,
)
from test_torch_bounce import make_rays  # noqa: E402
from test_torch_regen import (  # noqa: E402
    H, MAX_DEPTH, QUOTA, RR_START, W, make_lanes, port_lanes,
)

T_MIN = 1e-3
INF = float("inf")


@pytest.fixture(autouse=True, scope="module")
def _core_share():
    """Under pytest-xdist the workers share the machine's cores: run torch
    on this worker's share of them."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, min(old, (os.cpu_count() or 1) // workers)))
    yield
    torch.set_num_threads(old)


def moving_field(builder, n=300, extent=10.0, vmax=6.0, seed=0,
                 with_rect=True):
    """``test_motion_pallas.py::_moving_field`` with either package's
    builder: n spheres moving by up to ``vmax`` per axis over the shutter
    [0, 1]."""
    rng = np.random.default_rng(seed)
    b = builder()
    m = b.lambertian(b.constant_texture((1.0, 1.0, 1.0)))
    for _ in range(n):
        c = rng.uniform(-extent, extent, 3)
        v = rng.uniform(-vmax, vmax, 3)
        b.add_moving_sphere(tuple(c), tuple(c + v),
                            float(rng.uniform(0.2, 1.0)), m)
    if with_rect:
        b.add_xz_rect(-extent - 2, -extent - 2, extent + 2, extent + 2,
                      -extent - 1, m)
    b.set_camera((0, 0, 3 * extent), (0, 0, 0), time0=0.0, time1=1.0)
    return b.compile()


def two_spheres(builder, frozen=False):
    """``test_motion_pallas.py::test_motion_render_regen_matches_aos``'s
    scene; ``frozen``: the shutter closed at time 0."""
    b = builder()
    g = b.lambertian(b.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    m = b.lambertian(b.constant_texture((0.7, 0.3, 0.3)))
    lt = b.diffuse_light(b.constant_texture((7.0, 7.0, 7.0)))
    b.add_sphere((0, -1000, 0), 1000.0, g)
    b.add_moving_sphere((-2, 1, 0), (-2, 1.6, 0), 1.0, m)
    b.add_moving_sphere((2, 1, 0), (2.8, 1, 0), 1.0, m)
    b.add_xz_rect(-1.5, -1.5, 1.5, 1.5, 6.0, lt)
    b.set_camera((0, 2, 12), (0, 1, 0), vfov=30, time0=0.0,
                 time1=0.0 if frozen else 1.0)
    return b.compile()


def small_scene(builder):
    """64 moving spheres of three materials (Lambertian, metal,
    dielectric) over a checker ground, under a rect light: the bounce's
    and the regen step's cases."""
    rng = np.random.default_rng(7)
    b = builder()
    g = b.lambertian(b.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    mats = [b.lambertian(b.constant_texture((0.7, 0.3, 0.3))),
            b.metal(b.constant_texture((0.8, 0.8, 0.9)), 0.2),
            b.dielectric(1.5)]
    lt = b.diffuse_light(b.constant_texture((4.0, 4.0, 4.0)))
    b.add_sphere((0, -1000, 0), 1000.0, g)
    for i in range(64):
        c = rng.uniform([-4.0, 0.3, -4.0], [4.0, 2.0, 4.0])
        v = rng.uniform(-1.5, 1.5, 3)
        b.add_moving_sphere(tuple(c), tuple(c + v),
                            float(rng.uniform(0.2, 0.6)), mats[i % 3])
    b.add_xz_rect(-2.0, -2.0, 2.0, 2.0, 6.0, lt)
    b.set_camera((0, 3, 12), (0, 1, 0), vfov=40, aspect_ratio=W / H,
                 time0=0.0, time1=1.0)
    return b.compile()


def rand_rays(n, extent, seed):
    """``test_motion_pallas.py::_rand_rays`` as numpy (N, 3) rows and (N,)
    times in the shutter."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5 * extent, 1.5 * extent, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d, rng.uniform(0.0, 1.0, (n,)).astype(np.float32)


def tt(*xs):
    """numpy (N, 3) rows -> contiguous (3, N) tensors; (N,) as they are."""
    return [torch.from_numpy(np.ascontiguousarray(x.T if x.ndim == 2
                                                  else x)) for x in xs]


def test_closest_hit_matches_bruteforce_with_time():
    """The plain closest hit at per-ray times against JAX brute force with
    ``time=`` on 300 fast movers (|v| up to 6 per axis) and 1024 random
    rays; at t = 0 the answer differs."""
    js, ts = moving_field(JBuilder), moving_field(TBuilder)
    o, d, tm = rand_rays(1024, 10.0, seed=1)
    jh = jix.intersect_bruteforce(js, jnp.asarray(o), jnp.asarray(d), T_MIN,
                                  jnp.inf, time=jnp.asarray(tm))
    tab = fused_bounce.pack_tables(ts)
    assert tab.sph_vel is not None
    ot, dt, tmt = tt(o, d, tm)
    alive = torch.ones(1024, dtype=torch.bool)
    hit = closest_hit.closest_tables(tab, ot, dt, T_MIN, INF, alive,
                                     time=tmt)
    jt, jty, jixs = (np.asarray(x) for x in jh)
    t, ty, ix = (x.numpy() for x in hit[:3])
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(jt))
    both = np.isfinite(jt)
    np.testing.assert_allclose(t[both], jt[both], rtol=1e-5, atol=2e-4)
    other = both & ((ty != jty) | (ix != jixs))
    assert (t[other] == jt[other]).all(), "another winner off a tie"
    assert other.sum() <= 2
    still = closest_hit.closest_tables(tab, ot, dt, T_MIN, INF, alive)
    moved = (still.ix.numpy() != ix) | (still.ty.numpy() != ty)
    assert moved.sum() >= 50, "the shutter time moves winners"


def test_attributes_at_the_moved_centre():
    """Point, normal and front face of the winner against JAX
    ``hit_attributes(time=)``; without the time the sphere normals are
    another."""
    js, ts = moving_field(JBuilder), moving_field(TBuilder)
    o, d, tm = rand_rays(1024, 10.0, seed=2)
    jo, jd, jtm = jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)
    hb = jix.intersect_bruteforce(js, jo, jd, T_MIN, jnp.inf, time=jtm)
    ab = jix.hit_attributes(js, jo, jd, hb, time=jtm)
    ot, dt, tmt = tt(o, d, tm)
    c, h, _ = dispatch.intersect_and_attrs(ts, ot, dt, T_MIN, INF, time=tmt)
    sel = (np.isfinite(np.asarray(hb.t)) & (c.ix.numpy() == np.asarray(
        hb.prim_idx)) & (c.ty.numpy() == np.asarray(hb.prim_type)))
    assert sel.sum() >= 200
    np.testing.assert_allclose(h.p.numpy().T[sel], np.asarray(ab.p)[sel],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(h.n.numpy().T[sel],
                               np.asarray(ab.normal)[sel], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_array_equal(h.front.numpy()[sel],
                                  np.asarray(ab.front_face)[sel])
    h0, _ = twf.attrs_soa(fused_bounce.pack_tables(ts), ot, dt, c)
    sph = sel & (c.ty.numpy() == PRIM_SPHERE)
    assert (np.abs(h0.n.numpy() - h.n.numpy()).max(0)[sph] > 1e-2).sum() \
        >= 50


def off(a, b, slack=0.0):
    """Lanes where |a - b| exceeds rtol = atol = 1e-4 (+ slack)."""
    return (np.abs(a - b) > 1e-4 + 1e-4 * np.abs(b) + slack).any(0)


def test_bounce_matches_jax_with_time():
    """``bounce_fused_plain`` with per-ray times against JAX
    ``bounce_fused(time=)`` (interpret mode) on 64 moving spheres of three
    materials, 256 lanes, with ``test_torch_bounce.py``'s tolerances."""
    js, ts = small_scene(JBuilder), small_scene(TBuilder)
    o, d, alive, uni = make_rays(js, 3, n=256)
    tm = np.random.default_rng(13).random(256, dtype=np.float32)
    jout = [np.asarray(x) for x in pi.bounce_fused(
        js, jnp.asarray(o), jnp.asarray(d), T_MIN, jnp.asarray(alive),
        jnp.asarray(uni), time=jnp.asarray(tm))]
    args = [torch.from_numpy(x) for x in (o, d, alive, uni, tm)]
    tout = [x.numpy() for x in fused_bounce.bounce_fused(
        ts, *args[:2], T_MIN, *args[2:4], time=args[4])]
    agree = (jout[0] == tout[0]) & alive
    assert agree.sum() >= 0.999 * alive.sum()
    assert len(np.unique(tout[0][alive])) >= 3
    j_no, j_nd, j_att, j_emit, j_p, j_n = jout[1:]
    t_no, t_nd, t_att, t_emit, t_p, t_n = tout[1:]
    p_tol = 1e-5 * float(np.asarray(js.scale))
    np.testing.assert_allclose(t_p[:, agree], j_p[:, agree], rtol=0,
                               atol=p_tol)
    np.testing.assert_allclose(t_no[:, agree], j_no[:, agree], rtol=0,
                               atol=p_tol)
    colour = agree & (off(t_att, j_att) | off(t_emit, j_emit))
    near_edge = np.abs(np.sin(10.0 * j_p.astype(np.float64))).min(0) \
        < 10.0 * p_tol
    assert not (colour & ~near_edge).any()
    tab = fused_bounce.pack_tables(ts)
    _, ty, ix, _, _ = fused_bounce._closest_plain(tab, *args[:2], T_MIN,
                                                  args[2], time=args[4])
    radius = ts.spheres.radius.numpy()
    r_win = np.where(ty.numpy() == PRIM_SPHERE,
                     radius[np.clip(ix.numpy(), 0, len(radius) - 1)], np.inf)
    dp = np.abs(t_p - j_p).max(0) / r_win
    same = agree & ~colour
    assert not (same & off(t_n, j_n, 2.0 * dp)).any()
    assert not (same & off(t_nd, j_nd, 8.0 * dp)).any()


def test_regen_step_matches_jax_with_time():
    """``regen_step_plain`` with the lanes' times against JAX
    ``regen_step_fused(time=)`` (interpret mode) with
    ``test_torch_regen.py``'s tolerances; U's row 8 (JAX ``uni2`` row 9)
    draws the respawned lanes' times, equal to 1 ulp, and the other lanes
    keep theirs."""
    js, ts = small_scene(JBuilder), small_scene(TBuilder)
    st, eps = make_lanes(js, 4, n=256)
    rng = np.random.default_rng(14)
    st["U"] = np.concatenate([st["U"], rng.random((1, 256), dtype=np.float32)])
    tm = rng.random(256, dtype=np.float32)
    f = np.float32
    uni2 = np.concatenate([st["U"][:3], np.full((1, 256), eps, f),
                           st["U"][3:]], 0)
    out = pi.regen_step_fused(
        js, *(jnp.asarray(st[k]) for k in ("o", "d")), T_MIN,
        jnp.asarray(st["alive"].astype(f)), jnp.asarray(uni2),
        *(jnp.asarray(st[k]) for k in ("px", "py", "tput", "samp", "acc")),
        jnp.asarray(st["depth"].astype(f)), jnp.asarray(st["done"].astype(f)),
        width=W, height=H, quota=QUOTA, max_depth=MAX_DEPTH, rr_on=True,
        rr_start=RR_START, time=jnp.asarray(tm))
    j = [np.asarray(x) for x in out]
    lanes = port_lanes(st)._replace(time=torch.from_numpy(tm))
    t = regen.regen_step_plain(
        fused_bounce.pack_tables(ts), regen.pack_camera(ts.camera),
        torch.from_numpy(st["U"]), eps, lanes, width=W, height=H,
        quota=QUOTA, max_depth=MAX_DEPTH, rr_on=True, rr_start=RR_START,
        t_min=T_MIN)
    alive = st["alive"]
    t_alive, t_depth, t_done = (getattr(t, k).numpy()
                                for k in ("alive", "depth", "done"))
    same = (t_alive == (j[5][0] > 0)) & (t_depth == j[6][0]) & \
        (t_done == j[7][0])
    assert same[alive].mean() >= 0.99
    respawn = alive & same & (t_done > st["done"]) & t_alive
    assert respawn.sum() >= 20
    np.testing.assert_array_max_ulp(t.time.numpy()[same], j[8][0][same],
                                    maxulp=1)
    keep = same & ~respawn
    np.testing.assert_array_equal(t.time.numpy()[keep], tm[keep])
    t0, t1 = float(ts.camera.time0), float(ts.camera.time1)
    assert ((t.time.numpy() >= t0) & (t.time.numpy() <= t1)).all()
    p_tol = 1e-5 * float(np.asarray(js.scale))
    held = same & alive
    np.testing.assert_allclose(t.o.numpy()[:, held], j[0][:, held], rtol=0,
                               atol=p_tol)
    for k, jx in (("tput", j[2]), ("samp", j[3]), ("acc", j[4])):
        bad = held & off(getattr(t, k).numpy(), jx)
        assert bad.mean() <= 0.01, k


_FIELD = []


def _big_field():
    """The port's 20,000-sphere moving field, built once."""
    if not _FIELD:
        _FIELD.append(moving_field(TBuilder, n=20000, extent=40.0, vmax=8.0,
                                   seed=4, with_rect=False))
    return _FIELD[0]


@pytest.mark.parametrize("dilated", [True, False])
def test_ordered_walk_with_time(dilated):
    """The plain ordered walk at per-ray times against the plain flat
    sweep on 20,000 fast movers (|v| up to 8 per axis; the field of
    ``test_motion_pallas.py``'s ordered test, 79 chunks): the same winner
    and t on every alive lane. The same walk over boxes that are not
    dilated over the shutter (packed with the shutter closed at 0) loses
    winners: the check can fail."""
    ts = _big_field()
    tab = fused_bounce.pack_tables(ts)
    assert tab.osph is not None and tab.osph.vel is not None
    if not dilated:
        s = ts.spheres
        tab = tab._replace(osph=ordered.sphere_stage(
            tab.sph, s.center, s.radius, ts.camera.origin, tab.sph_vel,
            (0.0, 0.0)))
    # half the rays random; half aimed outward, from 1-3 units inside, at a
    # sphere that stands outside the field's t = 0 box at the ray's time:
    # only a box dilated over the shutter holds it
    o, d, tm = rand_rays(1024, 40.0, seed=5)
    rng = np.random.default_rng(6)
    t_ray = rng.uniform(0.5, 1.0, 512).astype(np.float32)
    c0 = ts.spheres.center.numpy()
    moved = c0[None] + ts.spheres.velocity.numpy()[None] * t_ray[:, None, None]
    lo, hi = c0.min(0), c0.max(0)
    out = ((moved < lo - 2.0) | (moved > hi + 2.0)).any(-1)   # (512, S)
    j = np.array([rng.choice(np.where(row)[0]) for row in out])
    aim = moved[np.arange(512), j]
    inward = -aim / np.linalg.norm(aim, axis=1, keepdims=True)
    off = inward * (ts.spheres.radius.numpy()[j]
                    + rng.uniform(1.0, 3.0, 512))[:, None]
    o[:512], d[:512], tm[:512] = aim + off, -off, t_ray
    ot, dt, tmt = tt(o, d, tm)
    alive = torch.from_numpy(rng.random(1024) > 0.05)
    walk = closest_hit.closest_ordered_plain(tab, ot, dt, T_MIN, INF, alive,
                                             time=tmt)
    flat = closest_hit.closest_hit_plain(tab, ot, dt, T_MIN, INF, alive,
                                         time=tmt)
    lost = alive & ((walk.ty != flat.ty) | (walk.ix != flat.ix)
                    | ~torch.eq(walk.t, flat.t))
    assert int((flat.ty >= 0).sum()) >= 500
    if dilated:
        assert not lost.any(), f"{int(lost.sum())} winners lost"
    else:
        assert lost.sum() >= 50, f"only {int(lost.sum())} winners lost"


def test_moving_tables_cover_the_shutter():
    """Each moving sphere's chunk box holds the sphere at both ends of the
    shutter; static scenes pack no velocities; the sorted velocities are
    the scene's."""
    ts = _big_field()
    tab = fused_bounce.pack_tables(ts)
    st = tab.osph
    slot = st.orig.long()
    real = slot >= 0
    np.testing.assert_array_equal(st.vel[real].numpy(),
                                  tab.sph_vel[slot[real]].numpy())
    assert (st.vel[~real] == 0).all()
    box = st.cull[torch.arange(slot.shape[0]) // st.chunk][real]
    c, r = ts.spheres.center[slot[real]], ts.spheres.radius[slot[real]]
    for t in (0.0, 1.0):
        ct = c + ts.spheres.velocity[slot[real]] * t
        assert ((ct - r[:, None] >= box[:, :3]) & (ct + r[:, None]
                                                   <= box[:, 3:])).all()
    static = fused_bounce.pack_tables(tbuiltin.sphere_field(3000))
    assert static.sph_vel is None and static.osph.vel is None


def light_scenes(builder):
    """A moving sphere light, a static one and a rect light; the same
    scene with the moving light parked where it stands at time 0.5."""
    out = []
    for parked in (False, True):
        b = builder()
        m = b.lambertian(b.constant_texture((0.5, 0.5, 0.5)))
        b.add_sphere((0, -1000, 0), 1000.0, m)
        if parked:
            b.add_sphere_light((1.0, 5.25, -0.5), 1.0, (4.0, 4.0, 4.0), 10.0)
        else:
            b.add_sphere_light((0.0, 5.0, 0.0), 1.0, (4.0, 4.0, 4.0), 10.0,
                               center1=(2.0, 5.5, -1.0))
        b.add_sphere_light((-3.0, 4.0, 2.0), 0.5, (2.0, 2.0, 2.0), 5.0)
        b.add_xzrect_light(2.0, 2.0, 3.0, 3.0, 4.0, (1.0, 1.0, 1.0), 3.0)
        b.set_camera((0, 2, 12), (0, 1, 0), time0=0.0, time1=1.0)
        out.append(b.compile())
    return out


def test_light_pdf_with_a_moving_light():
    """``mis.light_pdf`` at per-lane times against JAX ``light_pdf(time=)``
    (``_light_centers``), on directions toward the lights' moved
    centres."""
    js, ts = light_scenes(JBuilder)[0], light_scenes(TBuilder)[0]
    rng = np.random.default_rng(8)
    n = 2048
    p = rng.uniform([-4.0, 0.0, -4.0], [4.0, 1.0, 4.0], (n, 3)) \
        .astype(np.float32)
    tm = rng.random(n, dtype=np.float32)
    lt = ts.lights
    k = rng.integers(0, lt.kind.shape[0], n)
    c = lt.p0.numpy()[k] + lt.vel.numpy()[k] * tm[:, None]
    aim = c + rng.normal(scale=0.4, size=(n, 3))
    d = (aim - p) / np.linalg.norm(aim - p, axis=1, keepdims=True)
    d = d.astype(np.float32)
    jp = np.asarray(jmis.light_pdf(js, jnp.asarray(p), jnp.asarray(d),
                                   time=jnp.asarray(tm)))
    pt_, dt_, tmt = tt(p, d, tm)
    tp = mis.light_pdf(lt, pt_, dt_, tmt).numpy()
    assert (jp > 0).mean() >= 0.3
    # test_torch_nee.py's rule: 1e-5 relative plus four float32 ulps of
    # 1 - cos_max of the narrowest cone (at the moved centres) holding d
    r0 = lt.r0.numpy()
    cen = (lt.p0.numpy()[None] + lt.vel.numpy()[None] * tm[:, None, None]) \
        .astype(np.float64)
    to_c = cen - p[:, None]
    dist2 = (to_c * to_c).sum(-1)
    cos_max = np.sqrt(np.clip(1.0 - r0 ** 2 / dist2, 0, 1))
    cos_d = (to_c * d[:, None]).sum(-1) / np.sqrt(dist2)
    amp = np.where(cos_d >= cos_max - 1e-6,
                   1.0 / np.maximum(1.0 - cos_max, 1e-8), 0.0).max(1)
    rtol = 1e-5 + 4 * 2.0 ** -24 * amp
    assert (np.abs(tp - jp) <= rtol * np.abs(jp) + 1e-7 * jp.max()).all()
    still = mis.light_pdf(lt, pt_, dt_).numpy()
    assert (np.abs(still - tp) > 1e-3 * np.abs(tp)).sum() >= 100


@pytest.mark.parametrize("estimator", ["nee", "mis"])
def test_moving_light_at_its_time(estimator):
    """NEE's direct light and MIS's light directions at time 0.5 with a
    moving light equal those of the scene with the light parked at its
    time-0.5 position (shadow rays and the light sphere's geometry at the
    lanes' time)."""
    moving, parked = light_scenes(TBuilder)
    rng = np.random.default_rng(9)
    n = 1024
    p = np.concatenate([rng.uniform(-4, 4, (1, n)), np.zeros((1, n)),
                        rng.uniform(-4, 4, (1, n))]).astype(np.float32)
    p = torch.from_numpy(p)
    normal = torch.tensor([[0.0], [1.0], [0.0]]).expand(3, n).contiguous()
    idx = torch.from_numpy(rng.integers(0, 3, n))
    uni = torch.from_numpy(rng.random((4, n), dtype=np.float32))
    half = torch.full((n,), 0.5)
    if estimator == "nee":
        albedo = torch.full((3, n), 0.5)
        valid = torch.ones(n, dtype=torch.bool)
        a, _ = nee.direct_light_from(moving, fused_bounce.pack_tables(moving),
                                     idx, uni, p, normal, albedo, valid,
                                     time=half)
        b, _ = nee.direct_light_from(parked, fused_bounce.pack_tables(parked),
                                     idx, uni, p, normal, albedo, valid)
        assert (b > 0).any()
    else:
        a = mis.sample_light_dir_from(moving.lights, idx, uni[0], uni[1], p,
                                      half)
        b = mis.sample_light_dir_from(parked.lights, idx, uni[0], uni[1], p)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)


RENDER = dict(width=64, height=48, spp=16, spp_chunk=2, max_depth=8,
              t_min=T_MIN, spawn_eps_rel=1e-4)


def port_render(scene, seed=0, **kw):
    return tpt.render_fn(scene, torch.Generator().manual_seed(seed),
                         device="cpu", **{**RENDER, **kw})[0].numpy()


def test_render_matches_jax_bruteforce():
    """The two moving spheres at 64x48: the port's image mean (64 spp,
    seed-to-seed spread 1.9% on the CPU) within 6% of JAX
    ``render_fn(intersector="bruteforce")``'s (16 spp); a repeat render is
    bit-identical, and the frozen shutter's image differs."""
    jimg, _ = jpt.render_fn(two_spheres(JBuilder), jax.random.PRNGKey(0),
                            intersector="bruteforce", **RENDER)
    img = port_render(two_spheres(TBuilder), spp=64)
    assert np.isfinite(img).all()
    mj, mt = float(np.mean(np.asarray(jimg))), float(img.mean())
    assert abs(mt - mj) / mj < 0.06, (mt, mj)
    small = dict(spp=4, spp_chunk=2)
    again = port_render(two_spheres(TBuilder), 1, **small)
    np.testing.assert_array_equal(again, port_render(two_spheres(TBuilder),
                                                     1, **small))
    frozen = port_render(two_spheres(TBuilder, frozen=True), 1, **small)
    assert np.abs(frozen - again).mean() > 0.01


@pytest.mark.parametrize("n", [300, 2100])
def test_one_kernel_step_equals_loop_with_time(n, monkeypatch):
    """On a moving scene (motion_field: flat at 300 spheres, the walk at
    2100) the one-kernel step's route equals the loop's own step bit for
    bit (image, rays, steps), both carrying the lanes' times; NEE and MIS
    render finite images."""
    scene = tbuiltin.motion_field(n, 4.0 / 3.0)
    tab = fused_bounce.pack_tables(scene)
    assert tab.ordered == (n > 2048) and tab.sph_vel is not None
    kw = dict(width=16, height=12, spp=4, spp_chunk=2, max_depth=6,
              t_min=T_MIN, spawn_eps_rel=1e-5, device="cpu", tables=tab)
    out = []
    for one in (True, False):
        monkeypatch.setattr(twf, "_ONE_KERNEL_STEP", one)
        stats = {}
        img, rays = tpt.render_fn(scene, torch.Generator().manual_seed(3),
                                  stats=stats, **kw)
        out.append((img, rays, stats["steps"]))
    assert torch.equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]
    for est in (dict(nee=True), dict(mis=True)):
        img, rays = tpt.render_fn(scene, torch.Generator().manual_seed(3),
                                  **est, **kw)
        assert torch.isfinite(img).all() and rays > 0


def test_resolve_rules_for_moving_scenes():
    """JAX ``_resolve``'s rules: a moving scene takes the kernel route even
    for "leaf" (no leaf tables are built), which renders; "bruteforce"
    stays itself; "bvh" takes the kernel route too (JAX ``_resolve``)."""
    scene = tbuiltin.motion_field(10, 4.0 / 3.0)
    assert dispatch.route(scene, "auto") == "pallas"
    assert dispatch.resolve("pallas", True) == "pallas"
    assert dispatch.resolve("leaf", True) == "pallas"
    assert dispatch.resolve("leaf", False) == "leaf"
    assert dispatch.resolve("bvh", True) == "pallas"
    assert dispatch.resolve("bvh", False) == "bvh"
    assert dispatch.resolve("bruteforce", True) == "bruteforce"
    img, rays = tpt.render_fn(scene, torch.Generator(), width=8, height=6,
                              spp=1, spp_chunk=1, max_depth=2, t_min=T_MIN,
                              spawn_eps_rel=1e-5, intersector="leaf",
                              device="cpu")
    assert torch.isfinite(img).all() and rays > 0


def test_time_needs_moving_tables():
    """A regen step whose lanes carry a time over static tables raises (the
    kernel would leave the time stale); a bounce with a time over static
    tables is the static bounce."""
    ts = tbuiltin.three_spheres(1.0)
    tab = fused_bounce.pack_tables(ts)
    st, eps = make_lanes(small_scene(JBuilder), 5, n=128)
    lanes = port_lanes(st)._replace(time=torch.zeros(128))
    with pytest.raises(ValueError, match="velocities"):
        regen.regen_step_plain(
            tab, regen.pack_camera(ts.camera), torch.from_numpy(st["U"]),
            eps, lanes, width=W, height=H, quota=QUOTA, max_depth=MAX_DEPTH,
            rr_on=False, rr_start=RR_START, t_min=T_MIN)
    o, d, alive, uni = (torch.from_numpy(x) for x in
                        make_rays(small_scene(JBuilder), 6, n=128))
    a = fused_bounce.bounce_tables(tab, o, d, T_MIN, alive, uni,
                                   time=torch.rand(128))
    b = fused_bounce.bounce_tables(tab, o, d, T_MIN, alive, uni)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
