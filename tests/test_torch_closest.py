"""The port's closest hit (``raytracer_tpu_torch.ops.closest_hit``) and its
unfused bounce stage (``attrs_soa``, ``scatter_soa``, ``bounce_step(fused=
False)``) against the JAX package's Pallas ``intersect_pallas_full``,
``attrs_soa`` and ``scatter_soa``, run as the JAX tests run them on the
CPU (interpret mode). The same rays, t_max rows and uniforms, made with
numpy from a seed, go through both; on the CPU the port takes its plain
PyTorch version, the function its CUDA kernel is checked against on the
card (``chip_smoke.py``).

Tolerances, from what float32 can hold (the reasons of
``test_torch_bounce.py``):
- ``ty``/``ix`` agree on >= 99.9% of alive lanes: a ray grazing a
  silhouette, or two primitives at equal t, may pick another winner under
  the two packages' different operation order.
- Where they agree, t agrees to rtol 1e-5 and atol 1e-5 * scale / |d| (the
  point tolerance 1e-5 * scale in parametric units).
- Dead lanes: the port returns a miss; the TPU kernel returns real hits
  unless the whole ray tile is dead. Only alive lanes are compared.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from raytracer_tpu.models import wavefront_soa as jwf  # noqa: E402
from raytracer_tpu.ops import pallas_intersect  # noqa: E402
from raytracer_tpu.scene import SceneBuilder as JBuilder  # noqa: E402
from raytracer_tpu.scene.types import PRIM_SPHERE  # noqa: E402
from raytracer_tpu_torch.models import wavefront_soa as twf  # noqa: E402
from raytracer_tpu_torch.ops import closest_hit, dispatch  # noqa: E402
from raytracer_tpu_torch.ops import fused_bounce  # noqa: E402
from raytracer_tpu_torch.scene.builder import SceneBuilder  # noqa: E402
from test_torch_bounce import SCENES, T_MIN, make_rays  # noqa: E402

NAMES = sorted(SCENES)


def rays_with_tmax(jscene, seed):
    """``make_rays`` plus a t_max row: +inf on the first half of the lanes,
    finite on the second (a distance of 5% to 100% of the scene's size, in
    the ray's parametric units)."""
    o, d, alive, uni = make_rays(jscene, seed)
    n = o.shape[1]
    rng = np.random.default_rng(100 + seed)
    scale = float(np.asarray(jscene.scale))
    t_max = np.full(n, np.inf, np.float32)
    half = n // 2
    dn = np.linalg.norm(d[:, half:], axis=0)
    t_max[half:] = rng.uniform(0.05, 1.0, n - half) * scale / dn
    return o, d, alive, uni, t_max.astype(np.float32)


def port_closest(tscene, o, d, t_min, t_max, alive):
    tab = fused_bounce.pack_tables(tscene)
    out = closest_hit.closest_tables(
        tab, torch.from_numpy(o), torch.from_numpy(d), t_min,
        torch.from_numpy(t_max) if isinstance(t_max, np.ndarray) else t_max,
        torch.from_numpy(alive))
    return tab, out


def agreement(jty, jix, tty, tix, alive):
    agree = (jty == tty) & (jix == tix) & alive
    share = agree.sum() / alive.sum()
    assert share >= 0.999, f"winners agree on {share:.5f} of alive lanes"
    return agree


@pytest.mark.parametrize("name", NAMES)
def test_closest_matches_jax(name):
    jscene, tscene = SCENES[name][0](), SCENES[name][1]()
    o, d, alive, _, t_max = rays_with_tmax(jscene, NAMES.index(name))
    jhit, _, _ = pallas_intersect.intersect_pallas_full(
        jscene, jnp.asarray(o.T), jnp.asarray(d.T), T_MIN,
        jnp.asarray(t_max), alive=jnp.asarray(alive))
    _, out = port_closest(tscene, o, d, T_MIN, t_max, alive)
    t, ty, ix = (x.numpy() for x in out[:3])
    assert t.dtype == np.float32 and ty.dtype == np.int32
    assert ix.dtype == np.int32
    jt, jty, jix = (np.asarray(x) for x in jhit)
    agree = agreement(jty, jix, ty, ix, alive)
    scale = float(np.asarray(jscene.scale))
    atol = 1e-5 * scale / np.linalg.norm(d, axis=0)
    hit = agree & np.isfinite(jt)
    assert (np.isfinite(t) == np.isfinite(jt))[agree].all()
    assert (np.abs(t[hit] - jt[hit])
            <= (atol + 1e-5 * np.abs(jt))[hit]).all()
    # the case is really exercised: hits and misses, and t_max cuts some
    # hits that +inf keeps
    assert 0 < hit.sum() < alive.sum()
    _, full = port_closest(tscene, o, d, T_MIN, np.inf, alive)
    cut = np.isfinite(full.t.numpy()) & ~np.isfinite(t) & alive
    assert cut.any()
    assert (out.ty.numpy()[~alive] == -1).all()


@pytest.mark.parametrize("name", NAMES)
def test_attrs_and_scatter_match_jax(name):
    """``attrs_soa`` + ``scatter_soa`` on the closest hit against the JAX
    package's on its kernel's winner slots, with the tolerances of
    ``test_torch_bounce.py``."""
    jscene, tscene = SCENES[name][0](), SCENES[name][1]()
    o, d, alive, uni = make_rays(jscene, 10 + NAMES.index(name))
    jt, jty, jix, data = pallas_intersect._run(
        jscene, jnp.asarray(o.T), jnp.asarray(d.T), T_MIN, jnp.inf,
        alive=jnp.asarray(alive))
    jo, jd = [jnp.asarray(x) for x in o], [jnp.asarray(x) for x in d]
    jh, jf = jwf.attrs_soa(*jo, *jd, jt, jty, data)
    jsc = jwf.scatter_soa(jscene, jnp.asarray(uni[:3]), *jd, jh, jf)

    tab, hit = port_closest(tscene, o, d, T_MIN, np.inf, alive)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    h, f = twf.attrs_soa(tab, to, td, hit)
    sc = twf.scatter_soa(tscene, torch.from_numpy(uni), td, h, f)

    agree = agreement(np.asarray(jty), np.asarray(jix), hit.ty.numpy(),
                      hit.ix.numpy(), alive)
    scale = float(np.asarray(jscene.scale))
    p_tol = 1e-5 * scale
    jp = np.stack([np.asarray(x) for x in (jh.px, jh.py, jh.pz)])
    jn = np.stack([np.asarray(x) for x in (jh.nx, jh.ny, jh.nz)])
    p, n = h.p.numpy(), h.n.numpy()
    np.testing.assert_allclose(p[:, agree], jp[:, agree], rtol=0,
                               atol=p_tol, err_msg="p")
    assert (h.valid.numpy() == np.asarray(jh.valid))[agree].all()
    assert (h.front.numpy() == np.asarray(jh.front))[agree].all()
    for a, b in (("kind", "kind"), ("tex_kind", "tex_kind")):
        assert (getattr(f, a).numpy() == np.asarray(getattr(jf, b)))[
            agree].all()

    inter = sc.inter.numpy()
    same = agree & (inter == np.asarray(jsc.interaction))
    assert same.sum() >= 0.999 * alive.sum()
    assert len(np.unique(inter[alive])) >= 3

    def off(a, b, slack=0.0):
        return (np.abs(a - b) > 1e-4 + 1e-4 * np.abs(b) + slack).any(0)

    jatt = np.stack([np.asarray(x) for x in (jsc.ar, jsc.ag, jsc.ab)])
    jemit = np.stack([np.asarray(x) for x in (jsc.er, jsc.eg, jsc.eb)])
    jnd = np.stack([np.asarray(x) for x in (jsc.dx, jsc.dy, jsc.dz)])
    colour_off = same & (off(sc.att.numpy(), jatt)
                         | off(sc.emit.numpy(), jemit))
    near_edge = np.abs(np.sin(10.0 * jp.astype(np.float64))).min(0) \
        < 10.0 * p_tol
    assert not (colour_off & ~near_edge).any()
    radius = tscene.spheres.radius.numpy()
    ty, ix = hit.ty.numpy(), hit.ix.numpy()
    r_win = np.where(ty == PRIM_SPHERE,
                     radius[np.clip(ix, 0, max(len(radius) - 1, 0))]
                     if len(radius) else np.inf, np.inf)
    dp = np.abs(p - jp).max(0) / r_win
    keep = same & ~colour_off
    assert not (keep & off(n, jn, 2.0 * dp)).any(), "n"
    assert not (keep & off(sc.nd.numpy(), jnd, 8.0 * dp)).any(), "nd"
    # uv: away from the sphere seam (phi = +-pi), where u wraps
    ju, jv = np.asarray(jh.u), np.asarray(jh.v)
    seam = (ty == PRIM_SPHERE) & (np.abs(ju - 0.5) > 0.49)
    uv = keep & ~seam
    assert not (uv & (off(h.u.numpy()[None], ju[None], dp)
                      | off(h.v.numpy()[None], jv[None], dp))).any(), "uv"


def edge_scene(kind: str, build):
    """One primitive hit at exactly t = 2 by a ray from the origin along
    +y: a sphere (centre y = 3, radius 1), a y-rect at y = 2 or a triangle
    in the plane y = 2."""
    b = build()
    white = b.lambertian(b.constant_texture((0.5, 0.5, 0.5)))
    if kind == "sphere":
        b.add_sphere((0.0, 3.0, 0.0), 1.0, white)
    elif kind == "rect":
        b.add_rect(1, 2.0, -1.0, 1.0, -1.0, 1.0, white)
    else:
        b.add_triangles(np.array([[-1.0, 2.0, -1.0], [1.0, 2.0, -1.0],
                                  [0.0, 2.0, 1.0]]), np.array([[0, 1, 2]]),
                        white)
    return b.compile()


@pytest.mark.parametrize("kind", ["sphere", "rect", "triangle"])
def test_t_max_is_strict(kind):
    """A hit at t = 2 misses under t_max = 1.5 and under t_max = 2 (the
    fold keeps only t < t_max), and counts under t_max = 2.5 and +inf: in
    both packages."""
    t_max = np.array([1.5, 2.0, 2.5, np.inf], np.float32)
    n = t_max.shape[0]
    o = np.zeros((3, n), np.float32)
    d = np.tile(np.array([[0.0], [1.0], [0.0]], np.float32), (1, n))
    alive = np.ones(n, bool)
    expect = np.array([False, False, True, True])
    _, out = port_closest(edge_scene(kind, SceneBuilder), o, d, T_MIN,
                          t_max, alive)
    jhit = pallas_intersect.intersect_pallas(
        edge_scene(kind, JBuilder), jnp.asarray(o.T), jnp.asarray(d.T),
        T_MIN, jnp.asarray(t_max), alive=jnp.asarray(alive))
    for t in (out.t.numpy(), np.asarray(jhit.t)):
        assert (np.isfinite(t) == expect).all(), t
        np.testing.assert_array_equal(t[expect], 2.0)
    assert (out.ty.numpy() == np.where(expect, np.asarray(jhit.prim_type),
                                       -1)).all()
    assert (out.ix.numpy() == np.where(expect, 0, -1)).all()


def test_dead_lanes_miss():
    jscene, tscene = SCENES["cornell_mesh"][0](), SCENES["cornell_mesh"][1]()
    o, d, alive, _ = make_rays(jscene, 20)
    alive[::2] = False
    _, out = port_closest(tscene, o, d, T_MIN, np.inf, alive)
    _, all_dead = port_closest(tscene, o, d, T_MIN, np.inf,
                               np.zeros_like(alive))
    for res, dead in ((out, ~alive), (all_dead, np.ones_like(alive))):
        assert (res.ty.numpy()[dead] == -1).all()
        assert (res.ix.numpy()[dead] == -1).all()
        assert np.isinf(res.t.numpy()[dead]).all()
    assert np.isfinite(out.t.numpy()[alive]).any()


@pytest.mark.parametrize("name", NAMES)
def test_unfused_bounce_matches_fused(name):
    """The unfused stage (closest hit, ``attrs_soa``, ``scatter_soa``)
    against the port's fused plain bounce, on the same rays and uniform
    rows: the two routes of ``bounce_step`` agree lane for lane."""
    jscene, tscene = SCENES[name][0](), SCENES[name][1]()
    o, d, alive, uni = (torch.from_numpy(x)
                        for x in make_rays(jscene, 30 + NAMES.index(name)))
    tab = fused_bounce.pack_tables(tscene)
    eps = torch.tensor(uni[3, 0].item())
    kw = dict(t_min=T_MIN, spawn_eps=eps, scene=tscene)
    fused = twf.bounce_step(tab, uni, o, d, alive, fused=True, **kw)
    unfused = twf.bounce_step(tab, uni, o, d, alive, fused=False, **kw)
    alive = alive.numpy()
    agree = (fused.inter == unfused.inter).numpy()
    assert agree.all()
    assert len(np.unique(fused.inter.numpy()[alive])) >= 3
    for a, b, field in zip(fused[1:], unfused[1:], fused._fields[1:]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=field)


# "leaf" is ported: without leaf tables it raises ValueError, as JAX
# pallas_bvh._run does; "bvh" likewise without a BVH, with JAX's message;
# "bruteforce" is ported: it runs and finds the kernel route's winners (the
# cases keep their ids)
@pytest.mark.parametrize("method,error,item", [
    ("bvh", ValueError, "scene has no BVH; build it with ops.bvh.build_bvh"),
    pytest.param("leaf", ValueError, "no leaf tables", id="leaf-B4"),
    ("bruteforce", None, None)],
    ids=["bvh-A10", "leaf-B4", "bruteforce-A3"])
def test_dispatch_refuses_unported_routes(method, error, item):
    tscene = SCENES["three_spheres"][1]()
    o = torch.zeros((3, 4))
    d = torch.ones((3, 4))
    if error is None:
        got = dispatch.intersect_scene(tscene, o, d, T_MIN, float("inf"),
                                       method)
        ref = dispatch.intersect_scene(tscene, o, d, T_MIN, float("inf"))
        assert (got.ty == ref.ty).all() and (got.ix == ref.ix).all()
    else:
        with pytest.raises(error, match=item):
            dispatch.intersect_scene(tscene, o, d, T_MIN, float("inf"),
                                     method)
    hit, h, f = dispatch.intersect_and_attrs(tscene, o, d, T_MIN,
                                             float("inf"), "auto")
    assert hit.t.shape == (4,) and h.p.shape == (3, 4)
    assert ((hit.ty >= 0) == torch.isfinite(hit.t)).all()


def test_unfused_texture_refuses_images():
    """Image textures are ported (the name is kept): the unfused bounce
    reads the hit's texel, and the fused kernel, which evaluates constant
    and checker textures only, refuses the scene."""
    b = SceneBuilder()
    img = b.image_texture(np.full((2, 2, 3), 0.5, np.float32))
    b.add_sphere((0.0, 0.0, -2.0), 0.5, b.lambertian(img))
    scene = b.compile()
    tab = fused_bounce.pack_tables(scene)
    o = torch.zeros((3, 2))
    d = torch.tensor([[0.0, 0.0], [0.0, 0.0], [-1.0, -1.0]])
    alive = torch.ones(2, dtype=torch.bool)
    out = twf.bounce_step(tab, torch.rand((3, 2)), o, d, alive, t_min=T_MIN,
                          spawn_eps=1e-4, fused=False, scene=scene)
    np.testing.assert_array_equal(out.att.numpy(), 0.5)
    with pytest.raises(ValueError, match="unfused"):
        fused_bounce.bounce_fused(scene, o, d, T_MIN, alive,
                                  torch.rand((4, 2)))
