"""The port's fused bounce (``raytracer_tpu_torch.ops.fused_bounce``)
against the JAX package's Pallas ``bounce_fused``, run as the JAX tests run
it on the CPU (interpret mode). The same rays and uniform rows, made with
numpy from a seed, go through both; on the CPU the port takes its plain
PyTorch version, the function its CUDA kernel is checked against on the
card (``chip_smoke.py``).

Tolerances, from what float32 can hold:
- ``inter`` agrees on >= 99.9% of alive lanes. A lane on a decision edge
  (disc ~ 0, Schlick ~ u2, two primitives at equal t) may flip under the
  two packages' different operation order.
- Where ``inter`` agrees, ``att`` and ``emit`` agree to rtol = atol = 1e-4,
  except on a lane whose hit point lies within the point tolerance of a
  checker edge (sin(10 p_k) ~ 0), where the texture pick may flip.
- ``p`` and ``no`` agree to atol = 1e-5 * scene.scale (the spawn-epsilon
  scale). Both packages solve the sphere quadratic in float32, and for a
  camera ray (|d| ~ 10) it cancels: the hit points of the two packages
  differ by up to ~1e-3 on scene_500 (each is as far from the float64
  answer).
- A sphere normal is (p - c) / r, so it inherits that point difference
  divided by the radius (0.045 for scene_500's lights). ``n`` agrees to
  rtol = atol = 1e-4 plus 2 |dp| / r, and ``nd``, which reflection doubles
  and refraction amplifies further, to 1e-4 plus 8 |dp| / r (measured
  factors: 1.05 and 2.7 over six seeds). Rect and triangle winners get no
  such term.
"""

import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from raytracer_tpu.models.wavefront_soa import camera_rays_soa  # noqa: E402
from raytracer_tpu.ops import pallas_intersect  # noqa: E402
from raytracer_tpu.scene import builtin as jbuiltin  # noqa: E402
from raytracer_tpu.scene.loader import load_scene as jload  # noqa: E402
from raytracer_tpu.scene.types import INTER_ABSORB, PRIM_SPHERE  # noqa: E402
from raytracer_tpu_torch.ops import fused_bounce  # noqa: E402
from raytracer_tpu_torch.scene import builtin as tbuiltin  # noqa: E402
from raytracer_tpu_torch.scene.loader import load_scene as tload  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
N_RAYS = 2048
T_MIN = 1e-3

SCENES = {
    "three_spheres": (lambda: jbuiltin.three_spheres(),
                      lambda: tbuiltin.three_spheres()),
    "cornell_mesh": (lambda: jbuiltin.cornell_box(with_mesh=True),
                     lambda: tbuiltin.cornell_box(with_mesh=True)),
    "scene_500": (lambda: jload(os.path.join(DATA, "scene_500.json")),
                  lambda: tload(os.path.join(DATA, "scene_500.json"))),
}


def make_rays(jscene, seed, n=N_RAYS):
    """Half camera rays (random pixels of a 64x48 image), half random
    origins inside the scene bounds with random directions; a few dead
    lanes; scatter uniforms in rows 0-2 and the spawn epsilon in row 3."""
    rng = np.random.default_rng(seed)
    h = n // 2
    px = rng.integers(0, 64, h).astype(np.float32)
    py = rng.integers(0, 48, h).astype(np.float32)
    cam_uni = rng.random((4, h), dtype=np.float32)
    cam = camera_rays_soa(jscene.camera, None, jnp.asarray(px),
                          jnp.asarray(py), 64, 48, uni=jnp.asarray(cam_uni))
    cam = np.stack([np.asarray(c) for c in cam])          # (6, h)
    lo = np.asarray(jscene.bounds_min)
    hi = np.asarray(jscene.bounds_max)
    o_rand = (lo[:, None] + rng.random((3, n - h)) * (hi - lo)[:, None])
    d_rand = rng.normal(size=(3, n - h))
    o = np.concatenate([cam[:3], o_rand], 1).astype(np.float32)
    d = np.concatenate([cam[3:], d_rand], 1).astype(np.float32)
    alive = rng.random(n) > 0.03
    eps = np.float32(1e-5) * np.asarray(jscene.scale)
    uni = np.concatenate([rng.random((3, n), dtype=np.float32),
                          np.full((1, n), eps, np.float32)], 0)
    return o, d, alive, uni


def run_both(jscene, tscene, o, d, alive, uni):
    jout = pallas_intersect.bounce_fused(
        jscene, jnp.asarray(o), jnp.asarray(d), T_MIN, jnp.asarray(alive),
        jnp.asarray(uni))
    tout = fused_bounce.bounce_fused(
        tscene, torch.from_numpy(o), torch.from_numpy(d), T_MIN,
        torch.from_numpy(alive), torch.from_numpy(uni))
    return ([np.asarray(x) for x in jout], [x.numpy() for x in tout])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bounce_matches_jax(name):
    jscene, tscene = SCENES[name][0](), SCENES[name][1]()
    o, d, alive, uni = make_rays(jscene, seed=sorted(SCENES).index(name))
    jout, tout = run_both(jscene, tscene, o, d, alive, uni)
    j_inter, t_inter = jout[0], tout[0]
    assert t_inter.dtype == np.int32 and t_inter.shape == (N_RAYS,)
    for x in tout[1:]:
        assert x.shape == (3, N_RAYS) and x.dtype == np.float32
    agree = (j_inter == t_inter) & alive
    share = agree.sum() / alive.sum()
    assert share >= 0.999, f"inter agrees on {share:.5f} of alive lanes"
    # the scene is really exercised: hits of several interaction kinds
    assert len(np.unique(t_inter[alive])) >= 3

    j_no, j_nd, j_att, j_emit, j_p, j_n = jout[1:]
    t_no, t_nd, t_att, t_emit, t_p, t_n = tout[1:]
    p_tol = 1e-5 * float(np.asarray(jscene.scale))
    np.testing.assert_allclose(t_p[:, agree], j_p[:, agree], rtol=0,
                               atol=p_tol, err_msg="p")
    np.testing.assert_allclose(t_no[:, agree], j_no[:, agree], rtol=0,
                               atol=p_tol, err_msg="no")

    def off(a, b, slack=0.0):
        """Lanes where |a - b| exceeds rtol = atol = 1e-4 (+ slack)."""
        return (np.abs(a - b) > 1e-4 + 1e-4 * np.abs(b) + slack).any(0)

    colour_off = agree & (off(t_att, j_att) | off(t_emit, j_emit))
    near_edge = np.abs(np.sin(10.0 * j_p.astype(np.float64))).min(0) \
        < 10.0 * p_tol
    assert not (colour_off & ~near_edge).any(), (
        "att/emit differ away from a checker edge on lanes "
        f"{np.where(colour_off & ~near_edge)[0][:8]}")

    ty, ix = (x.numpy() for x in fused_bounce._closest_plain(
        fused_bounce.pack_tables(tscene), torch.from_numpy(o),
        torch.from_numpy(d), T_MIN, torch.from_numpy(alive))[1:3])
    radius = tscene.spheres.radius.numpy()
    r_win = np.where(ty == PRIM_SPHERE,
                     radius[np.clip(ix, 0, max(len(radius) - 1, 0))]
                     if len(radius) else np.inf, np.inf)
    dp = np.abs(t_p - j_p).max(0) / r_win
    same = agree & ~colour_off
    bad_n = same & off(t_n, j_n, 2.0 * dp)
    bad_nd = same & off(t_nd, j_nd, 8.0 * dp)
    assert not bad_n.any(), f"n differs on lanes {np.where(bad_n)[0][:8]}"
    assert not bad_nd.any(), f"nd differs on lanes {np.where(bad_nd)[0][:8]}"


@pytest.mark.parametrize("name", ["three_spheres", "cornell_mesh"])
def test_all_miss_rays_absorb(name):
    """Rays from outside the scene pointing away: both packages return
    ABSORB with zero emission and attenuation, and p = o."""
    jscene, tscene = SCENES[name][0](), SCENES[name][1]()
    rng = np.random.default_rng(11)
    n = 256
    hi = np.asarray(jscene.bounds_max)
    o = (hi[:, None] + 1.0 + rng.random((3, n))).astype(np.float32)
    d = (0.1 + rng.random((3, n))).astype(np.float32)     # away from bounds
    alive = np.ones(n, bool)
    uni = rng.random((4, n), dtype=np.float32)
    jout, tout = run_both(jscene, tscene, o, d, alive, uni)
    for out in (jout, tout):
        assert (out[0] == INTER_ABSORB).all()
        assert (out[4] == 0).all() and (out[3] == 0).all()
        np.testing.assert_array_equal(out[5], o)
