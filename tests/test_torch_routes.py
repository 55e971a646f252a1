"""Route choice and table packing for scenes past the kernels' cap
(``ops/dispatch.py::auto_route``, ``route_tables``).

The ordered walk's shared-memory sort holds ``ordered.MAX_SUPERS``
superchunks; a larger sphere or triangle table cannot be packed for the
kernel route. "auto" then takes "bvh" on a scene with a BVH, else
"bruteforce" (JAX ``_resolve`` past its caps), and the routes that never
read the ordered stages ("leaf", "bruteforce", "bvh") do not build them.
The tests lower ``MAX_SUPERS`` to 1 so that a 2,100-sphere field (9
chunks of 256, padded to 2 superchunks) is past it: no 2M-sphere table is
built.
"""

import pytest
import torch

from raytracer_tpu_torch.models import path_tracer, sppm
from raytracer_tpu_torch.ops import dispatch, ordered
from raytracer_tpu_torch.ops.bvh import build_bvh
from raytracer_tpu_torch.ops.fused_bounce import pack_tables
from raytracer_tpu_torch.ops.leaf import build_leaf_tables
from raytracer_tpu_torch.scene import builtin
from raytracer_tpu_torch.utils.config import RenderConfig, SPPMConfig
from test_torch_parallel import one_thread  # noqa: F401

N_FIELD = 2100
CFG = RenderConfig(width=8, height=6, samples_per_pixel=2, spp_chunk=1,
                   max_depth=3,
                   sppm=SPPMConfig(n_iterations=1, photons_per_iter=500,
                                   max_photon_bounces=3,
                                   max_camera_bounces=3))


def field(bvh=False, leaf=False):
    sc = builtin.sphere_field(N_FIELD, aspect_ratio=8 / 6)
    if bvh:
        sc = build_bvh(sc, use_native=False)
    if leaf:
        sc = sc._replace(leaf=build_leaf_tables(sc))
    return sc


@pytest.fixture
def small_cap(monkeypatch):
    monkeypatch.setattr(ordered, "MAX_SUPERS", 1)


def test_auto_leaves_the_kernels_past_the_cap(small_cap):
    assert ordered.past_cap(N_FIELD, ordered.SPH_CHUNK)
    assert dispatch.route(field(), "auto") == "bruteforce"
    assert dispatch.route(field(bvh=True), "auto") == "bvh"
    with pytest.raises(ValueError, match="superchunks"):
        pack_tables(field())


def test_auto_keeps_the_kernels_below_the_cap():
    assert not ordered.past_cap(N_FIELD, ordered.SPH_CHUNK)
    assert dispatch.route(field(bvh=True), "auto") == "pallas"
    assert dispatch.route(builtin.cornell_box(), "auto") == "pallas"


def test_moving_scene_past_the_cap_takes_brute_force(small_cap):
    """As JAX ``_resolve``: a moving scene's "auto" falls to brute force
    past the cap, even with a BVH; "bvh" and "leaf" still take the kernel
    route (neither has a motion form)."""
    sc = build_bvh(builtin.motion_field(N_FIELD), use_native=False)
    assert dispatch.route(sc, "auto") == "bruteforce"
    assert dispatch.route(sc, "bvh") == "pallas"
    assert dispatch.route(sc, "leaf") == "pallas"


@pytest.mark.parametrize("route", ["auto", "bruteforce", "bvh", "leaf"])
def test_path_tracer_renders_past_the_cap(small_cap, route):
    sc = field(bvh=route == "bvh", leaf=route == "leaf")
    img, rays = path_tracer.render(sc, CFG.replace(intersector=route), 0,
                                   device="cpu")
    assert img.shape == (6, 8, 3) and torch.isfinite(img).all()
    assert rays >= 8 * 6 * 2


@pytest.mark.parametrize("route", ["auto", "bruteforce", "bvh", "leaf"])
def test_sppm_renders_past_the_cap(small_cap, route):
    sc = field(bvh=route == "bvh", leaf=route == "leaf")
    img, rays, state = sppm.render(sc, CFG.replace(intersector=route), 0,
                                   device="cpu")
    assert img.shape == (6, 8, 3) and torch.isfinite(img).all()
    assert rays > 0 and state.iteration == 1


def test_kernel_route_past_the_cap_still_refuses(small_cap):
    with pytest.raises(ValueError, match="superchunks"):
        path_tracer.render(field(), CFG.replace(intersector="pallas"), 0,
                           device="cpu")


@pytest.mark.parametrize("route", ["auto", "leaf"])
def test_renders_below_the_cap_are_unchanged(route):
    """Below the cap the kernel and leaf routes render what they did when
    every render packed the ordered stages (``pack_tables(scene)``): the
    leaf route now packs none, and its kernel never read them."""
    sc = field(leaf=route == "leaf")
    cfg = CFG.replace(intersector=route)
    img, rays = path_tracer.render(sc, cfg, 3, device="cpu")
    tables = pack_tables(sc)
    assert tables.osph is not None
    ref, ref_rays = path_tracer.render_fn(
        sc, torch.Generator().manual_seed(3), width=8, height=6, spp=2,
        spp_chunk=1, max_depth=3, t_min=cfg.t_min,
        spawn_eps_rel=cfg.spawn_eps_rel, intersector=route, device="cpu",
        tables=tables)
    assert torch.equal(img, ref) and rays == ref_rays


def test_sppm_leaf_route_below_the_cap_is_unchanged(monkeypatch):
    sc = field(leaf=True)
    cfg = CFG.replace(intersector="leaf")
    img, rays, _ = sppm.render(sc, cfg, 4, device="cpu")
    monkeypatch.setattr(dispatch, "route_tables",
                        lambda scene, method: pack_tables(scene))
    ref, ref_rays, _ = sppm.render(sc, cfg, 4, device="cpu")
    assert torch.equal(img, ref) and rays == ref_rays
