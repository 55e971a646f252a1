"""The Cornell box with the Stanford bunny in its mesh slot
(``scene/builtin.py::cornell_bunny``), on the CPU: the benchmark's plain
reference for it (``benchmark/reference/mesh.py``, ``sppm_mesh.py``)
against its brute-force closest hit and the port's vertex normals, the
default Cornell box as it was built before the mesh slot took other
meshes, the CLI, and one port SPPM iteration on the plain ordered walk
held to the reference."""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import cli
from raytracer_tpu_torch.models import sppm
from raytracer_tpu_torch.ops import dispatch
from raytracer_tpu_torch.ops.fused_bounce import pack_tables
from raytracer_tpu_torch.scene import builtin
from raytracer_tpu_torch.scene.builder import (
    SceneBuilder, _vertex_normals, trs_matrix)
from raytracer_tpu_torch.utils.config import RenderConfig, SPPMConfig
from raytracer_tpu_torch.utils.obj import load_obj

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "benchmark"))

from reference import compare, mesh, render, sppm_mesh  # noqa: E402

CONFIG = ROOT / "benchmark" / "configs" / "cornell_bunny_800x800.json"


@pytest.fixture(autouse=True, scope="module")
def _core_share():
    """Under pytest-xdist the workers share the machine's cores: run torch
    on this worker's share of them."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, min(old, (os.cpu_count() or 1) // workers)))
    yield
    torch.set_num_threads(old)


def _config(width=800, height=800, photons=500000):
    import json
    cfg = json.loads(CONFIG.read_text())
    cfg.update(width=width, height=height)
    cfg["sppm"] = dict(cfg["sppm"], photons_per_iteration=photons)
    return cfg


@pytest.fixture(scope="module")
def ref():
    return mesh.build(_config(), ROOT)


def test_culled_hit_is_the_brute_force_hit(ref):
    """Rays from the room and from just outside the bunny's surface, some
    along an axis, towards points of the bunny's box: ``mesh.closest``
    gives ``render.closest``'s t, kind and index on every ray, and its
    barycentrics where a triangle wins (both float64, the same
    arithmetic)."""
    g = torch.Generator().manual_seed(5)
    n = 2000
    lo, hi = ref.cull.box_lo, ref.cull.box_hi
    o = torch.rand((n, 3), generator=g, dtype=torch.float64) * 555.0
    tgt = lo + torch.rand((n, 3), generator=g, dtype=torch.float64) * (hi - lo)
    o[300:600] = tgt[300:600] + 0.01
    d = tgt - o
    d[:100, 1:] = 0.0                                  # along x
    d[100:200, :2] = 0.0                               # along z
    want = render.closest(ref.sc, o, d, 1e-4)
    got = mesh.closest(ref, o, d, 1e-4)
    for a, b in zip(want[:3], got[:3]):
        assert torch.equal(a, b)
    tri = want[1] == 2
    assert int(tri.sum()) > 300
    assert torch.equal(want[3][tri], got[3][tri])
    assert torch.equal(want[4][tri], got[4][tri])


def test_reference_normals_are_the_ports():
    """``mesh.read_obj``'s area-weighted vertex normals of the bunny, which
    has no ``vn`` lines, are ``builder._vertex_normals``' of the same
    positions to 1e-6 (the port's function rounds its unit vectors to
    float32: 6e-8). From the port's own float32 positions
    (``load_obj``) they lie within 1e-5 at every triangle corner: the
    bunny's edges are ~1e-3 long at coordinates ~0.1, so float32 positions
    move a face normal by up to 2.1e-6 here."""
    path = ROOT / "data" / "mesh" / "bun315.obj"
    pos, faces, nrm = mesh.read_obj(path)
    assert faces.shape == (4968, 3) and pos.shape == (2503, 3)
    np.testing.assert_allclose(_vertex_normals(pos, faces), nrm, rtol=0,
                               atol=1e-6)
    obj = load_obj(str(path))
    assert obj.normals is None
    port = _vertex_normals(obj.positions, obj.indices)[obj.indices]
    np.testing.assert_allclose(port, nrm[faces], rtol=0, atol=1e-5)
    np.testing.assert_allclose(obj.positions[obj.indices], pos[faces],
                               rtol=1e-6, atol=1e-7)


def _parent_cornell_box():
    """``builtin.cornell_box()`` as it was written before its mesh slot
    took other meshes."""
    b = SceneBuilder()
    red = b.lambertian(b.constant_texture((0.75, 0.25, 0.25)))
    white = b.lambertian(b.constant_texture((0.75, 0.75, 0.75)))
    blue = b.lambertian(b.constant_texture((0.25, 0.25, 0.75)))
    b.add_yz_rect(0.0, 0.0, 555.0, 555.0, 555.0, red)
    b.add_yz_rect(0.0, 0.0, 555.0, 555.0, 0.0, blue)
    b.add_xz_rect(0.0, 0.0, 555.0, 555.0, 0.0, white)
    b.add_xz_rect(0.0, 0.0, 555.0, 555.0, 555.0, white)
    b.add_xy_rect(0.0, 0.0, 555.0, 555.0, 555.0, white)
    glass = b.dielectric(1.5, b.constant_texture((0.999, 0.999, 0.999)))
    b.add_sphere((140.0, 100.0, 240.0), 100.0, glass)
    mirror = b.metal(b.constant_texture((0.999, 0.999, 0.999)), 0.0)
    b.add_sphere((400.0, 100.0, 360.0), 100.0, mirror)
    b.add_xzrect_light(213.0, 227.0, 343.0, 332.0, 554.0,
                       (1.0, 1.0, 1.0), 1e6, add_geometry=True)
    m = load_obj(str(ROOT / "data" / "mesh" / "cube.obj"))
    b.add_triangles(m.positions, m.indices, white, normals=m.normals,
                    transform=trs_matrix((0.0, 0.0, 0.0), (50.0, 50.0, 50.0),
                                         (100.0, 50.0, 100.0)))
    b.add_box((300.0, 0.0, 100.0), (380.0, 100.0, 180.0), white)
    b.set_camera(look_from=(278.0, 278.0, -800.0),
                 look_at=(278.0, 278.0, 278.0), vup=(0.0, 1.0, 0.0),
                 vfov=50.0, aspect_ratio=1.0, aperture=0.0, focus_dist=10.0)
    return b.compile()


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    return [tree]


def test_default_cornell_box_is_unchanged():
    """``cornell_box()`` with no arguments: every scene field and every
    packed table bit for bit as before; the bunny's scene differs only in
    its triangles, which take the ordered walk."""
    new, old = builtin.cornell_box(), _parent_cornell_box()
    for a, b in zip(_leaves(new) + _leaves(pack_tables(new)),
                    _leaves(old) + _leaves(pack_tables(old))):
        if torch.is_tensor(a):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b
    bunny = builtin.cornell_bunny()
    assert bunny.triangles.v0.shape == (4968, 3)
    assert pack_tables(bunny).ordered and not pack_tables(new).ordered
    for field in ("spheres", "rects", "materials", "lights", "camera",
                  "bounds_min", "bounds_max"):
        for a, b in zip(_leaves(getattr(bunny, field)),
                        _leaves(getattr(new, field))):
            assert torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_cli_renders_cornell_bunny_with_sppm(tmp_path, capsys):
    out = tmp_path / "bunny.png"
    rc = cli.main(["render", "--scene", "cornell_bunny", "--integrator",
                   "sppm", "--width", "16", "--height", "16", "--spp", "1",
                   "--max-depth", "4", "--sppm-iters", "1", "--sppm-photons",
                   "2000", "--device", "cpu", "--out", str(out)])
    assert rc == 0
    assert "SPPM:" in capsys.readouterr().out
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# One port iteration (the second of a render, so the update's every branch
# runs) on the plain ordered walk against 16 replicas of the reference from
# the port's state before it, over every 4x4 block of a 24x24 image.
# Limits from 14 seeds on the CPU: the sound readings reach blocks_off 5
# and z_total 2.83; the same states with the flux doubled read blocks_off
# 71-79 and z_total 85-162. Twice the sound maxima, rounded up.
W, BLOCK, PHOTONS, REPLICAS = 24, 4, 20000, 16
LIMITS = {"blocks_off": 10, "z_total": 6.0}


def test_port_iteration_is_held_to_the_reference():
    cfg = _config(W, W, PHOTONS)
    sp = cfg["sppm"]
    scene = builtin.cornell_bunny()
    tables = dispatch.route_tables(scene, cfg["route"])
    assert tables.ordered
    rc = RenderConfig(
        width=W, height=W, samples_per_pixel=1, max_depth=50,
        t_min=cfg["t_min"], spawn_eps_rel=cfg["spawn_eps_rel"],
        intersector=cfg["route"],
        sppm=SPPMConfig(
            n_iterations=2, photons_per_iter=PHOTONS, alpha=sp["alpha"],
            k_global=sp["k_global"], k_caustic=sp["k_caustic"],
            max_photon_bounces=sp["max_photon_bounces"],
            max_camera_bounces=sp["max_camera_bounces"],
            max_photons_per_cell=sp["max_photons_per_cell"],
            query_impl=sp["query"]))
    kw = sppm.iteration_kwargs(scene, rc)
    before = sppm.sppm_iteration(scene, tables, sppm.init_state(W * W, "cpu"),
                                 3, **kw)
    after = sppm.sppm_iteration(scene, tables, before, 3, **kw)
    n_blocks = (W // BLOCK) ** 2
    pix = torch.as_tensor(compare.block_pixels(np.arange(n_blocks), W,
                                               BLOCK))

    def state(st):
        return {"flux_g": st.glob.flux[pix].double(),
                "r2_g": st.glob.radius2[pix].double(),
                "n_g": st.glob.photons[pix].double(),
                "flux_c": st.caustic.flux[pix].double(),
                "r2_c": st.caustic.radius2[pix].double(),
                "n_c": st.caustic.photons[pix].double()}

    ms = mesh.build(cfg, ROOT)
    gen = torch.Generator().manual_seed(1003)
    reps = torch.stack([compare.state_blocks(sppm_mesh.iteration(
        ms, state(before), pix, W, W, sp, cfg["t_min"], cfg["spawn_eps_rel"],
        gen), n_blocks) for _ in range(REPLICAS)])
    prog = compare.state_blocks(state(after), n_blocks)
    got = compare.state_numbers(prog[None], reps[None])
    assert all(got[k] <= LIMITS[k] for k in LIMITS), got
    # the comparison sees a wrong answer: the global flux doubled
    bad = compare.state_numbers((prog * torch.tensor(
        [1, 1, 2, 2, 2, 1, 1, 1, 1, 1.0]))[None], reps[None])
    assert all(bad[k] > LIMITS[k] for k in LIMITS), bad
