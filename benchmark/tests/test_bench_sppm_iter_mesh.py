"""The ``sppm_iter_mesh`` driver and its two metrics on a tiny cut of
``cornell_bunny.sppm_iter`` on the CPU: a run through the captured
iterations (a fake capture primitive on the CPU, as the card takes them)
comes out correct and reads the walk's bodies per live warp; the ordered
bounce's roofline reads its arithmetic from a trace and the counter; and
a program whose bunny is traced one unit off comes out not correct. The
harness's look for a card is skipped."""

import json
import re
from types import SimpleNamespace

import pytest
import torch

import conftest
from conftest import ROOT
from test_bench_walk_tail import graphed

BODIES = "sppm.ordered_bodies_per_warp"
ROOF = "kernel.bounce_ordered_roofline_pct"
SEED = 2 ** 40 + 23
PHOTONS = 8000         # the plain ordered walk on the CPU is slow


@pytest.fixture
def mesh_cell(tmp_path, monkeypatch):
    """A root with the tiny cell ``tiny.mesh``, cut from
    ``cornell_bunny.sppm_iter`` as ``conftest.TINY["iter"]`` is cut from
    ``cornell.sppm_iter``."""
    monkeypatch.setitem(conftest.TINY, "mesh", (
        "cornell_bunny_800x800", "sppm_iter_mesh", "cornell_bunny.sppm_iter",
        {"width": 16, "height": 16},
        {"job_iterations": 2, "trace_passes": 2},
        {"block": 4, "blocks": 8, "replicas": 8},
        ["sppm_iters_per_s", "sppm.photon_pass_ms", "sppm.measure_update_ms",
         "device.idle_pct.sppm", BODIES, ROOF]))
    root, name = conftest.make_root(tmp_path, "mesh")
    path = root / "benchmark" / "configs" / "tiny_mesh.json"
    cfg = json.loads(path.read_text())
    cfg["sppm"]["photons_per_iteration"] = PHOTONS
    path.write_text(json.dumps(cfg))
    return root, name


def _run(root, name, trace, seconds=8.0):
    import run
    from raytracer_tpu_torch.utils import timing
    with timing.recording():                  # from empty records
        pass
    return run.run_cell(name, SEED, seconds, trace, "cpu", root=root,
                        data_root=ROOT)


def test_traced_run_reads_the_walk(mesh_cell, monkeypatch):
    """Through the iteration's graphs the cell is correct, the walk's
    bodies per live warp read above 0, and the roofline, which needs the
    kernel in a device trace, is left out."""
    sppm = graphed(monkeypatch)
    root, name = mesh_cell
    line = _run(root, name, True)
    assert line["correct"] is True, line["compared"]
    assert line["metrics"][BODIES]["value"] > 0.0
    assert line["metrics"][BODIES]["unit"] == "bodies"
    assert ROOF not in line["metrics"]
    assert sppm.MEASURE_GRAPHS.captures == 2
    assert sppm.PHOTON_GRAPHS.captures == 1


def test_roofline_arithmetic():
    """``walk_bound``'s operations (bodies x 32 lanes x 512 triangles x 38)
    over the kernel's device time, the flat kernel's rows left out."""
    from harness import registry, roofline
    from raytracer_tpu_torch.utils import timing
    reader = registry.load_module(
        ROOT / "benchmark" / "metrics" / f"{ROOF}.py", "roof_test")
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      "cornell_bunny_800x800.json").read_text())
    ops = {"void (anonymous namespace)::bounce_ordered_kernel<false>(float "
           "const*)": [0.004, 20],
           "void (anonymous namespace)::bounce_kernel<false>(float const*)":
           [1.0, 20]}
    ctx = SimpleNamespace(trace=SimpleNamespace(ops=ops, passes=[]),
                          cell=SimpleNamespace(config=cfg))
    with timing.recording():
        assert reader.read(ctx) is None            # no bodies counted
        timing.count("ordered.bodies", 1000)
        got = reader.read(ctx)
    flops = 1000 * 32 * 512 * roofline.TRI_FLOPS
    nbytes = 20 * 10 * 512 * 68
    want = 100.0 * max(flops / roofline.PEAK_FP32,
                       nbytes / roofline.PEAK_BYTES) / 0.004
    assert got == pytest.approx(want, rel=1e-12)
    assert re.search(reader.KERNEL, "x::bounce_kernel<false>") is None


def test_caustic_z_leaves_one_block_out():
    """``caustic_z_less_one``: one block whose pixels take their first
    caustic photon (count 0 -> k, r^2 0 -> the cap's) in the program and
    in no replica reads far off through every block, and within the
    replicas' spread without it; the caustic flux doubled in every block
    reads far off both ways; the global map's quantities are left to
    ``sppm_iter``'s score."""
    from harness import registry
    from reference import compare
    driver = registry.load_module(
        ROOT / "benchmark" / "drivers" / "sppm_iter_mesh.py", "mesh_z_test")
    gen = torch.Generator().manual_seed(7)
    reps = 1.0 + 0.01 * torch.randn((2, 16, 64, 10), generator=gen,
                                    dtype=torch.float64)
    prog = 1.0 + 0.01 * torch.randn((2, 64, 10), generator=gen,
                                    dtype=torch.float64)
    caus = slice(compare.GLOBAL_COLUMNS, None)
    first = prog.clone()
    first[1, 5, 5:7] += torch.tensor([13.0, 30.0], dtype=torch.float64)
    assert compare.state_numbers(first[..., caus],
                                 reps[..., caus])["z_total"] > 18
    assert driver.caustic_z_less_one(first, reps) < 6
    doubled = prog.clone()
    doubled[..., 7:] *= 2.0
    assert driver.caustic_z_less_one(doubled, reps) > 100
    glob_off = prog.clone()
    glob_off[..., :compare.GLOBAL_COLUMNS] *= 2.0
    assert driver.caustic_z_less_one(glob_off, reps) < 6


def test_a_shifted_bunny_is_not_correct(mesh_cell, monkeypatch):
    """The program traces its bunny one unit along x (its tables packed
    from shifted vertices; the scene it checks and bounds is the right
    one): not correct."""
    from raytracer_tpu_torch.ops import dispatch
    orig = dispatch.route_tables

    def shifted(scene, *a, **k):
        tri = scene.triangles
        moved = tri.v0 + torch.tensor([1.0, 0.0, 0.0], device=tri.v0.device)
        return orig(scene._replace(triangles=tri._replace(v0=moved)), *a,
                    **k)

    monkeypatch.setattr(dispatch, "route_tables", shifted)
    root, name = mesh_cell
    line = _run(root, name, False)
    assert line["correct"] is False, line["compared"]
