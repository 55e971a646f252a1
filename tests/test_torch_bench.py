"""The port's bench (``raytracer_tpu_torch/bench.py``) on the CPU: its
line has exactly the keys of the JAX package's ``bench.py`` line (read
from the source with ``ast``), in the same order; every program runs at
a tiny size and returns positive rays and finite seconds; ``run``
composes the line from those records; the golden bands it copies accept
and reject the same images as ``tests/test_golden.py::check_against``;
and ``main`` refuses to run without a CUDA device."""

import ast
import math
import os

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import bench
from raytracer_tpu_torch.utils.config import RenderConfig, SPPMConfig
from test_golden import check_against

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(ROOT, "tests", "golden")


@pytest.fixture(autouse=True, scope="module")
def _core_share():
    """Under pytest-xdist the workers share the machine's cores: run torch
    on this worker's share of them."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, min(old, (os.cpu_count() or 1) // workers)))
    yield
    torch.set_num_threads(old)


def jax_bench_keys() -> list:
    """The keys of the dict literal assigned to ``result`` in bench.py."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets
                     if isinstance(t, ast.Name)] == ["result"]):
            return [k.value for k in node.value.keys]
    raise AssertionError("no result dict in bench.py")


def test_keys_equal_jax_bench_line():
    keys = jax_bench_keys()
    assert len(keys) == 37 and keys[:3] == ["metric", "value", "unit"]
    assert list(bench.KEYS) == keys


# each program at a tiny size on the CPU: (width, height, spp) cut from
# bench.py's, the scenes at full size but bunny_field (2 bunnies of 25)
TINY_SPPM = RenderConfig(width=16, height=16, samples_per_pixel=4,
                         sppm=SPPMConfig(n_iterations=2,
                                         photons_per_iter=2000))
PROGRAMS = {
    "scene500": lambda d: bench.scene500(d, 16, 12, 2),
    "field64k": lambda d: bench.field64k(d, width=16, height=12, spp=2),
    "field160k": lambda d: bench.field160k(d, width=16, height=12, spp=1),
    "mesh124k": lambda d: bench.mesh124k(d, 2, 16, 12, 1),
    "motion1k": lambda d: bench.motion1k(d, width=16, height=12, spp=2),
    "scene10": lambda d: bench.scene10(d, 16, 9, 2),
    "scene200": lambda d: bench.scene200(d, 16, 12, 2),
    "spp1000": lambda d: bench.spp1000(d, 16, 12, 4, 2, 2),
    "media": lambda d: bench.media(d, 16, 16, 2, 2),
    "sppm_iteration": lambda d: bench.sppm_iteration(d, 16, 16, 2000),
    "sppm_full": lambda d: bench.sppm_full(d, TINY_SPPM),
    "numeric_failures": bench.numeric_failures,
}
_RECORDS = {}


def tiny(name: str):
    """``name``'s program at its tiny size on the CPU, run once."""
    if name not in _RECORDS:
        _RECORDS[name] = PROGRAMS[name]("cpu")
    return _RECORDS[name]


def check_record(rec, rays=True):
    assert math.isfinite(rec["s"]) and rec["s"] > 0
    assert rec["launches"] == {}        # the plain versions on the CPU
    if rays:
        assert rec["rays"] > 0 and rec["finite"] and rec["mean"] > 0


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_runs_tiny_on_cpu(name):
    out = tiny(name)
    if name == "numeric_failures":
        assert out == []
    elif name == "scene500":
        assert out["best"] in ("pallas", "leaf")
        for route in ("pallas", "leaf", "rr", "depth50"):
            check_record(out[route])
        # the leaf route renders the same image from the same stream
        assert out["pallas"]["rays"] == out["leaf"]["rays"]
    elif name == "media":
        check_record(out["smoke"])
        check_record(out["cornell"])
    elif name == "sppm_iteration":
        check_record(out, rays=False)
        assert {"photon pass", "update"} <= set(out["times"])
        assert out["split_s"] > 0
    else:
        check_record(out)
    if name == "sppm_full":
        assert out["iterations"] == 2 and out["warmup_s"] > 0
        assert out["times"]["gather"] > 0 and out["split_s"] > 0


def test_run_composes_the_line(monkeypatch):
    """``run`` on the tiny records: every key, numbers finite, the
    headline the faster route's, the ratios as bench.py computes them."""
    for name in PROGRAMS:
        monkeypatch.setattr(bench, name,
                            lambda *a, _n=name, **k: tiny(_n))
    monkeypatch.setattr(bench, "card_name", lambda: "card, 700.00 W")
    result, ex = bench.run("cpu")
    assert tuple(result) == bench.KEYS
    s5 = ex["scene_500"]
    best = s5["best"]
    assert result["best_intersector"] == best
    assert result["value"] == round(
        s5[best]["rays"] / s5[best]["s"] / 1e6, 2)
    assert result["vs_baseline"] == round(
        max(s5[r]["rays"] / s5[r]["s"] for r in ("pallas", "leaf"))
        / 1e6 / 100.0, 3)
    assert result["media_tax_x"] == round(
        ex["media"]["smoke"]["s"] / ex["media"]["cornell"]["s"], 2)
    assert result["numeric_ok"] is True and result["numeric_failures"] == []
    assert result["backend"] == "cpu" and result["device"] == "card, 700.00 W"
    for k, v in result.items():
        if isinstance(v, float):
            assert math.isfinite(v) and v >= 0, k


def band_cases(name):
    """Images around the golden ``name``: itself, brighter and darker by
    3% and 12%, with per-pixel noise of three sizes, and a black image."""
    ref = np.load(os.path.join(GOLDEN, name))["img"]
    rng = np.random.default_rng(3)
    cases = [ref, ref * 1.03, ref * 0.97, ref * 1.12, ref * 0.88,
             np.zeros_like(ref)]
    for sigma in (0.05, 0.2, 0.6):
        cases.append(np.clip(np.sqrt(np.clip(ref, 0, None))
                             + rng.normal(0, sigma, ref.shape), 0,
                             None).astype(np.float32) ** 2)
    return cases


@pytest.mark.parametrize("name", ["three_spheres_32.npz",
                                  "cornell_sppm_32.npz"])
def test_golden_bands_match_check_against(name):
    verdicts = []
    for img in band_cases(name):
        try:
            check_against(name, img)
            ok = True
        except AssertionError:
            ok = False
        assert (bench.golden_failure(name, img) is None) == ok
        verdicts.append(ok)
    assert any(verdicts) and not all(verdicts)


def test_launch_counts_read_and_zero_every_wrapper(monkeypatch):
    """``kernels.launch_counts`` reads every count of ``kernels.COUNTS`` by
    library and form, ``launches_since`` the non-zero differences, and
    ``zero_launch_counts`` sets them all to 0."""
    from raytracer_tpu_torch import kernels
    monkeypatch.setitem(kernels.COUNTS, "regen_ordered_motion", 5)
    before = kernels.launch_counts()
    assert len(before) == 16 and before["regen_ordered_motion"] == 5
    monkeypatch.setitem(kernels.COUNTS, "photon_query",
                        before["photon_query"] + 2)
    assert kernels.launches_since(before) == {"photon_query": 2}
    kernels.zero_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}


def test_main_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
