"""Tests of the benchmark's harness, at tiny sizes on the CPU: run them
with ``python -m pytest benchmark/tests`` from the repository's root.
Tests that need the card decide so inside the ``cuda`` fixture."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny versions of each kind of cell: (configuration, traffic and check
# it is cut from, their overrides, the metrics it reports that name
# their cells)
IMAGE = ["msamples_per_s", "loop.mrays_per_s", "device.idle_pct.pt"]
TINY = {
    "pt": ("scene500_800x600", "pt32", "scene500.pt32",
           {"width": 24, "height": 16},
           {"spp_per_pass": 2, "job_spp": 8, "trace_passes": 2},
           {"block": 4, "blocks": 12, "ref_spp": 64, "control_passes": 8},
           IMAGE + ["kernel.regen_roofline_pct"]),
    "nee": ("scene500_800x600", "nee2", "scene500.nee2",
            {"width": 24, "height": 16},
            {"spp_per_pass": 2, "job_spp": 8, "trace_passes": 2},
            {"block": 4, "blocks": 12, "ref_spp": 64, "control_passes": 8},
            IMAGE),
    "gather": ("cornell_800x800", "sppm_gather16", "cornell.sppm_gather16",
               {"width": 32, "height": 32},
               {"state_iterations": 3, "spp_per_pass": 4, "job_spp": 16,
                "trace_passes": 2},
               {"block": 4, "blocks": 8, "ref_spp": 64,
                "control_passes": 8}, IMAGE),
    "iter": ("cornell_800x800", "sppm_iter", "cornell.sppm_iter",
             {"width": 32, "height": 32},
             {"job_iterations": 4, "trace_passes": 2},
             {"block": 4, "blocks": 8, "replicas": 8},
             ["sppm_iters_per_s", "sppm.photon_pass_ms",
              "sppm.measure_update_ms", "device.idle_pct.sppm"]),
}
TINY_PHOTONS = 20000


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def make_root(tmp: Path, kind: str) -> tuple:
    """A checkout-like root under ``tmp``: the benchmark's directory and a
    ``BENCHMARK.json`` with one more cell, ``tiny.<kind>``, defined only by
    new files (a configuration, a traffic mix and a check) and new names
    in the metrics' ``workloads``. Returns (root, cell name)."""
    config, traffic, check, cfg_over, tr_over, ck_over, reported = \
        TINY[kind]
    bench = _json(ROOT / "BENCHMARK.json")
    src = {c["name"]: c for c in bench["configs"]}[config]
    shutil.copytree(BENCH, tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = _json(ROOT / src["file"])
    cfg.update(cfg_over)
    if "sppm" in cfg:
        cfg["sppm"] = dict(cfg["sppm"], photons_per_iteration=TINY_PHOTONS)
    name = f"tiny.{kind}"
    cfg["name"] = f"tiny_{kind}"
    (tmp / "benchmark" / "configs" / f"tiny_{kind}.json").write_text(
        json.dumps(cfg))
    tr = _json(BENCH / "traffic" / f"{traffic}.json")
    tr.update(tr_over)
    (tmp / "benchmark" / "traffic" / f"tiny_{kind}.json").write_text(
        json.dumps(tr))
    ck = _json(BENCH / "checks" / f"{check}.json")
    ck.update(ck_over)
    (tmp / "benchmark" / "checks" / f"{name}.json").write_text(
        json.dumps(ck))
    bench["configs"].append(dict(src, name=cfg["name"],
                                 file=f"benchmark/configs/tiny_{kind}.json"))
    bench["workloads"].append({"name": name, "config": cfg["name"],
                               "traffic": f"tiny_{kind}", "chips": 1,
                               "why": "a tiny cut for the CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and m["name"] in reported:
            m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp, name


@pytest.fixture
def tiny(tmp_path):
    """``tiny(kind)``: a root with the tiny cell of ``kind``."""
    def make(kind):
        return make_root(tmp_path, kind)
    return make


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
