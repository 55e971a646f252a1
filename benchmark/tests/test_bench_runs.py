"""Each driver runs at a tiny size on the CPU, through the plain route,
and prints one well-formed last line; the process that ran it loaded no
module of jax, jaxlib, flax or raytracer_tpu (top-level names compared
whole), and the reference alone loads none of raytracer_tpu_torch
either."""

import json
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

RUN = """
import json, sys
from pathlib import Path
sys.path[:0] = [{root!r}, {bench!r}]
import run
line = run.run_cell({name!r}, {seed}, {seconds}, {trace}, "cpu",
                    root=Path({tiny!r}), data_root=Path({root!r}))
run.emit(line)
print("LOADED " + json.dumps(sorted({{m.split(".")[0]
                                     for m in sys.modules}})),
      file=sys.stderr)
"""

REFERENCE_ALONE = """
import json, sys
sys.path[:0] = [{root!r}, {bench!r}]
import torch
from pathlib import Path
from reference import compare, render, scenes, sppm
cfg = json.loads(Path({root!r}, "benchmark/configs/scene500_800x600.json")
                 .read_text())
sc = scenes.build(dict(cfg, width=8, height=6), Path({root!r}))
render.render_pixels(sc, torch.arange(4), 8, 6, 2, torch.Generator(),
                     mode="pt", max_depth=4, t_min=1e-3, spawn_eps=1e-3)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

TOP = ("jax", "jaxlib", "flax", "raytracer_tpu")
REQUIRED = ("correct", "attempted", "failed", "metrics", "device")


def _run(tiny, kind, trace, seconds=2.0):
    root, name = tiny(kind)
    code = RUN.format(root=str(ROOT), bench=str(BENCH), name=name,
                      seed=2 ** 40 + 7, seconds=seconds, trace=trace,
                      tiny=str(root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    loaded = json.loads(out.stderr.split("LOADED ")[-1].splitlines()[0])
    return line, loaded


@pytest.mark.parametrize("kind,trace", [("pt", 0), ("pt", 1), ("nee", 0),
                                        ("gather", 0), ("iter", 1)])
def test_driver_prints_one_line(tiny, kind, trace):
    line, loaded = _run(tiny, kind, trace)
    assert all(k in line for k in REQUIRED)
    assert list(line)[-1] == "compared"
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"}
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["correct"] is True, line["compared"]
    if trace:
        assert "breakdown" in line and "busy_s" in line["device"]
    else:
        assert "setup_s" in line["metrics"]
    assert not set(loaded) & set(TOP), loaded
    assert "raytracer_tpu_torch" in loaded


def test_reference_alone_loads_no_program():
    code = REFERENCE_ALONE.format(root=str(ROOT), bench=str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (set(TOP) | {"raytracer_tpu_torch"}), loaded


def test_forbidden_names_compared_whole(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "raytracer_tpu_torch_x", object())
    assert "raytracer_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert run.forbidden_modules() == ["jaxlib"]
