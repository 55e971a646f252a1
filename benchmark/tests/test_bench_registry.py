"""The harness finds every cell, configuration, traffic mix and metric by
the names in BENCHMARK.json, and takes a cell defined only by new
files."""

import json

import pytest

from conftest import BENCH, ROOT, TINY, make_root
from harness import registry


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_every_cell_resolves(cell):
    c = registry.resolve(cell)
    assert c.driver().Driver
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.end_to_end + c.per_layer:
        assert callable(c.metric_reader(m["name"]).read)
    assert set(c.check["limits"])


def test_every_reader_and_config_is_named_by_the_benchmark():
    b = bench()
    assert {c["file"] for c in b["configs"]} == {
        f"benchmark/configs/{p.name}" for p in (BENCH / "configs").glob("*")}
    metrics = {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    assert metrics == {p.stem for p in (BENCH / "metrics").glob("*.py")}


def test_a_cell_of_new_files_only(tmp_path):
    root, name = make_root(tmp_path, "pt")
    # one more per-layer metric, by a new reader file and a new entry
    (root / "benchmark" / "metrics" / "loop.passes.py").write_text(
        "def read(ctx):\n    return float(len(ctx.passes))\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "loop.passes", "unit": "passes",
                           "better": "higher", "source": "program_counter",
                           "layer": "regen loop", "moves": "msamples_per_s",
                           "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    c = registry.resolve(name, root)
    assert c.config["width"] == TINY["pt"][3]["width"]
    assert "loop.passes" in {m["name"] for m in c.per_layer}
    assert c.metric_reader("loop.passes").read(
        type("Ctx", (), {"passes": [1, 2]})) == 2.0
    with pytest.raises(KeyError):
        registry.resolve("no.such.cell", root)
