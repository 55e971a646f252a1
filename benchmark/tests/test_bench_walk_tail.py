"""``sppm.walk_tail_share`` on the tiny SPPM iteration cell on the CPU: a
traced run whose iterations take the captured measurement (forced onto
the CPU through a fake capture primitive, as the card takes it) reads
the share of iterations whose walk ran past the captured head, and a
program that counts no ``walk.tail`` gives the reader nothing to read."""

import json

import pytest

from conftest import ROOT

METRIC = "sppm.walk_tail_share"


class FakeGraph:
    """A capture primitive for the CPU: the capture records the program
    and runs it once; a replay runs it again into the captured outputs."""

    def __init__(self, device, gen):
        self.program = self.outputs = None

    def capture(self, program):
        from raytracer_tpu_torch.utils import graphs
        self.program, self.outputs = program, program()
        self.tensors = graphs.tensors(self.outputs)
        return self.outputs

    def replay(self):
        from raytracer_tpu_torch.utils import graphs
        for dst, src in zip(self.tensors, graphs.tensors(self.program())):
            if dst is not src:
                dst.copy_(src)


def graphed(monkeypatch):
    """The iteration's graphs on the CPU."""
    from raytracer_tpu_torch.models import sppm
    from raytracer_tpu_torch.utils import graphs

    monkeypatch.setattr(sppm, "photon_graph", lambda *a: True)
    monkeypatch.setattr(sppm, "PHOTON_GRAPHS",
                        graphs.GraphCache(primitive=FakeGraph))
    monkeypatch.setattr(sppm, "MEASURE_GRAPHS",
                        sppm.MeasureGraphs(primitive=FakeGraph))
    return sppm


def traced_run(tiny):
    """One traced run of the tiny "iter" cell with ``METRIC`` reported
    there too: its line."""
    import run as bench_run
    from raytracer_tpu_torch.utils import timing

    root, name = tiny("iter")
    b = json.loads((root / "BENCHMARK.json").read_text())
    for m in b["per_layer"]:
        if m["name"] == METRIC:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    with timing.recording():                  # from empty records
        pass
    return bench_run.run_cell(name, 2 ** 40 + 11, 2.0, True, "cpu",
                              root=root, data_root=ROOT)


@pytest.mark.parametrize("pinned", [None, 1], ids=["rule", "one_step"])
def test_traced_run_reads_the_tail_share(tiny, monkeypatch, pinned):
    """Every head replay of the stretch counts; with the head pinned to
    one step every iteration's walk runs past it: 100%."""
    sppm = graphed(monkeypatch)
    if pinned is not None:
        monkeypatch.setattr(sppm, "head_steps", lambda walked, depth: pinned)
    line = traced_run(tiny)
    assert line["correct"] is True, line["compared"]
    value = line["metrics"][METRIC]
    assert value["unit"] == "%" and 0.0 <= value["value"] <= 100.0
    if pinned is not None:
        assert value["value"] == 100.0
    assert sppm.MEASURE_GRAPHS.captures == 2


def test_an_eager_program_reads_none(tiny):
    """The eager measurement (the CPU's, and the parent's program on the
    card) counts no ``walk.tail``: the line leaves the metric out and the
    run stays whole."""
    line = traced_run(tiny)
    assert line["correct"] is True
    assert METRIC not in line["metrics"]
