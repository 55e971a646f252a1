"""``sppm.photon_steps_per_iter`` on the tiny SPPM iteration cell on the
CPU: a traced run reads the photon pass's steps an iteration (the
program's counter ``photon.steps``, one pass an iteration), and a
program that counts no photon step gives the reader nothing to read."""

import json

from conftest import ROOT
from harness import trace as tracing

METRIC = "sppm.photon_steps_per_iter"


def traced_run(tiny, monkeypatch):
    """One traced run of the tiny "iter" cell with ``METRIC`` reported
    there too: (its line, the stretch's summary)."""
    import run as bench_run
    from raytracer_tpu_torch.utils import timing

    root, name = tiny("iter")
    b = json.loads((root / "BENCHMARK.json").read_text())
    for m in b["per_layer"]:
        if m["name"] == METRIC:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    seen = []

    def profile(stretch, device):
        seen.append(real(stretch, device))
        return seen[-1]

    real = tracing.profile
    monkeypatch.setattr(tracing, "profile", profile)
    with timing.recording():                  # from empty records
        pass
    line = bench_run.run_cell(name, 2 ** 40 + 7, 2.0, True, "cpu",
                              root=root, data_root=ROOT)
    return line, seen[0]


def test_traced_run_reads_the_pass_steps(tiny, monkeypatch):
    from conftest import TINY_PHOTONS
    from raytracer_tpu_torch.models import wavefront_soa as wf

    line, summary = traced_run(tiny, monkeypatch)
    assert line["correct"] is True, line["compared"]
    bounces = json.loads((ROOT / "benchmark" / "configs" /
                          "cornell_800x800.json").read_text())[
        "sppm"]["max_photon_bounces"]
    lanes = wf.photon_lanes(TINY_PHOTONS)
    steps = wf.spawn_window(TINY_PHOTONS, lanes) + bounces
    assert line["metrics"][METRIC] == {"value": steps, "unit": "steps"}
    assert summary.passes


def test_a_program_without_the_counter_reads_none(tiny, monkeypatch):
    """The parent's program counts no ``photon.steps``: the line leaves
    the metric out and the run stays whole."""
    from raytracer_tpu_torch.models import wavefront_soa as wf

    monkeypatch.setattr(wf, "count_pass", lambda steps, lanes: None)
    line, summary = traced_run(tiny, monkeypatch)
    assert line["correct"] is True and summary.passes
    assert METRIC not in line["metrics"]
