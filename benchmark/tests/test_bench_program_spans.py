"""The per-layer metrics that read the program's own spans and counters
(``harness/recorder.py``), on tiny cells on the CPU: a traced run reads a
finite number for each; the regen loop's counters cover exactly the
traced stretch (its rays are those the entry returned for the stretch's
passes); an untraced run reports none of them."""

import json
import math

import pytest

from conftest import ROOT
from harness import trace as tracing

PROGRAM = {
    "pt": ["loop.dispatch_us_per_step", "loop.steps_per_pass"],
    "iter": ["sppm.host_reads_per_iter", "sppm.dispatch_ms_per_iter"],
}


def run(tiny, kind, trace, monkeypatch):
    """One run of the tiny ``kind`` cell, reporting the program's metrics
    too: (its line, the stretch's summary or None, the records)."""
    import run as bench_run
    from raytracer_tpu_torch.utils import timing

    root, name = tiny(kind)
    b = json.loads((root / "BENCHMARK.json").read_text())
    for m in b["per_layer"]:
        if m["name"] in PROGRAM[kind]:
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
    line = bench_run.run_cell(name, 2 ** 40 + 7, 2.0, trace, "cpu",
                              root=root, data_root=ROOT)
    return line, (seen[0] if seen else None), timing.recorded()


@pytest.mark.parametrize("kind", sorted(PROGRAM))
def test_traced_run_reads_the_program_metrics(tiny, kind, monkeypatch):
    line, summary, rec = run(tiny, kind, True, monkeypatch)
    assert line["correct"] is True, line["compared"]
    for name in PROGRAM[kind]:
        value = line["metrics"][name]["value"]
        assert math.isfinite(value) and value > 0, (name, value)
    if kind == "pt":
        rays = sum(p["rays"] for p in summary.passes)
        assert rec["counters"]["regen.rays"] == rays
        steps = line["metrics"]["loop.steps_per_pass"]["value"]
        assert steps * len(summary.passes) == rec["counters"]["regen.steps"]
    else:
        assert rec["spans"]["sppm.iteration"]["n"] == len(summary.passes)


@pytest.mark.parametrize("kind", sorted(PROGRAM))
def test_untraced_run_reports_none_of_them(tiny, kind, monkeypatch):
    line, summary, rec = run(tiny, kind, False, monkeypatch)
    assert summary is None
    assert not set(PROGRAM[kind]) & set(line["metrics"])
    assert rec == {"spans": {}, "counters": {}}
