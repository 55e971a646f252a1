"""``sppm.photon_kernel_share`` on the tiny SPPM iteration cell on the CPU:
a traced run whose photon steps go through the step kernel's route
(forced onto the CPU by a stand-in for the launch that runs the plain
twin on the same draws and counting a launch, as the card takes the
route) reads 100; the CPU's own plain steps, and the route with its
launch skipped, read 0; and a program that counts no
``photon.kernel_steps`` gives the reader nothing to read."""

import json

import pytest

from conftest import ROOT

METRIC = "sppm.photon_kernel_share"


def kernel_route(monkeypatch, launched: bool):
    """Every photon pass takes the kernel's route on the CPU: the launch
    replaced by the plain twin on the draws the route hands the kernel,
    counted as a launch where ``launched``."""
    from raytracer_tpu_torch import kernels
    from raytracer_tpu_torch.models import wavefront_soa as wf

    def launch(pas, U, b, E, step):
        kernels.COUNTS["photon_step"] += launched
        pas._step_plain(U, b, E, step)

    monkeypatch.setattr(wf, "step_kernel", lambda device: True)
    monkeypatch.setattr(wf.photon_step_ops, "photon_step", launch)


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
    return bench_run.run_cell(name, 2 ** 40 + 13, 2.0, True, "cpu",
                              root=root, data_root=ROOT)


@pytest.mark.parametrize("route", ["kernel", "plain", "skipped"])
def test_traced_run_reads_the_kernel_share(tiny, monkeypatch, route):
    """Every step through the kernel's route launched: 100%; the CPU's
    plain twin, or the kernel's route with the launch skipped: 0%."""
    if route != "plain":
        kernel_route(monkeypatch, launched=route == "kernel")
    line = traced_run(tiny)
    assert line["correct"] is True, line["compared"]
    assert line["metrics"][METRIC] == {
        "value": 100.0 if route == "kernel" else 0.0, "unit": "%"}


def test_a_program_without_the_counter_reads_none(tiny, monkeypatch):
    """The parent's program counts no ``photon.kernel_steps``: the line
    leaves the metric out and the run stays whole."""
    from raytracer_tpu_torch.models import wavefront_soa as wf

    monkeypatch.setattr(wf, "count_kernel_steps", lambda launches: None)
    line = traced_run(tiny)
    assert line["correct"] is True
    assert METRIC not in line["metrics"]
