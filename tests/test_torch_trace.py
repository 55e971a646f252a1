"""The port's span-and-counter recorder (``raytracer_tpu_torch/utils/
timing.py``) and the spans and counters of the regen loop, the SPPM
iteration and the graph cache, on the CPU.

A span records only under ``torch.profiler`` or inside
``timing.recording()``, and there it is a host op (``cpu_op``): the
profiler projects a user annotation (``record_function``) onto the
device's timeline as busy time, so a span of that kind would hide the
card's idle time. The cases here pin the kind against a torch upgrade."""

import json
import os
import time

import pytest
import torch

from raytracer_tpu_torch.models import path_tracer, sppm
from raytracer_tpu_torch.models import wavefront_soa as wf
from raytracer_tpu_torch.ops import dispatch
from raytracer_tpu_torch.ops import fused_bounce as fb
from raytracer_tpu_torch.scene import builtin
from raytracer_tpu_torch.utils import graphs, timing
from raytracer_tpu_torch.utils.config import RenderConfig, SPPMConfig

CPU = torch.device("cpu")
W, H = 16, 8
STAGES = ("sppm.photon_pass", "sppm.grid_build", "sppm.measurement",
          "sppm.query.global", "sppm.query.caustic", "sppm.update")


@pytest.fixture(autouse=True, scope="module")
def _core_share():
    """Under pytest-xdist the workers share the machine's cores: run torch
    on this worker's share of them."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    old = torch.get_num_threads()
    torch.set_num_threads(max(1, min(old, (os.cpu_count() or 1) // workers)))
    yield
    torch.set_num_threads(old)


def nest():
    """Two spans, one inside the other, and a counter."""
    with timing.span("t.outer"):
        torch.ones(8).sum()
        with timing.span("t.inner.sync"):
            torch.ones(8).cumsum(0)
        timing.count("t.count", 3)


def profiled(fn):
    """``fn()`` under a CPU ``torch.profiler`` session: (its events, the
    exported trace's events)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    events = prof.events()
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            exported = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return events, exported


def test_off_records_nothing():
    """Off (no profiler, no ``recording()``) a span is the one shared
    no-op, a counter adds nothing, and a span entered before a profiler
    session starts leaves no event in it."""
    with timing.recording():
        pass
    assert timing.span("a") is timing.span("b")
    nest()
    assert timing.recorded() == {"spans": {}, "counters": {}}
    outer = timing.span("t.late")
    with outer:
        events, exported = profiled(lambda: torch.ones(4).sum())
    assert not [e for e in events if e.name.startswith("t.")]
    assert not [e for e in exported if e.get("name", "").startswith("t.")]
    assert "t.late" not in timing.recorded()["spans"]


def test_spans_are_host_ops_under_the_profiler():
    """Under ``torch.profiler`` each span is a host op carrying its name,
    nested in its parent; the counter counts; a ``record_function`` range
    beside them is the user annotation the spans must not be."""
    def run():
        nest()
        with torch.profiler.record_function("t.annotation"):
            pass

    events, exported = profiled(run)
    by_name = {e.name: e for e in events}
    outer, inner = by_name["t.outer"], by_name["t.inner.sync"]
    assert not outer.is_user_annotation and not inner.is_user_annotation
    assert by_name["t.annotation"].is_user_annotation
    assert inner.cpu_parent is outer
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    cats = {e["name"]: e.get("cat") for e in exported if "name" in e}
    assert cats["t.outer"] == cats["t.inner.sync"] == "cpu_op"
    assert cats["t.annotation"] == "user_annotation"
    rec = timing.recorded()
    assert rec["spans"]["t.outer"]["n"] == 1
    assert rec["counters"]["t.count"] == 3
    assert rec["counters"]["host.reads"] == 1


def test_self_time_is_duration_less_children():
    with timing.recording():
        with timing.span("t.parent"):
            time.sleep(0.01)
            for _ in range(2):
                with timing.span("t.child"):
                    time.sleep(0.005)
    spans = timing.recorded()["spans"]
    parent, child = spans["t.parent"], spans["t.child"]
    assert child["n"] == 2 and parent["n"] == 1
    assert child["self_s"] == child["s"] >= 0.01
    assert parent["self_s"] == pytest.approx(parent["s"] - child["s"],
                                             abs=1e-12)
    assert parent["self_s"] >= 0.01


def test_recording_resets_and_ends():
    with timing.recording():
        nest()
    assert timing.recorded()["spans"]["t.outer"]["n"] == 1
    with timing.recording():
        timing.count("t.other")
        assert timing.recorded() == {"spans": {},
                                     "counters": {"t.other": 1}}
    nest()                                  # off again: no change
    assert timing.recorded()["counters"] == {"t.other": 1}


def regen_case(route, monkeypatch):
    """(lanes, one call of the regen loop on ``route``: rays, steps)."""
    sc = builtin.three_spheres(W / H)
    tables = dispatch.route_tables(sc, "pallas")
    kw = dict(width=W, height=H, lanes_per_pixel=2, samples_per_lane=3,
              max_depth=6, t_min=1e-3, spawn_eps=1e-5 * sc.scale)
    gen = torch.Generator().manual_seed(7)
    if route == "eager step":
        monkeypatch.setattr(wf, "_ONE_KERNEL_STEP", False)
    if route == "gather":
        est = torch.rand((W * H, 3),
                         generator=torch.Generator().manual_seed(1))
        _, rays, steps = wf.gather_regen_soa(sc, tables, est, gen, **kw)
    else:
        _, rays, steps = wf.render_regen_soa(sc, tables, gen, **kw)
    return W * H * 2, rays, steps


@pytest.mark.parametrize("route", ["one kernel", "eager step", "gather"])
def test_regen_loop_counts_its_steps_and_rays(route, monkeypatch):
    """``regen.steps`` and ``regen.rays`` are the loop's returned steps and
    rays; ``regen.sync`` is read once a step and once more a drain level;
    each step is one ``regen.dispatch`` holding one launch (and, on the
    one-kernel route, one draw), each level one ``regen.drain``."""
    with timing.recording():
        n, rays, steps = regen_case(route, monkeypatch)
    rec = timing.recorded()
    spans, counters = rec["spans"], rec["counters"]
    levels = len(wf._drain_sizes(n))
    assert counters["regen.steps"] == steps > 0
    assert counters["regen.rays"] == rays > 0
    assert spans["regen.sync"]["n"] == steps + levels
    assert spans["regen.drain"]["n"] == levels
    assert spans["regen.setup"]["n"] == spans["regen.finish"]["n"] == 1
    assert spans["regen.dispatch"]["n"] == steps
    assert spans["regen.launch"]["n"] == steps
    assert ("regen.draw" in spans) == (route == "one kernel")
    assert counters["host.reads"] == steps + levels + (route == "one kernel")
    d = spans["regen.dispatch"]
    children = spans["regen.launch"]["s"] + spans.get(
        "regen.draw", {"s": 0.0})["s"]
    assert d["self_s"] == pytest.approx(d["s"] - children, abs=1e-9)


def tiny_sppm():
    scene = builtin.cornell_box()
    cfg = RenderConfig(
        width=W, height=H, samples_per_pixel=2, spp_chunk=2, max_depth=6,
        sppm=SPPMConfig(n_iterations=1, photons_per_iter=3000,
                        max_photon_bounces=5, max_camera_bounces=6,
                        max_photons_per_cell=32))
    return scene, fb.pack_tables(scene), sppm.iteration_kwargs(scene, cfg)


@pytest.mark.parametrize("timed", [False, True], ids=["untimed", "times"])
def test_sppm_iteration_spans_each_stage_once(timed, monkeypatch):
    """One iteration on a tiny Cornell box: the entry span and each stage
    span once, in the entry; the measurement walk's host reads are its
    steps and the one that ends it; ``times=`` keeps its keys."""
    monkeypatch.setattr(wf, "PHOTON_LANES", 1024)
    scene, tables, kw = tiny_sppm()
    times = {} if timed else None
    with timing.recording():
        sppm.sppm_iteration(scene, tables, sppm.init_state(W * H, CPU), 3,
                            times=times, **kw)
    rec = timing.recorded()
    spans, counters = rec["spans"], rec["counters"]
    assert spans["sppm.iteration"]["n"] == 1
    assert all(spans[s]["n"] == 1 for s in STAGES)
    assert sum(spans[s]["s"] for s in STAGES) <= spans["sppm.iteration"]["s"]
    steps = counters["walk.steps"]
    assert 0 < steps <= kw["max_camera_bounces"]
    assert spans["walk.sync"]["n"] in (steps, steps + 1)
    assert spans["query.sync"]["n"] > 0           # the plain query's reads
    assert counters["host.reads"] == sum(
        v["n"] for k, v in spans.items() if k.endswith(".sync"))
    if timed:
        assert set(times) == {"photon pass", "grid build", "measurement",
                              "query global", "query caustic", "update"}
        assert all(v > 0 for v in times.values())


class Replayed:
    """A capture primitive for the CPU: its replay runs the program again
    into the captured outputs."""

    def __init__(self, device, gen):
        self.program = self.outputs = None

    def capture(self, program):
        self.program = program
        self.outputs = program()
        return self.outputs

    def replay(self):
        self.outputs.copy_(self.program())


@pytest.mark.parametrize("calls", [1, 3])
def test_graph_cache_counts_captures_and_replays(calls):
    cache = graphs.GraphCache(primitive=Replayed)

    def build(inputs, gen):
        def program():
            return inputs * 2 + torch.rand(inputs.shape, generator=gen)
        return (lambda: None), program, None

    x = torch.arange(4.0)
    with timing.recording():
        for _ in range(calls):
            out = cache.run("double", x, torch.Generator().manual_seed(0),
                            build)
    rec = timing.recorded()
    assert rec["counters"]["graph.captures"] == cache.captures == 1
    assert rec["counters"]["graph.replays"] == calls
    assert rec["spans"]["graph.capture"]["n"] == 1
    assert rec["spans"]["graph.replay"]["n"] == calls
    assert torch.all(out >= x * 2)


def test_render_fn_opens_no_user_annotation():
    """A whole ``render_fn`` under the profiler: its spans are there, the
    entry first, and none of its events is a user annotation."""
    sc = builtin.three_spheres(W / H)

    def run():
        path_tracer.render_fn(
            sc, torch.Generator().manual_seed(2), width=W, height=H, spp=2,
            spp_chunk=1, max_depth=4, t_min=1e-3, spawn_eps_rel=1e-5,
            intersector="pallas", device="cpu")

    events, _ = profiled(run)
    names = {e.name for e in events}
    assert {"pt.render_fn", "regen.sync", "regen.dispatch",
            "regen.launch"} <= names
    assert not [e.name for e in events if e.is_user_annotation]
    entry = next(e for e in events if e.name == "pt.render_fn")
    assert all(entry.time_range.start <= e.time_range.start
               for e in events if e.name.startswith("regen."))


@pytest.mark.parametrize("integrator", ["pt", "sppm"])
def test_cli_profile_dir_traces_and_counts(integrator, tmp_path, capsys):
    """``--profile-dir`` writes a trace holding the port's spans as host
    ops and prints the recorder's counters with the stage summary."""
    from raytracer_tpu_torch import cli
    prof = tmp_path / "prof"
    argv = ["render", "--scene", "cornell", "--integrator", integrator,
            "--width", "8", "--height", "8", "--spp", "2", "--max-depth",
            "4", "--sppm-iters", "1", "--sppm-photons", "1000", "--device",
            "cpu", "--profile-dir", str(prof), "--out",
            str(tmp_path / "out.png")]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    rec = timing.recorded()["counters"]
    assert rec["regen.steps"] > 0 and rec["host.reads"] > 0
    assert f"regen.steps: {rec['regen.steps']:,.0f}" in out
    assert f"host.reads: {rec['host.reads']:,.0f}" in out
    entry = "pt.render_fn" if integrator == "pt" else "sppm.iteration"
    with open(prof / timing.TRACE_FILE) as f:
        cats = {e.get("cat") for e in json.load(f)["traceEvents"]
                if e.get("name") in (entry, "regen.sync")}
    assert cats == {"cpu_op"}
