"""The photon step kernel's wrapper (``ops/photon_step.py``) and its
route in ``wavefront_soa.PhotonPass`` on the CPU, where no kernel runs.

Against a fake library (``kernels.bind`` replaced): the launch's library,
symbol and argument types, the pointers of the bounce's rows, the draws,
the lanes, the deposits, the counter, the scratch words and the lights,
``step``, ``B`` and the stream, one count under ``photon_step``; a null
emission draw after the spawn window. The wrapper raises on CPU buffers
and on a wrong dtype, shape or layout, or on buffers that share memory.
The route: a pass whose steps take the kernel's route (the launch
replaced by the plain twin) draws what the plain pass draws, so the two
agree bit for bit; the emission from explicit rows and the kernel's light
table equal ``emit_photons_soa``'s arithmetic; ``photon.kernel_steps``
counts the kernel's launches beside ``photon.steps``, eagerly and at each
replay of the captured pass. On the card the kernel
is held to the plain twin bit for bit (``chip_smoke.py``,
``photon_step_phase``)."""

import contextlib
import ctypes

import pytest
import torch

from raytracer_tpu_torch import kernels
from raytracer_tpu_torch.models import sppm
from raytracer_tpu_torch.models import wavefront_soa as wf
from raytracer_tpu_torch.ops import fused_bounce as fb
from raytracer_tpu_torch.ops import photon_step as ps
from raytracer_tpu_torch.ops.lights import light_cdf
from raytracer_tpu_torch.scene import builtin
from raytracer_tpu_torch.utils import graphs, timing

PHOTONS, LANES, BOUNCES = 3000, 1024, 5
STREAM = 0x5EED


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_pass(scene=None, kernel=False):
    """A pass of PHOTONS photons over LANES lanes on the CPU; ``kernel``:
    with the kernel's buffers (as on CUDA)."""
    scene = scene or builtin.cornell_box(with_mesh=True)
    pas = wf.PhotonPass(scene, fb.pack_tables(scene), PHOTONS, BOUNCES,
                        sppm.PHOTON_T_MIN, 1e-5 * scene.scale, lanes=LANES)
    if kernel:
        pas.kernel = True
        pas.light_table = ps.emission_table(pas.lights)
        pas.scratch = torch.zeros((ps.scratch_words(pas.L),),
                                  dtype=torch.int32)
    return pas


def step_inputs(pas, step=0):
    """The pass started, and step ``step``'s draws and bounce."""
    gen = torch.Generator().manual_seed(3)
    pas.start(gen)
    U = torch.rand((wf.U_TRACE_ROWS, pas.L), generator=gen)
    b = wf.bounce_step(pas.tables, U, pas.o, pas.d, pas.alive,
                       t_min=pas.t_min, spawn_eps=pas.eps)
    E = (torch.rand((ps.EMIT_ROWS, pas.L), generator=gen)
         if step < pas.window else None)
    return U, b, E


class FakeLib:
    """A ``lib<name>.so`` stand-in: records each call of its entry point
    and returns cudaSuccess."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, symbol):
        if symbol.startswith("rt_") and symbol != "rt_error_string":
            return lambda *args: self.calls.append((symbol, args)) or 0
        raise AttributeError(symbol)


@pytest.fixture
def fake(monkeypatch):
    """``kernels.launch`` bound to a fake library on a fake stream: (the
    library, the binds made)."""
    lib, binds = FakeLib(), []

    def bind(name, fn, argtypes):
        binds.append((name, fn, argtypes))
        return lib

    class Stream:
        cuda_stream = STREAM

    monkeypatch.setattr(kernels, "bind", bind)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setitem(kernels.COUNTS, "photon_step", 0)
    return lib, binds


@pytest.mark.parametrize("last", [False, True], ids=["window", "after"])
def test_launch_passes_the_buffers(fake, last):
    lib, binds = fake
    pas = make_pass(kernel=True)
    assert 0 < pas.window < pas.S == pas.window + BOUNCES
    step = pas.S - 1 if last else 0
    U, b, E = step_inputs(pas, step)
    assert (E is None) == last
    ps.launch_step(ps.step_args(pas, U, b, E, step), pas.o.device)
    assert binds == [("photon_step", "rt_photon_step", ps.ARGTYPES)]
    (symbol, args), = lib.calls
    assert symbol == "rt_photon_step" and len(args) == len(ps.ARGTYPES)
    ptr = [x.data_ptr() for x in (b.inter, b.no, b.nd, b.att, b.p, b.n, U)]
    ptr += [None if E is None else E.data_ptr()]
    ptr += [x.data_ptr() for x in (pas.o, pas.d, pas.w, pas.alive,
                                   pas.has_spec, pas.has_diff, pas.depth,
                                   pas.dep, pas.flags, pas.counter,
                                   pas.scratch, pas.light_table)]
    assert list(args[:20]) == ptr
    assert list(args[20:]) == [1, LANES, pas.S, step, BOUNCES, PHOTONS,
                               STREAM]
    assert ps.ARGTYPES[-2] is ctypes.c_longlong
    assert kernels.COUNTS["photon_step"] == 1


def test_cpu_buffers_raise():
    pas = make_pass(kernel=True)
    U, b, E = step_inputs(pas)
    with pytest.raises(ValueError, match="CUDA"):
        ps.photon_step(pas, U, b, E, 0)


@pytest.mark.parametrize("fault", [
    "U dtype", "E shape", "inter dtype", "o layout", "depth dtype",
    "dep shape", "att layout", "scratch size", "step", "shared"])
def test_bad_inputs_raise(fault):
    pas = make_pass(kernel=True)
    U, b, E = step_inputs(pas)
    step = 0
    if fault == "U dtype":
        U = U.double()
    elif fault == "E shape":
        E = E[:6]
    elif fault == "inter dtype":
        b = b._replace(inter=b.inter.long())
    elif fault == "o layout":
        pas.o = pas.o.T.contiguous().T
    elif fault == "depth dtype":
        pas.depth = pas.depth.long()
    elif fault == "dep shape":
        pas.dep = pas.dep[:, :-1]
    elif fault == "att layout":
        b = b._replace(att=b.att.T.contiguous().T)
    elif fault == "scratch size":
        pas.scratch = pas.scratch[:-1]
    elif fault == "step":
        step = pas.S
    else:
        b = b._replace(no=pas.o)
    with pytest.raises(ValueError):
        ps.step_args(pas, U, b, E, step)


def run(pas, seed):
    gen = torch.Generator().manual_seed(seed)
    pas.run(gen)
    return pas, gen.get_state()


def test_kernel_route_draws_as_the_plain_pass(monkeypatch):
    """A pass through the kernel's route (the launch replaced by the
    plain twin on the draws the route hands it) equals the plain pass bit
    for bit, and the launch gets the emission's draw inside the window
    only."""
    seen = []

    def launch(pas, U, b, E, step):
        seen.append((step, E is None))
        pas._step_plain(U, b, E, step)

    monkeypatch.setattr(ps, "photon_step", launch)
    plain, plain_state = run(make_pass(), 9)
    routed, routed_state = run(make_pass(kernel=True), 9)
    assert seen == [(s, s >= routed.window) for s in range(routed.S)]
    assert torch.equal(plain_state, routed_state)
    for name in ("dep", "flags", "counter", "o", "d", "w", "alive",
                 "has_spec", "has_diff", "depth"):
        assert torch.equal(getattr(plain, name), getattr(routed, name)), name
    assert int(routed.counter) == PHOTONS


def lit_scene():
    """A sphere light and a rect light: both emission forms and a pick."""
    scene = builtin.cornell_box(with_mesh=False)
    sph = builtin.textured_spheres(800 / 600).lights
    return scene._replace(lights=type(sph)(
        *(torch.cat([a, b]) for a, b in zip(scene.lights, sph))))


def test_emission_from_rows_equals_the_draw():
    lights = lit_scene().lights
    a = wf.emit_photons_soa(lights, torch.Generator().manual_seed(4), 500)
    U = torch.rand((ps.EMIT_ROWS, 500),
                   generator=torch.Generator().manual_seed(4))
    b = wf.emit_from(lights, U)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_emission_table_rows():
    lights = lit_scene().lights
    t = ps.emission_table(lights)
    n = lights.kind.shape[0]
    assert t.shape == (n, ps.LIGHT_W) and t.is_contiguous() and n >= 2
    assert torch.equal(t[:, 0:3], lights.p0)
    assert torch.equal(t[:, 3:6], lights.p1)
    assert torch.equal(t[:, 6], lights.r0)
    assert torch.equal(t[:, 7:10], lights.flux * lights.scale[:, None])
    assert t[:, 10].tolist() == [float(k == 0) for k in lights.kind.tolist()]
    assert torch.equal(t[:, 11], light_cdf(lights))
    assert 0 < float(t[0, 11]) < 1 and float(t[-1, 11]) == 1.0


@pytest.mark.parametrize("launches,kernel_steps", [
    ({}, 0), ({"photon_step": 20, "bounce": 20}, 20)], ids=["cpu", "cuda"])
def test_kernel_steps_count_beside_the_steps(launches, kernel_steps):
    with timing.recording():
        wf.count_pass(20, LANES)
        wf.count_kernel_steps(launches)
    counters = timing.recorded()["counters"]
    assert counters["photon.steps"] == 20
    assert counters["photon.kernel_steps"] == kernel_steps


class Replayed:
    """A CPU capture primitive: the capture runs the program once (the
    wrappers count its launches, as in a real capture); a replay runs it
    again and counts none, the cache adding the capture's."""

    def __init__(self, device, gen):
        self.program = None

    def capture(self, program):
        self.program = program
        return program()

    def replay(self):
        before = kernels.COUNTS.copy()
        self.program()
        kernels.COUNTS.subtract(kernels.COUNTS - before)


@pytest.mark.parametrize("launched", [True, False],
                         ids=["launched", "skipped"])
@pytest.mark.parametrize("way", ["eager", "graph"])
def test_kernel_steps_are_the_launches(monkeypatch, way, launched):
    """A pass on the kernel's route counts as kernel steps the step
    kernel's launches, eagerly and at every replay: all its steps where
    each step launched, none where the launch was skipped (the stand-in
    runs the plain twin without a launch)."""
    def launch(pas, U, b, E, step):
        kernels.COUNTS["photon_step"] += launched
        pas._step_plain(U, b, E, step)

    monkeypatch.setattr(wf, "step_kernel", lambda device: True)
    monkeypatch.setattr(ps, "photon_step", launch)
    monkeypatch.setitem(kernels.COUNTS, "photon_step", 0)
    scene = builtin.cornell_box(with_mesh=True)
    tables = fb.pack_tables(scene)
    eps = 1e-5 * scene.scale
    steps = wf.spawn_window(PHOTONS, LANES) + BOUNCES
    monkeypatch.setattr(wf, "PHOTON_LANES", LANES)
    monkeypatch.setattr(wf, "PHOTON_LANES_MAX", LANES)
    cache = graphs.GraphCache(primitive=Replayed)
    for it in range(2):
        gen = torch.Generator().manual_seed(it)
        with timing.recording():
            if way == "eager":
                wf.trace_photon_deposits_regen_soa(
                    scene, tables, gen, PHOTONS, BOUNCES, sppm.PHOTON_T_MIN,
                    eps, lanes=LANES)
            else:
                sppm.graphed_photon_pass(
                    scene, tables, gen, n_photons=PHOTONS,
                    max_photon_bounces=BOUNCES, spawn_eps=eps, cache=cache)
        counters = timing.recorded()["counters"]
        assert counters["photon.steps"] == steps
        assert counters["photon.kernel_steps"] == steps * launched
    assert cache.captures == (way == "graph")


def test_eager_pass_counts_its_kernel_steps():
    """The eager pass on the CPU counts its steps, none through the
    kernel; a device with neither route raises."""
    scene = builtin.cornell_box(with_mesh=True)
    with timing.recording():
        wf.trace_photon_deposits_regen_soa(
            scene, fb.pack_tables(scene), torch.Generator().manual_seed(1),
            PHOTONS, BOUNCES, sppm.PHOTON_T_MIN, 1e-5 * scene.scale,
            lanes=LANES)
    counters = timing.recorded()["counters"]
    steps = wf.spawn_window(PHOTONS, LANES) + BOUNCES
    assert counters["photon.steps"] == steps and steps > BOUNCES
    assert counters["photon.kernel_steps"] == 0
    with pytest.raises(NotImplementedError):
        wf.step_kernel("meta")
