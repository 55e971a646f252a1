"""The captured photon pass (``models/sppm.py::graphed_photon_pass``,
``utils/graphs.py``) on the CPU, through a fake capture primitive: its
capture records the program (and runs it, as the wrappers' counts of a
real capture do, leaving garbage in the outputs, since a real capture
executes nothing), and its replay runs the program again and writes the
results into the captured outputs, counting no launch. The graph's
buffers, its copies of the inputs, its generator state and its launch
counts are what the cache adds, and they are held here against the eager
pass bit for bit. On the card the same cache takes ``torch.cuda.
CUDAGraph`` (``chip_smoke.py`` phase 20)."""

import pytest
import torch

from raytracer_tpu_torch import kernels
from raytracer_tpu_torch.models import sppm
from raytracer_tpu_torch.models import wavefront_soa as wf
from raytracer_tpu_torch.ops import dispatch
from raytracer_tpu_torch.ops import fused_bounce as fb
from raytracer_tpu_torch.ops import photon_grid as pg
from raytracer_tpu_torch.scene import builtin
from raytracer_tpu_torch.utils import graphs, nans
from raytracer_tpu_torch.utils.config import RenderConfig, SPPMConfig
from raytracer_tpu_torch.utils.rng import stream_generator

CPU = torch.device("cpu")
SEED = 5
LANES = 1024            # a wavefront narrower than the budget: it spawns
PHOTONS, BOUNCES = 3000, 5


class FakeGraph:
    """Capture primitive for the CPU (module docstring)."""

    def __init__(self, device, gen):
        self.program, self.outputs, self.replays = None, None, 0

    def capture(self, program):
        self.program = program
        self.outputs = program()
        for t in graphs.tensors(self.outputs):
            t.fill_(True if t.dtype == torch.bool else -7)
        return self.outputs

    def replay(self):
        before = kernels.COUNTS.copy()
        out = self.program()
        kernels.COUNTS.subtract(kernels.COUNTS - before)
        for dst, src in zip(graphs.tensors(self.outputs),
                            graphs.tensors(out)):
            if dst is not src:
                dst.copy_(src)
        self.replays += 1


class Refused(FakeGraph):
    def capture(self, program):
        raise RuntimeError("capture refused")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the passes' tensors are small, and the suite's
    workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pin_lanes(monkeypatch, lanes):
    """The lane rule pinned to ``lanes`` (for budgets above it)."""
    monkeypatch.setattr(wf, "PHOTON_LANES", lanes)
    monkeypatch.setattr(wf, "PHOTON_LANES_MAX", lanes)


@pytest.fixture
def lanes(monkeypatch):
    pin_lanes(monkeypatch, LANES)
    return LANES


@pytest.fixture
def counted(monkeypatch):
    """The fused bounce on the CPU counts a launch, as its kernel
    wrapper does on the card."""
    real = wf.bounce_tables

    def bounce(*a, **k):
        kernels.COUNTS["bounce"] += 1
        return real(*a, **k)

    monkeypatch.setattr(wf, "bounce_tables", bounce)
    monkeypatch.setitem(kernels.COUNTS, "bounce", 0)


def cornell(albedo=None):
    scene = builtin.cornell_box(with_mesh=True)
    if albedo is not None:
        scene = scene._replace(textures=scene.textures._replace(
            color0=scene.textures.color0 * albedo))
    return scene


def grid_res(scene):
    return pg.choose_grid_resolution(scene.bounds_min.numpy(),
                                     scene.bounds_max.numpy(), PHOTONS,
                                     100)[0]


def photon_gen(it):
    return stream_generator(CPU, SEED, sppm.PHOTON_STREAM, it)


def eager(scene, tables, it, maps=True):
    gen = photon_gen(it)
    eps = 1e-5 * scene.scale
    dep, spawned = wf.trace_photon_deposits_regen_soa(
        scene, tables, gen, PHOTONS, BOUNCES, sppm.PHOTON_T_MIN, eps)
    grids = (sppm.build_maps(scene, dep, grid_res(scene), PHOTONS)
             if maps else None)
    return dep, spawned, grids, gen.get_state()


def graphed(scene, tables, it, cache, maps=True, n_photons=PHOTONS):
    gen = photon_gen(it)
    out = sppm.graphed_photon_pass(
        scene, tables, gen, n_photons=n_photons, max_photon_bounces=BOUNCES,
        spawn_eps=1e-5 * scene.scale,
        grid_res=grid_res(scene) if maps else None, cache=cache)
    return (*out, gen.get_state())


def assert_same(a, b):
    ta, tb = graphs.tensors(a), graphs.tensors(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("name,maps", [("cornell", True),
                                       ("cornell", False),
                                       ("field", True)],
                         ids=["maps", "pass", "ordered"])
def test_graph_matches_eager_bit_for_bit(lanes, name, maps):
    """Two iterations' streams through one captured program: deposits,
    flags, spawn count, both maps (cell_start, n_valid, the sorted
    arrays) and the generator's state after the pass equal the eager
    pass's; the second iteration only replays. "ordered": 4,096 spheres,
    whose tables take the near-to-far walk (the ordered bounce)."""
    scene = cornell() if name == "cornell" else builtin.sphere_field(4096)
    tables = fb.pack_tables(scene)
    assert tables.ordered == (name == "field")
    cache = graphs.GraphCache(primitive=FakeGraph)
    assert wf.spawn_window(PHOTONS, lanes) > 0
    for it in (0, 1):
        dep, spawned, grids, state = eager(scene, tables, it, maps)
        g_dep, g_spawned, g_grids, g_state = graphed(scene, tables, it,
                                                     cache, maps)
        assert int(spawned) == PHOTONS
        assert_same(dep, g_dep)
        assert torch.equal(spawned, g_spawned)
        assert torch.equal(state, g_state)
        if maps:
            assert_same(grids, g_grids)
            assert int(g_grids[0].n_valid) > 0
        else:
            assert g_grids is None
    entry, = cache.entries.values()
    assert cache.captures == 1 and entry.graph.replays == 2


def test_iterations_draw_their_own_photons(lanes):
    """A replay draws from its iteration's stream, not the capture's."""
    scene = cornell()
    cache = graphs.GraphCache(primitive=FakeGraph)
    tables = fb.pack_tables(scene)
    first = graphs.clone(graphed(scene, tables, 0, cache)[0])
    second = graphed(scene, tables, 1, cache)[0]
    assert not torch.equal(first.pos, second.pos)


def test_one_capture_per_key_and_bounded(lanes, monkeypatch):
    """The next call of a key replays; a new photon count, lane count,
    table layout or route (the pass alone, the pass and the maps)
    captures anew, the oldest entry dropped past the bound. Tables of the
    same layout replay on their own values."""
    scene = cornell()
    tables = fb.pack_tables(scene)
    cache = graphs.GraphCache(primitive=FakeGraph)
    graphed(scene, tables, 0, cache)
    graphed(scene, tables, 1, cache)
    assert cache.captures == 1
    graphed(scene, tables, 0, cache, n_photons=PHOTONS + 512)
    assert cache.captures == 2 and len(cache) == 2
    graphed(scene, tables, 0, cache, maps=False)
    assert cache.captures == 3 and len(cache) == graphs.MAX_GRAPHS
    pin_lanes(monkeypatch, 2 * LANES)
    graphed(scene, tables, 0, cache, maps=False)
    assert cache.captures == 4
    pin_lanes(monkeypatch, LANES)
    other = builtin.three_spheres()
    graphed(other, fb.pack_tables(other), 0, cache, maps=False)
    assert cache.captures == 5 and len(cache) == graphs.MAX_GRAPHS

    # the same layout, other values: a replay on the caller's tables
    dim = cornell(albedo=0.5)
    dim_tables = fb.pack_tables(dim)
    graphed(scene, tables, 0, cache)
    captures = cache.captures
    g_dep, *_ = graphed(dim, dim_tables, 2, cache)
    assert cache.captures == captures
    dep, *_ = eager(dim, dim_tables, 2)
    assert_same(dep, g_dep)
    # the entry holds copies, not the caller's tables
    entry = next(reversed(cache.entries.values()))
    assert entry.inputs[0].mat is not dim_tables.mat


def test_replays_count_the_eager_launches(lanes, counted):
    """The capturing call counts its warm-up step and one replay; two
    later replays count what two eager passes count."""
    scene = cornell()
    tables = fb.pack_tables(scene)
    steps = wf.spawn_window(PHOTONS, lanes) + BOUNCES
    for it in (0, 1):
        eager(scene, tables, it)
    assert kernels.COUNTS["bounce"] == 2 * steps
    cache = graphs.GraphCache(primitive=FakeGraph)
    kernels.COUNTS["bounce"] = 0
    graphed(scene, tables, 0, cache)
    assert kernels.COUNTS["bounce"] == steps + 1
    assert cache.entries[next(iter(cache.entries))].launches == {
        "bounce": steps}
    kernels.COUNTS["bounce"] = 0
    for it in (1, 2):
        graphed(scene, tables, it, cache)
    assert kernels.COUNTS["bounce"] == 2 * steps


def test_route_rule():
    """The graph serves the fused bounce on a CUDA device; the CPU, the
    "leaf" route, the unfused stage, the (N, 3) route and --debug-nans
    run eagerly. Decided from the scene, the route and the device: no
    card is touched."""
    cuda = torch.device("cuda")
    box = cornell()
    assert sppm.photon_graph(box, "pallas", cuda)
    assert not sppm.photon_graph(box, "pallas", CPU)
    assert not sppm.photon_graph(box, "leaf", cuda)
    for method in ("bruteforce", "bvh"):
        assert not sppm.photon_graph(box, method, cuda)
    assert not sppm.photon_graph(builtin.cornell_smoke(), "pallas", cuda)
    assert not sppm.photon_graph(builtin.textured_spheres(), "pallas", cuda)
    with nans.debug_nans():
        assert not sppm.photon_graph(box, "pallas", cuda)


def test_cpu_iteration_never_captures(monkeypatch):
    """On the CPU an iteration takes the eager pass and leaves the cache
    alone, and its stages are the eager ones."""
    def refuse(device, gen):
        raise AssertionError("the CPU captured")

    monkeypatch.setattr(sppm, "PHOTON_GRAPHS",
                        graphs.GraphCache(primitive=refuse))
    monkeypatch.setattr(sppm, "MEASURE_GRAPHS",
                        sppm.MeasureGraphs(primitive=refuse))
    scene = cornell()
    times = {}
    iteration(scene, times=times)
    assert len(sppm.PHOTON_GRAPHS) == len(sppm.MEASURE_GRAPHS) == 0
    assert {"photon pass", "grid build"} <= set(times)


def iteration(scene, state=None, **kw):
    kw = dict(sppm.iteration_kwargs(scene, small_config()), **kw)
    state = state or sppm.init_state(16 * 16, CPU)
    return sppm.sppm_iteration(scene, fb.pack_tables(scene), state, SEED,
                               **kw)


def small_config(iters=2):
    return RenderConfig(
        width=16, height=16, samples_per_pixel=2, spp_chunk=2, max_depth=6,
        sppm=SPPMConfig(n_iterations=iters, photons_per_iter=PHOTONS,
                        max_photon_bounces=BOUNCES, max_camera_bounces=6,
                        max_photons_per_cell=32))


def force_graph(monkeypatch, primitive=FakeGraph):
    """Send the CPU's SPPM through the graphs, as the card's is."""
    monkeypatch.setattr(sppm, "photon_graph", lambda *a: True)
    monkeypatch.setattr(sppm, "PHOTON_GRAPHS",
                        graphs.GraphCache(primitive=primitive))
    monkeypatch.setattr(sppm, "MEASURE_GRAPHS",
                        sppm.MeasureGraphs(primitive=primitive))


def test_capture_error_raises_and_nothing_runs_eagerly(lanes, monkeypatch):
    """A refused capture raises out of the iteration: the eager pass
    never runs and the cache keeps no entry."""
    force_graph(monkeypatch, Refused)

    def no_eager(*a, **k):
        raise AssertionError("the pass ran eagerly")

    monkeypatch.setattr(wf, "trace_photon_deposits_regen_soa", no_eager)
    steps = []
    real_step = wf.PhotonPass.step
    monkeypatch.setattr(wf.PhotonPass, "step",
                        lambda self, *a: steps.append(a) or
                        real_step(self, *a))
    with pytest.raises(RuntimeError, match="capture refused"):
        iteration(cornell())
    assert len(steps) == 1           # the warm-up step, before the capture
    assert len(sppm.PHOTON_GRAPHS) == 0


def test_replay_error_raises(lanes, monkeypatch):
    class Broken(FakeGraph):
        def replay(self):
            raise RuntimeError("replay failed")

    force_graph(monkeypatch, Broken)
    with pytest.raises(RuntimeError, match="replay failed"):
        iteration(cornell())


def test_graphed_iterations_and_render_equal_eager(lanes, monkeypatch):
    """Two SPPM iterations, then a render of two iterations with its
    gather, through the graph equal the eager ones bit for bit; the stage
    "photon pass" covers the grid builds."""
    scene = cornell()
    states, times = [], []
    for graph in (False, True):
        if graph:
            force_graph(monkeypatch)
        t = {}
        s = iteration(scene, times=t)
        s = iteration(scene, state=s, times=t)
        states.append(s)
        times.append(t)
    assert_same(states[0][:2], states[1][:2])
    assert "grid build" in times[0] and "grid build" not in times[1]
    assert "photon pass" in times[1]
    assert sppm.PHOTON_GRAPHS.captures == 1

    monkeypatch.undo()
    pin_lanes(monkeypatch, LANES)
    renders = []
    for graph in (False, True):
        if graph:
            force_graph(monkeypatch)
        img, rays, state = sppm.render(scene, small_config(), SEED,
                                       device=CPU)
        renders.append((img, rays, state))
    assert torch.equal(renders[0][0], renders[1][0])
    assert renders[0][1] == renders[1][1]
    assert_same(renders[0][2][:2], renders[1][2][:2])


def test_sharded_pass_replays_and_gathers_a_copy(lanes, monkeypatch):
    """The sharded iteration's pass (a one-rank mesh) replays the graph
    without the maps, and the all-gathered deposits are a copy: the next
    replay leaves them as they were."""
    from raytracer_tpu_torch.parallel import sppm as psppm
    from raytracer_tpu_torch.parallel.render import Mesh

    force_graph(monkeypatch)
    scene = cornell()
    tables = dispatch.route_tables(scene, "pallas")
    mesh = Mesh(n_px=1, n_spp=1, px_i=0, spp_i=0, device=CPU,
                spp_group=None)
    monkeypatch.setattr(psppm, "all_gather_cat", lambda x, dim: x.clone())
    kw = dict(n_photons=PHOTONS, max_photon_bounces=BOUNCES,
              spawn_eps=1e-5 * scene.scale)
    dep = sppm.trace_deposits(scene, tables, photon_gen(0), **kw)
    gathered = psppm.gather_deposits(dep, PHOTONS, mesh)
    kept = graphs.clone(gathered)
    sppm.trace_deposits(scene, tables, photon_gen(1), **kw)
    assert_same(kept, gathered)
    entry, = sppm.PHOTON_GRAPHS.entries.values()
    assert entry.outputs[2] is None
    ref, _ = wf.trace_photon_deposits_regen_soa(
        scene, tables, photon_gen(0), PHOTONS, BOUNCES, sppm.PHOTON_T_MIN,
        1e-5 * scene.scale)
    assert_same(ref, kept)


def test_layout_keys_and_copies():
    """The cache's key describes tensors by shape, dtype and device and
    every other leaf by value; ``clone`` copies every tensor and keeps
    the record types."""
    scene = cornell()
    tab = fb.pack_tables(scene)
    again = fb.pack_tables(cornell(albedo=0.5))
    assert graphs.layout(tab) == graphs.layout(again)
    assert graphs.layout(tab) != graphs.layout(
        fb.pack_tables(builtin.three_spheres()))
    assert graphs.layout((1, None)) != graphs.layout((2, None))
    copy = graphs.clone(tab)
    assert type(copy) is type(tab)
    for a, b in zip(graphs.tensors(copy), graphs.tensors(tab)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()


def test_add_launches_round_trip(monkeypatch):
    monkeypatch.setitem(kernels.COUNTS, "bounce", 3)
    before = kernels.launch_counts()
    kernels.add_launches({"bounce": 4, "photon_query": 2}, times=2)
    assert kernels.launches_since(before) == {"bounce": 8,
                                              "photon_query": 4}
    kernels.add_launches({"bounce": 4, "photon_query": 2}, times=-2)
    assert kernels.launch_counts() == before


def test_grid_res_tensor_made_once():
    a = pg.res_tensor((4, 5, 6), CPU)
    assert a is pg.res_tensor((4, 5, 6), CPU)
    assert a.tolist() == [4.0, 5.0, 6.0] and a.dtype == torch.float32


# the lane rule, at a budget with the cell's ratio of photons to lanes
# (500,000 photons on 250,880 lanes; here 64,000 on 32,768: 20 steps at
# 16 bounces, 4 of them spawning)
WIDE_PHOTONS = 64000


@pytest.mark.parametrize("n", [1, 1000, 3000, 8000, 16384])
def test_rule_runs_a_small_budget_at_once(n):
    """Up to PHOTON_LANES photons the wavefront is the whole budget, as
    before the rule: no spawn window."""
    assert wf.photon_lanes(n) == n
    assert wf.spawn_window(n, wf.photon_lanes(n)) == 0


@pytest.mark.parametrize("n", [16385, 20000, 32768])
def test_rule_keeps_the_narrow_width_up_to_twice_it(n):
    assert wf.photon_lanes(n) == wf.PHOTON_LANES == 16384


@pytest.mark.parametrize("n,lanes", [(500_000, 250_880),
                                     (-(-500_000 // 4), 63_488),
                                     (WIDE_PHOTONS, 32_768)],
                         ids=["iteration", "rank_of_four", "scaled"])
def test_rule_bounds_the_steps(n, lanes):
    """Half the budget, rounded up to 1,024 lanes: 20 steps at 16
    bounces (at most 28), for the upstream's 500,000 photons and for one
    rank's share of a four-card split (arithmetic only)."""
    assert wf.photon_lanes(n) == lanes
    assert wf.spawn_window(n, lanes) + 16 == 20


def test_rule_caps_the_width_and_the_slots():
    """Past 2 * PHOTON_LANES_MAX photons the width stays at the cap; the
    deposit slots stay under 4 n + 13 L, and under 10 n + 20,480 where the
    half rules."""
    cap = wf.PHOTON_LANES_MAX
    for n in (2 * cap, 2 * cap + 1, 10 ** 7, 10 ** 8):
        assert wf.photon_lanes(n) == cap
    for n in (16385, 32769, 65537, 100_000, 500_000, 2 * cap, 10 ** 7):
        lanes = wf.photon_lanes(n)
        assert lanes % wf.LANE_QUANTUM == 0 or lanes == n
        slots = (wf.spawn_window(n, lanes) + 16) * lanes
        assert slots <= 4 * n + 13 * lanes
        if wf.PHOTON_LANES < lanes < cap:
            assert slots <= 10 * n + 20 * wf.LANE_QUANTUM


def test_rule_spends_the_budget_exactly():
    """At the cell's ratio (64,000 photons, the rule's 32,768 lanes, 16
    bounces) the window spawns exactly the budget, so ``finish`` scales
    the deposits by exactly 1."""
    scene = cornell()
    pas = wf.PhotonPass(scene, fb.pack_tables(scene), WIDE_PHOTONS, 16,
                        sppm.PHOTON_T_MIN, 1e-5 * scene.scale)
    assert (pas.L, pas.window, pas.S) == (32768, 4, 20)
    gen = photon_gen(0)
    pas.start(gen)
    for step in range(pas.S):
        pas.step(gen, step)
    before = pas.dep.clone()
    pas.finish()
    assert int(pas.counter) == WIDE_PHOTONS
    assert torch.equal(pas.dep, before)


def test_graph_matches_eager_at_the_rules_lanes():
    """The graphed pass and maps at the rule's width (no lanes pinned)
    equal the eager pass bit for bit, on two iterations' streams."""
    scene = cornell()
    tables = fb.pack_tables(scene)
    cache = graphs.GraphCache(primitive=FakeGraph)
    res = pg.choose_grid_resolution(scene.bounds_min.numpy(),
                                    scene.bounds_max.numpy(), WIDE_PHOTONS,
                                    100)[0]
    eps = 1e-5 * scene.scale
    for it in (0, 1):
        gen = photon_gen(it)
        dep, spawned = wf.trace_photon_deposits_regen_soa(
            scene, tables, gen, WIDE_PHOTONS, BOUNCES, sppm.PHOTON_T_MIN,
            eps)
        grids = sppm.build_maps(scene, dep, res, WIDE_PHOTONS)
        g_gen = photon_gen(it)
        g_dep, g_spawned, g_grids = sppm.graphed_photon_pass(
            scene, tables, g_gen, n_photons=WIDE_PHOTONS,
            max_photon_bounces=BOUNCES, spawn_eps=eps, grid_res=res,
            cache=cache)
        assert dep.pos.shape[1] == wf.photon_lanes(WIDE_PHOTONS) * (
            4 + BOUNCES)
        assert int(spawned) == WIDE_PHOTONS
        assert_same(dep, g_dep)
        assert_same(grids, g_grids)
        assert torch.equal(spawned, g_spawned)
        assert torch.equal(gen.get_state(), g_gen.get_state())
    assert cache.captures == 1


@pytest.mark.parametrize("way", ["eager", "graph"])
def test_each_pass_counts_its_steps_and_lanes_once(lanes, way):
    """``photon.steps`` and ``photon.lanes`` gain S and L once a pass:
    an eager pass, and each replay of the captured one (the capture and
    its warm-up count nothing)."""
    from raytracer_tpu_torch.utils import timing
    scene = cornell()
    tables = fb.pack_tables(scene)
    cache = graphs.GraphCache(primitive=FakeGraph)
    steps = wf.spawn_window(PHOTONS, lanes) + BOUNCES
    with timing.recording():
        for it in (0, 1, 2):
            if way == "eager":
                eager(scene, tables, it, maps=False)
            else:
                graphed(scene, tables, it, cache, maps=False)
    counters = timing.recorded()["counters"]
    assert counters["photon.steps"] == 3 * steps
    assert counters["photon.lanes"] == 3 * lanes
    if way == "graph":
        assert cache.captures == 1 and counters["graph.replays"] == 3
