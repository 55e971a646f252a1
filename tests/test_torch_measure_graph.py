"""The captured measurement, queries and update
(``models/sppm.py::graphed_measure_and_update``) on the CPU, through the
fake capture primitive of ``test_torch_photon_graph.py``: a head of the
measurement walk with no host read, the eager tail where a lane outlives
the head, and the queries with the update, held against the eager
``measure_and_update`` bit for bit. On the card the same caches take
``torch.cuda.CUDAGraph``."""

import pytest
import torch

from raytracer_tpu_torch.models import sppm
from raytracer_tpu_torch.models import wavefront_soa as wf
from raytracer_tpu_torch.ops import fused_bounce as fb
from raytracer_tpu_torch.utils import graphs, timing
from raytracer_tpu_torch.utils.rng import stream_generator

from test_torch_photon_graph import (
    CPU, SEED, FakeGraph, assert_same, cornell, eager, small_config,
)

W = H = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the tensors are small, and the suite's workers
    already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def box():
    """Cornell's tables, iteration kwargs and one iteration's maps."""
    scene = cornell()
    tables = fb.pack_tables(scene)
    kw = sppm.iteration_kwargs(scene, small_config())
    _dep, _spawned, grids, _state = eager(scene, tables, 0)
    return scene, tables, kw, grids


def measure(box, state, it, *, graph, monkeypatch, pixel_ids=None,
            cache=None):
    """``measure_and_update`` of iteration ``it``'s measurement stream,
    through the graphs (``cache``) or eagerly."""
    scene, tables, kw, (g_grid, c_grid) = box
    with monkeypatch.context() as m:
        if graph:
            m.setattr(sppm, "photon_graph", lambda *a: True)
            m.setattr(sppm, "MEASURE_GRAPHS", cache)
        return sppm.measure_and_update(
            scene, tables, state, g_grid, c_grid,
            stream_generator(CPU, SEED, sppm.MEASURE_STREAM, it),
            width=W, height=H,
            max_camera_bounces=kw["max_camera_bounces"],
            grid_res=kw["grid_res"], alpha=kw["alpha"],
            k_global=kw["k_global"], k_caustic=kw["k_caustic"],
            t_min=kw["t_min"], spawn_eps=kw["spawn_eps_rel"] * scene.scale,
            query_impl=kw["query_impl"], k_per_cell=kw["k_per_cell"],
            pixel_ids=pixel_ids)


def fake_cache():
    return sppm.MeasureGraphs(primitive=FakeGraph)


def test_graphed_equals_eager_from_zero_and_later_states(box, monkeypatch):
    """Three iterations from a zero state: the first walks eagerly and
    captures the queries and update, the second captures the head, the
    third replays both; each new state equals the eager one bit for bit,
    the later ones from a state with photons in it."""
    cache = fake_cache()
    state = g_state = sppm.init_state(W * H, CPU)
    for it in range(3):
        state = measure(box, state, it, graph=False, monkeypatch=monkeypatch)
        g_state = measure(box, g_state, it, graph=True,
                          monkeypatch=monkeypatch, cache=cache)
        assert_same(state[:2], g_state[:2])
        assert g_state.iteration == state.iteration == it + 1
    assert bool((state.glob.photons > 0).any())
    assert cache.captures == 2 and len(cache.steps) == 1
    (k,) = cache.steps.values()
    assert 1 <= k <= box[2]["max_camera_bounces"]


def test_returned_state_outlives_the_next_replay(box, monkeypatch):
    """The state a replay returns is the caller's own: the next replay
    leaves it as it was."""
    cache = fake_cache()
    zero = sppm.init_state(W * H, CPU)
    for it in range(2):
        measure(box, zero, it, graph=True, monkeypatch=monkeypatch,
                cache=cache)
    first = measure(box, zero, 2, graph=True, monkeypatch=monkeypatch,
                    cache=cache)
    kept = graphs.clone(first)
    measure(box, first, 3, graph=True, monkeypatch=monkeypatch, cache=cache)
    assert_same(kept[:2], first[:2])


@pytest.mark.parametrize("pinned", [None, 1], ids=["head", "tail"])
def test_tail_continues_eagerly_and_is_counted(box, monkeypatch, pinned):
    """With the head's steps pinned to 1 the walk runs past it and goes
    on eagerly: the state equals the eager one bit for bit, ``walk.tail``
    counts the iteration once, and ``walk.steps`` counts the eager walk's
    steps. Without the pin the head covers the walk: no tail, one host
    read, and ``walk.steps`` counts the head's steps."""
    if pinned is not None:
        monkeypatch.setattr(sppm, "head_steps", lambda walked, depth: pinned)
    cache = fake_cache()
    zero = sppm.init_state(W * H, CPU)
    measure(box, zero, 0, graph=True, monkeypatch=monkeypatch, cache=cache)
    with timing.recording():
        state = measure(box, zero, 1, graph=False, monkeypatch=monkeypatch)
    eager_rec = timing.recorded()
    with timing.recording():
        g_state = measure(box, zero, 1, graph=True, monkeypatch=monkeypatch,
                          cache=cache)
    rec = timing.recorded()
    assert_same(state[:2], g_state[:2])
    (k,) = cache.steps.values()
    walked = eager_rec["counters"]["walk.steps"]
    if pinned is not None:
        assert k == 1 < walked
        assert rec["counters"]["walk.tail"] == 1
        assert rec["counters"]["walk.steps"] == walked
    else:
        assert k >= walked
        assert rec["counters"]["walk.tail"] == 0
        assert rec["counters"]["walk.steps"] == k
        assert rec["spans"]["walk.sync"]["n"] == 1
    assert "walk.tail" not in eager_rec["counters"]


def test_one_capture_per_key_over_a_job_reset(box, monkeypatch):
    """Fifty iterations of a job, a state reset to zeros, and the next
    job's first: two captures (the head, the queries and update), and a
    replay in every call from the capturing one on (the head's capture
    waits for the first call's eager walk)."""
    cache = fake_cache()
    state = sppm.init_state(W * H, CPU)
    for it in range(51):
        if it == 50:
            state = sppm.init_state(W * H, CPU)
        state = measure(box, state, it, graph=True, monkeypatch=monkeypatch,
                        cache=cache)
    assert cache.captures == 2 and len(cache) == 2
    assert sorted(e.graph.replays for e in cache.entries.values()) == [50,
                                                                      51]


def test_pixel_shards_replay_on_their_own_pixels(box, monkeypatch):
    """Two shards of a 16x16 image padded to 272 pixels (the second holds
    ids past the image), as the sharded iteration serves them: one key,
    each shard's state equal to the eager one bit for bit, and the
    padding measures nothing."""
    cache = fake_cache()
    npix = W * H
    for it in range(3):
        for lo in (0, 136):
            ids = torch.arange(lo, lo + 136)
            zero = sppm.init_state(136, CPU)
            state = measure(box, zero, it, graph=False,
                            monkeypatch=monkeypatch, pixel_ids=ids)
            g_state = measure(box, zero, it, graph=True,
                              monkeypatch=monkeypatch, pixel_ids=ids,
                              cache=cache)
            assert_same(state[:2], g_state[:2])
            past = ids >= npix
            assert not bool((g_state.glob.photons[past] != 0).any())
    assert bool((ids >= npix).any())
    assert cache.captures == 2 and len(cache.steps) == 1


def test_walk_steps_match_the_eager_walk(box):
    """``measure_walk_soa`` from a head's lanes after k steps equals the
    whole walk from step 0: the steps draw the same rows."""
    scene, tables, kw, _ = box
    eps = kw["spawn_eps_rel"] * scene.scale

    def rays(gen):
        return sppm._camera_soa(scene.camera, gen, W, H, None, CPU)

    walk_kw = dict(max_depth=kw["max_camera_bounces"], t_min=kw["t_min"],
                   spawn_eps=eps)
    gen = stream_generator(CPU, SEED, sppm.MEASURE_STREAM, 0)
    whole, steps = wf.measure_walk_soa(scene, tables, gen,
                                       wf.measure_lanes(*rays(gen)),
                                       **walk_kw)
    gen = stream_generator(CPU, SEED, sppm.MEASURE_STREAM, 0)
    w = wf.measure_lanes(*rays(gen))
    w = wf.measure_step(tables, gen, w, t_min=kw["t_min"], spawn_eps=eps)
    rest, steps2 = wf.measure_walk_soa(scene, tables, gen, w, step=1,
                                       **walk_kw)
    assert steps2 == steps > 1
    assert_same(whole, rest)
