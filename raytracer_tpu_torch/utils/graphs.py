"""Captured CUDA graphs of fixed-shape programs, kept in a small cache: the
port's counterpart of JAX's jit cache for the programs it replays (the
SPPM photon pass and both photon maps, ``models/sppm.py::
graphed_photon_pass``; the measurement's head and the queries with the
update, ``graphed_measure_and_update``).

An entry is keyed as a jit is: by the static arguments its caller names
and by the layout of its input tensors (each one's shape, dtype and
device; every other leaf by value), never by the tensors themselves. It
holds its own copies of the inputs, which every call refreshes before
the replay, so it keeps no caller's tensor alive, and a program of the
same key replays on another scene's tables of the same layout.

First use of a key: the program's warm-up runs eagerly (it builds the
nvcc libraries the program launches), then the program is captured and,
since a capture executes nothing, replayed at once. Later uses replay
only. Each replay returns the entry's output buffers, which the next
replay of that key overwrites. Random draws come from the entry's own
generator, registered with the graph; its state is set from the caller's
generator before every replay, so a replay draws exactly what the
program run eagerly from that generator would.

The kernel wrappers count a launch in Python (``kernels.COUNTS``), so the
capture's counts are taken back (nothing ran) and added again at every
replay: the counts of a graphed program equal those of the same program
run eagerly. ``GraphCache.replayed`` holds the last replay's.

A capture or replay error raises; nothing falls back to an eager run.
The recorder (``utils/timing.py``) sees the span ``graph.capture`` (the
warm-up, the capture and the instantiation) and ``graph.replay`` (the
input copies and the replay), and counts ``graph.captures`` and
``graph.replays``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, NamedTuple

import torch

from raytracer_tpu_torch.kernels import COUNTS
from raytracer_tpu_torch.utils import timing

MAX_GRAPHS = 2      # a render holds one graph; one more for its neighbour


def tensors(tree) -> list:
    """The tensors of a tree of tuples (NamedTuples included), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensors(x)]
    return []


def layout(tree):
    """A hashable description of ``tree``: each tensor's shape, dtype and
    device, every other leaf by value, tuples by type."""
    if isinstance(tree, torch.Tensor):
        return ("tensor", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(layout(x) for x in tree))
    return tree


def clone(tree):
    """``tree`` with every tensor copied (contiguous)."""
    if isinstance(tree, torch.Tensor):
        return tree.contiguous().clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone(x) for x in tree)
    return tree


class CudaGraph:
    """The card's capture primitive: one ``torch.cuda.CUDAGraph`` whose
    random draws come from ``gen``."""

    def __init__(self, device, gen: torch.Generator):
        self.device = torch.device(device)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(gen)

    def capture(self, program: Callable):
        with torch.cuda.device(self.device):
            with torch.cuda.graph(self.graph):
                return program()

    def replay(self):
        self.graph.replay()


class Entry(NamedTuple):
    graph: object         # the capture primitive, captured
    inputs: object        # the entry's copies of the inputs
    gen: torch.Generator  # the generator the graph draws from
    keep: object          # what the program's buffers hang on
    outputs: object       # the program's outputs, refreshed by a replay
    launches: dict        # kernel launches per replay


class GraphCache:
    """At most ``size`` captured programs, the least recently used
    dropped first. ``primitive(device, gen)`` makes a capture primitive
    (``CudaGraph`` on the card; the CPU tests pass one that records the
    program and runs it again on replay)."""

    def __init__(self, size: int = MAX_GRAPHS, primitive=CudaGraph):
        self.size, self.primitive = size, primitive
        self.entries = OrderedDict()
        self.captures = 0
        self.replayed = {}      # the last replay's kernel launches

    def __len__(self):
        return len(self.entries)

    def clear(self):
        self.entries.clear()

    def run(self, key, inputs, gen: torch.Generator, build: Callable):
        """The outputs of the program of ``key`` on ``inputs``, its draws
        from ``gen``'s state (which advances as the eager program's
        would). ``build(inputs, gen)`` -> (warm, program, keep) is called
        once per key, with the entry's own copies of the inputs and its
        generator: ``warm()`` runs eagerly before the capture,
        ``program()`` is captured and returns the outputs, ``keep`` holds
        the buffers the graph reads and writes."""
        device = tensors(inputs)[0].device
        key = (key, layout(inputs))
        entry = self.entries.pop(key, None)
        if entry is None:
            entry = self._capture(device, inputs, gen, build)
        self.entries[key] = entry
        while len(self.entries) > self.size:
            self.entries.popitem(last=False)
        with timing.span("graph.replay"):
            for dst, src in zip(tensors(entry.inputs), tensors(inputs)):
                if dst is not src:
                    dst.copy_(src)
            entry.gen.set_state(gen.get_state())
            entry.graph.replay()
        timing.count("graph.replays")
        COUNTS.update(entry.launches)
        self.replayed = entry.launches
        # the caller's generator moves on past the program's draws
        gen.set_state(entry.gen.get_state())
        return entry.outputs

    @timing.spanned("graph.capture")
    def _capture(self, device, inputs, gen, build) -> Entry:
        own = clone(inputs)
        g = torch.Generator(device=device)
        g.set_state(gen.get_state())
        warm, program, keep = build(own, g)
        warm()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        graph = self.primitive(device, g)
        before = COUNTS.copy()
        outputs = graph.capture(program)
        launches = dict(COUNTS - before)    # the positive differences
        COUNTS.subtract(launches)           # the capture ran nothing
        self.captures += 1
        timing.count("graph.captures")
        return Entry(graph, own, g, keep, outputs, launches)
