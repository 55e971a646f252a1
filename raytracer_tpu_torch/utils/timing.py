"""Stage timing, progress and profiling: the counterpart of
``raytracer_tpu/utils/timing.py``, and the port's span-and-counter
recorder.

``StageTimer`` keeps the reference's Total / SPPM / RT wall-clock summary
(main.rs:57-71) with the same lines as the JAX class, plus counters
(rays traced, with Mrays/s). ``Progress`` is the live stderr line of long
renders, silent off a TTY. ``maybe_profile`` records a ``torch.profiler``
trace (CUDA activity too when the card is used) into a directory, with
the recorder on.

The recorder: ``span(name)`` around a step of the program and
``count(name, n)`` beside it. Both record only while a ``torch.profiler``
session runs or inside ``recording()``; otherwise a span is one shared
no-op after a flag read. A recorded span adds its host seconds, its self
seconds (less the time its child spans cover) and its count under its
name, and opens a profiler range of the host-op kind (a ``cpu_op``, never
a user annotation, which the profiler would also project onto the
device's timeline as busy time). No span synchronises the device. Every
deliberate host read of device data on the instrumented paths sits in a
span whose name ends in ``.sync``; ``recorded()`` counts those as
``host.reads``. A device counter (``count_device``) is summed on the
device while recording and read once, by ``recorded()``. Names are dotted
by layer: ``pt.``/``sppm.`` entries and stages, ``regen.``, ``walk.``,
``query.``, ``graph.``, ``ordered.``. ``Stages`` times
the SPPM iteration's stages as spans, and as host seconds after a device
synchronise when asked (``times=``).
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast


@dataclass
class StageTimer:
    stages: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    _start: float = field(default_factory=time.time)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.time() - t0

    def count(self, name: str, value: float):
        self.counters[name] = self.counters.get(name, 0.0) + float(value)

    def summary(self) -> str:
        total = time.time() - self._start
        lines = [f"Total: {total:.2f}s"]
        for name, secs in self.stages.items():
            lines.append(f"{name}: {secs:.2f}s")
        for name, v in self.counters.items():
            if name.endswith("_rays") and total > 0:
                lines.append(f"{name}: {v/1e6:.2f}M ({v/total/1e6:.2f} "
                             "Mrays/s)")
            else:
                lines.append(f"{name}: {v:,.0f}")
        return "\n".join(lines)


@dataclass
class Progress:
    """Live progress line for long renders (the indicatif::ProgressBar
    analog, camera.rs:76,124-126): one stderr line per completed unit with
    ETA and optional Mrays/s, silent when stderr is not a TTY unless
    ``force``. Callers synchronise the device for a tick only when
    ``enabled``."""
    total: int
    label: str = "render"
    force: bool = False
    _done: int = 0
    _rays: float = 0.0
    _start: float = field(default_factory=time.time)

    @property
    def enabled(self) -> bool:
        return self.force or sys.stderr.isatty()

    def tick(self, units: int = 1, rays: float = 0.0):
        self._done += units
        self._rays += float(rays)
        if not self.enabled:
            return
        elapsed = time.time() - self._start
        rate = self._done / elapsed if elapsed > 0 else 0.0
        eta = (self.total - self._done) / rate if rate > 0 else float("inf")
        msg = (f"\r{self.label}: {self._done}/{self.total} "
               f"[{elapsed:.0f}s elapsed, ETA {eta:.0f}s]")
        if self._rays:
            msg += f" {self._rays / elapsed / 1e6:.1f} Mrays/s"
        end = "\n" if self._done >= self.total else ""
        print(msg, end=end, file=sys.stderr, flush=True)


def sync_for(prog: Progress, device):
    """Wait for ``device`` if ``prog`` will print (its times are then the
    device's); a no-op otherwise, so a piped run keeps its launches
    queued."""
    if prog.enabled and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------- recorder

# The records of the process, like the profiler it follows: per span name
# [seconds, self seconds, count], per counter its sum, per device and names
# of device counters their sums on that device, and the recorded spans open
# now, innermost last.
_SPANS: Dict[str, list] = {}
_COUNTERS: Dict[str, float] = {}
_DEVICE: Dict[tuple, torch.Tensor] = {}
_OPEN: list = []
_ON = False                     # inside ``recording()``
_NOOP = contextlib.nullcontext()
SYNC = ".sync"                  # the suffix of a host read's span


class _Span:
    __slots__ = ("name", "_range", "_t0", "child")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = _RecordFunctionFast(self.name)
        self._range.__enter__()
        self.child = 0.0
        _OPEN.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        _OPEN.pop()
        if _OPEN:
            _OPEN[-1].child += dt
        rec = _SPANS.get(self.name)
        if rec is None:
            rec = _SPANS[self.name] = [0.0, 0.0, 0]
        rec[0] += dt
        rec[1] += dt - self.child
        rec[2] += 1
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager: the span ``name`` while recording, else one
    shared no-op."""
    if _ON or _profiler._is_profiler_enabled:
        return _Span(name)
    return _NOOP


def spanned(name: str):
    """Decorate a function so that each call is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n=1):
    """Add ``n`` to the counter ``name`` while recording."""
    if _ON or _profiler._is_profiler_enabled:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def count_device(names: tuple, values: torch.Tensor):
    """Add ``values``, a (len(names),) int64 tensor on its device, to the
    counters ``names`` while recording: the sum stays on the device (one
    add, in the span ``count.device``) and ``recorded()`` reads it. No
    host read here."""
    if _ON or _profiler._is_profiler_enabled:
        with span("count.device"):
            key = (tuple(names), values.device)
            acc = _DEVICE.get(key)
            if acc is None:
                _DEVICE[key] = values.detach().clone()
            else:
                acc.add_(values)


@contextlib.contextmanager
def recording():
    """Record within the block, profiler or not, from empty records."""
    global _ON
    _SPANS.clear()
    _COUNTERS.clear()
    _DEVICE.clear()
    old, _ON = _ON, True
    try:
        yield
    finally:
        _ON = old


def recorded() -> dict:
    """``{"spans": {name: {"s", "self_s", "n"}}, "counters": {name: sum}}``
    of the records; ``counters["host.reads"]`` is the count of the
    ``.sync`` spans, where there are any. The device counters' sums are
    read here (a host read of each device's sums, outside any span)."""
    spans = {k: {"s": s, "self_s": self_s, "n": n}
             for k, (s, self_s, n) in _SPANS.items()}
    counters = dict(_COUNTERS)
    for (names, _dev), acc in _DEVICE.items():
        for name, v in zip(names, acc.tolist()):
            counters[name] = counters.get(name, 0) + v
    reads = sum(v["n"] for k, v in spans.items() if k.endswith(SYNC))
    if reads:
        counters["host.reads"] = reads
    return {"spans": spans, "counters": counters}


def stage_key(name: str) -> str:
    """A stage span's key in ``Stages``' ``times``: the name past its
    first dot, dots and underscores read as spaces ("sppm.query.global"
    -> "query global")."""
    return name.split(".", 1)[1].replace(".", " ").replace("_", " ")


class Stages:
    """The stages of one SPPM iteration: ``with stage(name):`` is the span
    ``name``; with ``times`` a dict it also adds the stage's host-clock
    seconds, taken after a device synchronise, to
    ``times[stage_key(name)]``."""

    def __init__(self, times: Optional[dict], device):
        self.times, self.device = times, torch.device(device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        with span(name):
            yield
            if self.times is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                key = stage_key(name)
                self.times[key] = (self.times.get(key, 0.0)
                                   + time.perf_counter() - t0)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str], device="cpu"):
    """Record a ``torch.profiler`` trace of the block into
    ``profile_dir/trace.json`` (Chrome trace format), with CUDA activity
    when ``device`` is a CUDA device, and the recorder's records of the
    block (``recorded()``); a no-op without a directory."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with recording(), profile(activities=acts) as prof:
        yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(profile_dir, TRACE_FILE))
