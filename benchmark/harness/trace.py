"""The traced stretch: ``torch.profiler`` over a few passes after the
window, reduced to the device's busy time (the union of every device
activity's interval), time per device operation by name, and the idle
gaps labelled by what the host was doing: the benchmark's own span around
its call (``bench.<name>``) and the innermost host operation open at the
gap's middle."""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

import torch

SPAN_PREFIX = "bench."
STRETCH = SPAN_PREFIX + "stretch"
LABELLED_GAPS = 2000       # the longest gaps that get a label
TOP = 10


class Spans:
    """The benchmark's spans around its calls into the program; each is a
    ``record_function`` while the profiler runs and costs nothing else."""

    def __init__(self):
        self.active = False

    def __call__(self, name: str):
        if self.active:
            return torch.profiler.record_function(SPAN_PREFIX + name)
        return contextlib.nullcontext()


@dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    ops: dict = field(default_factory=dict)     # name -> [seconds, count]
    gaps: list = field(default_factory=list)    # [label, seconds]
    passes: list = field(default_factory=list)  # the stretch's pass records

    def top_ops(self, n: int = TOP) -> list:
        rows = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:n]
        return [[name[:160], secs] for name, (secs, _count) in rows]


def _union(intervals, lo: float, hi: float) -> tuple:
    """(covered length, uncovered gaps) of ``intervals`` clipped to [lo,
    hi]."""
    covered, gaps, cur = 0.0, [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
            covered += b - a
            cur = b
        elif b > cur:
            covered += b - cur
            cur = b
    if hi > cur:
        gaps.append((cur, hi))
    return covered, gaps


def _innermost(starts, events, t: float, pred):
    """The latest-starting event of ``events`` (sorted by start) that
    contains ``t`` and satisfies ``pred``, or None."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        e = events[i]
        if e.time_range.end >= t and pred(e):
            return e
        i -= 1
    return None


def summarize(events) -> TraceSummary:
    """Reduce ``prof.events()`` of a stretch run inside a ``STRETCH`` span."""
    cuda = torch.autograd.DeviceType.CUDA
    stretch = [e for e in events if e.name == STRETCH
               and e.device_type != cuda]
    if not stretch:
        raise RuntimeError("the trace holds no stretch span")
    st = stretch[0]
    lo, hi = st.time_range.start, st.time_range.end
    device = [e for e in events if e.device_type == cuda
              and not e.name.startswith(SPAN_PREFIX)]
    ops = {}
    for e in device:
        rec = ops.setdefault(e.name, [0.0, 0])
        rec[0] += (e.time_range.end - e.time_range.start) / 1e6
        rec[1] += 1
    busy, gaps = _union([(e.time_range.start, e.time_range.end)
                         for e in device], lo, hi)
    host = sorted((e for e in events if e.device_type != cuda
                   and e.thread == st.thread and e is not st),
                  key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    labelled = {}
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:LABELLED_GAPS]:
        mid = 0.5 * (a + b)
        span = _innermost(starts, host, mid,
                          lambda e: e.name.startswith(SPAN_PREFIX))
        op = _innermost(starts, host, mid,
                        lambda e: not e.name.startswith(SPAN_PREFIX))
        label = (f"{span.name if span else 'no span'} / "
                 f"{op.name if op else 'python'}")
        labelled[label] = labelled.get(label, 0.0) + (b - a) / 1e6
    top_gaps = sorted(labelled.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(busy / 1e6, (hi - lo) / 1e6, ops,
                        [[k, v] for k, v in top_gaps])


def profile(run_stretch, device) -> TraceSummary:
    """Run ``run_stretch()`` under ``torch.profiler`` (host and, on a CUDA
    device, the card) inside a ``STRETCH`` span that ends after a device
    synchronise, and reduce the trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(STRETCH):
            passes = run_stretch()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    summary = summarize(prof.events())
    summary.passes = passes
    return summary
