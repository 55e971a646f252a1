"""Stage timing, progress and profiling: the counterpart of
``raytracer_tpu/utils/timing.py``.

``StageTimer`` keeps the reference's Total / SPPM / RT wall-clock summary
(main.rs:57-71) with the same lines as the JAX class, plus counters
(rays traced, with Mrays/s). ``Progress`` is the live stderr line of long
renders, silent off a TTY. ``maybe_profile`` records a ``torch.profiler``
trace (CUDA activity too when the card is used) into a directory.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional


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
    import torch
    if prog.enabled and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str], device="cpu"):
    """Record a ``torch.profiler`` trace of the block into
    ``profile_dir/trace.json`` (Chrome trace format), with CUDA activity
    when ``device`` is a CUDA device; a no-op without a directory."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(profile_dir, TRACE_FILE))
