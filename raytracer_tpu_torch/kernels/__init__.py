"""Builds the CUDA sources under ``csrc/`` with nvcc and loads them
(``build``), launches their entry points (``launch``) and counts the
launches by library and form (``COUNTS``)."""

from collections import Counter

from raytracer_tpu_torch.kernels.build import bind, check_launch

# The ``launch_counts`` keys: the single-form kernels, then the sweeps
# (``ops/fused_bounce.py::sweep_forms``) by form.
KEYS = (("leaf", "photon_query", "fma_rate", "photon_step")
        + tuple(k + f for k in ("bounce", "closest", "regen")
                for f in ("", "_ordered", "_motion", "_ordered_motion")))

# Kernel launches on CUDA tensors, by key. A run reads them before and
# after to show it went through the kernels; a CUDA graph's replay adds
# what its capture launched (``utils/graphs.py``).
COUNTS = Counter(dict.fromkeys(KEYS, 0))


def launch(key: str, library: str, symbol: str, argtypes, args, what: str):
    """Call entry point ``symbol`` of ``lib<library>.so`` (``argtypes``,
    the stream last) with ``args``, raise if the launch was refused
    (``what`` names the kernel), and count it under ``key``."""
    lib = bind(library, symbol, argtypes)
    check_launch(lib, getattr(lib, symbol)(*args), what)
    COUNTS[key] += 1


def launch_counts() -> dict:
    """Every kernel's launch count, by library and form."""
    return dict(COUNTS)


def launches_since(before: dict) -> dict:
    """The launches made since ``before`` (``launch_counts()``), those
    that are not 0."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def add_launches(counts: dict, times: int = 1):
    """Add ``counts`` (``launch_counts`` keys) ``times`` times to the
    launch counts."""
    for k, v in counts.items():
        COUNTS[k] += v * times


def zero_launch_counts():
    """Set every launch count to 0."""
    for k in COUNTS:
        COUNTS[k] = 0
