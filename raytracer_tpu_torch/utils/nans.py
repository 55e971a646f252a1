"""``--debug-nans``: the counterpart of JAX's ``jax_debug_nans``.

JAX raises ``FloatingPointError`` at the first operation that makes a
NaN. The port checks the outputs of each wavefront step (the ray state
and radiance of the path tracer's loops, the photon pass, the SPPM
measurement and gather walks) and SPPM's stat update instead, and raises
``FloatingPointError`` naming the step and the tensor. Off by default:
each check reads a flag back from the device, a sync that a normal render
does not pay.
"""

from __future__ import annotations

import contextlib

import torch

_ON = [False]


def enabled() -> bool:
    return _ON[0]


@contextlib.contextmanager
def debug_nans(on: bool = True):
    """Turn the checks on (or off) within the block."""
    old, _ON[0] = _ON[0], on
    try:
        yield
    finally:
        _ON[0] = old


def check(step: str, **tensors):
    """Raise ``FloatingPointError`` if any of ``tensors`` (None skipped)
    holds a NaN, when the checks are on."""
    if not _ON[0]:
        return
    for name, x in tensors.items():
        if x is not None and bool(torch.isnan(x).any()):
            raise FloatingPointError(f"NaN in {name} after {step}")
