"""Closest hit over every primitive table, with a per-ray t_min, t_max and
alive mask: the NEE shadow rays and the unfused bounce.

The port of ``raytracer_tpu/ops/pallas_intersect.py::_closest_kernel``
(reached through ``_call_kernel``/``_run``/``intersect_pallas(_full)``).
The CUDA kernel lives in ``csrc/closest.cu`` and shares its sweep with the
fused bounce (``csrc/sweep.cuh``); ``closest_hit_plain`` below is the same
function in plain PyTorch. The wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.

Tables with an ordered stage (``ops/ordered.py``) take the ordered kernel
``csrc/closest_ordered.cu``, the port of ``_closest_kernel_ordered``
(reached through ``_call_kernel_ordered``), whose plain twin is
``closest_ordered_plain``: the near-to-far superchunk walk, with the tie
rule (t, then type, then scene index) that gives the flat kernel's winner.

Motion blur: with a per-ray shutter ``time`` on moving tables, both
kernels run their motion form (the TPU kernels with ``has_time=True``;
``fused_bounce.launch_sweep`` picks the entry point), as ``fused_bounce``
describes; the NEE shadow rays carry their lane's time.

The tables are ``fused_bounce.pack_tables``'s. The TPU kernel's 28 winner
slots are not carried over (they exist because TPU gathers are slow): the
caller rebuilds the winner's attributes from the tables with (type, index,
b1, b2), as ``models/wavefront_soa.py::attrs_soa`` does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from raytracer_tpu_torch.ops.fused_bounce import (
    BounceTables, _check, _closest_plain, launch_sweep, sweep_forms,
)


class Closest(NamedTuple):
    """The winner per ray, each (N,): t (+inf on a miss), primitive type
    (int32, -1 on a miss), index in the scene's own table order (int32, -1
    on a miss) and the triangle barycentrics b1, b2 (0 for other types)."""
    t: torch.Tensor
    ty: torch.Tensor
    ix: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor


def _rows(t_min, t_max, n, dev):
    """t_min and t_max as contiguous (N,) f32 tensors on ``dev``."""
    out = []
    for name, x in (("t_min", t_min), ("t_max", t_max)):
        if not torch.is_tensor(x):
            x = torch.full((n,), float(x), device=dev)
        _check(name, x.to(torch.float32).contiguous(), dev, torch.float32,
               (n,), "closest hit")
        out.append(x.to(torch.float32).contiguous())
    return out


def _closest(t, ty, ix, b1, b2) -> Closest:
    hit = ty >= 0
    return Closest(torch.where(hit, t, torch.inf), ty,
                   torch.where(hit, ix, -1).to(torch.int32), b1, b2)


def closest_hit_plain(tab: BounceTables, o, d, t_min, t_max, alive,
                      time=None) -> Closest:
    """The closest hit in plain PyTorch (any device), over the flat
    tables: ``fused_bounce._closest_plain`` with the miss mapped to t =
    +inf, ix = -1. Same interface and outputs as ``closest_tables``."""
    return _closest(*_closest_plain(tab, o, d, t_min, alive, t_max=t_max,
                                    time=time))


def closest_ordered_plain(tab: BounceTables, o, d, t_min, t_max, alive,
                          stats=None, time=None) -> Closest:
    """The ordered closest hit in plain PyTorch (any device): each stage
    with an ordered table runs ``ordered.walk_plain`` (groups of the
    kernel's warp, its culls and stop rule), the others the flat
    scan. ``stats``, ``time``: as for ``closest_tables``."""
    return _closest(*_closest_plain(tab, o, d, t_min, alive, t_max=t_max,
                                    ordered=True, stats=stats, time=time))


# -------------------------------------------------------------- kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I,                 # o d tmin tmax alive n
             _P, _I, _P, _I, _P, _I]                 # sph rect tri + counts
_OUTS = [_P, _P, _P, _P, _P]                         # t ty ix b1 b2
_FORMS = sweep_forms("closest", "closest-hit", _ARGTYPES, _OUTS)


def _closest_cuda(tab: BounceTables, o, d, t_min, t_max, alive,
                  stats=None, time=None) -> Closest:
    dev = o.device
    n = o.shape[1]
    f32 = torch.float32
    _check("o", o, dev, f32, (3, n), "closest hit")
    _check("d", d, dev, f32, (3, n), "closest hit")
    _check("alive", alive, dev, torch.bool, (n,), "closest hit")
    tmin, tmax = _rows(t_min, t_max, n, dev)
    for name in ("sph", "rect", "tri"):
        x = getattr(tab, name)
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"closest hit: table {name} must be contiguous "
                             f"on {dev}")
    t = torch.empty((n,), dtype=f32, device=dev)
    ty = torch.empty((n,), dtype=torch.int32, device=dev)
    ix = torch.empty((n,), dtype=torch.int32, device=dev)
    b1 = torch.empty((n,), dtype=f32, device=dev)
    b2 = torch.empty((n,), dtype=f32, device=dev)
    args = [o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            alive.data_ptr(), n,
            tab.sph.data_ptr(), tab.sph.shape[0],
            tab.rect.data_ptr(), tab.rect.shape[0],
            tab.tri.data_ptr(), tab.tri.shape[0]]
    outs = [x.data_ptr() for x in (t, ty, ix, b1, b2)]
    launch_sweep(_FORMS, tab, args, n, dev, "closest hit", outs, stats, time)
    return Closest(t, ty, ix, b1, b2)


def closest_tables(tab: BounceTables, o, d, t_min, t_max, alive,
                   stats=None, time=None) -> Closest:
    """The closest hit of each ray over packed tables. ``o``/``d`` (3, N)
    f32; ``t_min`` a float or (N,) tensor; ``t_max`` a float or (N,) f32
    tensor (+inf allowed); ``alive`` (N,) bool. A hit needs t_min <= t and
    t < min(t_max, BIG) strictly; ties go to the lowest index, spheres
    before rects before triangles.

    Dead lanes miss. (In the TPU kernel they return real hits unless their
    whole ray tile is dead; callers mask them either way.) Tables with an
    ordered stage take the ordered kernel; ``stats`` (G, 2) int32 zeros,
    G = ceil(N / 32), then receives its chunk bodies per warp (spheres,
    triangles). ``time`` (N,) f32: the rays' shutter times; on moving
    tables they take the kernels' motion form.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if o.device.type == "cpu":
        if tab.ordered:
            return closest_ordered_plain(tab, o, d, t_min, t_max, alive,
                                         stats, time)
        return closest_hit_plain(tab, o, d, t_min, t_max, alive, time)
    if o.device.type != "cuda":
        raise NotImplementedError(f"closest hit: no kernel for {o.device}")
    return _closest_cuda(tab, o, d, t_min, t_max, alive, stats, time)
