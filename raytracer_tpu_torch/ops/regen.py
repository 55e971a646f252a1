"""One step of the regeneration loop in one kernel: the bounce (closest
hit, attributes, texture, scatter) and the loop's bookkeeping (emission,
throughput, Russian roulette, the depth cap, retire and quota counting,
the camera respawn of a retired lane).

The port of ``raytracer_tpu/ops/pallas_intersect.py::_regen_kernel`` and
``_regen_kernel_ordered`` (reached through ``_call_regen`` and
``regen_step_fused``; the camera column of ``pack_camera``). The CUDA
kernels live in ``csrc/regen.cu`` and ``csrc/regen_ordered.cu`` (the
epilogue in ``csrc/regen.cuh``); ``regen_step_plain`` below is the same
function in plain PyTorch. The wrapper ``regen_step_tables`` takes the
plain version only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises.

The step works on the lane state of ``models/wavefront_soa.py``'s loop
(``_Lanes``: o, d, tput, samp, acc (3, n) f32; alive (n,) bool; depth,
done (n,) int32; px, py (n,) f32) and on the loop's (8, n) uniform draw
``U``: rows 0-2 the scatter's (unit-sphere pair, dielectric choice), 3
Russian roulette, 4-7 the respawn's (jitter x, jitter y, lens radius, lens
angle). The spawn offset is one float (JAX broadcasts it into a row of
``uni2`` for its VMEM layout only). It is the loop's step without NEE, MIS
or the SPPM gather's density estimate, as in JAX, and the step the loop
takes wherever those are off.

Motion blur (JAX ``has_time=True``): the lanes carry a shutter time
(``lanes.time`` (n,)), ``U`` gets a ninth row (``U_TIME``, JAX ``uni2``
row 9), the bounce tests the moving spheres at each lane's time, and a
lane that respawns takes the next sample's time ``time0 + U[8] (time1 -
time0)`` from the packed camera's shutter (19-20). The kernels' motion
entry points (``fused_bounce.launch_sweep``'s motion form) update the
time in place with the rest of the lane.
"""

from __future__ import annotations

import ctypes

import torch

from raytracer_tpu_torch.ops.fused_bounce import (
    TABLE_ARGTYPES, BounceTables, _check, bounce_fused_plain,
    bounce_ordered_plain, launch_sweep, sweep_forms, table_args,
)
from raytracer_tpu_torch.ops.sampling import camera_rays_soa
from raytracer_tpu_torch.scene.types import INTER_ABSORB, Camera
from raytracer_tpu_torch.utils import timing

U_ROWS = 8                       # the loop's draw per step (+1: motion)
U_RR = 3                         # Russian roulette
U_CAM = slice(4, 8)              # the respawn: jitter x, y, lens r, phi
U_TIME = 8                       # the respawn's shutter time (motion)
CAM_WIDTH = 32                   # pack_camera's length


def pack_camera(cam: Camera) -> torch.Tensor:
    """The camera as one (32,) f32 tensor on its device, the layout of
    JAX ``pack_camera``'s column: origin 0-2, u 3-5, v 6-8, lower-left
    corner 9-11, horizontal 12-14, vertical 15-17, lens radius 18, shutter
    times 19-20, zeros after."""
    parts = [cam.origin, cam.u, cam.v, cam.lower_left_corner, cam.horizontal,
             cam.vertical]
    parts += [x.reshape(1).to(cam.origin.device)
              for x in (cam.lens_radius, cam.time0, cam.time1)]
    flat = torch.cat([x.to(torch.float32) for x in parts])
    return torch.cat([flat, flat.new_zeros(CAM_WIDTH - flat.shape[0])])


def unpack_camera(cam: torch.Tensor) -> Camera:
    """The ``Camera`` of a ``pack_camera`` tensor (``w``, which no ray
    reads, comes back as zeros)."""
    return Camera(origin=cam[0:3], lower_left_corner=cam[9:12],
                  horizontal=cam[12:15], vertical=cam[15:18], u=cam[3:6],
                  v=cam[6:9], w=torch.zeros_like(cam[0:3]),
                  lens_radius=cam[18], time0=cam[19], time1=cam[20])


def regen_bookkeeping(lanes, cam: Camera, U, inter, no, nd, att, samp, *,
                      width: int, height: int, quota: int, max_depth: int,
                      rr_on: bool, rr_start: int, stop=None):
    """The loop's bookkeeping after a bounce, in plain PyTorch: the one
    copy that ``regen_step_plain`` and the loop's own step
    (``models/wavefront_soa.py::_step``) share and ``csrc/regen.cuh``
    follows op for op. From the bounce's interaction ``inter``, candidate
    ray ``no``/``nd`` and attenuation ``att``: the throughput, Russian
    roulette from depth ``rr_start`` on, the depth cap, retire and quota
    counting, and the camera respawn (``cam``, U's rows 4-7) of a lane
    that retires while ``done < quota``, with its next shutter time from U
    row 8 where the lanes carry one (``lanes.time``). ``samp`` is the
    sample radiance with this bounce's contributions already added;
    ``stop`` (optional) ends its lanes' samples at this hit. Returns
    (``lanes`` with o, d, tput, samp, acc, alive, depth, done and time
    replaced, the respawned lanes)."""
    alive = lanes.alive
    cont = alive & (inter != INTER_ABSORB)
    if stop is not None:
        cont = cont & ~stop
    tput = torch.where(cont, lanes.tput * att, lanes.tput)
    if rr_on:
        p_surv = torch.clamp(tput.amax(0), 0.05, 1.0)
        do_rr = lanes.depth >= rr_start
        survive = ~do_rr | (U[U_RR] < p_surv)
        tput = tput * torch.where(do_rr & cont & survive, 1.0 / p_surv, 1.0)
        cont = cont & survive
    depth = lanes.depth + 1
    cont = cont & (depth < max_depth)
    retire = alive & ~cont
    acc = lanes.acc + torch.where(retire, samp, 0.0)
    done = lanes.done + retire.to(torch.int32)
    regen = retire & (done < quota)
    co, cd = camera_rays_soa(cam, lanes.px, lanes.py, width, height,
                             U[U_CAM])
    time = lanes.time
    if time is not None:
        t_new = cam.time0 + U[U_TIME] * (cam.time1 - cam.time0)
        time = torch.where(regen, t_new, time)
    return lanes._replace(
        o=torch.where(regen, co, torch.where(cont, no, lanes.o)),
        d=torch.where(regen, cd, torch.where(cont, nd, lanes.d)),
        tput=torch.where(regen, 1.0, tput),
        samp=torch.where(regen, 0.0, samp), acc=acc,
        alive=(alive & cont) | regen, depth=torch.where(regen, 0, depth),
        done=done, time=time), regen


def regen_step_plain(tab: BounceTables, cam, U, eps: float, lanes, *,
                     width: int, height: int, quota: int, max_depth: int,
                     rr_on: bool, rr_start: int, t_min: float, stats=None):
    """One regeneration step in plain PyTorch (any device): the fused
    bounce's plain version (the ordered walk for tables with an ordered
    stage, adding its chunk bodies to ``stats`` as ``bounce_tables``
    does), the emission, then ``regen_bookkeeping``, so that on the CPU
    it equals the loop's own step (without NEE, MIS or a density
    estimate) bit for bit. Returns ``lanes`` with o, d, tput, samp, acc,
    alive, depth, done and time replaced."""
    n = lanes.o.shape[1]
    _motion(tab, lanes)
    uni_t = torch.cat([U[0:3], torch.full((1, n), float(eps),
                                          device=U.device)], 0)
    if tab.ordered:
        b = bounce_ordered_plain(tab, lanes.o, lanes.d, t_min, lanes.alive,
                                 uni_t, stats, lanes.time)
    else:
        b = bounce_fused_plain(tab, lanes.o, lanes.d, t_min, lanes.alive,
                               uni_t, lanes.time)
    inter, no, nd, att, emit = b[:5]
    samp = lanes.samp + torch.where(lanes.alive, lanes.tput * emit, 0.0)
    return regen_bookkeeping(
        lanes, unpack_camera(cam), U, inter, no, nd, att, samp, width=width,
        height=height, quota=quota, max_depth=max_depth, rr_on=rr_on,
        rr_start=rr_start)[0]


def _motion(tab: BounceTables, lanes) -> bool:
    """Does the step carry a shutter time? Lanes with a time need moving
    tables (a time on static tables would go stale in the kernel)."""
    if lanes.time is None:
        return False
    if tab.sph_vel is None:
        raise ValueError("regen step: the lanes carry a shutter time but the "
                         "tables have no sphere velocities")
    return True


# -------------------------------------------------------------- kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
# o d tput samp acc alive depth done px py U cam; tmin eps; n width height
# quota max_depth rr_on rr_start; the tables
_ARGTYPES = ([_P] * 12 + [ctypes.c_float] * 2 + [_I] * 7 + TABLE_ARGTYPES)
_FORMS = sweep_forms("regen", "regen", _ARGTYPES)
_WRITTEN = ("o", "d", "tput", "samp", "acc", "alive", "depth", "done")


def _regen_cuda(tab: BounceTables, cam, U, eps: float, lanes, *, width,
                height, quota, max_depth, rr_on, rr_start, t_min,
                stats=None):
    dev = lanes.o.device
    n = lanes.o.shape[1]
    f32, i32 = torch.float32, torch.int32
    motion = _motion(tab, lanes)
    want = dict(o=(f32, (3, n)), d=(f32, (3, n)), tput=(f32, (3, n)),
                samp=(f32, (3, n)), acc=(f32, (3, n)),
                alive=(torch.bool, (n,)), depth=(i32, (n,)),
                done=(i32, (n,)), px=(f32, (n,)), py=(f32, (n,)))
    if motion:
        want["time"] = (f32, (n,))
    for name, (dtype, shape) in want.items():
        _check(name, getattr(lanes, name), dev, dtype, shape, "regen step")
    _check("U", U, dev, f32, (U_ROWS + motion, n), "regen step")
    _check("cam", cam, dev, f32, (CAM_WIDTH,), "regen step")
    # the kernel updates the lanes in place, each thread its own lane:
    # safe only while no written tensor shares memory with another operand
    written = [getattr(lanes, k).untyped_storage().data_ptr()
               for k in _WRITTEN + (("time",) if motion else ())]
    read = [x.untyped_storage().data_ptr()
            for x in (lanes.px, lanes.py, U, cam)]
    if len(set(written)) < len(written) or set(written) & set(read):
        raise ValueError("regen step: the lane tensors it writes must not "
                         "share memory with each other or with px, py, U "
                         "or cam")
    args = [getattr(lanes, k).data_ptr() for k in _WRITTEN + ("px", "py")]
    args += [U.data_ptr(), cam.data_ptr(), float(t_min), float(eps), n,
             width, height, quota, max_depth, int(bool(rr_on)), rr_start,
             *table_args(tab, dev, "regen step")]
    with timing.span("regen.launch"):
        launch_sweep(_FORMS, tab, args, n, dev, "regen step", stats=stats,
                     time=lanes.time)
    return lanes


def regen_step_tables(tab: BounceTables, cam, U, eps: float, lanes, *,
                      width: int, height: int, quota: int, max_depth: int,
                      rr_on: bool, rr_start: int, t_min: float, stats=None):
    """One step of the regeneration loop over packed tables: ``cam`` from
    ``pack_camera``, ``U`` the loop's (8, n) draw (9 rows when the lanes
    carry a shutter time, on moving tables: the kernels' motion form),
    ``eps`` the spawn offset, ``lanes`` the loop's lane state (module
    docstring); a lane that retires while ``done < quota`` respawns
    through pixel (px, py) of a ``width`` x ``height`` image. Tables with
    an ordered stage take the ordered kernel; ``stats`` (G, 2) int32
    zeros, G = ceil(n / 32), then receives its chunk bodies per warp
    (spheres, triangles).

    CPU tensors take the plain version, which returns new tensors; CUDA
    tensors launch the kernel, which updates the lane tensors in place and
    returns ``lanes`` (clone them first to keep the old state)."""
    kw = dict(width=width, height=height, quota=quota, max_depth=max_depth,
              rr_on=rr_on, rr_start=rr_start, t_min=t_min, stats=stats)
    dev = lanes.o.device
    if dev.type == "cpu":
        with timing.span("regen.launch"):
            return regen_step_plain(tab, cam, U, eps, lanes, **kw)
    if dev.type != "cuda":
        raise NotImplementedError(f"regen step: no kernel for {dev}")
    return _regen_cuda(tab, cam, U, eps, lanes, **kw)
