"""Path-regeneration wavefront path tracer on tensors.

The PyTorch counterpart of ``raytracer_tpu/models/wavefront_soa.py`` for
the fused-bounce main path: ``camera_rays_soa``, ``block_order``, the drain
cascade ``_drain_sizes``, ``bounce_step`` and ``render_regen_soa``. NEE,
MIS, media and motion blur are not ported yet (ROADMAP A6, A7, A9).

Lane state is kept as (3, N) rows (origin, direction, throughput, sample
radiance, accumulated radiance) and (N,) vectors (alive, depth, done), so
one tensor op updates all three components. The loop runs eagerly: a
Python ``while`` around one bounce-kernel launch plus the bookkeeping ops,
with one host sync per step for the loop condition.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.ops.fused_bounce import BounceTables, bounce_tables
from raytracer_tpu_torch.scene.types import INTER_ABSORB, Camera

TWO_PI = 6.283185307179586

# Per-step uniform rows: one (8, n) draw per step, consumed as in the JAX
# package. Rows 0-1 are the unit-sphere pair shared by the diffuse bounce
# and the metal fuzz, row 2 the dielectric reflect choice, row 3 Russian
# roulette, rows 4-7 the camera respawn (jitter x, jitter y, lens r, lens
# phi).
U_SPH1, U_SPH2, U_DIEL, U_RR = 0, 1, 2, 3
U_JX, U_JY, U_LR, U_LPHI = 4, 5, 6, 7
U_REGEN_ROWS = 8

RR_START_BOUNCE = 3

# Drain cascade: each time the live lane count falls below the next level,
# the survivors are compacted once (alive first, stable order) into a
# narrower wavefront, down to this floor.
DRAIN_MIN_LANES = 32768


class Bounce(NamedTuple):
    """One bounce's outcome, in the order ``bounce_tables`` returns it:
    interaction code (N,) and (3, N) rows of the candidate next ray
    (spawn-offset origin and scattered direction), attenuation, emission,
    hit point and shading normal. Emission and interaction are already
    miss-masked."""
    inter: torch.Tensor
    no: torch.Tensor
    nd: torch.Tensor
    att: torch.Tensor
    emit: torch.Tensor
    p: torch.Tensor
    n: torch.Tensor


def camera_rays_soa(cam: Camera, px, py, width: int, height: int, uni):
    """Thin-lens camera rays (camera.rs:57-64 with the jitter and y-flip of
    camera.rs:97-99). ``px, py`` (N,) f32 pixel coordinates; ``uni`` (4, N)
    uniform rows (jitter x, jitter y, lens radius, lens angle). Returns
    (o, d), each (3, N)."""
    u = (px + uni[0]) / (width - 1)
    v = (py + uni[1]) / (height - 1)
    t = 1.0 - v  # y axis is reverted (camera.rs:99)
    r = torch.sqrt(uni[2]) * cam.lens_radius
    phi = TWO_PI * uni[3]
    rdx = r * torch.cos(phi)
    rdy = r * torch.sin(phi)
    o = torch.stack([cam.origin[c] + cam.u[c] * rdx + cam.v[c] * rdy
                     for c in range(3)])
    d = torch.stack([cam.lower_left_corner[c] + u * cam.horizontal[c]
                     + t * cam.vertical[c] - o[c] for c in range(3)])
    return o, d


def block_order(width: int, height: int, bs: int = 16):
    """Lane -> pixel permutation putting a bs x bs pixel block into each
    group of bs*bs consecutive lanes, so neighbouring lanes trace
    neighbouring rays. Returns (perm, inv): numpy int32 arrays,
    perm[lane_slot] = pixel id."""
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    nbx = -(-width // bs)
    key_ = (((ys // bs) * nbx + (xs // bs)) * (bs * bs)
            + (ys % bs) * bs + (xs % bs))
    perm = np.argsort(key_.reshape(-1), kind="stable").astype(np.int32)
    inv = np.argsort(perm, kind="stable").astype(np.int32)
    return perm, inv


def _drain_sizes(n: int):
    """Cascade level widths: n, n/2, ..., floor (256-aligned). The
    monotonic guard matters: 256-rounding can fail to shrink near small
    floors."""
    sizes = [n]
    while sizes[-1] > DRAIN_MIN_LANES:
        nxt = max(DRAIN_MIN_LANES, -(-(sizes[-1] // 2) // 256) * 256)
        if nxt >= sizes[-1]:
            break
        sizes.append(nxt)
    return sizes


def bounce_step(tables: BounceTables, uni, o, d, alive, *, t_min: float,
                spawn_eps) -> Bounce:
    """Advance one bounce with the fused kernel: intersect + attributes +
    texture + scatter. ``uni`` holds at least the three scatter rows;
    ``spawn_eps`` is a 0-d tensor (or float) filling the kernel's fourth
    uniform row."""
    n = o.shape[1]
    eps = torch.as_tensor(spawn_eps, dtype=torch.float32, device=o.device)
    uni_t = torch.cat([uni[U_SPH1:U_DIEL + 1], eps.expand(1, n)], 0)
    return Bounce(*bounce_tables(tables, o, d, t_min, alive, uni_t))


class _Lanes(NamedTuple):
    """Per-lane state of the regeneration loop."""
    o: torch.Tensor       # (3, n) ray origin
    d: torch.Tensor       # (3, n) ray direction
    tput: torch.Tensor    # (3, n) path throughput
    samp: torch.Tensor    # (3, n) radiance of the sample in flight
    acc: torch.Tensor     # (3, n) radiance of the lane's finished samples
    alive: torch.Tensor   # (n,) bool
    depth: torch.Tensor   # (n,) int32 bounces of the sample in flight
    done: torch.Tensor    # (n,) int32 samples finished
    px: torch.Tensor      # (n,) f32 pixel x
    py: torch.Tensor      # (n,) f32 pixel y
    slot: torch.Tensor    # (n,) int64 output slot


def _step(s: _Lanes, tables, cam, gen, *, width, height, quota, max_depth,
          t_min, spawn_eps, russian_roulette):
    """One regeneration step: bounce, accumulate emission, update the
    throughput, Russian roulette, retire and respawn camera rays."""
    nl = s.o.shape[1]
    U = torch.rand((U_REGEN_ROWS, nl), generator=gen, device=s.o.device)
    b = bounce_step(tables, U, s.o, s.d, s.alive, t_min=t_min,
                    spawn_eps=spawn_eps)
    alive = s.alive
    samp = s.samp + torch.where(alive, s.tput * b.emit, 0.0)
    cont = alive & (b.inter != INTER_ABSORB)
    tput = torch.where(cont, s.tput * b.att, s.tput)
    if russian_roulette:
        p_surv = torch.clamp(tput.amax(0), 0.05, 1.0)
        do_rr = s.depth >= RR_START_BOUNCE
        survive = ~do_rr | (U[U_RR] < p_surv)
        tput = tput * torch.where(do_rr & cont & survive, 1.0 / p_surv, 1.0)
        cont = cont & survive
    depth = s.depth + 1
    cont = cont & (depth < max_depth)

    retire = alive & ~cont
    acc = s.acc + torch.where(retire, samp, 0.0)
    done = s.done + retire.to(torch.int32)
    regen = retire & (done < quota)
    co, cd = camera_rays_soa(cam, s.px, s.py, width, height,
                             U[U_JX:U_LPHI + 1])
    o = torch.where(regen, co, torch.where(cont, b.no, s.o))
    d = torch.where(regen, cd, torch.where(cont, b.nd, s.d))
    return s._replace(
        o=o, d=d, tput=torch.where(regen, 1.0, tput),
        samp=torch.where(regen, 0.0, samp), acc=acc,
        alive=(alive & cont) | regen,
        depth=torch.where(regen, 0, depth), done=done)


def render_regen_soa(scene, tables: BounceTables, gen: torch.Generator, *,
                     width: int, height: int, lanes_per_pixel: int,
                     samples_per_lane: int, max_depth: int, t_min: float,
                     spawn_eps, russian_roulette: bool = True):
    """Path-regeneration wavefront renderer. When a lane's sample retires
    (miss, absorb, RR kill or depth cap) the lane spawns its pixel's next
    sample at once. Lane l serves pixel slot l % npix for
    ``samples_per_lane`` samples, so per-pixel spp = lanes_per_pixel *
    samples_per_lane. Stragglers drain through the compaction cascade of
    ``_drain_sizes``.

    Returns ((npix, 3) radiance sum over all samples in pixel order, rays
    traced (alive lanes summed over steps, an int), loop steps)."""
    dev = tables.sph.device
    cam = scene.camera
    perm, inv = block_order(width, height)
    slots = torch.as_tensor(perm, device=dev).long()
    n_out = slots.shape[0]
    n = n_out * lanes_per_pixel
    slot_id = torch.arange(n, device=dev) % n_out
    pix = slots[slot_id]
    px = (pix % width).to(torch.float32)
    py = (pix // width).to(torch.float32)
    o0, d0 = camera_rays_soa(
        cam, px, py, width, height,
        torch.rand((4, n), generator=gen, device=dev))
    ones = torch.ones((3, n), device=dev)
    zeros = torch.zeros((3, n), device=dev)
    izero = torch.zeros((n,), dtype=torch.int32, device=dev)
    s = _Lanes(o0, d0, ones, zeros, zeros.clone(),
               torch.ones((n,), dtype=torch.bool, device=dev), izero,
               izero.clone(), px, py, slot_id)
    kw = dict(width=width, height=height, quota=samples_per_lane,
              max_depth=max_depth, t_min=t_min, spawn_eps=spawn_eps,
              russian_roulette=russian_roulette)

    rays = 0      # a Python int: exact at any count
    steps = 0
    accum = torch.zeros((3, n_out), device=dev)
    sizes = _drain_sizes(n)
    for level, floor in enumerate(sizes[1:] + [0]):
        while True:
            n_alive = int(s.alive.sum())   # the one host sync per step
            if n_alive <= floor:
                break
            rays += n_alive
            s = _step(s, tables, cam, gen, **kw)
            steps += 1
        if level == 0:
            # level 0 keeps its static lane -> slot map: a reshape-sum
            accum += s.acc.reshape(3, lanes_per_pixel, n_out).sum(1)
        else:
            accum.index_add_(1, s.slot, s.acc)
        if floor:
            # survivors first, in stable order; finished radiance stays
            # behind in ``accum``
            idx = torch.argsort((~s.alive).to(torch.int8), stable=True)[:floor]
            s = _Lanes(*(x[..., idx] for x in s))
            s = s._replace(acc=torch.zeros_like(s.acc))
    return accum.T[torch.as_tensor(inv, device=dev).long()], rays, steps
