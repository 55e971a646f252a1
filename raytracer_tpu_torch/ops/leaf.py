"""Leaf-culled sphere traversal: ``--intersector leaf``.

The port of ``raytracer_tpu/ops/pallas_bvh.py``: ``_partition_leaves``,
``build_leaf_tables`` and ``with_leaf_tables`` (host side, numpy), and
``_leaf_kernel`` (reached through ``_call_leaf_kernel``/``_run``/
``intersect_leaf(_full)``) as the CUDA kernel ``csrc/leaf.cu``, whose plain
PyTorch twin is ``leaf_closest_plain``. The wrapper takes the plain version
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.

Tables (``scene.types.LeafTables``, the port's layout): spheres with radius
> 20 x the median go to a dense "big" set; the rest are median-split on the
largest-extent axis into leaves of ``LEAF_SIZE`` spheres (every leaf full
but one), each with its tight box. The JAX package's ``kron`` one-hot
gather matrices and bf16 hi/mid split exist only because the TPU gathers
through bf16 matmuls; the kernel here reads the leaves' records from
global memory.

The walk, per ray (one thread per ray): the dense stages first (the big
spheres, then the rects, then the triangles, through the flat sweep), so
their hits bound t; then every leaf box in table order, slab-tested against
the ray's running best t, and an exact float32 test of the spheres of each
leaf that passes. A leaf is culled when its entry t exceeds the best t (the
test is inclusive, so a tie at the entry is kept). Winner rule: the flat
sweep's, by (t, then type, then scene index): a leaf sphere at the best t
wins over a rect or triangle there, and over a sphere of higher index. No
bf16 candidates and no rescue scan (:583-649): those exist only because the
TPU's candidate pass ran at 16-bit gather precision. No ``|o|^2 - 2 o.c +
csq`` expansion: the direct ``oc = o - c`` quadratic of ``sweep.cuh``
(``pallas_intersect.py:312-317`` says why).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from raytracer_tpu_torch.kernels.build import bind, check_launch
from raytracer_tpu_torch.ops import ordered as ordered_ops
from raytracer_tpu_torch.ops.closest_hit import Closest, _closest, _rows
from raytracer_tpu_torch.ops.fused_bounce import (
    BIG, BounceTables, _check, _closest_plain, _row, _sphere_tt,
)
from raytracer_tpu_torch.scene.types import (
    PRIM_SPHERE, LeafTables, Scene,
)

LEAF_SIZE = 32     # spheres per leaf (JAX LEAF_SIZE)
BIG_FACTOR = 20.0  # "big": radius > 20 x the median radius
MIN_SPHERES = 256  # with_leaf_tables' policy

# Kernel launches made by ``leaf_closest`` on CUDA tensors. A plain integer:
# a run reads it before and after to show it went through the kernel.
LAUNCHES = 0


class LeafPack(NamedTuple):
    """The leaf kernel's tables, on the scene's device: the big spheres'
    and the leaves' records as rows of the packed sphere table ((c, r^2),
    bit-equal to the flat sweep's), with their scene indices."""
    box: torch.Tensor       # (L, 6) f32 leaf boxes, widened by BOX_PAD
    sph: torch.Tensor       # (L * LEAF, 4) f32; empty slots (0,0,0,-3e38)
    orig: torch.Tensor      # (L * LEAF,) int32 scene index, -1 empty
    big: torch.Tensor       # (B, 4) f32
    big_orig: torch.Tensor  # (B,) int32


def _partition_leaves(centers: np.ndarray, leaf: int):
    """Recursive median split on the largest-extent axis; split points are
    leaf-size multiples so every leaf but one is full. Returns index
    lists."""
    out = []

    def split(idx):
        if len(idx) <= leaf:
            out.append(idx)
            return
        c = centers[idx]
        ax = int(np.argmax(c.max(0) - c.min(0)))
        order = np.argsort(c[:, ax], kind="stable")
        h = len(idx) // 2
        h = max(leaf, min(len(idx) - leaf, -(-h // leaf) * leaf))
        split(idx[order[:h]])
        split(idx[order[h:]])

    split(np.arange(centers.shape[0]))
    return out


def build_leaf_tables(scene: Scene, leaf_size: int = LEAF_SIZE,
                      big_factor: float = BIG_FACTOR) -> LeafTables:
    """The leaf tables of ``scene`` (host, numpy; CPU tensors): the JAX
    ``build_leaf_tables``'s partition, big set and float32 boxes."""
    s = scene.spheres
    centers = s.center.detach().cpu().numpy().astype(np.float64)
    radii = np.abs(s.radius.detach().cpu().numpy().astype(np.float64))
    n = radii.shape[0]
    if n == 0:
        raise ValueError("leaf tables need at least one sphere")
    big = radii > big_factor * max(np.median(radii), 1e-12)
    small_ix = np.where(~big)[0]
    big_ix = np.where(big)[0]
    leaves = _partition_leaves(centers[small_ix], leaf_size)
    aabb = np.zeros((len(leaves), 6), np.float32)
    members = np.full((len(leaves), leaf_size), -1, np.int32)
    for li, rel in enumerate(leaves):
        ix = small_ix[rel]
        aabb[li, :3] = (centers[ix] - radii[ix, None]).min(0)
        aabb[li, 3:] = (centers[ix] + radii[ix, None]).max(0)
        members[li, :len(ix)] = ix
    return LeafTables(torch.from_numpy(aabb), torch.from_numpy(members),
                      torch.from_numpy(big_ix.astype(np.int32)))


def with_leaf_tables(scene: Scene, min_spheres: int = MIN_SPHERES,
                     leaf_size: int = LEAF_SIZE) -> Scene:
    """Attach leaf tables when the scene profits from them (many spheres,
    no motion blur). No-op otherwise, and never rebuilds existing
    tables."""
    if scene.leaf is not None:
        return scene
    if scene.spheres.motion_marker.shape[0]:
        return scene
    if scene.spheres.radius.shape[0] < min_spheres:
        return scene
    lt = build_leaf_tables(scene, leaf_size=leaf_size)
    return scene._replace(leaf=lt.to(scene.spheres.center.device))


def pack_leaf(lt: LeafTables, sph: torch.Tensor) -> LeafPack:
    """The kernel's tables from the scene's leaf tables and its packed
    sphere table ``sph`` (S, 4), on ``sph``'s device."""
    dev = sph.device
    members = lt.members.to(dev).reshape(-1).long()
    keep = members >= 0
    pad = torch.tensor([0.0, 0.0, 0.0, -BIG], device=dev)
    rows = torch.where(keep[:, None], sph[members.clamp(min=0)], pad[None])
    box = lt.aabb.to(device=dev, dtype=torch.float32)
    mag = box.abs().amax(1, keepdim=True)
    grow = ordered_ops.BOX_PAD * (mag + 1.0)
    box = torch.cat([box[:, :3] - grow, box[:, 3:] + grow], 1)
    big = lt.big.to(dev).long()

    def c(x):
        return x.contiguous()

    return LeafPack(c(box), c(rows), c(torch.where(keep, members, -1).to(
        torch.int32)), c(sph[big]), c(big.to(torch.int32)))


def _need(tab: BounceTables) -> LeafPack:
    if tab.leaf is None:
        raise ValueError("scene has no leaf tables; call with_leaf_tables")
    return tab.leaf


# --------------------------------------------------------------- plain

def leaf_closest_plain(tab: BounceTables, o, d, t_min, t_max, alive,
                       visits=None) -> Closest:
    """The leaf walk in plain PyTorch (any device), vectorised over rays
    with one loop over leaves: the dense stages (big spheres, rects,
    triangles), then each leaf box against the running best t, then the
    leaf's spheres. ``visits`` (N,) int32, if given: leaves tested per ray,
    incremented. Same interface and outputs as ``leaf_closest``."""
    lp = _need(tab)
    n = o.shape[1]
    dev = o.device
    alive = alive.bool()
    dense = tab._replace(sph=lp.big, osph=None, otri=None)
    t, ty, ix, b1, b2 = _closest_plain(dense, o, d, t_min, alive,
                                       t_max=t_max)
    if lp.big.shape[0]:
        ix = torch.where(ty == PRIM_SPHERE,
                         lp.big_orig.long()[ix.clamp(0, lp.big.shape[0] - 1)],
                         ix)
    tmin_v = _row(t_min, n, dev)
    tmax_v = torch.clamp(_row(t_max, n, dev), max=BIG)
    r = ordered_ops.cull_rays(o, d, tmin_v, tmax_v)
    dx, dy, dz = d
    a = dx * dx + dy * dy + dz * dz
    cols = (o[0], o[1], o[2], dx, dy, dz, a, 1.0 / a, tmin_v, tmax_v)
    k = lp.sph.shape[0] // max(lp.box.shape[0], 1)
    for li in range(lp.box.shape[0]):
        hit, _, _ = ordered_ops.slab(r, lp.box[li], t)
        sel = torch.nonzero(hit & alive)[:, 0]
        if sel.numel() == 0:
            continue
        if visits is not None:
            visits[sel] += 1
        rows = lp.sph[li * k:(li + 1) * k]
        tt = _sphere_tt(tuple(x[sel][:, None] for x in cols),
                        *(rows[None, :, j] for j in range(4)))
        ids = lp.orig[li * k:(li + 1) * k].long()[None]
        mt = tt.amin(1)
        wid = torch.where(tt == mt[:, None], ids,
                          torch.iinfo(torch.int64).max).amin(1)
        cur_t, cur_ty, cur_ix = t[sel], ty[sel], ix[sel]
        better = (mt < cur_t) | ((mt == cur_t) & (
            (cur_ty > PRIM_SPHERE)
            | ((cur_ty == PRIM_SPHERE) & (wid < cur_ix))))
        t[sel] = torch.where(better, mt, cur_t)
        ty[sel] = torch.where(better, PRIM_SPHERE, cur_ty)
        ix[sel] = torch.where(better, wid, cur_ix)
        b1[sel] = torch.where(better, 0.0, b1[sel])
        b2[sel] = torch.where(better, 0.0, b2[sel])
    return _closest(t, ty, ix, b1, b2)


# -------------------------------------------------------------- kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I,                 # o d tmin tmax alive n
             _P, _P, _I,                             # big big_orig n_big
             _P, _I, _P, _I,                         # rect n, tri n
             _P, _P, _P, _I, _I,                     # box sph orig L leaf
             _P, _P, _P, _P, _P,                     # t ty ix b1 b2
             _P, _P]                                 # visits stream


def _leaf_cuda(tab: BounceTables, o, d, t_min, t_max, alive,
               visits=None) -> Closest:
    global LAUNCHES
    lp = _need(tab)
    dev = o.device
    n = o.shape[1]
    f32 = torch.float32
    _check("o", o, dev, f32, (3, n), "leaf")
    _check("d", d, dev, f32, (3, n), "leaf")
    _check("alive", alive, dev, torch.bool, (n,), "leaf")
    if visits is not None:
        _check("visits", visits, dev, torch.int32, (n,), "leaf")
    tmin, tmax = _rows(t_min, t_max, n, dev)
    for x in (tab.rect, tab.tri, *lp):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"leaf: tables must be contiguous on {dev}")
    n_leaf = lp.box.shape[0]
    t = torch.empty((n,), dtype=f32, device=dev)
    ty = torch.empty((n,), dtype=torch.int32, device=dev)
    ix = torch.empty((n,), dtype=torch.int32, device=dev)
    b1 = torch.empty((n,), dtype=f32, device=dev)
    b2 = torch.empty((n,), dtype=f32, device=dev)
    lib = bind("leaf", "rt_leaf", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rt_leaf(
            o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            alive.data_ptr(), n,
            lp.big.data_ptr(), lp.big_orig.data_ptr(), lp.big.shape[0],
            tab.rect.data_ptr(), tab.rect.shape[0],
            tab.tri.data_ptr(), tab.tri.shape[0],
            lp.box.data_ptr(), lp.sph.data_ptr(), lp.orig.data_ptr(), n_leaf,
            lp.sph.shape[0] // max(n_leaf, 1),
            t.data_ptr(), ty.data_ptr(), ix.data_ptr(), b1.data_ptr(),
            b2.data_ptr(), None if visits is None else visits.data_ptr(),
            stream)
    check_launch(lib, rc, "leaf kernel")
    LAUNCHES += 1
    return Closest(t, ty, ix, b1, b2)


def leaf_closest(tab: BounceTables, o, d, t_min, t_max, alive,
                 visits=None) -> Closest:
    """The closest hit of each ray through the leaf walk, over tables
    packed from a scene with leaf tables (``tab.leaf``; ValueError
    without). Same rays, limits and outputs as ``closest_hit.
    closest_tables``: a hit needs t_min <= t < min(t_max, BIG); dead lanes
    miss. ``visits`` (N,) int32 zeros, if given, receives the leaves
    tested per ray.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if o.device.type == "cpu":
        return leaf_closest_plain(tab, o, d, t_min, t_max, alive, visits)
    if o.device.type != "cuda":
        raise NotImplementedError(f"leaf: no kernel for {o.device}")
    return _leaf_cuda(tab, o, d, t_min, t_max, alive, visits)
