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

The walk, per ray: the dense stages first (the big spheres, then the
rects, then the triangles, through the flat sweep), so their hits bound t;
then the leaves whose box the ray's slab test passes against its running
best t, and an exact float32 test of each such leaf's spheres. A leaf is
culled when its entry t exceeds the best t (the test is inclusive, so a
tie at the entry is kept). ``leaf_closest_plain`` takes the leaves in table
order; the kernel walks a box hierarchy over them (``leaf_tree``) with each
warp of 32 rays deciding together (``leaf_walk_plain``, its plain twin).
Winner rule: the flat sweep's, by (t, then type, then scene index), which
no visit order changes: a leaf sphere at the best t wins over a rect or
triangle there, and over a sphere of higher index. No
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

from raytracer_tpu_torch.kernels import launch
from raytracer_tpu_torch.ops import ordered as ordered_ops
from raytracer_tpu_torch.ops.closest_hit import Closest, _closest, _rows
from raytracer_tpu_torch.ops.fused_bounce import (
    BIG, BounceTables, _check, _closest_plain, _row, _sphere_tt,
)
from raytracer_tpu_torch.scene.types import (
    PRIM_SPHERE, LeafTables, Scene,
)

LEAF_SIZE = 32     # spheres per leaf (JAX LEAF_SIZE)
GROUP = 32         # rays that walk the hierarchy together: a warp
STACK = 32         # the kernel's stack of nodes: the hierarchy's depth cap
BIG_FACTOR = 20.0  # "big": radius > 20 x the median radius
MIN_SPHERES = 256  # with_leaf_tables' policy


class LeafPack(NamedTuple):
    """The leaf kernel's tables, on the scene's device: the big spheres'
    and the leaves' records as rows of the packed sphere table ((c, r^2),
    bit-equal to the flat sweep's), with their scene indices."""
    box: torch.Tensor       # (L, 6) f32 leaf boxes, widened by BOX_PAD
    sph: torch.Tensor       # (L * LEAF, 4) f32; empty slots (0,0,0,-3e38)
    orig: torch.Tensor      # (L * LEAF,) int32 scene index, -1 empty
    big: torch.Tensor       # (B, 4) f32
    big_orig: torch.Tensor  # (B,) int32
    nbox: torch.Tensor      # (M, 6) f32 boxes of the hierarchy's nodes
    node: torch.Tensor      # (M, 4) int32 left, right, leaf (-1: inner), 0


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


def leaf_tree(box: torch.Tensor):
    """A box hierarchy over the leaf boxes ``box`` (L, 6): median splits of
    the leaves' box centres on the largest-extent axis, down to one leaf
    per node. An inner node's box is the union of its children's (exact
    float32 min and max, so a ray whose slab test passes a leaf's box
    passes every box above it). Nodes in breadth-first order, the root
    first. Returns (nbox (M, 6) f32, node (M, 4) int32: left, right, leaf
    index or -1, 0) on ``box``'s device."""
    b = box.detach().cpu().numpy().astype(np.float32)
    centre = (b[:, :3].astype(np.float64) + b[:, 3:]) / 2
    kids, boxes, leafs = [], [], []

    def build(ix):
        k = len(kids)
        kids.append((-1, -1))
        boxes.append(None)
        leafs.append(-1)
        if len(ix) == 1:
            boxes[k], leafs[k] = b[ix[0]], int(ix[0])
            return k
        c = centre[ix]
        ax = int(np.argmax(c.max(0) - c.min(0)))
        order = np.argsort(c[:, ax], kind="stable")
        h = len(ix) // 2
        left, right = build(ix[order[:h]]), build(ix[order[h:]])
        kids[k] = (left, right)
        boxes[k] = np.concatenate([np.minimum(boxes[left][:3],
                                              boxes[right][:3]),
                                   np.maximum(boxes[left][3:],
                                              boxes[right][3:])])
        return k

    build(np.arange(b.shape[0]))
    bfs, depth, level = [], 0, [0]
    while level:
        bfs += level
        depth += 1
        level = [c for k in level for c in kids[k] if c >= 0]
    if depth > STACK:
        raise ValueError(f"leaf hierarchy {depth} deep; the kernel's stack "
                         f"holds {STACK}")
    new = {k: i for i, k in enumerate(bfs)}
    node = np.array([[new.get(kids[k][0], -1), new.get(kids[k][1], -1),
                      leafs[k], 0] for k in bfs], np.int32)
    nbox = np.stack([boxes[k] for k in bfs]).astype(np.float32)
    return (torch.from_numpy(nbox).to(box.device),
            torch.from_numpy(node).to(box.device))


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
    nbox, node = leaf_tree(box)

    def c(x):
        return x.contiguous()

    return LeafPack(c(box), c(rows), c(torch.where(keep, members, -1).to(
        torch.int32)), c(sph[big]), c(big.to(torch.int32)), c(nbox),
        c(node))


def _need(tab: BounceTables) -> LeafPack:
    if tab.leaf is None:
        raise ValueError("scene has no leaf tables; call with_leaf_tables")
    return tab.leaf


# --------------------------------------------------------------- plain

def _dense(tab: BounceTables, lp: LeafPack, o, d, t_min, t_max, alive):
    """The dense stages (big spheres, rects, triangles) of the plain
    walks: the winner rows [t, ty, ix, b1, b2], the rays' slab values and
    their columns for ``_sphere_tt``."""
    n = o.shape[1]
    dev = o.device
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
    return [t, ty, ix, b1, b2], r, cols


def _fold_leaf(lp: LeafPack, best, cols, sel, leaf_ix):
    """Test the rays ``sel`` (m,) against the spheres of their leaves
    ``leaf_ix`` (m,) and fold with the tie rule (t, then type, then
    index) into ``best``."""
    t, ty, ix, b1, b2 = best
    k = lp.sph.shape[0] // max(lp.box.shape[0], 1)
    slots = leaf_ix[:, None] * k + torch.arange(k, device=sel.device)
    rows = lp.sph[slots]
    tt = _sphere_tt(tuple(x[sel][:, None] for x in cols),
                    *(rows[..., j] for j in range(4)))
    ids = lp.orig[slots].long()
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


def leaf_closest_plain(tab: BounceTables, o, d, t_min, t_max, alive,
                       visits=None) -> Closest:
    """The leaf walk in plain PyTorch (any device), vectorised over rays
    with one loop over leaves in table order: the dense stages (big
    spheres, rects, triangles), then each leaf box against the running
    best t, then the leaf's spheres. ``visits`` (N,) int32, if given:
    leaves tested per ray, incremented. Same interface and outputs as
    ``leaf_closest``."""
    lp = _need(tab)
    alive = alive.bool()
    best, r, cols = _dense(tab, lp, o, d, t_min, t_max, alive)
    for li in range(lp.box.shape[0]):
        hit, _, _ = ordered_ops.slab(r, lp.box[li], best[0])
        sel = torch.nonzero(hit & alive)[:, 0]
        if sel.numel() == 0:
            continue
        if visits is not None:
            visits[sel] += 1
        _fold_leaf(lp, best, cols, sel, torch.full_like(sel, li))
    return _closest(*best)


def leaf_walk_plain(tab: BounceTables, o, d, t_min, t_max, alive,
                    visits=None) -> Closest:
    """The kernel's walk in plain PyTorch (any device): after the dense
    stages, each group of GROUP consecutive rays walks the hierarchy
    (``LeafPack.nbox``/``node``) together, vectorised over the groups. At
    an inner node each alive ray tests both children's boxes against its
    running best t; the group descends into the children some ray passes,
    the one most rays enter first (by entry t, else by count) first, the
    other kept on its stack. At a leaf, the rays whose own slab test of
    the leaf's box passes test its spheres (``visits`` counts those
    leaves). The same winners as ``leaf_closest_plain``."""
    lp = _need(tab)
    n = o.shape[1]
    dev = o.device
    alive = alive.bool()
    best, r, cols = _dense(tab, lp, o, d, t_min, t_max, alive)
    g_n = -(-n // GROUP)
    lanes = torch.arange(g_n * GROUP, device=dev).reshape(g_n, GROUP)
    inside = lanes < n
    lanes = lanes.clamp(max=n - 1)
    al = alive[lanes] & inside
    node = lp.node.long()
    nd = torch.zeros(g_n, dtype=torch.long, device=dev)
    sp = torch.zeros(g_n, dtype=torch.long, device=dev)
    stack = torch.zeros((g_n, STACK), dtype=torch.long, device=dev)
    act = al.any(1) & (node.shape[0] > 0)
    while bool(act.any()):
        g = torch.nonzero(act)[:, 0]
        rec = node[nd[g]]
        ln, a = lanes[g], al[g]
        rg = ordered_ops.CullRays(tuple(x[ln] for x in r.o),
                                  tuple(x[ln] for x in r.inv),
                                  tuple(x[ln] for x in r.par), r.tmin[ln],
                                  r.tmax[ln])
        cap = best[0][ln]

        def passes(k):
            ok, tn, tf = ordered_ops.span(rg, lp.nbox[k][:, None, :])
            return a & ok & (tn <= torch.minimum(
                tf, torch.minimum(cap, rg.tmax))), tn

        leaf = rec[:, 2] >= 0
        on, _ = passes(nd[g])
        on &= leaf[:, None]
        sel = ln[on]
        if sel.numel():
            if visits is not None:
                visits[sel] += 1
            _fold_leaf(lp, best, cols, sel, rec[:, 2, None].expand_as(on)[on])
        c0, c1 = rec[:, 0].clamp(min=0), rec[:, 1].clamp(min=0)
        h0, tn0 = passes(c0)
        h1, tn1 = passes(c1)
        h0 &= ~leaf[:, None]
        h1 &= ~leaf[:, None]
        b0, b1 = h0.any(1), h1.any(1)
        both = h0 & h1
        nb = both.sum(1)
        first1 = torch.where(nb > 0, (both & (tn1 < tn0)).sum(1) * 2 > nb,
                             h1.sum(1) > h0.sum(1))
        two = b0 & b1
        far = torch.where(first1, c0, c1)
        gt = g[two]
        stack[gt, sp[gt]] = far[two]
        sp[gt] += 1
        down = b0 | b1
        nxt = torch.where(two, torch.where(first1, c1, c0),
                          torch.where(b0, c0, c1))
        pop = ~down & (sp[g] > 0)
        gp = g[pop]
        sp[gp] -= 1
        nxt = torch.where(pop, stack[g, (sp[g]).clamp(min=0)], nxt)
        nd[g] = nxt
        act[g] = down | pop
    return _closest(*best)


# -------------------------------------------------------------- kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I,                 # o d tmin tmax alive n
             _P, _P, _I,                             # big big_orig n_big
             _P, _I, _P, _I,                         # rect n, tri n
             _P, _P, _I, _P, _P, _I,                 # nbox node M sph orig
             #                                         leaf
             _P, _P, _P, _P, _P,                     # t ty ix b1 b2
             _P, _P]                                 # visits stream


def _leaf_cuda(tab: BounceTables, o, d, t_min, t_max, alive,
               visits=None) -> Closest:
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
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch("leaf", "leaf", "rt_leaf", _ARGTYPES, (
            o.data_ptr(), d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
            alive.data_ptr(), n,
            lp.big.data_ptr(), lp.big_orig.data_ptr(), lp.big.shape[0],
            tab.rect.data_ptr(), tab.rect.shape[0],
            tab.tri.data_ptr(), tab.tri.shape[0],
            lp.nbox.data_ptr(), lp.node.data_ptr(), lp.node.shape[0],
            lp.sph.data_ptr(), lp.orig.data_ptr(),
            lp.sph.shape[0] // max(n_leaf, 1),
            t.data_ptr(), ty.data_ptr(), ix.data_ptr(), b1.data_ptr(),
            b2.data_ptr(), None if visits is None else visits.data_ptr(),
            stream), "leaf kernel")
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
