"""Flat-array BVH: the host build and a wavefront traversal, the
``--intersector bvh`` route. The counterpart of
``raytracer_tpu/ops/bvh.py``.

- **Build (host, numpy or C++)**: median split on the largest-extent axis
  of the primitive centroids into flat arrays; a leaf holds a contiguous
  range of the reordered primitive list (at most ``LEAF_SIZE``).
  ``_build_flat_python`` makes the same numpy calls as the JAX package's,
  so the two layouts are bit-equal; ``build_bvh(use_native=True)`` takes
  the C++ builder of ``native/rt_native.cpp`` (``native/runtime.py``)
  where g++ can build it, and says once on stderr when it cannot.
- **Traversal**: the JAX package's per-ray short stack (``MAX_STACK``
  entries) run as a wavefront over (N,) lanes with an (N, MAX_STACK)
  int32 stack: each iteration pops one node per live lane. The nearer
  child is popped first (``l_enter <= r_enter``), the running best t
  shrinks the box test, a primitive wins only on a strictly smaller t,
  and the primitive tests are inclusive (t_min <= t <= t_max), so the
  winners match JAX's lane for lane, ties included. A leaf's primitives
  are tested together as (N, LEAF_SIZE) columns and folded in order;
  testing them against the leaf's entry best t instead of the shrinking
  one changes no winner, since a primitive then wins only on t < best t.
  The loop reads its live count to the host every ``CHECK_EVERY``
  iterations and compacts the live lanes once at most half of the current
  width is live; on the card each run of ``CHECK_EVERY`` iterations is one
  CUDA graph, captured again after each compaction. The JAX function is XLA, not Pallas:
  this is plain PyTorch, with no kernel of its own.

Mixed primitive types share one tree: the unified list is (prim_type,
prim_idx) pairs, spheres, then rects, then triangles.
"""

from __future__ import annotations


import numpy as np
import torch

from raytracer_tpu_torch.ops import vec
from raytracer_tpu_torch.ops.intersect import Hit
from raytracer_tpu_torch.scene.types import (
    BVH, PRIM_RECT, PRIM_SPHERE, PRIM_TRIANGLE, Scene,
)

MAX_STACK = 48
LEAF_SIZE = 4
CHECK_EVERY = 8          # iterations between two reads of the live count
MIN_COMPACT = 4096       # no compaction below this width
NO_BVH = "scene has no BVH; build it with ops.bvh.build_bvh"


# ----------------------------------------------------------------- build

def primitive_aabbs(scene: Scene):
    """Conservative world-space boxes of every primitive in the unified
    order [spheres | rects | triangles]: (min (P, 3) f32, max (P, 3) f32,
    type (P,) int32, index (P,) int32), numpy. Rects and triangles are
    padded by 1e-4 x max(1, scene scale) (rectangle.rs:36-40 pads by
    1e-4)."""
    mins, maxs, types, idxs = [], [], [], []
    pad = 1e-4 * max(1.0, float(scene.scale))

    def host(x, dtype=np.float64):
        return x.detach().cpu().numpy().astype(dtype)

    s = scene.spheres
    if s.radius.shape[0]:
        c = host(s.center)
        r = np.abs(host(s.radius))[:, None]
        mins.append(c - r)
        maxs.append(c + r)
        types.append(np.full(len(c), PRIM_SPHERE, np.int32))
        idxs.append(np.arange(len(c), dtype=np.int32))

    rct = scene.rects
    if rct.k.shape[0]:
        n = rct.k.shape[0]
        axis = host(rct.axis, np.int64)
        k = host(rct.k)
        a0, a1, b0, b1 = (host(x) for x in (rct.a0, rct.a1, rct.b0, rct.b1))
        lo = np.zeros((n, 3))
        hi = np.zeros((n, 3))
        for i in range(n):
            ax = int(axis[i])
            aa, bb = ((1, 2), (0, 2), (0, 1))[ax]
            lo[i, ax], hi[i, ax] = k[i] - pad, k[i] + pad
            lo[i, aa], hi[i, aa] = a0[i], a1[i]
            lo[i, bb], hi[i, bb] = b0[i], b1[i]
        mins.append(lo)
        maxs.append(hi)
        types.append(np.full(n, PRIM_RECT, np.int32))
        idxs.append(np.arange(n, dtype=np.int32))

    t = scene.triangles
    if t.mat_id.shape[0]:
        v0 = host(t.v0)
        v1 = v0 + host(t.e1)
        v2 = v0 + host(t.e2)
        mins.append(np.minimum(np.minimum(v0, v1), v2) - pad)
        maxs.append(np.maximum(np.maximum(v0, v1), v2) + pad)
        types.append(np.full(len(v0), PRIM_TRIANGLE, np.int32))
        idxs.append(np.arange(len(v0), dtype=np.int32))

    if not mins:
        raise ValueError("cannot build a BVH over an empty scene")
    return (np.concatenate(mins).astype(np.float32),
            np.concatenate(maxs).astype(np.float32),
            np.concatenate(types), np.concatenate(idxs))


def _build_flat_python(pmin: np.ndarray, pmax: np.ndarray, leaf_size: int):
    """Iterative median-split build: (node_min, node_max, left, right,
    is_leaf, order). Interior nodes hold their children's ids in
    left/right; a leaf holds its first slot in ``order`` and its count."""
    n = pmin.shape[0]
    centroid = (pmin + pmax) * 0.5
    order = np.arange(n, dtype=np.int32)

    node_min, node_max = [], []
    left, right, is_leaf = [], [], []

    def alloc():
        node_min.append(None)
        node_max.append(None)
        left.append(0)
        right.append(0)
        is_leaf.append(False)
        return len(left) - 1

    root = alloc()
    stack = [(root, 0, n)]
    while stack:
        nid, s, e = stack.pop()
        seg = order[s:e]
        node_min[nid] = pmin[seg].min(axis=0)
        node_max[nid] = pmax[seg].max(axis=0)
        if e - s <= leaf_size:
            left[nid], right[nid], is_leaf[nid] = s, e - s, True
            continue
        ext = centroid[seg].max(axis=0) - centroid[seg].min(axis=0)
        axis = int(np.argmax(ext))
        mid = (e - s) // 2
        part = np.argpartition(centroid[seg, axis], mid)
        order[s:e] = seg[part]
        l_id, r_id = alloc(), alloc()
        left[nid], right[nid], is_leaf[nid] = l_id, r_id, False
        stack.append((r_id, s + mid, e))
        stack.append((l_id, s, s + mid))

    return (np.asarray(node_min, np.float32), np.asarray(node_max, np.float32),
            np.asarray(left, np.int32), np.asarray(right, np.int32),
            np.asarray(is_leaf, bool), order)


def build_bvh(scene: Scene, leaf_size: int = LEAF_SIZE,
              use_native: bool = True) -> Scene:
    """Build the flat BVH on the host and attach it to the scene, its
    arrays on the scene's device. ``use_native``: the C++ builder, else
    (or where it cannot be built) ``_build_flat_python``."""
    pmin, pmax, ptype, pidx = primitive_aabbs(scene)
    built = None
    if use_native:
        from raytracer_tpu_torch.native import runtime
        built = runtime.bvh_build(pmin, pmax, leaf_size)
        if built is None:
            runtime.warn_once(
                "raytracer_tpu_torch: the native BVH builder is unavailable "
                f"({runtime.why()}); building with numpy")
    if built is None:
        built = _build_flat_python(pmin, pmax, leaf_size)
    node_min, node_max, left, right, is_leaf, order = built
    dev = scene.bounds_min.device

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return scene._replace(bvh=BVH(
        node_min=t(node_min), node_max=t(node_max), left=t(left),
        right=t(right), is_leaf=t(np.asarray(is_leaf, bool)),
        prim_type=t(ptype[order]), prim_idx=t(pidx[order])))


# ------------------------------------------------------------- traversal

def _leaf_prim_t(scene: Scene, ptype, pidx, o, d, t_min, t_max):
    """Distance to the primitives (``ptype``, ``pidx``), +inf on a miss, in
    the JAX package's arithmetic. ``o``/``d`` (..., 3) broadcast against
    the index shape; ``t_min``/``t_max`` broadcast against it too."""
    inf = torch.inf
    t_out = torch.full(pidx.shape, inf, device=o.device)

    sp = scene.spheres
    if sp.radius.shape[0]:
        i = pidx.clamp(0, sp.radius.shape[0] - 1).long()
        c = sp.center[i]
        r = sp.radius[i]
        oc = o - c
        a = vec.dot(d, d)
        half_b = vec.dot(oc, d)
        cc = vec.dot(oc, oc) - r * r
        disc = half_b * half_b - a * cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        r1 = (-half_b - sq) / a
        r2 = (-half_b + sq) / a
        ts = torch.where((r1 >= t_min) & (r1 <= t_max), r1,
                         torch.where((r2 >= t_min) & (r2 <= t_max), r2, inf))
        ts = torch.where(disc >= 0.0, ts, inf)
        t_out = torch.where(ptype == PRIM_SPHERE, ts, t_out)

    rc = scene.rects
    if rc.k.shape[0]:
        i = pidx.clamp(0, rc.k.shape[0] - 1).long()
        axis = rc.axis[i].long()
        ax_a = torch.where(axis == 0, 1, 0)
        ax_b = torch.where(axis == 2, 1, 2)
        shape = axis.shape

        def comp(v, ax):
            return torch.gather(v.expand(*shape, 3), -1, ax[..., None])[..., 0]

        d_n = comp(d, axis)
        o_n = comp(o, axis)
        safe = d_n.abs() > 1e-12
        tt = (rc.k[i] - o_n) / torch.where(safe, d_n, 1.0)
        p = o + tt[..., None] * d
        pa = comp(p, ax_a)
        pb = comp(p, ax_b)
        inb = ((pa >= rc.a0[i]) & (pa <= rc.a1[i]) & (pb >= rc.b0[i])
               & (pb <= rc.b1[i]))
        ok = safe & inb & (tt >= t_min) & (tt <= t_max)
        t_out = torch.where(ptype == PRIM_RECT, torch.where(ok, tt, inf),
                            t_out)

    tr = scene.triangles
    if tr.mat_id.shape[0]:
        i = pidx.clamp(0, tr.mat_id.shape[0] - 1).long()
        v0, e1, e2 = tr.v0[i], tr.e1[i], tr.e2[i]
        dd = d.expand_as(v0)
        s0 = vec.cross(dd, e2)
        div = vec.dot(s0, e1)
        safe = div != 0.0
        inv = 1.0 / torch.where(safe, div, 1.0)
        dv = o - v0
        b1 = vec.dot(dv, s0) * inv
        s1 = vec.cross(dv, e1)
        b2 = vec.dot(d, s1) * inv
        tt = vec.dot(e2, s1) * inv
        ok = (safe & (b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0)
              & (b1 + b2 <= 1.0) & (tt >= t_min) & (tt <= t_max))
        t_out = torch.where(ptype == PRIM_TRIANGLE, torch.where(ok, tt, inf),
                            t_out)
    return t_out


def _slab(bvh: BVH, node, o, inv_d):
    """(enter, leave) of each lane's ray through its node's box."""
    t0 = (bvh.node_min[node] - o) * inv_d
    t1 = (bvh.node_max[node] - o) * inv_d
    return (torch.minimum(t0, t1).amax(-1), torch.maximum(t0, t1).amin(-1))


class _Walk:
    """The traversal state of a set of lanes, updated in place by
    ``step`` (one pop per live lane), so that a run of steps can be
    captured as a CUDA graph."""

    def __init__(self, scene: Scene, leaf_size: int, lanes, o, d, inv_d,
                 tmin, tmax, stack, sp, best):
        self.scene, self.bvh = scene, scene.bvh
        self.leaf_size = leaf_size
        self.lanes, self.o, self.d, self.inv_d = lanes, o, d, inv_d
        self.tmin, self.tmax, self.stack, self.sp = tmin, tmax, stack, sp
        self.best_t, self.best_ty, self.best_ix = best
        self.slots = torch.arange(leaf_size, device=o.device)
        self.graph = None

    def subset(self, keep) -> "_Walk":
        return _Walk(self.scene, self.leaf_size, self.lanes[keep],
                     *(x[keep] for x in (self.o, self.d, self.inv_d,
                                         self.tmin, self.tmax, self.stack,
                                         self.sp)),
                     tuple(x[keep] for x in (self.best_t, self.best_ty,
                                             self.best_ix)))

    def step(self):
        bvh, o, d, sp = self.bvh, self.o, self.d, self.sp
        n_prims = bvh.prim_type.shape[0]
        top = MAX_STACK - 1
        active = sp > 0
        node = self.stack.gather(1, (sp - 1).clamp(min=0)[:, None])[:, 0]
        sp = sp - active.long()
        enter, leave = _slab(bvh, node, o, self.inv_d)
        best_t = self.best_t
        hit_box = active & (torch.maximum(enter, self.tmin) < torch.minimum(
            leave, torch.minimum(best_t, self.tmax)))
        leaf = bvh.is_leaf[node]

        # leaf: its primitives as (width, leaf_size) columns, folded in order
        do_leaf = hit_box & leaf
        start = bvh.left[node].long()
        count = bvh.right[node].long()
        slot = (start[:, None] + self.slots).clamp(0, n_prims - 1)
        pty = bvh.prim_type[slot]
        pix = bvh.prim_idx[slot]
        ts = _leaf_prim_t(self.scene, pty, pix, o[:, None], d[:, None],
                          self.tmin[:, None],
                          torch.minimum(best_t, self.tmax)[:, None])
        valid = do_leaf[:, None] & (self.slots < count[:, None])
        best_ty, best_ix = self.best_ty, self.best_ix
        for k in range(self.leaf_size):
            better = valid[:, k] & (ts[:, k] < best_t)
            best_t = torch.where(better, ts[:, k], best_t)
            best_ty = torch.where(better, pty[:, k], best_ty)
            best_ix = torch.where(better, pix[:, k], best_ix)

        # interior: push the far child, then the near one (popped first);
        # a lane that pushes nothing writes above its top, harmlessly
        push = hit_box & ~leaf
        l_child = torch.where(leaf, 0, bvh.left[node]).long()
        r_child = torch.where(leaf, 0, bvh.right[node]).long()
        l_enter, _ = _slab(bvh, l_child, o, self.inv_d)
        r_enter, _ = _slab(bvh, r_child, o, self.inv_d)
        near_l = l_enter <= r_enter
        near = torch.where(near_l, l_child, r_child)
        far = torch.where(near_l, r_child, l_child)
        self.stack.scatter_(1, sp.clamp(max=top)[:, None], far[:, None])
        sp = sp + push.long()
        self.stack.scatter_(1, sp.clamp(max=top)[:, None], near[:, None])
        sp = sp + push.long()
        self.sp.copy_(sp)
        self.best_t.copy_(best_t)
        self.best_ty.copy_(best_ty)
        self.best_ix.copy_(best_ix)

    def run(self, steps: int):
        """``steps`` iterations: eagerly on the CPU; on the card as one
        CUDA graph, captured at first use after one eager step (an
        iteration is ~150 small launches: the graph replays them without
        the host, 1.25 against 2.21 ms at 480,000 lanes on the H100)."""
        if not self.o.is_cuda:
            for _ in range(steps):
                self.step()
            return
        if self.graph is None:
            self.step()                    # warm-up, a real iteration
            torch.cuda.synchronize(self.o.device)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                for _ in range(steps):
                    self.step()
            return                         # capture does not execute
        self.graph.replay()


def intersect_bvh(scene: Scene, o, d, t_min, t_max,
                  leaf_size: int = LEAF_SIZE) -> Hit:
    """Closest hit of rays ``o``/``d`` (N, 3) through the flat BVH, within
    [t_min, t_max] (floats or (N,) tensors; the best t starts at t_max and
    a primitive wins only below it, so a hit at exactly t_max is not
    taken, as in JAX). Returns ``Hit`` (t +inf, type and index -1 on a
    miss)."""
    bvh = scene.bvh
    if bvh is None:
        raise ValueError(NO_BVH)
    n = o.shape[0]
    dev = o.device
    i32 = torch.int32
    out_t = torch.full((n,), torch.inf, device=dev)
    out_ty = torch.full((n,), -1, dtype=i32, device=dev)
    out_ix = torch.full((n,), -1, dtype=i32, device=dev)
    if n == 0:
        return Hit(out_t, out_ty, out_ix)

    def lanes_of(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        return x.expand(n).clone() if x.dim() == 0 else x.clone()

    tmin, tmax = lanes_of(t_min), lanes_of(t_max)
    inv_d = torch.where(d.abs() > 1e-20, 1.0 / d,
                        torch.sign(d) * 1e20 + 1e20)
    walk = _Walk(scene, leaf_size, torch.arange(n, device=dev),
                 o.contiguous(), d.contiguous(), inv_d, tmin, tmax,
                 torch.zeros((n, MAX_STACK), dtype=torch.int64, device=dev),
                 torch.ones((n,), dtype=torch.int64, device=dev),
                 (tmax.clone(), out_ty.clone(), out_ix.clone()))

    def write_back(w):
        out_t[w.lanes] = w.best_t
        out_ty[w.lanes] = w.best_ty
        out_ix[w.lanes] = w.best_ix

    while True:
        live = walk.sp > 0
        n_live = int(live.sum())           # the host sync, every run
        if n_live == 0:
            break
        width = walk.lanes.shape[0]
        if width >= MIN_COMPACT and n_live <= width // 2:
            write_back(walk)
            walk = walk.subset(live.nonzero()[:, 0])
        walk.run(CHECK_EVERY)
    write_back(walk)
    out_t = torch.where(out_ty >= 0, out_t, torch.inf)
    return Hit(out_t, out_ty, out_ix)
