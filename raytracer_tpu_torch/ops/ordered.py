"""Ordered tables and the near-to-far superchunk walk for large sphere and
triangle tables.

The port of ``raytracer_tpu/ops/pallas_intersect.py``'s table side of the
ordered walk: ``_morton_order``, ``_order_chunks_near_to_far``,
``_wants_order``, the chunk and superchunk AABB tables of ``_pack_spheres``
and ``pack_rect_tri``, and the route rule of ``_order_flags``; and of its
kernel side, ``stage_ordered`` and ``_tile_chunk_order``, as ``walk_plain``
below, the plain PyTorch version of ``csrc/sweep.cuh::walk``.

A stage qualifies for the walk as in the JAX package: more than one chunk,
and at least ``ORDER_MIN_CHUNKS`` chunks once the chunk count is padded to a
``SUPER`` multiple (spheres: chunks of 256, so more than 2048 spheres;
triangles: chunks of 512, so more than 4096 triangles). The TPU's SMEM
budget and its 8-bit superchunk ids have no counterpart; the port's own cap
is ``MAX_SUPERS`` superchunks per stage (the kernel sorts their keys in
shared memory), and a larger table raises.

The walk, per group of ``GROUP`` rays (a warp of the kernels; every
decision below is the group's own, so a group runs only the chunks its own
rays can reach):
- the superchunks are visited in ascending order of the squared gap between
  the group's alive-origin box and the superchunk's box (a stable sort:
  equal gaps keep table order);
- the walk stops once that gap exceeds every alive lane's remaining reach,
  ``min(best_t, t_cap) * |d|``, squared with the JAX slack
  ``reach^2 * 1.001 + 1e-9``; ``t_cap`` is the lane's exit t from the
  stage's box, ``leave * 1.001 + 1e-4`` (0 when the lane misses the box);
- a superchunk, then each of its ``SUPER`` member chunks, runs only when an
  alive lane's slab test against its box passes for t in
  [t_min, min(best_t, t_cap, t_max)] (inclusive);
- a chunk's primitives are tested and folded into the lane's winner.
The group size changes which chunks run, and a lane's winner only where
the float32 sphere test hits a sphere that float64 misses (|o - c|^2 - r^2
cancelling far from it) at a point outside the sphere's chunk box: no cull
is conservative for such a false hit, so the lane keeps it only if another
lane of its group runs the chunk (``test_walk_group_keeps_no_false_hit``).
Every true hit lies in its padded box, and every cull is conservative for
it. ``BLOCK`` (128), the thread block whose decisions the kernels shared
until they became per warp, gives the chunk bodies of that design on the
same rays.

Tie rule: visit order changes from block to block, so the fold compares
(t, then type, then scene index): a hit replaces the winner when its t is
smaller, or equal with the same type and a lower scene index. Stages still
run spheres, then rects, then triangles, each with a strict ``<`` against
the earlier types, so spheres win over rects over triangles. The flat sweep
(``csrc/sweep.cuh::sweep``) picks the same winner on every lane, ties
included. (The TPU kernels break exact ties by Morton slot instead.)

Box tests: the inverse direction is 1e30 where |d| <= 1e-30 (the guard of
``ray_vals``), and an axis along which the ray is parallel (that same
guard) is tested as "origin inside the slab, inclusive" instead of by t,
so a ray lying in a box face keeps the box. A box whose lo.x > hi.x (a pad
chunk's inverted box) never passes. Each primitive's box is widened by
``BOX_PAD`` of its coordinates' magnitude, so rounding between the box test
and the exact pair test cannot cull a true winner.

Motion blur (JAX ``_pack_spheres(with_motion=True)``): a moving sphere
stage carries its sorted velocities (``vel``), and each sphere's box covers
its centre over the whole shutter, ``c +/- r + min/max(v t0, v t1)``,
before ``BOX_PAD`` widens it, so the chunk, superchunk and stage boxes hold
every position a ray's time can give. Morton and near-to-far order stay on
the t = 0 centres, as in JAX. The walk then tests each sphere at
``c + v t`` with the ray's own time.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

SPH_CHUNK = 256         # sphere chunk width (JAX SPH_CHUNK)
TRI_CHUNK = 512         # triangle chunk width (JAX CHUNK)
SUPER = 8               # chunks per superchunk (JAX SUPER)
ORDER_MIN_CHUNKS = 16   # padded chunk count from which a stage walks
MAX_SUPERS = 1024       # the kernel's shared-memory sort holds this many keys
GROUP = 32              # rays per walk group: a warp of the kernels
BLOCK = 128             # rays per group of the block-wide walk before it
BIG = 3.0e38
INV_GUARD = 1e-30       # |d| at or below this: inverse 1e30, parallel axis
BOX_PAD = 1e-5          # relative widening of each primitive's box
CAP_REL, CAP_ABS = 1.001, 1e-4       # t_cap = leave * 1.001 + 1e-4
REACH_REL, REACH_ABS = 1.001, 1e-9   # stop: gap^2 > reach^2 * 1.001 + 1e-9
PAIRS = 1 << 24         # plain walk: at most this many pairs per fold


class OrderedStage(NamedTuple):
    """A primitive table sorted for the walk: Morton-compact chunks, the
    chunk count padded to a SUPER multiple, chunks in near-to-far camera
    order within each superchunk (pad slots interleave as misses)."""
    prim: torch.Tensor    # (k_ch * chunk, W) f32 records; pads miss
    orig: torch.Tensor    # (k_ch * chunk,) int32 scene index, -1 on a pad
    cull: torch.Tensor    # (k_ch, 6) f32 chunk boxes: lo xyz, hi xyz
    scull: torch.Tensor   # (k_ch // SUPER, 6) f32 superchunk boxes
    box: torch.Tensor     # (6,) f32 the stage's box
    # (k_ch * chunk, 4) f32 velocities (vx, vy, vz, 0) of a moving sphere
    # stage, pads 0; None for a static stage
    vel: Optional[torch.Tensor] = None

    @property
    def chunk(self) -> int:
        return self.prim.shape[0] // self.cull.shape[0]


def eff_chunk(n: int, full: int) -> int:
    """Chunk width for an n-row table (JAX ``eff_chunk``)."""
    return full if n > full else max(128, -(-max(n, 1) // 128) * 128)


def padded_chunks(n: int, chunk: int) -> int:
    return -(-(-(-n // chunk)) // SUPER) * SUPER


def wants_order(n: int, chunk: int) -> bool:
    """The JAX ``_wants_order`` without its TPU cap on superchunks. A
    table past the port's own cap (``MAX_SUPERS``) raises ValueError."""
    if not (n > chunk and padded_chunks(n, chunk) >= ORDER_MIN_CHUNKS):
        return False
    k_sup = padded_chunks(n, chunk) // SUPER
    if k_sup > MAX_SUPERS:
        raise ValueError(
            f"ordered stage of {k_sup} superchunks: the walk's shared-memory "
            f"sort holds at most {MAX_SUPERS} ({MAX_SUPERS * SUPER * chunk} "
            "primitives of this kind)")
    return True


def morton_order(centers: torch.Tensor) -> torch.Tensor:
    """Z-order of (n, 3) points: consecutive chunks are spatially compact
    (JAX ``_morton_order``; a stable sort)."""
    c = centers.to(torch.float32)
    lo = c.amin(0)
    hi = c.amax(0)
    q = ((c - lo) / torch.clamp(hi - lo, min=1e-9) * 1023.0).to(torch.int64)
    q = torch.clamp(q, 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return torch.argsort(code, stable=True)


def order_chunks_near_to_far(order, lo3, hi3, chunk: int, cam):
    """Pad the chunk count to a SUPER multiple; superchunks are groups of
    SUPER Morton-consecutive chunks, ordered near-to-far from ``cam``, and
    their members near-to-far within (JAX ``_order_chunks_near_to_far``).
    ``lo3``/``hi3`` (n, 3) are the primitives' box corners in Morton
    order. Returns the slot -> scene index map with -1 on pad slots."""
    n = order.shape[0]
    k_ch = padded_chunks(n, chunk)
    n_pad = k_ch * chunk
    dev = order.device
    fill = torch.full((n_pad - n, 3), BIG, device=dev)
    clo = torch.cat([lo3.float(), fill]).reshape(k_ch, chunk, 3).amin(1)
    chi = torch.cat([hi3.float(), -fill]).reshape(k_ch, chunk, 3).amax(1)
    cam = cam.float()[None]
    gap = torch.clamp(torch.maximum(clo - cam, cam - chi), min=0.0)
    gap2 = (gap * gap).sum(-1)
    sup_order = torch.argsort(gap2.reshape(-1, SUPER).amin(1), stable=True)
    within = torch.argsort(gap2.reshape(-1, SUPER), dim=1, stable=True)
    chunk_order = (sup_order[:, None] * SUPER + within[sup_order]).reshape(-1)
    perm = (chunk_order[:, None] * chunk
            + torch.arange(chunk, device=dev)[None]).reshape(-1)
    full = torch.cat([order, torch.full((n_pad - n,), -1, dtype=order.dtype,
                                        device=dev)])
    return full[perm]


def _pack(records, lo, hi, slots, pad_record, chunk: int,
          vel=None) -> OrderedStage:
    """Gather the scene-order ``records`` (n, W) and boxes (n, 3) (and
    velocities ``vel`` (n, 4), if given) into the slot order ``slots`` (-1
    = pad) and build the chunk, superchunk and stage boxes."""
    keep = slots >= 0
    ix = torch.clamp(slots, min=0)
    prim = torch.where(keep[:, None], records[ix], pad_record[None])
    mag = torch.maximum(lo.abs(), hi.abs()).amax(1, keepdim=True)
    pad = BOX_PAD * (mag + 1.0)
    blo = torch.where(keep[:, None], (lo - pad)[ix], BIG)
    bhi = torch.where(keep[:, None], (hi + pad)[ix], -BIG)
    k_ch = slots.shape[0] // chunk
    clo = blo.reshape(k_ch, chunk, 3).amin(1)
    chi = bhi.reshape(k_ch, chunk, 3).amax(1)
    cull = torch.cat([clo, chi], 1)
    scull = torch.cat([clo.reshape(-1, SUPER, 3).amin(1),
                       chi.reshape(-1, SUPER, 3).amax(1)], 1)
    box = torch.cat([clo.amin(0), chi.amax(0)])

    def c(x):
        return x.to(torch.float32).contiguous()

    svel = None
    if vel is not None:
        svel = c(torch.where(keep[:, None], vel[ix], 0.0))
    return OrderedStage(c(prim), slots.to(torch.int32).contiguous(), c(cull),
                        c(scull), c(box), svel)


def sphere_stage(sph, center, radius, cam, vel=None,
                 shutter=None) -> Optional[OrderedStage]:
    """The ordered copy of the packed sphere table ``sph`` (S, 4) = (c,
    r^2), or None when the table does not qualify. Pads are (0, 0, 0,
    -3e38): disc < 0 for every ray. ``vel`` (S, 4) and ``shutter`` (time0,
    time1): a moving table, whose boxes are dilated over the shutter and
    whose stage carries the sorted velocities."""
    n = sph.shape[0]
    chunk = eff_chunk(n, SPH_CHUNK)
    if not wants_order(n, chunk):
        return None
    c = center.to(torch.float32)
    r = radius.to(torch.float32).abs()[:, None]
    lo, hi = c - r, c + r
    if vel is not None:
        v = vel[:, :3]
        t0, t1 = (torch.as_tensor(t, dtype=torch.float32, device=c.device)
                  for t in shutter)
        lo = lo + torch.minimum(v * t0, v * t1)
        hi = hi + torch.maximum(v * t0, v * t1)
    order = morton_order(c)
    slots = order_chunks_near_to_far(order, c[order], c[order], chunk, cam)
    pad = torch.tensor([0.0, 0.0, 0.0, -BIG], device=sph.device)
    return _pack(sph, lo, hi, slots, pad, chunk, vel)


def tri_stage(tri, v0, e1, e2, cam) -> Optional[OrderedStage]:
    """The ordered copy of the packed triangle table ``tri`` (T, 16), or
    None when the table does not qualify. Pads are all zeros: div = 0."""
    n = tri.shape[0]
    chunk = eff_chunk(n, TRI_CHUNK)
    if not wants_order(n, chunk):
        return None
    v0, e1, e2 = (x.to(torch.float32) for x in (v0, e1, e2))
    lo = torch.minimum(torch.minimum(v0, v0 + e1), v0 + e2)
    hi = torch.maximum(torch.maximum(v0, v0 + e1), v0 + e2)
    order = morton_order(v0 + (e1 + e2) / 3.0)
    slots = order_chunks_near_to_far(order, lo[order], hi[order], chunk, cam)
    pad = torch.zeros((tri.shape[1],), device=tri.device)
    return _pack(tri, lo, hi, slots, pad, chunk)


# --------------------------------------------------------------- plain walk

class CullRays(NamedTuple):
    """Per-ray values of the box tests, each (..., 1) against box columns:
    origin, inverse direction (1e30 guard), parallel flags, t_min, t_max."""
    o: tuple
    inv: tuple
    par: tuple
    tmin: torch.Tensor
    tmax: torch.Tensor


def cull_rays(o, d, tmin, tmax) -> CullRays:
    """``o``/``d``: 3-tuples of tensors of one shape; ``tmin``/``tmax`` of
    that shape (tmax clamped to BIG by the caller)."""
    par = tuple(x.abs() <= INV_GUARD for x in d)
    inv = tuple(torch.where(p, 1e30, 1.0 / torch.where(p, 1.0, x))
                for x, p in zip(d, par))
    return CullRays(tuple(o), inv, par, tmin, tmax)


def span(r: CullRays, box):
    """(ok, enter, leave) of rays ``r`` against ``box`` (..., 6): ok is
    False where the box is inverted or a parallel axis misses; enter starts
    at t_min, leave ignores t_max (csrc/sweep.cuh::box_span)."""
    ok = box[..., 0] <= box[..., 3]
    tn = r.tmin
    tf = torch.full_like(r.tmin, float("inf"))
    for k in range(3):
        lo, hi = box[..., k], box[..., 3 + k]
        t0 = (lo - r.o[k]) * r.inv[k]
        t1 = (hi - r.o[k]) * r.inv[k]
        p = r.par[k]
        ok = ok & (~p | ((r.o[k] >= lo) & (r.o[k] <= hi)))
        tn = torch.maximum(tn, torch.where(p, -float("inf"),
                                           torch.minimum(t0, t1)))
        tf = torch.minimum(tf, torch.where(p, float("inf"),
                                           torch.maximum(t0, t1)))
    return ok, tn, tf


def slab(r: CullRays, box, cap):
    """Inclusive slab test of rays ``r`` against ``box`` (..., 6) for t in
    [t_min, min(cap, t_max)]; returns (pass, enter, leave) where leave
    ignores cap and t_max (the stage box's exit t)."""
    ok, tn, tf = span(r, box)
    hit = ok & (tn <= torch.minimum(tf, torch.minimum(cap, r.tmax)))
    return hit, ok & (tn <= tf), tf


def walk_plain(stage: OrderedStage, o, d, tmin, tmax, alive, best, tests,
               kind: int, stats=None, time=None, group: int = GROUP):
    """The walk of one ordered stage over rays ``o``/``d`` (3, N) with
    ``tmin``/``tmax`` (N,) (tmax clamped to BIG) and ``alive`` (N,) bool,
    vectorised over the groups of ``group`` consecutive rays (``GROUP``,
    a warp, as the kernels walk; ``BLOCK`` for the block-wide walk of
    before): one loop over walk positions and members. ``best`` = [t, ty,
    ix, b1, b2] (N,) tensors, updated in place with the tie rule.
    ``tests(rows, rc)`` returns (tt, b1, b2) (nb, group, chunk) for the
    prims ``rows`` (nb, chunk, W) against the ray columns ``rc`` (ox, oy,
    oz, dx, dy, dz, a, 1/a, t_min, t_max), each (nb, group, 1), of the
    groups that run the chunk (b1, b2 may be None), with tt = BIG where the
    pair misses. ``stats``, if given, (G,) int64 with G = ceil(N / group):
    chunk bodies run per group, incremented. ``time`` (N,), for a stage
    with ``vel``: the rays' shutter times; ``tests`` then also gets the
    chunk's velocity rows (nb, chunk, 4) and the time column (nb, group,
    1)."""
    n = o.shape[1]
    dev = o.device
    g = -(-n // group)
    pad = g * group - n

    def blocks(x, fill=0.0):
        if pad:
            x = torch.cat([x, x.new_full(x.shape[:-1] + (pad,), fill)], -1)
        return x.reshape(x.shape[:-1] + (g, group))

    ob, db = blocks(o), blocks(d, 1.0)
    tminb, tmaxb = blocks(tmin), blocks(tmax)
    aliveb = blocks(alive, False)
    r = cull_rays(ob, db, tminb, tmaxb)
    dlen = torch.sqrt(db[0] * db[0] + db[1] * db[1] + db[2] * db[2])
    _, inside, leave = slab(r, stage.box, torch.full_like(tminb, BIG))
    t_cap = torch.where(inside, leave * CAP_REL + CAP_ABS, 0.0)
    am = aliveb[None]
    tlo = torch.where(am, ob, BIG).amin(-1)                   # (3, G)
    thi = torch.where(am, ob, -BIG).amax(-1)
    sc = stage.scull
    gx, gy, gz = (torch.clamp(torch.maximum(sc[None, :, k] - thi[k][:, None],
                                            tlo[k][:, None] - sc[None, :, 3 + k]),
                              min=0.0) for k in range(3))
    g2 = gx * gx + gy * gy + gz * gz                          # (G, K)
    order = torch.argsort(g2, dim=1, stable=True)
    k_sup = sc.shape[0]
    chunk = stage.chunk
    prim = stage.prim.reshape(-1, chunk, stage.prim.shape[1])
    orig = stage.orig.reshape(-1, chunk).long()
    done = ~aliveb.any(1)
    bt, bty, bix, bb1, bb2 = (blocks(x) for x in best)
    bix = bix.long()
    step = max(1, PAIRS // (group * chunk))
    dx, dy, dz = db
    a = dx * dx + dy * dy + dz * dz
    cols = (ob[0], ob[1], ob[2], dx, dy, dz, a, 1.0 / a, tminb, tmaxb)
    moving = time is not None and stage.vel is not None
    if moving:
        vel = stage.vel.reshape(-1, chunk, stage.vel.shape[1])
        timeb = blocks(time)

    def fold(sel, c):
        extra = (vel[c], timeb[sel][..., None]) if moving else ()
        tt, b1, b2 = tests(prim[c], tuple(x[sel][..., None] for x in cols),
                           *extra)
        tt = torch.where(aliveb[sel][..., None], tt, BIG)
        ids = orig[c][:, None, :]                             # (nb, 1, C)
        mt = tt.amin(-1)
        cand = tt == mt[..., None]
        wid = torch.where(cand, ids, torch.iinfo(torch.int64).max).amin(-1)
        cur_t, cur_ty, cur_ix = bt[sel], bty[sel], bix[sel]
        better = (mt < cur_t) | ((mt == cur_t) & (cur_ty == kind)
                                 & (wid < cur_ix))
        bt[sel] = torch.where(better, mt, cur_t)
        bty[sel] = torch.where(better, kind, cur_ty)
        bix[sel] = torch.where(better, wid, cur_ix)
        if b1 is not None:
            j = (cand & (ids == wid[..., None])).to(torch.int8).argmax(-1)
            bb1[sel] = torch.where(better, b1.gather(-1, j[..., None])[..., 0],
                                   bb1[sel])
            bb2[sel] = torch.where(better, b2.gather(-1, j[..., None])[..., 0],
                                   bb2[sel])

    for pos in range(k_sup):
        if bool(done.all()):
            break
        s = order[:, pos]
        g2s = g2.gather(1, s[:, None])[:, 0]
        cap = torch.minimum(bt, t_cap)
        reach = torch.where(aliveb, cap * dlen, 0.0).amax(1)
        done = done | (g2s > reach * reach * REACH_REL + REACH_ABS)
        hit, _, _ = slab(r, sc[s][:, None, :], cap)
        run_sup = ~done & (hit & aliveb).any(1)
        for m in range(SUPER):
            c = s * SUPER + m
            cap = torch.minimum(bt, t_cap)
            hit, _, _ = slab(r, stage.cull[c][:, None, :], cap)
            run = run_sup & (hit & aliveb).any(1)
            sel = torch.nonzero(run)[:, 0]
            if sel.numel() == 0:
                continue
            if stats is not None:
                stats += run.to(stats.dtype)
            for i0 in range(0, sel.numel(), step):
                part = sel[i0:i0 + step]
                fold(part, c[part])
    for dst, src in zip(best, (bt, bty, bix, bb1, bb2)):
        dst.copy_(src.reshape(-1)[:n].to(dst.dtype))
