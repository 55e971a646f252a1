"""Scenes with a large OBJ mesh for the reference, and their closest hit
with an exact cull.

- ``read_obj``: an OBJ file's first object, fan-triangulated, with
  area-weighted vertex normals (each vertex the normalised sum of the
  unnormalised face normals (v1 - v0) x (v2 - v0) of its faces), which is
  how the program defines a file's normals when it has no ``vn`` lines;
- ``build``: a ``"primitives"`` configuration (``reference.scenes``) whose
  meshes are read so, each under its scale and translation, with a
  ``Cull`` of its triangles;
- ``closest``: ``render.closest``'s answer, winners and barycentrics
  equal on every ray, where a ray tests the triangles of only those
  chunks whose padded float64 box its segment [t_min, best t] reaches,
  best t being the nearest sphere or rect (and t_max). A hit inside a
  triangle lies inside its chunk's box, so no winner is culled; ties go
  to the lowest scene index, as in ``render.closest``.

The brute-force ``render.closest`` would hold an (N, T, 3) float64 tensor
for T = 4,968 triangles, some 10^11 pair tests a comparison; this cull
tests a ray against the few chunks it passes. Imports nothing of the
program."""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from reference import render, scenes

CHUNK = 64            # triangles a chunk, in Morton order of centroids
BOX_PAD_REL = 1e-6    # each box widened by this share of its magnitude
BOX_PAD_ABS = 1e-9
BOX_TESTS = 1 << 20   # (ray, chunk box) tests a block
PAIR_TRIS = 1 << 21   # (ray, triangle) tests a block
NO_INDEX = torch.iinfo(torch.int64).max


def read_obj(path: Path):
    """(positions (V, 3), faces (T, 3) 0-based, vertex normals (V, 3)),
    float64, of an OBJ file's first object (its faces up to the second
    ``o``/``g`` after face data), fan-triangulated."""
    pos, faces, seen = [], [], False
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            pos.append([float(x) for x in parts[1:4]])
        elif parts[0] in ("o", "g") and seen:
            break
        elif parts[0] == "f":
            seen = True
            ids = []
            for ref in parts[1:]:
                i = int(ref.split("/")[0])
                ids.append(i - 1 if i > 0 else len(pos) + i)
            for k in range(1, len(ids) - 1):
                faces.append([ids[0], ids[k], ids[k + 1]])
    pos = np.array(pos, np.float64)
    faces = np.array(faces, np.int64).reshape(-1, 3)
    return pos, faces, vertex_normals(pos, faces)


def vertex_normals(pos, faces):
    """Area-weighted vertex normals (V, 3) of a triangle mesh."""
    fn = np.cross(pos[faces[:, 1]] - pos[faces[:, 0]],
                  pos[faces[:, 2]] - pos[faces[:, 0]])
    out = np.zeros_like(pos)
    for k in range(3):
        np.add.at(out, faces[:, k], fn)
    norm = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(norm, 1e-12)


@dataclass
class Cull:
    """The triangles in chunks of ``CHUNK``: ``ids`` (C, CHUNK) scene
    indices, -1 on a pad; ``lo``/``hi`` (C, 3) float64 boxes, padded;
    ``box_lo``/``box_hi`` (3,) the whole mesh's."""
    ids: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    box_lo: torch.Tensor
    box_hi: torch.Tensor

    def to(self, device) -> "Cull":
        return Cull(*(getattr(self, k).to(device) for k in
                      ("ids", "lo", "hi", "box_lo", "box_hi")))


def _pad(lo, hi):
    mag = np.maximum(np.abs(lo), np.abs(hi))
    pad = mag * BOX_PAD_REL + BOX_PAD_ABS
    return lo - pad, hi + pad


def make_cull(v0, v1, v2) -> Cull:
    """Chunks of the triangles (each (T, 3) float64 numpy) in Morton order
    of their centroids, with their padded boxes."""
    t = v0.shape[0]
    tri_lo = np.minimum(np.minimum(v0, v1), v2)
    tri_hi = np.maximum(np.maximum(v0, v1), v2)
    cen = (v0 + v1 + v2) / 3.0
    span = np.maximum(cen.max(0) - cen.min(0), 1e-30)
    q = np.clip(((cen - cen.min(0)) / span * 1023).astype(np.int64), 0, 1023)
    code = np.zeros(t, np.int64)
    for bit in range(10):
        for ax in range(3):
            code |= ((q[:, ax] >> bit) & 1) << (3 * bit + ax)
    order = np.argsort(code, kind="stable")
    c = -(-t // CHUNK)
    ids = np.full(c * CHUNK, -1, np.int64)
    ids[:t] = order
    ids = ids.reshape(c, CHUNK)
    lo = np.full((c, 3), np.inf)
    hi = np.full((c, 3), -np.inf)
    for k in range(c):
        row = ids[k][ids[k] >= 0]
        lo[k], hi[k] = tri_lo[row].min(0), tri_hi[row].max(0)
    lo, hi = _pad(lo, hi)
    blo, bhi = _pad(tri_lo.min(0), tri_hi.max(0))
    f = torch.float64
    return Cull(torch.as_tensor(ids), torch.as_tensor(lo, dtype=f),
                torch.as_tensor(hi, dtype=f), torch.as_tensor(blo, dtype=f),
                torch.as_tensor(bhi, dtype=f))


@dataclass
class MeshScene:
    """A reference scene (``scenes.RefScene``) and the ``Cull`` of its
    triangles."""
    sc: scenes.RefScene
    cull: Cull

    def to(self, device=None, dtype=None) -> "MeshScene":
        return MeshScene(self.sc.to(device, dtype), self.cull.to(device))


def build(config: dict, data_root: Path) -> MeshScene:
    """The reference scene of a ``"primitives"`` configuration whose
    ``meshes`` are read by ``read_obj`` (float64, on the CPU), its camera
    at the configuration's aspect ratio. Sets the card's float32 matrix
    products to full precision (no TF32), as every reference must."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = dict(config["scene"])
    meshes = spec.pop("meshes", [])
    b = scenes._Builder()
    camera = scenes._primitives_scene(b, spec, data_root)
    for mesh in meshes:
        pos, faces, nrm = read_obj(data_root / mesh["obj"])
        pos = pos * float(mesh["scale"]) + np.array(scenes._vec(
            mesh["translate"]))
        m = b.material(spec["materials"][mesh["material"]])
        for f in faces:
            b.tri.append((pos[f[0]], pos[f[1]], pos[f[2]], nrm[f], m))
    sc = b.compile(camera, config["width"] / config["height"])
    v0 = sc.tri_v0.numpy()
    return MeshScene(sc, make_cull(v0, v0 + sc.tri_e1.numpy(),
                                   v0 + sc.tri_e2.numpy()))


def _slab(o, d, lo, hi, t0, t1):
    """Whether each ray's segment [t0, t1] meets its box [lo, hi]
    (inclusive); float64. ``o``, ``d`` (N, 3), ``lo``, ``hi`` (N, 3) or
    (3,), ``t0``, ``t1`` (N,). An axis the ray runs parallel to passes
    where the origin lies within the slab."""
    par = d == 0
    inv = 1.0 / torch.where(par, 1.0, d)
    a = (lo - o) * inv
    b = (hi - o) * inv
    inside = (o >= lo) & (o <= hi)
    tn = torch.where(par, torch.where(inside, -math.inf, math.inf),
                     torch.minimum(a, b)).amax(-1)
    tf = torch.where(par, torch.where(inside, math.inf, -math.inf),
                     torch.maximum(a, b)).amin(-1)
    return (tn <= tf) & (tn <= t1) & (tf >= t0)


def closest(ms: MeshScene, o, d, t_min, t_max=math.inf):
    """``render.closest(ms.sc, o, d, t_min, t_max)``, with the triangles
    culled by chunk: (t (N,), +inf on a miss; kind 0 sphere, 1 rect, 2
    triangle; index; the triangle's barycentrics b1, b2, 0 off a
    triangle)."""
    sc = ms.sc
    n, dev, dt = o.shape[0], o.device, o.dtype
    counts = [sc.sph_r.shape[0], sc.rect_k.shape[0]]
    parts = []
    if counts[0]:
        parts.append(render._sphere_t(sc, o, d, t_min, t_max))
    if counts[1]:
        parts.append(render._rect_t(sc, o, d, t_min, t_max))
    kinds = torch.cat([torch.full((c,), k, dtype=torch.int64, device=dev)
                       for k, c in enumerate(counts) if c])
    starts = torch.tensor([0, counts[0]], device=dev)
    t, j = torch.cat(parts, 1).min(1)
    kind = kinds[j]
    idx = j - starts[kind]
    b1 = torch.zeros((n,), dtype=dt, device=dev)
    b2 = torch.zeros_like(b1)
    if not sc.tri_m.shape[0]:
        return t, kind, idx, b1, b2
    tt, ti, tb1, tb2 = _triangles(sc, ms.cull, o, d, t_min,
                                  torch.clamp(t, max=t_max))
    win = tt < t           # the spheres and rects come first on a tie
    return (torch.where(win, tt, t), torch.where(win, 2, kind),
            torch.where(win, ti, idx), torch.where(win, tb1, b1),
            torch.where(win, tb2, b2))


def _triangles(sc, cu: Cull, o, d, t_min, t_best):
    """The nearest triangle hit of each ray in (t_min, t_best), over the
    chunks its segment [t_min, t_best] reaches: (t, +inf where none; scene
    index, the lowest on a tie; b1, b2)."""
    n, dev, dt = o.shape[0], o.device, o.dtype
    o64, d64 = o.double(), d.double()
    t0 = torch.full((n,), float(t_min), dtype=torch.float64, device=dev)
    t1 = t_best.double()
    best_t = torch.full((n,), math.inf, dtype=dt, device=dev)
    best_i = torch.full((n,), NO_INDEX, dtype=torch.int64, device=dev)
    best_b1 = torch.zeros((n,), dtype=dt, device=dev)
    best_b2 = torch.zeros_like(best_b1)
    rays = _slab(o64, d64, cu.box_lo, cu.box_hi, t0, t1).nonzero()[:, 0]
    step = max(1, BOX_TESTS // cu.lo.shape[0])
    pairs = []          # (ray, chunk) for every chunk box a segment meets
    for a in range(0, rays.shape[0], step):
        r = rays[a:a + step]
        ok = _slab(o64[r, None], d64[r, None], cu.lo[None], cu.hi[None],
                   t0[r, None], t1[r, None])
        pr, pc = ok.nonzero(as_tuple=True)
        pairs.append((r[pr], pc))
    step = max(1, PAIR_TRIS // cu.ids.shape[1])
    for r_all, c_all in pairs:
        for a in range(0, r_all.shape[0], step):
            r = r_all[a:a + step]
            ids = cu.ids[c_all[a:a + step]]                  # (P, CHUNK)
            tt, b1, b2 = _pair_t(sc, o[r], d[r], torch.clamp(ids, min=0),
                                 t_min, t_best[r])
            tt = torch.where(ids >= 0, tt, math.inf)
            # each pair's nearest hit, the lowest index on a tie
            m = tt.amin(1)
            col = torch.argmin(torch.where(tt == m[:, None], ids, NO_INDEX),
                               1)[:, None]
            pick = ids.gather(1, col)[:, 0]
            pb1, pb2 = b1.gather(1, col)[:, 0], b2.gather(1, col)[:, 0]
            # then each ray's over its pairs and what it holds: nearer, or
            # as near with a lower index (a triangle lies in one chunk, so
            # no pair repeats one)
            new_t = best_t.scatter_reduce(0, r, m, "amin")
            at = m == new_t[r]
            new_i = torch.where(best_t == new_t, best_i, NO_INDEX)
            new_i = new_i.scatter_reduce(0, r, torch.where(at, pick,
                                                           NO_INDEX), "amin")
            won = at & (pick == new_i[r])
            best_b1[r[won]] = pb1[won]
            best_b2[r[won]] = pb2[won]
            best_t, best_i = new_t, new_i
    return best_t, torch.clamp(best_i, max=sc.tri_m.shape[0] - 1), \
        best_b1, best_b2


def _pair_t(sc, o, d, tid, t_min, t_max):
    """``render._tri_t`` of rays ``o``, ``d`` (P, 3) against the
    triangles ``tid`` (P, K): (t, b1, b2), each (P, K)."""
    e1, e2, v0 = sc.tri_e1[tid], sc.tri_e2[tid], sc.tri_v0[tid]
    pvec = torch.linalg.cross(d[:, None].expand(-1, tid.shape[1], -1), e2,
                              dim=-1)
    det = render.dot(pvec, e1)
    safe = det.abs() > 1e-12
    inv = 1.0 / torch.where(safe, det, 1.0)
    tvec = o[:, None] - v0
    b1 = render.dot(tvec, pvec) * inv
    qvec = torch.linalg.cross(tvec, e1, dim=-1)
    b2 = render.dot(d[:, None], qvec) * inv
    t = render.dot(e2, qvec) * inv
    ok = (safe & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1) & (t > t_min)
          & (t < t_max[:, None]))
    return torch.where(ok, t, math.inf), b1, b2


RAYS_A_BLOCK = 1 << 20


def hit(ms: MeshScene, o, d, t_min):
    """``render.hit`` through ``closest``: (valid, p, normal flipped
    against the ray, front face, material)."""
    sc = ms.sc
    outs = [closest(ms, o[a:a + RAYS_A_BLOCK], d[a:a + RAYS_A_BLOCK], t_min)
            for a in range(0, o.shape[0], RAYS_A_BLOCK)]
    t, kind, idx, b1, b2 = (torch.cat([x[i] for x in outs])
                            for i in range(5))
    valid = torch.isfinite(t)
    p = o + torch.where(valid, t, 0.0)[:, None] * d
    nrm = torch.zeros_like(p)
    mat = torch.zeros_like(idx)
    if sc.sph_r.shape[0]:
        i = torch.clamp(idx, 0, sc.sph_r.shape[0] - 1)
        sel = kind == 0
        nrm = torch.where(sel[:, None],
                          (p - sc.sph_c[i]) / sc.sph_r[i][:, None], nrm)
        mat = torch.where(sel, sc.sph_m[i], mat)
    if sc.rect_k.shape[0]:
        i = torch.clamp(idx, 0, sc.rect_k.shape[0] - 1)
        sel = kind == 1
        one = torch.nn.functional.one_hot(sc.rect_axis[i], 3).to(p.dtype)
        nrm = torch.where(sel[:, None], one, nrm)
        mat = torch.where(sel, sc.rect_m[i], mat)
    if sc.tri_m.shape[0]:
        i = torch.clamp(idx, 0, sc.tri_m.shape[0] - 1)
        sel = kind == 2
        tn = sc.tri_n[i]
        interp = ((1 - b1 - b2)[:, None] * tn[:, 0] + b1[:, None] * tn[:, 1]
                  + b2[:, None] * tn[:, 2])
        nrm = torch.where(sel[:, None], interp, nrm)
        mat = torch.where(sel, sc.tri_m[i], mat)
    front = render.dot(d, nrm) < 0
    nrm = render.unit(torch.where(front[:, None], nrm, -nrm))
    return valid, p, nrm, front, mat
