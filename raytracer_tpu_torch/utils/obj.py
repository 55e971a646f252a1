"""Wavefront OBJ parsing (host-side IO; replaces the ``tobj`` dependency,
mesh.rs:149-158 — load options: triangulate=true, single_index=true, and the
reference reads only ``models[0]``, i.e. the first object/group).

Pure Python: this is file IO, not compute — parse time is negligible next
to render time for every shipped mesh (bun315.obj, 4968 tris, parses in
~10 ms), so no native fast path is warranted.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class ObjMesh(NamedTuple):
    positions: np.ndarray           # (V, 3) f32
    indices: np.ndarray             # (T, 3) int32 (triangulated, fan)
    normals: Optional[np.ndarray]   # (V, 3) f32 or None (per-position)
    texcoords: Optional[np.ndarray]  # (V, 2) f32 or None


def load_obj(path: str, first_object_only: bool = True) -> ObjMesh:
    """Parse an OBJ file. With ``first_object_only`` (the reference's
    ``models[0]`` behavior, mesh.rs:159), parsing stops at the second
    ``o``/``g`` statement that follows face data.

    single_index semantics (tobj): each unique (v, vt, vn) triple becomes one
    output vertex; positions/normals/texcoords are re-indexed together.
    """
    positions, texcoords, normals = [], [], []
    faces = []  # list of triples of (v, vt, vn) string keys
    seen_faces = False
    n_groups = 0

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                positions.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("vt "):
                parts = line.split()
                texcoords.append((float(parts[1]), float(parts[2])))
            elif line.startswith("vn "):
                parts = line.split()
                normals.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith(("o ", "g ")):
                if seen_faces:
                    n_groups += 1
                    if first_object_only:
                        break
            elif line.startswith("f "):
                seen_faces = True
                verts = line.split()[1:]
                # triangulate as a fan (tobj triangulate=true)
                for i in range(1, len(verts) - 1):
                    faces.append((verts[0], verts[i], verts[i + 1]))

    pos = np.asarray(positions, np.float32)
    tex = np.asarray(texcoords, np.float32) if texcoords else None
    nrm = np.asarray(normals, np.float32) if normals else None

    def parse_ref(ref: str, count: int, which: int):
        parts = ref.split("/")
        if which >= len(parts) or parts[which] == "":
            return -1
        idx = int(parts[which])
        return idx - 1 if idx > 0 else count + idx

    # single-index rebuild: unique (v, vt, vn) triples
    remap = {}
    out_pos, out_tex, out_nrm, out_idx = [], [], [], []
    for tri in faces:
        tri_out = []
        for ref in tri:
            v = parse_ref(ref, len(pos), 0)
            vt = parse_ref(ref, len(tex) if tex is not None else 0, 1)
            vn = parse_ref(ref, len(nrm) if nrm is not None else 0, 2)
            key = (v, vt, vn)
            if key not in remap:
                remap[key] = len(out_pos)
                out_pos.append(pos[v])
                out_tex.append(tex[vt] if (tex is not None and vt >= 0) else (0.0, 0.0))
                out_nrm.append(nrm[vn] if (nrm is not None and vn >= 0) else None)
            tri_out.append(remap[key])
        out_idx.append(tri_out)

    has_normals = nrm is not None and all(x is not None for x in out_nrm)
    return ObjMesh(
        positions=np.asarray(out_pos, np.float32).reshape(-1, 3),
        indices=np.asarray(out_idx, np.int32).reshape(-1, 3),
        normals=(np.asarray(out_nrm, np.float32).reshape(-1, 3)
                 if has_normals else None),
        texcoords=np.asarray(out_tex, np.float32).reshape(-1, 2),
    )
