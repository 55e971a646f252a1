"""Scenes of the reference, built from a configuration's ``"scene"``:

- ``{"kind": "json", "file": ...}``: a scene file of the course template
  (``HitableList``/``BVHNode`` of ``Sphere`` with ``Lambertian``,
  ``Metal``, ``Dielectric`` and ``DiffuseLight`` materials, constant and
  checker textures, and a thin-lens camera). An emitting sphere is also a
  light whose flux is its texture's mean colour, at scale 1.
- ``{"kind": "primitives", ...}``: named materials, rects, spheres, rect
  lights (a light record and its emitting rect), OBJ meshes under a scale
  and a translation, boxes (six rects) and a camera.

Semantics, from the reference renderer (material.rs, camera.rs, hit.rs):
the checker picks colour 0 where sin(10x) sin(10y) sin(10z) < 0; a
dielectric without a tint is white; a diffuse light emits its texture on
both faces and scatters as a diffuse surface with attenuation 1/pi.
Every field is a tensor on the scene's device in the scene's dtype."""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, fields
from pathlib import Path

import numpy as np
import torch

LAMBERTIAN, METAL, DIELECTRIC, LIGHT = 0, 1, 2, 3
CONST, CHECKER = 0, 1
SPHERE_LIGHT, RECT_LIGHT = 0, 1
PLANES = {"yz": 0, "xz": 1, "xy": 2}     # the rect's normal axis


@dataclass
class RefScene:
    # spheres (S)
    sph_c: torch.Tensor
    sph_r: torch.Tensor
    sph_m: torch.Tensor
    # rects (R): normal axis, plane offset, in-plane bounds (a < b axes)
    rect_axis: torch.Tensor
    rect_k: torch.Tensor
    rect_lo: torch.Tensor     # (R, 2)
    rect_hi: torch.Tensor     # (R, 2)
    rect_m: torch.Tensor
    # triangles (T)
    tri_v0: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_n: torch.Tensor       # (T, 3, 3) vertex normals
    tri_m: torch.Tensor
    # materials (M)
    mat_kind: torch.Tensor
    mat_tex: torch.Tensor     # CONST or CHECKER
    mat_c0: torch.Tensor      # (M, 3)
    mat_c1: torch.Tensor
    mat_fuzz: torch.Tensor
    mat_ir: torch.Tensor
    # lights (L)
    light_kind: torch.Tensor
    light_p0: torch.Tensor    # sphere: centre; rect: (x0, y, z0)
    light_p1: torch.Tensor    # rect: (x1, y, z1)
    light_r: torch.Tensor
    light_power: torch.Tensor  # (L, 3) flux x scale
    # camera
    cam_origin: torch.Tensor
    cam_llc: torch.Tensor
    cam_h: torch.Tensor
    cam_v: torch.Tensor
    cam_lu: torch.Tensor      # the lens's axes (camera u and v)
    cam_lv: torch.Tensor
    lens_radius: float
    scale: float              # the bounds' diagonal
    bounds_lo: tuple = (0.0, 0.0, 0.0)
    bounds_hi: tuple = (1.0, 1.0, 1.0)

    def to(self, device=None, dtype=None) -> "RefScene":
        out = {}
        for f in fields(self):
            x = getattr(self, f.name)
            if torch.is_tensor(x):
                x = x.to(device=device)
                if dtype is not None and x.is_floating_point():
                    x = x.to(dtype)
            out[f.name] = x
        return RefScene(**out)

    def counts(self) -> dict:
        return {"spheres": int(self.sph_r.shape[0]),
                "rects": int(self.rect_k.shape[0]),
                "triangles": int(self.tri_m.shape[0])}


class _Builder:
    def __init__(self):
        self.sph, self.rect, self.tri, self.mats, self.lights = \
            [], [], [], [], []
        self._mat_ids = {}

    def material(self, spec: dict) -> int:
        key = json.dumps(spec, sort_keys=True)
        if key not in self._mat_ids:
            kind = spec["type"]
            fuzz, ir = 0.0, 1.0
            if kind == "Lambertian":
                k, tex = LAMBERTIAN, spec["albedo"]
            elif kind == "Metal":
                k, tex = METAL, spec["albedo"]
                fuzz = float(spec.get("fuzz", 0.0))
            elif kind == "Dielectric":
                k, tex = DIELECTRIC, spec.get("albedo", [1.0, 1.0, 1.0])
                ir = float(spec["ref_idx"])
            elif kind == "DiffuseLight":
                k, tex = LIGHT, spec["emit"]
            else:
                raise ValueError(f"unknown material {kind!r}")
            t, c0, c1 = _texture(tex)
            self.mats.append((k, t, c0, c1, fuzz, ir))
            self._mat_ids[key] = len(self.mats) - 1
        return self._mat_ids[key]

    def compile(self, camera: dict, aspect: float) -> RefScene:
        f = torch.float64

        def t(rows, width, dtype=f):
            return torch.tensor(np.asarray(rows, np.float64).reshape(
                -1, *width) if width else np.asarray(rows, np.float64),
                dtype=dtype)

        i64 = torch.int64
        sph = self.sph
        rect = self.rect
        tri = self.tri
        mats = self.mats
        lights = self.lights
        cam = _camera(camera, aspect)
        lo, hi = _bounds(sph, rect, tri)
        return RefScene(
            sph_c=t([s[0] for s in sph], (3,)),
            sph_r=t([s[1] for s in sph], ()),
            sph_m=torch.tensor([s[2] for s in sph], dtype=i64),
            rect_axis=torch.tensor([r[0] for r in rect], dtype=i64),
            rect_k=t([r[1] for r in rect], ()),
            rect_lo=t([r[2] for r in rect], (2,)),
            rect_hi=t([r[3] for r in rect], (2,)),
            rect_m=torch.tensor([r[4] for r in rect], dtype=i64),
            tri_v0=t([x[0] for x in tri], (3,)),
            tri_e1=t([x[1] - x[0] for x in tri], (3,)),
            tri_e2=t([x[2] - x[0] for x in tri], (3,)),
            tri_n=t([x[3] for x in tri], (3, 3)),
            tri_m=torch.tensor([x[4] for x in tri], dtype=i64),
            mat_kind=torch.tensor([m[0] for m in mats], dtype=i64),
            mat_tex=torch.tensor([m[1] for m in mats], dtype=i64),
            mat_c0=t([m[2] for m in mats], (3,)),
            mat_c1=t([m[3] for m in mats], (3,)),
            mat_fuzz=t([m[4] for m in mats], ()),
            mat_ir=t([m[5] for m in mats], ()),
            light_kind=torch.tensor([x[0] for x in lights], dtype=i64),
            light_p0=t([x[1] for x in lights], (3,)),
            light_p1=t([x[2] for x in lights], (3,)),
            light_r=t([x[3] for x in lights], ()),
            light_power=t([x[4] for x in lights], (3,)),
            lens_radius=cam["lens_radius"],
            scale=float(np.linalg.norm(hi - lo)),
            bounds_lo=tuple(float(x) for x in lo),
            bounds_hi=tuple(float(x) for x in hi),
            **{k: torch.tensor(v, dtype=f) for k, v in cam.items()
               if k != "lens_radius"})


def _vec(v) -> list:
    if isinstance(v, dict):
        return [float(v["x"]), float(v["y"]), float(v["z"])]
    return [float(x) for x in v]


def _texture(spec) -> tuple:
    """(kind, colour 0, colour 1) of a texture: a colour, or a
    ``ConstantTexture``/``CheckerTexture`` node."""
    if isinstance(spec, list) or "x" in spec:
        c = _vec(spec)
        return CONST, c, c
    if spec["type"] == "ConstantTexture":
        c = _vec(spec["color"])
        return CONST, c, c
    if spec["type"] == "CheckerTexture":
        return (CHECKER, _vec(spec["t0"]["color"]),
                _vec(spec["t1"]["color"]))
    raise ValueError(f"unknown texture {spec['type']!r}")


def _camera(spec: dict, aspect: float) -> dict:
    """Thin-lens camera (camera.rs:24-55)."""
    look_from = np.array(_vec(spec["look_from"]))
    look_at = np.array(_vec(spec["look_at"]))
    vup = np.array(_vec(spec["vup"]))
    h = math.tan(math.radians(float(spec["vfov"])) / 2.0)
    vh = 2.0 * h
    vw = aspect * vh
    w = look_from - look_at
    w /= np.linalg.norm(w)
    u = np.cross(vup, w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    focus = float(spec.get("focus_dist", 10.0))
    horizontal = focus * vw * u
    vertical = focus * vh * v
    llc = look_from - horizontal / 2 - vertical / 2 - focus * w
    return {"cam_origin": look_from, "cam_llc": llc, "cam_h": horizontal,
            "cam_v": vertical, "cam_lu": u, "cam_lv": v,
            "lens_radius": float(spec.get("aperture", 0.0)) / 2.0}


def _bounds(sph, rect, tri):
    """The scene's bounding box: spheres' boxes, rects thickened by 1e-4
    along their normal, triangles' vertices."""
    pts = []
    for c, r, _ in sph:
        pts += [np.array(c) - r, np.array(c) + r]
    for axis, k, lo, hi, _ in rect:
        others = [a for a in range(3) if a != axis]
        a = np.zeros(3)
        b = np.zeros(3)
        a[axis], b[axis] = k - 1e-4, k + 1e-4
        a[others], b[others] = lo, hi
        pts += [a, b]
    for v0, v1, v2, _, _ in tri:
        pts += [v0, v1, v2]
    if not pts:
        return np.zeros(3), np.ones(3)
    p = np.array(pts)
    return p.min(0), p.max(0)


def _walk_json(node, out: list):
    kind = node.get("type")
    if kind == "HitableList":
        for item in node["items"]:
            _walk_json(item, out)
    elif kind == "BVHNode":
        _walk_json(node["left"], out)
        if node.get("right") is not None and node["right"] != node["left"]:
            _walk_json(node["right"], out)
    elif kind == "Sphere":
        out.append(node)
    else:
        raise ValueError(f"unknown object {kind!r}")


def _mean_colour(spec) -> list:
    kind, c0, c1 = _texture(spec)
    return [(a + b) / 2 for a, b in zip(c0, c1)]


def _json_scene(b: _Builder, doc: dict) -> dict:
    spheres = []
    _walk_json(doc["objects"], spheres)
    for s in spheres:
        m = b.material(s["material"])
        c, r = _vec(s["center"]), float(s["radius"])
        b.sph.append((c, r, m))
        if s["material"]["type"] == "DiffuseLight":
            flux = _mean_colour(s["material"]["emit"])
            if any(x > 0 for x in flux):
                b.lights.append((SPHERE_LIGHT, c, [0.0, 0.0, 0.0], r, flux))
    return doc["camera"]


def _obj_faces(path: Path):
    """(positions, faces of (v, vn) index triples, normals) of an OBJ
    file's first object, fan-triangulated."""
    pos, nrm, faces, seen = [], [], [], False
    for line in path.read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            pos.append([float(x) for x in parts[1:4]])
        elif parts[0] == "vn":
            nrm.append([float(x) for x in parts[1:4]])
        elif parts[0] in ("o", "g") and seen:
            break
        elif parts[0] == "f":
            seen = True
            refs = [p.split("/") for p in parts[1:]]
            for i in range(1, len(refs) - 1):
                faces.append([refs[0], refs[i], refs[i + 1]])
    return np.array(pos), faces, np.array(nrm)


def _primitives_scene(b: _Builder, spec: dict, data_root: Path) -> dict:
    mats = {name: m for name, m in spec["materials"].items()}

    def mat(name):
        return b.material(mats[name])

    def rect(r, m):
        b.rect.append((PLANES[r["plane"]], float(r["k"]),
                       [float(x) for x in r["lo"]],
                       [float(x) for x in r["hi"]], m))

    for r in spec.get("rects", []):
        rect(r, mat(r["material"]))
    for s in spec.get("spheres", []):
        b.sph.append((_vec(s["center"]), float(s["radius"]),
                      mat(s["material"])))
    for lt in spec.get("rect_lights", []):
        if lt["plane"] != "xz":
            raise ValueError("rect lights lie in an xz plane")
        rect(lt, mat(lt["material"]))
        y = float(lt["k"])
        (x0, z0), (x1, z1) = lt["lo"], lt["hi"]
        b.lights.append((RECT_LIGHT, [x0, y, z0], [x1, y, z1], 0.0,
                         [float(c) * float(lt["scale"])
                          for c in lt["flux"]]))
    for mesh in spec.get("meshes", []):
        pos, faces, nrm = _obj_faces(data_root / mesh["obj"])
        sc = float(mesh["scale"])
        tr = np.array(_vec(mesh["translate"]))
        m = mat(mesh["material"])
        for face in faces:
            v = [pos[int(r[0]) - 1] * sc + tr for r in face]
            n = [nrm[int(r[2]) - 1] for r in face]
            b.tri.append((v[0], v[1], v[2], np.array(n), m))
    for box in spec.get("boxes", []):
        (x0, y0, z0), (x1, y1, z1) = box["min"], box["max"]
        m = mat(box["material"])
        for plane, k, lo, hi in (("xy", z1, (x0, y0), (x1, y1)),
                                 ("xy", z0, (x0, y0), (x1, y1)),
                                 ("xz", y1, (x0, z0), (x1, z1)),
                                 ("xz", y0, (x0, z0), (x1, z1)),
                                 ("yz", x1, (y0, z0), (y1, z1)),
                                 ("yz", x0, (y0, z0), (y1, z1))):
            rect({"plane": plane, "k": k, "lo": lo, "hi": hi}, m)
    return spec["camera"]


def build(config: dict, data_root: Path) -> RefScene:
    """The reference scene of ``config`` (float64, on the CPU), its camera
    at the configuration's aspect ratio."""
    spec = config["scene"]
    b = _Builder()
    if spec["kind"] == "json":
        with open(data_root / spec["file"]) as f:
            camera = _json_scene(b, json.load(f))
    elif spec["kind"] == "primitives":
        camera = _primitives_scene(b, spec, data_root)
    else:
        raise ValueError(f"unknown scene kind {spec['kind']!r}")
    return b.compile(camera, config["width"] / config["height"])
