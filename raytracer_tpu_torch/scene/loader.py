"""Scene loader for the reference's declarative scene files.

The reference ships ``data/*.json`` / ``data/*.yaml`` (course Track-5
inputs) but contains **no parser for them** (SURVEY.md §2.21) — the
benchmark configurations nevertheless name them, so this loader is
first-class new work. Schema (reverse-engineered from the files themselves):

- top level: ``{objects, camera}``
- objects: tagged union by ``"type"``:
  - ``HitableList {items: [...]}``
  - ``BVHNode {left, right, bounding_box}`` — a pre-baked tree; we treat it
    as *grouping only* and rebuild our own acceleration structure (the
    file's bounding_box is redundant, it is recomputable)
  - ``Sphere {center{x,y,z}, radius, material}``
  - ``MovingSphere {center0, center1, radius, material}`` (extension — the
    reference files have no motion, SURVEY.md §8; also accepted as a plain
    Sphere with a ``center1`` key; center0 at t=0, center1 at t=1, sampled
    over the camera ``time0``/``time1`` shutter)
- materials: ``Lambertian {albedo: <texture>}``, ``Metal {albedo: {x,y,z},
  fuzz}``, ``Dielectric {ref_idx}`` (no tint -> white),
  ``DiffuseLight {emit: <texture>}``
- textures: ``ConstantTexture {color{x,y,z}}``, ``CheckerTexture {t0, t1}``
- camera: ``{look_from, look_at, vup, vfov, aspect, aperture, focus_dist}``
  (+ optional ``time0``/``time1`` shutter window, extension)

``data/test.json`` uses a variant schema (``object_type`` key, no material);
we accept it with a default gray Lambertian.

DiffuseLight spheres additionally register as photon-emitting lights
(SphereDiffuseLight semantics, light.rs:67-125) so the SPPM integrator works
on these scenes; flux is the emit texture's mean color, scale 1. Under
``--nee`` that mean-flux record is exact only for CONSTANT emit textures
(the shadow-ray estimator uses flux as Le while BRDF sampling sees the
actual texture — see ops/nee.py::direct_light's contract); a checker emit
would bias --nee renders, so plain PT/SPPM should be used for those.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from raytracer_tpu_torch.scene.builder import SceneBuilder
from raytracer_tpu_torch.scene.types import Scene


def _vec(d) -> tuple:
    return (float(d["x"]), float(d["y"]), float(d["z"]))


class _Loader:
    def __init__(self):
        self.b = SceneBuilder()
        self._mat_cache = {}
        self._tex_cache = {}

    # -- textures ---------------------------------------------------------
    def texture(self, spec) -> int:
        key = json.dumps(spec, sort_keys=True)
        if key not in self._tex_cache:
            kind = spec["type"]
            if kind == "ConstantTexture":
                tid = self.b.constant_texture(_vec(spec["color"]))
            elif kind == "CheckerTexture":
                t0 = spec["t0"]["color"]
                t1 = spec["t1"]["color"]
                tid = self.b.checker_texture(_vec(t0), _vec(t1))
            else:
                raise ValueError(f"unknown texture type {kind!r}")
            self._tex_cache[key] = tid
        return self._tex_cache[key]

    def _texture_mean_color(self, spec) -> tuple:
        if spec["type"] == "ConstantTexture":
            return _vec(spec["color"])
        if spec["type"] == "CheckerTexture":
            a = _vec(spec["t0"]["color"])
            b = _vec(spec["t1"]["color"])
            return tuple((x + y) / 2 for x, y in zip(a, b))
        raise ValueError(spec["type"])

    # -- materials --------------------------------------------------------
    def material(self, spec) -> tuple:
        """Returns (mat_id, emissive_mean or None)."""
        key = json.dumps(spec, sort_keys=True)
        if key not in self._mat_cache:
            kind = spec["type"]
            emissive = None
            if kind == "Lambertian":
                mid = self.b.lambertian(self.texture(spec["albedo"]))
            elif kind == "Metal":
                # Metal albedo is an inline color, not a texture node
                tid = self.b.constant_texture(_vec(spec["albedo"]))
                mid = self.b.metal(tid, float(spec.get("fuzz", 0.0)))
            elif kind == "Dielectric":
                mid = self.b.dielectric(float(spec["ref_idx"]))
            elif kind == "DiffuseLight":
                mid = self.b.diffuse_light(self.texture(spec["emit"]))
                emissive = self._texture_mean_color(spec["emit"])
            else:
                raise ValueError(f"unknown material type {kind!r}")
            self._mat_cache[key] = (mid, emissive)
        return self._mat_cache[key]

    # -- objects ----------------------------------------------------------
    def obj(self, spec):
        kind = spec.get("type") or spec.get("object_type")
        if kind == "HitableList":
            for item in spec["items"]:
                self.obj(item)
        elif kind == "BVHNode":
            # pre-baked tree: grouping only; bounding_box ignored/rebuilt
            self.obj(spec["left"])
            if spec.get("right") is not None and spec["right"] != spec["left"]:
                self.obj(spec["right"])
        elif kind in ("Sphere", "MovingSphere"):
            if "material" in spec:
                mid, emissive = self.material(spec["material"])
            else:  # test.json variant has no material
                mid, emissive = self.b.lambertian(
                    self.b.constant_texture((0.5, 0.5, 0.5))), None
            radius = float(spec["radius"])
            # extension schema: MovingSphere {center0, center1} or a plain
            # Sphere with a center1 key — center0 at t=0, center1 at t=1,
            # sampled over the camera shutter [time0, time1]
            # (builder.add_moving_sphere semantics; the reference files
            # have no motion, SURVEY.md §8)
            if kind == "MovingSphere" or "center1" in spec:
                c0 = _vec(spec.get("center0") or spec["center"])
                c1 = _vec(spec["center1"])
                self.b.add_moving_sphere(c0, c1, radius, mid)
                center = c0
            else:
                center = _vec(spec["center"])
                self.b.add_sphere(center, radius, mid)
            if emissive is not None and any(c > 0 for c in emissive):
                # moving emitters register their velocity so NEE samples
                # the center at the shadow ray's time (c0 + (c1-c0)*t)
                vel = (tuple(b - a for a, b in zip(center, _vec(spec["center1"])))
                       if (kind == "MovingSphere" or "center1" in spec)
                       else (0.0, 0.0, 0.0))
                self.b._push_light(0, center, (0, 0, 0), radius, emissive,
                                   1.0, vel=vel)
        elif kind is None and isinstance(spec, list):
            for item in spec:
                self.obj(item)
        else:
            raise ValueError(f"unknown object type {kind!r}")


def load_scene(path: str, aspect_ratio: Optional[float] = None) -> Scene:
    """Load a JSON or YAML scene file into a compiled Scene."""
    ext = os.path.splitext(path)[1].lower()
    with open(path, "r") as f:
        if ext in (".yaml", ".yml"):
            import yaml
            doc = yaml.safe_load(f)
        else:
            doc = json.load(f)

    ld = _Loader()
    objs = doc["objects"]
    if isinstance(objs, list):  # test.json variant
        for item in objs:
            ld.obj(item)
    else:
        ld.obj(objs)

    cam = doc["camera"]
    ld.b.set_camera(
        look_from=_vec(cam["look_from"]), look_at=_vec(cam["look_at"]),
        vup=_vec(cam["vup"]), vfov=float(cam["vfov"]),
        aspect_ratio=float(cam.get("aspect", 1.0)),
        aperture=float(cam.get("aperture", 0.0)),
        focus_dist=float(cam.get("focus_dist", 10.0)),
        time0=float(cam.get("time0", 0.0)),
        time1=float(cam.get("time1", 0.0)))
    return ld.b.compile(aspect_ratio=aspect_ratio)
