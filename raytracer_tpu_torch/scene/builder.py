"""Host-side scene construction and compilation to device tables.

This is the framework's "scene compiler": the reference builds an
``Arc<dyn Hitable>`` graph at startup (scene.rs, world.rs); we accumulate
primitives/materials/textures/lights in numpy lists and ``compile()`` them
into the flat :class:`~raytracer_tpu_torch.scene.types.Scene` record of
torch tensors (the PyTorch counterpart of ``raytracer_tpu/scene/builder.py``:
the same numpy arithmetic, so both packages build equal tables). Compound
objects are flattened here, at compile time:

- Cube -> 6 axis rects                      (cube.rs:16-60)
- Transform(mesh) -> baked vertex transform (transform.rs:152-165; every
  reference scene is static, so baking is exact)
- Mesh -> triangle soup rows                (mesh.rs:144-196)

Tables are built on the CPU; ``scene.to(device)`` moves them.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from raytracer_tpu_torch.scene import types as T

F = np.float32
I = np.int32


def trs_matrix(rotate_deg, scale, translate) -> np.ndarray:
    """T * S * Rx * Ry * Rz, the reference's composition order
    (transform.rs:28-106; note S and R commute only for uniform scale,
    matching how the reference composes them)."""
    rx, ry, rz = [math.radians(a) for a in rotate_deg]

    def rot_x(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], F)

    def rot_y(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], F)

    def rot_z(a):
        c, s = math.cos(a), math.sin(a)
        return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], F)

    s_mat = np.diag([scale[0], scale[1], scale[2], 1.0]).astype(F)
    t_mat = np.eye(4, dtype=F)
    t_mat[:3, 3] = translate
    return t_mat @ s_mat @ rot_x(rx) @ rot_y(ry) @ rot_z(rz)


class SceneBuilder:
    """Accumulates scene entities; ``compile()`` emits the tensor tables."""

    def __init__(self):
        self._tex = {"kind": [], "color0": [], "color1": [], "image_id": []}
        self._mat = {"kind": [], "tex_id": [], "fuzz": [], "ir": []}
        self._sph = {"center": [], "radius": [], "mat_id": [], "velocity": []}
        self._rect = {"axis": [], "k": [], "a0": [], "a1": [], "b0": [], "b1": [], "mat_id": []}
        self._tri = {"v0": [], "e1": [], "e2": [], "n0": [], "n1": [], "n2": [], "mat_id": []}
        self._light = {"kind": [], "p0": [], "p1": [], "r0": [], "flux": [],
                       "scale": [], "vel": []}
        self._medium = {"kind": [], "p0": [], "p1": [], "r0": [],
                        "neg_inv_density": [], "mat_id": []}
        self._images = []
        self.camera_params = None

    # ---------------------------------------------------------- textures

    def constant_texture(self, color) -> int:
        return self._push_tex(T.TEX_CONSTANT, color, (0, 0, 0), -1)

    def checker_texture(self, c0, c1) -> int:
        return self._push_tex(T.TEX_CHECKER, c0, c1, -1)

    def image_texture(self, image: np.ndarray) -> int:
        """image: (H, W, 3) uint8 or float in [0,1]."""
        if image.dtype == np.uint8:
            image = image.astype(F) / 255.0
        self._images.append(np.asarray(image, F))
        return self._push_tex(T.TEX_IMAGE, (0, 0, 0), (0, 0, 0), len(self._images) - 1)

    def noise_texture(self, scale: float = 1.0) -> int:
        """Perlin marble texture (an extension; the reference has no Perlin).
        The scale rides in color0[0]."""
        return self._push_tex(T.TEX_NOISE, (scale, 0, 0), (0, 0, 0), -1)

    def _push_tex(self, kind, c0, c1, img) -> int:
        self._tex["kind"].append(kind)
        self._tex["color0"].append(tuple(c0))
        self._tex["color1"].append(tuple(c1))
        self._tex["image_id"].append(img)
        return len(self._tex["kind"]) - 1

    # --------------------------------------------------------- materials

    def lambertian(self, tex_id: int) -> int:
        return self._push_mat(T.MAT_LAMBERTIAN, tex_id, 0.0, 1.0)

    def metal(self, tex_id: int, fuzz: float) -> int:
        return self._push_mat(T.MAT_METAL, tex_id, fuzz, 1.0)

    def dielectric(self, ir: float, tex_id: Optional[int] = None) -> int:
        if tex_id is None:
            tex_id = self.constant_texture((1.0, 1.0, 1.0))
        return self._push_mat(T.MAT_DIELECTRIC, tex_id, 0.0, ir)

    def diffuse_light(self, emit_tex_id: int) -> int:
        return self._push_mat(T.MAT_DIFFUSE_LIGHT, emit_tex_id, 0.0, 1.0)

    def isotropic(self, tex_id: int) -> int:
        return self._push_mat(T.MAT_ISOTROPIC, tex_id, 0.0, 1.0)

    def _push_mat(self, kind, tex_id, fuzz, ir) -> int:
        self._mat["kind"].append(kind)
        self._mat["tex_id"].append(tex_id)
        self._mat["fuzz"].append(fuzz)
        self._mat["ir"].append(ir)
        return len(self._mat["kind"]) - 1

    # -------------------------------------------------------- primitives

    def add_sphere(self, center, radius: float, mat_id: int):
        self._sph["center"].append(tuple(center))
        self._sph["radius"].append(radius)
        self._sph["mat_id"].append(mat_id)
        self._sph["velocity"].append((0.0, 0.0, 0.0))

    def add_moving_sphere(self, center0, center1, radius: float, mat_id: int):
        """Motion-blur sphere: lerps center0 -> center1 over the shutter
        (book-2 MovingSphere semantics; extension — the reference has none)."""
        self._sph["center"].append(tuple(center0))
        self._sph["radius"].append(radius)
        self._sph["mat_id"].append(mat_id)
        self._sph["velocity"].append(tuple(
            c1 - c0 for c0, c1 in zip(center0, center1)))

    def add_rect(self, axis: int, k: float, a0: float, a1: float,
                 b0: float, b1: float, mat_id: int):
        """axis: plane-normal axis (0: x=k YZ-rect, 1: y=k XZ, 2: z=k XY);
        (a, b) are the two in-plane axes in ascending order."""
        for name, val in (("axis", axis), ("k", k), ("a0", a0), ("a1", a1),
                          ("b0", b0), ("b1", b1), ("mat_id", mat_id)):
            self._rect[name].append(val)

    def add_xy_rect(self, x0, y0, x1, y1, z, mat_id):
        self.add_rect(2, z, x0, x1, y0, y1, mat_id)

    def add_xz_rect(self, x0, z0, x1, z1, y, mat_id):
        self.add_rect(1, y, x0, x1, z0, z1, mat_id)

    def add_yz_rect(self, y0, z0, y1, z1, x, mat_id):
        self.add_rect(0, x, y0, y1, z0, z1, mat_id)

    def add_box(self, pmin, pmax, mat_id: int):
        """Six rects, like Cube::new (cube.rs:16-60)."""
        (x0, y0, z0), (x1, y1, z1) = pmin, pmax
        self.add_xy_rect(x0, y0, x1, y1, z1, mat_id)
        self.add_xy_rect(x0, y0, x1, y1, z0, mat_id)
        self.add_xz_rect(x0, z0, x1, z1, y1, mat_id)
        self.add_xz_rect(x0, z0, x1, z1, y0, mat_id)
        self.add_yz_rect(y0, z0, y1, z1, x1, mat_id)
        self.add_yz_rect(y0, z0, y1, z1, x0, mat_id)

    def add_triangles(self, positions: np.ndarray, indices: np.ndarray,
                      mat_id: int, normals: Optional[np.ndarray] = None,
                      transform: Optional[np.ndarray] = None):
        """Triangle soup. positions (V,3), indices (T,3) int. If a 4x4
        ``transform`` is given it is baked into vertices here; normals are
        transformed by the same forward matrix (transform.rs:158 uses the
        forward matrix, not inverse-transpose — exact for the uniform scales
        the reference uses) and re-normalized at hit time."""
        pos = np.asarray(positions, F)
        idx = np.asarray(indices, np.int64)
        if normals is None:
            normals = _vertex_normals(pos, idx)
        nrm = np.asarray(normals, F)
        if transform is not None:
            pos = pos @ transform[:3, :3].T + transform[:3, 3]
            nrm = nrm @ transform[:3, :3].T
        v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
        self._tri["v0"].append(v0)
        self._tri["e1"].append(v1 - v0)
        self._tri["e2"].append(v2 - v0)
        self._tri["n0"].append(nrm[idx[:, 0]])
        self._tri["n1"].append(nrm[idx[:, 1]])
        self._tri["n2"].append(nrm[idx[:, 2]])
        self._tri["mat_id"].append(np.full((len(idx),), mat_id, I))

    # ------------------------------------------------------------- media

    def add_constant_medium_sphere(self, center, radius, density, tex_id):
        """ConstantMedium with a sphere boundary (medium.rs:7-24): the
        boundary is NOT hittable geometry; scattering uses the Isotropic
        phase material."""
        mat = self.isotropic(tex_id)
        self._push_medium(0, center, (0, 0, 0), radius, density, mat)
        return mat

    def add_constant_medium_box(self, pmin, pmax, density, tex_id):
        mat = self.isotropic(tex_id)
        self._push_medium(1, pmin, pmax, 0.0, density, mat)
        return mat

    def _push_medium(self, kind, p0, p1, r0, density, mat_id):
        self._medium["kind"].append(kind)
        self._medium["p0"].append(tuple(p0))
        self._medium["p1"].append(tuple(p1))
        self._medium["r0"].append(r0)
        self._medium["neg_inv_density"].append(-1.0 / density)
        self._medium["mat_id"].append(mat_id)

    # ------------------------------------------------------------ lights

    def add_sphere_light(self, center, radius, flux, scale,
                         center1=None):
        """SphereDiffuseLight (light.rs:67-125): adds BOTH the light record
        and the hitable sphere with a DiffuseLight material. ``center1``
        makes it a MOVING emitter (motion extension): the geometry sweeps
        center->center1 over the shutter and the light record carries the
        same velocity so NEE samples the time-correct position."""
        tex = self.constant_texture(flux)
        mat = self.diffuse_light(tex)
        if center1 is not None:
            self.add_moving_sphere(center, center1, radius, mat)
            vel = tuple(b - a for a, b in zip(center, center1))
        else:
            self.add_sphere(center, radius, mat)
            vel = (0.0, 0.0, 0.0)
        self._push_light(T.LIGHT_SPHERE, center, (0, 0, 0), radius, flux,
                         scale, vel=vel)
        return mat

    def add_xzrect_light(self, x0, z0, x1, z1, y, flux, scale,
                         add_geometry: bool = True):
        """XZRectLight (light.rs:127-184). ``add_geometry`` mirrors the
        Cornell scene re-adding the light as a hitable (scene.rs:86)."""
        tex = self.constant_texture(flux)
        mat = self.diffuse_light(tex)
        if add_geometry:
            self.add_xz_rect(x0, z0, x1, z1, y, mat)
        self._push_light(T.LIGHT_XZRECT, (x0, y, z0), (x1, y, z1), 0.0, flux, scale)
        return mat

    def _push_light(self, kind, p0, p1, r0, flux, scale,
                    vel=(0.0, 0.0, 0.0)):
        self._light["kind"].append(kind)
        self._light["p0"].append(tuple(p0))
        self._light["p1"].append(tuple(p1))
        self._light["r0"].append(r0)
        self._light["flux"].append(tuple(flux))
        self._light["scale"].append(scale)
        self._light["vel"].append(tuple(vel))

    # ------------------------------------------------------------ camera

    def set_camera(self, look_from, look_at, vup=(0.0, 1.0, 0.0), vfov=50.0,
                   aspect_ratio=1.0, aperture=0.0, focus_dist=10.0,
                   time0=0.0, time1=0.0):
        self.camera_params = dict(
            look_from=tuple(look_from), look_at=tuple(look_at), vup=tuple(vup),
            vfov=vfov, aspect_ratio=aspect_ratio, aperture=aperture,
            focus_dist=focus_dist, time0=time0, time1=time1)

    # ----------------------------------------------------------- compile

    def compile(self, aspect_ratio: Optional[float] = None) -> T.Scene:
        has_motion = any(any(v) for v in self._sph["velocity"])
        spheres = T.Spheres(
            center=_arr(self._sph["center"], (0, 3)),
            radius=_arr(self._sph["radius"], (0,)),
            mat_id=_arr(self._sph["mat_id"], (0,), I),
            velocity=_arr(self._sph["velocity"], (0, 3)),
            motion_marker=torch.zeros((1 if has_motion else 0,), dtype=torch.int32),
        )
        rects = T.Rects(
            axis=_arr(self._rect["axis"], (0,), I),
            k=_arr(self._rect["k"], (0,)),
            a0=_arr(self._rect["a0"], (0,)), a1=_arr(self._rect["a1"], (0,)),
            b0=_arr(self._rect["b0"], (0,)), b1=_arr(self._rect["b1"], (0,)),
            mat_id=_arr(self._rect["mat_id"], (0,), I),
        )
        tri_parts = {k: (np.concatenate(v, axis=0) if v else None)
                     for k, v in self._tri.items()}
        triangles = T.Triangles(
            v0=_arr(tri_parts["v0"], (0, 3)), e1=_arr(tri_parts["e1"], (0, 3)),
            e2=_arr(tri_parts["e2"], (0, 3)), n0=_arr(tri_parts["n0"], (0, 3)),
            n1=_arr(tri_parts["n1"], (0, 3)), n2=_arr(tri_parts["n2"], (0, 3)),
            mat_id=_arr(tri_parts["mat_id"], (0,), I),
        )
        materials = T.Materials(
            kind=_arr(self._mat["kind"], (0,), I),
            tex_id=_arr(self._mat["tex_id"], (0,), I),
            fuzz=_arr(self._mat["fuzz"], (0,)),
            ir=_arr(self._mat["ir"], (0,)),
        )
        has_noise = any(k == T.TEX_NOISE for k in self._tex["kind"])
        textures = T.Textures(
            kind=_arr(self._tex["kind"], (0,), I),
            color0=_arr(self._tex["color0"], (0, 3)),
            color1=_arr(self._tex["color1"], (0, 3)),
            image_id=_arr(self._tex["image_id"], (0,), I),
            noise_marker=torch.zeros((1 if has_noise else 0,), dtype=torch.int32),
        )
        images, image_wh = _pack_images(self._images)

        # Power-proportional light pick probs (light.rs:202-216)
        n_l = len(self._light["kind"])
        if n_l:
            flux = np.asarray(self._light["flux"], F)
            scale = np.asarray(self._light["scale"], F)
            powers = np.linalg.norm(flux * scale[:, None], axis=-1)
            prob = powers / powers.sum()
        else:
            prob = np.zeros((0,), F)
        lights = T.Lights(
            kind=_arr(self._light["kind"], (0,), I),
            p0=_arr(self._light["p0"], (0, 3)),
            p1=_arr(self._light["p1"], (0, 3)),
            r0=_arr(self._light["r0"], (0,)),
            flux=_arr(self._light["flux"], (0, 3)),
            scale=_arr(self._light["scale"], (0,)),
            prob=torch.as_tensor(prob),
            log_prob=torch.as_tensor(np.log(np.maximum(prob, 1e-30))),
            vel=_arr(self._light["vel"], (0, 3)),
        )

        cp = self.camera_params or dict(
            look_from=(0, 0, -1), look_at=(0, 0, 0), vup=(0, 1, 0),
            vfov=50.0, aspect_ratio=1.0, aperture=0.0, focus_dist=10.0)
        if aspect_ratio is not None:
            cp = dict(cp, aspect_ratio=aspect_ratio)
        camera = make_camera(**cp)

        media = None
        if self._medium["kind"]:
            media = T.Media(
                kind=_arr(self._medium["kind"], (0,), I),
                p0=_arr(self._medium["p0"], (0, 3)),
                p1=_arr(self._medium["p1"], (0, 3)),
                r0=_arr(self._medium["r0"], (0,)),
                neg_inv_density=_arr(self._medium["neg_inv_density"], (0,)),
                mat_id=_arr(self._medium["mat_id"], (0,), I),
            )

        bmin, bmax = _scene_bounds(spheres, rects, triangles)
        return T.Scene(
            spheres=spheres, rects=rects, triangles=triangles,
            materials=materials, textures=textures,
            images=images, image_wh=image_wh,
            lights=lights, camera=camera,
            bounds_min=torch.as_tensor(bmin), bounds_max=torch.as_tensor(bmax),
            media=media,
        )


def make_camera(look_from, look_at, vup, vfov, aspect_ratio, aperture,
                focus_dist, time0=0.0, time1=0.0) -> T.Camera:
    """Thin-lens precomputation, camera.rs:24-55."""
    look_from = np.asarray(look_from, F)
    look_at = np.asarray(look_at, F)
    vup = np.asarray(vup, F)
    theta = math.radians(vfov)
    h = math.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect_ratio * viewport_height

    w = look_from - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    origin = look_from
    horizontal = focus_dist * viewport_width * u
    vertical = focus_dist * viewport_height * v
    llc = origin - horizontal / 2.0 - vertical / 2.0 - focus_dist * w
    return T.Camera(
        origin=_t(origin), lower_left_corner=_t(llc),
        horizontal=_t(horizontal), vertical=_t(vertical),
        u=_t(u), v=_t(v), w=_t(w),
        lens_radius=_t(np.asarray(aperture / 2.0, F)),
        time0=_t(np.asarray(time0, F)), time1=_t(np.asarray(time1, F)),
    )


def _vertex_normals(pos: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals for OBJ files without normals."""
    fn = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]], pos[idx[:, 2]] - pos[idx[:, 0]])
    out = np.zeros_like(pos)
    for k in range(3):
        np.add.at(out, idx[:, k], fn)
    norms = np.linalg.norm(out, axis=-1, keepdims=True)
    return (out / np.maximum(norms, 1e-12)).astype(F)


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy -> tensor, copied so the table owns its memory."""
    return torch.from_numpy(np.array(a))


def _arr(x, empty_shape, dtype=F):
    if x is None or (hasattr(x, "__len__") and len(x) == 0):
        return _t(np.zeros(empty_shape, dtype))
    return _t(np.asarray(x, dtype))


def _pack_images(images):
    if not images:
        return _t(np.zeros((0, 1, 1, 3), F)), _t(np.zeros((0, 2), I))
    mh = max(im.shape[0] for im in images)
    mw = max(im.shape[1] for im in images)
    packed = np.zeros((len(images), mh, mw, 3), F)
    wh = np.zeros((len(images), 2), I)
    for i, im in enumerate(images):
        packed[i, :im.shape[0], :im.shape[1]] = im
        wh[i] = (im.shape[1], im.shape[0])
    return _t(packed), _t(wh)


def _scene_bounds(spheres: T.Spheres, rects: T.Rects, triangles: T.Triangles):
    mins, maxs = [], []
    if spheres.radius.shape[0]:
        c = np.asarray(spheres.center)
        r = np.asarray(spheres.radius)[:, None]
        mins.append((c - r).min(axis=0))
        maxs.append((c + r).max(axis=0))
    if rects.k.shape[0]:
        axis = np.asarray(rects.axis)
        k = np.asarray(rects.k)
        a0, a1 = np.asarray(rects.a0), np.asarray(rects.a1)
        b0, b1 = np.asarray(rects.b0), np.asarray(rects.b1)
        lo = np.zeros((len(k), 3), F)
        hi = np.zeros((len(k), 3), F)
        for i in range(len(k)):
            ax = axis[i]
            aa, bb = (1, 2) if ax == 0 else ((0, 2) if ax == 1 else (0, 1))
            lo[i, ax] = k[i] - 1e-4
            hi[i, ax] = k[i] + 1e-4
            lo[i, aa], hi[i, aa] = a0[i], a1[i]
            lo[i, bb], hi[i, bb] = b0[i], b1[i]
        mins.append(lo.min(axis=0))
        maxs.append(hi.max(axis=0))
    if triangles.mat_id.shape[0]:
        v0 = np.asarray(triangles.v0)
        v1 = v0 + np.asarray(triangles.e1)
        v2 = v0 + np.asarray(triangles.e2)
        allv = np.concatenate([v0, v1, v2], axis=0)
        mins.append(allv.min(axis=0))
        maxs.append(allv.max(axis=0))
    if not mins:
        return np.zeros(3, F), np.ones(3, F)
    return (np.minimum.reduce(mins).astype(F), np.maximum.reduce(maxs).astype(F))
