"""Scene representation: flat struct-of-arrays tables of torch tensors.

The PyTorch counterpart of ``raytracer_tpu/scene/types.py``. Field names,
kind codes and table layouts are the same, so code that reads a scene by
field name (``tests/oracle_np.py::NpScene``) reads either package's scene.
Every record is a ``NamedTuple`` of tensors with a ``.to(device)`` that
moves the whole record, nested records included.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# Material kinds (material.rs concrete impls)
MAT_LAMBERTIAN = 0     # material.rs:89-113
MAT_METAL = 1          # material.rs:115-139
MAT_DIELECTRIC = 2     # material.rs:141-188
MAT_DIFFUSE_LIGHT = 3  # material.rs:191-212 (emits AND scatters diffusely)
MAT_ISOTROPIC = 4      # material.rs:213-231

# Texture kinds (material.rs:48-84; NOISE is an extension)
TEX_CONSTANT = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_NOISE = 3

# Light kinds (light.rs)
LIGHT_SPHERE = 0       # SphereDiffuseLight light.rs:67-125
LIGHT_XZRECT = 1       # XZRectLight light.rs:127-184

# Primitive type codes
PRIM_SPHERE = 0
PRIM_RECT = 1
PRIM_TRIANGLE = 2
PRIM_MEDIA = 3

# Interaction codes (material.rs:10-16)
INTER_DIFFUSE = 0
INTER_SPECULAR = 1
INTER_ABSORB = 2
INTER_REFLECT = 3
INTER_REFRACT = 4


def tree_to(rec, device):
    """Move every tensor of a (nested) NamedTuple record to ``device``;
    ``None`` fields stay ``None``."""
    if rec is None:
        return None
    if isinstance(rec, torch.Tensor):
        return rec.to(device)
    return type(rec)(*(tree_to(x, device) for x in rec))


def _i32(n=0):
    return torch.zeros((n,), dtype=torch.int32)


class Textures(NamedTuple):
    """Texture table (material.rs:48-84). The checker is world-space: the
    sign of sin(10x)sin(10y)sin(10z) picks color0 (<0) else color1."""
    kind: torch.Tensor      # (T,) int32
    color0: torch.Tensor    # (T, 3)  (noise textures keep their scale in [.,0])
    color1: torch.Tensor    # (T, 3)
    image_id: torch.Tensor  # (T,) int32 (-1 if none)
    noise_marker: torch.Tensor = _i32()  # (1,) if any noise texture else (0,)


class Materials(NamedTuple):
    """Material table (material.rs:21-212). ``tex_id`` is the albedo texture,
    or the emit texture for diffuse lights."""
    kind: torch.Tensor    # (M,) int32
    tex_id: torch.Tensor  # (M,) int32
    fuzz: torch.Tensor    # (M,)
    ir: torch.Tensor      # (M,)


class Spheres(NamedTuple):
    """Sphere table (sphere.rs:8-12); ``velocity`` is the motion-blur
    extension, ``motion_marker`` is (1,) if any sphere moves."""
    center: torch.Tensor  # (S, 3)
    radius: torch.Tensor  # (S,)
    mat_id: torch.Tensor  # (S,) int32
    velocity: torch.Tensor = torch.zeros((0, 3))
    motion_marker: torch.Tensor = _i32()


class Rects(NamedTuple):
    """Axis-aligned rectangles; (a, b) are the two in-plane axes in
    ascending order (rectangle.rs:32,70,107)."""
    axis: torch.Tensor    # (R,) int32: 0 => x=k, 1 => y=k, 2 => z=k
    k: torch.Tensor
    a0: torch.Tensor
    a1: torch.Tensor
    b0: torch.Tensor
    b1: torch.Tensor
    mat_id: torch.Tensor  # (R,) int32


class Triangles(NamedTuple):
    """Triangle soup with precomputed edges and per-corner normals
    (mesh.rs:56-137)."""
    v0: torch.Tensor      # (T, 3)
    e1: torch.Tensor      # (T, 3)
    e2: torch.Tensor      # (T, 3)
    n0: torch.Tensor      # (T, 3)
    n1: torch.Tensor      # (T, 3)
    n2: torch.Tensor      # (T, 3)
    mat_id: torch.Tensor  # (T,) int32


class Lights(NamedTuple):
    """Emitter table (light.rs:61-235)."""
    kind: torch.Tensor      # (L,) int32
    p0: torch.Tensor        # (L, 3)
    p1: torch.Tensor        # (L, 3)
    r0: torch.Tensor        # (L,)
    flux: torch.Tensor      # (L, 3)
    scale: torch.Tensor     # (L,)
    prob: torch.Tensor      # (L,)
    log_prob: torch.Tensor  # (L,)
    vel: torch.Tensor       # (L, 3)


class Camera(NamedTuple):
    """Thin-lens camera, precomputed like camera.rs:24-55."""
    origin: torch.Tensor             # (3,)
    lower_left_corner: torch.Tensor  # (3,)
    horizontal: torch.Tensor         # (3,)
    vertical: torch.Tensor           # (3,)
    u: torch.Tensor                  # (3,)
    v: torch.Tensor                  # (3,)
    w: torch.Tensor                  # (3,)
    lens_radius: torch.Tensor        # ()
    time0: torch.Tensor = torch.tensor(0.0)
    time1: torch.Tensor = torch.tensor(0.0)


class Media(NamedTuple):
    """Constant-density volumes (medium.rs:7-61). The port builds the table
    so that scenes with media are recognised; rendering them is still to
    be ported."""
    kind: torch.Tensor             # (V,) int32: 0 sphere, 1 box
    p0: torch.Tensor               # (V, 3)
    p1: torch.Tensor               # (V, 3)
    r0: torch.Tensor               # (V,)
    neg_inv_density: torch.Tensor  # (V,)
    mat_id: torch.Tensor           # (V,) int32


class BVH(NamedTuple):
    """Flat BVH over the unified primitive list (field names only: the port
    does not build one yet)."""
    node_min: torch.Tensor
    node_max: torch.Tensor
    left: torch.Tensor
    right: torch.Tensor
    is_leaf: torch.Tensor
    prim_type: torch.Tensor
    prim_idx: torch.Tensor


class Scene(NamedTuple):
    """The world: all tables + camera + bounds."""
    spheres: Spheres
    rects: Rects
    triangles: Triangles
    materials: Materials
    textures: Textures
    images: torch.Tensor      # (I, IH, IW, 3) f32 atlas (I may be 0)
    image_wh: torch.Tensor    # (I, 2) int32
    lights: Lights
    camera: Camera
    bounds_min: torch.Tensor  # (3,)
    bounds_max: torch.Tensor  # (3,)
    bvh: Optional[BVH] = None
    media: Optional[Media] = None
    leaf: None = None         # leaf-traversal tables: not ported yet

    @property
    def scale(self):
        """Characteristic scene scale (diagonal length) for f32 epsilons,
        a float32 0-d tensor as in the JAX package."""
        return torch.sqrt(torch.sum((self.bounds_max - self.bounds_min) ** 2))


# every record moves as a whole: ``scene.to("cuda")``
for _rec in (Textures, Materials, Spheres, Rects, Triangles, Lights, Camera,
             Media, BVH, Scene):
    _rec.to = tree_to
