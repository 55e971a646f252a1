"""Scene system: tensor tables, host-side builder, loaders, converters."""

from raytracer_tpu_torch.scene.types import (  # noqa: F401
    Camera, Lights, Materials, Rects, Scene, Spheres, Textures, Triangles,
    MAT_LAMBERTIAN, MAT_METAL, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC,
    TEX_CONSTANT, TEX_CHECKER, TEX_IMAGE,
    LIGHT_SPHERE, LIGHT_XZRECT,
    PRIM_SPHERE, PRIM_RECT, PRIM_TRIANGLE,
)
from raytracer_tpu_torch.scene.builder import SceneBuilder  # noqa: F401
