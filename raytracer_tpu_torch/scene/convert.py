"""Carry a scene across from any object that has the JAX ``Scene``'s
field names.

``scene_from_numpy(tree)`` reads the record by field name and turns every
leaf that ``np.asarray`` accepts into a tensor. Tests hand it a JAX scene
(whose arrays ``np.asarray`` reads) to compare both packages on one scene;
this module itself imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_tpu_torch.scene import types as T

# record-valued fields of each record type
_NESTED = {
    T.Scene: {"spheres": T.Spheres, "rects": T.Rects,
              "triangles": T.Triangles, "materials": T.Materials,
              "textures": T.Textures, "lights": T.Lights,
              "camera": T.Camera, "bvh": T.BVH, "media": T.Media},
}


def _leaf(x) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x)))


def _convert(cls, src):
    nested = _NESTED.get(cls, {})
    vals = []
    for name in cls._fields:
        if not hasattr(src, name):
            if name not in cls._field_defaults:
                raise TypeError(f"{type(src).__name__} has no field {name!r}")
            vals.append(cls._field_defaults[name])
            continue
        x = getattr(src, name)
        if x is None:
            vals.append(None)
        elif name in nested:
            vals.append(_convert(nested[name], x))
        elif cls is T.Scene and name == "leaf":
            raise NotImplementedError(
                "leaf-traversal tables are not ported yet (ROADMAP B, "
                "_leaf_kernel)")
        else:
            vals.append(_leaf(x))
    return cls(*vals)


def scene_from_numpy(tree) -> T.Scene:
    """A port ``Scene`` (CPU tensors) from any object with the JAX
    ``Scene``'s field names and array-like leaves."""
    return _convert(T.Scene, tree)
