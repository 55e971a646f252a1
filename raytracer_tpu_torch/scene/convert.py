"""Carry a scene across from any object that has the JAX ``Scene``'s
field names.

``scene_from_numpy(tree)`` reads the record by field name and turns every
leaf that ``np.asarray`` accepts into a tensor; leaf-traversal tables are
carried into the port's layout (``leaf_from_numpy``). Tests hand it a JAX scene
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
            vals.append(leaf_from_numpy(x))
        else:
            vals.append(_leaf(x))
    return cls(*vals)


PAD_CSQ = np.float32(3e38)   # a pad column's csq row in the JAX tables


def leaf_from_numpy(src) -> T.LeafTables:
    """The port's ``LeafTables`` from the JAX package's (``aabb`` (6, L'),
    ``table`` (17, L' * LEAF), ``big`` (18, B')): leaf membership from
    ``table`` row 16, the big set from ``big`` row 16, the boxes from
    ``aabb``. Pad columns read 0 in row 16, like sphere 0; they are told
    apart by row 3, where a pad holds csq = 3e38. Leaves with no member
    (the JAX padding to a multiple of 32 leaves) are dropped."""
    aabb = np.asarray(src.aabb, np.float32)
    table = np.asarray(src.table, np.float32)
    big = np.asarray(src.big, np.float32)
    n_cols = aabb.shape[1]
    leaf = table.shape[1] // n_cols
    ids = np.rint(table[16]).astype(np.int32)
    ids[table[3] == PAD_CSQ] = -1
    ids = ids.reshape(n_cols, leaf)
    real = (ids >= 0).any(1)
    big_ids = np.rint(big[16]).astype(np.int32)[big[3] != PAD_CSQ]
    return T.LeafTables(torch.from_numpy(np.ascontiguousarray(aabb[:, real].T)),
                        torch.from_numpy(np.ascontiguousarray(ids[real])),
                        torch.from_numpy(big_ids))


def scene_from_numpy(tree) -> T.Scene:
    """A port ``Scene`` (CPU tensors) from any object with the JAX
    ``Scene``'s field names and array-like leaves."""
    return _convert(T.Scene, tree)
