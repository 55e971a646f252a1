"""Batched 3-vector math on (..., 3) tensors: the counterpart of
``raytracer_tpu/ops/vec.py`` (the reference's Vec3, vec3.rs), used by the
brute-force (N, 3) route (``ops/intersect.py``, ``ops/materials.py``,
``models/path_tracer.py``). The wavefront's (3, N) rows have their own
helpers in ``ops/sampling.py``.

- dot (vec3.rs:335-341), cross (:74), unit (:86-91, guarded: a zero vector
  gives 0, not a panic), near_zero (1e-8, :93-96), reflect (:163-165),
  refract of a unit direction (:167-172).
"""

from __future__ import annotations

import torch

NEAR_ZERO_EPS = 1e-8


def dot(a, b):
    """Dot product over the trailing axis."""
    return (a * b).sum(-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def squared_length(v):
    return dot(v, v)


def unit(v, eps=0.0):
    """v / |v| where |v|^2 > eps, else 0."""
    l2 = squared_length(v)
    inv = torch.where(l2 > eps, 1.0 / torch.sqrt(torch.clamp(l2, min=1e-30)),
                      0.0)
    return v * inv[..., None]


def near_zero(v):
    """Every component below 1e-8 in magnitude."""
    return (v.abs() < NEAR_ZERO_EPS).all(-1)


def reflect(v_in, n):
    """v - 2 (v . n) n."""
    return v_in - 2.0 * dot(v_in, n)[..., None] * n


def refract(uv, n, etai_over_etat):
    """Snell refraction of a unit direction ``uv`` about ``n`` with the
    ratio ``etai_over_etat`` (a float or one per vector)."""
    cos_theta = torch.clamp(dot(-uv, n), max=1.0)
    eta = torch.as_tensor(etai_over_etat, dtype=uv.dtype, device=uv.device)
    eta = eta.expand(cos_theta.shape)
    perp = eta[..., None] * (uv + cos_theta[..., None] * n)
    par = -torch.sqrt((1.0 - squared_length(perp)).abs())[..., None] * n
    return perp + par
