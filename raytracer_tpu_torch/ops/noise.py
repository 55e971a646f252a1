"""Perlin gradient noise, turbulence and the marble pattern, on tensors.

The counterpart of ``raytracer_tpu/ops/noise.py``: classic lattice gradient
noise with hermitian smoothing, a sum of |noise| octaves, and the book-2
marble 0.5 (1 + sin(scale z + 10 turb(p))).

The permutation and gradient tables are module constants built with numpy
by exactly the calls of the JAX module (``default_rng(12345)``, three
``permutation(256)``, then ``normal(size=(256, 3))`` normalised), so the
two packages' tables are equal bit for bit. They are copied to a device
once, at its first call there (``_tables``): a copy from the host in every
call would wait for the device each time.

The JAX module loops over the eight lattice corners; here they are one
axis of the tensors (in the same order, dx outermost), so an octave is a
few dozen launches whatever the corner count, the same sum up to the order
of its eight terms.
"""

from __future__ import annotations

import numpy as np
import torch

_rng = np.random.default_rng(12345)
PERM_X = _rng.permutation(256).astype(np.int32)
PERM_Y = _rng.permutation(256).astype(np.int32)
PERM_Z = _rng.permutation(256).astype(np.int32)
_g = _rng.normal(size=(256, 3))
GRAD = (_g / np.linalg.norm(_g, axis=-1, keepdims=True)).astype(np.float32)
del _rng, _g
# the lattice corners (dx, dy, dz), dx outermost as in the JAX loops
CORNERS = np.array([(dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
                    for dz in (0, 1)], np.int32)
_ON_DEVICE = {}


def _tables(device):
    """(perm_x, perm_y, perm_z, grad, corners) on ``device``, copied there
    once."""
    device = torch.device(device)
    if device not in _ON_DEVICE:
        _ON_DEVICE[device] = (
            *(torch.from_numpy(t).to(device=device, dtype=torch.int64)
              for t in (PERM_X, PERM_Y, PERM_Z)),
            torch.from_numpy(GRAD).to(device),
            torch.from_numpy(CORNERS).to(device))
    return _ON_DEVICE[device]


def perlin(p):
    """Gradient noise in about [-1, 1] at points ``p`` (..., 3) float32.
    Lattice coordinates wrap with ``i & 255`` in int32 (two's complement,
    so negative coordinates wrap as in the JAX package)."""
    perm_x, perm_y, perm_z, grad, corner = _tables(p.device)
    p = p.contiguous()            # the corner sum's order, whatever p's
    ip = torch.floor(p)
    f = p[..., None, :] - ip[..., None, :]             # (..., 1, 3)
    u = f * f * (3.0 - 2.0 * f)                       # hermitian smoothing
    lat = (ip.to(torch.int32)[..., None, :] + corner) & 255   # (..., 8, 3)
    h = perm_x[lat[..., 0].long()] ^ perm_y[lat[..., 1].long()] \
        ^ perm_z[lat[..., 2].long()]
    g = grad[h]                                       # (..., 8, 3)
    w = f - corner.to(p.dtype)
    dot = g[..., 0] * w[..., 0] + g[..., 1] * w[..., 1] + g[..., 2] * w[..., 2]
    wt = torch.where(corner.bool(), u, 1.0 - u)       # (..., 8, 3)
    return (wt[..., 0] * wt[..., 1] * wt[..., 2] * dot).sum(-1)


def turbulence(p, depth: int = 7):
    """Sum of |noise| over ``depth`` octaves, each half the weight and
    twice the frequency of the one before."""
    acc = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    weight = 1.0
    q = p
    for _ in range(depth):
        acc = acc + weight * torch.abs(perlin(q))
        weight *= 0.5
        q = q * 2.0
    return acc


def marble(p, scale):
    """Book-2 marble at points ``p`` (..., 3): 0.5 (1 + sin(scale z +
    10 turb(p))); ``scale`` broadcasts against p[..., 2]."""
    return 0.5 * (1.0 + torch.sin(scale * p[..., 2] + 10.0 * turbulence(p)))
