"""Closed-form sampling on (3, N) rows, from prepared uniform rows: the
counterparts of ``raytracer_tpu/ops/sampling.py``'s ``uniform_sphere_from``
and ``uniform_hemisphere``, and the camera rays of
``raytracer_tpu/models/wavefront_soa.py::camera_rays_soa``. Callers draw
the uniforms (one batched ``torch.rand`` per step), so a test can feed
both packages the same numbers."""

from __future__ import annotations

import torch

from raytracer_tpu_torch.scene.types import Camera

TWO_PI = 6.283185307179586


def unit(x, eps=0.0):
    """``vec.unit`` on (3, N) rows: x / |x| where |x|^2 > eps, else 0."""
    l2 = (x * x).sum(0)
    inv = torch.where(l2 > eps, 1.0 / torch.sqrt(torch.clamp(l2, min=1e-30)),
                      0.0)
    return x * inv


def uniform_sphere_from(u1, u2):
    """Uniform direction on the unit sphere from two (N,) uniform rows:
    z = 1 - 2 u1, phi = 2 pi u2. Returns (3, N)."""
    z = 1.0 - 2.0 * u1
    phi = TWO_PI * u2
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z])


def uniform_hemisphere(u1, u2, normal):
    """``uniform_sphere_from(u1, u2)`` flipped into the hemisphere around
    ``normal`` (3, N) (vec3.rs:144-151). Returns (3, N)."""
    d = uniform_sphere_from(u1, u2)
    return d * torch.where((d * normal).sum(0) > 0.0, 1.0, -1.0)


def camera_rays_soa(cam: Camera, px, py, width: int, height: int, uni):
    """Thin-lens camera rays (camera.rs:57-64 with the jitter and y-flip of
    camera.rs:97-99). ``px, py`` (N,) f32 pixel coordinates; ``uni`` (4, N)
    uniform rows (jitter x, jitter y, lens radius, lens angle). Returns
    (o, d), each (3, N)."""
    u = (px + uni[0]) / (width - 1)
    v = (py + uni[1]) / (height - 1)
    t = 1.0 - v  # y axis is reverted (camera.rs:99)
    r = torch.sqrt(uni[2]) * cam.lens_radius
    phi = TWO_PI * uni[3]
    rdx = r * torch.cos(phi)
    rdy = r * torch.sin(phi)
    o = torch.stack([cam.origin[c] + cam.u[c] * rdx + cam.v[c] * rdy
                     for c in range(3)])
    d = torch.stack([cam.lower_left_corner[c] + u * cam.horizontal[c]
                     + t * cam.vertical[c] - o[c] for c in range(3)])
    return o, d
