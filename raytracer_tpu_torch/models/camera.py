"""Camera rays on (N, 3) tensors for the brute-force route: the
counterpart of ``raytracer_tpu/models/camera.py::camera_rays``
(camera.rs:57-64 with the per-sample jitter and y-flip of camera.rs:97-99).
The wavefront's (3, N) form is ``ops/sampling.py::camera_rays_soa``."""

from __future__ import annotations

import torch

from raytracer_tpu_torch.scene.types import Camera

TWO_PI = 6.283185307179586
CAMERA_ROWS = 4          # jitter x, jitter y, lens radius, lens angle


def camera_rays_from(cam: Camera, uni, pixel_ids, width: int, height: int):
    """One jittered thin-lens ray per entry of ``pixel_ids`` (N,) flat ids
    (y * width + x), from ``uni`` (4, N) uniform rows: jitter x, jitter y,
    and the lens disk's sqrt-radius and angle. Returns (o, d), each
    (N, 3)."""
    x = (pixel_ids % width).to(torch.float32)
    y = (pixel_ids // width).to(torch.float32)
    s = (x + uni[0]) / (width - 1)
    t = 1.0 - (y + uni[1]) / (height - 1)      # y is reverted (camera.rs:99)
    r = torch.sqrt(uni[2])
    phi = TWO_PI * uni[3]
    rd = cam.lens_radius * torch.stack([r * torch.cos(phi),
                                        r * torch.sin(phi)], -1)
    offset = cam.u[None] * rd[:, :1] + cam.v[None] * rd[:, 1:2]
    origin = cam.origin[None] + offset
    direction = (cam.lower_left_corner[None] + s[:, None] * cam.horizontal[None]
                 + t[:, None] * cam.vertical[None] - cam.origin[None]
                 - offset)
    return origin, direction


def camera_rays(cam: Camera, gen: torch.Generator, pixel_ids, width: int,
                height: int):
    """``camera_rays_from`` on ``CAMERA_ROWS`` rows drawn from ``gen`` on
    the pixels' device."""
    uni = torch.rand((CAMERA_ROWS, pixel_ids.shape[0]), generator=gen,
                     device=pixel_ids.device)
    return camera_rays_from(cam, uni, pixel_ids, width, height)
