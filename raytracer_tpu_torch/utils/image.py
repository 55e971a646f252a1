"""Image output: gamma-2 encode and a PNG writer (vec3.rs:223-231,
main.rs:55).

The PyTorch counterpart of ``raytracer_tpu/utils/image.py`` with
``ops/vec.py::to_rgb8``: numpy and zlib only, so it runs wherever the port
runs.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def linear_to_rgb8(img_linear) -> np.ndarray:
    """(H, W, 3) linear float (array or tensor on any device) -> (H, W, 3)
    uint8: floor(clamp(sqrt(max(c, 0)), 0, 1) * 255)."""
    if hasattr(img_linear, "detach"):
        img_linear = img_linear.detach().cpu().numpy()
    c = np.asarray(img_linear, np.float32)
    g = np.clip(np.sqrt(np.maximum(c, np.float32(0.0))), 0.0, 1.0)
    return np.floor(g * np.float32(255.0)).astype(np.uint8)


def save_png(path: str, rgb8: np.ndarray):
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    rgb8 = np.ascontiguousarray(rgb8, np.uint8)
    h, w, _ = rgb8.shape
    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def save_render(path: str, img_linear):
    """Gamma-encode a linear (H, W, 3) image and write it as PNG."""
    save_png(path, linear_to_rgb8(img_linear))
