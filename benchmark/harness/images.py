"""The client side of a cell whose passes return images (the path tracer
and the SPPM final gather): it keeps the job's progressive image, takes
each pass's mean over each sampled block of pixels for the comparison,
and counts passes whose image is not finite. The sampled blocks are drawn
from ``--seed``."""

from __future__ import annotations

import sys

import torch

from harness import seeds
from reference import compare, render, scenes


class ImageClient:
    def __init__(self, cell, seed: int, device, data_root):
        cfg, ck = cell.config, cell.check
        self.cfg, self.check, self.seed = cfg, ck, seed
        self.device, self.data_root = torch.device(device), data_root
        self.width, self.height = cfg["width"], cfg["height"]
        blocks = compare.sample_blocks(
            seeds.numpy_rng(seed, seeds.SAMPLE), self.width, self.height,
            ck["block"], ck["blocks"])
        self.n_blocks = len(blocks)
        self.blocks = blocks
        self.pixels = torch.as_tensor(
            compare.block_pixels(blocks, self.width, ck["block"]),
            device=self.device)
        self.accum = torch.zeros((self.height, self.width, 3),
                                 device=self.device)
        self.means = []
        self.bad = torch.zeros((), dtype=torch.int64, device=self.device)

    def take(self, img, new_job: bool):
        """The client's work on one pass's image (H, W, 3)."""
        if new_job:
            self.accum.zero_()
        self.accum += img
        self.means.append(img.reshape(-1, 3)[self.pixels].reshape(
            self.n_blocks, -1, 3).mean(1))
        self.bad += (~torch.isfinite(img)).any()

    def reset(self):
        """Forget the warm pass's answer."""
        self.means.clear()
        self.bad.zero_()

    def failed(self) -> int:
        return int(self.bad)

    def release(self):
        self.accum = None

    def program_means(self):
        return torch.stack(self.means)

    def reference(self, dtype=torch.float64):
        """The reference scene on the run's device in ``dtype``."""
        return scenes.build(self.cfg, self.data_root).to(self.device, dtype)

    def walk(self, sc, **extra) -> dict:
        """``render.trace``'s keywords: the configuration's ray offsets
        and the driver's ``extra`` (mode, depth, NEE, ...)."""
        return dict(t_min=self.cfg["t_min"],
                    spawn_eps=self.cfg["spawn_eps_rel"] * sc.scale, **extra)

    def reference_numbers(self, prog, spp: int, **walk) -> dict:
        """The comparison's numbers for the program's per-pass block means
        ``prog`` (P, B, 3) against ``spp`` reference samples a pixel."""
        sc = self.reference()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seeds.derive(self.seed, seeds.REFERENCE))
        s1, s2 = render.render_pixels(sc, self.pixels, self.width,
                                      self.height, spp, gen,
                                      **self.walk(sc, **walk))
        mean, se = compare.reference_blocks(s1, s2, spp, self.n_blocks)
        for row in compare.worst_blocks(prog, mean, se,
                                        self.check["rel_floor"]):
            b, c = row[:2]
            print(f"block {int(self.blocks[b])} channel {c}: z {row[2]:.3f}, "
                  f"program {row[3]:.6g} +- {row[4]:.3g}, reference "
                  f"{row[5]:.6g} +- {row[6]:.3g}", file=sys.stderr)
        return compare.image_numbers(prog, mean, se,
                                     self.check["rel_floor"],
                                     tuple(self.check["limits"]))

    def control_means(self, passes: int, spp: int, dtype, **walk):
        """The control in the program's place: ``passes`` passes of ``spp``
        samples a pixel of the reference computed in ``dtype``, as
        per-pass block means (P, B, 3)."""
        sc = self.reference(dtype)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seeds.derive(self.seed, seeds.CONTROL))
        out = []
        for _ in range(passes):
            s1, _s2 = render.render_pixels(sc, self.pixels, self.width,
                                           self.height, spp, gen,
                                           **self.walk(sc, **walk))
            out.append((s1.float() / spp).reshape(self.n_blocks, -1,
                                                  3).mean(1))
        return torch.stack(out)
