"""Progressive path-tracer passes: each pass is one call of
``path_tracer.render_fn`` with the scene's tables packed once in set-up,
as ``path_tracer.render`` calls it for each host batch. A pass renders
``spp_per_pass`` samples of every pixel from a generator seeded by
(``--seed``, pass index); a job is ``job_spp`` samples, after which the
client's progressive image starts again.

The traffic file's keys: ``spp_per_pass``, ``spp_chunk``,
``russian_roulette``, ``nee``, ``job_spp``, ``trace_passes``. The
configuration's: ``scene`` (a ``json`` scene file), ``width``,
``height``, ``max_depth``, ``t_min``, ``spawn_eps_rel``, ``route``."""

from __future__ import annotations

import torch

from harness import seeds
from harness.images import ImageClient
from harness.trace import Spans


class Driver:
    def __init__(self, cell, seed: int, device, data_root, trace=False):
        self.cfg, self.tr, self.seed = cell.config, cell.traffic, seed
        self.device, self.data_root = torch.device(device), data_root
        self.client = ImageClient(cell, seed, device, data_root)
        self.spp = self.tr["spp_per_pass"]
        self.passes_per_job = max(1, self.tr["job_spp"] // self.spp)

    def setup(self):
        from raytracer_tpu_torch.models import path_tracer
        from raytracer_tpu_torch.ops import dispatch
        from raytracer_tpu_torch.scene.loader import load_scene
        cfg = self.cfg
        self.render_fn = path_tracer.render_fn
        scene = load_scene(str(self.data_root / cfg["scene"]["file"]),
                           aspect_ratio=cfg["width"] / cfg["height"])
        self.scene = scene.to(self.device)
        self.route = path_tracer.resolve_route(
            self.scene, cfg["route"], self.tr["nee"], False)
        self.tables = dispatch.route_tables(self.scene, self.route)
        self._pass(seeds.derive(self.seed, seeds.WARM), True, Spans())
        self.client.reset()

    def _pass(self, pass_seed: int, new_job: bool, spans):
        cfg, tr = self.cfg, self.tr
        gen = torch.Generator(device=self.device)
        gen.manual_seed(pass_seed)
        with spans("render_fn"):
            img, rays = self.render_fn(
                self.scene, gen, width=cfg["width"], height=cfg["height"],
                spp=self.spp, spp_chunk=tr["spp_chunk"],
                max_depth=cfg["max_depth"], t_min=cfg["t_min"],
                spawn_eps_rel=cfg["spawn_eps_rel"], intersector=self.route,
                russian_roulette=tr["russian_roulette"], nee=tr["nee"],
                device=self.device, tables=self.tables)
        with spans("client"):
            self.client.take(img, new_job)
        return rays

    def run_pass(self, k: int, spans) -> dict:
        rays = self._pass(seeds.derive(self.seed, seeds.PASS, k),
                          k % self.passes_per_job == 0, spans)
        return {"samples": self.cfg["width"] * self.cfg["height"] * self.spp,
                "rays": int(rays)}

    def stage_ms(self):
        return None

    def failed(self) -> int:
        return self.client.failed()

    def release(self):
        self.scene = self.tables = None
        self.client.release()

    def _walk(self) -> dict:
        return dict(mode="pt", max_depth=self.cfg["max_depth"],
                    nee=self.tr["nee"],
                    russian_roulette=self.tr["russian_roulette"])

    def compare(self) -> dict:
        return self.client.reference_numbers(
            self.client.program_means(), self.client.check["ref_spp"],
            **self._walk())

    def control(self, passes: int, dtype) -> dict:
        """The control's numbers: ``passes`` passes of the reference in
        ``dtype`` in the program's place."""
        prog = self.client.control_means(passes, self.spp, dtype,
                                         **self._walk())
        return self.client.reference_numbers(
            prog, self.client.check["ref_spp"], **self._walk())
