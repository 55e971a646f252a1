"""SPPM final-gather passes: ``sppm.gather_fn`` of a state that set-up
builds with ``state_iterations`` of the program's own SPPM iterations
(seeded from ``--seed``), as ``sppm.render`` calls it for each host batch:
``spp_per_pass`` samples of every pixel at the configuration's gather
depth, from a generator seeded by (``--seed``, pass index); a job is
``job_spp`` samples. The gather's paths do not depend on the estimates,
so the state's age changes only the image, not the work.

The comparison follows the program's state: the reference works each
sampled pixel's density estimate out of that state (flux / (pi r^2
photons traced), both maps) and gathers the same pixels on its own
random numbers.

Traffic keys: ``state_iterations``, ``spp_per_pass``, ``spp_chunk``,
``job_spp``, ``trace_passes``."""

from __future__ import annotations

import math

import torch

from harness import seeds, sppm_program
from harness.images import ImageClient
from harness.trace import Spans


class Driver:
    def __init__(self, cell, seed: int, device, data_root, trace=False):
        self.cfg, self.tr, self.seed = cell.config, cell.traffic, seed
        self.device, self.data_root = torch.device(device), data_root
        self.client = ImageClient(cell, seed, device, data_root)
        self.spp = self.tr["spp_per_pass"]
        self.passes_per_job = max(1, self.tr["job_spp"] // self.spp)
        self.n_total = (self.tr["state_iterations"]
                        * self.cfg["sppm"]["photons_per_iteration"])

    def setup(self):
        p = self.prog = sppm_program.build(
            self.cfg, self.device, gather_spp=self.tr["job_spp"],
            spp_chunk=self.tr["spp_chunk"])
        state = p.sppm.init_state(self.cfg["width"] * self.cfg["height"],
                                  self.device)
        state_seed = seeds.derive(self.seed, seeds.STATE)
        for _ in range(self.tr["state_iterations"]):
            state = p.sppm.sppm_iteration(p.scene, p.tables, state,
                                          state_seed, **p.kw)
        self.state = state
        self._pass(seeds.derive(self.seed, seeds.WARM), True, Spans())
        self.client.reset()

    def _pass(self, pass_seed: int, new_job: bool, spans):
        p, cfg = self.prog, self.cfg
        gen = torch.Generator(device=self.device)
        gen.manual_seed(pass_seed)
        with spans("gather_fn"):
            img, rays = p.sppm.gather_fn(
                p.scene, p.tables, self.state, gen, width=cfg["width"],
                height=cfg["height"], spp=self.spp,
                spp_chunk=self.tr["spp_chunk"],
                max_depth=cfg["gather"]["max_depth"], t_min=cfg["t_min"],
                spawn_eps_rel=cfg["spawn_eps_rel"],
                n_total_photons=self.n_total, intersector=p.config.intersector)
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
        self.state = sppm_program.state_dict(self.state,
                                             self.client.pixels)
        self.prog = None
        self.client.release()

    def _walk(self, dtype) -> dict:
        """The gather's walk with each sampled pixel's density estimate,
        worked out from the program's state in ``dtype``."""
        st = {k: v.to(dtype) for k, v in self.state.items()}
        est = 0.0
        for h in ("g", "c"):
            rad = st[f"flux_{h}"] / (math.pi * torch.clamp(
                st[f"r2_{h}"], min=1e-12)[:, None]) / self.n_total
            est = est + torch.where((st[f"n_{h}"] > 0)[:, None], rad, 0.0)
        return dict(mode="gather", max_depth=self.cfg["gather"]["max_depth"],
                    est=est)

    def compare(self) -> dict:
        return self.client.reference_numbers(
            self.client.program_means(), self.client.check["ref_spp"],
            **self._walk(torch.float64))

    def control(self, passes: int, dtype) -> dict:
        prog = self.client.control_means(passes, self.spp, dtype,
                                         **self._walk(dtype))
        return self.client.reference_numbers(
            prog, self.client.check["ref_spp"], **self._walk(torch.float64))
