"""SPPM iterations, one a pass: ``sppm.sppm_iteration(scene, tables,
state, seed, **sppm.iteration_kwargs(...))`` with the state carried from
pass to pass and reset to zeros after ``job_iterations`` (a job: the
upstream's 50 iterations of 500,000 photons); each job's seed comes from
(``--seed``, job index). On the card the photon pass and both maps are one
CUDA graph replay, captured in set-up by the warm iterations.

The comparison follows the program's own state: for a few iterations
drawn from ``--seed`` (one a job's first, from zeros) it keeps the state
before and after, and the reference runs the same iteration ``replicas``
times from the state before, on its own photons and camera rays, for the
sampled blocks of pixels (``reference.compare.state_numbers``).

Traffic keys: ``job_iterations``, ``trace_passes``. Check keys:
``block``, ``blocks``, ``iterations``, ``replicas``, ``limits``."""

from __future__ import annotations

import torch

from harness import seeds, sppm_program
from reference import compare, scenes
from reference import sppm as ref_sppm


class Driver:
    def __init__(self, cell, seed: int, device, data_root, trace=False):
        self.cfg, self.tr, self.ck = cell.config, cell.traffic, cell.check
        self.seed, self.device, self.data_root = seed, torch.device(device), \
            data_root
        self.trace = trace
        self.job = self.tr["job_iterations"]
        w, h = self.cfg["width"], self.cfg["height"]
        rng = seeds.numpy_rng(seed, seeds.SAMPLE)
        blocks = compare.sample_blocks(rng, w, h, self.ck["block"],
                                       self.ck["blocks"])
        self.n_blocks = len(blocks)
        self.pixels = torch.as_tensor(
            compare.block_pixels(blocks, w, self.ck["block"]),
            device=self.device)
        self.sampled = compare.sample_iterations(rng, self.job,
                                                 self.ck["iterations"])
        self.kept = {}
        self.stages = []
        self.bad = None

    def setup(self):
        p = self.prog = sppm_program.build(self.cfg, self.device)
        self.npix = self.cfg["width"] * self.cfg["height"]
        state = p.sppm.init_state(self.npix, self.device)
        warm = seeds.derive(self.seed, seeds.WARM)
        for _ in range(2):          # the graph's capture, then a replay
            state = p.sppm.sppm_iteration(p.scene, p.tables, state, warm,
                                          **p.kw)
        self.bad = torch.zeros((), dtype=torch.bool, device=self.device)
        self.state = None

    def run_pass(self, k: int, spans) -> dict:
        p = self.prog
        j, i = divmod(k, self.job)
        if i == 0:
            if self.state is not None:
                self.bad |= ~sppm_program.finite(self.state)
            self.state = p.sppm.init_state(self.npix, self.device)
            self.job_seed = seeds.derive(self.seed, seeds.JOB, j)
        before = self.state
        times = {} if self.trace and not spans.active else None
        with spans("sppm_iteration"):
            self.state = p.sppm.sppm_iteration(
                p.scene, p.tables, before, self.job_seed, times=times,
                **p.kw)
        if times is not None:
            self.stages.append(times)
        if k in self.sampled:
            self.kept[k] = (before, self.state)
        return {"iterations": 1}

    def stage_ms(self):
        return self.stages

    def failed(self) -> int:
        if self.state is not None:
            self.bad |= ~sppm_program.finite(self.state)
        return int(self.bad)

    def release(self):
        self.kept = {k: (sppm_program.state_dict(b, self.pixels),
                         sppm_program.state_dict(a, self.pixels))
                     for k, (b, a) in self.kept.items()}
        self.prog = self.state = None

    def _reference(self, dtype=torch.float64):
        return scenes.build(self.cfg, self.data_root).to(self.device, dtype)

    def _replicas(self, sc, before: dict, k: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seeds.derive(self.seed, seeds.REFERENCE, k))
        return torch.stack([
            compare.state_blocks(self._iterate(sc, before, gen),
                                 self.n_blocks)
            for _ in range(self.ck["replicas"])])

    def _iterate(self, sc, before: dict, gen) -> dict:
        cfg = self.cfg
        return ref_sppm.iteration(sc, before, self.pixels, cfg["width"],
                                  cfg["height"], cfg["sppm"], cfg["t_min"],
                                  cfg["spawn_eps_rel"], gen)

    def _numbers(self, after_of) -> dict:
        """The numbers for the program's (or the control's) state after
        each kept iteration, ``after_of(k, before)``."""
        if not self.kept:
            raise RuntimeError("the window reached no sampled iteration "
                               f"(sampled: {sorted(self.sampled)})")
        sc = self._reference()
        prog, reps, unchanged = [], [], 0
        for k, (before, _after) in sorted(self.kept.items()):
            after = after_of(k, before)
            unchanged += int(all(torch.equal(after[key], before[key])
                                 for key in ref_sppm.STATE_KEYS))
            prog.append(compare.state_blocks(after, self.n_blocks))
            reps.append(self._replicas(sc, before, k))
        out = compare.state_numbers(torch.stack(prog), torch.stack(reps))
        out["unchanged"] = unchanged
        return out

    def compare(self) -> dict:
        return self._numbers(lambda k, before: self.kept[k][1])

    def control(self, passes: int, dtype) -> dict:
        """The control's numbers: the reference in ``dtype`` in the
        program's place for each kept iteration, from the program's state
        before it."""
        sc = self._reference(dtype)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seeds.derive(self.seed, seeds.CONTROL))

        def after_of(k, before):
            out = self._iterate(sc, before, gen)
            return {key: v.double() for key, v in out.items()}
        return self._numbers(after_of)
