"""The plain reference agrees with itself across seeds at tiny sizes, and
its scenes are built from the inputs alone."""

import torch

from conftest import ROOT, _json
from harness import seeds
from reference import compare, render, scenes
from reference import sppm as ref_sppm


def _config(name):
    return _json(ROOT / "benchmark" / "configs" / f"{name}.json")


def test_scenes_from_inputs():
    s5 = scenes.build(_config("scene500_800x600"), ROOT)
    assert s5.counts() == {"spheres": 1005, "rects": 0, "triangles": 0}
    assert s5.light_kind.shape[0] == 501      # 500 lamps and the checker one
    cb = scenes.build(_config("cornell_800x800"), ROOT)
    assert cb.counts() == {"spheres": 2, "rects": 12, "triangles": 12}
    assert cb.light_power[0].tolist() == [1e6, 1e6, 1e6]


def _blocks(cfg, seed, spp, **walk):
    sc = scenes.build(cfg, ROOT)
    rng = seeds.numpy_rng(1, seeds.SAMPLE)
    blocks = compare.sample_blocks(rng, cfg["width"], cfg["height"], 4, 6)
    pix = torch.as_tensor(compare.block_pixels(blocks, cfg["width"], 4))
    gen = torch.Generator().manual_seed(seed)
    s1, s2 = render.render_pixels(
        sc, pix, cfg["width"], cfg["height"], spp, gen, t_min=cfg["t_min"],
        spawn_eps=cfg["spawn_eps_rel"] * sc.scale, **walk)
    return compare.reference_blocks(s1, s2, spp, len(blocks))


def test_path_tracer_agrees_with_itself():
    cfg = dict(_config("scene500_800x600"), width=40, height=30)
    for nee in (False, True):
        a_mean, a_se = _blocks(cfg, 1, 48, mode="pt", max_depth=8, nee=nee)
        b_mean, b_se = _blocks(cfg, 2, 48, mode="pt", max_depth=8, nee=nee)
        z = (a_mean - b_mean).abs() / torch.sqrt(a_se ** 2 + b_se ** 2
                                                 + 1e-30)
        assert float(z.max()) < 5.0
        assert float(a_mean.mean()) > 0


def test_sppm_iteration_agrees_with_itself():
    cfg = dict(_config("cornell_800x800"), width=24, height=24)
    sp = dict(cfg["sppm"], photons_per_iteration=20000)
    sc = scenes.build(cfg, ROOT)
    rng = seeds.numpy_rng(3, seeds.SAMPLE)
    blocks = compare.sample_blocks(rng, 24, 24, 4, 4)
    pix = torch.as_tensor(compare.block_pixels(blocks, 24, 4))
    zero = {k: torch.zeros((pix.shape[0], 3) if k.startswith("flux")
                           else (pix.shape[0],), dtype=torch.float64)
            for k in ref_sppm.STATE_KEYS}
    gen = torch.Generator().manual_seed(5)

    def it(state):
        return ref_sppm.iteration(sc, state, pix, 24, 24, sp, cfg["t_min"],
                                  cfg["spawn_eps_rel"], gen)
    first = it(zero)
    assert float(first["n_g"].max()) == sp["k_global"]
    reps = torch.stack([torch.stack([compare.state_blocks(it(first), 4)
                                     for _ in range(8)])])
    prog = compare.state_blocks(it(first), 4)[None]
    out = compare.state_numbers(prog, reps)
    assert out["blocks_off"] <= 2 and out["z_total"] < 8.0
