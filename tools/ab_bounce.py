"""Run the fused-bounce kernels of this checkout and of another one on the
same rays and compare their outputs bit for bit, beside both builds'
registers and spills: the check that a change to the shared CUDA sources
(``csrc/*.cuh``) left the bounce kernels as they were.

    python3 tools/ab_bounce.py OTHER_CHECKOUT

``OTHER_CHECKOUT`` is a directory with another tree of the repository
(for example ``git archive`` of the parent commit, unpacked), whose
``raytracer_tpu_torch/csrc`` is built into its own ``_build``. The rays:
the 800x600 image rays of ``chip_smoke.py`` (480,000 lanes) on scene_500
(``bounce.cu``) and on sphere_field(65536) (``bounce_ordered.cu``), then
a second bounce fed from the first. Needs a CUDA device; exits non-zero
if any output differs.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from raytracer_tpu_torch.kernels import build as kbuild  # noqa: E402
from raytracer_tpu_torch.ops import fused_bounce as fb  # noqa: E402

NAMES = ("bounce", "bounce_ordered")


def use_sources(pkg: Path):
    """Build and load the kernels from ``pkg``'s csrc from now on."""
    kbuild.CSRC = pkg / "csrc"
    kbuild.BUILD = pkg / "_build"
    kbuild.load_library.cache_clear()


def registers(name: str) -> str:
    return " | ".join(ln.strip() for ln in kbuild.build_log(name).splitlines()
                      if "registers" in ln or "spill" in ln)


def run_cases(dev) -> dict:
    """Both bounces of each scene, their seven outputs on the host."""
    out = {}
    for scene_name, seed in (("scene_500", 7), ("field64k", 20)):
        scene = (chip_smoke.load(scene_name, chip_smoke.WIDTH
                                 / chip_smoke.HEIGHT)
                 if scene_name == "scene_500"
                 else chip_smoke.large_scene(scene_name)).to(dev)
        tab = fb.pack_tables(scene)
        o, d, alive, uni = chip_smoke.image_rays(scene.to("cpu"), seed, dev)
        for bounce in (1, 2):
            res = fb.bounce_tables(tab, o, d, chip_smoke.T_MIN, alive, uni)
            out[(scene_name, bounce)] = [x.cpu() for x in res]
            alive = alive & (res[0] != 2)            # INTER_ABSORB retires
            o, d = res[1].contiguous(), res[2].contiguous()
    return out


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve() / "raytracer_tpu_torch"
    dev = torch.device("cuda")
    results, regs = {}, {}
    for tag, pkg in (("this", ROOT / "raytracer_tpu_torch"), ("other", other)):
        use_sources(pkg)
        for name in NAMES:
            kbuild.load_library(name)
            regs[(tag, name)] = registers(name)
        results[tag] = run_cases(dev)
        torch.cuda.synchronize()
    for name in NAMES:
        for tag, where in (("this", "this tree"),
                           ("other", os.path.relpath(other.parent))):
            print(f"{name} ({where}): {regs[(tag, name)]}")
    same = True
    for case, outs in results["this"].items():
        diff = [k for k, (a, b) in enumerate(zip(outs, results["other"][case]))
                if not torch.equal(a, b)]
        same &= not diff
        print(f"{case[0]} bounce {case[1]}: "
              + ("bit-identical" if not diff
                 else f"outputs {diff} differ (of inter, no, nd, att, emit, "
                      "p, n)"))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
