"""Where a render's time goes on the GPU: one scene_500 render of the
PyTorch port (800x600, 32 spp, spp_chunk 1, depth 16, Russian roulette
off, as in chip_smoke.py phases 6 and 9) under ``torch.profiler``, after
one unprofiled warm render.

    python3 tools/profile_torch.py [--mode pt|nee|mis ...]

Prints, per mode, the wall time, the device time summed over kernels, the
device busy share (device time over wall time), and the ten kernels with
the most device time, with their launch counts. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profile(mode: str) -> None:
    from raytracer_tpu_torch.models import path_tracer
    from raytracer_tpu_torch.scene.loader import load_scene
    from raytracer_tpu_torch.utils.config import RenderConfig
    scene = load_scene(os.path.join(ROOT, "data", "scene_500.json"),
                       aspect_ratio=800 / 600)
    cfg = RenderConfig(width=800, height=600, samples_per_pixel=32,
                       spp_chunk=1, max_depth=16, t_min=1e-3,
                       spawn_eps_rel=1e-5, russian_roulette=False,
                       nee=mode == "nee", mis=mode == "mis")
    path_tracer.render(scene, cfg, 0, device="cuda")             # warm
    torch.cuda.synchronize()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act, acc_events=True) as prof:
        t0 = time.perf_counter()
        path_tracer.render(scene, cfg, 1, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: an operator's row repeats the time of its kernels
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"{mode}: wall {wall * 1e3:.3f} ms, device {dev_ms:.3f} ms, busy "
          f"{dev_ms / (wall * 1e3):.3f}")
    for e in rows[:10]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.count:7d} x  {e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", nargs="+", default=["pt", "nee", "mis"],
                    choices=["pt", "nee", "mis"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for mode in args.mode:
        profile(mode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
