"""The FMA-rate probe on the card: ``passes`` fused multiply-adds per
element on four accumulators over (TILE * n_tiles, C) inputs, in float32
and in bfloat16, timed to give the card's own FP32 and bf16 rates beside
the data sheet's (and the ceiling of the kernels' bounds in PERF.md).

The counterpart of ``experiments/bf16_rate_bench.py`` (the same TILE, C,
accumulator seeds and weight), whose Pallas ``_kernel`` measured the TPU's
elementwise rate; here ``csrc/fma_rate.cu`` on the CUDA cores, whose plain
twin is ``fma_chain_plain``. Run on a machine with the card:

    python -m raytracer_tpu_torch.experiments.bf16_rate_bench

It prints, per (dtype, passes), the time of one call, TFLOP/s and the
bound. Passes 16 and 64 lie below the card's ridge (12 bytes per f32
element against 2 * passes flops): they measure memory, not the FMA rate.
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from raytracer_tpu_torch.kernels import launch

TILE = 256
C = 1024
N_TILES = 64
PASSES = (16, 64, 256, 1024)
W = 0.99993896484375              # 1 - 2^-14; rounds to 1.0 in bf16
# The weight of the correctness checks: exact in bf16 and not 1, so a bf16
# chain without its multiply fails (by 3x at passes 64), while the chain
# contracts and the kernel's single rounding stays within 1.2% of the
# plain version's two. At 1 - 2^-8 every product lands half a bf16 ulp
# below a, and the two roundings drift 3.7% apart by passes 64.
W_CHECK = 0.75
SEEDS = (1.0009765625, 1.001953125, 1.0029296875)   # a1, a2, a3 = x * s
DTYPES = (torch.float32, torch.bfloat16)
# The card's peaks (H100 SXM at 700 W): FP32 on the CUDA cores (the
# data sheet), bf16 on the CUDA cores in packed pairs (twice FP32, the
# Hopper white paper), device memory.
PEAK = {torch.float32: 67e12, torch.bfloat16: 134e12}
PEAK_BYTES = 3.35e12


def make_inputs(n_tiles: int = N_TILES, device="cuda", seed: int = 0,
                w: float = W):
    """x uniform in [0.5, 1.5) and the weight ``w``, float32,
    (TILE * n_tiles, C)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((n_tiles * TILE, C), generator=gen, device=device) + 0.5
    return x, torch.full_like(x, w)


def fma_chain_plain(x, w, passes: int):
    """The probe's function in plain PyTorch, in the inputs' dtype: every
    product and sum rounds to it (the kernel's FMA rounds once)."""
    a = [x] + [x * s for s in SEEDS]
    for _ in range(passes // 4):
        a = [ak * w + x for ak in a]
    return (a[0] + a[1]) + (a[2] + a[3])


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]


def _fma_cuda(x, w, passes: int):
    if x.dtype not in DTYPES or w.dtype != x.dtype or w.shape != x.shape:
        raise ValueError(f"fma probe: x and w must be float32 or bfloat16 "
                         f"of one shape, got {x.dtype} {tuple(x.shape)} and "
                         f"{w.dtype} {tuple(w.shape)}")
    if w.device != x.device or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fma probe: x and w must be contiguous on one device")
    if x.numel() % 8 or passes % 4:
        raise ValueError("fma probe: the element count must be a multiple "
                         "of 8 and passes a multiple of 4")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launch("fma_rate", "fma_rate", "rt_fma_rate", _ARGTYPES,
               (x.data_ptr(), w.data_ptr(), out.data_ptr(), x.numel(), passes,
                int(x.dtype == torch.bfloat16), stream), "fma probe kernel")
    return out


def fma_chain(x, w, passes: int):
    """The probe on ``x``, ``w`` (one shape, float32 or bfloat16): CPU
    tensors take the plain version, CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return fma_chain_plain(x, w, passes)
    if x.device.type != "cuda":
        raise NotImplementedError(f"fma probe: no kernel for {x.device}")
    return _fma_cuda(x, w, passes)


def bound(n: int, dtype, passes: int) -> dict:
    """The least time of one call: 2 * passes flops per element over the
    dtype's peak, or x and w read and out written over the memory rate."""
    size = torch.finfo(dtype).bits // 8
    flops, nbytes = 2.0 * passes * n, 3.0 * n * size
    ops_ms, bytes_ms = flops / PEAK[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def time_ms(fn, reps: int = 10) -> float:
    """Device time of one call: CUDA events around ``reps`` calls after a
    warm one, divided by ``reps``."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bench(n_tiles: int = N_TILES, passes=PASSES, reps: int = 10,
          device="cuda") -> list:
    """The kernel's time, TFLOP/s and bound per (dtype, passes) on
    ``n_tiles`` tiles. Returns one dict per case."""
    x32, w32 = make_inputs(n_tiles, device)
    rows = []
    for p in passes:
        for dtype in DTYPES:
            x, w = x32.to(dtype), w32.to(dtype)
            ms = time_ms(lambda: fma_chain(x, w, p), reps)
            b = bound(x.numel(), dtype, p)
            rows.append({"dtype": str(dtype).removeprefix("torch."),
                         "passes": p, "ms": ms,
                         "tflops": b["flops"] / ms / 1e9, **b})
    return rows


def main():
    if not torch.cuda.is_available():
        raise SystemExit("the FMA-rate probe needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for r in bench():
        print(f"passes={r['passes']} {r['dtype']}: {r['ms']:.4f} ms, "
              f"{r['tflops']:.3f} TFLOP/s; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")


if __name__ == "__main__":
    main()
