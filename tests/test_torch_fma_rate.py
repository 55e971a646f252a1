"""The port's FMA-rate probe (``raytracer_tpu_torch.experiments.
bf16_rate_bench``: ``fma_chain_plain``, the plain twin of
``csrc/fma_rate.cu``) against the Pallas ``_kernel`` of
``experiments/bf16_rate_bench.py``, run through an interpret-mode
``pallas_call`` built here around it (the script's ``run`` has no
interpret switch), on one 256 x 1024 tile.

Both the script's weight (1 - 2^-14, which is 1 in bf16, so every bf16
product is exact) and ``W_CHECK`` (0.75, exact in bf16: a chain without its
multiply is 3x off at passes 64) go through both.

Tolerances: the two packages round the chain at other places (XLA may
keep float32 through a fused bf16 chain; PyTorch rounds every product and
sum to the tensor's type). Measured on one tile at passes 16 and 64: f32
within 5.9e-7 relative, bf16 within 2^-7 with 94-96% of the elements
exact. Held to 2e-6 (f32) and 2^-6 (bf16: two bf16 ulps).
"""

import functools
import importlib.util
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from raytracer_tpu_torch.experiments import bf16_rate_bench as probe  # noqa

ROOT = os.path.join(os.path.dirname(__file__), "..")
RTOL = {"float32": 2e-6, "bfloat16": 2.0 ** -6}


def jax_probe_module():
    spec = importlib.util.spec_from_file_location(
        "jax_bf16_rate_bench",
        os.path.join(ROOT, "experiments", "bf16_rate_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_PROBE = jax_probe_module()


def inputs(w, seed=0):
    """One tile of the script's inputs, float32 (x uniform + 0.5, w)."""
    rng = np.random.default_rng(seed)
    x = (rng.random((probe.TILE, probe.C), dtype=np.float32) + 0.5)
    return x, np.full_like(x, w)


@pytest.mark.parametrize("w", ["script", "check"])
@pytest.mark.parametrize("passes", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(dtype, passes, w):
    w_val = probe.W if w == "script" else probe.W_CHECK
    x, w = inputs(w_val)
    jdt = jnp.dtype(dtype)
    call = pl.pallas_call(functools.partial(JAX_PROBE._kernel, passes=passes),
                          out_shape=jax.ShapeDtypeStruct(x.shape, jdt),
                          interpret=True)
    ref = np.asarray(call(jnp.asarray(x).astype(jdt),
                          jnp.asarray(w).astype(jdt)).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    out = probe.fma_chain(torch.from_numpy(x).to(tdt),
                          torch.from_numpy(w).to(tdt), passes)
    assert out.dtype == tdt and out.shape == x.shape
    out = out.float().numpy()
    assert np.isfinite(out).all()
    rel = np.abs(out - ref) / np.abs(ref)
    assert rel.max() <= RTOL[dtype], rel.max()
    # the chain really ran: (a0 + a1) + (a2 + a3) ends near 4 x sum_k w^k,
    # k < passes / 4
    steps = passes // 4
    grown = 4.0 * (1.0 - w_val ** steps) / (1.0 - w_val) + 4.0 * w_val ** steps
    assert 0.9 * grown < (out / x).mean() < 1.1 * grown


def test_constants_are_the_scripts():
    assert (probe.TILE, probe.C, probe.W) == (JAX_PROBE.TILE, JAX_PROBE.C,
                                              0.99993896484375)
    # the check weight is exact in bf16 and not 1
    w = torch.tensor(probe.W_CHECK)
    assert w.to(torch.bfloat16).float() == w and probe.W_CHECK != 1.0
    assert 64 in probe.PASSES and {16, 256} <= set(probe.PASSES)


@pytest.mark.parametrize("passes,by", [(16, "bytes"), (64, "bytes"),
                                       (256, "operations"),
                                       (1024, "operations")])
def test_bound_crosses_the_ridge(passes, by):
    """12 bytes per f32 element against 2 * passes flops: below the
    card's ~20 flops per byte the probe measures memory."""
    b = probe.bound(probe.N_TILES * probe.TILE * probe.C, torch.float32,
                    passes)
    assert b["bound_by"] == by
    assert b["flops"] == 2.0 * passes * probe.N_TILES * probe.TILE * probe.C


def test_kernel_wrapper_checks_its_inputs():
    x = torch.zeros((8, 8), dtype=torch.float64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        probe._fma_cuda(x, x, 16)
    x = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="multiple"):
        probe._fma_cuda(x, x, 6)
    with pytest.raises(NotImplementedError, match="meta"):
        probe.fma_chain(x.to("meta"), x.to("meta"), 16)
