"""The light table's power-categorical pick (light.rs:220-225's
WeightedIndex), shared by photon emission, NEE and MIS."""

from __future__ import annotations

import torch

from raytracer_tpu_torch.scene.types import Lights


def light_cdf(lights: Lights):
    """The lights' cumulative pick probabilities (L,) f32: the cumulative
    sum of ``exp(log_prob)``, normalised, in float64."""
    return torch.cumsum(torch.softmax(lights.log_prob.double(), 0), 0).float()


def pick_light(lights: Lights, u):
    """Light index per lane (N,) int64 from one uniform row ``u`` (N,), by
    inverse CDF over ``exp(log_prob)``: the first light whose cumulative
    probability exceeds u (always 0 for a single light, whose probability
    is exactly 1). The JAX package draws the same law with
    ``jax.random.categorical``."""
    idx = torch.searchsorted(light_cdf(lights), u, right=True)
    return idx.clamp(max=lights.kind.shape[0] - 1)


def light_cols(x, idx):
    """Per-lane columns of an (L, 3) light field as (3, N) rows, contiguous
    (the kernels take contiguous rows)."""
    return x.T[:, idx]
