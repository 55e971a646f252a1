"""Seeded random streams shared by the integrators and the sharded
renders."""

from __future__ import annotations

import numpy as np
import torch


def stream_generator(device, seed: int, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, *words): SPPM's (stream,
    index), plus a rank's mesh coordinates in ``parallel/``."""
    words = np.random.SeedSequence(
        [int(seed) % 2 ** 64, *words]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return gen
