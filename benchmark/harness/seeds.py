"""Seeds of the generated inputs, from ``--seed`` and a few words (a
stream tag and an index), so that the same seed gives the same inputs.
``--seed`` may be any whole number, also past 64 bits."""

from __future__ import annotations

import numpy as np

# stream tags
PASS, JOB, WARM, SAMPLE, REFERENCE, CONTROL, STATE = 1, 2, 3, 4, 5, 6, 7


def derive(seed: int, *words: int) -> int:
    """A 63-bit seed from (seed, *words), for ``torch.Generator``."""
    s = int(seed)
    limbs = [s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF, (s >> 64) & 0xFFFFFFFF,
             1 if s < 0 else 0]
    state = np.random.SeedSequence(limbs + [int(w) for w in words])
    a, b = state.generate_state(2, np.uint32)
    return ((int(a) << 31) ^ int(b)) & ((1 << 63) - 1)


def numpy_rng(seed: int, *words: int) -> np.random.Generator:
    """A numpy generator for host-side choices (which blocks, which passes
    the comparison samples)."""
    return np.random.default_rng(derive(seed, *words))
