"""SPPM state checkpoint and resume, in the JAX package's npz format
(``raytracer_tpu/utils/checkpoint.py``: ``FORMAT_VERSION = 1``, the same
key names), so a checkpoint written by either package resumes in the other.

``sppm_state_from_numpy`` carries a state across from any object with the
``SPPMState`` field names (a JAX state included), as
``scene/convert.py::scene_from_numpy`` does for scenes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from raytracer_tpu_torch.models.sppm import SPPMHalf, SPPMState

FORMAT_VERSION = 1


def save_state(path: str, state: SPPMState, seed: int):
    """Write ``state`` and the render's ``seed`` to ``path`` (atomically:
    a temporary file, then a rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def arr(x):
        return x.detach().cpu().numpy()

    flat = {
        "version": FORMAT_VERSION,
        "seed": seed,
        "iteration": np.asarray(int(state.iteration), np.int32),
        "g_flux": arr(state.glob.flux),
        "g_radius2": arr(state.glob.radius2),
        "g_photons": arr(state.glob.photons),
        "c_flux": arr(state.caustic.flux),
        "c_radius2": arr(state.caustic.radius2),
        "c_photons": arr(state.caustic.photons),
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def _half(flux, radius2, photons) -> SPPMHalf:
    return SPPMHalf(*(torch.from_numpy(np.array(np.asarray(x), np.float32))
                      for x in (flux, radius2, photons)))


def load_state(path: str):
    """Returns (state on the CPU, seed). Fails on a version mismatch."""
    with np.load(path) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"checkpoint version {int(z['version'])} != "
                             f"{FORMAT_VERSION}")
        state = SPPMState(
            glob=_half(z["g_flux"], z["g_radius2"], z["g_photons"]),
            caustic=_half(z["c_flux"], z["c_radius2"], z["c_photons"]),
            iteration=int(z["iteration"]))
        return state, int(z["seed"])


def sppm_state_from_numpy(tree) -> SPPMState:
    """A port ``SPPMState`` (CPU tensors) from any object with the
    ``SPPMState`` field names and array-like leaves."""
    return SPPMState(glob=_half(*tree.glob), caustic=_half(*tree.caustic),
                     iteration=int(np.asarray(tree.iteration)))
