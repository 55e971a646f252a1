"""Build the CUDA sources under ``csrc/`` with nvcc and load them.

Each library ``lib<name>.so`` is compiled from ``csrc/<name>.cu`` (plus the
package's ``*.cuh`` headers) into a plain-C shared library and loaded with
``ctypes``; no PyTorch headers are involved, so a build takes seconds. The
output lands in ``raytracer_tpu_torch/_build/<hash of sources and
flags>/`` at first use, so a fresh checkout builds what it runs. There is
no fallback: a missing ``nvcc`` or a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
CUDA_ROOT = "/usr/local/cuda"     # the toolkit's default location
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    """The nvcc on PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), CUDA_ROOT):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise BuildError(
        f"nvcc not found (looked on PATH, $CUDA_HOME/bin and {CUDA_ROOT}/bin):"
        " the CUDA kernels of raytracer_tpu_torch are built from csrc/ at "
        "first use and have no fallback")


def _sources(name: str):
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise BuildError(f"no CUDA source {src}")
    return [src] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    """Where ``lib<name>.so`` is built: keyed by sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD / h.hexdigest()[:16] / f"lib{name}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless the library for these sources
    exists. The compiler's output is kept beside it in ``build.log``."""
    out = library_path(name)
    if out.is_file():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}"
    (out.parent / "build.log").write_text(log)
    if res.returncode != 0:
        os.unlink(tmp)
        raise BuildError(f"nvcc failed for {name}.cu (rc {res.returncode}):"
                         f"\n{log}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str = "bounce") -> ctypes.CDLL:
    """Build (at first use) and load ``lib<name>.so``."""
    return ctypes.CDLL(str(build(name)))


def bind(name: str, fn: str, argtypes) -> ctypes.CDLL:
    """``load_library(name)`` with the argument types of its entry point
    ``fn`` (returning the launch's ``cudaError_t`` as an int) and of
    ``rt_error_string`` set. Pointers and the stream are
    ``ctypes.c_void_p``: ctypes would pass an untyped int as 32 bits."""
    lib = load_library(name)
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str):
    """Raise unless the launch returned cudaSuccess: a refused launch
    never runs, and no later synchronise reports it."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.rt_error_string(rc).decode())


def build_log(name: str = "bounce") -> str:
    """The compiler output of the last build of ``name`` (ptxas register
    and shared-memory use included)."""
    return (library_path(name).parent / "build.log").read_text()
