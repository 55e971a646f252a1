"""ctypes binding of ``rt_native.cpp``'s BVH builder.

The library is built with g++ at first use into
``raytracer_tpu_torch/_build/native/<hash of the source>/`` (gitignored)
and loaded from there. Where g++ is missing or the build fails,
``bvh_build`` returns None and ``why()`` says what went wrong; the caller
(``ops/bvh.py::build_bvh``) then builds with numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "rt_native.cpp"
BUILD = Path(__file__).resolve().parent.parent / "_build" / "native"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_state = {"lib": None, "tried": False, "why": "", "warned": False}


def _build() -> Path:
    """Compile the library unless it exists for this source; raise
    ``RuntimeError`` with the compiler's output on failure."""
    h = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes())
    out = BUILD / h.hexdigest()[:16] / "librt_native.so"
    if out.is_file():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    res = subprocess.run([gxx, *FLAGS, str(SRC), "-o", tmp],
                         capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed (rc {res.returncode}): "
                           f"{res.stderr.strip()[:500]}")
    os.replace(tmp, out)
    return out


def _load():
    with _lock:
        if not _state["tried"]:
            _state["tried"] = True
            try:
                lib = ctypes.CDLL(str(_build()))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                _state["why"] = str(e)
            else:
                f = lib.rt_bvh_build
                f.restype = ctypes.c_int
                f.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                              + [ctypes.c_void_p] * 6 + [ctypes.c_int])
                _state["lib"] = lib
        return _state["lib"]


def available() -> bool:
    return _load() is not None


def why() -> str:
    """Why the library is unavailable ("" if it is not known to be)."""
    _load()
    return _state["why"]


def warn_once(msg: str):
    """Print ``msg`` on stderr the first time only."""
    with _lock:
        if _state["warned"]:
            return
        _state["warned"] = True
    print(msg, file=sys.stderr)


def bvh_build(prim_min: np.ndarray, prim_max: np.ndarray,
              leaf_size: int = 4):
    """The flat BVH over primitive boxes (P, 3): (node_min, node_max,
    left, right, is_leaf, order), the layout of
    ``ops/bvh.py::_build_flat_python``; None if the library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = prim_min.shape[0]
    max_nodes = max(1, 2 * n)
    node_min = np.zeros((max_nodes, 3), np.float32)
    node_max = np.zeros((max_nodes, 3), np.float32)
    left = np.zeros((max_nodes,), np.int32)
    right = np.zeros((max_nodes,), np.int32)
    is_leaf = np.zeros((max_nodes,), np.int32)
    order = np.zeros((n,), np.int32)
    pmin = np.ascontiguousarray(prim_min, np.float32)
    pmax = np.ascontiguousarray(prim_max, np.float32)
    if pmin.shape != (n, 3) or pmax.shape != (n, 3):
        raise ValueError(f"primitive boxes {pmin.shape}, {pmax.shape}")
    k = lib.rt_bvh_build(pmin.ctypes.data, pmax.ctypes.data, n,
                         node_min.ctypes.data, node_max.ctypes.data,
                         left.ctypes.data, right.ctypes.data,
                         is_leaf.ctypes.data, order.ctypes.data, leaf_size)
    if k <= 0:
        raise ValueError(f"rt_bvh_build refused {n} primitives "
                         f"(leaf size {leaf_size})")
    return (node_min[:k], node_max[:k], left[:k], right[:k],
            is_leaf[:k].astype(bool), order)
