"""ctypes binding of the native (C++) BVH builder.

Counterpart of ``myraytracer_tpu/runtime/native.py``. The source,
``runtime/bvh_builder.cpp``, is built at first use with

    g++ -O3 -std=c++17 -fPIC -shared -ffp-contract=off bvh_builder.cpp

into ``myraytracer_tpu_torch/_build/libmrt_bvh_<hash>.so``, named by a
hash of the source and the flags, through a temporary file and
``os.replace`` (as kernels/_build.py builds the CUDA kernels). There is
no ``-march=native`` and no FMA contraction, so a build on any x86 host
gives the NumPy builder's bits.

The builder is opt-in (``ops/bvh.build_bvh(native=True)``,
``Scene.build(native=True)``), and it never falls back: without a
compiler, or when the build fails, :func:`library` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "bvh_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")

_lib = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmrt_bvh_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. Raises
    RuntimeError without ``g++`` or when the compile fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native BVH builder cannot be "
                           "built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o",
                               str(tmp_out)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp_out, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded builder library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.mrt_bvh_build.restype = ctypes.c_void_p
        lib.mrt_bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mrt_bvh_export.restype = None
        lib.mrt_bvh_export.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_float)] * 2 + [
            ctypes.POINTER(ctypes.c_int32)] * 8
        _lib = lib
    return _lib


def build_bvh_native(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                     leaf_size: int, builder: str = "median"):
    """The native build of :func:`ops.bvh.build_bvh`'s tree: the same
    ``BVHArrays`` (see there for the arguments)."""
    from myraytracer_tpu_torch.ops.bvh import BVHArrays

    if builder not in ("median", "sah"):
        raise ValueError(f"builder must be 'median' or 'sah', got {builder!r}")
    lib = library()
    v0 = np.asarray(v0, np.float64)
    v1 = np.asarray(v1, np.float64)
    v2 = np.asarray(v2, np.float64)
    T = v0.shape[0]
    if T == 0:
        raise ValueError("build_bvh: no triangles")
    centroids = np.ascontiguousarray((v0 + v1 + v2) / 3.0)
    tri_min = np.ascontiguousarray(np.minimum(np.minimum(v0, v1), v2))
    tri_max = np.ascontiguousarray(np.maximum(np.maximum(v0, v1), v2))

    def dptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    n_nodes = ctypes.c_int64(0)
    handle = lib.mrt_bvh_build(dptr(centroids), dptr(tri_min), dptr(tri_max),
                               T, leaf_size, 1 if builder == "sah" else 0,
                               ctypes.byref(n_nodes))
    N = n_nodes.value
    bbmin = np.empty((N, 3), np.float32)
    bbmax = np.empty((N, 3), np.float32)
    left, first, count, axis = (np.empty(N, np.int32) for _ in range(4))
    entry = np.empty((8, N), np.int32)
    skip = np.empty((8, N), np.int32)
    order = np.empty(T, np.int32)
    max_leaf = ctypes.c_int32(0)

    def fptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def iptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    # the export writes every array and frees the builder
    lib.mrt_bvh_export(handle, fptr(bbmin), fptr(bbmax), iptr(left),
                       iptr(first), iptr(count), iptr(axis), iptr(entry),
                       iptr(skip), iptr(order), ctypes.byref(max_leaf))
    return BVHArrays(bbmin=bbmin, bbmax=bbmax, left=left, first=first,
                     count=count, axis=axis, entry=entry, skip=skip,
                     order=order, max_leaf=int(max_leaf.value))
