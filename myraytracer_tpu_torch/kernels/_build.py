"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every source under ``myraytracer_tpu_torch/csrc/`` compiles to an object
and all objects link into one shared library with a plain C interface
(no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC [-fmad=false] -c csrc/<name>.cu
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o libmrt_kernels_<hash>.so *.o

The library is built at first use into ``myraytracer_tpu_torch/_build/``,
named by a hash of the sources and flags, so an edited source never
loads a stale build. ``--use_fast_math`` is never used (the slab tests
rely on IEEE 1/0 = inf and on comparisons with INF = 3e38).

FMA contraction: the compute-bound cluster scan keeps nvcc's default
contraction (10% faster on the H100, with hit ids equal to the plain
version's on all but 7 of 2,088,960 office rays). The memory-bound
shading kernels (``NO_FMA``) are built with ``-fmad=false``, which costs
them nothing and keeps every a*b+c rounded twice, as the plain PyTorch
versions compute it: there, kernel and plain version agree bit for bit.

Each C entry point takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch;
:func:`launch` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

#: sources built without FMA contraction (see the module docstring)
NO_FMA = ("shade.cu", "shade_grad.cu")

#: kernel launches so far, per kernel; a wrapper adds one where it
#: launches its kernel and nowhere else (reset with reset_launches)
LAUNCHES = {
    "phase1_exact": 0,
    "cluster_scan_closest": 0,
    "cluster_scan_anyhit": 0,
    "shade_pre": 0,
    "shade_phong": 0,
    "seg_fwd": 0,
    "seg_bwd": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
#: argument types of every C entry point (pointers and stream as void*)
_SIGNATURES = {
    "mrt_phase1_exact": [_P] * 6 + [_I] * 3 + [_P],
    "mrt_cluster_scan": [_P] * 13 + [_I] * 5 + [_P],
    "mrt_shade_pre": [_P] * 7 + [_I] + [_P] * 2 + [_I] * 3 + [_P] * 8,
    "mrt_shade_phong": [_P] * 13 + [_I] * 3 + [_P] * 5,
    "mrt_seg_fwd": [_P] * 5 + [_I] + [_P] * 8 + [_I] * 2 + [_P] * 5,
    "mrt_seg_bwd": [_P] * 5 + [_I] + [_P] * 12 + [_I] * 2 + [_P] * 6,
}

_lib = None

#: dtype of a check_inputs argument, by the letter its name ends in
_DTYPES = {"f": torch.float32, "i": torch.int32, "b": torch.bool}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + NO_FMA).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmrt_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the library unless it exists; returns (path, nvcc log).

    The log holds ptxas's per-kernel register and shared-memory report.
    """
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        return out, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    log = []

    def run(cmd):
        proc = subprocess.run([str(c) for c in cmd], capture_output=True,
                              text=True)
        log.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log[-1]}")

    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = Path(tmp) / f"{src.stem}.o"
            fma = ("-fmad=false",) if src.name in NO_FMA else ()
            run([nvcc, *NVCC_FLAGS, *fma, "-Xptxas", "-v", "-c", src, "-o",
                 obj])
            objs.append(obj)
        tmp_out = Path(tmp) / out.name
        run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_out, *objs])
        os.replace(tmp_out, out)
    log = "".join(log)
    log_path.write_text(log)
    return out, log


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.mrt_error_string.argtypes = [ctypes.c_int]
        lib.mrt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(entry: str, counter: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` on ``device``'s current stream.

    ``args`` are the entry point's arguments without the trailing stream.
    Raises RuntimeError when the launch reports a CUDA error.
    """
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        msg = lib.mrt_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err}: {msg}")
    LAUNCHES[counter] += 1


def check_inputs(name: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor is contiguous, on ``device``, with the
    dtype its name ends in (``_f`` float32, ``_i`` int32, ``_b`` bool)."""
    for key, t in tensors.items():
        want = _DTYPES[key[-1]]
        if t.device != device or t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f"{name}: {key[:-2]} must be a contiguous {want} tensor on "
                f"{device}, got {t.dtype} on {t.device}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")
