"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every source under ``myraytracer_tpu_torch/csrc/`` compiles to an object
(one nvcc process per source, all started together) and all objects link
into one shared library with a plain C interface (no PyTorch headers, so
the build takes seconds):

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
shading kernels and the latency-bound BVH walk (``NO_FMA``) are built
with ``-fmad=false``, which keeps every a*b+c rounded twice, as the
plain PyTorch versions compute it: there, kernel and plain version agree
bit for bit.

Each C entry point takes device pointers and the CUDA stream as
``void*`` and returns ``cudaGetLastError()`` after its launch;
:func:`launch` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
NO_FMA = ("bvh_walk.cu", "shade.cu", "shade_grad.cu")

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
    "bvh_walk_closest": 0,
    "bvh_walk_anyhit": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
#: argument types of every C entry point (pointers and stream as void*)
_SIGNATURES = {
    "mrt_phase1_exact": [_P] * 6 + [_I] * 3 + [_P],
    "mrt_cluster_scan": [_P] * 13 + [_I] * 5 + [_P],
    "mrt_shade_pre": [_P] * 8 + [_I] + [_P] * 3 + [_I] * 4 + [_P] * 9,
    "mrt_shade_phong": [_P] * 15 + [_I] * 3 + [_P] * 5,
    "mrt_seg_fwd": [_P] * 5 + [_I] + [_P] * 8 + [_I] * 2 + [_P] * 5,
    "mrt_seg_bwd": [_P] * 5 + [_I] + [_P] * 12 + [_I] * 2 + [_P] * 6,
    "mrt_bvh_walk": [_P] * 9 + [_I] * 4 + [_P],
}

#: C helpers that give a kernel's dynamic shared memory per block, in
#: bytes, from its shape arguments
_SMEM_SIZES = {
    "mrt_phase1_exact_smem": [_I],
    "mrt_cluster_scan_smem": [_I],
    "mrt_seg_bwd_smem": [_I],
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
        # one nvcc per source, all started together
        objs, procs = [], []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = Path(tmp) / f"{src.stem}.o"
            fma = ("-fmad=false",) if src.name in NO_FMA else ()
            cmd = [nvcc, *NVCC_FLAGS, *fma, "-Xptxas", "-v", "-c", src, "-o",
                   obj]
            procs.append(subprocess.Popen(
                [str(c) for c in cmd], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
            objs.append(obj)
        failed = []
        for proc in procs:
            out_text, _ = proc.communicate()
            log.append(out_text)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{out_text}")
        if failed:
            raise RuntimeError("\n".join(failed))
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
        for name, argtypes in _SMEM_SIZES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_size_t
        lib.mrt_bvh_walk_threads.argtypes = []
        lib.mrt_bvh_walk_threads.restype = ctypes.c_int
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


def check_inputs(name: str, device: torch.device, widths=None,
                 **tensors) -> None:
    """Raise unless every tensor is contiguous, on ``device``, with the
    dtype its name ends in (``_f`` float32, ``_i`` int32, ``_b`` bool),
    and unless each tensor named in ``widths`` is a [N, width] table."""
    for key, t in tensors.items():
        want = _DTYPES[key[-1]]
        if t.device != device or t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f"{name}: {key[:-2]} must be a contiguous {want} tensor on "
                f"{device}, got {t.dtype} on {t.device}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    for key, width in (widths or {}).items():
        t = tensors[key]
        if t.dim() != 2 or t.shape[1] != width:
            raise ValueError(f"{name}: {key[:-2]} must be [N, {width}], got "
                             f"{tuple(t.shape)}")


def kernel_resources(log: str) -> dict:
    """Per-kernel resources from ptxas's ``-v`` report in the build log:
    mangled entry name -> {"registers", "smem_static" (bytes), "spill_stores",
    "spill_loads", "stack_frame" (bytes)}. Dynamic shared memory is set at
    launch (``_SMEM_SIZES``)."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = {"registers": None, "smem_static": 0,
                          "spill_stores": 0, "spill_loads": 0,
                          "stack_frame": 0}
            continue
        if entry is None:
            continue
        for key, pat in (("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("stack_frame", r"(\d+) bytes stack frame")):
            m = re.search(pat, line)
            if m:
                out[entry][key] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[entry]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                out[entry]["smem_static"] = int(m.group(1))
            entry = None
    return out


def sass(path: Path) -> str:
    """The SASS of the built library, as ``cuobjdump -sass`` prints it.
    Raises RuntimeError when cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found")
    return subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout


def kernel_sass(path: Path) -> dict:
    """Static counts from the SASS of the built library (:func:`sass`):
    mangled entry name -> {"instructions", "ldl", "stl" (local-memory
    loads and stores: spills and stack arrays), "atomics" (ATOM, RED),
    "loops": [instructions of each loop body, from a backward branch's
    target to the branch, in address order]}.

    Raises RuntimeError when cuobjdump is missing.
    """
    text = sass(path)
    out, fn, code = {}, None, []

    def close():
        if fn is None:
            return
        ops = [op for _, op in code]
        addr = [a for a, _ in code]
        loops = []
        for i, (a, op) in enumerate(code):
            m = re.search(r"\bBRA(?:\.\S+)?\s+(?:\S+,\s*)?(0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) <= a:
                start = int(m.group(1), 16)
                loops.append(sum(1 for x in addr[:i + 1] if x >= start))
        out[fn] = {
            "instructions": len(ops),
            "ldl": sum(1 for op in ops if re.search(r"\bLDL\b", op)),
            "stl": sum(1 for op in ops if re.search(r"\bSTL\b", op)),
            "atomics": sum(1 for op in ops
                           if re.search(r"\b(ATOM|ATOMG|RED|REDG)\b", op)),
            "loops": loops}

    for line in text.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            close()
            fn, code = m.group(1), []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if fn is not None and m and not m.group(2).strip().startswith("NOP"):
            op = re.sub(r"^@!?U?P\w+\s+", "", m.group(2).strip())
            code.append((int(m.group(1), 16), op))
    close()
    return out
