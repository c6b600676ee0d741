"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together), linked into one shared library
with a plain C interface and loaded with ``ctypes``.  The library is keyed by
a hash of the sources and flags and lives under ``build/`` at the root of the
checkout, so the first call in a fresh checkout builds it and later calls
reuse it.  Nothing here runs at
import time.

Each wrapper that launches a kernel bumps that kernel's entry in
:data:`LAUNCHES` — real CUDA launches only, never the plain versions.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> count of real CUDA launches made by the kernel wrappers
LAUNCHES: collections.Counter = collections.Counter()

_LIB = None
_LOCK = threading.Lock()
BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: every pointer and the stream as void*, every int as int
SIGNATURES = {
    "gemm_tiled": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _P],
    "gemm_batch_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "gemm_batch_scatter_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                               _I, _P],
    "spdmm_f32": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _P],
    "spdmm_fused_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I,
                        _I, _I, _P, _I, _P],
    "spmm_fused_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _I,
                       _I, _I, _P, _P, _P],
}


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(repr(CFLAGS).encode())
    for p in sources + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if no build with the same digest exists; return
    its path.  The ``.so`` is moved into place atomically, so concurrent
    builds cannot load a half-written file."""
    sources = _sources()
    root = _repo_root() / "build" / "repro_torch"
    out = root / f"libkernels_{_digest(sources)}.so"
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True)
        return out
    root.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, subprocess.Popen(
                [nvcc, *CFLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        for src, p in procs:
            log, _ = p.communicate()
            logs.append(f"== {src.name}\n{log}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        lib_tmp = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(lib_tmp),
             *(str(Path(tmp) / (s.stem + ".o")) for s in sources)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib_tmp, out)
    (root / (out.stem + ".log")).write_text("\n".join(logs))
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0,
                      cached=False, ptxas="\n".join(logs))
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def require(ok: bool, what: str) -> None:
    """Shape precondition of a kernel wrapper: raise, never ``assert``
    (a wrong shape would send the kernel out of bounds)."""
    if not ok:
        raise ValueError(what)


def check_operand(name: str, t, dtype, ndim: int) -> None:
    """Refuse an operand the kernels do not take: not on a CUDA device, of
    another dtype or rank, or not contiguous."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} on {t.device}, expected a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_rows(name: str, t, dtype) -> None:
    """Refuse a matrix the kernels do not take as rows at a stride: not on
    a CUDA device, of another dtype, not 2-D, with columns that are not
    adjacent in memory, or with rows that overlap."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} on {t.device}, expected a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.ndim != 2:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         "2 dims")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} must have a column stride of 1")
    if t.shape[0] > 1 and t.stride(0) < t.shape[1]:
        raise ValueError(f"{name} has rows that overlap (row stride "
                         f"{t.stride(0)} for {t.shape[1]} columns)")


def predicate(pred) -> tuple[int | None, int]:
    """``(pointer, when)`` arguments of a predicated launch: ``pred`` is
    ``None`` (always run) or ``(flag, when)`` with ``flag`` a one-element
    int32 CUDA tensor; the kernel's thread blocks return at once unless
    ``flag == when``.  Read on the device only, so a captured program takes
    either branch without a host sync."""
    if pred is None:
        return None, 0
    flag, when = pred
    check_operand("pred", flag.reshape(-1), torch.int32, 1)
    require(flag.numel() == 1, f"predicate flag of {flag.numel()} elements")
    return flag.data_ptr(), int(when)


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")
