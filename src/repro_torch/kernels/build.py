"""Build and load the port's CUDA kernel library.

The sources in ``repro_torch/csrc/*.cu`` (and the ``*.cuh`` headers they
share) expose a plain C interface, so they compile with ``nvcc`` alone (no
PyTorch headers, seconds instead of minutes) and bind through ``ctypes``.  Each source compiles to its own object, all
``nvcc`` processes started together, and the objects link into one shared
library under ``build/repro_torch/`` at the repository root.  A stamp of
the hash of every file in ``csrc/`` (sources and headers) skips the build
when nothing changed.  Nothing is built on import: the first kernel launch
builds, so the CPU tests, which never launch, need no CUDA toolkit.

Flags: ``-gencode arch=compute_90a,code=sm_90a -O3`` and no
``--use_fast_math`` — the queue_tick RED ramp needs IEEE division, and the
kernels pin every float operation they make with explicit intrinsics.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]
LIB_NAME = "librepro_torch_kernels.so"

_lib: ctypes.CDLL | None = None


BUILD_DIR = REPO_ROOT / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` in parallel and link the library; returns
    its path.  Raises with nvcc's output if a compile or the link fails."""
    out = BUILD_DIR
    out.mkdir(parents=True, exist_ok=True)
    lib = out / LIB_NAME
    stamp = out / "sources.sha256"
    sources = _sources()
    digest = _digest()
    with open(out / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not force and lib.exists() and stamp.exists() and stamp.read_text() == digest:
                return lib
            nvcc = _nvcc()
            procs = []
            for src in sources:
                obj = out / (src.stem + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                procs.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                )))
            failed = []
            for cmd, _, p in procs:
                log, _ = p.communicate()
                if p.returncode != 0:
                    failed.append(f"$ {' '.join(cmd)}\n{log}")
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
            tmp = out / (LIB_NAME + ".tmp")
            link = [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]]
            res = subprocess.run(link, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"link failed:\n$ {' '.join(link)}\n{res.stdout}{res.stderr}")
            os.replace(tmp, lib)
            stamp.write_text(digest)
            return lib
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # name: argument types (every entry point returns cudaGetLastError())
    "repro_seg_sum": [_P, _P, _I, ctypes.c_uint, _L, _P, _I, _I, _I, _P],
    "repro_seg_rank": [_P, _P, _P, _I, _I, _I, _P],
    "repro_reps_tick": [_P] * 9 + [_I] + [_P] * 3 + [_I, _I, _I, _L] + [_P] * 9 + [_P, _L, _P],
    "repro_queue_tick": [_P] * 5 + [_I] * 7 + [_F, _F, _I] + [_P] * 7,
    "repro_ecmp_hash": [_P, _P, _P, _P, _P, _L, _I, _L, _L, _L, _P],
    "repro_next_queue": [_P] * 8 + [_I, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P],
    "repro_next_queue_table": [_P] * 6 + [_I] * 4 + [_P] * 7 + [_I, _I, _I, _P, _P, _I, _I,
                                                                  _I, _I, _P, _P],
}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.repro_queue_tick_scratch_ints.argtypes = [_I]
        lib.repro_queue_tick_scratch_ints.restype = _L
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc} ({msg})")
