"""Build the port's CUDA sources at first use and load them with ctypes.

``load_cuda_library(name, sources)`` compiles ``csrc/*.cu`` with ``nvcc``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds) and caches it under ``src/repro_torch/_build/``,
keyed by a hash of the sources and flags: an edited source rebuilds, an
unchanged one loads the library already built. ``import_triton()`` points
Triton's own kernel cache into the same directory before importing it.

Nothing here runs at import time; a missing ``nvcc`` or a failed build
raises, and no caller falls back to a plain version. Libraries of different
names build concurrently when loaded from several threads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_lock = threading.Lock()  # guards _name_locks
_name_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    # PyTorch's own search: $CUDA_HOME, $CUDA_PATH, nvcc on PATH, /usr/local/cuda
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str, sources: list[Path]) -> Path:
    """Where the library built from ``sources`` lives (content-addressed)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(sources):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load_cuda_library(name: str, sources: list[Path]) -> ctypes.CDLL:
    """Compile (once per source hash) and load ``sources`` as one library."""
    with _lock:
        lock = _name_locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        out = library_path(name, sources)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed building {name} ({proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        lib = ctypes.CDLL(str(out))
        _loaded[name] = lib
        return lib


def import_triton():
    """Import Triton with its kernel cache inside the build directory."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton

    return triton
