"""Build and bind the port's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface. ``nvcc`` compiles them
for Hopper (``sm_90a``) into a shared library under ``_build/`` on first use,
named by a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is. The library is bound with ``ctypes``:
every pointer and the stream are ``c_void_p``, and each entry point returns
its ``cudaGetLastError()``.

Nothing is built or loaded at import time: the CPU tests import every module
of the port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("attention.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class KernelLibrary:
    """The loaded shared library plus what its build reported."""

    def __init__(self, path: Path, build_seconds: Optional[float], build_log: str):
        self.path = path
        self.build_seconds = build_seconds  # None: reused an existing build
        self.build_log = build_log
        lib = ctypes.CDLL(str(path))
        ptr, i32, f32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        strides = [i64] * 9
        lib.prd_rows_attention.argtypes = (
            [ptr] * 5 + [i32] * 5 + [f32] + strides + [ptr]
        )
        lib.prd_rows_attention.restype = i32
        lib.prd_tiled_attention.argtypes = (
            [ptr] * 6 + [i32] * 5 + [f32] + strides + [ptr]
        )
        lib.prd_tiled_attention.restype = i32
        lib.prd_error_string.argtypes = [i32]
        lib.prd_error_string.restype = ctypes.c_char_p
        self.lib = lib

    def check(self, code: int, what: str) -> None:
        if code != 0:
            msg = self.lib.prd_error_string(code).decode()
            raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


_LIBRARY: Optional[KernelLibrary] = None


def find_nvcc() -> str:
    """nvcc from $PATH, $CUDA_HOME or /usr/local/cuda; raises when absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found ($PATH, $CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels are built from source on first use"
    )


def _source_digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> KernelLibrary:
    """Compile (when the hashed library is missing) and load the kernels."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    target = BUILD_DIR / f"libprd_kernels_{_source_digest()}.so"
    log_path = target.with_suffix(".log")
    build_seconds = None
    if not target.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(CSRC_DIR / s) for s in SOURCES)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - start
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, target)  # atomic: concurrent builders never see half a file
        log_path.write_text(log)
    log = log_path.read_text() if log_path.exists() else ""
    _LIBRARY = KernelLibrary(target, build_seconds, log)
    return _LIBRARY
