"""Build and bind the port's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface. On first use ``nvcc``
compiles each of them for Hopper (``sm_90a``), one process per source, all
started together, and links the objects into one shared library named by
a hash of the sources, the headers and the flags (their contents, not their
path), so an edited source is rebuilt and an unchanged one is loaded as it
is, from whichever copy of the package it comes. The library goes into the
directory ``build_dir()`` chooses: ``$PRD_TORCH_KERNEL_DIR`` when it is set;
else ``_build/`` beside this module when that can be written (a checkout);
else ``${XDG_CACHE_HOME:-~/.cache}/protein_redesign_tpu_torch/kernels`` (an
installed, read-only copy). The library is bound with ``ctypes``: every
pointer and the stream are ``c_void_p``, and each entry point returns its
``cudaGetLastError()``.

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
# An explicit build directory, as TORCH_EXTENSIONS_DIR is for torch's builds.
KERNEL_DIR_ENV = "PRD_TORCH_KERNEL_DIR"
SOURCES = ("attention.cu", "attention_mma.cu", "attention_bwd.cu", "attention_bwd_mma.cu",
           "attention_bwd_tf32.cu", "attention_kchunk.cu", "attention_tf32.cu",
           "attention_tiled_tf32.cu", "attention_kchunk_bwd.cu", "fused_gated.cu",
           "fused_gated_mma.cu", "trimul.cu", "trimul_mma.cu", "transition.cu",
           "transition_mma.cu", "outer.cu", "outer_mma.cu", "attention_kchunk_wide_tf32.cu",
           "attention_bwd_wide_mma.cu", "attention_bwd_wide_tf32.cu", "attention_rows_wide_tf32.cu",
           "attention_fast_wide_tf32.cu", "attention_kchunk_bwd_wide_mma.cu",
           "attention_kchunk_bwd_wide_tf32.cu", "fused_gated_wide.cu", "trimul_wide_mma.cu")
HEADERS = ("common.cuh", "mma.cuh", "attention_mma.cuh", "attention_tf32.cuh",
           "attention_bwd_wide.cuh", "ln_project.cuh", "fused_gated_rows.cuh", "trimul_rows.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c")
LINK_FLAGS = (*ARCH, "-shared")
# the build log's last section: each source and when its nvcc ended
NVCC_SECONDS = "== nvcc seconds from the build's start\n"


class KernelLibrary:
    """The loaded shared library plus what its build reported."""

    def __init__(self, path: Path, build_seconds: Optional[float], build_log: str):
        self.path = path
        self.build_seconds = build_seconds  # None: reused an existing build
        self.build_log = build_log
        # {source: seconds from the build's start to its nvcc's end}
        self.source_seconds = {
            src: float(s) for src, s in
            (line.split() for line in build_log.partition(NVCC_SECONDS)[2].splitlines())}
        lib = ctypes.CDLL(str(path))
        ptr, i32, f32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        strides = [i64] * 9
        lib.prd_rows_attention.argtypes = (
            [ptr] * 5 + [i32] * 5 + [f32] + strides + [ptr]
        )
        lib.prd_rows_attention.restype = i32
        lib.prd_rows_attention_fast.argtypes = lib.prd_rows_attention.argtypes
        lib.prd_rows_attention_fast.restype = i32
        lib.prd_tiled_attention.argtypes = (
            [ptr] * 6 + [i32] * 5 + [f32] + strides + [ptr]
        )
        lib.prd_tiled_attention.restype = i32
        lib.prd_tiled_attention_mma.argtypes = [ptr] * 6 + [i32] * 4 + [f32] + strides + [ptr]
        lib.prd_tiled_attention_mma.restype = i32
        lib.prd_rows_attention_fast_mma.argtypes = [ptr] * 5 + [i32] * 4 + [f32] + strides + [ptr]
        lib.prd_rows_attention_fast_mma.restype = i32
        lib.prd_rows_attention_mma.argtypes = lib.prd_rows_attention_fast_mma.argtypes
        lib.prd_rows_attention_mma.restype = i32
        lib.prd_rows_attention_tf32x3.argtypes = lib.prd_rows_attention_fast_mma.argtypes
        lib.prd_rows_attention_tf32x3.restype = i32
        lib.prd_rows_attention_fast_tf32x3.argtypes = lib.prd_rows_attention_fast_mma.argtypes
        lib.prd_rows_attention_fast_tf32x3.restype = i32
        for wide in ("rows_attention", "rows_attention_fast"):
            fn = getattr(lib, f"prd_{wide}_wide_tf32x3")
            fn.argtypes, fn.restype = lib.prd_rows_attention_fast_mma.argtypes, i32
        lib.prd_tiled_attention_tf32x3.argtypes = lib.prd_tiled_attention_mma.argtypes
        lib.prd_tiled_attention_tf32x3.restype = i32
        lib.prd_rows_attention_kchunk_mma.argtypes = (
            [ptr] * 7 + [i32] * 4 + [f32] + strides + [ptr]
        )
        lib.prd_rows_attention_kchunk_mma.restype = i32
        lib.prd_rows_attention_kchunk_tf32x3.argtypes = lib.prd_rows_attention_kchunk_mma.argtypes
        lib.prd_rows_attention_kchunk_tf32x3.restype = i32
        lib.prd_rows_attention_kchunk_wide_tf32x3.argtypes = (
            lib.prd_rows_attention_kchunk_mma.argtypes
        )
        lib.prd_rows_attention_kchunk_wide_tf32x3.restype = i32
        lib.prd_rows_attention_bwd.argtypes = (
            [ptr] * 9 + [i32] * 5 + [f32] + strides + [i64] * 3 + [ptr]
        )
        lib.prd_rows_attention_bwd.restype = i32
        lib.prd_rows_attention_bwd_mma.argtypes = (
            [ptr] * 9 + [i32] * 4 + [f32] + strides + [i64] * 3 + [ptr]
        )
        lib.prd_rows_attention_bwd_mma.restype = i32
        lib.prd_rows_attention_bwd_tf32x3.argtypes = lib.prd_rows_attention_bwd_mma.argtypes
        lib.prd_rows_attention_bwd_tf32x3.restype = i32
        for wide in ("mma", "tf32x3"):
            fn = getattr(lib, f"prd_rows_attention_bwd_wide_{wide}")
            fn.argtypes, fn.restype = lib.prd_rows_attention_bwd_mma.argtypes, i32
        lib.prd_rows_attention_kchunk.argtypes = (
            [ptr] * 7 + [i32] * 5 + [f32] + strides + [ptr]
        )
        lib.prd_rows_attention_kchunk.restype = i32
        lib.prd_rows_attention_kchunk_bwd.argtypes = (
            [ptr] * 11 + [i32] * 5 + [f32] + strides + [i64] * 3 + [ptr]
        )
        lib.prd_rows_attention_kchunk_bwd.restype = i32
        lib.prd_rows_attention_kchunk_bwd_mma.argtypes = (
            [ptr] * 11 + [i32] * 4 + [f32] + strides + [i64] * 3 + [ptr]
        )
        lib.prd_rows_attention_kchunk_bwd_mma.restype = i32
        lib.prd_rows_attention_kchunk_bwd_tf32x3.argtypes = (
            lib.prd_rows_attention_kchunk_bwd_mma.argtypes
        )
        lib.prd_rows_attention_kchunk_bwd_tf32x3.restype = i32
        for wide in ("mma", "tf32x3"):
            fn = getattr(lib, f"prd_rows_attention_kchunk_bwd_wide_{wide}")
            fn.argtypes, fn.restype = lib.prd_rows_attention_kchunk_bwd_mma.argtypes, i32
        lib.prd_fused_gated.argtypes = [ptr] * 9 + [i32] * 7 + [f32] + [i64] * 3 + [ptr]
        lib.prd_fused_gated.restype = i32
        lib.prd_fused_gated_mma.argtypes = lib.prd_fused_gated.argtypes
        lib.prd_fused_gated_mma.restype = i32
        lib.prd_fused_gated_project_mma.argtypes = (
            [ptr] * 5 + [i32] * 6 + [f32] + [i64] * 3 + [i32, ptr])
        lib.prd_fused_gated_project_mma.restype = i32
        lib.prd_fused_gated_out_mma.argtypes = [ptr] * 5 + [i32, i64, i32, i32, i32, ptr]
        lib.prd_fused_gated_out_mma.restype = i32
        lib.prd_trimul.argtypes = [ptr] * 10 + [i32] * 5 + [ptr]
        lib.prd_trimul.restype = i32
        lib.prd_trimul_mma.argtypes = [ptr] * 11 + [i32] * 5 + [ptr]
        lib.prd_trimul_mma.restype = i32
        lib.prd_trimul_wide.argtypes = lib.prd_trimul_mma.argtypes
        lib.prd_trimul_wide.restype = i32
        lib.prd_transition.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
        lib.prd_transition.restype = i32
        lib.prd_transition_mma.argtypes = lib.prd_transition.argtypes
        lib.prd_transition_mma.restype = i32
        lib.prd_transition_mma_layout.argtypes = [i32] * 4
        lib.prd_transition_mma_layout.restype = i32
        lib.prd_outer.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
        lib.prd_outer.restype = i32
        lib.prd_outer_mma.argtypes = [ptr] * 3 + [i64] + [ptr] * 2 + [i32] * 5 + [ptr]
        lib.prd_outer_mma.restype = i32
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


def _writable(directory: Path) -> bool:
    """Whether ``directory`` (or, while it does not exist, its nearest
    existing parent) can take the build: this process may write it, and its
    mode grants someone write permission, so a copy made read-only stays so
    for a root process too."""
    while not directory.exists():
        directory = directory.parent
    return os.access(directory, os.W_OK) and bool(directory.stat().st_mode & 0o222)


def build_dir() -> Path:
    """Where the library is looked for and built: ``$PRD_TORCH_KERNEL_DIR``;
    else ``BUILD_DIR`` when it can be written; else the user's cache."""
    explicit = os.environ.get(KERNEL_DIR_ENV)
    if explicit:
        return Path(explicit)
    if _writable(BUILD_DIR):
        return BUILD_DIR
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "protein_redesign_tpu_torch" / "kernels"


def _source_digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> KernelLibrary:
    """Compile (when the hashed library is missing) and load the kernels."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    directory = build_dir()
    target = directory / f"libprd_kernels_{_source_digest()}.so"
    log_path = target.with_suffix(".log")
    build_seconds = None
    if not target.exists():
        nvcc = find_nvcc()
        directory.mkdir(parents=True, exist_ok=True)
        start = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=directory) as tmp:
            objects = [str(Path(tmp) / f"{Path(s).stem}.o") for s in SOURCES]
            outputs = [Path(tmp) / f"{Path(s).stem}.out" for s in SOURCES]
            procs = []
            for src, obj, out in zip(SOURCES, objects, outputs):
                with open(out, "w") as f:
                    procs.append(subprocess.Popen(
                        [nvcc, *COMPILE_FLAGS, "-o", obj, str(CSRC_DIR / src)],
                        stdout=f, stderr=subprocess.STDOUT))
            done = {}  # source: seconds from the build's start to its nvcc's end
            while len(done) < len(procs):
                for src, proc in zip(SOURCES, procs):
                    if src not in done and proc.poll() is not None:
                        done[src] = time.perf_counter() - start
                time.sleep(0.05)
            log = "".join(f"== {src}\n{out.read_text()}" for src, out in zip(SOURCES, outputs))
            if any(proc.returncode != 0 for proc in procs):
                raise RuntimeError(f"nvcc failed:\n{log}")
            so = Path(tmp) / "lib.so"
            proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(so), *objects],
                                  capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
            log += NVCC_SECONDS + "".join(f"{src} {done[src]:.1f}\n" for src in SOURCES)
            # atomic: concurrent builders never see half a file
            os.replace(so, target)
        build_seconds = time.perf_counter() - start
        log_path.write_text(log)
    log = log_path.read_text() if log_path.exists() else ""
    _LIBRARY = KernelLibrary(target, build_seconds, log)
    return _LIBRARY
