"""Time variants of the f32 tensor-core body's launch constants on the card.

    python -m protein_redesign_tpu_torch.kernels.variants

The 3xTF32 body of K3 and K5 (``csrc/attention_tf32.cu``) fixes two
constants: the warps of a block (8: 128 queries, as K3's bf16 body) and the
blocks that must fit on an SM at once, which caps its registers
(``kF32MinBlocks``: 2 blocks of 8 warps up to CP = 32, 128 registers).
This script builds the shipped source and variants of it, each from a copy
of ``csrc/`` whose constants are rewritten, into libraries of their own
(one nvcc each, all started together), and times K5 in f32 at chip_smoke's
phase-9 shape (R = N = 1024, H = 4, C = 16, 997 nodes valid, the padded
rows fully masked) on the same inputs: CUDA events around calls queued
behind a spin on the card, the variants in turns (ABBA...), the median of
the rounds. Each variant's output is held to the shipped one's (1e-5).
It prints ptxas's registers and spills for the instantiation at C = 16,
the card's name and power limit, and one line per variant.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from . import COMPILE_FLAGS, CSRC_DIR, HEADERS, find_nvcc

SOURCE = "attention_tf32.cu"
WARPS = re.compile(r"constexpr int kF32Warps = \d+")
MIN_BLOCKS = re.compile(r"constexpr int kF32MinBlocks = [^;]+;")
# (label, warps a block, the kF32MinBlocks expression)
VARIANTS = (
    ("shipped: 8 warps, 2 blocks a SM (128 registers)", 8, "NT <= 4 ? 2 : 1"),
    ("8 warps, 3 blocks a SM (80 registers)", 8, "NT <= 2 ? 3 : (NT <= 4 ? 2 : 1)"),
    ("4 warps, 4 blocks a SM (128 registers)", 4, "NT <= 4 ? 4 : 2"),
    ("4 warps, 6 blocks a SM (80 registers)", 4, "NT <= 2 ? 6 : (NT <= 4 ? 4 : 2)"),
)
R, N, H, C, N_VALID, SCALE = 1024, 1024, 4, 16, 997, 0.25
ROUNDS, CALLS = 6, 5


def build_variant(workdir: Path, warps: int, min_blocks: str, nvcc: str) -> subprocess.Popen:
    """Start nvcc on a copy of csrc/ with the two constants rewritten."""
    src_dir = workdir / "csrc"
    shutil.copytree(CSRC_DIR, src_dir, ignore=shutil.ignore_patterns("*.o"))
    path = src_dir / SOURCE
    text = path.read_text()
    for pattern, value in ((WARPS, f"constexpr int kF32Warps = {warps}"),
                           (MIN_BLOCKS, f"constexpr int kF32MinBlocks = {min_blocks};")):
        text, count = pattern.subn(value, text)
        if count != 1:
            raise RuntimeError(f"{SOURCE}: expected one match of {pattern.pattern}, got {count}")
    path.write_text(text)
    assert all((src_dir / h).exists() for h in HEADERS)
    compile_flags = [f for f in COMPILE_FLAGS if f != "-c"]
    return subprocess.Popen([nvcc, *compile_flags, "-shared", "-o",
                             str(workdir / "lib.so"), str(path)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_line(log: str) -> str:
    """Registers and spills of K5's instantiation at C = 16 (NT = 2)."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "tf32x3" in line and "ILb1ELi2E" in line:
            tail = " ".join(x.strip() for x in lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", tail)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", tail)
            return (f"{regs.group(1) if regs else '?'} registers, spills "
                    f"{spill.group(1) + '/' + spill.group(2) if spill else '?'} bytes")
    return "not found"


def inputs():
    g = torch.Generator(device="cuda").manual_seed(200)
    q, k, v = (torch.randn(R, N, H, C, generator=g, device="cuda") for _ in range(3))
    node = (torch.arange(N, device="cuda") < N_VALID).float()
    mask = (node[:, None] * node[None, :]).repeat(R // N, 1).contiguous()
    return q, k, v, mask


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("variants: a CUDA card is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    nvcc = find_nvcc()
    q, k, v, mask = inputs()
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    with tempfile.TemporaryDirectory() as tmp:
        dirs = [Path(tmp) / f"v{i}" for i in range(len(VARIANTS))]
        procs = []
        for d, (_, warps, min_blocks) in zip(dirs, VARIANTS):
            d.mkdir()
            procs.append(build_variant(d, warps, min_blocks, nvcc))
        logs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        fns, outs = [], []
        for d in dirs:
            lib = ctypes.CDLL(str(d / "lib.so"))
            fn = lib.prd_rows_attention_kchunk_tf32x3
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float]
                           + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            out = torch.empty_like(q)
            m, logs_ = (torch.empty(R, H, N, device="cuda") for _ in range(2))

            def call(fn=fn, out=out, m=m, logs_=logs_):
                code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                          out.data_ptr(), m.data_ptr(), logs_.data_ptr(), R, N, H, C, SCALE,
                          *strides, torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"launch failed: CUDA error {code}")

            call()
            torch.cuda.synchronize()
            fns.append(call)
            outs.append((out, m, logs_))
        for out, m, logs_ in outs[1:]:
            for got, want in zip((out, m, logs_), outs[0]):
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        times = [[] for _ in VARIANTS]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for r in range(ROUNDS):
            order = range(len(VARIANTS)) if r % 2 == 0 else reversed(range(len(VARIANTS)))
            for i in order:
                torch.cuda._sleep(50_000_000)
                start.record()
                for _ in range(CALLS):
                    fns[i]()
                end.record()
                torch.cuda.synchronize()
                times[i].append(start.elapsed_time(end) / CALLS)
    print(smi)
    print(f"K5 f32, R={R} N={N} H={H} C={C} ({N_VALID} valid): ms on the device, median of "
          f"{ROUNDS} rounds of {CALLS} calls (min-max)")
    for (label, _, _), t, log in zip(VARIANTS, times, logs):
        print(f"  {label}: {statistics.median(t):.3f} ({min(t):.3f}-{max(t):.3f}); "
              f"{ptxas_line(log)}")


if __name__ == "__main__":
    sys.exit(main())
