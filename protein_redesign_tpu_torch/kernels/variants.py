"""Time variants of the f32 tensor-core bodies' launch constants on the card.

    python -m protein_redesign_tpu_torch.kernels.variants [k5] [k6]

Each 3xTF32 body fixes two constants. K5's forward (``csrc/attention_tf32.cu``):
the warps of a block (``kF32Warps``, 8: 128 queries, as K3's bf16 body) and
the blocks that must fit on an SM at once, which caps its registers
(``kF32MinBlocks``: 2 blocks of 8 warps up to CP = 32, 128 registers). K6's
backward (``csrc/attention_bwd_tf32.cu``, which K7 in f32 shares): the keys
or queries of a streamed tile (``kBwdF32Tile``) and the blocks of 4 warps a
SM (``kBwdF32MinBlocks``). For each body named (both by default) this script
builds the shipped source and variants of it, each from a copy of ``csrc/``
whose constants are rewritten, into libraries of their own (one nvcc each,
all started together), and times the kernel at chip_smoke's phase-9 shape
(R = N = 1024, H = 4, C = 16, f32, 997 nodes valid, the padded rows fully
masked) on the same inputs: CUDA events around calls queued behind a spin
on the card, the variants in turns (ABBA...), the median of the rounds.
Each variant's outputs are held to the shipped one's (1e-5). It prints
ptxas's registers and spills for the instantiations at C = 16, the card's
name and power limit, and one line per variant.
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

R, N, H, C, N_VALID, SCALE = 1024, 1024, 4, 16, 997, 0.25
ROUNDS, CALLS = 6, 5
PTR, I32, F32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

# per body: its source, the two constants' patterns, its instantiations at
# C = 16 (mangled-name fragments) and its variants: (label, the two
# constants' new definitions)
BODIES = {
    "k5": dict(
        source="attention_tf32.cu",
        patterns=(r"constexpr int kF32Warps = \d+", r"constexpr int kF32MinBlocks = [^;]+;"),
        kernels=("tf32x3_kernelILb1ELi2E",),
        variants=(
            ("shipped: 8 warps, 2 blocks a SM (128 registers)", "8", "NT <= 4 ? 2 : 1"),
            ("8 warps, 3 blocks a SM (80 registers)", "8", "NT <= 2 ? 3 : (NT <= 4 ? 2 : 1)"),
            ("4 warps, 4 blocks a SM (128 registers)", "4", "NT <= 4 ? 4 : 2"),
            ("4 warps, 6 blocks a SM (80 registers)", "4", "NT <= 2 ? 6 : (NT <= 4 ? 4 : 2)"),
        ),
        definitions=("constexpr int kF32Warps = {}", "constexpr int kF32MinBlocks = {};"),
    ),
    "k6": dict(
        source="attention_bwd_tf32.cu",
        patterns=(r"constexpr int kBwdF32Tile = [^;]+;", r"constexpr int kBwdF32MinBlocks = [^;]+;"),
        kernels=("kchunk_bwd_dq_tf32x3_kernelILi2E", "kchunk_bwd_dkdv_tf32x3_kernelILi2E"),
        variants=(
            ("shipped: 64-row tiles, 4 blocks a SM (128 registers)", "NT <= 2 ? 64 : 32",
             "NT <= 2 ? 4 : (NT <= 4 ? 3 : 2)"),
            ("64-row tiles, 3 blocks a SM (168 registers)", "NT <= 2 ? 64 : 32",
             "NT <= 4 ? 3 : 2"),
            ("32-row tiles, 4 blocks a SM (128 registers)", "32", "NT <= 2 ? 4 : (NT <= 4 ? 3 : 2)"),
            ("32-row tiles, 3 blocks a SM (168 registers)", "32", "NT <= 4 ? 3 : 2"),
        ),
        definitions=("constexpr int kBwdF32Tile = {};", "constexpr int kBwdF32MinBlocks = {};"),
    ),
}


def build_variant(workdir: Path, body: dict, values, nvcc: str) -> subprocess.Popen:
    """Start nvcc on a copy of csrc/ with the body's two constants rewritten."""
    src_dir = workdir / "csrc"
    shutil.copytree(CSRC_DIR, src_dir, ignore=shutil.ignore_patterns("*.o"))
    path = src_dir / body["source"]
    text = path.read_text()
    for pattern, definition, value in zip(body["patterns"], body["definitions"], values):
        text, count = re.subn(pattern, definition.format(value), text)
        if count != 1:
            raise RuntimeError(f"{body['source']}: expected one match of {pattern}, got {count}")
    path.write_text(text)
    assert all((src_dir / h).exists() for h in HEADERS)
    compile_flags = [f for f in COMPILE_FLAGS if f != "-c"]
    return subprocess.Popen([nvcc, *compile_flags, "-shared", "-o",
                             str(workdir / "lib.so"), str(path)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_line(log: str, kernel: str) -> str:
    """Registers and spills of one instantiation (a mangled-name fragment)."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            tail = " ".join(x.strip() for x in lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", tail)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", tail)
            return (f"{regs.group(1) if regs else '?'} registers, spills "
                    f"{spill.group(1) + '/' + spill.group(2) if spill else '?'} bytes")
    return "not found"


def inputs():
    """q, k, v, dO, the rows mask, and K5's out, m and log s with the
    delta = rowsum(dO o O) that K6 takes, from the shipped kernels."""
    from ..ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(200)
    q, k, v, dout = (torch.randn(R, N, H, C, generator=g, device="cuda") for _ in range(4))
    node = (torch.arange(N, device="cuda") < N_VALID).float()
    mask = (node[:, None] * node[None, :]).repeat(R // N, 1).contiguous()
    out, m, logs = A.rows_attention_kchunk_stats(q, k, v, mask, SCALE)
    return q, k, v, dout, mask, m, logs, A._kchunk_delta(dout, out)


def make_call(name: str, lib, tensors):
    """The variant's call and the outputs it writes."""
    q, k, v, dout, mask, m, logs, delta = tensors
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream().cuda_stream
    if name == "k5":
        fn = lib.prd_rows_attention_kchunk_tf32x3
        fn.argtypes = [PTR] * 7 + [I32] * 4 + [F32] + [I64] * 9 + [PTR]
        outs = (torch.empty_like(q), torch.empty_like(m), torch.empty_like(m))
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                *(t.data_ptr() for t in outs), R, N, H, C, SCALE, *strides, stream)
    else:
        fn = lib.prd_rows_attention_kchunk_bwd_tf32x3
        fn.argtypes = [PTR] * 11 + [I32] * 4 + [F32] + [I64] * 12 + [PTR]
        outs = tuple(torch.empty_like(q) for _ in range(3))
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), dout.data_ptr(),
                m.data_ptr(), logs.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in outs),
                R, N, H, C, SCALE, *strides, *dout.stride()[:3], stream)
    fn.restype = I32

    def call():
        code = fn(*args)
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")

    return call, outs


def run(name: str, tensors, nvcc: str) -> None:
    body = BODIES[name]
    variants = body["variants"]
    with tempfile.TemporaryDirectory() as tmp:
        dirs = [Path(tmp) / f"v{i}" for i in range(len(variants))]
        procs = []
        for d, (_, *values) in zip(dirs, variants):
            d.mkdir()
            procs.append(build_variant(d, body, values, nvcc))
        logs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        fns, outs = [], []
        for d in dirs:
            call, written = make_call(name, ctypes.CDLL(str(d / "lib.so")), tensors)
            call()
            torch.cuda.synchronize()
            fns.append(call)
            outs.append(written)
        for written in outs[1:]:
            for got, want in zip(written, outs[0]):
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        times = [[] for _ in variants]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        for r in range(ROUNDS):
            order = range(len(variants)) if r % 2 == 0 else reversed(range(len(variants)))
            for i in order:
                torch.cuda._sleep(50_000_000)
                start.record()
                for _ in range(CALLS):
                    fns[i]()
                end.record()
                torch.cuda.synchronize()
                times[i].append(start.elapsed_time(end) / CALLS)
    print(f"{name.upper()} f32, R={R} N={N} H={H} C={C} ({N_VALID} valid): ms on the device, "
          f"median of {ROUNDS} rounds of {CALLS} calls (min-max)")
    for (label, *_), t, log in zip(variants, times, logs):
        regs = "; ".join(ptxas_line(log, kernel) for kernel in body["kernels"])
        print(f"  {label}: {statistics.median(t):.3f} ({min(t):.3f}-{max(t):.3f}); {regs}")


def main() -> None:
    names = sys.argv[1:] or list(BODIES)
    unknown = [n for n in names if n not in BODIES]
    if unknown:
        raise SystemExit(f"variants: unknown bodies {unknown}; choose from {list(BODIES)}")
    if not torch.cuda.is_available():
        raise SystemExit("variants: a CUDA card is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    nvcc = find_nvcc()
    tensors = inputs()
    print(smi)
    for name in names:
        run(name, tensors, nvcc)


if __name__ == "__main__":
    sys.exit(main())
