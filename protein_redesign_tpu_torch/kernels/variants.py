"""Time variants of the f32 tensor-core bodies' launch constants on the card.

    python -m protein_redesign_tpu_torch.kernels.variants [k1] [k5] [k6]

Each 3xTF32 body fixes a few constants. K5's forward (``csrc/attention_tf32.cu``
and the body it shares in ``attention_tf32.cuh``): the warps of a block
(``kF32Warps``, 8: 128 queries, as K3's bf16 body) and the blocks that must
fit on an SM at once, which caps its registers (``kF32MinBlocks``: 16 warps
a SM up to CP = 32, 128 registers). K1's forward, the same body: the warps
of a block by N (``rows_tf32x3_warps``: 4 where 128 queries would pad more
query slots than 64, else 8). K6's backward (``csrc/attention_bwd_tf32.cu``,
which K7 in f32 shares): the keys or queries of a streamed tile
(``kBwdF32Tile``) and the blocks of 4 warps a SM (``kBwdF32MinBlocks``). For
each body named (all by default) this script builds the shipped source and
variants of it, each from a copy of ``csrc/`` whose constants are
rewritten, into libraries of their own (one nvcc each, all started
together), and times the kernel on the same inputs at its shapes: K5 and K6
at chip_smoke's phase-9 shape (R = N = 1024, H = 4, C = 16, f32, 997 nodes
valid, the padded rows fully masked), K1 at phase 3's (R = 2 N, N = 192 and
512, H = 4, C = 16, f32, 147 and 401 nodes valid): CUDA events around calls
queued behind a spin on the card, the variants in turns (ABBA...), the
median of the rounds. Each variant's outputs are held to the shipped one's
(1e-5). It prints ptxas's registers and spills for the instantiations at C
= 16, the card's name and power limit, and one line per variant and shape.
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

H, C, SCALE = 4, 16, 0.25
ROUNDS, CALLS = 6, 5
PTR, I32, F32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

# the shape of K5 and K6: (R, N, nodes valid)
KCHUNK_SHAPE = (1024, 1024, 997)
# the blocks a SM of K5's variants, as kF32MinBlocks<WARPS, NT>: 128
# registers (16 warps a SM) up to CP = 32, or 80 (24 warps) at CP <= 16
MIN_BLOCKS_128 = "(NT <= 4 ? 16 : 8) / WARPS"
MIN_BLOCKS_80 = "(NT <= 2 ? 24 : (NT <= 4 ? 16 : 8)) / WARPS"
WARPS_RULE = "(N + 127) / 128 * 128 > (N + 63) / 64 * 64 ? 4 : 8"

# per body: the source it is built from, its constants' edits (file,
# pattern, new definition with {} for the value), its instantiations at C =
# 16 (mangled-name fragments), its shapes and its variants: (label, the
# constants' values)
BODIES = {
    "k1": dict(
        source="attention_tf32.cu",
        edits=(("attention_tf32.cu", r"int rows_tf32x3_warps\(int N\) \{ return [^;]+; \}",
                "int rows_tf32x3_warps(int N) {{ return {}; }}"),),
        kernels=("rows_attention_tf32x3_kernelILi4ELi2E", "rows_attention_tf32x3_kernelILi8ELi2E"),
        shapes=((384, 192, 147), (1024, 512, 401)),
        variants=(
            ("shipped: 4 warps where 128 queries pad more, else 8", WARPS_RULE),
            ("8 warps (128 queries) at every N", "8"),
            ("4 warps (64 queries) at every N", "4"),
        ),
    ),
    "k5": dict(
        source="attention_tf32.cu",
        edits=(("attention_tf32.cu", r"constexpr int kF32Warps = \d+", "constexpr int kF32Warps = {}"),
               ("attention_tf32.cuh", r"constexpr int kF32MinBlocks = [^;]+;",
                "constexpr int kF32MinBlocks = {};")),
        kernels=("tf32x3_kernelILb1ELi2E",),
        shapes=(KCHUNK_SHAPE,),
        variants=(
            ("shipped: 8 warps, 2 blocks a SM (128 registers)", "8", MIN_BLOCKS_128),
            ("8 warps, 3 blocks a SM (80 registers)", "8", MIN_BLOCKS_80),
            ("4 warps, 4 blocks a SM (128 registers)", "4", MIN_BLOCKS_128),
            ("4 warps, 6 blocks a SM (80 registers)", "4", MIN_BLOCKS_80),
        ),
    ),
    "k6": dict(
        source="attention_bwd_tf32.cu",
        edits=(("attention_bwd_tf32.cu", r"constexpr int kBwdF32Tile = [^;]+;",
                "constexpr int kBwdF32Tile = {};"),
               ("attention_bwd_tf32.cu", r"constexpr int kBwdF32MinBlocks = [^;]+;",
                "constexpr int kBwdF32MinBlocks = {};")),
        kernels=("kchunk_bwd_dq_tf32x3_kernelILi2E", "kchunk_bwd_dkdv_tf32x3_kernelILi2E"),
        shapes=(KCHUNK_SHAPE,),
        variants=(
            ("shipped: 64-row tiles, 4 blocks a SM (128 registers)", "NT <= 2 ? 64 : 32",
             "NT <= 2 ? 4 : (NT <= 4 ? 3 : 2)"),
            ("64-row tiles, 3 blocks a SM (168 registers)", "NT <= 2 ? 64 : 32",
             "NT <= 4 ? 3 : 2"),
            ("32-row tiles, 4 blocks a SM (128 registers)", "32", "NT <= 2 ? 4 : (NT <= 4 ? 3 : 2)"),
            ("32-row tiles, 3 blocks a SM (168 registers)", "32", "NT <= 4 ? 3 : 2"),
        ),
    ),
}


def build_variant(workdir: Path, body: dict, values, nvcc: str) -> subprocess.Popen:
    """Start nvcc on a copy of csrc/ with the body's constants rewritten."""
    src_dir = workdir / "csrc"
    shutil.copytree(CSRC_DIR, src_dir, ignore=shutil.ignore_patterns("*.o"))
    for (name, pattern, definition), value in zip(body["edits"], values):
        path = src_dir / name
        text, count = re.subn(pattern, definition.format(value), path.read_text())
        if count != 1:
            raise RuntimeError(f"{name}: expected one match of {pattern}, got {count}")
        path.write_text(text)
    assert all((src_dir / h).exists() for h in HEADERS)
    compile_flags = [f for f in COMPILE_FLAGS if f != "-c"]
    return subprocess.Popen([nvcc, *compile_flags, "-shared", "-o",
                             str(workdir / "lib.so"), str(src_dir / body["source"])],
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


def inputs(R: int, N: int, n_valid: int):
    """q, k, v, dO, the rows mask, and K5's out, m and log s with the
    delta = rowsum(dO o O) that K6 takes, from the shipped kernels."""
    from ..ops import attention as A

    g = torch.Generator(device="cuda").manual_seed(200)
    q, k, v, dout = (torch.randn(R, N, H, C, generator=g, device="cuda") for _ in range(4))
    node = (torch.arange(N, device="cuda") < n_valid).float()
    mask = (node[:, None] * node[None, :]).repeat(R // N, 1).contiguous()
    out, m, logs = A.rows_attention_kchunk_stats(q, k, v, mask, SCALE)
    return q, k, v, dout, mask, m, logs, A._kchunk_delta(dout, out)


def make_call(name: str, lib, tensors):
    """The variant's call and the outputs it writes."""
    q, k, v, dout, mask, m, logs, delta = tensors
    R, N = q.shape[:2]
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    stream = torch.cuda.current_stream().cuda_stream
    if name == "k1":
        fn = lib.prd_rows_attention_tf32x3
        fn.argtypes = [PTR] * 5 + [I32] * 4 + [F32] + [I64] * 9 + [PTR]
        outs = (torch.empty_like(q),)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), outs[0].data_ptr(),
                R, N, H, C, SCALE, *strides, stream)
    elif name == "k5":
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


def time_variants(name: str, libs, tensors):
    """Each variant's ms per call on the device at one shape, in turns."""
    fns, outs = [], []
    for lib in libs:
        call, written = make_call(name, lib, tensors)
        call()
        torch.cuda.synchronize()
        fns.append(call)
        outs.append(written)
    for written in outs[1:]:
        for got, want in zip(written, outs[0]):
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    times = [[] for _ in libs]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for r in range(ROUNDS):
        order = range(len(libs)) if r % 2 == 0 else reversed(range(len(libs)))
        for i in order:
            torch.cuda._sleep(50_000_000)
            start.record()
            for _ in range(CALLS):
                fns[i]()
            end.record()
            torch.cuda.synchronize()
            times[i].append(start.elapsed_time(end) / CALLS)
    return times


def run(name: str, nvcc: str) -> None:
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
        libs = [ctypes.CDLL(str(d / "lib.so")) for d in dirs]
        for R, N, n_valid in body["shapes"]:
            times = time_variants(name, libs, inputs(R, N, n_valid))
            print(f"{name.upper()} f32, R={R} N={N} H={H} C={C} ({n_valid} valid): ms on the "
                  f"device, median of {ROUNDS} rounds of {CALLS} calls (min-max)")
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
    print(smi)
    for name in names:
        run(name, nvcc)


if __name__ == "__main__":
    sys.exit(main())
