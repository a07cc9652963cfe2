"""Time variants of the tensor-core bodies' launch constants on the card.

    python -m protein_redesign_tpu_torch.kernels.variants [k1] [k5] [k6] [k1fast] [k10]
        [k10rows]

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

K1 fast's f32 body (``attention_tf32.cu``, ``k1fast``): its logits kept in
shared memory where they fit (``fast_stores_logits``) against recomputing
them from K in each of its three passes, at K1's phase-3 shapes (N = 192
and 384 of 147 and 360 valid). K10's split layout (``transition_mma.cu``,
``k10``, single_fc at bucket 192: M = 384, 512 -> 2048 -> 512 and 768 ->
3072 -> 768, both dtypes): the depth of its slab ring (``kRing``), the
block's rows (``split_warps``: 64 where they fit, else 32), and, to time
them alone, a build that stores its partial sums in place of adding them
(its outputs are wrong and not compared). K10's times include zeroing its
f32 scratch, as the wrapper does; its outputs are held to the shipped
build's at 1e-5 in f32 and 2e-2 in bf16 (the scratch's atomics sum in an
order that changes from run to run). K10's rows layout (``k10rows``,
pair_fc at bucket 192: M = 73,728, 64 -> 256 -> 64): 8 warps a block
against 16 in bf16, W2's pair of f32 values as one 8-byte load or two 4-byte
ones in the f32 second product, and, to time its parts, builds without the
LayerNorm, the first or the second product (timing only).
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
# K10's scratch: added to (shipped), or overwritten (timing only)
ATOMIC = "atomicAdd(reinterpret_cast<float4*>(p), v);"
STORE = "*reinterpret_cast<float4*>(p) = v;"
TIMING_ONLY = "timing only"
# K10's rows layout: its LayerNorm and its second product, kept or left out
LN_CALL = "    ln_in_place<T>(a_w, ldx, D, lane);\n"
PROD_OUT = "      prod_out<NO>(h, w2_s + c * kHid, ld2, lane, acc);\n"
PROD_HIDDEN = "      prod_hidden(a_w, ldx, w1_s + c * kHid * lda, lda, DP, lane, h);\n"
RESIDENT = "8"
W2_PAIR = ("const float2 w = *reinterpret_cast<const float2*>(w2 + (n * 8 + g) * ld2 + kk * 8 "
           "+ 2 * t4);")
W2_TWO = ("const float* w_p = w2 + (n * 8 + g) * ld2 + kk * 8 + 2 * t4; "
          "const float2 w = make_float2(w_p[0], w_p[1]);")
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
    "k1fast": dict(
        source="attention_tf32.cu",
        edits=(("attention_tf32.cu",
                r"bool fast_stores_logits\(size_t smem\) \{ return [^;]+; \}",
                "bool fast_stores_logits(size_t smem) {{ return {}; }}"),),
        kernels=("rows_attention_fast_tf32x3_kernelILb1ELi2E",
                 "rows_attention_fast_tf32x3_kernelILb0ELi2E"),
        shapes=((384, 192, 147), (768, 384, 360)),
        variants=(
            ("shipped: logits kept in shared memory where they fit", "smem <= 227 * 1024"),
            ("logits recomputed from K in each pass", "false"),
        ),
    ),
    "k10": dict(
        source="transition_mma.cu",
        edits=(("transition_mma.cu", r"constexpr int kRing = \d+;", "constexpr int kRing = {};"),
               ("transition_mma.cu", r"return split_smem<T>\(D, 4\) <= kMaxSmem \? 4",
                "return split_smem<T>(D, 4) <= kMaxSmem && {} ? 4"),
               ("transition_mma.cu",
                r"__device__ __forceinline__ void add4\(float\* p, float4 v\) \{\n  [^\n]*\n\}",
                "__device__ __forceinline__ void add4(float* p, float4 v) {{\n  {}\n}}")),
        kernels=("transition_mma_split_kernelI13__nv_bfloat16Li4EE",
                 "transition_mma_split_kernelIfLi4EE"),
        shapes=((torch.bfloat16, 384, 512, 2048, 512), (torch.float32, 384, 512, 2048, 512),
                (torch.bfloat16, 384, 768, 3072, 768), (torch.float32, 384, 768, 3072, 768)),
        variants=(
            ("shipped: a ring of 3 slabs, 64-row blocks where they fit", "3", "true", ATOMIC),
            ("a ring of 2 slabs (double buffering)", "2", "true", ATOMIC),
            ("a ring of 4 slabs", "4", "true", ATOMIC),
            ("32-row blocks at every width", "3", "false", ATOMIC),
            (f"{TIMING_ONLY}: partial sums stored, not added", "3", "true", STORE),
        ),
    ),
    "k10rows": dict(
        source="transition_mma.cu",
        edits=(("transition_mma.cu", r"constexpr int kResidentWarps = [^;]+;",
                "constexpr int kResidentWarps = {};"),
               ("transition_mma.cu", r"    ln_in_place<T>\(a_w, ldx, D, lane\);\n", "{}"),
               ("transition_mma.cu",
                r"      prod_out<NO>\(h, w2_s \+ c \* kHid, ld2, lane, acc\);\n", "{}"),
               ("transition_mma.cu",
                r"      prod_hidden\(a_w, ldx, w1_s \+ c \* kHid \* lda, lda, DP, lane, h\);\n",
                "{}"),
               ("transition_mma.cu",
                r"const float2 w = \*reinterpret_cast<const float2\*>\(w2 \+ \(n \* 8 \+ g\) \* ld2 "
                r"\+ kk \* 8 \+ 2 \* t4\);", "{}")),
        kernels=("transition_mma_rows_kernelI13__nv_bfloat16Li8ELi8EE",
                 "transition_mma_rows_kernelIfLi8ELi8EE"),
        shapes=((torch.bfloat16, 73728, 64, 256, 64), (torch.float32, 73728, 64, 256, 64)),
        variants=(
            ("shipped: 8 warps a block", RESIDENT, LN_CALL, PROD_OUT, PROD_HIDDEN, W2_PAIR),
            ("16 warps a block in bf16", "sizeof(T) == 2 ? 16 : 8", LN_CALL, PROD_OUT,
             PROD_HIDDEN, W2_PAIR),
            ("f32 second product: W2's pair as two 4-byte loads", RESIDENT, LN_CALL, PROD_OUT,
             PROD_HIDDEN, W2_TWO),
            (f"{TIMING_ONLY}: no LayerNorm", RESIDENT, "", PROD_OUT, PROD_HIDDEN, W2_PAIR),
            (f"{TIMING_ONLY}: no second product", RESIDENT, LN_CALL, "", PROD_HIDDEN, W2_PAIR),
            (f"{TIMING_ONLY}: no first product", RESIDENT, LN_CALL, PROD_OUT, "", W2_PAIR),
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


def inputs(name: str, shape):
    """The body's inputs at one shape: for K10 x, W1, b1, W2, b2 (seeded)
    and its output and f32 scratch; for the attention bodies q, k, v, dO,
    the rows mask, and K5's out, m and log s with the delta = rowsum(dO o O)
    that K6 takes, from the shipped kernels."""
    from ..ops import attention as A

    if name.startswith("k10"):
        dtype, M, D, Hd, Dout = shape
        g = torch.Generator(device="cuda").manual_seed(210)
        x = torch.randn(M, D, generator=g, device="cuda").to(dtype)
        w1 = (torch.randn(Hd, D, generator=g, device="cuda") * D ** -0.5).to(dtype)
        w2 = (torch.randn(Dout, Hd, generator=g, device="cuda") * Hd ** -0.5).to(dtype)
        b1, b2 = (0.3 * torch.randn(n, generator=g, device="cuda") for n in (Hd, Dout))
        return (x, w1, b1, w2, b2, torch.empty(M, Dout, dtype=dtype, device="cuda"),
                torch.zeros(M, Dout, device="cuda"))
    R, N, n_valid = shape
    g = torch.Generator(device="cuda").manual_seed(200)
    q, k, v, dout = (torch.randn(R, N, H, C, generator=g, device="cuda") for _ in range(4))
    node = (torch.arange(N, device="cuda") < n_valid).float()
    mask = (node[:, None] * node[None, :]).repeat(R // N, 1).contiguous()
    out, m, logs = A.rows_attention_kchunk_stats(q, k, v, mask, SCALE)
    return q, k, v, dout, mask, m, logs, A._kchunk_delta(dout, out)


def make_call(name: str, lib, tensors):
    """The variant's call and the outputs it writes."""
    stream = torch.cuda.current_stream().cuda_stream
    if name.startswith("k10"):
        x, w1, b1, w2, b2, out, out32 = tensors
        fn = lib.prd_transition_mma
        fn.argtypes = [PTR] * 7 + [I32] * 5 + [PTR]
        fn.restype = I32
        args = (*(t.data_ptr() for t in tensors), int(x.dtype == torch.bfloat16), x.shape[0],
                x.shape[1], w1.shape[0], w2.shape[0], stream)

        def call_k10():
            out32.zero_()
            code = fn(*args)
            if code:
                raise RuntimeError(f"launch failed: CUDA error {code}")

        return call_k10, (out,)
    q, k, v, dout, mask, m, logs, delta = tensors
    R, N = q.shape[:2]
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    if name in ("k1", "k1fast"):
        fn = lib.prd_rows_attention_tf32x3 if name == "k1" else lib.prd_rows_attention_fast_tf32x3
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


def time_variants(name: str, libs, tensors, labels):
    """Each variant's ms per call on the device at one shape, in turns; each
    variant's outputs (but a timing-only one's) held to the shipped one's."""
    fns, outs = [], []
    for lib in libs:
        call, written = make_call(name, lib, tensors)
        call()
        torch.cuda.synchronize()
        fns.append(call)
        outs.append(tuple(t.clone() for t in written))
    tol = 2e-2 if tensors[0].dtype == torch.bfloat16 else 1e-5
    for written, label in zip(outs[1:], labels[1:]):
        if label.startswith(TIMING_ONLY):
            continue
        for got, want in zip(written, outs[0]):
            torch.testing.assert_close(got, want, atol=tol, rtol=tol)
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
        for shape in body["shapes"]:
            times = time_variants(name, libs, inputs(name, shape), [v[0] for v in variants])
            if name.startswith("k10"):
                dtype, M, D, Hd, Dout = shape
                what = f"K10 {str(dtype)[6:]}, M={M}, {D} -> {Hd} -> {Dout}"
            else:
                R, N, n_valid = shape
                what = f"{name.upper()} f32, R={R} N={N} H={H} C={C} ({n_valid} valid)"
            print(f"{what}: ms on the device, median of {ROUNDS} rounds of {CALLS} calls "
                  f"(min-max)")
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
