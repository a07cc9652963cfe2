"""Masked, biased multi-head attention: the plain PyTorch version and the
dispatch to the hand-written Hopper kernels.

Port of ``protein_redesign_tpu/ops/pallas_attention.py``: ``attention_reference``
is ``_attention_reference`` (:1242) at f32 logits, ``fused_attention`` is the
forward of ``fused_attention`` (:1265), and ``gated_attention_core`` is
``gated_attention_core`` (:1525). The two kernel wrappers replace the Pallas
kernels the denoiser's main path runs:

- ``rows_attention`` (K1) <- ``_rows_attention_impl`` / ``_make_rowhead_kernel``:
  key mask, no bias (triangle attention).
- ``rows_attention_fast`` (K1 fast) <- the same with ``fast=True``
  (``cfg.fast_softmax``, serving): the f32 logits rounded to bf16 after the
  -2^15 fill and the softmax taken in bf16 (`pallas_attention.py:103-130`).
- ``tiled_attention`` (K2) <- ``_tiled_attention_impl`` / ``_attn_kernel`` /
  ``_attn_kernel_nomask``: additive bias, key mask optional (single attention,
  SPAttention).

K1, K1 fast, K2, K3, K5, K6 and K7 have two bodies (``takes_mma``): on bf16
inputs with C a multiple of 8 a tensor-core one (``attention_mma.cu``;
K6's and K7's ``attention_bwd_mma.cu``: mma.sync, ldmatrix, cp.async),
else the CUDA-core one of ``attention.cu``, ``attention_kchunk.cu``,
``attention_kchunk_bwd.cu`` or ``attention_bwd.cu``. In f32 with C a
multiple of 8 every kernel takes a tensor-core body too (``takes_tf32x3``):
K1, K3 and K5 ``attention_tf32.cu`` (one body; C up to 128), K1 fast its own
body there (C up to 128: the logits kept in shared memory, P.V in two TF32
products of bf16 P), K2 ``attention_tiled_tf32.cu`` (C up to 1024), K6 and
K7 ``attention_bwd_tf32.cu`` (C up to 128): every product in 3xTF32, three
TF32 products of split operands, which keeps the 1e-5 parity that one TF32
product would break. f32 at C = 4 mod 8 keeps the CUDA-core bodies.
- ``rows_attention_bwd`` (K7) <- ``_rows_attention_bwd_impl`` /
  ``_make_rowhead_bwd_kernel``: the flash backward of K1.
- ``rows_attention_kchunk`` (K3, and K4 and the fori variant, which differ
  only in TPU layout) <- ``_rows_attention_kchunk_grid_cn`` /
  ``_make_rowhead_kchunk_grid_cn_kernel``: K1's function by online softmax
  over key chunks.
- ``rows_attention_kchunk_stats`` (K5) <- ``_kchunk_grid_cn_stats_call`` /
  ``_make_rowhead_kchunk_grid_cn_stats_kernel``: K3 plus the row max m and
  log s.
- ``rows_attention_kchunk_bwd`` (K6) <- ``_kchunk_grid_cn_grads_call`` /
  ``_make_rowhead_kchunk_grid_cn_bwd_kernel``: dq, dk, dv from those stats.
- ``fused_gated_rows_attention`` (K8) <- ``fused_gated_rows_attention``
  (:1142) / ``_fused_gated_impl`` / ``_make_fused_gated_kernel``: the whole
  no-bias GatedAttention (LN, projections, masked softmax, gate,
  out-projection), the switch ``use_pallas_fused_gated``. Two bodies
  (``fused_gated_takes_tensor_cores``): C a multiple of 8 the tensor-core one
  (``fused_gated_mma.cu``: mma.sync in bf16, 3xTF32 in f32), C = 4 mod 8
  the CUDA-core one (``fused_gated.cu``). Its backward
  differentiates the plain version ``fused_gated_reference``, as
  ``_fused_gated_bwd`` (:1227) differentiates ``_fused_gated_reference``.
  It computes in the input's dtype (f32 throughout in float32), where the
  TPU kernel rounds its operands to bf16 even in an f32 model.

Triangle attention has two regimes, chosen by ``kchunk_select`` as the JAX
``_kchunk_select`` (:681) chooses them: below the switch (N < 2048 in bf16,
N < 1024 in f32) K1 forward and K7 backward; at or above it K3 when no input
needs a gradient, else K5 forward, which keeps (out, m, log s) for the
backward, and K6 backward, as the JAX ``_fwd``/``_bwd`` (:1425/:1454) do with
``kernel_bwd`` on, the training default. With ``kernel_bwd`` off
(``cfg.use_pallas_bwd`` False) the forward is K1, or K1 fast where
``fast_softmax`` is set, below the switch and K3 at or above it, and the
backward is the plain VJP of the f32 ``attention_reference`` in both regimes
(JAX ``_bwd`` :1461-1519). ``fast`` reaches K1 fast only there: with
``kernel_bwd`` on, the JAX package drops it (:1291-1294, :1449-1450), and
the K-chunk regime and K2 ignore it. K2's backward is the plain
recompute through ``attention_reference`` under autograd (the JAX einsum VJP,
:1509-1519: its dbias is [R, H, N, N] anyway, so the JAX package has no
backward kernel for it either).

Public functions keep the JAX layout: q, k, v are [R, N, H, C], mask [R, N],
bias [R, H, N, N]. A wrapper given CPU tensors runs the plain version; given
CUDA tensors it launches its kernel or raises. The kernels read q, k, v and
dO through their strides (head dimension contiguous, so the swapped "ending"
triangle layout needs no copy); the wrapper makes the mask (f32) and the bias
contiguous.

The port reads the JAX package's attention plan (``resolve_attention_plan``,
copied into ``models/denoiser.py``) only where it changes the function:
with ``fast_softmax`` on, where the plan leaves Pallas, a bf16 model's
attentions compute ``attention_reference_fast`` (plain tensor ops, as the
JAX package computes them in XLA). Everywhere else every model attention
goes through ``gated_attention_core`` to the kernel wrappers, at every N. Inside
``plain_route()`` it runs the plain versions on any device instead: autograd
of ``attention_reference`` below the switch, and the plain K3, K5 and K6 at
or above it (their memory is O(N * chunk), where autograd of the reference
would hold [R, H, N, N] logits). That block exists to compare the kernels
with the plain versions on the card; nothing on the main path enters it.

Each kernel's bound (head width, shared memory, grid) is a pure predicate
of shapes and dtype beside its constant (``attention_fits``, ``bwd_fits``,
``kchunk_fits``, ``fused_gated_fits``; ``trimul_fits``, ``transition_fits``
and ``outer_fits`` in their modules). Each wrapper reads its predicate
before it launches and raises ValueError on CUDA tensors past the bound;
``rows_attention`` reads K7's before the forward, so a backward K7 cannot
take fails before anything launches. No shape on CUDA tensors takes a plain
version instead of a kernel.
"""

from __future__ import annotations

import contextlib
import math
import warnings
from typing import Dict, Iterator, Optional

import torch

NEG_INF = -(2.0**15)  # the reference's padding fill (`pallas_attention.py:33`)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The tensor-core bodies (attention_mma.cu: K1, K1 fast, K2, K3, K5;
# attention_bwd_mma.cu: K6, K7; bf16, C a multiple of 8): a block's queries
# and two K and V tiles in shared memory.
MMA_SMEM_BYTES = 227 * 1024
MMA_BODIES = ("rows_attention", "rows_attention_fast", "tiled_attention", "rows_attention_kchunk",
              "rows_attention_kchunk_stats", "rows_attention_bwd", "rows_attention_kchunk_bwd")
KCHUNK_FORWARDS = ("rows_attention_kchunk", "rows_attention_kchunk_stats")  # K3, K5
BACKWARDS = ("rows_attention_bwd", "rows_attention_kchunk_bwd")  # K7, K6
# K3's tensor-core body takes 128 queries per block up to head width 128 (a
# (row, head)'s K and V are read from L2 once per query tile), 64 above it
# (shared memory).
KCHUNK_MMA_QUERIES, KCHUNK_MMA_WIDE_QUERIES = 128, 64

MAX_HEADS = 65535  # grid.y
# One block per (row, 16-query tile) at most, in grid.x's 2^31 - 1 blocks.
MIN_QUERY_TILE, MAX_BLOCKS = 16, 2**31 - 1


def mma_smem_bytes(C: int, queries: int = 64) -> int:
    """Shared memory of a tensor-core block (``smem_bytes`` in attention_mma.cu):
    ``queries`` query rows and two tiles of BK keys of the padded width CP = C
    rounded up to 16, plus two V tiles of the CS-channel output slice, in bf16."""
    cp = -(-C // 16) * 16
    bk = 64 if cp <= 128 else (32 if cp <= 512 else 16)
    cs = 16 if cp <= 16 else (32 if cp <= 32 else 64)
    return 2 * ((queries + 2 * bk) * (cp + 8) + 2 * bk * (cs + 8))


def _padded_tiles(C: int) -> int:
    """8-channel n-tiles of the padded head of K7's and the f32 body's
    kernels: the least power of two covering C (CP = 8 of them)."""
    nt = 1
    while 8 * nt < C:
        nt *= 2
    return nt


def bwd_mma_smem_bytes(C: int) -> int:
    """Shared memory of K6's and K7's tensor-core kernels (``dkdv_smem`` in
    attention_bwd_mma.cu, the larger of the two): 2 x 64 rows staged once and
    two buffers of two tiles of 64 rows (32 above CP = 64), CP + 8 bf16
    each, CP = C padded to 16, 32, 64 or 128, plus three f32 stats a tile row."""
    nt = max(2, _padded_tiles(C))
    tile = 64 if nt <= 8 else 32
    return 2 * (2 * 64 + 4 * tile) * (8 * nt + 8) + 4 * 6 * tile


def tf32x3_smem_bytes(C: int, queries: int = 128, bias: bool = False) -> int:
    """Shared memory of the f32 tensor-core one-pass body of K1, K3, K5 and
    K2 at C <= 128 (``rows_tf32x3_smem`` in attention_tf32.cuh): ``queries``
    queries (K3 and K5 128, K1 64 or 128 by N, K2 64) and two buffers of 64
    keys (32 from CP = 32 on) of K and V, CP + 4 floats a row, CP = C padded
    to 8, 16, 32, 64 or 128; with ``bias`` two [queries, keys + 8] bias
    tiles."""
    nt = _padded_tiles(C)
    keys = 64 if nt <= 2 else 32
    return 4 * ((queries + 4 * keys) * (8 * nt + 4) + (2 * queries * (keys + 8) if bias else 0))


# K2's f32 tensor-core body at C > 128 (attention_tiled_tf32.cu
# ``wide_smem``): two stages of 32 queries and 64 keys of 128 channels (132
# floats a row), and the bias, logits and P's two parts of a [32, 64] tile
# (68 floats a row), whatever C is.
TILED_WIDE_TF32X3_SMEM_BYTES = 4 * (2 * (32 + 64) * 132 + 4 * 32 * 68 + 2 * 32)


def tiled_tf32x3_smem_bytes(C: int) -> int:
    """Shared memory of K2's f32 tensor-core body at head width C: the
    one-pass body with 64 queries and the bias up to C = 128, the wide body
    above."""
    return (tf32x3_smem_bytes(C, 64, bias=True) if C <= MAX_KCHUNK_HEAD_DIM
            else TILED_WIDE_TF32X3_SMEM_BYTES)


def bwd_tf32x3_smem_bytes(C: int) -> int:
    """Shared memory of K6's and K7's f32 tensor-core kernels (``dkdv_smem``
    in attention_bwd_tf32.cu, the larger of the two): 2 x 64 rows staged once
    and two buffers of two tiles of 64 rows (32 from CP = 32 on), CP + 4
    floats each, CP = C padded to 8, 16, 32, 64 or 128, plus three f32 stats
    a tile row."""
    nt = _padded_tiles(C)
    tile = 64 if nt <= 2 else 32
    return 4 * ((2 * 64 + 4 * tile) * (8 * nt + 4) + 6 * tile)


def takes_mma(name: str, dtype: torch.dtype, C: int) -> bool:
    """Whether kernel ``name`` runs its bf16 tensor-core body at head width C
    in ``dtype``: K1, K1 fast, K2, K3 and K5 in bf16 when C is a multiple of
    8 (an mma operand row is 8 bf16) whose tiles fit shared memory; K7 and K6
    in bf16 when C is a multiple of 8 up to MAX_BWD_HEAD_DIM (their
    accumulators hold the whole head). Else the CUDA-core body, or in f32
    the 3xTF32 body where ``takes_tf32x3``."""
    if name not in MMA_BODIES or dtype != torch.bfloat16 or C <= 0 or C % 8:
        return False
    if name in BACKWARDS:
        return C <= MAX_BWD_HEAD_DIM and bwd_mma_smem_bytes(C) <= MMA_SMEM_BYTES
    queries = kchunk_queries(C) if name in KCHUNK_FORWARDS else 64
    return mma_smem_bytes(C, queries) <= MMA_SMEM_BYTES


def takes_tf32x3(name: str, dtype: torch.dtype, C: int) -> bool:
    """Whether kernel ``name`` runs its f32 tensor-core body (3xTF32) at head
    width C in ``dtype``: f32 with C a multiple of 8, K1, K1 fast, K3 and K5
    (attention_tf32.cu) and K6 and K7 (attention_bwd_tf32.cu) up to
    MAX_KCHUNK_HEAD_DIM (the accumulators hold the whole head), K2
    (attention_tiled_tf32.cu) up to MAX_HEAD_DIM (its wide body streams the
    head), each within its shared memory (K1 fast keeps its logits in shared
    memory where they fit and recomputes them past that, so N bounds
    nothing)."""
    if dtype != torch.float32 or C <= 0 or C % 8:
        return False
    if name == "tiled_attention":
        return C <= MAX_HEAD_DIM and tiled_tf32x3_smem_bytes(C) <= MMA_SMEM_BYTES
    if C > MAX_KCHUNK_HEAD_DIM:
        return False
    if name in BACKWARDS:
        return bwd_tf32x3_smem_bytes(C) <= MMA_SMEM_BYTES
    return (name in KCHUNK_FORWARDS + ("rows_attention", "rows_attention_fast")
            and tf32x3_smem_bytes(C) <= MMA_SMEM_BYTES)


def takes_tensor_cores(name: str, dtype: torch.dtype, C: int) -> bool:
    """Whether kernel ``name`` runs a tensor-core body (bf16 or 3xTF32)."""
    return takes_mma(name, dtype, C) or takes_tf32x3(name, dtype, C)


def kchunk_queries(C: int) -> int:
    """Queries per block of K3's tensor-core body at head width C."""
    return KCHUNK_MMA_QUERIES if C <= 128 else KCHUNK_MMA_WIDE_QUERIES


# The bound predicates below read shapes and dtype only. A dtype the kernels
# do not take (neither float32 nor bfloat16) is not a bound: the kernel
# wrappers raise TypeError for it.


def grid_fits(R: int, N: int, H: int) -> bool:
    """Whether R rows of N queries and H heads fit the attention kernels' grids."""
    return R > 0 and N > 0 and 0 < H <= MAX_HEADS and -(-N // MIN_QUERY_TILE) * R <= MAX_BLOCKS


def width_fits(C: int, max_width: int) -> bool:
    """A CUDA-core body's head width: a multiple of 4 (16-byte loads) up to
    ``max_width``."""
    return 0 < C <= max_width and C % 4 == 0


MAX_HEAD_DIM = 1024  # the CUDA-core bodies: C / 32 accumulators per lane and query


def attention_fits(name: str, R: int, N: int, H: int, C: int, dtype: torch.dtype) -> bool:
    """Whether K1, K1 fast or K2 (``name``) takes [R, N, H, C] operands of
    ``dtype``: a tensor-core body's shared memory (bf16 or 3xTF32, multiples
    of 8), else the CUDA-core body's C <= MAX_HEAD_DIM, a multiple of 4."""
    return grid_fits(R, N, H) and (takes_tensor_cores(name, dtype, C)
                                   or width_fits(C, MAX_HEAD_DIM))


# K7: the CUDA-core body holds rows in registers to C = 32, then 4 x C / 32
# accumulators per lane; the tensor-core body a warp's 16 rows of the whole
# head's gradients (C / 2 accumulators a thread)
MAX_BWD_HEAD_DIM = 128


def bwd_fits(R: int, N: int, H: int, C: int, dtype: torch.dtype) -> bool:
    """Whether K7 takes the backward of [R, N, H, C] operands of ``dtype``:
    a tensor-core body's shared memory (bf16 or 3xTF32, multiples of 8),
    else the CUDA-core body's C <= MAX_BWD_HEAD_DIM, a multiple of 4."""
    return grid_fits(R, N, H) and (takes_tensor_cores("rows_attention_bwd", dtype, C)
                                   or width_fits(C, MAX_BWD_HEAD_DIM))


# K3, K5 and K6 on the CUDA cores: 4 x C / 32 accumulators per lane; K3 and
# K5 in f32 on the tensor cores: a warp's 16 rows of the whole head's output
# (C / 2 accumulators a thread)
MAX_KCHUNK_HEAD_DIM = 128


def kchunk_fits(name: str, R: int, N: int, H: int, C: int, dtype: torch.dtype) -> bool:
    """Whether K3 (``name`` "rows_attention_kchunk"), K5 or K6 takes
    [R, N, H, C] operands of ``dtype``: the bf16 tensor-core body's shared
    memory, the 3xTF32 body's (f32), else the CUDA-core body's C <=
    MAX_KCHUNK_HEAD_DIM."""
    return grid_fits(R, N, H) and (takes_tensor_cores(name, dtype, C)
                                   or width_fits(C, MAX_KCHUNK_HEAD_DIM))


# The K-chunk switch points and chunk target of the JAX package
# (`pallas_attention.py:140-147`, KCHUNK :147), without its environment
# overrides (TPU sweep knobs). The chunk sets the plain versions' key
# chunks; the kernels stream keys in tiles of 32 whatever it is.
ROWS_KCHUNK_MIN_N = 2048
ROWS_KCHUNK_MIN_N_F32 = 1024
KCHUNK = 256
# Elements of one [rows, H, N, chunk] f32 block of the plain K-chunk
# versions: they take rows in blocks so their memory stays bounded.
PLAIN_BLOCK_ELEMS = 1 << 26

# Launches of each kernel since the last reset. A wrapper adds one where it
# launches its kernel and nowhere else.
LAUNCHES: Dict[str, int] = {
    "rows_attention": 0, "rows_attention_fast": 0, "tiled_attention": 0, "rows_attention_bwd": 0,
    "rows_attention_kchunk": 0, "rows_attention_kchunk_stats": 0, "rows_attention_kchunk_bwd": 0,
    # the fused kernels: K8 here, K9-K11 in ops/trimul.py, transition.py, outer.py
    "fused_gated_rows_attention": 0, "triangle_multiply": 0, "fused_transition": 0,
    "fused_outer_linear": 0,
}

_PLAIN_ROUTE = False  # set only inside plain_route()
_WARNED: set = set()  # the plain-VJP warnings already given in this process


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def plain_route_active() -> bool:
    """True inside ``plain_route()``."""
    return _PLAIN_ROUTE


def layer_norm_f32(x: torch.Tensor) -> torch.Tensor:
    """Non-affine LayerNorm over the last axis in f32, eps 1e-5 (the fused
    kernels' ``_ln``)."""
    return torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), eps=1e-5)


def plain_vjp(plain, saved, needs_input_grad, dout, *static):
    """Gradients of ``plain(*saved, *static)`` for the inputs that need one
    (None elsewhere; a mask gets None, its gradient being zero where it is
    defined): the backward of K2 and of the fused kernels, which
    differentiate their plain version, as the JAX VJPs differentiate their
    reference math."""
    wanted = [i for i, t in enumerate(saved) if t is not None and needs_input_grad[i]]
    inputs = list(saved)
    with torch.enable_grad():
        for i in wanted:
            inputs[i] = inputs[i].detach().requires_grad_()
        out = plain(*inputs, *static)
        grads = torch.autograd.grad(out, [inputs[i] for i in wanted], dout,
                                    allow_unused=True) if wanted else ()
    result = [None] * len(saved)
    for i, grad in zip(wanted, grads):
        result[i] = grad
    return result


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as JAX rounds a Python scalar that
    meets an array of that dtype (``q * scale`` in bf16 uses the bf16 scale)."""
    return float(torch.tensor(value, dtype=dtype))


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax in f32 with the -2^15 key-padding fill; ``mask`` broadcasts
    over the key axis (`layers.py` ``masked_softmax``)."""
    logits = logits.float()
    if mask is not None:
        logits = torch.where(mask < 0.5, NEG_INF, logits)
    return torch.softmax(logits, dim=-1)


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    scale: float,
) -> torch.Tensor:
    """Plain version: softmax(q k^T * scale + bias, masked) v with f32
    logits, probabilities rounded to v's dtype and f32 accumulation."""
    qs = q * weak_scalar(scale, q.dtype)
    logits = torch.einsum("rihc,rjhc->rhij", qs.float(), k.float())
    if bias is not None:
        logits = logits + bias.float()
    probs = masked_softmax(logits, None if mask is None else mask[:, None, None, :])
    out = torch.einsum("rhij,rjhc->rihc", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def attention_reference_fast(q, k, v, mask: Optional[torch.Tensor],
                             bias: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """The bf16-logit attention: ``_attention_reference(..., fast_softmax=True)``
    (`pallas_attention.py:1242-1261`), the function the JAX package evaluates
    in XLA wherever its attention plan leaves Pallas and ``cfg.fast_softmax``
    is on. Every step runs in q's dtype: the logits gemm of the pre-scaled q
    (f32 sums, rounded once), the bias added, the -2^15 fill, then max, exp
    and the division, the sum accumulated in f32 and rounded; P cast to v's
    dtype and P.V accumulated in f32. For f32 inputs this is
    ``attention_reference``'s function. Plain tensor ops on any device, and
    differentiable by autograd, as JAX differentiates the same function
    there. Where the JAX plan also chunks queries (``attn_chunk``, N >= 768)
    this computes the same function unchunked."""
    dt = q.dtype
    qs = q * weak_scalar(scale, dt)
    logits = torch.einsum("rihc,rjhc->rhij", qs.float(), k.float()).to(dt)
    if bias is not None:
        logits = logits + bias.to(dt)
    if mask is not None:
        logits = logits.masked_fill(mask[:, None, None, :] < 0.5, NEG_INF)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = e / e.float().sum(-1, keepdim=True).to(dt)
    out = torch.einsum("rhij,rjhc->rihc", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def rows_attention_fast_reference(q, k, v, mask, scale: float) -> torch.Tensor:
    """Plain version of K1 fast: masked attention without bias whose softmax
    runs in bf16, with the Pallas body's rounding points (`_make_rowhead_kernel`
    with ``fast``, then ``jax.nn.softmax`` on bf16 logits): the scaled q
    rounded to the input dtype, f32 logits, the -2^15 fill, the logits
    rounded to bf16; m = max, e = exp(l - m) and p = e / sum(e), each a bf16
    op (the sum accumulated in f32, then rounded); p cast to v's dtype (its
    bf16 values kept in an f32 model), P.V accumulated in f32, the output
    in the input dtype."""
    qs = q * weak_scalar(scale, q.dtype)
    logits = torch.einsum("rihc,rjhc->rhij", qs.float(), k.float())
    logits = torch.where(mask[:, None, None, :] < 0.5, NEG_INF, logits).to(torch.bfloat16)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = e / e.float().sum(-1, keepdim=True).to(torch.bfloat16)
    out = torch.einsum("rhij,rjhc->rihc", probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def rows_attention_bwd_reference(q, k, v, mask, dout, scale: float):
    """Plain version of K7: (dq, dk, dv) of masked attention without bias
    given dO [R, N, H, C], with the Pallas kernel's roundings
    (`_make_rowhead_bwd_kernel`): f32 probabilities, dv from probabilities
    rounded to v's dtype, dS = P(dP - rowsum(dP P)) zeroed at masked keys
    and rounded to q's dtype, f32 sums, outputs in the input dtype. dq is
    taken through the pre-scaled q and multiplied by the dtype-rounded
    scale, as ``_bwd`` does (`jnp.swapaxes(dqt, 1, 2) * scale`)."""
    w = weak_scalar(scale, q.dtype)
    qt = (q * w).float()
    logits = torch.einsum("rihc,rjhc->rhij", qt, k.float())
    masked = mask[:, None, None, :] < 0.5
    probs = torch.softmax(torch.where(masked, NEG_INF, logits), dim=-1)
    g = dout.float()
    dv = torch.einsum("rhij,rihc->rjhc", probs.to(v.dtype).float(), g).to(v.dtype)
    dp = torch.einsum("rihc,rjhc->rhij", g, v.float())
    ds = probs * (dp - (dp * probs).sum(-1, keepdim=True))
    ds = torch.where(masked, 0.0, ds).to(q.dtype).float()
    dqt = torch.einsum("rhij,rjhc->rihc", ds, k.float()).to(q.dtype)
    dk = torch.einsum("rhij,rihc->rjhc", ds, qt).to(k.dtype)
    return dqt * w, dk, dv


def kchunk_select(N: int, dtype: torch.dtype) -> int:
    """The key chunk of the K-chunk regime for N keys in ``dtype``, or 0
    below the switch (``_kchunk_select``, `pallas_attention.py:681-707`):
    the largest of KCHUNK, /2, /4, /8 that divides N; 0 when none does."""
    min_n = ROWS_KCHUNK_MIN_N
    if dtype == torch.float32:
        min_n = min(min_n, ROWS_KCHUNK_MIN_N_F32)
    if N < min_n:
        return 0
    for cand in (KCHUNK, KCHUNK // 2, KCHUNK // 4, KCHUNK // 8):
        if cand > 0 and N % cand == 0:
            return cand
    return 0


def _kchunk_blocks(q: torch.Tensor, kc: int):
    """Row slices of at most PLAIN_BLOCK_ELEMS logits per key chunk."""
    R, N, H, _ = q.shape
    rows = max(1, PLAIN_BLOCK_ELEMS // (H * N * kc))
    return [slice(r0, r0 + rows) for r0 in range(0, R, rows)]


def _plain_chunk(N: int, dtype: torch.dtype) -> int:
    return kchunk_select(N, dtype) or KCHUNK


def _kchunk_forward_block(q, k, v, mask, w: float, kc: int):
    """Online softmax over key chunks of ``kc`` for one block of rows, with
    the Pallas kernel's roundings (`_make_rowhead_kchunk_grid_cn_kernel`):
    f32 logits of the pre-scaled q, running max from -inf, f32 p, p rounded
    to v's dtype for P.V, f32 sums, the division at the end. Returns (out
    [R, N, H, C] in v's dtype, m and s [R, H, N] f32)."""
    R, N, H, C = q.shape
    qt = (q * w).float().permute(0, 2, 1, 3)  # [R, H, N, C]
    kt = k.float().permute(0, 2, 3, 1)         # [R, H, C, N]
    vt = v.permute(0, 2, 1, 3)                 # [R, H, N, C]
    m = torch.full((R, H, N), float("-inf"), device=q.device)
    s = torch.zeros((R, H, N), device=q.device)
    acc = torch.zeros((R, H, N, C), device=q.device)
    for k0 in range(0, N, kc):
        logits = qt @ kt[..., k0:k0 + kc]
        logits = torch.where(mask[:, None, None, k0:k0 + kc] < 0.5, NEG_INF, logits)
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        s = s * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(v.dtype).float() @ vt[:, :, k0:k0 + kc].float()
        m = m_new
    out = (acc / s[..., None]).to(v.dtype).permute(0, 2, 1, 3)
    return out, m, s


def rows_attention_kchunk_reference(q, k, v, mask, scale: float, stats: bool = False):
    """Plain version of K3 (``stats`` False) and K5 (True): masked
    attention without bias by online softmax over key chunks
    (``kchunk_select``'s chunk, KCHUNK below the switch). K5 also returns
    the row max m and log s, f32 [R, H, N], kept split
    (`pallas_attention.py:373-378`)."""
    R, N, H, C = q.shape
    kc = _plain_chunk(N, q.dtype)
    w = weak_scalar(scale, q.dtype)
    parts = [_kchunk_forward_block(q[b], k[b], v[b], mask[b], w, kc)
             for b in _kchunk_blocks(q, kc)]
    out = torch.cat([o for o, _, _ in parts])
    if not stats:
        return out
    m = torch.cat([m for _, m, _ in parts])
    logs = torch.log(torch.cat([s for _, _, s in parts]))
    return out, m, logs


def _kchunk_delta(dout: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta_i = sum_c dO_ic O_ic in f32, [R, H, N] (`pallas_attention.py:1025-1027`)."""
    return (dout.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()


def _kchunk_backward_block(q, k, v, mask, dout, m, logs, delta, w: float, kc: int):
    """K6's function for one block of rows (`_make_rowhead_kchunk_grid_cn_bwd_kernel`)."""
    R, N, H, C = q.shape
    qt = (q * w).float().permute(0, 2, 1, 3)  # [R, H, N, C]
    kt = k.float().permute(0, 2, 1, 3)
    vt = v.float().permute(0, 2, 1, 3)
    g = dout.float().permute(0, 2, 1, 3)
    dq = torch.zeros((R, H, N, C), device=q.device)
    dk, dv = [], []
    for k0 in range(0, N, kc):
        kk, vv = kt[:, :, k0:k0 + kc], vt[:, :, k0:k0 + kc]
        masked = mask[:, None, None, k0:k0 + kc] < 0.5
        logits = torch.where(masked, NEG_INF, qt @ kk.transpose(-1, -2))
        p = torch.exp((logits - m[..., None]) - logs[..., None])
        ds = p * (g @ vv.transpose(-1, -2) - delta[..., None])
        ds = torch.where(masked, 0.0, ds).to(q.dtype).float()
        dv.append((p.to(v.dtype).float().transpose(-1, -2) @ g).to(v.dtype))
        dk.append((ds.transpose(-1, -2) @ qt).to(k.dtype))
        dq = dq + ds @ kk
    dq = dq.to(q.dtype).permute(0, 2, 1, 3)
    dk = torch.cat(dk, dim=2).permute(0, 2, 1, 3)
    dv = torch.cat(dv, dim=2).permute(0, 2, 1, 3)
    return dq, dk, dv


def rows_attention_kchunk_bwd_reference(q, k, v, mask, dout, out, m, logs, scale: float):
    """Plain version of K6: (dq, dk, dv) of the K-chunk regime from the
    forward's output and split stats, chunked over keys as the Pallas
    kernel is: P = exp((L - m) - log s) in f32, dS = P (dP - delta) zeroed
    at masked keys, P rounded to v's dtype for dv, dS rounded to q's dtype
    for dq and dk, f32 sums; dq through the pre-scaled q times the
    dtype-rounded scale, as ``_bwd`` takes it (:1502)."""
    R, N, H, C = q.shape
    kc = _plain_chunk(N, q.dtype)
    w = weak_scalar(scale, q.dtype)
    delta = _kchunk_delta(dout, out)
    parts = [_kchunk_backward_block(q[b], k[b], v[b], mask[b], dout[b], m[b], logs[b], delta[b],
                                    w, kc)
             for b in _kchunk_blocks(q, kc)]
    dq, dk, dv = (torch.cat(t) for t in zip(*parts))
    return dq * w, dk, dv


def _aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` if every [.., C] row starts on 16 bytes (cp.async and 16-byte
    loads), else a contiguous copy."""
    if t.data_ptr() % 16 == 0 and all(st * t.element_size() % 16 == 0 for st in t.stride()[:3]):
        return t
    return t.contiguous() if not t.is_contiguous() else t.clone()


def _check(q, k, v, mask, bias, fits: bool, bound: str) -> None:
    """The operands' layout, devices and dtypes; ``fits`` is the kernel's
    bound predicate on their shape, ``bound`` what it requires."""
    if q.dim() != 4:
        raise ValueError(f"q must be [R, N, H, C], got {tuple(q.shape)}")
    R, N, H, C = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}")
    tensors = [("q", q), ("k", k), ("v", v)]
    if mask is not None:
        tensors.append(("mask", mask))
        if mask.shape != (R, N):
            raise ValueError(f"mask must be [R, N] = {(R, N)}, got {tuple(mask.shape)}")
    if bias is not None:
        tensors.append(("bias", bias))
        if bias.shape != (R, H, N, N):
            raise ValueError(
                f"bias must be [R, H, N, N] = {(R, H, N, N)}, got {tuple(bias.shape)}"
            )
    if not fits:
        raise ValueError(f"head width {C} unsupported: {bound}")
    for name, t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention kernels take float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v), ("bias", bias)):
        if t is not None and t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    if not grid_fits(R, N, H):
        raise ValueError(f"attention grid: R={R}, N={N}, H={H} must be non-empty, with H up to "
                         f"{MAX_HEADS} and ceil(N / {MIN_QUERY_TILE}) R up to {MAX_BLOCKS}")
    for name, t in tensors[:3]:
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along the head dimension")


_MMA_BOUND = (f"the tensor-core body needs a multiple of 8 whose tiles fit {MMA_SMEM_BYTES} "
              f"bytes (K6 and K7 up to {MAX_BWD_HEAD_DIM}; in f32 K2 up to {MAX_HEAD_DIM}, "
              f"the others up to {MAX_KCHUNK_HEAD_DIM})")


def _launch(name: str, q, k, v, mask, bias, scale: float,
            mma: Optional[bool] = None) -> torch.Tensor:
    """Launch K1, K1 fast or K2 (``name``); ``mma`` None picks the body by
    ``takes_tensor_cores``: the bf16 one (attention_mma.cu) or in f32 the
    3xTF32 one (K1 and K1 fast attention_tf32.cu, K2
    attention_tiled_tf32.cu); False forces the CUDA-core body."""
    from ..kernels import build

    C = q.shape[-1]
    auto = takes_tensor_cores(name, q.dtype, C)
    mma = auto if mma is None else mma
    if mma:
        _check(q, k, v, mask, bias, auto, _MMA_BOUND)
    else:
        _check(q, k, v, mask, bias, width_fits(C, MAX_HEAD_DIM),
               f"the CUDA-core body needs a multiple of 4 up to {MAX_HEAD_DIM}")
    lib = build()
    R, N, H, C = q.shape
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    if bias is not None:
        bias = bias.contiguous()
    if mma:
        q, k, v = (_aligned_rows(t) for t in (q, k, v))
    out = torch.empty((R, N, H, C), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        w = weak_scalar(scale, q.dtype)
        common = (_DTYPE_CODES[q.dtype], R, N, H, C, w, *strides, stream)
        if mma:
            suffix = "mma" if q.dtype == torch.bfloat16 else "tf32x3"
            fn = getattr(lib.lib, f"prd_{name}_{suffix}")
            tensors = [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       None if mask is None else mask.data_ptr()]
            if name == "tiled_attention":
                tensors.append(bias.data_ptr())
            code = fn(*tensors, out.data_ptr(), R, N, H, C, w, *strides, stream)
        elif name != "tiled_attention":  # K1 or K1 fast
            code = getattr(lib.lib, f"prd_{name}")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                *common,
            )
        else:
            code = lib.lib.prd_tiled_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                None if mask is None else mask.data_ptr(),
                None if bias is None else bias.data_ptr(),
                out.data_ptr(), *common,
            )
    lib.check(code, name)
    LAUNCHES[name] += 1
    return out


def _launch_bwd(q, k, v, mask, dout, scale: float, mma: Optional[bool] = None):
    """Launch K7; ``mma`` None picks the body by ``takes_tensor_cores``: the
    bf16 one (attention_bwd_mma.cu) or in f32 the 3xTF32 one
    (attention_bwd_tf32.cu); False forces the CUDA-core body."""
    from ..kernels import build

    C = q.shape[-1]
    auto = takes_tensor_cores("rows_attention_bwd", q.dtype, C)
    mma = auto if mma is None else mma
    if mma:
        _check(q, k, v, mask, None, auto, _MMA_BOUND)
    else:
        _check(q, k, v, mask, None, width_fits(C, MAX_BWD_HEAD_DIM),
               f"rows attention backward takes a multiple of 4 up to {MAX_BWD_HEAD_DIM}")
    R, N, H, C = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout must match q: got {tuple(dout.shape)} {dout.dtype} on {dout.device}")
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    if mma:
        q, k, v, dout = (_aligned_rows(t) for t in (q, k, v, dout))
    lib = build()
    mask = mask.to(torch.float32).contiguous()
    dq, dk, dv = (torch.empty((R, N, H, C), dtype=q.dtype, device=q.device) for _ in range(3))
    stats = torch.empty((3, R, H, N), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, dout) for s in t.stride()[:3]]
    w = weak_scalar(scale, q.dtype)
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), dout.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if mma:
            fn = (lib.lib.prd_rows_attention_bwd_mma if q.dtype == torch.bfloat16
                  else lib.lib.prd_rows_attention_bwd_tf32x3)
            code = fn(*pointers, R, N, H, C, w, *strides, stream)
        else:
            code = lib.lib.prd_rows_attention_bwd(*pointers, _DTYPE_CODES[q.dtype], R, N, H, C, w,
                                                  *strides, stream)
    lib.check(code, "rows_attention_bwd")
    LAUNCHES["rows_attention_bwd"] += 1
    return dq * w, dk, dv


def _check_kchunk(q, k, v, mask, name: str = "rows_attention_kchunk_bwd",
                  tensor_cores: bool = False) -> None:
    C = q.shape[-1]
    if tensor_cores:
        _check(q, k, v, mask, None, takes_tensor_cores(name, q.dtype, C), _MMA_BOUND)
    else:
        _check(q, k, v, mask, None, width_fits(C, MAX_KCHUNK_HEAD_DIM),
               f"K-chunked rows attention takes a multiple of 4 up to {MAX_KCHUNK_HEAD_DIM}")


def _launch_kchunk(q, k, v, mask, scale: float, stats: bool, mma: Optional[bool] = None):
    """K3 (``stats`` False) or K5: out, plus m and log s [R, H, N] f32. The
    body by ``takes_tensor_cores`` where ``mma`` is None: the bf16 one
    (attention_mma.cu) or in f32 the 3xTF32 one (attention_tf32.cu); False
    forces the CUDA-core body."""
    from ..kernels import build

    name = "rows_attention_kchunk_stats" if stats else "rows_attention_kchunk"
    if mma is None:
        mma = takes_tensor_cores(name, q.dtype, q.shape[-1])
    _check_kchunk(q, k, v, mask, name, mma)
    lib = build()
    R, N, H, C = q.shape
    mask = mask.to(torch.float32).contiguous()
    if mma:
        q, k, v = (_aligned_rows(t) for t in (q, k, v))
    out = torch.empty((R, N, H, C), dtype=q.dtype, device=q.device)
    m = logs = None
    if stats:
        m, logs = (torch.empty((R, H, N), dtype=torch.float32, device=q.device) for _ in range(2))
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    w = weak_scalar(scale, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if mma:
            fn = (lib.lib.prd_rows_attention_kchunk_mma if q.dtype == torch.bfloat16
                  else lib.lib.prd_rows_attention_kchunk_tf32x3)
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                      None if m is None else m.data_ptr(),
                      None if logs is None else logs.data_ptr(), R, N, H, C, w, *strides, stream)
        else:
            code = lib.lib.prd_rows_attention_kchunk(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                None if m is None else m.data_ptr(), None if logs is None else logs.data_ptr(),
                _DTYPE_CODES[q.dtype], R, N, H, C, w, *strides, stream,
            )
    lib.check(code, name)
    LAUNCHES[name] += 1
    return (out, m, logs) if stats else out


def _launch_kchunk_bwd(q, k, v, mask, dout, out, m, logs, scale: float,
                       mma: Optional[bool] = None):
    """K6: dq, dk, dv from K5's (out, m, log s). The body by
    ``takes_tensor_cores`` where ``mma`` is None: the bf16 one
    (attention_bwd_mma.cu) or in f32 the 3xTF32 one (attention_bwd_tf32.cu);
    False forces the CUDA-core body."""
    from ..kernels import build

    name = "rows_attention_kchunk_bwd"
    if mma is None:
        mma = takes_tensor_cores(name, q.dtype, q.shape[-1])
    _check_kchunk(q, k, v, mask, name, mma)
    R, N, H, C = q.shape
    for what, t in (("dout", dout), ("out", out)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what} must match q: got {tuple(t.shape)} {t.dtype} on {t.device}")
    for what, t in (("m", m), ("logs", logs)):
        if t.shape != (R, H, N) or t.dtype != torch.float32 or t.device != q.device:
            raise ValueError(f"{what} must be f32 [R, H, N] = {(R, H, N)} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    if mma:
        q, k, v, dout = (_aligned_rows(t) for t in (q, k, v, dout))
    lib = build()
    mask = mask.to(torch.float32).contiguous()
    m, logs = m.contiguous(), logs.contiguous()
    delta = _kchunk_delta(dout, out)
    dq, dk, dv = (torch.empty((R, N, H, C), dtype=q.dtype, device=q.device) for _ in range(3))
    strides = [s for t in (q, k, v, dout) for s in t.stride()[:3]]
    w = weak_scalar(scale, q.dtype)
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), dout.data_ptr(),
                m.data_ptr(), logs.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if mma:
            fn = (lib.lib.prd_rows_attention_kchunk_bwd_mma if q.dtype == torch.bfloat16
                  else lib.lib.prd_rows_attention_kchunk_bwd_tf32x3)
            code = fn(*pointers, R, N, H, C, w, *strides, stream)
        else:
            code = lib.lib.prd_rows_attention_kchunk_bwd(*pointers, _DTYPE_CODES[q.dtype], R, N,
                                                         H, C, w, *strides, stream)
    lib.check(code, name)
    LAUNCHES[name] += 1
    return dq * w, dk, dv


def _on_cpu(t: torch.Tensor) -> bool:
    """True when the input lies on the CPU (plain version); False for CUDA
    (kernel); raises for any other device."""
    device = t.device
    if device.type == "cpu":
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"attention runs on cpu or cuda tensors, got {device}")


def attention_body(name: str, q, k, v, mask, bias, scale: float, mma: bool, dout=None,
                   out=None, m=None, logs=None):
    """One launch of K1 (``name`` "rows_attention"), K1 fast
    ("rows_attention_fast"), K2 ("tiled_attention"), K3
    ("rows_attention_kchunk"), K5 ("rows_attention_kchunk_stats"), K7
    ("rows_attention_bwd", given ``dout``) or K6
    ("rows_attention_kchunk_bwd", given ``dout`` and K5's ``out``, ``m`` and
    ``logs``) on CUDA tensors through the body ``mma`` names, without
    autograd: the CUDA-core body (``mma`` False), which a tensor-core one
    replaced (both dtypes, C a multiple of 8), stays callable only to time
    the two side by side."""
    if name == "rows_attention_bwd":
        return _launch_bwd(q, k, v, mask, dout, scale, mma=mma)
    if name == "rows_attention_kchunk_bwd":
        return _launch_kchunk_bwd(q, k, v, mask, dout, out, m, logs, scale, mma=mma)
    if name in KCHUNK_FORWARDS:
        return _launch_kchunk(q, k, v, mask, scale, stats=name != "rows_attention_kchunk", mma=mma)
    return _launch(name, q, k, v, mask, bias, scale, mma=mma)


def rows_attention_fast(q, k, v, mask: torch.Tensor, scale: float) -> torch.Tensor:
    """K1 fast: ``rows_attention_fast_reference``'s function; the plain
    version for CPU tensors, the kernel for CUDA ones: the tensor-core body
    with C a multiple of 8 (bf16; f32 up to 128), else the CUDA-core body
    (C <= 1024).
    Forward only: its callers differentiate the f32 reference instead."""
    if mask is None:
        raise ValueError("rows_attention_fast needs a key mask")
    if _on_cpu(q):
        return rows_attention_fast_reference(q, k, v, mask, scale)
    return _launch("rows_attention_fast", q, k, v, mask, None, scale)


def rows_attention_bwd(q, k, v, mask: torch.Tensor, dout: torch.Tensor, scale: float):
    """K7: (dq, dk, dv) of ``rows_attention`` given dO; dq is with respect
    to the unscaled q."""
    if _on_cpu(q):
        return rows_attention_bwd_reference(q, k, v, mask, dout, scale)
    return _launch_bwd(q, k, v, mask, dout, scale)


def rows_attention_kchunk(q, k, v, mask: torch.Tensor, scale: float) -> torch.Tensor:
    """K3: ``rows_attention``'s function by online softmax over key tiles."""
    if _on_cpu(q):
        return rows_attention_kchunk_reference(q, k, v, mask, scale)
    return _launch_kchunk(q, k, v, mask, scale, stats=False)


def rows_attention_kchunk_stats(q, k, v, mask: torch.Tensor, scale: float):
    """K5: K3's output plus the row max m and log s, f32 [R, H, N]."""
    if _on_cpu(q):
        return rows_attention_kchunk_reference(q, k, v, mask, scale, stats=True)
    return _launch_kchunk(q, k, v, mask, scale, stats=True)


def rows_attention_kchunk_bwd(q, k, v, mask, dout, out, m, logs, scale: float):
    """K6: (dq, dk, dv) of the K-chunk regime from K5's (out, m, log s);
    dq is with respect to the unscaled q."""
    if _on_cpu(q):
        return rows_attention_kchunk_bwd_reference(q, k, v, mask, dout, out, m, logs, scale)
    return _launch_kchunk_bwd(q, k, v, mask, dout, out, m, logs, scale)


class _RowsAttention(torch.autograd.Function):
    """Triangle attention by regime, as the JAX ``_fwd``/``_bwd`` with
    ``kernel_bwd``: below the switch K1 forward and K7 backward; at or
    above it K3 (``stats`` False: no input needs a gradient), or K5, which
    saves (out, m, log s), and K6 backward. In the K-chunk regime
    ``plain_route()`` takes the plain versions on any device."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, stats):
        ctx.scale = scale
        ctx.kchunk = kchunk_select(q.shape[1], q.dtype) > 0
        if not ctx.kchunk:
            ctx.save_for_backward(q, k, v, mask)
            if _on_cpu(q):
                return attention_reference(q, k, v, mask, None, scale)
            return _launch("rows_attention", q, k, v, mask, None, scale)
        ctx.plain = _PLAIN_ROUTE
        if not stats:
            if ctx.plain:
                return rows_attention_kchunk_reference(q, k, v, mask, scale)
            return rows_attention_kchunk(q, k, v, mask, scale)
        if ctx.plain:
            out, m, logs = rows_attention_kchunk_reference(q, k, v, mask, scale, stats=True)
        else:
            out, m, logs = rows_attention_kchunk_stats(q, k, v, mask, scale)
        ctx.save_for_backward(q, k, v, mask, out, m, logs)
        return out

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors  # once: remat's checkpoint unpacks each tensor once
        if not ctx.kchunk:
            dq, dk, dv = rows_attention_bwd(*saved, dout, ctx.scale)
        else:
            bwd = rows_attention_kchunk_bwd_reference if ctx.plain else rows_attention_kchunk_bwd
            dq, dk, dv = bwd(*saved[:4], dout, *saved[4:], ctx.scale)
        return dq, dk, dv, None, None, None


def _warn_plain_vjp(fast: bool) -> None:
    """The JAX ``_bwd``'s warning (:1469-1483), once per process for each text."""
    message = (
        "fused_attention: differentiating through the CUDA forward kernel with the plain "
        "VJP backward (re-materializes the attention logits in device memory). For "
        "training, set use_pallas_bwd=True (the default) so the backward runs the "
        "flash-style kernels."
        + (" Note: fast_softmax is on, so these gradients are gradients of the f32 "
           "reference forward, NOT of the bf16 fast forward actually evaluated (serving "
           "lever)." if fast else "")
    )
    if message not in _WARNED:
        _WARNED.add(message)
        warnings.warn(message, stacklevel=3)


class _RowsAttentionPlainVjp(torch.autograd.Function):
    """Triangle attention with ``kernel_bwd`` off, as the JAX ``_fwd``/``_bwd``
    take it: K1 fast (``fast``) or K1 below the K-chunk switch, K3 at or
    above it; the backward is the plain VJP of the f32 ``attention_reference``
    in both regimes. ``plain_route()`` takes the plain forwards on any device."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, fast):
        ctx.save_for_backward(q, k, v, mask)
        ctx.scale, ctx.fast = scale, fast
        if kchunk_select(q.shape[1], q.dtype) > 0:
            fn = rows_attention_kchunk_reference if _PLAIN_ROUTE else rows_attention_kchunk
        elif fast:
            fn = rows_attention_fast_reference if _PLAIN_ROUTE else rows_attention_fast
        elif _PLAIN_ROUTE or _on_cpu(q):
            return attention_reference(q, k, v, mask, None, scale)
        else:
            return _launch("rows_attention", q, k, v, mask, None, scale)
        return fn(q, k, v, mask, scale)

    @staticmethod
    def backward(ctx, dout):
        _warn_plain_vjp(ctx.fast)
        grads = plain_vjp(attention_reference, ctx.saved_tensors, ctx.needs_input_grad, dout,
                          None, ctx.scale)
        return (*grads, None, None)


class _TiledAttention(torch.autograd.Function):
    """K2 forward; backward by the plain recompute under autograd (the JAX
    einsum VJP), which also gives dbias."""

    @staticmethod
    def forward(ctx, q, k, v, mask, bias, scale):
        ctx.save_for_backward(q, k, v, mask, bias)
        ctx.scale = scale
        if _on_cpu(q):
            return attention_reference(q, k, v, mask, bias, scale)
        return _launch("tiled_attention", q, k, v, mask, bias, scale)

    @staticmethod
    def backward(ctx, dout):
        grads = plain_vjp(attention_reference, ctx.saved_tensors, ctx.needs_input_grad, dout,
                          ctx.scale)
        return (*grads, None)


def rows_attention(q, k, v, mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Masked attention without bias (triangle attention), by regime: K1
    below the switch, K3 or K5 at or above it. q, k, v [R, N, H, C]; mask
    [R, N]. Differentiable: the backward is K7 or K6. On CUDA tensors that
    need a gradient below the switch, a shape K7 cannot take (``bwd_fits``)
    raises before the forward launches."""
    if mask is None:
        raise ValueError("rows_attention needs a key mask")
    stats = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    if (stats and q.dim() == 4 and not _on_cpu(q) and not _PLAIN_ROUTE
            and kchunk_select(q.shape[1], q.dtype) == 0 and not bwd_fits(*q.shape, q.dtype)):
        raise ValueError(f"rows attention backward (K7) takes a head width that is a multiple "
                         f"of 4 up to {MAX_BWD_HEAD_DIM}; got q {tuple(q.shape)}")
    return _RowsAttention.apply(q, k, v, mask, scale, stats)


def tiled_attention(q, k, v, mask: Optional[torch.Tensor], bias: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """K2: attention with a bias [R, H, N, N] and an optional key mask [R, N];
    on CUDA with C a multiple of 8 a tensor-core body, in bf16 (any C whose
    tiles fit shared memory, up to 1168) or in f32 3xTF32 (up to 1024), else
    the CUDA-core body (C <= 1024). Differentiable: the backward is the plain
    recompute."""
    if bias is None:
        raise ValueError("tiled_attention needs a bias; masked attention without one "
                         "is rows_attention's")
    return _TiledAttention.apply(q, k, v, mask, bias, scale)


def fused_attention(q, k, v, mask, bias, scale: float) -> torch.Tensor:
    """The kernel route, dispatched as the JAX forward does
    (`_fused_attention_fwd_impl`): no bias goes to the rows kernels (K1 or,
    in the K-chunk regime, K3/K5), which need the mask, and a bias to K2."""
    if bias is None:
        return rows_attention(q, k, v, mask, scale)
    return tiled_attention(q, k, v, mask, bias, scale)


def fused_gated_reference(x, mask, wq, wk, wv, wg, bg, wo, bo, num_heads: int) -> torch.Tensor:
    """Plain version of K8, the whole no-bias GatedAttention on x [..., N, D]
    with a key mask broadcastable to [..., N]: LN without affine (f32),
    q = x Wq / sqrt(C), k, v and the gate sigmoid(x Wg + bg) per head,
    masked f32 softmax, o = P v, sigmoid gate * o, out-projection summed
    over heads plus bo. The Pallas kernel's roundings in the input's dtype:
    the LN output, q (scaled in f32), k, v, the probabilities and the gated
    output rounded to it, the gate and all sums f32, the output in it."""
    dt = x.dtype
    H, HC = num_heads, wq.shape[0]
    C = HC // H
    xl = layer_norm_f32(x).to(dt).float()

    def proj(w):
        return xl @ w.to(dt).float().t()

    def heads(y):
        return y.reshape(y.shape[:-1] + (H, C)).float()

    q = heads((proj(wq) * (1.0 / math.sqrt(C))).to(dt))
    k = heads(proj(wk).to(dt))
    v = heads(proj(wv).to(dt))
    gate = torch.sigmoid(proj(wg) + bg.float())
    logits = torch.einsum("...ihc,...jhc->...hij", q, k)
    probs = masked_softmax(logits, mask[..., None, None, :])
    o = torch.einsum("...hij,...jhc->...ihc", probs.to(dt).float(), v)
    gated = (gate * o.reshape(o.shape[:-2] + (HC,))).to(dt).float()
    return (gated @ wo.to(dt).float().t() + bo.float()).to(dt)


# K8's two bodies. fused_gated_mma.cu (tensor cores, bf16 and 3xTF32): C a
# multiple of 8 up to 128 (the P.V accumulators hold 64 channels a slice),
# H C up to 512 and D up to 128 (a warp's [16, D] out-projection sum in
# registers). fused_gated.cu (CUDA cores, C = 4 mod 8): up to four output
# channels per lane (D <= 128), one head channel per lane in P.V (C <= 32),
# the out-projection [H C, D] in shared memory (f32, H C <= 128).
MAX_FUSED_PAIR_DIM, MAX_FUSED_HEAD_DIM, MAX_FUSED_WIDTH = 128, 128, 512
MAX_FUSED_CORE_HEAD_DIM, MAX_FUSED_CORE_WIDTH = 32, 128


def fused_gated_takes_tensor_cores(D: int, H: int, C: int) -> bool:
    """Whether K8 runs its tensor-core body (fused_gated_mma.cu, either
    dtype) at pair width D with H heads of width C: C a multiple of 8 up to
    MAX_FUSED_HEAD_DIM, H C up to MAX_FUSED_WIDTH, D up to
    MAX_FUSED_PAIR_DIM. Else the CUDA-core body (fused_gated.cu)."""
    return (0 < D <= MAX_FUSED_PAIR_DIM and 0 < C <= MAX_FUSED_HEAD_DIM and C % 8 == 0
            and 0 < H * C <= MAX_FUSED_WIDTH)


def fused_gated_core_fits(D: int, H: int, C: int) -> bool:
    """The CUDA-core body's bound: D up to 128, C a multiple of 4 up to 32,
    H C up to 128."""
    return (0 < D <= MAX_FUSED_PAIR_DIM and 0 < C <= MAX_FUSED_CORE_HEAD_DIM and C % 4 == 0
            and 0 < H * C <= MAX_FUSED_CORE_WIDTH)


def fused_gated_fits(R: int, N: int, D: int, H: int, C: int, dtype: torch.dtype) -> bool:
    """Whether K8 takes R rows of N positions of width D in ``dtype`` with H
    heads of width C: the tensor-core body's bound, else the CUDA-core
    body's; one block per (row, 32 queries) in grid.x."""
    return ((fused_gated_takes_tensor_cores(D, H, C) or fused_gated_core_fits(D, H, C))
            and R > 0 and N > 0 and -(-N // 32) * R <= MAX_BLOCKS)


def _launch_fused_gated(x, mask, wq, wk, wv, wg, bg, wo, bo, num_heads: int) -> torch.Tensor:
    from ..kernels import build

    if not x.is_cuda or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the fused gated attention kernel takes CUDA float32 or bfloat16, got "
                        f"{x.dtype} on {x.device}")
    if x.dim() < 2:
        raise ValueError(f"x must be [..., N, D], got {tuple(x.shape)}")
    N, D = x.shape[-2:]
    HC = wq.shape[0]
    H = num_heads
    C = HC // H if H > 0 else 0
    R = math.prod(x.shape[:-2])
    if not (H * C == HC and fused_gated_fits(R, N, D, H, C, x.dtype)):
        raise ValueError(f"the fused gated attention kernel takes D up to {MAX_FUSED_PAIR_DIM}, "
                         f"head width a multiple of 8 up to {MAX_FUSED_HEAD_DIM} with H*C up to "
                         f"{MAX_FUSED_WIDTH} (or a multiple of 4 up to "
                         f"{MAX_FUSED_CORE_HEAD_DIM} with H*C up to {MAX_FUSED_CORE_WIDTH}) and "
                         f"ceil(N / 32) rows up to {MAX_BLOCKS}; got {R} rows, N={N}, D={D}, "
                         f"H={H}, H*C={HC}")
    for name, w, shape in (("wq", wq, (HC, D)), ("wk", wk, (HC, D)), ("wv", wv, (HC, D)),
                           ("wg", wg, (HC, D)), ("bg", bg, (HC,)), ("wo", wo, (D, HC)),
                           ("bo", bo, (D,))):
        if w.shape != shape or w.device != x.device:
            raise ValueError(f"{name} must be {shape} on {x.device}, got {tuple(w.shape)} on "
                             f"{w.device}")
    # [R1, R2, N, D] rows read through their strides: the "ending" triangle
    # attention's transposed view [B, j, i, D] needs no copy
    x4 = x.reshape((-1,) + x.shape[-3:]) if x.dim() >= 3 else x[None]
    if x4.dim() == 3:
        x4 = x4[None]
    if x4.stride(-1) != 1:
        x4 = x4.contiguous()
    R1, R2 = x4.shape[:2]
    lib = build()
    dt = x.dtype
    maskf = torch.broadcast_to(mask, x.shape[:-1]).reshape(R, N).to(torch.float32).contiguous()
    w_in = torch.cat([wq, wk, wv, wg]).to(dt).t().contiguous()  # [D, 4 H C]: q | k | v | gate
    bg_f, bo_f = bg.float().contiguous(), bo.float().contiguous()
    wo_t = wo.to(dt).t().contiguous()  # [H C, D]
    qkv = torch.empty((3, R, N, HC), dtype=dt, device=x.device)  # scratch: q (scaled), k, v
    gate = torch.empty((R, N, HC), dtype=torch.float32, device=x.device)
    out = torch.empty(x4.shape, dtype=dt, device=x.device)
    entry = (lib.lib.prd_fused_gated_mma if fused_gated_takes_tensor_cores(D, H, C)
             else lib.lib.prd_fused_gated)
    with torch.cuda.device(x.device):
        code = entry(
            x4.data_ptr(), maskf.data_ptr(), w_in.data_ptr(), bg_f.data_ptr(), wo_t.data_ptr(),
            bo_f.data_ptr(), qkv.data_ptr(), gate.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[dt], R1, R2, N, D, H, C, 1.0 / math.sqrt(C),
            *x4.stride()[:3], stream_of(x),
        )
    lib.check(code, "fused_gated_rows_attention")
    LAUNCHES["fused_gated_rows_attention"] += 1
    return out.reshape(x.shape)


def fused_gated(x, mask, wq, wk, wv, wg, bg, wo, bo, num_heads: int) -> torch.Tensor:
    """K8: the plain version for a CPU tensor, the kernel for a CUDA one."""
    if _on_cpu(x):
        return fused_gated_reference(x, mask, wq, wk, wv, wg, bg, wo, bo, num_heads)
    return _launch_fused_gated(x, mask, wq, wk, wv, wg, bg, wo, bo, num_heads)


class _FusedGated(torch.autograd.Function):
    """K8 forward; backward by autograd of the plain version
    (``_fused_gated_bwd``)."""

    @staticmethod
    def forward(ctx, x, mask, wq, wk, wv, wg, bg, wo, bo, num_heads):
        ctx.save_for_backward(x, mask, wq, wk, wv, wg, bg, wo, bo)
        ctx.num_heads = num_heads
        fn = fused_gated_reference if _PLAIN_ROUTE else fused_gated
        return fn(x, mask, wq, wk, wv, wg, bg, wo, bo, num_heads)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors  # once: remat's checkpoint unpacks each tensor once
        grads = plain_vjp(fused_gated_reference, saved, ctx.needs_input_grad, dout,
                          ctx.num_heads)
        return (*grads, None)


def fused_gated_rows_attention(x, mask, wq, wk, wv, wg, bg, wo, bo, num_heads: int):
    """The whole no-bias GatedAttention as one kernel (K8), differentiable:
    x [..., N, D] rows (pre-LN), mask broadcastable to [..., N], weights in
    the torch Linear layout (wq, wk, wv, wg [H C, D], wo [D, H C])."""
    return _FusedGated.apply(x, mask, wq, wk, wv, wg, bg, wo, bo, num_heads)


@contextlib.contextmanager
def plain_route() -> Iterator[None]:
    """Inside this block ``gated_attention_core`` and the fused kernels' entry
    points (K8-K11) run the plain versions on CUDA tensors too. For comparing
    the kernels with them (tests and chip_smoke.py); process-wide, not per
    thread."""
    global _PLAIN_ROUTE
    outer, _PLAIN_ROUTE = _PLAIN_ROUTE, True
    try:
        yield
    finally:
        _PLAIN_ROUTE = outer


def gated_attention_core(q, k, v, mask, bias, scale: float, fast: bool = False,
                         kernel_bwd: bool = True, use_pallas: bool = True) -> torch.Tensor:
    """Every model attention: the kernel route, or the plain version inside
    ``plain_route()`` (in the K-chunk regime, and with ``kernel_bwd`` off,
    through the autograd Functions, which read the block themselves); inputs
    row-flattened as above. ``use_pallas`` is the attention plan's decision
    (``models.denoiser.resolve_attention_plan``); the port reads it only for
    ``fast`` (``cfg.fast_softmax``), where it changes the function. Where
    the plan leaves Pallas, ``fast`` computes ``attention_reference_fast``
    on bf16 inputs, every attention alike, and nothing else on f32 inputs,
    as the JAX ``_attention_reference`` does. Under the Pallas plan
    ``kernel_bwd`` (``cfg.use_pallas_bwd``) off sends masked attention
    without a bias through ``_RowsAttentionPlainVjp``, and only there does
    ``fast`` select K1 fast."""
    if fast and not use_pallas:
        if q.dtype == torch.bfloat16:
            return attention_reference_fast(q, k, v, mask, bias, scale)
        fast = False  # f32: the flag leaves the function as it is
    rows = bias is None and mask is not None
    if rows and not kernel_bwd:
        return _RowsAttentionPlainVjp.apply(q, k, v, mask, scale, fast)
    kchunk = rows and kchunk_select(q.shape[1], q.dtype) > 0
    if _PLAIN_ROUTE and not kchunk:
        return attention_reference(q, k, v, mask, bias, scale)
    return fused_attention(q, k, v, mask, bias, scale)
