"""The fused transition: LN -> W1 + b1 -> ReLU -> W2 (+ b2) over rows, the
plain PyTorch version and the dispatch to its hand-written Hopper kernel.

Port of ``protein_redesign_tpu/ops/pallas_transition.py``:
``fused_transition`` replaces the Pallas kernel K10 (``_fused_transition_impl``
:71 -> ``_kernel`` :33), and its backward differentiates the plain version,
as ``_ft_bwd`` (:138) differentiates ``_reference_impl``. K10 has two
bodies (``transition_takes_tensor_cores``): input, hidden and output widths
that are multiples of 8 in bf16 (4 in f32) take the tensor-core one
(``kernels/csrc/transition_mma.cu``: mma.sync in bf16, 3xTF32 in f32, h kept
in registers; ``transition_layout`` names its layout), other widths the
CUDA-core one (``kernels/csrc/transition.cu``), which stays callable to time
it beside the other.

Weights keep the torch Linear layout: w1 [Hd, D], w2 [Dout, Hd], f32
parameters. The computation takes the input's dtype, as the kernel does:
LN statistics in f32, operands rounded to the dtype (the LN output, the
weights, the ReLU output), f32 sums and f32 biases, the output in the dtype.
In float32 that is f32 throughout, the Pallas kernel's function in
interpret mode and ``_reference_impl``'s. (On the TPU the kernel rounds its
operands to bf16 even in an f32 model; the port does not.)

A CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises; inside ``ops.attention.plain_route()`` the autograd entry point runs
the plain version on any device.
"""

from __future__ import annotations

from typing import Optional

import torch

from .attention import (
    LAUNCHES,
    _DTYPE_CODES,
    _on_cpu,
    layer_norm_f32,
    plain_route_active,
    plain_vjp,
    stream_of,
)

# transition.cu keeps 64 LN rows transposed ([D][68]) and three 64 x 64
# tiles (f32) in shared memory where they fit (D up to 670), else a [64][68]
# slab of them normalised from each row's mean and rstd (any D); outputs
# wider than 64 split the hidden dimension across blocks (grid.y, up to
# 65535 chunks of 64), each chunk's partial sums in a slab of an f32
# scratch that a second kernel adds in chunk order (the same bits at every
# call, as parallel-in-time sampling at tolerance 0 needs).
MAX_SMEM = 232448  # bytes a block can use on the H100
SPLIT_OUT_DIM = 64
MAX_SPLIT_HIDDEN = 64 * 65535


def smem_bytes(D: int) -> int:
    """transition.cu's shared memory for input width D: the whole-row layout
    where it fits MAX_SMEM, else the streamed one."""
    whole = 4 * (68 * D + 64 * 64 + 64 * 68 + 64 * 64)
    return whole if whole <= MAX_SMEM else 4 * (64 * 68 + 64 * 64 + 64 * 68 + 64 * 64 + 2 * 64)


# transition_mma.cu's layouts: rows with W resident (Dout up to
# TC_MAX_ROWS_OUT, W1, W2 and the biases staged once per block of
# TC_RESIDENT_WARPS warps, halved where that does not fit, each warp with
# two 16-row x tiles of its own); rows with W streamed (blocks of
# TC_ROW_WARPS warps, 128-row A and output tiles, W1 and W2 in chunks of
# TC_HIDDEN units); split (wider outputs, or rows past shared memory: blocks
# of 4 warps, or 2 where 4 do not fit, one TC_HIDDEN-unit chunk each on
# grid.y, W's slabs through a ring of TC_RING slots, partial sums in the
# chunk's slab of the f32 scratch, summed in chunk order as above).
TC_ROW_WARPS, TC_RING, TC_HIDDEN, TC_MAX_ROWS_OUT = 8, 3, 64, 128
TC_RESIDENT_WARPS = 8
_TC_OPERAND = {torch.bfloat16: (16, 8, 8), torch.float32: (8, 4, 4)}  # depth, pad, chunk


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _k_stride(K: int, dtype: torch.dtype) -> int:
    depth, pad, _ = _TC_OPERAND[dtype]
    return _round_up(K, depth) + pad


def tc_rows_smem_bytes(D: int, Hd: int, Dout: int, dtype: torch.dtype, warps: int) -> int:
    """Shared memory of transition_mma.cu's rows layout with W resident
    (``rows_smem``) for blocks of ``warps`` warps: W1 [HK, D], W2's 64 or 128
    rows of HK units, two 16-row x tiles a warp (in the dtype, rows as wide
    as the wider of D and Dout: a dead tile takes the outputs), b1 and b2
    (f32); HK is Hd padded to TC_HIDDEN."""
    hk, outs, lda = _round_up(Hd, TC_HIDDEN), 64 if Dout <= 64 else 128, _k_stride(D, dtype)
    ldx = _k_stride(max(D, Dout), dtype)
    return dtype.itemsize * (hk * lda + outs * (hk + 8) + warps * 32 * ldx) + 4 * (hk + outs)


def tc_chunks_smem_bytes(D: int, Hd: int, Dout: int, dtype: torch.dtype) -> int:
    """Shared memory of the rows layout with W streamed (``chunks_smem``):
    the A and output tiles of 16 TC_ROW_WARPS rows, one chunk of W1 and of
    W2, b1 and b2."""
    rows, outs, lda = 16 * TC_ROW_WARPS, 64 if Dout <= 64 else 128, _k_stride(D, dtype)
    return (dtype.itemsize * (rows * lda + rows * (_round_up(Dout, 32) + 8) + TC_HIDDEN * lda
                              + outs * (TC_HIDDEN + 8))
            + 4 * (_round_up(Hd, TC_HIDDEN) + outs))


def tc_split_smem_bytes(D: int, dtype: torch.dtype, warps: int) -> int:
    """Shared memory of the split layout (``split_smem``) for blocks of
    ``warps`` warps: 16 ``warps`` rows of x, TC_RING slots of 64 x 72 for
    W's slabs, and the warps' [16, 68] f32 partial sums."""
    return (dtype.itemsize * (16 * warps * _k_stride(D, dtype) + TC_RING * 64 * 72)
            + 4 * 16 * warps * 68)


def transition_layout(D: int, Hd: int, Dout: int, dtype: torch.dtype) -> Optional[str]:
    """The layout transition_mma.cu takes for these widths (``layout_of``):
    "resident" or "streamed" (the rows layout, Dout up to TC_MAX_ROWS_OUT, W
    whole in shared memory or in chunks), "split", or None where the
    tensor-core body does not take them (a width not a multiple of 8 in
    bf16, 4 in f32, another dtype, or no layout within shared memory)."""
    if dtype not in _TC_OPERAND or min(D, Hd, Dout) <= 0:
        return None
    chunk = _TC_OPERAND[dtype][2]
    if D % chunk or Hd % chunk or Dout % chunk:
        return None
    if Dout <= TC_MAX_ROWS_OUT:
        warps = TC_RESIDENT_WARPS
        if min(tc_rows_smem_bytes(D, Hd, Dout, dtype, w) for w in (warps, warps // 2)) <= MAX_SMEM:
            return "resident"
        if tc_chunks_smem_bytes(D, Hd, Dout, dtype) <= MAX_SMEM:
            return "streamed"
    if tc_split_smem_bytes(D, dtype, 2) <= MAX_SMEM and -(-Hd // TC_HIDDEN) <= 65535:
        return "split"
    return None


def transition_takes_tensor_cores(D: int, Hd: int, Dout: int, dtype: torch.dtype) -> bool:
    """Whether K10 runs its tensor-core body (transition_mma.cu) at these
    widths in ``dtype``, else the CUDA-core body (transition.cu)."""
    return transition_layout(D, Hd, Dout, dtype) is not None


def transition_fits(M: int, D: int, Hd: int, Dout: int, dtype: torch.dtype) -> bool:
    """Whether K10 takes M rows of width D in ``dtype``, hidden width Hd and
    Dout outputs: any D (smem_bytes(D) within MAX_SMEM), Hd up to
    MAX_SPLIT_HIDDEN when Dout > SPLIT_OUT_DIM, 1 to 2^31 - 1 rows."""
    return (0 < D and 0 < Hd and 0 < Dout and smem_bytes(D) <= MAX_SMEM
            and (Dout <= SPLIT_OUT_DIM or Hd <= MAX_SPLIT_HIDDEN) and 0 < M <= 2**31 - 1)


def transition_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                         w2: torch.Tensor, b2: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain version of K10 on x [..., D]."""
    dt = x.dtype
    xl = layer_norm_f32(x).to(dt).float()
    h = torch.relu(xl @ w1.to(dt).float().t() + b1.float()).to(dt).float()
    out = h @ w2.to(dt).float().t()
    if b2 is not None:
        out = out + b2.float()
    return out.to(dt)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous) if it starts on 16 bytes, else a copy that does."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, w1, b1, w2, b2) -> torch.Tensor:
    from ..kernels import build

    Hd, D = w1.shape
    Dout = w2.shape[0]
    if not x.is_cuda or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the transition kernel takes CUDA float32 or bfloat16, got {x.dtype} "
                        f"on {x.device}")
    if x.shape[-1] != D or w2.shape[1] != Hd or b1.shape != (Hd,) or (
            b2 is not None and b2.shape != (Dout,)):
        raise ValueError(f"transition shapes: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    lead = x.shape[:-1]
    M = x.numel() // D if D else 0
    if not transition_fits(M, D, Hd, Dout, x.dtype):
        raise ValueError(f"the transition kernel takes 1 to 2^31 - 1 rows and, for outputs "
                         f"wider than {SPLIT_OUT_DIM}, a hidden width up to {MAX_SPLIT_HIDDEN}; "
                         f"got D={D}, Hd={Hd}, Dout={Dout}, {M} rows")
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
    x2 = _aligned(x.reshape(-1, D).contiguous())
    lib = build()
    dt = x.dtype
    b1f = b1.float().contiguous()
    b2f = None if b2 is None else b2.float().contiguous()
    b2p = None if b2f is None else b2f.data_ptr()
    out = torch.empty((M, Dout), dtype=dt, device=x.device)
    layout = (transition_layout(D, Hd, Dout, dt)
              if transition_takes_tensor_cores(D, Hd, Dout, dt) else None)
    if layout is not None:  # transition_mma.cu: the Linear layout as it is
        fn = lib.lib.prd_transition_mma
        w1p, w2p = (_aligned(w.to(dt).contiguous()) for w in (w1, w2))
        split = layout == "split"
    else:  # transition.cu: w1t [D, Hd], w2t [Hd, Dout]
        fn = lib.lib.prd_transition
        w1p, w2p = (w.to(dt).t().contiguous() for w in (w1, w2))
        split = Dout > SPLIT_OUT_DIM
    # the split blocks' f32 sums, a slab per 64-unit hidden chunk (outputs
    # wider than the rows layouts take); every element is written
    out32 = torch.empty((-(-Hd // TC_HIDDEN), M, Dout), device=x.device) if split else None
    with torch.cuda.device(x.device):
        code = fn(
            x2.data_ptr(), w1p.data_ptr(), b1f.data_ptr(), w2p.data_ptr(), b2p, out.data_ptr(),
            None if out32 is None else out32.data_ptr(),
            _DTYPE_CODES[dt], M, D, Hd, Dout, stream_of(x),
        )
    lib.check(code, "fused_transition")
    LAUNCHES["fused_transition"] += 1
    return out.reshape(lead + (Dout,))


def transition(x, w1, b1, w2, b2=None) -> torch.Tensor:
    """K10: the plain version for a CPU tensor, the kernel for a CUDA one."""
    if _on_cpu(x):
        return transition_reference(x, w1, b1, w2, b2)
    return _launch(x, w1, b1, w2, b2)


class _FusedTransition(torch.autograd.Function):
    """K10 forward; backward by autograd of the plain version (``_ft_bwd``)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        if plain_route_active():
            return transition_reference(x, w1, b1, w2, b2)
        return transition(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors  # once: remat's checkpoint unpacks each tensor once
        return tuple(plain_vjp(transition_reference, saved, ctx.needs_input_grad, dout))


def fused_transition(x, w1, b1, w2, b2=None) -> torch.Tensor:
    """LN -> W1 + b1 -> ReLU -> W2 (+ b2) as one kernel, differentiable."""
    return _FusedTransition.apply(x, w1, b1, w2, b2)
