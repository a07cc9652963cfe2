"""The fused transition: LN -> W1 + b1 -> ReLU -> W2 (+ b2) over rows, the
plain PyTorch version and the dispatch to its hand-written Hopper kernel.

Port of ``protein_redesign_tpu/ops/pallas_transition.py``:
``fused_transition`` replaces the Pallas kernel K10 (``_fused_transition_impl``
:71 -> ``_kernel`` :33) with ``kernels/csrc/transition.cu``, and its
backward differentiates the plain version, as ``_ft_bwd`` (:138)
differentiates ``_reference_impl``.

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
# 65535 chunks of 64) and sum in an f32 scratch.
MAX_SMEM = 232448  # bytes a block can use on the H100
SPLIT_OUT_DIM = 64
MAX_SPLIT_HIDDEN = 64 * 65535


def smem_bytes(D: int) -> int:
    """transition.cu's shared memory for input width D: the whole-row layout
    where it fits MAX_SMEM, else the streamed one."""
    whole = 4 * (68 * D + 64 * 64 + 64 * 68 + 64 * 64)
    return whole if whole <= MAX_SMEM else 4 * (64 * 68 + 64 * 64 + 64 * 68 + 64 * 64 + 2 * 64)


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
    x2 = x.reshape(-1, D).contiguous()
    lib = build()
    dt = x.dtype
    w1t = w1.to(dt).t().contiguous()  # [D, Hd]
    w2t = w2.to(dt).t().contiguous()  # [Hd, Dout]
    b1f = b1.float().contiguous()
    b2f = None if b2 is None else b2.float().contiguous()
    out = torch.empty((M, Dout), dtype=dt, device=x.device)
    # the split blocks' f32 sums (outputs wider than 64, such as single_fc)
    out32 = torch.zeros((M, Dout), device=x.device) if Dout > SPLIT_OUT_DIM else None
    with torch.cuda.device(x.device):
        code = lib.lib.prd_transition(
            x2.data_ptr(), w1t.data_ptr(), b1f.data_ptr(), w2t.data_ptr(),
            None if b2f is None else b2f.data_ptr(), out.data_ptr(),
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
