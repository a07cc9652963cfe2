"""The fused OuterLinear: Linear(cat[x_i * x_j, x_i - x_j]) of the normed
single representation without the [N, N, 2S] concat, the plain PyTorch
version and the dispatch to its hand-written Hopper kernel.

Port of ``protein_redesign_tpu/ops/pallas_outer.py``: ``fused_outer_linear``
replaces the Pallas kernel K11 (``_fused_outer_impl`` :72 -> ``_make_kernel``
:55); its backward differentiates the plain version, as ``_fo_bwd`` (:135)
differentiates ``_reference_impl``. K11 has two bodies
(``outer_takes_tensor_cores``): pair widths D that are multiples of 8 up to
128 take the tensor-core one (``kernels/csrc/outer_mma.cu``: mma.sync in
bf16, 3xTF32 in f32, W1 in the Linear's layout), the other widths that
``outer_fits`` admits (any D up to 512) the CUDA-core one
(``kernels/csrc/outer.cu``: past 128 a block per 128-channel slice), which
stays callable to time it beside the other.

With W = [W1; W2] split along the concat axis,

    out[b, i, j] = (xl_i * xl_j) . W1 + u_i - u_j + bias,   u = LN(x) . W2.

As in the JAX package, the LayerNorm (f32) and u (an f32 product of the
f32 LN output, [B, N, D]) are computed outside the kernel, here by PyTorch;
the kernel computes the O(N^2 S D) product and the sums. The products
x_i * x_j are rounded to the input's dtype before the dot with W1 (rounded
too), sums in f32, the output in the dtype: f32 throughout in float32.

The weight keeps the torch Linear layout [D, 2S]. A CPU tensor runs the
plain version; a CUDA tensor launches the kernel or raises; inside
``ops.attention.plain_route()`` the autograd entry point runs the plain
version on any device.
"""

from __future__ import annotations

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
from .transition import _aligned

MAX_TC_PAIR_DIM = 128  # outer_mma.cu: a warp's 16 j x TI i rows of all D channels
# outer.cu: 16 threads of 4 output channels in each of two groups of 64, a
# block per slice of 128 channels past that
MAX_PAIR_DIM = 512
# outer_mma.cu stages xl rows and W1 in 16-byte pieces: S a multiple of this
TC_PIECE = {torch.bfloat16: 8, torch.float32: 4}


def outer_fits(B: int, N: int, D: int, dtype: torch.dtype) -> bool:
    """Whether K11 takes x [B, N, S] in ``dtype`` with D output channels: D
    from 1 to MAX_PAIR_DIM, B and N from 1 to 65535."""
    return 0 < D <= MAX_PAIR_DIM and 0 < B <= 65535 and 0 < N <= 65535


def outer_takes_tensor_cores(S: int, D: int, dtype: torch.dtype) -> bool:
    """Whether K11 runs its tensor-core body (outer_mma.cu) at single width S
    and pair width D in ``dtype``, else the CUDA-core body (outer.cu): D a
    multiple of 8 up to MAX_TC_PAIR_DIM, and S a multiple of one 16-byte piece
    (8 in bf16, 4 in f32). S need not be a multiple of the MMA's k-step (16
    in bf16, 8 in f32): the last chunk of 64 is zero-padded in shared
    memory."""
    return (dtype in TC_PIECE and 0 < D <= MAX_TC_PAIR_DIM and D % 8 == 0
            and S > 0 and S % TC_PIECE[dtype] == 0)


def _ln_u(x: torch.Tensor, w: torch.Tensor):
    """(xl in x's dtype, u f32 [..., N, D])."""
    S = x.shape[-1]
    xl32 = layer_norm_f32(x)
    u = xl32 @ w[:, S:].float().t()
    return xl32.to(x.dtype), u


def outer_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K11: x [..., N, S] -> [..., N, N, D]."""
    xl, u = _ln_u(x, w)
    w1 = w[:, :x.shape[-1]].to(x.dtype)
    prod = (xl[..., :, None, :] * xl[..., None, :, :]).float()  # rounded to the dtype
    o = prod @ w1.float().t()
    out = o + u[..., :, None, :] + (b.float() - u[..., None, :, :])
    return out.to(x.dtype)


def _launch(x, w, b) -> torch.Tensor:
    from ..kernels import build

    if not x.is_cuda or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the OuterLinear kernel takes CUDA float32 or bfloat16, got {x.dtype} "
                        f"on {x.device}")
    if x.dim() != 3:
        raise ValueError(f"the OuterLinear kernel takes x [B, N, S], got {tuple(x.shape)}")
    B, N, S = x.shape
    D = w.shape[0]
    if w.shape != (D, 2 * S) or b.shape != (D,):
        raise ValueError(f"OuterLinear weight must be [D, 2S] = [D, {2 * S}] with bias [D], got "
                         f"{tuple(w.shape)} and {tuple(b.shape)}")
    if not outer_fits(B, N, D, x.dtype):
        raise ValueError(f"the OuterLinear kernel takes a pair width from 1 to {MAX_PAIR_DIM}, "
                         f"B and N from 1 to 65535; got B={B}, N={N}, D={D}")
    for name, t in (("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
    lib = build()
    xl, u = _ln_u(x, w)
    xl, u = xl.contiguous(), u.contiguous()
    bf = _aligned(b.float().contiguous())
    out = torch.empty((B, N, N, D), dtype=x.dtype, device=x.device)
    if outer_takes_tensor_cores(S, D, x.dtype):
        # outer_mma.cu: W1 in the dtype, rows of the Linear's [D, 2S] layout
        # (a weight in the dtype is read in place; an f32 one in a bf16 model
        # is cast, [D, S])
        w1 = w if w.dtype == x.dtype else w[:, :S].to(x.dtype)
        w1 = _aligned(w1.contiguous())
        args = (xl.data_ptr(), u.data_ptr(), w1.data_ptr(), w1.stride(0), bf.data_ptr(),
                out.data_ptr(), _DTYPE_CODES[x.dtype], B, N, S, D, stream_of(x))
        fn = lib.lib.prd_outer_mma
    else:  # outer.cu: W1 transposed, [S, D] in the dtype
        w1t = w[:, :S].to(x.dtype).t().contiguous()
        args = (xl.data_ptr(), u.data_ptr(), w1t.data_ptr(), bf.data_ptr(), out.data_ptr(),
                _DTYPE_CODES[x.dtype], B, N, S, D, stream_of(x))
        fn = lib.lib.prd_outer
    with torch.cuda.device(x.device):
        code = fn(*args)
    lib.check(code, "fused_outer_linear")
    LAUNCHES["fused_outer_linear"] += 1
    return out


def outer(x, w, b) -> torch.Tensor:
    """K11: the plain version for a CPU tensor, the kernel for a CUDA one."""
    if _on_cpu(x):
        return outer_reference(x, w, b)
    return _launch(x, w, b)


class _FusedOuter(torch.autograd.Function):
    """K11 forward; backward by autograd of the plain version (``_fo_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        if plain_route_active():
            return outer_reference(x, w, b)
        return outer(x, w, b)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors  # once: remat's checkpoint unpacks each tensor once
        return tuple(plain_vjp(outer_reference, saved, ctx.needs_input_grad, dout))


def fused_outer_linear(x, w, b) -> torch.Tensor:
    """OuterLinear's Linear(cat[x_i * x_j, x_i - x_j]) of LN(x) as one
    kernel, differentiable; x [B, N, S], w [D, 2S], b [D]."""
    return _FusedOuter.apply(x, w, b)
