"""The fused OuterLinear: Linear(cat[x_i * x_j, x_i - x_j]) of the normed
single representation without the [N, N, 2S] concat, the plain PyTorch
version and the dispatch to its hand-written Hopper kernel.

Port of ``protein_redesign_tpu/ops/pallas_outer.py``: ``fused_outer_linear``
replaces the Pallas kernel K11 (``_fused_outer_impl`` :72 -> ``_make_kernel``
:55) with ``kernels/csrc/outer.cu``; its backward differentiates the plain
version, as ``_fo_bwd`` (:135) differentiates ``_reference_impl``.

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

MAX_PAIR_DIM = 128  # outer.cu: 16 threads of 4 output channels in each of two groups of 64


def outer_fits(B: int, N: int, D: int, dtype: torch.dtype) -> bool:
    """Whether K11 takes x [B, N, S] in ``dtype`` with D output channels: D a
    multiple of 4 up to MAX_PAIR_DIM, B and N from 1 to 65535."""
    return 0 < D <= MAX_PAIR_DIM and D % 4 == 0 and 0 < B <= 65535 and 0 < N <= 65535


def _split(x: torch.Tensor, w: torch.Tensor):
    """(xl in x's dtype, u f32 [..., N, D], W1 [D, S] in the dtype)."""
    S = x.shape[-1]
    xl32 = layer_norm_f32(x)
    u = xl32 @ w[:, S:].float().t()
    return xl32.to(x.dtype), u, w[:, :S].to(x.dtype)


def outer_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K11: x [..., N, S] -> [..., N, N, D]."""
    xl, u, w1 = _split(x, w)
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
        raise ValueError(f"the OuterLinear kernel takes a pair width that is a multiple of 4 up "
                         f"to {MAX_PAIR_DIM}, B and N from 1 to 65535; got B={B}, N={N}, D={D}")
    for name, t in (("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
    lib = build()
    xl, u, w1 = _split(x, w)
    xl, u = xl.contiguous(), u.contiguous()
    w1t = w1.t().contiguous()  # [S, D]
    bf = b.float().contiguous()
    out = torch.empty((B, N, N, D), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = lib.lib.prd_outer(
            xl.data_ptr(), u.data_ptr(), w1t.data_ptr(), bf.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[x.dtype], B, N, S, D, stream_of(x),
        )
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
