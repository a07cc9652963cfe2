"""Masked, biased multi-head attention: the plain PyTorch version and the
dispatch to the hand-written Hopper kernels.

Port of ``protein_redesign_tpu/ops/pallas_attention.py``: ``attention_reference``
is ``_attention_reference`` (:1242) at f32 logits, ``fused_attention`` is the
forward of ``fused_attention`` (:1265), and ``gated_attention_core`` is
``gated_attention_core`` (:1525). The two kernel wrappers replace the Pallas
kernels the denoiser's main path runs:

- ``rows_attention`` (K1) <- ``_rows_attention_impl`` / ``_make_rowhead_kernel``:
  key mask, no bias (triangle attention).
- ``tiled_attention`` (K2) <- ``_tiled_attention_impl`` / ``_attn_kernel`` /
  ``_attn_kernel_nomask``: additive bias, key mask optional (single attention,
  SPAttention).
- ``rows_attention_bwd`` (K7) <- ``_rows_attention_bwd_impl`` /
  ``_make_rowhead_bwd_kernel``: the flash backward of K1.

Gradients follow the JAX ``custom_vjp`` pair ``_fwd``/``_bwd`` (:1425/:1454)
with ``kernel_bwd`` on, the training default: K1's backward is K7, and K2's
is the plain recompute through ``attention_reference`` under autograd (the
JAX einsum VJP, :1509-1519: its dbias is [R, H, N, N] anyway, so the JAX
package has no backward kernel for it either).

Public functions keep the JAX layout: q, k, v are [R, N, H, C], mask [R, N],
bias [R, H, N, N]. A wrapper given CPU tensors runs the plain version; given
CUDA tensors it launches its kernel or raises. The kernels read q, k, v and
dO through their strides (head dimension contiguous, so the swapped "ending"
triangle layout needs no copy); the wrapper makes the mask (f32) and the bias
contiguous.

The port's attention plan has no size gates yet (those of the JAX
package's ``resolve_attention_plan``, ``protein_redesign_tpu/models/
denoiser.py:497``, were measured on a TPU): every model attention goes
through ``gated_attention_core`` to the kernel wrappers. Inside
``plain_route()`` it runs the plain version on any device instead, forward
and backward (autograd of ``attention_reference``); that block exists to
compare the kernels with the plain version on the card, and nothing on the
main path enters it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch

NEG_INF = -(2.0**15)  # the reference's padding fill (`pallas_attention.py:33`)
MAX_HEAD_DIM = 512
MAX_HEADS = 65535  # grid.y
# One block per (row, 16-query tile) at most, in grid.x's 2^31 - 1 blocks.
MIN_QUERY_TILE, MAX_BLOCKS = 16, 2**31 - 1
MAX_BWD_HEAD_DIM = 32  # K7 keeps a row's vectors in registers

# Launches of each kernel since the last reset. A wrapper adds one where it
# launches its kernel and nowhere else.
LAUNCHES: Dict[str, int] = {"rows_attention": 0, "tiled_attention": 0, "rows_attention_bwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PLAIN_ROUTE = False  # set only inside plain_route()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _check(q, k, v, mask, bias) -> None:
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
    for name, t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}, got {t.device}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention kernels take float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v), ("bias", bias)):
        if t is not None and t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    if not (0 < C <= MAX_HEAD_DIM and C % 4 == 0):
        raise ValueError(f"head width {C} unsupported: need a multiple of 4 up to {MAX_HEAD_DIM}")
    if R == 0 or N == 0 or H == 0:
        raise ValueError(f"empty attention: R={R}, N={N}, H={H}")
    if H > MAX_HEADS or -(-N // MIN_QUERY_TILE) * R > MAX_BLOCKS:
        raise ValueError(f"attention grid too large: R={R}, N={N}, H={H}")
    for name, t in tensors[:3]:
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous along the head dimension")


def _launch(name: str, q, k, v, mask, bias, scale: float) -> torch.Tensor:
    from ..kernels import build

    _check(q, k, v, mask, bias)
    lib = build()
    R, N, H, C = q.shape
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    if bias is not None:
        bias = bias.contiguous()
    out = torch.empty((R, N, H, C), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        common = (_DTYPE_CODES[q.dtype], R, N, H, C, weak_scalar(scale, q.dtype), *strides, stream)
        if name == "rows_attention":
            code = lib.lib.prd_rows_attention(
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


def _launch_bwd(q, k, v, mask, dout, scale: float):
    from ..kernels import build

    _check(q, k, v, mask, None)
    R, N, H, C = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"dout must match q: got {tuple(dout.shape)} {dout.dtype} on {dout.device}")
    if C > MAX_BWD_HEAD_DIM:
        raise ValueError(f"rows attention backward takes head width up to {MAX_BWD_HEAD_DIM}, "
                         f"got {C}")
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    lib = build()
    mask = mask.to(torch.float32).contiguous()
    dq, dk, dv = (torch.empty((R, N, H, C), dtype=q.dtype, device=q.device) for _ in range(3))
    stats = torch.empty((3, R, H, N), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, dout) for s in t.stride()[:3]]
    w = weak_scalar(scale, q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.lib.prd_rows_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            _DTYPE_CODES[q.dtype], R, N, H, C, w, *strides, stream,
        )
    lib.check(code, "rows_attention_bwd")
    LAUNCHES["rows_attention_bwd"] += 1
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


def rows_attention_bwd(q, k, v, mask: torch.Tensor, dout: torch.Tensor, scale: float):
    """K7: (dq, dk, dv) of ``rows_attention`` given dO; dq is with respect
    to the unscaled q."""
    if _on_cpu(q):
        return rows_attention_bwd_reference(q, k, v, mask, dout, scale)
    return _launch_bwd(q, k, v, mask, dout, scale)


class _RowsAttention(torch.autograd.Function):
    """K1 forward, K7 backward (the JAX ``_fwd``/``_bwd`` with ``kernel_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale):
        ctx.save_for_backward(q, k, v, mask)
        ctx.scale = scale
        if _on_cpu(q):
            return attention_reference(q, k, v, mask, None, scale)
        return _launch("rows_attention", q, k, v, mask, None, scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask = ctx.saved_tensors
        dq, dk, dv = rows_attention_bwd(q, k, v, mask, dout, ctx.scale)
        return dq, dk, dv, None, None


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
        q, k, v, mask, bias = ctx.saved_tensors
        wanted = [i for i in (0, 1, 2, 4) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            inputs = [q, k, v, mask, bias]
            for i in wanted:
                inputs[i] = inputs[i].detach().requires_grad_()
            out = attention_reference(*inputs, ctx.scale)
            grads = torch.autograd.grad(out, [inputs[i] for i in wanted], dout)
        result = [None] * 6
        for i, grad in zip(wanted, grads):
            result[i] = grad
        return tuple(result)


def rows_attention(q, k, v, mask: torch.Tensor, scale: float) -> torch.Tensor:
    """K1: masked attention without bias. q, k, v [R, N, H, C]; mask [R, N].
    Differentiable: the backward is K7."""
    if mask is None:
        raise ValueError("rows_attention needs a key mask")
    return _RowsAttention.apply(q, k, v, mask, scale)


def tiled_attention(q, k, v, mask: Optional[torch.Tensor], bias: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """K2: attention with a bias [R, H, N, N] and an optional key mask [R, N].
    Differentiable: the backward is the plain recompute."""
    if bias is None:
        raise ValueError("tiled_attention needs a bias; masked attention without one "
                         "is rows_attention's")
    return _TiledAttention.apply(q, k, v, mask, bias, scale)


def fused_attention(q, k, v, mask, bias, scale: float) -> torch.Tensor:
    """The kernel route, dispatched as the JAX forward does
    (`_fused_attention_fwd_impl`): no bias goes to K1, which needs the
    mask, and a bias to K2."""
    if bias is None:
        return rows_attention(q, k, v, mask, scale)
    return tiled_attention(q, k, v, mask, bias, scale)


@contextlib.contextmanager
def plain_route() -> Iterator[None]:
    """Inside this block ``gated_attention_core`` runs the plain version on
    CUDA tensors too. For comparing the kernels with it (tests and
    chip_smoke.py); process-wide, not per thread."""
    global _PLAIN_ROUTE
    outer, _PLAIN_ROUTE = _PLAIN_ROUTE, True
    try:
        yield
    finally:
        _PLAIN_ROUTE = outer


def gated_attention_core(q, k, v, mask, bias, scale: float) -> torch.Tensor:
    """Every model attention: the kernel route, or the plain version inside
    ``plain_route()``; inputs row-flattened as above."""
    if _PLAIN_ROUTE:
        return attention_reference(q, k, v, mask, bias, scale)
    return fused_attention(q, k, v, mask, bias, scale)
