"""Query-chunked attention for long-context buckets (port of
``protein_redesign_tpu/ops/chunked_attention.py``).

The plain attention materialises the [rows, H, N, N] logits, and for
triangle attention the row count is itself B*N, so the logits grow as N^3:
8.6 GB of bf16 logits for four heads at N = 1024, and as much again for
the probabilities. ``chunked_attention`` evaluates the same function
``chunk`` query rows at a time, so the logits of one chunk are live at
once. Each chunk's arithmetic is the port's plain version's:
``attention_reference`` (f32 logits and softmax), or with ``fast`` on bf16
inputs ``attention_reference_fast`` (logits, softmax and its sum rounded to
bf16), as the JAX body accumulates in ``q.dtype`` there. With gradients on,
each chunk is checkpointed (the JAX ``jax.checkpoint``): the backward
recomputes one chunk's probabilities at a time.

Inputs keep their natural leading dims and the bias is sliced per chunk,
never broadcast to the row axis: the broadcast alone would materialise the
N^3 tensor the chunking exists to avoid. Nothing here launches a kernel;
``models.layers.attention_core`` calls it only where the attention would
otherwise run a plain version (``ops.attention.chunks_queries``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .attention import attention_reference, attention_reference_fast


def chunked_attention(
    q: torch.Tensor,               # [..., N, H, C]
    k: torch.Tensor,               # [..., N, H, C]
    v: torch.Tensor,               # [..., N, H, C]
    mask: Optional[torch.Tensor],  # broadcastable to [..., N]
    bias: Optional[torch.Tensor],  # broadcastable to [..., H, N, N]
    scale: float,
    chunk: int,
    fast: bool = False,
) -> torch.Tensor:
    """The plain attention (``attention_reference``, or with ``fast`` on
    bf16 inputs ``attention_reference_fast``) evaluated ``chunk`` query rows
    at a time, on unflattened inputs. Requires 0 < chunk <= N and
    N % chunk == 0."""
    N = q.shape[-3]
    if not (0 < chunk <= N and N % chunk == 0):
        raise ValueError(f"attn_chunk={chunk} must divide the padded length N={N}")
    # f32 inputs: the JAX body accumulates in f32 with or without the flag
    body = attention_reference_fast if fast and q.dtype != torch.float32 else attention_reference
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias))
    # k stays in its dtype: each body's f32 copy of it dies after the logits,
    # where one copy cast before the loop would stay live through every
    # chunk's softmax and P.V (PERF.md: more peak memory for ~2% time)
    outs = []
    for start in range(0, N, chunk):
        qc = q[..., start:start + chunk, :, :]
        bc = None if bias is None else bias[..., start:start + chunk, :]
        if grad:
            outs.append(checkpoint(body, qc, k, v, mask, bc, scale, use_reentrant=False))
        else:
            outs.append(body(qc, k, v, mask, bc, scale))
    return torch.cat(outs, dim=-3)
