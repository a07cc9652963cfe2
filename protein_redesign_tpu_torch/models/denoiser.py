"""The SE(3)-equivariant denoiser trunk (port of
``protein_redesign_tpu/models/denoiser.py``).

The reference quirks stay: SPAttention applies no key-padding mask, its
per-head width is single_dim, and its residual wraps the normed input;
OuterProductUpdate divides by the mask outer product + 1e-3; the pair is
symmetrised as 0.5 * (P + P^T) at the end.

With ``cfg.remat`` and grad enabled, each FoldingBlock is checkpointed
(`denoiser.py:665`'s ``nn.remat``): the backward recomputes the block's
forward, launching its attention kernels a second time.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from protein_redesign_tpu.config import ModelConfig

from ..ops.attention import weak_scalar
from .layers import GatedAttention, LayerNorm, PRLinear, TransitionMLP, attention_core


class TriangleAttention(nn.Module):
    """Row-wise ('starting') or column-wise ('ending') attention over pair
    rows (`denoiser.py:44-75`)."""

    def __init__(self, pair_dim: int, head_dim: int, num_heads: int, mode: str,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if mode not in ("starting", "ending"):
            raise ValueError(f"Invalid mode: {mode}")
        self.mode = mode
        self.attn = GatedAttention(pair_dim, head_dim, num_heads, dtype)

    def forward(self, pair: torch.Tensor, mask_2d: torch.Tensor) -> torch.Tensor:
        if self.mode == "ending":
            pair = pair.transpose(-2, -3)
            mask_2d = mask_2d.transpose(-1, -2)
        out = self.attn(pair, mask_2d)
        if self.mode == "ending":
            out = out.transpose(-2, -3)
        return out


class TriangleMultiplication(nn.Module):
    """Gated triangle multiplicative update (`denoiser.py:83-181`), the
    plain einsum path. ``fast_accum`` keeps the [N, N, D] product in the
    compute dtype instead of f32."""

    def __init__(self, pair_dim: int, mode: str, fast_accum: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if mode not in ("outgoing", "incoming"):
            raise ValueError(f"Invalid mode: {mode}")
        D = pair_dim
        self.mode, self.fast_accum, self.dtype = mode, fast_accum, dtype
        self.norm = LayerNorm(D, dtype=dtype)
        self.ab_gate = PRLinear(D, 2 * D, init="gating", dtype=dtype)
        self.ab_proj = PRLinear(D, 2 * D, init="default", dtype=dtype)
        self.ab_norm = LayerNorm(D, dtype=dtype)
        self.out_gate = PRLinear(D, D, init="gating", dtype=dtype)
        self.out_proj = PRLinear(D, D, init="final", dtype=dtype)

    def forward(self, pair: torch.Tensor, mask_2d: torch.Tensor) -> torch.Tensor:
        acc = self.dtype if self.fast_accum else torch.float32
        pair = self.norm(pair)
        ab = mask_2d[..., None] * (torch.sigmoid(self.ab_gate(pair)) * self.ab_proj(pair))
        a, b = ab.chunk(2, dim=-1)
        # f32 products and accumulation, as preferred_element_type=f32.
        if self.mode == "outgoing":
            prod = torch.einsum("...ikd,...jkd->...ijd", a.float(), b.float())
        else:
            prod = torch.einsum("...kid,...kjd->...ijd", a.float(), b.float())
        prod = self.ab_norm(prod.to(acc))
        return torch.sigmoid(self.out_gate(pair)) * self.out_proj(prod)


class OuterLinear(nn.Module):
    """Pair update from single: Linear(cat[x_i * x_j, x_i - x_j])
    (`denoiser.py:184-251`). ``factored`` computes the same Linear as
    (x_i * x_j) W1 + u_i - u_j + b with u = x W2, without the
    [N, N, 2S] concat."""

    def __init__(self, single_dim: int, pair_dim: int, factored: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.factored, self.dtype, self.single_dim = factored, dtype, single_dim
        self.norm = LayerNorm(single_dim, dtype=dtype)
        self.linear = PRLinear(2 * single_dim, pair_dim, init="final", dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        S = self.single_dim
        x = self.norm(x)
        if self.factored:
            w = self.linear.weight.to(self.dtype).t()  # [2S, D], the flax kernel
            u = x @ w[S:]
            diff = u[..., :, None, :] - u[..., None, :, :]
            y = x[..., :, :, None] * w[:S]  # [..., N, S, D]
            prod = torch.einsum("...isd,...js->...ijd", y.float(), x.float()).to(self.dtype)
            return prod + diff + self.linear.bias.to(self.dtype)
        x_i = x[..., :, None, :]
        x_j = x[..., None, :, :]
        return self.linear(torch.cat([x_i * x_j, x_i - x_j], dim=-1))


class _SPAHeads(nn.Module):
    """Holds SPAttention's projections under the reference's ``mha`` names."""

    def __init__(self, single_dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        hc = num_heads * single_dim
        self.linear_q = PRLinear(single_dim, hc, bias=False, init="glorot", dtype=dtype)
        self.linear_k = PRLinear(single_dim, hc, bias=False, init="glorot", dtype=dtype)
        self.linear_v = PRLinear(single_dim, hc, bias=False, init="glorot", dtype=dtype)
        self.linear_g = PRLinear(single_dim, hc, init="gating", dtype=dtype)
        self.linear_o = PRLinear(hc, single_dim, init="final", dtype=dtype)


class SPAttention(nn.Module):
    """AF2 single attention with pair bias (`denoiser.py:254-314`): per-head
    width single_dim, no padding mask, residual on the normed input."""

    def __init__(self, single_dim: int, pair_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.single_dim, self.num_heads, self.dtype = single_dim, num_heads, dtype
        self.layer_norm_m = LayerNorm(single_dim, affine=True, dtype=dtype)
        self.linear_z = nn.Sequential(
            LayerNorm(pair_dim, affine=True, dtype=dtype),
            PRLinear(pair_dim, num_heads, bias=False, init="normal", dtype=dtype),
        )
        self.mha = _SPAHeads(single_dim, num_heads, dtype)

    def forward(self, single: torch.Tensor, pair: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        del mask  # accepted but unused, as in the reference
        H, C = self.num_heads, self.single_dim
        m = self.layer_norm_m(single)
        bias = torch.movedim(self.linear_z(pair), -1, -3)  # [..., H, i, j]

        def heads(y: torch.Tensor) -> torch.Tensor:
            return y.reshape(y.shape[:-1] + (H, C))

        q = heads(self.mha.linear_q(m)) / weak_scalar(math.sqrt(C), self.dtype)
        k = heads(self.mha.linear_k(m))
        v = heads(self.mha.linear_v(m))
        g = torch.sigmoid(heads(self.mha.linear_g(m)))
        o = attention_core(q, k, v, None, bias, 1.0).to(self.dtype)
        o = (g * o).reshape(o.shape[:-2] + (H * C,))
        return m + self.mha.linear_o(o)


class OuterProductUpdate(nn.Module):
    """AF2 outer-product-mean pair update (`denoiser.py:317-365`)."""

    def __init__(self, single_dim: int, pair_dim: int, hidden_dim: int, eps: float = 1e-3,
                 factored: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.factored, self.dtype = eps, factored, dtype
        self.layer_norm = LayerNorm(single_dim, affine=True, dtype=dtype)
        self.linear_1 = PRLinear(single_dim, hidden_dim, init="default", dtype=dtype)
        self.linear_2 = PRLinear(single_dim, hidden_dim, init="default", dtype=dtype)
        self.linear_out = PRLinear(hidden_dim, pair_dim, init="final", dtype=dtype)

    def forward(self, single: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        ln = self.layer_norm(single)
        m = mask[..., None].to(self.dtype)
        a = self.linear_1(ln) * m
        b = self.linear_2(ln) * m
        if self.factored:
            w = self.linear_out.weight.to(self.dtype).t()  # [C, D]
            y = a[..., :, :, None] * w  # [..., N, C, D]
            outer = torch.einsum("...icd,...jc->...ijd", y.float(), b.float()).to(self.dtype)
            outer = outer + self.linear_out.bias.to(self.dtype)
        else:
            outer = torch.einsum("...ic,...jc->...ijc", a.float(), b.float()).to(self.dtype)
            outer = self.linear_out(outer)
        norm = torch.einsum("...ic,...jc->...ijc", m, m) + weak_scalar(self.eps, self.dtype)
        return outer / norm


class FoldingBlock(nn.Module):
    """One denoiser block (`denoiser.py:368-457`)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        S, P = cfg.single_dim, cfg.pair_dim
        H, C = cfg.num_heads, cfg.head_dim
        fast_accum = cfg.fast_softmax or cfg.pair_stream_bf16
        self.attn_bias = nn.Sequential(
            LayerNorm(P, dtype=dtype), PRLinear(P, H, init="normal", dtype=dtype)
        )
        self.single_attn = GatedAttention(S, C, H, dtype)
        self.single_fc = TransitionMLP(S, S * cfg.transition_factor, S, dtype=dtype)
        self.outer_linear = OuterLinear(S, P, factored=cfg.outer_factored, dtype=dtype)
        self.pair_mul_outgoing = TriangleMultiplication(P, "outgoing", fast_accum, dtype)
        self.pair_mul_incoming = TriangleMultiplication(P, "incoming", fast_accum, dtype)
        self.pair_attn_starting = TriangleAttention(P, C, H, "starting", dtype)
        self.pair_attn_ending = TriangleAttention(P, C, H, "ending", dtype)
        self.pair_fc = TransitionMLP(P, P * cfg.transition_factor, P, dtype=dtype)

    def forward(self, single: torch.Tensor, pair: torch.Tensor,
                mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mask_2d = mask[..., :, None] * mask[..., None, :]
        attn_bias = torch.movedim(self.attn_bias(pair), -1, -3)  # [..., H, i, j]
        single = single + self.single_attn(single, mask, attn_bias)
        single = single + self.single_fc(single)
        pair = pair + self.outer_linear(single)
        pair = pair + self.pair_mul_outgoing(pair, mask_2d)
        pair = pair + self.pair_mul_incoming(pair, mask_2d)
        pair = pair + self.pair_attn_starting(pair, mask_2d)
        pair = pair + self.pair_attn_ending(pair, mask_2d)
        pair = pair + self.pair_fc(pair)
        return single, pair


class Denoiser(nn.Module):
    """OPM + SPAttention + num_blocks FoldingBlocks + symmetrisation
    (`denoiser.py:620-697`)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dtype = getattr(torch, cfg.dtype)
        self.cfg, self.dtype = cfg, dtype
        self.opm = OuterProductUpdate(
            cfg.single_dim, cfg.pair_dim, cfg.single_dim // 4,
            factored=cfg.outer_factored, dtype=dtype,
        )
        self.SPAAttnBlock = SPAttention(cfg.single_dim, cfg.pair_dim, cfg.num_heads, dtype)
        self.folding_blocks = nn.ModuleList(
            FoldingBlock(cfg, dtype) for _ in range(cfg.num_blocks)
        )

    def forward(self, single: torch.Tensor, pair: torch.Tensor,
                mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mask_2d = mask[..., :, None] * mask[..., None, :]
        pair = pair + mask_2d[..., None] * self.opm(single, mask)
        single = self.SPAAttnBlock(single, pair, mask)
        if self.cfg.pair_stream_bf16:
            pair = pair.to(torch.bfloat16)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for block in self.folding_blocks:
            if remat:
                single, pair = checkpoint(block, single, pair, mask, use_reentrant=False)
            else:
                single, pair = block(single, pair, mask)
        pair = pair.to(self.dtype)
        return single, 0.5 * (pair + pair.transpose(-2, -3))
