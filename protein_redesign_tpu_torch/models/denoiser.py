"""The SE(3)-equivariant denoiser trunk (port of
``protein_redesign_tpu/models/denoiser.py``).

The reference quirks stay: SPAttention applies no key-padding mask, its
per-head width is single_dim, and its residual wraps the normed input;
OuterProductUpdate divides by the mask outer product + 1e-3; the pair is
symmetrised as 0.5 * (P + P^T) at the end.

With ``cfg.remat`` and grad enabled, each FoldingBlock is checkpointed
(`denoiser.py:665`'s ``nn.remat``): the backward recomputes the block's
forward, launching its attention kernels a second time.

With ``cfg.sequence_parallel`` inside ``parallel.mesh.on_mesh`` (the
counterpart of the JAX Denoiser's ``with mesh:``; without one it raises, as
JAX's ``with_sharding_constraint`` does), each rank of the model group
holds its block of the first complex axis of ``pair`` [B, N, N, D] and
``single`` [B, N, C] from the first FoldingBlock through the end of the
stack (`denoiser.py:460-469, 667-669, 692-693`), and the ops reach past
their rows through ``mesh.gather_blocks`` (all-gather, its adjoint a
reduce-scatter): single attention gathers the keys' and values' rows,
OuterLinear ``single[j]``, the outgoing triangle multiplication ``b``, the
incoming one ``a`` and ``b``; the ending triangle attention and the final
symmetrisation take the transpose from the gathered whole. Starting
triangle attention and the transitions are local. No kernel runs (JAX's
``fused_ok`` and plan): the Denoiser runs inside ``ops.attention.
plain_route()`` and the fused switches are off. Where m does not divide N
the last block is short, padded for the collectives only.

``resolve_attention_plan`` is a copy of the JAX package's decision
(`denoiser.py:470-617`). The Denoiser resolves it once per forward from the
padded complex axis, as the JAX one does (:638), and hands ``use_pallas``
and ``attn_chunk`` to every attention: the port reads ``use_pallas`` only
for ``fast_softmax`` (see ``ops.attention.gated_attention_core``), and
``attn_chunk`` where the attention takes a plain route
(``models.layers.attention_core``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import ModelConfig
from ..ops.attention import plain_route, weak_scalar
from ..parallel import mesh
from ..ops.outer import fused_outer_linear
from ..ops.trimul import triangle_multiply
from .layers import GatedAttention, LayerNorm, PRLinear, TransitionMLP, attention_core


# --- copied from protein_redesign_tpu/models/denoiser.py (:470-617) ---------
# The JAX attention plan, its thresholds measured on a TPU (v5e): the port
# mirrors the decision, not its speed, because where it leaves Pallas the
# fast_softmax flag computes another function (bf16 logits in XLA).
PALLAS_TRAIN_MAX_N = 2048  # kernel ceiling for training (inclusive)
PALLAS_INFER_MAX_N = 2048  # kernel ceiling for inference (inclusive)
# From this size up, non-kernel plans chunk queries where the unchunked
# logits would not fit.
LONGCTX_CHUNK_MIN_N = 768


def resolve_attention_plan(cfg: ModelConfig, n: int) -> Tuple[bool, int]:
    """(use_pallas, attn_chunk) for a padded complex axis of n.

    Explicit settings win: ``cfg.use_pallas`` forces the kernel,
    ``cfg.attn_chunk`` forces query-chunked attention. Otherwise: plain XLA
    below ``pallas_auto_min_n`` (384); the kernel for narrow heads
    (head_dim < 32) at inference, and in training with ``use_pallas_bwd``,
    up to the ceilings; for wide heads (head_dim >= 64) within their
    measured range (training 384..512, or ..1024 single-head; inference
    from 512, or 384 with the bf16 pair stream or several heads); heads of
    32..63, sequence parallelism and training without ``use_pallas_bwd``
    keep XLA; from 768 up, query chunks of 128 in training and where the
    unchunked logits would pass ~4 GB."""
    if cfg.use_pallas:
        return True, 0
    if cfg.attn_chunk > 0:
        return False, cfg.attn_chunk
    if cfg.pallas_auto_min_n <= 0:
        return False, 0
    inference = not cfg.training_mode and not cfg.sequence_parallel
    trainable = (
        cfg.training_mode
        and cfg.use_pallas_bwd
        and not cfg.sequence_parallel
        and n <= PALLAS_TRAIN_MAX_N
    )
    ceiling = (PALLAS_INFER_MAX_N if inference else PALLAS_TRAIN_MAX_N) + 1
    if (
        (inference or trainable)
        and cfg.head_dim < 32
        and cfg.pallas_auto_min_n <= n < ceiling
    ):
        return True, 0
    wide_infer_min = (
        384 if (cfg.pair_stream_bf16 or cfg.num_heads > 1) else 512
    )
    wide_max_n = 1024 if cfg.num_heads == 1 else 512
    if (
        (inference or trainable)
        and cfg.head_dim >= 64
        and n <= wide_max_n
        and n >= max(cfg.pallas_auto_min_n, wide_infer_min if inference else 384)
    ):
        return True, 0
    if n >= LONGCTX_CHUNK_MIN_N:
        chunk = 128 if n % 128 == 0 else 0
        if cfg.training_mode or cfg.sequence_parallel:
            return False, chunk
        bpe = 2 if cfg.dtype == "bfloat16" else 4
        logits_gb = cfg.num_heads * n**3 * bpe / 1e9  # B=1 heuristic
        if logits_gb > 4.0:
            return False, chunk
    return False, 0
# --- end of copy -------------------------------------------------------------


class TriangleAttention(nn.Module):
    """Row-wise ('starting') or column-wise ('ending') attention over pair
    rows (`denoiser.py:44-75`)."""

    def __init__(self, pair_dim: int, head_dim: int, num_heads: int, mode: str,
                 dtype: torch.dtype = torch.float32, fused_gated: bool = False,
                 fast: bool = False, kernel_bwd: bool = True):
        super().__init__()
        if mode not in ("starting", "ending"):
            raise ValueError(f"Invalid mode: {mode}")
        self.mode = mode
        self.attn = GatedAttention(pair_dim, head_dim, num_heads, dtype, fused_gated=fused_gated,
                                   fast=fast, kernel_bwd=kernel_bwd)

    def forward(self, pair: torch.Tensor, mask_2d: torch.Tensor,
                use_pallas: bool = True, attn_chunk: int = 0,
                transpose: Optional[Callable] = None) -> torch.Tensor:
        """``transpose`` (sequence parallelism): this rank's rows of a
        row-sharded tensor's transpose; mask_2d, symmetric, is its own."""
        if self.mode == "ending":
            if transpose is None:
                pair = pair.transpose(-2, -3)
                mask_2d = mask_2d.transpose(-1, -2)
            else:
                pair = transpose(pair)
        out = self.attn(pair, mask_2d, use_pallas=use_pallas, attn_chunk=attn_chunk)
        if self.mode == "ending":
            out = out.transpose(-2, -3) if transpose is None else transpose(out)
        return out


class TriangleMultiplication(nn.Module):
    """Gated triangle multiplicative update (`denoiser.py:83-181`).
    ``fast_accum`` keeps the einsum path's [N, N, D] product in the compute
    dtype instead of f32. ``dmajor`` (``cfg.trimul_dmajor``) contracts
    channel-major, a and b moved to [..., d, N, N] for a d-batched
    [N, N] x [N, N] product (`denoiser.py:142-160`). ``fused``
    (``cfg.use_pallas_trimul``): the whole op as one kernel (K9,
    ``triangle_multiply``) on the same parameters; it ignores
    ``fast_accum`` and ``dmajor``, as the JAX fused path does."""

    def __init__(self, pair_dim: int, mode: str, fast_accum: bool = False,
                 dtype: torch.dtype = torch.float32, fused: bool = False, dmajor: bool = False):
        super().__init__()
        if mode not in ("outgoing", "incoming"):
            raise ValueError(f"Invalid mode: {mode}")
        D = pair_dim
        self.mode, self.fast_accum, self.dtype, self.fused = mode, fast_accum, dtype, fused
        self.dmajor = dmajor
        self.norm = LayerNorm(D, dtype=dtype)
        self.ab_gate = PRLinear(D, 2 * D, init="gating", dtype=dtype)
        self.ab_proj = PRLinear(D, 2 * D, init="default", dtype=dtype)
        self.ab_norm = LayerNorm(D, dtype=dtype)
        self.out_gate = PRLinear(D, D, init="gating", dtype=dtype)
        self.out_proj = PRLinear(D, D, init="final", dtype=dtype)

    def forward(self, pair: torch.Tensor, mask_2d: torch.Tensor,
                sp: Optional[Tuple[Callable, int, int]] = None) -> torch.Tensor:
        """``sp`` (sequence parallelism: this rank's rows [lo, hi) of the
        pair and of mask_2d): (gather, lo, hi), ``gather`` the whole
        complex axis from the rows."""
        if self.fused:
            return triangle_multiply(
                pair.to(self.dtype), mask_2d.to(self.dtype),
                self.ab_gate.weight, self.ab_gate.bias, self.ab_proj.weight, self.ab_proj.bias,
                self.out_gate.weight, self.out_gate.bias, self.out_proj.weight,
                self.out_proj.bias, self.mode,
            )
        acc = self.dtype if self.fast_accum else torch.float32
        pair = self.norm(pair)
        ab = mask_2d[..., None] * (torch.sigmoid(self.ab_gate(pair)) * self.ab_proj(pair))
        a, b = ab.chunk(2, dim=-1)
        # f32 products and accumulation, as preferred_element_type=f32.
        if sp is not None:
            gather, lo, hi = sp
            if self.mode == "outgoing":  # a[i, k] local, b[j, k] of every j
                prod = torch.einsum("...ikd,...jkd->...ijd", a.float(), gather(b).float())
            else:  # a[k, i] of every k at the local i, b[k, j] of every k
                prod = torch.einsum("...kid,...kjd->...ijd",
                                    gather(a)[:, :, lo:hi].float(), gather(b).float())
        elif self.dmajor:
            at, bt = (torch.movedim(t.float(), -1, -3) for t in (a, b))  # [..., d, N, N]
            if self.mode == "outgoing":
                prod = torch.matmul(at, bt.transpose(-1, -2))
            else:
                prod = torch.matmul(at.transpose(-1, -2), bt)
            prod = torch.movedim(prod, -3, -1)
        elif self.mode == "outgoing":
            prod = torch.einsum("...ikd,...jkd->...ijd", a.float(), b.float())
        else:
            prod = torch.einsum("...kid,...kjd->...ijd", a.float(), b.float())
        prod = self.ab_norm(prod.to(acc))
        return torch.sigmoid(self.out_gate(pair)) * self.out_proj(prod)


class OuterLinear(nn.Module):
    """Pair update from single: Linear(cat[x_i * x_j, x_i - x_j])
    (`denoiser.py:184-251`). ``factored`` computes the same Linear as
    (x_i * x_j) W1 + u_i - u_j + b with u = x W2, without the
    [N, N, 2S] concat. ``fused`` (``cfg.use_pallas_outer``, which takes
    precedence over ``factored``): the same function as one kernel (K11,
    ``fused_outer_linear``) on the same parameters."""

    def __init__(self, single_dim: int, pair_dim: int, factored: bool = False,
                 dtype: torch.dtype = torch.float32, fused: bool = False):
        super().__init__()
        self.factored, self.dtype, self.single_dim = factored, dtype, single_dim
        self.fused = fused
        self.norm = LayerNorm(single_dim, dtype=dtype)
        self.linear = PRLinear(2 * single_dim, pair_dim, init="final", dtype=dtype)

    def forward(self, x: torch.Tensor, x_j: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x_j`` (sequence parallelism): the whole single representation,
        x this rank's rows i of it."""
        if self.fused:
            return fused_outer_linear(x.to(self.dtype), self.linear.weight, self.linear.bias)
        S = self.single_dim
        x = self.norm(x)
        xj = x if x_j is None else self.norm(x_j)
        if self.factored:
            w = self.linear.weight.to(self.dtype).t()  # [2S, D], the flax kernel
            u, uj = x @ w[S:], xj @ w[S:]
            diff = u[..., :, None, :] - uj[..., None, :, :]
            y = x[..., :, :, None] * w[:S]  # [..., N, S, D]
            prod = torch.einsum("...isd,...js->...ijd", y.float(), xj.float()).to(self.dtype)
            return prod + diff + self.linear.bias.to(self.dtype)
        x_i = x[..., :, None, :]
        x_j = xj[..., None, :, :]
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
    width single_dim, no padding mask, residual on the normed input.
    ``fast`` (``cfg.fast_softmax``) and the plan's ``use_pallas`` and
    ``attn_chunk`` go to the attention, as the JAX module's do."""

    def __init__(self, single_dim: int, pair_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, fast: bool = False):
        super().__init__()
        self.single_dim, self.num_heads, self.dtype, self.fast = single_dim, num_heads, dtype, fast
        self.layer_norm_m = LayerNorm(single_dim, affine=True, dtype=dtype)
        self.linear_z = nn.Sequential(
            LayerNorm(pair_dim, affine=True, dtype=dtype),
            PRLinear(pair_dim, num_heads, bias=False, init="normal", dtype=dtype),
        )
        self.mha = _SPAHeads(single_dim, num_heads, dtype)

    def forward(self, single: torch.Tensor, pair: torch.Tensor, mask: torch.Tensor,
                use_pallas: bool = True, attn_chunk: int = 0) -> torch.Tensor:
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
        o = attention_core(q, k, v, None, bias, 1.0, self.fast, use_pallas=use_pallas,
                           attn_chunk=attn_chunk).to(self.dtype)
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
    """One denoiser block (`denoiser.py:368-457`). ``cfg.trimul_dmajor`` goes
    to both triangle multiplications. The four fused-kernel switches route
    its modules as the JAX block does (`denoiser.py:676-688`):
    ``use_pallas_transition`` single_fc and pair_fc (K10),
    ``use_pallas_outer`` outer_linear (K11), ``use_pallas_trimul`` both
    triangle multiplications (K9), ``use_pallas_fused_gated`` both triangle
    attentions (K8). ``fast`` and ``kernel_bwd`` (``cfg.fast_softmax`` and
    ``cfg.use_pallas_bwd``, taken once by the Denoiser) go to the attentions,
    and so do the plan's ``use_pallas`` and ``attn_chunk``, resolved once per
    forward."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, fast: bool = False,
                 kernel_bwd: bool = True):
        super().__init__()
        S, P = cfg.single_dim, cfg.pair_dim
        H, C = cfg.num_heads, cfg.head_dim
        fast_accum = fast or cfg.pair_stream_bf16
        # no fused kernel with the complex axis sharded (`denoiser.py:644`)
        fused_ok = not cfg.sequence_parallel
        self.attn_bias = nn.Sequential(
            LayerNorm(P, dtype=dtype), PRLinear(P, H, init="normal", dtype=dtype)
        )
        flags = dict(fast=fast, kernel_bwd=kernel_bwd and fused_ok)
        self.single_attn = GatedAttention(S, C, H, dtype, **flags)
        transition = cfg.use_pallas_transition and fused_ok
        trimul = cfg.use_pallas_trimul and fused_ok
        fused_gated = cfg.use_pallas_fused_gated and fused_ok
        self.single_fc = TransitionMLP(S, S * cfg.transition_factor, S, dtype=dtype,
                                       fused=transition)
        self.outer_linear = OuterLinear(S, P, factored=cfg.outer_factored, dtype=dtype,
                                        fused=cfg.use_pallas_outer and fused_ok)
        self.pair_mul_outgoing = TriangleMultiplication(P, "outgoing", fast_accum, dtype,
                                                        fused=trimul, dmajor=cfg.trimul_dmajor)
        self.pair_mul_incoming = TriangleMultiplication(P, "incoming", fast_accum, dtype,
                                                        fused=trimul, dmajor=cfg.trimul_dmajor)
        self.pair_attn_starting = TriangleAttention(P, C, H, "starting", dtype,
                                                    fused_gated=fused_gated, **flags)
        self.pair_attn_ending = TriangleAttention(P, C, H, "ending", dtype,
                                                  fused_gated=fused_gated, **flags)
        self.pair_fc = TransitionMLP(P, P * cfg.transition_factor, P, dtype=dtype,
                                     fused=transition)

    def forward(self, single: torch.Tensor, pair: torch.Tensor, mask: torch.Tensor,
                use_pallas: bool = True, attn_chunk: int = 0,
                sp: Optional[Tuple[mesh.MeshAxes, int, int]] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``sp`` (sequence parallelism): (axes, lo, hi), single and pair
        this rank's rows [lo, hi) of their first complex axis."""
        if sp is not None:
            with plain_route():  # here too for remat's recompute in the backward
                return self._forward_rows(single, pair, mask, use_pallas, attn_chunk, *sp)
        mask_2d = mask[..., :, None] * mask[..., None, :]
        attn_bias = torch.movedim(self.attn_bias(pair), -1, -3)  # [..., H, i, j]
        single = single + self.single_attn(single, mask, attn_bias, use_pallas, attn_chunk)
        single = single + self.single_fc(single)
        pair = pair + self.outer_linear(single)
        pair = pair + self.pair_mul_outgoing(pair, mask_2d)
        pair = pair + self.pair_mul_incoming(pair, mask_2d)
        pair = pair + self.pair_attn_starting(pair, mask_2d, use_pallas, attn_chunk)
        pair = pair + self.pair_attn_ending(pair, mask_2d, use_pallas, attn_chunk)
        pair = pair + self.pair_fc(pair)
        return single, pair

    def _forward_rows(self, single, pair, mask, use_pallas, attn_chunk, axes, lo, hi):
        N = mask.shape[-1]

        def gather(x: torch.Tensor) -> torch.Tensor:
            return mesh.gather_blocks(x, axes, N)

        def transpose(x: torch.Tensor) -> torch.Tensor:
            return gather(x).transpose(1, 2)[:, lo:hi]

        mask_2d = mask[..., lo:hi, None] * mask[..., None, :]  # [B, rows, N]
        attn_bias = torch.movedim(self.attn_bias(pair), -1, -3)  # [B, H, rows, N]
        single = single + self.single_attn(single, mask, attn_bias, use_pallas, attn_chunk,
                                           kv=gather(single))
        single = single + self.single_fc(single)
        pair = pair + self.outer_linear(single, gather(single))
        pair = pair + self.pair_mul_outgoing(pair, mask_2d, (gather, lo, hi))
        pair = pair + self.pair_mul_incoming(pair, mask_2d, (gather, lo, hi))
        pair = pair + self.pair_attn_starting(pair, mask_2d, use_pallas, attn_chunk)
        pair = pair + self.pair_attn_ending(pair, mask_2d, use_pallas, attn_chunk, transpose)
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
        self.SPAAttnBlock = SPAttention(cfg.single_dim, cfg.pair_dim, cfg.num_heads, dtype,
                                        fast=cfg.fast_softmax)
        # the attention flags, taken once (`denoiser.py:652, 677, 687`)
        fast, kernel_bwd = cfg.fast_softmax, cfg.use_pallas_bwd
        self.folding_blocks = nn.ModuleList(
            FoldingBlock(cfg, dtype, fast, kernel_bwd) for _ in range(cfg.num_blocks)
        )

    def forward(self, single: torch.Tensor, pair: torch.Tensor,
                mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        axes = None
        if self.cfg.sequence_parallel:
            axes = mesh.current_axes()
            if axes is None:
                raise RuntimeError(
                    "sequence_parallel shards the complex axis over the mesh's 'model' axis and "
                    "needs a mesh in context: run the model inside parallel.mesh.on_mesh(...), "
                    "as the JAX Denoiser runs inside `with mesh:`")
        with plain_route() if axes is not None else contextlib.nullcontext():
            return self._forward(single, pair, mask, axes)

    def _forward(self, single, pair, mask, axes):
        use_pallas, attn_chunk = resolve_attention_plan(self.cfg, single.shape[-2])
        mask_2d = mask[..., :, None] * mask[..., None, :]
        pair = pair + mask_2d[..., None] * self.opm(single, mask)
        single = self.SPAAttnBlock(single, pair, mask, use_pallas, attn_chunk)
        if self.cfg.pair_stream_bf16:
            pair = pair.to(torch.bfloat16)
        remat = self.cfg.remat and torch.is_grad_enabled()
        sp, N = None, single.shape[-2]
        if axes is not None:  # this rank's rows of the complex axis
            lo, hi = mesh.sp_rows(N, axes)
            sp = (axes, lo, hi)
            single, pair = single[:, lo:hi], pair[:, lo:hi]
        for block in self.folding_blocks:
            if remat:
                single, pair = checkpoint(block, single, pair, mask, use_pallas, attn_chunk, sp,
                                          use_reentrant=False)
            else:
                single, pair = block(single, pair, mask, use_pallas, attn_chunk, sp)
        if axes is not None:
            single, pair = mesh.gather_blocks(single, axes, N), mesh.gather_blocks(pair, axes, N)
        pair = pair.to(self.dtype)
        return single, 0.5 * (pair + pair.transpose(-2, -3))
