"""PyTorch building blocks for the denoiser (port of
``protein_redesign_tpu/models/layers.py``).

Parameters are float32 and registered under the reference ``state_dict``
names (`utils/convert.py:57-123`); every module computes in the ``dtype`` it
was built with (bfloat16 at paper width), LayerNorm statistics and attention
logits in float32, as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from protein_redesign_tpu.chem.features import ATOM_FEATURE_SIZES, BOND_FEATURE_SIZES

# masked_softmax is defined beside the plain attention that uses it and is
# re-exported here, where the JAX package's layer vocabulary has it.
from ..ops.attention import gated_attention_core, masked_softmax, weak_scalar  # noqa: F401

TRUNC_STD_CORRECTION = 0.87962566103423978


def init_linear_(weight: torch.Tensor, bias: Optional[torch.Tensor], init: str) -> None:
    """The reference init vocabulary (`layers.py:40-56`) on a torch
    [out, in] weight; 'gating' biases start at 1, all others at 0."""
    fan_out, fan_in = weight.shape
    with torch.no_grad():
        if init in ("default", "relu"):
            std = math.sqrt((2.0 if init == "relu" else 1.0) / fan_in) / TRUNC_STD_CORRECTION
            nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)
        elif init == "glorot":
            nn.init.xavier_uniform_(weight)
        elif init == "normal":
            nn.init.normal_(weight, std=math.sqrt(1.0 / fan_in))
        elif init in ("gating", "final"):
            weight.zero_()
        else:
            raise ValueError(f"Invalid init: {init}")
        if bias is not None:
            bias.fill_(1.0 if init == "gating" else 0.0)


class PRLinear(nn.Module):
    """Linear with the reference init names, computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 init: str = "default", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        init_linear_(self.weight, self.bias, init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics, eps 1e-5, output in ``dtype``;
    ``affine`` adds the AF2 weight and bias."""

    def __init__(self, dim: int, affine: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        if affine:
            self.weight = nn.Parameter(torch.ones(dim))
            self.bias = nn.Parameter(torch.zeros(dim))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (self.dim,), self.weight, self.bias, 1e-5)
        return y.to(self.dtype)


class CategoricalEmbedding(nn.Module):
    """Mean of per-feature embeddings scaled by 1/sqrt(F) (`layers.py:155-206`).
    The per-feature tables keep the reference names (``embeddings.{i}``) and
    are gathered as one offset table."""

    def __init__(self, sizes: Sequence[int], features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embeddings = nn.ModuleList(nn.Embedding(s, features) for s in sizes)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        self.register_buffer("offsets", torch.as_tensor(offsets, dtype=torch.long),
                             persistent=False)
        self.scale = 1.0 / math.sqrt(len(sizes))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        table = torch.cat([e.weight for e in self.embeddings], dim=0).to(self.dtype)
        gathered = F.embedding(feats.long() + self.offsets, table)  # [..., F, D]
        return weak_scalar(self.scale, self.dtype) * gathered.sum(dim=-2)


def AtomEmbedding(features: int, dtype: torch.dtype) -> CategoricalEmbedding:
    return CategoricalEmbedding(ATOM_FEATURE_SIZES, features, dtype)


def BondEmbedding(features: int, dtype: torch.dtype) -> CategoricalEmbedding:
    return CategoricalEmbedding(BOND_FEATURE_SIZES, features, dtype)


class Embed(nn.Module):
    """Plain categorical embedding with N(0, 1) init (embed_relpos,
    embed_bond_distance)."""

    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.randn(num_embeddings, features))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx.long(), self.weight.to(self.dtype))


def rbf_centers(features: int, min_val: float = 0.0, max_val: float = 2.0) -> torch.Tensor:
    """The RBF centres, buffer ``embed_dist.0.center``."""
    return torch.linspace(min_val, max_val, features)


def sinusoidal_weights(features: int) -> torch.Tensor:
    """The log-spaced frequencies, buffer ``embed_beta.0.weight``."""
    if features % 2 != 0:
        raise ValueError(f"features must be even: {features}.")
    return torch.as_tensor(np.logspace(-4.0, 0.0, features // 2), dtype=torch.float32)


class RadialBasisProjection(nn.Module):
    """Gaussian RBF on [0, 2] nm (`layers.py:229-245`)."""

    def __init__(self, features: int, min_val: float = 0.0, max_val: float = 2.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.scale = (features - 1) / (max_val - min_val)
        self.register_buffer("center", rbf_centers(features, min_val, max_val))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x[..., None].to(self.dtype) - self.center.to(self.dtype)
        return torch.exp(weak_scalar(-self.scale, self.dtype) * torch.square(d))


class SinusoidalProjection(nn.Module):
    """Log-spaced sin/cos features (`layers.py:248-262`)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("weight", sinusoidal_weights(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wx = self.weight.to(self.dtype) * x[..., None].to(self.dtype)
        return torch.cat([torch.sin(wx), torch.cos(wx)], dim=-1)


def attention_core(
    query: torch.Tensor,  # [..., N, H, C]
    key: torch.Tensor,
    value: torch.Tensor,
    mask: Optional[torch.Tensor],       # broadcastable to [..., N]
    attn_bias: Optional[torch.Tensor],  # [..., H, N, N]
    scale: float,
) -> torch.Tensor:
    """Row-flatten the leading dims and run ``gated_attention_core``
    (`layers.py:276-324`)."""
    lead = query.shape[:-3]
    N, H, C = query.shape[-3:]
    R = math.prod(lead)
    qf = query.reshape(R, N, H, C)
    kf = key.reshape(R, N, H, C)
    vf = value.reshape(R, N, H, C)
    maskf = None
    if mask is not None:
        maskf = torch.broadcast_to(mask, lead + (N,)).reshape(R, N)
    biasf = None
    if attn_bias is not None:
        biasf = torch.broadcast_to(attn_bias, lead + (H, N, N)).reshape(R, H, N, N)
    out = gated_attention_core(qf, kf, vf, maskf, biasf, scale)
    return out.reshape(lead + (N, H, C))


class GatedAttention(nn.Module):
    """Per-head gated MHA with optional additive bias (`layers.py:327-429`)
    over any leading dims; the input's second-to-last axis is the sequence."""

    def __init__(self, dim: int, head_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.head_dim, self.num_heads, self.dtype = head_dim, num_heads, dtype
        hc = head_dim * num_heads
        self.norm = LayerNorm(dim, dtype=dtype)
        self.q_proj = PRLinear(dim, hc, bias=False, init="glorot", dtype=dtype)
        self.k_proj = PRLinear(dim, hc, bias=False, init="glorot", dtype=dtype)
        self.v_proj = PRLinear(dim, hc, bias=False, init="glorot", dtype=dtype)
        self.gate_proj = PRLinear(dim, hc, init="gating", dtype=dtype)
        self.out_proj = PRLinear(hc, dim, init="final", dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        H, C = self.num_heads, self.head_dim
        x = self.norm(x)

        def heads(y: torch.Tensor) -> torch.Tensor:
            return y.reshape(y.shape[:-1] + (H, C))

        query, key, value = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        gate = torch.sigmoid(heads(self.gate_proj(x)))
        out = attention_core(
            query, key, value, mask, attn_bias, 1.0 / math.sqrt(C)
        ).to(self.dtype)
        out = gate * out
        return self.out_proj(out.reshape(out.shape[:-2] + (H * C,)))


class TransitionMLP(nn.Sequential):
    """LN -> expand -> ReLU -> contract with a 'final'-init output
    (`layers.py:432-473`); indices 1 and 3 carry the reference names."""

    def __init__(self, dim: int, hidden: int, out: int, out_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(
            LayerNorm(dim, dtype=dtype),
            PRLinear(dim, hidden, init="relu", dtype=dtype),
            nn.ReLU(),
            PRLinear(hidden, out, bias=out_bias, init="final", dtype=dtype),
        )
