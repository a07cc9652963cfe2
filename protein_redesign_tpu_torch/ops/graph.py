"""Graph-batching helpers (port of ``protein_redesign_tpu/ops/graph.py``;
reference `ProteinReDiff/models/utils.py`).

The reference carries these GVP-era utilities (flatten_graph /
unflatten_graph / rbf / norm) although nothing imports them; the port
keeps them so that it offers what the JAX package offers.
"""

from __future__ import annotations

from typing import Tuple

import torch


def norm(x: torch.Tensor, axis: int = -1, keepdims: bool = False,
         eps: float = 1e-8) -> torch.Tensor:
    """Safe L2 norm."""
    return torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=keepdims) + eps)


def rbf(d: torch.Tensor, d_min: float = 0.0, d_max: float = 20.0,
        d_count: int = 16) -> torch.Tensor:
    """Gaussian radial basis expansion of distances."""
    mu = torch.linspace(d_min, d_max, d_count, dtype=d.dtype, device=d.device)
    sigma = (d_max - d_min) / d_count
    return torch.exp(-torch.square((d[..., None] - mu) / sigma))


def flatten_graph(
    node_feats: torch.Tensor,  # [B, N, ...]
    node_mask: torch.Tensor,   # [B, N]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Concatenate a padded node batch into one flat graph: (flat_feats
    [B*N, ...], flat_mask [B*N], batch_index [B*N]); padded entries keep
    mask 0."""
    B, N = node_mask.shape
    flat_feats = node_feats.reshape((B * N,) + tuple(node_feats.shape[2:]))
    flat_mask = node_mask.reshape(B * N)
    batch_index = torch.repeat_interleave(torch.arange(B, device=node_mask.device), N)
    return flat_feats, flat_mask, batch_index


def unflatten_graph(flat_feats: torch.Tensor, batch_size: int) -> torch.Tensor:
    """Inverse of ``flatten_graph`` for statically padded graphs."""
    N = flat_feats.shape[0] // batch_size
    return flat_feats.reshape((batch_size, N) + tuple(flat_feats.shape[1:]))
