"""Inference sequence masking (port of ``random_mask`` in
``protein_redesign_tpu/models/masking.py:38``).

Positions are scored uniformly, ranked, and masked where the rank is below
the count to mask, selected over the flattened batch. The scores come from a
``torch.Generator`` or are injected, so a test can feed the draws the JAX
sampler made.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_INF = 1e10


def _rank(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Dense rank (0 = smallest) along a dim."""
    order = torch.argsort(x, dim=dim, stable=True)
    return torch.argsort(order, dim=dim, stable=True)


def random_mask(
    residue_mask: torch.Tensor,  # [B, N]
    mask_fraction: float,
    scores: Optional[torch.Tensor] = None,  # [B * N] uniform in [0, 1)
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero a random ``mask_fraction`` of valid residues. Returns
    (residue_extra_mask, residue_inv_extra_mask)."""
    B, N = residue_mask.shape
    valid = residue_mask > 0.5
    num_valid = valid.sum().to(torch.float32)
    # f32 product, as the JAX version computes it
    num_to_mask = torch.floor(num_valid * torch.tensor(mask_fraction, dtype=torch.float32))
    if scores is None:
        scores = torch.rand(B * N, generator=generator, device=residue_mask.device)
    scores = torch.where(valid.reshape(-1), scores.to(residue_mask.device), _INF)
    ranks = _rank(scores)
    selected = (ranks < num_to_mask.to(residue_mask.device)).reshape(B, N) & valid
    extra_mask = residue_mask * (1.0 - selected.to(residue_mask.dtype))
    inv_mask = selected.to(residue_mask.dtype)
    return extra_mask, inv_mask
