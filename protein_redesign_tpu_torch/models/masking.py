"""Sequence masking (port of ``random_mask`` and ``spatial_mask`` in
``protein_redesign_tpu/models/masking.py:38,62``).

Random masking scores positions uniformly, ranks them, and masks where the
rank is below the count to mask, selected over the flattened batch. Spatial
masking masks the residues nearest the ligand centroid. The uniform draws
come from a ``torch.Generator`` or are injected, so a test can feed the
draws the JAX package made.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

_INF = 1e10


def _rank(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Dense rank (0 = smallest) along a dim."""
    order = torch.argsort(x, dim=dim, stable=True)
    return torch.argsort(order, dim=dim, stable=True)


def random_mask(
    residue_mask: torch.Tensor,  # [B, N]
    mask_fraction: Union[float, torch.Tensor],
    scores: Optional[torch.Tensor] = None,  # [B * N] uniform in [0, 1)
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero a random ``mask_fraction`` of valid residues. Returns
    (residue_extra_mask, residue_inv_extra_mask)."""
    B, N = residue_mask.shape
    valid = residue_mask > 0.5
    num_valid = valid.sum().to(torch.float32)
    # f32 product, as the JAX version computes it
    fraction = torch.as_tensor(mask_fraction, dtype=torch.float32, device=residue_mask.device)
    num_to_mask = torch.floor(num_valid * fraction)
    if scores is None:
        scores = torch.rand(B * N, generator=generator, device=residue_mask.device)
    scores = torch.where(valid.reshape(-1), scores.to(residue_mask.device), _INF)
    ranks = _rank(scores)
    selected = (ranks < num_to_mask).reshape(B, N) & valid
    extra_mask = residue_mask * (1.0 - selected.to(residue_mask.dtype))
    inv_mask = selected.to(residue_mask.dtype)
    return extra_mask, inv_mask


def spatial_mask(
    residue_ca_pos: torch.Tensor,  # [B, N, 3]
    residue_mask: torch.Tensor,    # [B, N]
    atom_pos: torch.Tensor,        # [B, N, 3]
    atom_mask: torch.Tensor,       # [B, N]
    max_p: torch.Tensor,           # scalar
    frac_u: Optional[torch.Tensor] = None,  # scalar uniform in [0, 1)
    generator: Optional[torch.Generator] = None,
    median_of: Optional[torch.Tensor] = None,  # [B', N]: the batch whose median counts
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask the k residues nearest the ligand centroid in each sample, with
    k = floor(U(0, 1) * max_p * median(residues per sample)); the median is
    over ``median_of``'s samples where given (a data-parallel rank's global
    batch), else over ``residue_mask``'s. Returns
    (residue_extra_mask, residue_inv_extra_mask)."""
    n_res = (residue_mask if median_of is None else median_of).sum(-1)
    n_median = torch.quantile(n_res, 0.5)  # the mean of the middle two, as jnp.median
    if frac_u is None:
        frac_u = torch.rand((), generator=generator, device=residue_mask.device)
    frac = frac_u.to(residue_mask.device) * max_p
    top_k = torch.floor(frac * n_median)
    centroid = (atom_mask[..., None] * atom_pos).sum(-2) / torch.clamp(
        atom_mask.sum(-1, keepdim=True), min=1e-12
    )  # [B, 3]
    d = torch.sqrt(torch.square(centroid[:, None, :] - residue_ca_pos).sum(-1) + 1e-12)
    d = d + (1.0 - residue_mask) * _INF
    selected = (_rank(d) < top_k) & (residue_mask > 0.5)
    extra_mask = residue_mask * (1.0 - selected.to(residue_mask.dtype))
    inv_mask = selected.to(residue_mask.dtype)
    return extra_mask, inv_mask
