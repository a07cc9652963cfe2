"""Unit and geometry helpers (port of ``protein_redesign_tpu/ops/geometry.py``)."""

from __future__ import annotations

import torch


def angstrom_to_nanometre(pos: torch.Tensor) -> torch.Tensor:
    return 0.1 * pos


def nanometre_to_angstrom(x: torch.Tensor) -> torch.Tensor:
    return 10.0 * x


def remove_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Subtract the masked mean over the node axis: masked rows keep their
    value, valid rows are centred on the masked centroid."""
    m = mask[..., None]
    x_sum = torch.sum(m * x, dim=-2, keepdim=True)
    norm = torch.sum(m, dim=-2, keepdim=True)
    return x - m * x_sum / torch.clamp(norm, min=1e-12)
