"""Unit and geometry helpers (port of ``protein_redesign_tpu/ops/geometry.py``)."""

from __future__ import annotations

from typing import Tuple

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


def nearest_bin(x: torch.Tensor, bins: int, min_val: float, max_val: float) -> torch.Tensor:
    """Index of the nearest of ``bins`` bin centres spanning [min_val,
    max_val]; a tie takes the lower bin, as ``jnp.argmin`` does. The centres
    are ``torch.linspace``'s, which may differ from ``jnp.linspace``'s in
    the last bit, so only an ``x`` within an ulp of a midpoint can land in
    another bin than the JAX function's."""
    w = 0.5 * (max_val - min_val) / bins
    v = torch.linspace(min_val + w, max_val - w, bins, dtype=x.dtype, device=x.device)
    return torch.argmin(torch.abs(x[..., None] - v), dim=-1)


def pseudo_beta(residue_atom_pos: torch.Tensor,
                residue_atom_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Virtual C-beta position and mask from the N, CA and C atoms."""
    n_pos, ca_pos, c_pos = (residue_atom_pos[:, :, i] for i in range(3))
    b = ca_pos - n_pos
    c = c_pos - ca_pos
    a = torch.linalg.cross(b, c, dim=-1)
    pseudo_cb_pos = -0.58273431 * a + 0.56802827 * b - 0.54067466 * c + ca_pos
    n_mask, ca_mask, c_mask = (residue_atom_mask[:, :, i] for i in range(3))
    pseudo_cb_mask = n_mask * ca_mask * c_mask
    return pseudo_cb_pos, pseudo_cb_mask
