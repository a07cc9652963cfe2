"""Tensor ops of the port: geometry helpers and attention with its kernels."""

from .geometry import (
    angstrom_to_nanometre,
    nanometre_to_angstrom,
    nearest_bin,
    pseudo_beta,
    remove_mean,
)
