"""Tensor ops of the port: geometry helpers and attention with its kernels."""
