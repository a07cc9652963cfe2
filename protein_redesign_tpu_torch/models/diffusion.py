"""Beta schedules and the diffusion-schedule table (port of
``protein_redesign_tpu/models/diffusion.py``): computed in float64 with
numpy, stored as float32 tensors. The table holds the quantities the DDPM
step and the training loss read; the JAX table's others belong to the
samplers that are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def linear_beta_schedule(n_timestep: int, start: float = 0.0001, end: float = 0.02) -> np.ndarray:
    return np.linspace(start, end, n_timestep, dtype=np.float64)


def cosine_beta_schedule(n_timestep: int) -> np.ndarray:
    steps = n_timestep + 1
    x = np.linspace(0, n_timestep, steps, dtype=np.float64)
    alphas_cumprod = np.cos((x / steps) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def get_betas(n_timestep: int, schedule: str) -> np.ndarray:
    if schedule == "linear":
        return linear_beta_schedule(n_timestep)
    if schedule == "cosine":
        return cosine_beta_schedule(n_timestep)
    raise ValueError(f"Invalid schedule: {schedule}")


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The DDPM step's and the loss's schedule quantities as float32 tensors [T]."""

    alphas: torch.Tensor
    sqrt_alphas: torch.Tensor
    sqrt_betas: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor

    @staticmethod
    def create(num_steps: int, schedule: str = "linear",
               device: torch.device | str = "cpu") -> "DiffusionSchedule":
        betas = get_betas(num_steps, schedule)
        alphas = 1.0 - betas

        def f32(a: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

        return DiffusionSchedule(
            alphas=f32(alphas),
            sqrt_alphas=f32(np.sqrt(alphas)),
            sqrt_betas=f32(np.sqrt(betas)),
            sqrt_alphas_cumprod=f32(np.sqrt(np.cumprod(alphas))),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - np.cumprod(alphas))),
        )
