"""Beta schedules and the diffusion-schedule table (port of
``protein_redesign_tpu/models/diffusion.py``): computed in float64 with
numpy, stored as float32 tensors. The table holds the quantities the DDPM
and DDIM steps (the posterior coefficients: the ancestral sequence reverse)
and the training loss read.
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
    """The samplers' and the loss's schedule quantities as float32 tensors [T]."""

    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas: torch.Tensor
    sqrt_betas: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    posterior_variance: torch.Tensor

    @staticmethod
    def create(num_steps: int, schedule: str = "linear",
               device: torch.device | str = "cpu") -> "DiffusionSchedule":
        betas = get_betas(num_steps, schedule)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas)
        alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
        one_minus, one_minus_prev = 1.0 - alphas_cumprod, 1.0 - alphas_cumprod_prev

        def f32(a: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

        return DiffusionSchedule(
            alphas=f32(alphas),
            alphas_cumprod=f32(alphas_cumprod),
            sqrt_alphas=f32(np.sqrt(alphas)),
            sqrt_betas=f32(np.sqrt(betas)),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(one_minus)),
            posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / one_minus),
            posterior_mean_coef2=f32(one_minus_prev * np.sqrt(alphas) / one_minus),
            posterior_variance=f32(betas * one_minus_prev / one_minus),
        )
