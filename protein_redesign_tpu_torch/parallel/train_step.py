"""Training machinery for one device (port of
``protein_redesign_tpu/parallel/train_step.py``):

- Adam with the reference's LinearLR warmup and an optional cosine decay
  (``make_optimizer``, ``lr_at``), and an optional clip by global norm that
  scales exactly as ``optax.clip_by_global_norm`` does;
- EMA after each optimizer step with torch_ema's ramp (``_ema_update``);
- gradient accumulation: the micro-batches' gradients are summed by
  ``backward`` and divided by their count, and ``grad_norm`` is taken on the
  averaged gradients before the clip.

The optimizer's learning rate is set before every update from the step
count, as optax's schedule reads its own count: the first update uses
``learning_rate / warmup_steps``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from protein_redesign_tpu.config import ModelConfig, TrainConfig

from ..models import prdiff
from ..models.prdiff import Batch, ProteinReDiffNet, TrainNoise

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8  # optax.scale_by_adam's defaults


@dataclasses.dataclass
class TrainState:
    net: ProteinReDiffNet
    ema: ProteinReDiffNet  # the EMA weights, in a copy of the net
    optimizer: torch.optim.Adam
    step: int = 0
    ema_updates: int = 0  # torch_ema's num_updates


def lr_at(step: int, cfg: ModelConfig, train_cfg: TrainConfig) -> float:
    """The learning rate of update ``step`` (0-based), as the optax schedule
    of `train_step.py:36-62` gives it: linear from lr / warmup to lr over
    warmup - 1 steps, then constant, or a cosine decay to lr * lr_min_ratio
    over ``lr_decay_steps`` when that is positive."""
    lr, warmup = cfg.learning_rate, cfg.warmup_steps
    ramp = max(warmup - 1, 1)
    if train_cfg.lr_decay_steps > 0 and step >= ramp:
        count = min(step - ramp, train_cfg.lr_decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / train_cfg.lr_decay_steps))
        return lr * ((1.0 - train_cfg.lr_min_ratio) * cosine + train_cfg.lr_min_ratio)
    init = lr / warmup
    frac = 1.0 - min(step, ramp) / ramp
    return (init - lr) * frac + lr


def make_optimizer(net: ProteinReDiffNet, cfg: ModelConfig) -> torch.optim.Adam:
    """Adam over every parameter; ``train_step`` sets its lr per update."""
    return torch.optim.Adam(net.parameters(), lr=cfg.learning_rate / cfg.warmup_steps,
                            betas=ADAM_BETAS, eps=ADAM_EPS)


def make_train_state(net: ProteinReDiffNet) -> TrainState:
    ema = copy.deepcopy(net).requires_grad_(False)
    return TrainState(net=net, ema=ema, optimizer=make_optimizer(net, net.cfg))


def ema_decay_at(decay: float, num_updates: int) -> float:
    """torch_ema's ramp min(decay, (1 + n) / (10 + n)), in f32 as JAX computes it."""
    n = np.float32(num_updates)
    return float(np.minimum(np.float32(decay), (np.float32(1.0) + n) / (np.float32(10.0) + n)))


@torch.no_grad()
def _ema_update(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor], decay: float,
                num_updates: int) -> None:
    """ema <- ema * d + params * (1 - d), in place (`train_step.py:82-91`)."""
    d = ema_decay_at(decay, num_updates)
    torch._foreach_mul_(list(ema), d)
    torch._foreach_add_(list(ema), list(params), alpha=1.0 - d)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """``optax.clip_by_global_norm``: unchanged when norm < max_norm, else
    g / norm * max_norm (no epsilon, unlike ``clip_grad_norm_``)."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def make_train_step(
    train_cfg: TrainConfig,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """The train step: ``step(state, micro_batches, noises=None,
    generator=None)`` over ``accumulate_grad_batches`` micro-batches,
    updating ``state`` in place; returns the averaged loss and the global
    norm of the averaged gradients as device scalars."""
    accum = train_cfg.accumulate_grad_batches

    def train_step(
        state: TrainState,
        micro_batches: Sequence[Batch],
        noises: Optional[Sequence[TrainNoise]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        if len(micro_batches) != accum:
            raise ValueError(f"{len(micro_batches)} micro-batches, accumulate_grad_batches={accum}")
        net, opt = state.net, state.optimizer
        opt.zero_grad(set_to_none=True)
        loss_sum = 0.0
        for i, batch in enumerate(micro_batches):
            noise = noises[i] if noises is not None else None
            loss, _ = prdiff.loss(net, batch, noise=noise, generator=generator)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        params = list(net.parameters())
        for p in params:  # an unused parameter still gets Adam's zero-gradient update
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads: List[torch.Tensor] = [p.grad for p in params]
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
            loss_sum = loss_sum / accum
        grad_norm = global_norm(grads)
        if train_cfg.gradient_clip_norm > 0:
            clip_by_global_norm_(grads, grad_norm, train_cfg.gradient_clip_norm)
        for group in opt.param_groups:
            group["lr"] = lr_at(state.step, net.cfg, train_cfg)
        opt.step()
        _ema_update(list(state.ema.parameters()), params, net.cfg.ema_decay, state.ema_updates)
        state.step += 1
        state.ema_updates += 1
        return {"loss": loss_sum, "grad_norm": grad_norm}

    return train_step


def make_eval_step() -> Callable[..., torch.Tensor]:
    """Validation under the EMA weights with fresh draws (`train_step.py:154-170`):
    the per-sample [B] losses, so padded rows can be left out."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch, noise: Optional[TrainNoise] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        loss, _ = prdiff.loss(state.ema, batch, reduction="none", noise=noise,
                              generator=generator)
        return loss

    return eval_step
