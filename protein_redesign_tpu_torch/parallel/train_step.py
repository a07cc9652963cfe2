"""Training machinery (port of ``protein_redesign_tpu/parallel/train_step.py``):

- Adam with the reference's LinearLR warmup and an optional cosine decay
  (``make_optimizer``, ``lr_at``), and an optional clip by global norm that
  scales exactly as ``optax.clip_by_global_norm`` does;
- EMA after each optimizer step with torch_ema's ramp (``_ema_update``);
- gradient accumulation: the micro-batches' gradients are summed by
  ``backward`` and divided by their count, and ``grad_norm`` is taken on the
  averaged gradients before the clip;
- with ``self_cond``, one coin per micro-batch, drawn on the host from the
  step's seed (``prdiff.host_generator``) unless injected, so the Python
  branch between one pass and two costs no device sync.

The optimizer's learning rate is set before every update from the step
count, as optax's schedule reads its own count: the first update uses
``learning_rate / warmup_steps``.

Inside a ``torch.distributed`` process group the step is data-parallel,
as the JAX step is on a (data, 1) mesh: each rank's micro-batches are its
rows of the global ones (``parallel.mesh.RowShard``), its draws the global
batch's, and after the local backward passes one all-reduce averages the
gradients and the loss over the ranks. With the loss's KL and CE sums
already global, that average is the gradient of JAX's global loss; then
``grad_norm``, the clip, Adam and the EMA run alike on every rank, which
so holds the same parameters bit for bit (``mesh.assert_replicas_equal``).

On a (d, m) mesh (``mesh.on_mesh``) the m ranks of a model group run the
same rows and draws. Where the net is sharded (FSDP, ``parallel/fsdp.py``)
each shard's gradient arrives reduce-scattered over the model group from
the backward, is all-reduced over the data group, and the whole leaves'
gradients over every rank; both are divided by the d m ranks (the model
group's copies are equal, so its sum is m times one). ``grad_norm`` counts
each whole leaf once and each shard once (the shards' squares summed over
the model group); the clip, Adam and the EMA then run on the shards. A
``sequence_parallel`` net (whole parameters) takes the same world average:
the loss is replicated on the model group, and each rank's gradient is
that of its rows' share times m (the adjoint of the final gather sums the
group's equal cotangents).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig, TrainConfig
from ..models import prdiff
from ..models.prdiff import Batch, ProteinReDiffNet, TrainNoise
from . import fsdp, mesh

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
def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> int:
    """Sum ``tensors`` over ``group`` (the world by default) in place and
    divide them by the world size, through one f32 buffer and one
    all-reduce; returns the buffer's bytes."""
    if not tensors:
        return 0
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    flat = mesh.all_reduced(flat, group=group) / mesh.rank_and_world()[1]
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return flat.numel() * flat.element_size()


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
    norm of the averaged gradients as device scalars and, with
    ``self_cond``, the micro-batches' coins (``sc_coins``) and how many ran
    the first pass (``sc_passes``). Inside a process group ``noises`` are
    the global micro-batches' draws, and the metrics add ``grad_bytes`` and
    ``allreduce_seconds``: the all-reduced buffer and its host time."""
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
        self_cond = net.cfg.self_cond
        if self_cond:
            drawn = torch.rand(accum, generator=prdiff.host_generator(generator)).tolist()
        loss_sum, coins = 0.0, []
        data_parallel = mesh.distributed()
        for i, batch in enumerate(micro_batches):
            noise = noises[i] if noises is not None else TrainNoise()
            if self_cond and noise.sc_coin is None:
                noise = dataclasses.replace(noise, sc_coin=drawn[i])
            shard = mesh.RowShard.of(batch["residue_mask"]) if data_parallel else None
            loss, _ = prdiff.loss(net, batch, noise=noise, generator=generator, shard=shard)
            loss.backward()
            loss_sum = loss_sum + loss.detach()
            if self_cond:
                coins.append(float(noise.sc_coin))
        params = list(fsdp.restore_(net).parameters())
        for p in params:  # an unused parameter still gets Adam's zero-gradient update
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads: List[torch.Tensor] = [p.grad for p in params]
        if accum > 1:
            torch._foreach_div_(grads, float(accum))
            loss_sum = loss_sum / accum
        reduced = {}
        spec = fsdp.sharded(net)
        shards = [p.grad for n, p in net.named_parameters() if n in spec]
        whole = [p.grad for n, p in net.named_parameters() if n not in spec]
        axes = mesh.current_axes()
        if data_parallel:
            loss_sum = torch.as_tensor(loss_sum, dtype=torch.float32, device=grads[0].device)
            _synchronize(grads[0].device)
            began = time.perf_counter()
            reduced["grad_bytes"] = (all_reduce_mean_([*whole, loss_sum])
                                     + all_reduce_mean_(shards, axes.data_group if shards else None))
            _synchronize(grads[0].device)
            reduced["allreduce_seconds"] = time.perf_counter() - began
        if shards:
            shard_sq = sum(torch.sum(torch.square(g.float())) for g in shards)
            grad_norm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in whole)
                                   + mesh.all_reduced(shard_sq, group=axes.model_group))
        else:
            grad_norm = global_norm(grads)
        if train_cfg.gradient_clip_norm > 0:
            clip_by_global_norm_(grads, grad_norm, train_cfg.gradient_clip_norm)
        for group in opt.param_groups:
            group["lr"] = lr_at(state.step, net.cfg, train_cfg)
        opt.step()
        _ema_update(list(state.ema.parameters()), params, net.cfg.ema_decay, state.ema_updates)
        state.step += 1
        state.ema_updates += 1
        metrics = {"loss": loss_sum, "grad_norm": grad_norm, **reduced}
        if self_cond:
            metrics.update(sc_coins=coins, sc_passes=sum(c < 0.5 for c in coins))
        return metrics

    return train_step


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_eval_step() -> Callable[..., Tuple[torch.Tensor, Dict]]:
    """Validation under the EMA weights with fresh draws (`train_step.py:154-170`):
    the per-sample [B] losses, so padded rows can be left out, and the
    loss's metrics (with ``self_cond``, ``sc_pass``: the validation loss
    takes the self-conditioning coin as the training loss does)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch, noise: Optional[TrainNoise] = None,
                  generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Dict]:
        return prdiff.loss(state.ema, batch, reduction="none", noise=noise,
                           generator=generator)

    return eval_step
