"""ProteinReDiff network, batch preparation, the training loss and the DDPM
and DDIM samplers (port of ``protein_redesign_tpu/models/prdiff.py``).

Each sampler is a Python loop over timesteps. Every random draw comes from a
``torch.Generator`` or is injected, through ``SamplerNoise`` for the samplers
(mask scores, initial coordinates and sequence, each step's noise) and
``TrainNoise`` for the loss (masking policy and fractions, mask scores,
timesteps, noise), so a test can feed the port exactly what the JAX package
drew. The loss keeps the reference's quirky reductions
(`tests/test_loss_semantics.py`): KL and CE summed to scalars and broadcast
onto every sample, and (seq_pred + 1) / 2 fed to the CE as logits.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops.geometry import angstrom_to_nanometre, nanometre_to_angstrom, remove_mean
from .denoiser import Denoiser
from .diffusion import DiffusionSchedule
from .layers import (
    AtomEmbedding,
    BondEmbedding,
    Embed,
    LayerNorm,
    PRLinear,
    RadialBasisProjection,
    SinusoidalProjection,
    TransitionMLP,
)
from .masking import random_mask, spatial_mask

Batch = Dict[str, torch.Tensor]
NUM_CLASSES = 21  # 20 residue types + pad/mask class 0


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for config fields outside the ported
    slice (DDPM and DDIM generation and training with the Gaussian sequence
    channel)."""
    unsupported = [
        (cfg.self_cond, "self_cond: self-conditioning is not ported yet"),
        (cfg.seq_process != "gaussian",
         f"seq_process={cfg.seq_process!r}: only 'gaussian' is ported"),
        (cfg.seq_reverse != "reference",
         f"seq_reverse={cfg.seq_reverse!r}: only 'reference' is ported"),
        (cfg.attn_chunk > 0, "attn_chunk>0: query-chunked attention is not ported yet"),
        (cfg.sequence_parallel, "sequence_parallel: not ported yet"),
        (cfg.param_dtype != "float32", f"param_dtype={cfg.param_dtype!r}: only float32"),
        (cfg.dtype not in ("float32", "bfloat16"),
         f"dtype={cfg.dtype!r}: only float32 and bfloat16"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(f"ModelConfig.{what}")


class NormLinear(nn.Sequential):
    """Non-affine LN -> bias-free 'normal' Linear [-> ReLU] (`prdiff.py:54-70`)."""

    def __init__(self, dim: int, features: int, relu: bool = False,
                 dtype: torch.dtype = torch.float32):
        layers = [LayerNorm(dim, dtype=dtype),
                  PRLinear(dim, features, bias=False, init="normal", dtype=dtype)]
        if relu:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class ProjLinear(nn.Sequential):
    """Fixed RBF or sinusoidal projection -> bias-free 'normal' Linear
    (`prdiff.py:73-92`); index 0 holds the constant buffer."""

    def __init__(self, features: int, proj: str, proj_dim: int,
                 dtype: torch.dtype = torch.float32):
        if proj == "rbf":
            projection = RadialBasisProjection(proj_dim, dtype=dtype)
        else:
            projection = SinusoidalProjection(proj_dim, dtype=dtype)
        super().__init__(
            projection, PRLinear(proj_dim, features, bias=False, init="normal", dtype=dtype)
        )


class ProteinReDiffNet(nn.Module):
    """Embeddings + Denoiser + equivariant readout + sequence head
    (`prdiff.py:95-219`)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype = self.dtype = getattr(torch, cfg.dtype)
        S, P = cfg.single_dim, cfg.pair_dim
        self.embed_atom_feats = AtomEmbedding(S, dtype)
        self.embed_residue_type = NormLinear(NUM_CLASSES, S, relu=True, dtype=dtype)
        self.embed_residue_esm = NormLinear(cfg.esm_dim, S, dtype=dtype)
        self.embed_bond_feats = BondEmbedding(P, dtype)
        self.embed_bond_distance = Embed(cfg.max_bond_distance + 1, P, dtype)
        self.embed_relpos = Embed(cfg.max_relpos * 2 + 1, P, dtype)
        self.embed_dist = ProjLinear(P, "rbf", cfg.dist_dim, dtype)
        self.embed_beta = ProjLinear(P, "sinusoidal", cfg.time_dim, dtype)
        self.Denoiser = Denoiser(cfg)
        self.weight_radial = TransitionMLP(P, P, 1, out_bias=False, dtype=dtype)
        self.seq_mlp = TransitionMLP(S, S, NUM_CLASSES, out_bias=False, dtype=dtype)

    def forward(
        self,
        batch: Batch,
        z: torch.Tensor,      # [B, N, 3] noisy coords (nm), f32
        seq_t: torch.Tensor,  # [B, N, 21] noisy one-hot
        mask: torch.Tensor,   # [B, N] residue+atom mask
        t: torch.Tensor,      # [B] int timestep
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, dtype = self.cfg, self.dtype
        atom_mask = batch["atom_mask"]
        residue_mask = batch["residue_mask"]
        chain = batch["residue_chain_index"]
        residue_index = batch["residue_index"]

        atom_mask_2d = atom_mask[..., :, None] * atom_mask[..., None, :]
        residue_mask_2d = residue_mask[..., :, None] * residue_mask[..., None, :]
        relpos = residue_index[..., :, None] - residue_index[..., None, :]
        chain_mask = (chain[..., :, None] == chain[..., None, :]).to(dtype)
        mask_2d = mask[..., :, None] * mask[..., None, :]

        # Geometry in f32 whatever the compute dtype.
        zf = z.float()
        zi_zj = zf[..., :, None, :] - zf[..., None, :, :]
        noise_dist = torch.linalg.vector_norm(zi_zj + 1e-20, dim=-1)
        scaled_t = (t / cfg.num_steps).float()

        single = atom_mask[..., None].to(dtype) * self.embed_atom_feats(batch["atom_feats"])
        single = single + residue_mask[..., None].to(dtype) * (
            self.embed_residue_type(seq_t.to(dtype))
            + self.embed_residue_esm(batch["residue_esm"].to(dtype))
        )

        bond_distance = torch.clamp(batch["bond_distance"], max=cfg.max_bond_distance)
        pair = atom_mask_2d[..., None].to(dtype) * (
            batch["bond_mask"][..., None].to(dtype) * self.embed_bond_feats(batch["bond_feats"])
            + self.embed_bond_distance(bond_distance)
        )
        relpos = cfg.max_relpos + torch.clamp(relpos, -cfg.max_relpos, cfg.max_relpos)
        pair = pair + residue_mask_2d[..., None].to(dtype) * (
            chain_mask[..., None] * self.embed_relpos(relpos)
        )
        pair = pair + mask_2d[..., None].to(dtype) * (
            self.embed_dist(noise_dist.to(dtype))
            + self.embed_beta(scaled_t[:, None, None])
        )

        single, pair = self.Denoiser(single, pair, mask)

        # Equivariant vector readout.
        w = self.weight_radial(pair).float()
        r = zi_zj * torch.rsqrt(torch.sum(torch.square(zi_zj), dim=-1, keepdim=True) + 1e-4)
        noise_pred = torch.sum(mask_2d[..., None].float() * w * r, dim=-2)
        noise_pred = remove_mean(noise_pred, mask)

        seq_pred = self.seq_mlp(single).float()
        return noise_pred, seq_pred


@dataclasses.dataclass
class TrainNoise:
    """Draws the training loss would otherwise take from its generator, as
    the JAX package draws them (`prdiff.py:371-394, 438-462, 633-636`)."""

    rt: Optional[torch.Tensor] = None           # scalar U(0, 1): masking policy
    p: Optional[torch.Tensor] = None            # scalar U(0.1, mask_prob): fraction bound
    rand_u: Optional[torch.Tensor] = None       # scalar U(0, 1): random fraction is rand_u * p
    rand_scores: Optional[torch.Tensor] = None  # [B * N] U(0, 1): random-mask scores
    spatial_u: Optional[torch.Tensor] = None    # scalar U(0, 1): spatial fraction is spatial_u * p
    t: Optional[torch.Tensor] = None            # [B] timesteps in [0, num_steps)
    noise_z: Optional[torch.Tensor] = None      # [B, N, 3] N(0, 1), before mean removal
    noise_seq: Optional[torch.Tensor] = None    # [B, N, 21] N(0, 1), before mean removal


def _uniform(value: Optional[torch.Tensor], like: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    if value is not None:
        return value.to(like.device, torch.float32)
    return torch.rand((), generator=generator, device=like.device)


def _training_masks(batch: Batch, mask_prob: float, noise: TrainNoise,
                    generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training masking policy (`prdiff.py:371-394`): random masking of
    a U(0, 1) * p fraction when rt < 0.3, spatial masking around the ligand
    when 0.3 <= rt < 0.5, else none; p ~ U(0.1, mask_prob)."""
    residue_mask = batch["residue_mask"]
    rt = _uniform(noise.rt, residue_mask, generator)
    if noise.p is not None:
        p = noise.p.to(residue_mask.device, torch.float32)
    else:
        p = 0.1 + _uniform(None, residue_mask, generator) * (mask_prob - 0.1)
    p_rand = _uniform(noise.rand_u, residue_mask, generator) * p
    rand_extra, rand_inv = random_mask(residue_mask, p_rand, noise.rand_scores, generator)
    spat_extra, spat_inv = spatial_mask(
        batch["residue_atom_pos"][:, :, 1], residue_mask, batch["atom_pos"], batch["atom_mask"],
        p, noise.spatial_u, generator,
    )
    use_rand, use_spatial = rt < 0.3, (rt >= 0.3) & (rt < 0.5)
    extra_mask = torch.where(use_rand, rand_extra,
                             torch.where(use_spatial, spat_extra, residue_mask))
    inv_mask = torch.where(use_rand, rand_inv,
                           torch.where(use_spatial, spat_inv, torch.zeros_like(residue_mask)))
    return extra_mask, inv_mask


def prepare_batch(
    batch: Batch,
    mask_prob: float,
    mask_scores: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    training: bool = False,
    train_noise: Optional[TrainNoise] = None,
) -> Batch:
    """`prdiff.py:334-411`: ±1 one-hot, merged nm coordinates and the
    sequence masking: the training policy draw, or (inference) a fixed
    ``mask_prob`` fraction of the residues."""
    batch = dict(batch)
    atom_pos = batch["atom_pos"]
    atom_mask = batch["atom_mask"]
    residue_ca_pos = batch["residue_atom_pos"][:, :, 1]
    residue_mask = batch["residue_mask"]
    residue_type = batch["residue_type"]

    one_hot = F.one_hot(residue_type.long(), NUM_CLASSES).float() * 2.0 - 1.0
    pos = atom_mask[..., None] * atom_pos + residue_mask[..., None] * residue_ca_pos
    if training:
        extra_mask, inv_mask = _training_masks(batch, mask_prob, train_noise or TrainNoise(),
                                               generator)
    else:
        extra_mask, inv_mask = random_mask(residue_mask, mask_prob, mask_scores, generator)

    batch["residue_esm"] = batch["residue_esm"] * extra_mask[..., None]
    batch["residue_type_masked"] = residue_type * extra_mask.to(residue_type.dtype)
    batch["residue_one_hot"] = one_hot * extra_mask[..., None]
    batch["residue_extra_mask"] = extra_mask
    batch["residue_inv_extra_mask"] = inv_mask
    batch["x"] = angstrom_to_nanometre(pos)
    batch["residue_and_atom_mask"] = atom_mask + residue_mask
    return batch


@functools.lru_cache(maxsize=8)
def schedule_on(num_steps: int, schedule: str, device: str) -> DiffusionSchedule:
    """The schedule table on a device, built once per (steps, kind, device)."""
    return DiffusionSchedule.create(num_steps, schedule, device=device)


def q_sample(
    sched: DiffusionSchedule,
    x: torch.Tensor,
    seq: torch.Tensor,
    t: torch.Tensor,
    noise_z: torch.Tensor,
    noise_seq: torch.Tensor,
    batch: Batch,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward noising with known-residue clamping (``q``, `prdiff.py:414-436`)."""
    extra = batch["residue_extra_mask"][..., None]
    inv = batch["residue_inv_extra_mask"][..., None]
    sac = sched.sqrt_alphas_cumprod[t][:, None, None]
    s1mac = sched.sqrt_one_minus_alphas_cumprod[t][:, None, None]
    z_t = sac * x + s1mac * noise_z
    seq_t = sac * seq + s1mac * noise_seq
    seq_t = extra * seq + inv * seq_t
    t1 = torch.clamp(t - 1, min=0)
    sac1 = sched.sqrt_alphas_cumprod[t1][:, None, None]
    s1mac1 = sched.sqrt_one_minus_alphas_cumprod[t1][:, None, None]
    seq_t1 = sac1 * seq + s1mac1 * noise_seq
    return z_t, seq_t, seq_t1, t1


def _label_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -torch.gather(F.log_softmax(logits, dim=-1), -1, labels[..., None])[..., 0]


def diffusion_loss(
    net: ProteinReDiffNet,
    sched: DiffusionSchedule,
    batch: Batch,
    x: torch.Tensor,
    mask: torch.Tensor,
    t: torch.Tensor,
    noise_z: torch.Tensor,
    noise_seq: torch.Tensor,
) -> torch.Tensor:
    """Per-sample loss [B] (`prdiff.py:438-524`, Gaussian sequence channel):
    masked coordinate MSE per sample plus, in ``loss_mode="reference"``, KL
    and CE summed to scalars and broadcast onto every sample; in
    ``"per_position"``, per-sample self-normalized terms. ``noise_z`` and
    ``noise_seq`` are raw standard normals."""
    seq = batch["residue_one_hot"]
    residue_mask = batch["residue_mask"]
    noise_z = remove_mean(noise_z, mask)
    noise_seq = remove_mean(noise_seq, residue_mask)
    z_t, seq_t, seq_t1, t1 = q_sample(sched, x, seq, t, noise_z, noise_seq, batch)
    noise_pred, seq_pred = net(batch, z_t, seq_t, mask, t)
    sac1 = sched.sqrt_alphas_cumprod[t1][:, None, None]
    s1mac1 = sched.sqrt_one_minus_alphas_cumprod[t1][:, None, None]
    seq_pred_t1 = sac1 * seq_pred + s1mac1 * noise_seq

    mse = torch.sum(mask[..., None] * torch.square(noise_pred - noise_z), dim=(-1, -2))
    rm = residue_mask[..., None]
    log_p = F.log_softmax(seq_pred_t1, dim=-1) * rm
    q_tgt = torch.softmax(seq_t1, dim=-1) * rm
    # F.kl_div(input, target) = target * (log(target) - input), 0 log 0 := 0
    kl = torch.where(
        q_tgt > 0, q_tgt * (torch.log(torch.where(q_tgt > 0, q_tgt, 1.0)) - log_p),
        -q_tgt * log_p,
    )
    labels = batch["residue_type"].long()

    if net.cfg.loss_mode == "per_position":
        num_nodes = torch.clamp(torch.sum(mask > 0.5, dim=-1), min=1)
        num_res = torch.clamp(torch.sum(residue_mask, dim=-1), min=1.0)
        sel = batch["residue_inv_extra_mask"] * (labels != 0)
        ce = torch.sum(_label_nll(seq_pred, labels) * sel, dim=-1) / torch.clamp(
            torch.sum(sel, dim=-1), min=1.0
        )
        return mse / num_nodes + torch.sum(kl, dim=(-1, -2)) / num_res + ce

    nll = _label_nll((seq_pred + 1.0) / 2.0, labels)
    nll = torch.where(labels == 0, 0.0, nll) * mask
    return mse + torch.sum(kl) + torch.sum(nll)


def loss(
    net: ProteinReDiffNet,
    batch: Batch,
    reduction: str = "mean",
    noise: Optional[TrainNoise] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Scalar training/validation loss (`prdiff.py:589-646`), with the
    training masking policy as both the JAX train and eval steps take it;
    ``reduction="none"`` returns the per-sample [B] vector instead of its
    mean (validation weights only a padded batch's real rows)."""
    cfg = net.cfg
    if cfg.loss_mode not in ("reference", "per_position"):
        raise ValueError(f"loss_mode must be 'reference' or 'per_position', got {cfg.loss_mode!r}")
    noise = noise or TrainNoise()
    batch = prepare_batch(batch, cfg.mask_prob, generator=generator, training=True,
                          train_noise=noise)
    x = batch["x"]
    mask = batch["residue_and_atom_mask"]
    B = x.shape[0]
    sched = schedule_on(cfg.num_steps, cfg.diffusion_schedule, str(x.device))
    t = noise.t
    if t is None:
        t = torch.randint(0, cfg.num_steps, (B,), generator=generator, device=x.device)
    noise_z = noise.noise_z
    if noise_z is None:
        noise_z = _normal(x.shape, x, generator)
    noise_seq = noise.noise_seq
    if noise_seq is None:
        noise_seq = _normal(batch["residue_one_hot"].shape, x, generator)
    per_sample = diffusion_loss(net, sched, batch, x, mask, t.to(x.device).long(),
                                noise_z.to(x), noise_seq.to(x))
    if cfg.loss_mode == "reference":
        per_sample = per_sample / torch.sum(mask > 0.5, dim=-1)
    mean = per_sample.mean()
    if reduction == "none":
        return per_sample, {"loss": mean}
    return mean, {"loss": mean}


@dataclasses.dataclass
class SamplerNoise:
    """Draws a sampler would otherwise take from its generator: raw
    uniforms and standard normals, before any masking or mean removal."""

    mask_scores: Optional[torch.Tensor] = None  # [B * N]
    z0: Optional[torch.Tensor] = None           # [B, N, 3]
    s0: Optional[torch.Tensor] = None           # [B, N, 21]
    steps: Optional[torch.Tensor] = None        # [T, B, N, 3] in loop order (DDIM: [S, ...])


Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _normal(shape, like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


def sample_init(
    batch: Batch,
    mask_prob: float,
    generator: Optional[torch.Generator] = None,
    noise: Optional[SamplerNoise] = None,
) -> Tuple[Batch, Carry]:
    """prepare_batch + the initial (z, seq_t, seq_pred) carry (`prdiff.py:699-748`)."""
    noise = noise or SamplerNoise()
    batch = prepare_batch(batch, mask_prob, noise.mask_scores, generator)
    x = batch["x"]
    mask = batch["residue_and_atom_mask"]
    seq = batch["residue_one_hot"]
    z0 = noise.z0 if noise.z0 is not None else _normal(x.shape, x, generator)
    z0 = remove_mean(z0.to(x), mask)
    s0 = noise.s0 if noise.s0 is not None else _normal(seq.shape, seq, generator)
    s0 = remove_mean(s0.to(seq), batch["residue_mask"])
    extra = batch["residue_extra_mask"][..., None]
    inv = batch["residue_inv_extra_mask"][..., None]
    s0 = extra * seq + inv * s0
    return batch, (z0, s0, torch.zeros_like(s0))


def guard(x: torch.Tensor, enabled: bool = True) -> torch.Tensor:
    """Sampler state sanitiser (`prdiff.py:785-814`): non-finite entries
    become 0 / ±1e4 and magnitudes are clamped to 1e4; the identity on
    healthy state."""
    if not enabled:
        return x
    bound = 1e4
    return torch.clamp(torch.nan_to_num(x, nan=0.0, posinf=bound, neginf=-bound), -bound, bound)


def gaussian_step(
    net: ProteinReDiffNet,
    sched: DiffusionSchedule,
    batch: Batch,
    carry: Carry,
    t_scalar: int,
    step_noise: torch.Tensor,
) -> Carry:
    """One reference DDPM step (`prdiff.py:816-876`, seq_reverse='reference');
    ``step_noise`` is the raw standard normal for the coordinates."""
    z_t, seq_t, _ = carry
    x = batch["x"]
    mask = batch["residue_and_atom_mask"]
    B = x.shape[0]
    t = torch.full((B,), t_scalar, dtype=torch.long, device=x.device)
    w_noise = (1.0 - sched.alphas[t]) / sched.sqrt_one_minus_alphas_cumprod[t]
    noise_pred, seq_pred = net(batch, z_t, seq_t, mask, t)
    mean = (1.0 / sched.sqrt_alphas[t])[:, None, None] * (
        z_t - w_noise[:, None, None] * noise_pred
    )
    seq_next = torch.softmax(seq_pred, dim=-1) * 2.0 - 1.0
    if t_scalar == 0:
        z_next = mean
    else:
        noise = remove_mean(step_noise.to(x), mask)
        z_next = mean + sched.sqrt_betas[t][:, None, None] * noise
    enabled = net.cfg.sample_guard
    return guard(z_next, enabled), guard(seq_next, enabled), seq_pred


def sample_finish(batch: Batch, carry: Carry) -> Tuple[torch.Tensor, torch.Tensor]:
    """Carry -> (positions [B, N, 3] in Å, residue-masked sequence logits)."""
    z_final, _seq_t, seq_pred_last = carry
    return (
        nanometre_to_angstrom(z_final),
        batch["residue_mask"][..., None] * seq_pred_last,
    )


StepHook = Optional[Callable[[int, Carry], None]]


def _sampler_loop(net: ProteinReDiffNet, batch: Batch, mask_prob: Optional[float],
                  generator: Optional[torch.Generator], noise: Optional[SamplerNoise],
                  num_steps: int, step: Callable[[Batch, Carry, int, torch.Tensor], Carry],
                  on_step: StepHook) -> Tuple[torch.Tensor, torch.Tensor]:
    """sample_init, ``num_steps`` calls of ``step(batch, carry, i, noise_i)``
    with each step's raw normal drawn (or injected) before it, and
    sample_finish. ``on_step(i, carry)`` sees the carry after step i; it
    changes nothing of the sample."""
    mask_prob = net.cfg.mask_prob if mask_prob is None else mask_prob
    batch, carry = sample_init(batch, mask_prob, generator, noise)
    x = batch["x"]
    for i in range(num_steps):
        if noise is not None and noise.steps is not None:
            step_noise = noise.steps[i]
        else:
            step_noise = _normal(x.shape, x, generator)
        carry = step(batch, carry, i, step_noise)
        if on_step is not None:
            on_step(i, carry)
    return sample_finish(batch, carry)


@torch.inference_mode()
def sample(
    net: ProteinReDiffNet,
    batch: Batch,
    mask_prob: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[SamplerNoise] = None,
    on_step: StepHook = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DDPM ancestral sampler (`prdiff.py:669-687`) as a loop over
    t = T-1 .. 0. Returns (positions in Å, residue-masked seq logits)."""
    cfg = net.cfg
    sched = schedule_on(cfg.num_steps, cfg.diffusion_schedule, str(batch["residue_mask"].device))
    T = cfg.num_steps

    def step(b, carry, i, step_noise):
        return gaussian_step(net, sched, b, carry, T - 1 - i, step_noise)

    return _sampler_loop(net, batch, mask_prob, generator, noise, T, step, on_step)


def ddim_taus(num_steps: int, ddim_steps: int) -> np.ndarray:
    """The descending DDIM timestep subsequence tau_0 > ... > tau_{S-1} = 0,
    computed in f64 numpy as the JAX package does (``ddim_taus_np``,
    `prdiff.py:222-232`), int32."""
    return np.round(np.linspace(num_steps - 1, 0, ddim_steps)).astype(np.int32)


def ddim_tau_grid(num_steps: int, ddim_steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """The tau grid and its shifted companion, -1 at the end for the x0
    endpoint (alpha_bar_prev 1) (`prdiff.py:235-243`)."""
    taus = ddim_taus(num_steps, ddim_steps)
    return taus, np.concatenate([taus[1:], np.array([-1], np.int32)])


def ddim_coord_update(z_t: torch.Tensor, noise_pred: torch.Tensor, mask: torch.Tensor,
                      a_t: torch.Tensor, a_prev: torch.Tensor, eta: float,
                      step_noise: torch.Tensor) -> torch.Tensor:
    """One DDIM coordinate update (Song et al. 2021 eq. 12;
    ``_ddim_coord_update``, `prdiff.py:1136-1168`); ``step_noise`` is the
    raw standard normal."""
    x0_pred = remove_mean((z_t - torch.sqrt(1.0 - a_t) * noise_pred) / torch.sqrt(a_t), mask)
    # max(., 0): with a repeated tau (ddim_steps > T) a_t / a_prev can round
    # to just above 1 and the bare sqrt gives NaN even at eta = 0
    sigma = (eta * torch.sqrt((1.0 - a_prev) / (1.0 - a_t))
             * torch.sqrt(torch.clamp(1.0 - a_t / a_prev, min=0.0)))
    dir_coeff = torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0))
    noise = remove_mean(step_noise.to(z_t), mask)
    return torch.sqrt(a_prev) * x0_pred + dir_coeff * noise_pred + sigma * noise


def ddim_step(
    net: ProteinReDiffNet,
    sched: DiffusionSchedule,
    batch: Batch,
    carry: Carry,
    tau: int,
    tau_prev: int,
    eta: float,
    step_noise: torch.Tensor,
) -> Carry:
    """One DDIM step with the reference sequence recurrence
    (``_ddim_gaussian_step_fn``, `prdiff.py:1082-1134`, seq_reverse='reference')."""
    z_t, seq_t, _ = carry
    x = batch["x"]
    mask = batch["residue_and_atom_mask"]
    t = torch.full((x.shape[0],), tau, dtype=torch.long, device=x.device)
    noise_pred, seq_pred = net(batch, z_t, seq_t, mask, t)
    a_t = sched.alphas_cumprod[tau]
    a_prev = sched.alphas_cumprod[tau_prev] if tau_prev >= 0 else torch.ones_like(a_t)
    z_next = ddim_coord_update(z_t, noise_pred, mask, a_t, a_prev, eta, step_noise)
    seq_next = torch.softmax(seq_pred, dim=-1) * 2.0 - 1.0
    enabled = net.cfg.sample_guard
    return guard(z_next, enabled), guard(seq_next, enabled), seq_pred


@torch.inference_mode()
def sample_ddim(
    net: ProteinReDiffNet,
    batch: Batch,
    ddim_steps: int = 50,
    eta: float = 0.0,
    mask_prob: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[SamplerNoise] = None,
    on_step: StepHook = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DDIM sampler over a ``ddim_steps``-long subsequence of the trained
    schedule (``sample_ddim``, `prdiff.py:1024-1055`): the DDPM sampler's
    initialisation and readout, one step per tau. ``noise.steps`` holds
    one raw normal per tau (drawn at eta 0 too, as the JAX sampler does)."""
    cfg = net.cfg
    sched = schedule_on(cfg.num_steps, cfg.diffusion_schedule, str(batch["residue_mask"].device))
    taus, taus_prev = ddim_tau_grid(cfg.num_steps, ddim_steps)

    def step(b, carry, i, step_noise):
        return ddim_step(net, sched, b, carry, int(taus[i]), int(taus_prev[i]), eta, step_noise)

    return _sampler_loop(net, batch, mask_prob, generator, noise, ddim_steps, step, on_step)
