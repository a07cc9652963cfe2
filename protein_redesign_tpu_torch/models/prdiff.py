"""ProteinReDiff network, inference batch preparation and the DDPM sampler
(port of ``protein_redesign_tpu/models/prdiff.py``).

The sampler is a Python loop over timesteps. Every random draw (mask
scores, initial coordinates and sequence, each step's noise) comes from a
``torch.Generator`` or is injected through ``SamplerNoise``, so a test can
feed the port exactly what the JAX sampler drew.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from protein_redesign_tpu.config import ModelConfig

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
from .masking import random_mask

Batch = Dict[str, torch.Tensor]
NUM_CLASSES = 21  # 20 residue types + pad/mask class 0


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for config fields outside the ported
    slice (DDPM generation with the Gaussian sequence channel)."""
    unsupported = [
        (cfg.training_mode, "training_mode: training is not ported yet"),
        (cfg.self_cond, "self_cond: self-conditioning is not ported yet"),
        (cfg.seq_process != "gaussian",
         f"seq_process={cfg.seq_process!r}: only 'gaussian' is ported"),
        (cfg.seq_reverse != "reference",
         f"seq_reverse={cfg.seq_reverse!r}: only 'reference' is ported"),
        (cfg.fast_softmax, "fast_softmax: the bf16-softmax kernel variant is not ported yet"),
        (cfg.attn_chunk > 0, "attn_chunk>0: query-chunked attention is not ported yet"),
        (cfg.sequence_parallel, "sequence_parallel: not ported yet"),
        (cfg.use_pallas_trimul, "use_pallas_trimul: the fused triangle kernel is not ported yet"),
        (cfg.use_pallas_transition,
         "use_pallas_transition: the fused transition kernel is not ported yet"),
        (cfg.use_pallas_outer, "use_pallas_outer: the fused OuterLinear kernel is not ported yet"),
        (cfg.use_pallas_fused_gated,
         "use_pallas_fused_gated: the fused gated-attention kernel is not ported yet"),
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


def prepare_batch(
    batch: Batch,
    mask_prob: float,
    mask_scores: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Batch:
    """Inference branch of `prdiff.py:334-411`: ±1 one-hot, merged nm
    coordinates and the random masking of ``mask_prob`` of the residues."""
    batch = dict(batch)
    atom_pos = batch["atom_pos"]
    atom_mask = batch["atom_mask"]
    residue_ca_pos = batch["residue_atom_pos"][:, :, 1]
    residue_mask = batch["residue_mask"]
    residue_type = batch["residue_type"]

    one_hot = F.one_hot(residue_type.long(), NUM_CLASSES).float() * 2.0 - 1.0
    pos = atom_mask[..., None] * atom_pos + residue_mask[..., None] * residue_ca_pos
    extra_mask, inv_mask = random_mask(residue_mask, mask_prob, mask_scores, generator)

    batch["residue_esm"] = batch["residue_esm"] * extra_mask[..., None]
    batch["residue_type_masked"] = residue_type * extra_mask.to(residue_type.dtype)
    batch["residue_one_hot"] = one_hot * extra_mask[..., None]
    batch["residue_extra_mask"] = extra_mask
    batch["residue_inv_extra_mask"] = inv_mask
    batch["x"] = angstrom_to_nanometre(pos)
    batch["residue_and_atom_mask"] = atom_mask + residue_mask
    return batch


@dataclasses.dataclass
class SamplerNoise:
    """Draws the DDPM sampler would otherwise take from its generator: raw
    uniforms and standard normals, before any masking or mean removal."""

    mask_scores: Optional[torch.Tensor] = None  # [B * N]
    z0: Optional[torch.Tensor] = None           # [B, N, 3]
    s0: Optional[torch.Tensor] = None           # [B, N, 21]
    steps: Optional[torch.Tensor] = None        # [T, B, N, 3], loop order t = T-1 .. 0


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


@torch.inference_mode()
def sample(
    net: ProteinReDiffNet,
    batch: Batch,
    mask_prob: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[SamplerNoise] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DDPM ancestral sampler (`prdiff.py:669-687`) as a loop over
    t = T-1 .. 0. Returns (positions in Å, residue-masked seq logits)."""
    cfg = net.cfg
    mask_prob = cfg.mask_prob if mask_prob is None else mask_prob
    sched = DiffusionSchedule.create(cfg.num_steps, cfg.diffusion_schedule,
                                     device=batch["residue_mask"].device)
    batch, carry = sample_init(batch, mask_prob, generator, noise)
    x = batch["x"]
    for i, t in enumerate(range(cfg.num_steps - 1, -1, -1)):
        if noise is not None and noise.steps is not None:
            step_noise = noise.steps[i]
        else:
            step_noise = _normal(x.shape, x, generator)
        carry = gaussian_step(net, sched, batch, carry, t, step_noise)
    return sample_finish(batch, carry)
