"""ESM-2 protein language model (port of ``protein_redesign_tpu/models/esm2.py``).

The model is conditioned on frozen ESM-2 650M residue embeddings, so every
design request runs this encoder first. ``ESM2`` computes what the JAX
package's ``esm2_forward`` computes, in its order of roundings:

- token embedding with ESM's token dropout: ``<mask>`` rows zeroed, the
  rest rescaled by (1 - 0.12) / (1 - the observed mask ratio over the real
  tokens), pad rows zeroed;
- per layer: LN -> attention (q scaled by head_dim**-0.5 BEFORE the
  rotary embedding, as fair-esm does; rotary in f32; logits and P.V as
  products of compute-dtype operands summed in f32; softmax in f32 with a
  finfo(f32).min key bias) -> residual; LN -> erf-GELU MLP -> residual;
- rotary embeddings of the half-split form, tables built in float64;
- a final LayerNorm. LayerNorms and the residual stream stay f32.

Its parameters carry HF ``transformers.EsmModel``'s names, so an HF state
dict loads with ``load_state_dict`` (``encoder_state_dict`` drops the
contact head, the pooler and HF's rotary buffers). The dense layers hold
their weights in the compute dtype (the values JAX's per-use cast gives);
embeddings and LayerNorms stay f32.

``ESM2Encoder`` / ``load_esm2`` are the counterparts of ``JaxESM2`` /
``load_jax_esm2`` without length buckets: those exist in JAX to reuse
compiled programs, and padding with masked keys changes no output beyond
rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ESM-2 token-dropout constant: the mask ratio used in all ESM training
# runs (0.15 masked * 0.8 replaced-by-<mask>).
MASK_RATIO_TRAIN = 0.15 * 0.8


@dataclasses.dataclass(frozen=True)
class ESM2Config:
    vocab_size: int = 33
    hidden_size: int = 1280
    num_layers: int = 33
    num_heads: int = 20
    intermediate_size: int = 5120
    pad_token_id: int = 1
    mask_token_id: int = 32
    layer_norm_eps: float = 1e-5
    token_dropout: bool = True
    # Compute dtype for the matmul-heavy path; LayerNorm and softmax always
    # run in f32.
    dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _rotary_tables(length: int, dim: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [length, dim] of the duplicated-frequency form, built
    in float64 on ``device`` (no host copy, which would wait for the
    device) and rounded to f32."""
    f64 = dict(dtype=torch.float64, device=device)
    inv_freq = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, **f64) / dim))
    freqs = torch.outer(torch.arange(length, **f64), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().float(), emb.sin().float()


def _layer(cfg: ESM2Config, dtype: torch.dtype, device) -> nn.ModuleDict:
    """One encoder layer under HF's names."""
    D, Fd = cfg.hidden_size, cfg.intermediate_size

    def dense(din: int, dout: int) -> nn.Linear:
        return nn.Linear(din, dout, dtype=dtype, device=device)

    def norm() -> nn.LayerNorm:
        return nn.LayerNorm(D, eps=cfg.layer_norm_eps, device=device)

    return nn.ModuleDict(dict(
        attention=nn.ModuleDict(dict(
            self=nn.ModuleDict(dict(query=dense(D, D), key=dense(D, D), value=dense(D, D))),
            output=nn.ModuleDict(dict(dense=dense(D, D))),
            LayerNorm=norm(),
        )),
        intermediate=nn.ModuleDict(dict(dense=dense(D, Fd))),
        output=nn.ModuleDict(dict(dense=dense(Fd, D))),
        LayerNorm=norm(),
    ))


class ESM2(nn.Module):
    """The ESM-2 encoder: ``forward(input_ids [B, L], attention_mask [B, L])
    -> [B, L, hidden]`` f32 final-layer representations (1 = real token,
    0 = pad)."""

    def __init__(self, cfg: ESM2Config, device=None):
        super().__init__()
        self.cfg, self.dtype = cfg, getattr(torch, cfg.dtype)
        self.embeddings = nn.ModuleDict(dict(
            word_embeddings=nn.Embedding(cfg.vocab_size, cfg.hidden_size, device=device)))
        self.encoder = nn.ModuleDict(dict(
            layer=nn.ModuleList(_layer(cfg, self.dtype, device) for _ in range(cfg.num_layers)),
            emb_layer_norm_after=nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                              device=device),
        ))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        L = input_ids.shape[1]
        amask = attention_mask.float()

        # --- embeddings + ESM token dropout
        x = self.embeddings.word_embeddings(input_ids).float()
        if cfg.token_dropout:
            is_mask = (input_ids == cfg.mask_token_id).float()
            x = x * (1.0 - is_mask)[..., None]
            src_len = amask.sum(-1)
            observed = (is_mask * amask).sum(-1) / src_len.clamp(min=1.0)
            x = x * ((1.0 - MASK_RATIO_TRAIN) / (1.0 - observed))[:, None, None]
        x = x * amask[..., None]

        cos, sin = (t[:, None, :]  # [L, 1, Ch]
                    for t in _rotary_tables(L, cfg.head_dim, x.device))
        mask_bias = (1.0 - amask)[:, None, None, :] * torch.finfo(torch.float32).min
        for layer in self.encoder.layer:
            x = self._block(layer, x, cos, sin, mask_bias)
        return self.encoder.emb_layer_norm_after(x)

    def _block(self, layer: nn.ModuleDict, x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        dtype, H, Ch = self.dtype, self.cfg.num_heads, self.cfg.head_dim
        B, L, _ = x.shape
        attention = layer.attention

        # --- attention sublayer
        h = attention.LayerNorm(x).to(dtype)
        q = attention.self.query(h).view(B, L, H, Ch)
        k = attention.self.key(h).view(B, L, H, Ch)
        v = attention.self.value(h).view(B, L, H, Ch)
        q = q * Ch ** -0.5  # before the rotary embedding, as fair-esm
        qf, kf = q.float(), k.float()
        qf = qf * cos + _rotate_half(qf) * sin
        kf = kf * cos + _rotate_half(kf) * sin
        # products of compute-dtype operands summed in f32
        # (preferred_element_type=f32 on the JAX side)
        logits = torch.einsum("bihc,bjhc->bhij", qf.to(dtype).float(), kf.to(dtype).float())
        probs = torch.softmax(logits + mask_bias, dim=-1)
        ctx = torch.einsum("bhij,bjhc->bihc", probs.to(dtype).float(), v.float())
        x = x + attention.output.dense(ctx.reshape(B, L, H * Ch).to(dtype)).float()

        # --- feed-forward sublayer
        h = layer.LayerNorm(x).to(dtype)
        h = F.gelu(layer.intermediate.dense(h).float()).to(dtype)  # erf GELU, in f32
        return x + layer.output.dense(h).float()


# --------------------------------------------------------------- converters

# JAX stacked-pytree entries -> HF names inside encoder.layer.{i}
_LAYER_NAMES = {
    "ln1": "attention.LayerNorm",
    "q": "attention.self.query",
    "k": "attention.self.key",
    "v": "attention.self.value",
    "o": "attention.output.dense",
    "ln2": "LayerNorm",
    "fc1": "intermediate.dense",
    "fc2": "output.dense",
}


def encoder_state_dict(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """An HF ``EsmModel`` state dict without what ``ESM2`` does not hold:
    the contact head, the pooler and HF's rotary ``inv_freq`` buffers (the
    port builds its tables in float64). ``ESM2.load_state_dict`` of the
    result raises on a missing encoder key."""
    return {
        k: v for k, v in state_dict.items()
        if not k.startswith(("contact_head.", "pooler."))
        and not k.endswith("rotary_embeddings.inv_freq")
    }


def esm2_state_dict_from_jax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's stacked pytree (``kernel`` as [in, out], a leading
    layer axis) as ``ESM2``'s state dict."""

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    layers = params["layers"]
    out = {"embeddings.word_embeddings.weight": tensor(params["embed"]["weight"])}
    for i in range(np.shape(layers["q"]["kernel"])[0]):
        for key, name in _LAYER_NAMES.items():
            p = layers[key]
            prefix = f"encoder.layer.{i}.{name}"
            weight = np.asarray(p["kernel"][i]).T if "kernel" in p else p["scale"][i]
            out[f"{prefix}.weight"] = tensor(weight)
            out[f"{prefix}.bias"] = tensor(p["bias"][i])
    out["encoder.emb_layer_norm_after.weight"] = tensor(params["final_ln"]["scale"])
    out["encoder.emb_layer_norm_after.bias"] = tensor(params["final_ln"]["bias"])
    return out


def esm2_config_from_hf(hf_config: Any, dtype: str = "float32") -> ESM2Config:
    # ESM2 hardcodes the ESM-2 architecture: rotary positions, no embedding
    # LayerNorm. Reject ESM-1b/-1v style configs loudly instead of computing
    # silently wrong embeddings.
    pe = getattr(hf_config, "position_embedding_type", "absolute")
    if pe != "rotary" or getattr(hf_config, "emb_layer_norm_before", False):
        raise ValueError(
            f"the package's own encoder supports ESM-2 checkpoints only (rotary "
            f"positions, no pre-embedding LayerNorm); got "
            f"position_embedding_type={pe!r}, emb_layer_norm_before="
            f"{getattr(hf_config, 'emb_layer_norm_before', False)!r}. "
            "Use --esm_backend torch for other ESM variants."
        )
    return ESM2Config(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        pad_token_id=hf_config.pad_token_id,
        mask_token_id=hf_config.mask_token_id,
        layer_norm_eps=hf_config.layer_norm_eps,
        token_dropout=hf_config.token_dropout,
        dtype=dtype,
    )


class ESM2Encoder:
    """``ESM2`` on its device, one sequence a call."""

    def __init__(self, model: ESM2):
        self.model = model.eval().requires_grad_(False)
        self.device = model.embeddings.word_embeddings.weight.device

    def __call__(self, token_ids: np.ndarray) -> np.ndarray:
        """token_ids [L] (one sequence incl. cls/eos) -> [L, hidden] f32."""
        ids = torch.as_tensor(np.asarray(token_ids, np.int64), device=self.device)[None]
        with torch.inference_mode():
            out = self.model(ids, torch.ones_like(ids))
        return out[0].cpu().numpy()


def load_esm2(
    model_name: str = "facebook/esm2_t33_650M_UR50D",
    dtype: str = "float32",
    device: str = "cpu",
    local_files_only: bool = True,
) -> Optional[ESM2Encoder]:
    """Load HF ESM-2 weights (local cache only by default) into an
    ``ESM2Encoder`` on ``device``. Returns None when the weights are
    unavailable offline; any OTHER failure (unsupported architecture, a
    missing encoder key, a corrupt shard) propagates so it cannot
    masquerade as a missing-weights zero-fallback."""
    try:
        from transformers import AutoConfig, EsmModel

        hf = EsmModel.from_pretrained(
            model_name, local_files_only=local_files_only, add_pooling_layer=False,
        )
    except (OSError, ImportError):  # offline / not downloaded
        return None
    cfg = esm2_config_from_hf(
        AutoConfig.from_pretrained(model_name, local_files_only=local_files_only), dtype=dtype,
    )
    model = ESM2(cfg, device=device)
    model.load_state_dict(encoder_state_dict(hf.state_dict()))
    del hf
    return ESM2Encoder(model)
