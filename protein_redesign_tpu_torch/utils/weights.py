"""Weights carried between the JAX package and the port.

``state_dict_from_jax`` is the inverse of
``protein_redesign_tpu.utils.convert.convert_state_dict``: it takes the JAX
parameter tree (numpy arrays) and returns the port's ``state_dict`` under the
reference names, transposing Dense kernels, splitting the fused embedding
tables per feature, mapping LayerNorm ``scale`` to ``weight`` and adding the
two constant buffers. ``train_state_from_jax`` carries a whole JAX train
state (weights, EMA, Adam moments, counters) onto the port's. ``load_checkpoint``
reads what the port's generate CLI accepts: a directory with ``config.json``
and ``model.pt``, a train checkpoint directory of the port's train CLI (EMA
weights of the lowest-val_loss step), or a reference Lightning ``.ckpt``.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from pathlib import Path
from typing import TYPE_CHECKING, Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch

from protein_redesign_tpu.chem.features import ATOM_FEATURE_SIZES, BOND_FEATURE_SIZES
from protein_redesign_tpu.config import ModelConfig

from ..models.layers import rbf_centers, sinusoidal_weights

if TYPE_CHECKING:
    from ..parallel.train_step import TrainState

StateDict = Dict[str, torch.Tensor]


def _node(tree: Mapping[str, Any], path: str) -> Any:
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _tensor(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd: StateDict, dst: str, tree: Mapping[str, Any], src: str) -> None:
    node = _node(tree, src)
    sd[f"{dst}.weight"] = _tensor(np.asarray(node["kernel"]).T)
    if "bias" in node:
        sd[f"{dst}.bias"] = _tensor(node["bias"])


def _layernorm(sd: StateDict, dst: str, tree: Mapping[str, Any], src: str) -> None:
    node = _node(tree, src)
    sd[f"{dst}.weight"] = _tensor(node["scale"])
    sd[f"{dst}.bias"] = _tensor(node["bias"])


def _embed_stack(sd: StateDict, dst: str, tree: Mapping[str, Any], src: str, sizes) -> None:
    table = np.asarray(_node(tree, src))
    for i, part in enumerate(np.split(table, np.cumsum(sizes)[:-1], axis=0)):
        sd[f"{dst}.embeddings.{i}.weight"] = _tensor(part)


def _denoiser(sd: StateDict, t: Mapping[str, Any], num_blocks: int, p: str) -> None:
    """Inverse of ``convert_denoiser`` (`utils/convert.py:57-99`)."""
    _layernorm(sd, f"{p}SPAAttnBlock.layer_norm_m", t, "spa_attn/layer_norm_m/LayerNorm_0")
    _layernorm(sd, f"{p}SPAAttnBlock.linear_z.0", t, "spa_attn/z_norm/LayerNorm_0")
    _linear(sd, f"{p}SPAAttnBlock.linear_z.1", t, "spa_attn/linear_z/Dense_0")
    for name in ("q", "k", "v", "o", "g"):
        _linear(sd, f"{p}SPAAttnBlock.mha.linear_{name}", t, f"spa_attn/linear_{name}/Dense_0")
    _layernorm(sd, f"{p}opm.layer_norm", t, "opm/layer_norm/LayerNorm_0")
    for name in ("1", "2", "out"):
        _linear(sd, f"{p}opm.linear_{name}", t, f"opm/linear_{name}/Dense_0")
    for i in range(num_blocks):
        b, d = f"{p}folding_blocks.{i}", f"folding_blocks_{i}"
        _linear(sd, f"{b}.attn_bias.1", t, f"{d}/attn_bias_proj/Dense_0")
        for proj in ("q_proj", "k_proj", "v_proj", "gate_proj", "out_proj"):
            _linear(sd, f"{b}.single_attn.{proj}", t, f"{d}/single_attn/{proj}/Dense_0")
        _linear(sd, f"{b}.single_fc.1", t, f"{d}/single_fc/PRLinear_0/Dense_0")
        _linear(sd, f"{b}.single_fc.3", t, f"{d}/single_fc/PRLinear_1/Dense_0")
        _linear(sd, f"{b}.outer_linear.linear", t, f"{d}/outer_linear/linear/Dense_0")
        for mode in ("outgoing", "incoming"):
            for proj in ("ab_proj", "ab_gate", "out_proj", "out_gate"):
                _linear(sd, f"{b}.pair_mul_{mode}.{proj}", t,
                        f"{d}/pair_mul_{mode}/{proj}/Dense_0")
        for mode in ("starting", "ending"):
            for proj in ("q_proj", "k_proj", "v_proj", "gate_proj", "out_proj"):
                _linear(sd, f"{b}.pair_attn_{mode}.attn.{proj}", t,
                        f"{d}/pair_attn_{mode}/attn/{proj}/Dense_0")
        _linear(sd, f"{b}.pair_fc.1", t, f"{d}/pair_fc/PRLinear_0/Dense_0")
        _linear(sd, f"{b}.pair_fc.3", t, f"{d}/pair_fc/PRLinear_1/Dense_0")


def state_dict_from_jax(params: Mapping[str, Any], cfg: ModelConfig) -> StateDict:
    """JAX parameter tree -> the port's state_dict (inverse of
    `utils/convert.py:102-123`)."""
    sd: StateDict = {}
    _embed_stack(sd, "embed_atom_feats", params,
                 "embed_atom_feats/FusedCategoricalEmbedding_0/table", ATOM_FEATURE_SIZES)
    _embed_stack(sd, "embed_bond_feats", params,
                 "embed_bond_feats/FusedCategoricalEmbedding_0/table", BOND_FEATURE_SIZES)
    for name in ("embed_beta", "embed_dist", "embed_residue_type", "embed_residue_esm"):
        _linear(sd, f"{name}.1", params, f"{name}/dense/Dense_0")
    sd["embed_bond_distance.weight"] = _tensor(_node(params, "embed_bond_distance/table"))
    sd["embed_relpos.weight"] = _tensor(_node(params, "embed_relpos/table"))
    for name in ("weight_radial", "seq_mlp"):
        _linear(sd, f"{name}.1", params, f"{name}/PRLinear_0/Dense_0")
        _linear(sd, f"{name}.3", params, f"{name}/PRLinear_1/Dense_0")
    _denoiser(sd, params["denoiser"], cfg.num_blocks, "Denoiser.")
    sd["embed_dist.0.center"] = rbf_centers(cfg.dist_dim)
    sd["embed_beta.0.weight"] = sinusoidal_weights(cfg.time_dim)
    return sd


def train_state_from_jax(state: "TrainState", tree: Mapping[str, Any]) -> None:
    """Load a JAX ``TrainState`` given as numpy trees, ``{"params",
    "ema_params", "mu", "nu", "count", "step", "ema_updates"}`` (Adam's
    moments and count from ``optax.ScaleByAdamState``), into the port's
    ``TrainState``: weights, EMA copy and Adam state under the same names."""
    cfg = state.net.cfg
    state.net.load_state_dict(state_dict_from_jax(tree["params"], cfg))
    state.ema.load_state_dict(state_dict_from_jax(tree["ema_params"], cfg))
    mu = state_dict_from_jax(tree["mu"], cfg)
    nu = state_dict_from_jax(tree["nu"], cfg)
    opt = state.optimizer
    for name, p in state.net.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(float(tree["count"])),
            "exp_avg": mu[name].to(p),
            "exp_avg_sq": nu[name].to(p),
        }
    state.step = int(tree["step"])
    state.ema_updates = int(tree["ema_updates"])


def config_from_dict(cfg_dict: Mapping[str, Any]) -> ModelConfig:
    """ModelConfig from a config.json dict; unknown keys are dropped with a
    warning, as the JAX checkpoint loader does."""
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = sorted(set(cfg_dict) - known)
    if unknown:
        warnings.warn(f"config carries unknown keys: {unknown} — ignored.")
    return ModelConfig(**{k: v for k, v in cfg_dict.items() if k in known})


def save_checkpoint(directory: Union[str, Path], state_dict: Mapping[str, torch.Tensor],
                    cfg: ModelConfig) -> None:
    """Write ``config.json`` (the ModelConfig fields) and ``model.pt``."""
    path = Path(directory)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path / "model.pt")


def load_checkpoint(path: Union[str, Path], **overrides: Any) -> Tuple[StateDict, ModelConfig]:
    """(state_dict, config) from a ``config.json`` + ``model.pt`` directory,
    a train checkpoint directory (EMA weights of its best step, as the JAX
    generate CLI loads one) or a reference Lightning ``.ckpt`` (EMA weights
    preferred, as `utils/convert.py:147-169` reads them)."""
    path = Path(path)
    if path.is_dir() and not (path / "model.pt").exists():
        from .checkpoint import load_ema_weights

        return load_ema_weights(path, **overrides)
    if path.is_dir():
        cfg_dict = json.loads((path / "config.json").read_text())
        cfg_dict.update(overrides)
        sd = torch.load(path / "model.pt", map_location="cpu", weights_only=True)
        return sd, config_from_dict(cfg_dict)
    from protein_redesign_tpu.utils.convert import load_reference_checkpoint

    params, ema_params, cfg = load_reference_checkpoint(str(path), **overrides)
    tree = ema_params if ema_params is not None else params
    return state_dict_from_jax(tree, cfg), cfg
