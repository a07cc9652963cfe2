"""FSDP parameter sharding over the mesh's model axis (port of
``protein_redesign_tpu/parallel/mesh.py`` ``_param_spec`` :74 and
``param_sharding`` :89, which the JAX train CLI applies to ``params`` and
``ema_params`` under ``--mesh_shape d,m``, `cli/train.py:272-280`).

``param_spec`` is JAX's rule on a leaf's shape in the flax layout: the
largest axis (ties: the first, as JAX's stable sort keeps them) that m
divides and that is at least 2 m long, else replicated; 1-D leaves are
replicated. ``shard_axes`` maps it onto the port's tensors: a torch
``Linear`` weight is [out, in] where the flax kernel is [in, out], so JAX's
axis a is the torch weight's axis 1 - a; the categorical embeddings' tables
are JAX's one fused table split by feature, each part sharded along the
fused table's axis.

``shard_net_`` leaves each rank its block of every sharded leaf (the
Parameter keeps its identity, so an optimizer built on the net follows it)
and registers the units: every FoldingBlock, and every other child of the
net and of its Denoiser. On entry to a unit's forward its sharded leaves are
all-gathered over the model group into whole tensors
(``mesh.gather_blocks``, whose adjoint reduce-scatters the gradient into
the shard's), and on exit
the shards are back in place: the whole weights live while the graph holds
them. With remat (the default) a FoldingBlock keeps none of them, and its
recompute in the backward gathers them again; without it autograd keeps
each gathered weight until its backward.

A checkpoint holds whole tensors (``whole_state_dict``,
``whole_optimizer_state``); ``shard_train_state_`` takes a state loaded
whole to this rank's shards, so a run resumes across layouts.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from . import mesh

ATTR = "_fsdp_axes"  # on the net: {parameter name: its sharded axis}


def param_spec(shape: Sequence[int], model_size: int) -> Optional[int]:
    """JAX's ``_param_spec`` on a flax-layout shape: the axis sharded over
    'model', or None for a replicated leaf."""
    if model_size <= 1 or len(shape) < 2:
        return None
    for axis in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[axis] % model_size == 0 and shape[axis] >= 2 * model_size:
            return axis
    return None


def _jax_layouts(net: nn.Module) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """Each parameter's flax-layout shape and the map from that layout's axes
    to the tensor's: a callable axis -> axis, or None where JAX shards a
    fused table along an axis the port's parts do not share."""
    from ..models.layers import CategoricalEmbedding, PRLinear

    out: Dict[str, Tuple[Tuple[int, ...], Any]] = {}
    for mod_name, module in net.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        if isinstance(module, CategoricalEmbedding):
            parts = [e.weight for e in module.embeddings]
            fused = (sum(p.shape[0] for p in parts), parts[0].shape[1])
            for i in range(len(parts)):
                out[f"{prefix}embeddings.{i}.weight"] = (fused, lambda a: a if a == 1 else None)
            continue
        for pname, p in module._parameters.items():
            name = f"{prefix}{pname}"
            if p is None or name in out:
                continue
            if isinstance(module, PRLinear) and pname == "weight":
                out[name] = (tuple(p.shape[::-1]), lambda a: 1 - a)
            else:
                out[name] = (tuple(p.shape), lambda a: a)
    return out


def shard_axes(net: nn.Module, model_size: int) -> Dict[str, Optional[int]]:
    """Each parameter's sharded torch axis on a model axis of
    ``model_size`` (JAX's ``param_sharding``), or None where it stays
    whole on every rank."""
    axes: Dict[str, Optional[int]] = {}
    layouts = _jax_layouts(net)
    for name, _ in net.named_parameters():
        shape, to_torch = layouts[name]
        axis = param_spec(shape, model_size)
        axes[name] = None if axis is None else to_torch(axis)
    return axes


def _units(net: nn.Module) -> List[nn.Module]:
    """The modules whose leaves are gathered together: every FoldingBlock,
    and every other child of the net and of its Denoiser."""
    from ..models.denoiser import Denoiser

    units: List[nn.Module] = []
    for child in net.children():
        if isinstance(child, Denoiser):
            for name, sub in child.named_children():
                units.extend(sub if name == "folding_blocks" else [sub])
        else:
            units.append(child)
    return units


def _restore(unit: nn.Module) -> None:
    """Put a unit's shards back in place of its gathered leaves."""
    for owner, pname, shard in unit._fsdp_swapped:
        owner._parameters[pname] = shard
    unit._fsdp_swapped = []


def _gather_hooks(axes: mesh.MeshAxes):
    """A unit's forward pre- and post-hooks: swap its sharded leaves for
    whole tensors, and the shards back."""

    def pre(unit: nn.Module, args: Any) -> None:
        _restore(unit)
        swapped = []
        for path, pname, axis in unit._fsdp_leaves:
            owner = unit.get_submodule(path)
            shard = owner._parameters[pname]
            owner._parameters[pname] = mesh.gather_blocks(shard, axes,
                                                          shard.shape[axis] * axes.model, axis)
            swapped.append((owner, pname, shard))
        unit._fsdp_swapped = swapped

    def post(unit: nn.Module, args: Any, output: Any) -> None:
        _restore(unit)

    return pre, post


def restore_(net: nn.Module) -> nn.Module:
    """Every unit's shards back in place. A remat recompute in the backward
    stops once it has the tensors the backward needs, so its unit's exit
    hook never runs; the train step calls this after its backward passes."""
    for module in net.modules():
        if getattr(module, "_fsdp_swapped", None):
            _restore(module)
    return net


def shard_net_(net: nn.Module, axes: mesh.MeshAxes) -> nn.Module:
    """Shard ``net``'s parameters over ``axes``'s model group in place (a
    model axis of 1 leaves it whole) and register the gather hooks."""
    spec = shard_axes(net, axes.model)
    setattr(net, ATTR, {n: a for n, a in spec.items() if a is not None})
    if axes.model == 1 or not getattr(net, ATTR):
        return net
    params = dict(net.named_parameters())
    with torch.no_grad():
        for name, axis in getattr(net, ATTR).items():
            p = params[name]
            p.data = p.data.chunk(axes.model, dim=axis)[axes.model_index].clone()
    pre, post = _gather_hooks(axes)
    names = {m: n for n, m in net.named_modules()}
    for unit in _units(net):
        prefix = names[unit]
        leaves = []
        for name, axis in getattr(net, ATTR).items():
            if name.startswith(prefix + "."):
                path, _, pname = name[len(prefix) + 1:].rpartition(".")
                leaves.append((path, pname, axis))
        if leaves:
            unit._fsdp_leaves = leaves
            unit._fsdp_swapped = []
            unit.register_forward_pre_hook(pre)
            unit.register_forward_hook(post)
    return net


def sharded(net: nn.Module) -> Dict[str, int]:
    """{parameter name: sharded axis} of a net ``shard_net_`` sharded; empty
    for a whole one."""
    return getattr(net, ATTR, {})


def _whole(t: torch.Tensor, axis: Optional[int], axes: Optional[mesh.MeshAxes]) -> torch.Tensor:
    if axis is None or axes is None or axes.model_group is None:
        return t.detach()
    return mesh.gathered(t.detach(), axis, axes.model_group)


def _block(t: torch.Tensor, axis: Optional[int], axes: mesh.MeshAxes) -> torch.Tensor:
    if axis is None:
        return t
    return t.chunk(axes.model, dim=axis)[axes.model_index].clone()


def whole_state_dict(net: nn.Module) -> Dict[str, torch.Tensor]:
    """``net``'s state_dict with whole tensors on the CPU (collective over the
    model group where ``net`` is sharded: every rank calls it)."""
    spec, axes = sharded(net), mesh.current_axes()
    return {k: _whole(v, spec.get(k), axes).cpu() for k, v in net.state_dict().items()}


def whole_optimizer_state(net: nn.Module, optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer.state_dict()`` with each sharded parameter's moments whole
    (collective, as ``whole_state_dict``)."""
    spec, axes = sharded(net), mesh.current_axes()
    state = optimizer.state_dict()
    names = [n for n, _ in net.named_parameters()]
    # the packed entries are the optimizer's own dicts: whole copies go in new ones
    state["state"] = {index: {k: _whole(v, spec.get(names[index]), axes)
                              if k in ("exp_avg", "exp_avg_sq") else v
                              for k, v in entry.items()}
                      for index, entry in state["state"].items()}
    return state


def shard_train_state_(state: Any, axes: mesh.MeshAxes) -> Any:
    """Shard a TrainState holding whole tensors: the net, the EMA copy and
    Adam's moments (which follow their parameters: a difference of layout
    from JAX's replicated optax state, with the same numbers)."""
    shard_net_(state.net, axes)
    shard_net_(state.ema, axes)
    spec = sharded(state.net)
    for name, p in state.net.named_parameters():
        entry = state.optimizer.state.get(p)
        if entry is None or name not in spec:
            continue
        for key in ("exp_avg", "exp_avg_sq"):
            if key in entry and entry[key].shape != p.shape:
                entry[key] = _block(entry[key], spec[name], axes)
    return state


def whole_checksum(net: nn.Module) -> str:
    """sha256 of the whole parameters' bytes, in order (collective where
    ``net`` is sharded)."""
    import hashlib

    spec, axes = sharded(net), mesh.current_axes()
    h = hashlib.sha256()
    for name, p in net.named_parameters():
        t = _whole(p, spec.get(name), axes).contiguous().cpu()
        h.update(t.view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()
