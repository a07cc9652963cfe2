"""Device meshes, row sharding and process groups (port of
``protein_redesign_tpu/parallel/mesh.py``; ``init_distributed`` ports the
JAX train CLI's ``_maybe_init_distributed``, `cli/train.py:29-69`).

The JAX package builds a ('data', 'model') ``jax.sharding.Mesh`` and lets
GSPMD split the batch over 'data', shard the large parameters over 'model'
and insert the collectives. The port does the same by hand:

- training runs one process a device in a ``torch.distributed`` process
  group. Rank r sits at mesh position (r // m, r % m), as JAX's
  ``reshape(d, m)`` of the device list puts devices (``MeshAxes``): the m
  ranks of one data row form its model group and take the same rows of
  the global batch and the same draws; the d ranks of one model column form
  its data group. Each data row holds its block of the global batch's rows;
  the loss's batch-wide sums are all-reduced over the data group with
  autograd (``all_reduce_sum``) and the gradients once a step
  (``parallel/train_step.py``). With m > 1 the parameters are sharded over
  the model group (FSDP, ``parallel/fsdp.py``) after JAX's ``_param_spec``
  (``param_spec``);
- ``on_mesh(axes)`` is the counterpart of JAX's ``with mesh:``: inside it
  a ``sequence_parallel`` model shards the pair and single representations'
  first complex axis over the model group (``models/denoiser.py``), with
  the collective below (``gather_blocks`` and its adjoint);
- sampling keeps one process and a ``ReplicatedNet``: one copy of the net a
  mesh device, each call's rows split over them and run in turn from one
  thread (the launches do not wait for the cards), the outputs gathered in
  order on the first device.

A mesh is an array of ``torch.device`` s; one device may appear more than
once (two replicas on one card, or on the CPU).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import os
import socket
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# The backend of a process group: nccl on CUDA devices and gloo on the CPU,
# unless this variable names one (gloo lets two ranks share one card).
BACKEND_VAR = "PRD_DIST_BACKEND"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices as a (data, model) array."""

    devices: np.ndarray  # object array [d, m] of torch.device

    @property
    def shape(self) -> Dict[str, int]:
        d, m = self.devices.shape
        return {DATA_AXIS: d, MODEL_AXIS: m}

    @property
    def data_devices(self) -> List[torch.device]:
        """The devices along the data axis, in order."""
        return list(self.devices[:, 0])


def make_mesh(devices: Sequence[Any], mesh_shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """A ('data', 'model') mesh over ``devices`` (all on the data axis by
    default), device i at ``mesh_position(i, m)``. ValueError when the shape
    does not hold them, as in JAX."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if mesh_shape is None:
        mesh_shape = (n, 1)
    d, m = mesh_shape
    if d * m != n:
        raise ValueError(f"mesh_shape {mesh_shape} != {n} devices")
    array = np.empty((d, m), dtype=object)
    for i, device in enumerate(devices):
        array[mesh_position(i, m)] = device
    return Mesh(array)


def mesh_position(rank: int, model_size: int) -> Tuple[int, int]:
    """(data index, model index) of rank or device ``rank`` on a mesh with a
    model axis of ``model_size``: JAX's ``reshape(d, m)``, row-major."""
    return rank // model_size, rank % model_size


def host_scalar(x: Any) -> Any:
    """A Python scalar from a value every rank holds (a tensor on any
    device, a numpy value or a number)."""
    if torch.is_tensor(x):
        return x.item()
    return np.asarray(x).item()


def row_blocks(rows: int, parts: int) -> List[Tuple[int, int]]:
    """Contiguous [start, stop) blocks of ``rows`` over ``parts``: ceil-sized,
    as JAX pads an uneven split, so a short last block (and fewer blocks
    than parts when rows < parts)."""
    size = -(-rows // parts)
    return [(lo, min(lo + size, rows)) for lo in range(0, rows, size)]


def shard_batch(mesh: Mesh, batch: Dict[str, Any], rows: int) -> List[Dict[str, Any]]:
    """The batch's leading axis split over 'data' in contiguous row blocks
    (``row_blocks``), each on its device (``batch_sharding`` +
    ``shard_batch``): tensors with ``rows`` leading rows are split, other
    tensors copied whole to each device, other values passed as they are.
    Fewer blocks than devices where ``rows`` is smaller than the axis."""
    def part(v: Any, lo: int, hi: int, device: torch.device) -> Any:
        if not torch.is_tensor(v):
            return v
        return (v[lo:hi] if v.dim() and v.shape[0] == rows else v).to(device)

    return [{k: part(v, lo, hi, device) for k, v in batch.items()}
            for (lo, hi), device in zip(row_blocks(rows, mesh.shape[DATA_AXIS]),
                                        mesh.data_devices)]


def devices_for(n: int, device: Any) -> List[torch.device]:
    """n devices for ranks or replicas: ``cuda:0 .. cuda:n-1`` for ``cuda``
    (the JAX CLIs' ValueError where fewer cards are visible), else
    ``device`` (a card ``cuda:K`` or the CPU) n times."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        visible = torch.cuda.device_count()
        if visible < n:
            raise ValueError(f"--num_devices {n} requested but only {visible} CUDA devices "
                             f"are visible")
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * n


def gather_rows(blocks: Sequence[torch.Tensor], device: Any) -> torch.Tensor:
    """Row blocks concatenated in order on ``device``."""
    return torch.cat([b.to(device) for b in blocks], dim=0)


def pad_rows(group: List[Any], multiple: int) -> List[Any]:
    """``group`` with its last item repeated up to a multiple of
    ``multiple`` (the JAX runner's padding; the caller drops the copies)."""
    return group + [group[-1]] * ((-len(group)) % multiple)


# -- process groups ---------------------------------------------------------


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(device: Any) -> str:
    """``PRD_DIST_BACKEND`` where set, else nccl for CUDA and gloo for the CPU."""
    chosen = os.environ.get(BACKEND_VAR)
    if chosen:
        return chosen
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


@dataclasses.dataclass(frozen=True)
class Cluster:
    """How this process joins a group: its rank, the world size, its local
    rank (the card it takes) and the rendezvous."""

    rank: int
    world: int
    local_rank: int
    init_method: str


def cluster_from_env() -> Optional[Cluster]:
    """The JAX CLI's cluster variables (``JAX_COORDINATOR_ADDRESS`` or
    ``COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), else
    torchrun's (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``), else None. Under the JAX variables the local rank is
    ``LOCAL_RANK`` where set, else 0 (one process a host)."""
    env = os.environ
    coord = env.get("JAX_COORDINATOR_ADDRESS") or env.get("COORDINATOR_ADDRESS")
    nproc, pid = env.get("JAX_NUM_PROCESSES"), env.get("JAX_PROCESS_ID")
    if coord and nproc and pid:
        try:
            world, rank = int(nproc), int(pid)
        except ValueError:
            raise SystemExit(f"JAX_NUM_PROCESSES/JAX_PROCESS_ID must be integers "
                             f"(got {nproc!r}, {pid!r})")
        return Cluster(rank, world, int(env.get("LOCAL_RANK", 0)), f"tcp://{coord}")
    if all(env.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
        return Cluster(int(env["RANK"]), int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", 0)),
                       "env://")
    return None


def join(cluster: Cluster, device: Any) -> torch.device:
    """Join the process group of ``cluster`` and return this rank's device:
    ``device`` itself when it names a card index (every rank on that card)
    or the CPU, else ``cuda:<local_rank>``. The backend is ``backend_for``'s,
    with no fallback: where it fails to start, this raises."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", cluster.local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend_for(device)
        dist.init_process_group(backend, init_method=cluster.init_method,
                                world_size=cluster.world, rank=cluster.rank,
                                device_id=device if backend == "nccl" else None)
    return device


def init_distributed(device: Any = "cuda") -> Optional[Tuple[Cluster, torch.device]]:
    """Join a process group from the cluster variables (``cluster_from_env``);
    (cluster, this rank's device), or None where no variable is set."""
    cluster = cluster_from_env()
    if cluster is None:
        return None
    return cluster, join(cluster, device)


def distributed() -> bool:
    """True inside a process group: the collectives below then run."""
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> Tuple[int, int]:
    if not distributed():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """This rank's place on a (data, model) mesh of ranks: the axes' sizes,
    its indices along them (``mesh_position``), and its data group (the d
    ranks of its model column) and model group (the m ranks of its data
    row); the groups are None outside a process group."""

    data: int
    model: int
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None


def mesh_axes(d: int, m: int) -> MeshAxes:
    """This rank's ``MeshAxes`` on a (d, m) mesh of the group's ranks. Every
    rank calls it with the same shape (creating a group is collective);
    outside a group only (1, 1) holds. ValueError, as ``make_mesh``'s, when
    d m is not the world size."""
    rank, world = rank_and_world()
    if d * m != world:
        raise ValueError(f"mesh_shape {(d, m)} != {world} devices")
    di, mi = mesh_position(rank, m)
    if not distributed():
        return MeshAxes(d, m)
    model_groups = [dist.new_group([i * m + j for j in range(m)]) for i in range(d)]
    data_groups = [dist.new_group([i * m + j for i in range(d)]) for j in range(m)]
    return MeshAxes(d, m, di, mi, data_groups[mi], model_groups[di])


_AXES: Optional[MeshAxes] = None


@contextlib.contextmanager
def on_mesh(axes: MeshAxes):
    """Run the block on ``axes``: the port's ``with mesh:``. The loss's
    batch sums span its data group, and a ``sequence_parallel`` model
    shards its complex axis over its model group."""
    global _AXES
    outer, _AXES = _AXES, axes
    try:
        yield axes
    finally:
        _AXES = outer


def current_axes() -> Optional[MeshAxes]:
    """The axes of the innermost ``on_mesh``, or None outside one."""
    return _AXES


def _data_group() -> Any:
    """The group the batch's rows span: the data group inside ``on_mesh``,
    else the whole world (a (world, 1) mesh)."""
    return None if _AXES is None else _AXES.data_group


def _group_size(group: Any) -> int:
    return dist.get_world_size(group) if distributed() else 1


def _comm_device(x: torch.Tensor) -> torch.device:
    """Where a collective on ``x`` runs: the CPU where the group's backend
    is gloo (which stages a card's tensors through the host), else x's
    device."""
    return torch.device("cpu") if dist.get_backend() == "gloo" else x.device


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a collective sends it: on the CPU under gloo, and bf16 as f32
    there (exact)."""
    y = x.detach().to(_comm_device(x))
    if y.device.type == "cpu" and y.dtype == torch.bfloat16:
        y = y.float()
    return y.contiguous()


def all_reduced(x: torch.Tensor, op: Any = None, group: Any = None) -> torch.Tensor:
    """``x`` summed (or reduced by ``op``) over ``group`` (the world by
    default), as a new tensor."""
    y = _wire(x).clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return y.to(x.device, x.dtype)


def gathered(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """The group's equal-shaped ``x`` concatenated along ``dim`` in rank
    order, without gradient."""
    y = _wire(x)
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts, dim=dim).to(x.device, x.dtype)


def reduce_scattered(x: torch.Tensor, dim: int, group: Any) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x`` summed over the group (equal
    blocks): nccl's reduce-scatter, and under gloo, which has none, an
    all-reduce and a slice."""
    n, index = dist.get_world_size(group), dist.get_rank(group)
    if dist.get_backend(group) == "nccl":
        moved = x.movedim(dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // n,) + moved.shape[1:], dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, moved, group=group)
        return out.movedim(0, dim)
    return all_reduced(x, group=group).chunk(n, dim=dim)[index].contiguous()


class _AllReduceSum(torch.autograd.Function):
    """y = sum over the group's ranks of x; the gradient of each rank's x is
    the sum over the ranks of dL/dy, so the ranks' gradients add up to the
    gradient of the sum of their losses."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduced(x, group=group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduced(grad, group=ctx.group), None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data group (``_data_group``),
    differentiable; ``x`` itself outside a process group."""
    return _AllReduceSum.apply(x, _data_group()) if distributed() else x


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The data group's equal-shaped ``x`` concatenated along the rows, in
    rank order, without gradient; ``x`` itself outside a process group."""
    if not distributed():
        return x
    return gathered(x, 0, _data_group())


class _GatherBlocks(torch.autograd.Function):
    """The model group's blocks of ``dim`` (``row_blocks(total, m)``, the
    last one short where m does not divide ``total``, padded for the
    collective as JAX pads) as the whole axis. Adjoint: the reduce-scatter,
    each rank's block of the gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, dim, total, group):
        n = dist.get_world_size(group)
        size = -(-total // n)
        ctx.dim, ctx.group, ctx.size, ctx.total = dim, group, size, total
        ctx.real = x.shape[dim]
        pad = size - x.shape[dim]
        if pad:
            shape = list(x.shape)
            shape[dim] = pad
            x = torch.cat([x, x.new_zeros(shape)], dim=dim)
        return gathered(x, dim, group).narrow(dim, 0, total)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        pad = ctx.size * n - ctx.total
        if pad:
            shape = list(grad.shape)
            shape[ctx.dim] = pad
            grad = torch.cat([grad, grad.new_zeros(shape)], dim=ctx.dim)
        block = reduce_scattered(grad.contiguous(), ctx.dim, ctx.group)
        return block.narrow(ctx.dim, 0, ctx.real), None, None, None


def gather_blocks(x: torch.Tensor, axes: MeshAxes, total: int, dim: int = 1) -> torch.Tensor:
    """The whole axis ``dim`` (``total`` long) from each model rank's block
    of it, differentiable (``_GatherBlocks``): a sequence-parallel
    activation's complex axis, or an FSDP parameter from its shards; ``x``
    itself on a model axis of 1."""
    if axes.model == 1 or axes.model_group is None:
        return x
    return _GatherBlocks.apply(x, dim, total, axes.model_group)


def sp_rows(total: int, axes: MeshAxes) -> Tuple[int, int]:
    """[start, stop) of this rank's block of a complex axis of ``total``
    over the model axis (an empty block past the rows, where m > total)."""
    blocks = row_blocks(total, axes.model)
    if axes.model_index < len(blocks):
        return blocks[axes.model_index]
    return total, total


def any_rank(flag: bool) -> bool:
    """True where ``flag`` is true on any rank (each rank must call it)."""
    if not distributed():
        return flag
    on_card = dist.get_backend() == "nccl"
    t = torch.tensor([float(flag)], device=torch.cuda.current_device() if on_card else "cpu")
    return bool(all_reduced(t, dist.ReduceOp.MAX).item() > 0)


def barrier() -> None:
    if distributed():
        dist.barrier()


def assert_replicas_equal(module: torch.nn.Module) -> str:
    """The whole parameters' checksum (a sharded net's gathered first), after
    checking that every rank holds the same one (AssertionError naming each
    rank's where they differ)."""
    from .fsdp import whole_checksum

    digest = whole_checksum(module)
    if distributed():
        digests: List[Optional[str]] = [None] * dist.get_world_size()
        dist.all_gather_object(digests, digest)
        if len(set(digests)) != 1:
            raise AssertionError(f"the ranks' parameters differ: {digests}")
    return digest


@dataclasses.dataclass
class RowShard:
    """This rank's rows [start, stop) of a global batch of ``total`` rows,
    for the training loss: the sequence masks rank and count over the
    global batch (``residue_mask`` is the global one), and the reference
    loss's KL and CE sums span it (``sum``)."""

    start: int
    stop: int
    total: int
    residue_mask: torch.Tensor  # [total, N]

    @staticmethod
    def of(local_residue_mask: torch.Tensor) -> "RowShard":
        """The shard of this rank's equal block of its data group's rows,
        from its residue mask."""
        group = _data_group()
        index = dist.get_rank(group) if distributed() else 0
        b = local_residue_mask.shape[0]
        return RowShard(index * b, (index + 1) * b, _group_size(group) * b,
                        all_gather_rows(local_residue_mask))

    def rows(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return None if x is None else x[self.start:self.stop]

    @staticmethod
    def sum(x: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(x)


# -- sampling replicas --------------------------------------------------------

_MASK = "__mask__"  # the net's mask argument, split with the batch


class ReplicatedNet:
    """``ProteinReDiffNet`` replicated over a mesh's data axis, with the
    net's call signature and ``cfg``: each call's rows (of ``batch``, ``z``,
    ``seq``, ``mask``, ``t`` and the self-conditioning inputs) are split in
    contiguous blocks over the replicas, run in turn from the calling thread
    (each under its device) and gathered in order on the first device. The
    forward reads nothing back to the host and kernel launches do not wait
    for the card, so replicas on different cards overlap their device work.
    The split of ``batch`` and ``mask`` is kept while the caller passes the
    same objects, so only z, seq and t cross each call. ``launches[i]``
    counts replica i's kernel launches by kernel."""

    def __init__(self, net: torch.nn.Module, mesh: Mesh):
        self.mesh, self.devices = mesh, mesh.data_devices
        self.primary = self.devices[0]
        first = net.to(self.primary)
        self.replicas = [first] + [copy.deepcopy(first).to(d) for d in self.devices[1:]]
        self.cfg = first.cfg
        self.launches: List[Dict[str, int]] = [{} for _ in self.devices]
        self._static: Optional[Tuple[Any, Any, List]] = None

    def __getattr__(self, name: str) -> Any:
        if name == "replicas":  # not set yet: no recursion through __getattr__
            raise AttributeError(name)
        return getattr(self.replicas[0], name)

    def eval(self) -> "ReplicatedNet":
        for r in self.replicas:
            r.eval()
        return self

    def reset_launches(self) -> None:
        self.launches = [{} for _ in self.devices]

    def _split_static(self, batch, mask) -> List[Tuple[Dict[str, Any], torch.Tensor]]:
        """Each replica's (batch, mask) rows, kept while the same objects come."""
        cached = self._static
        if cached is None or cached[0] is not batch or cached[1] is not mask:
            parts = shard_batch(self.mesh, {**batch, _MASK: mask}, mask.shape[0])
            self._static = cached = (batch, mask, [(p, p.pop(_MASK)) for p in parts])
        return cached[2]

    def __call__(self, batch, z, seq, mask, t, *extra):
        from ..ops.attention import LAUNCHES

        moving = shard_batch(self.mesh, dict(enumerate((z, seq, t, *extra))), z.shape[0])
        outs = []
        for i, ((b, m), rows) in enumerate(zip(self._split_static(batch, mask), moving)):
            device, before = self.devices[i], dict(LAUNCHES)
            with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
                outs.append(self.replicas[i](b, rows[0], rows[1], m, rows[2],
                                             *(rows[k] for k in range(3, 3 + len(extra)))))
            for name, n in LAUNCHES.items():
                if n > before[name]:
                    self.launches[i][name] = self.launches[i].get(name, 0) + n - before[name]
        return tuple(gather_rows([o[i] for o in outs], self.primary) for i in range(2))
