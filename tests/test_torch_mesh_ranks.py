"""Rank bodies that ``tests/test_torch_fsdp.py`` and
``tests/test_torch_sequence_parallel.py`` spawn with ``torch.multiprocessing``
on gloo CPU ranks. They import torch and the port only (a spawned child
imports this module by name), so a rank never pays for jax. No tests here.
"""

from pathlib import Path


def _join(rank: int, world: int, port: int):
    import torch

    from protein_redesign_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.join(mesh.Cluster(rank, world, rank, f"tcp://127.0.0.1:{port}"), "cpu")
    return mesh


def fsdp_rank(rank: int, world: int, port: int, workdir: str, d: int, m: int) -> None:
    """A rank of a (d, m) mesh: ``inputs.pt``'s train steps on its data
    row's rows of each global micro-batch with the parameters, EMA and
    moments sharded over its model group; saves the metrics, the whole
    state (gathered) and its shard shapes as ``rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
    from protein_redesign_tpu_torch.parallel import fsdp
    from protein_redesign_tpu_torch.parallel.train_step import make_train_state, make_train_step
    from protein_redesign_tpu_torch.utils.checkpoint import load_train_state, step_dir

    mesh = _join(rank, world, port)
    workdir = Path(workdir)
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    axes = mesh.mesh_axes(d, m)
    with mesh.on_mesh(axes):
        state = make_train_state(ProteinReDiffNet(inputs["cfg"]))
        load_train_state(step_dir(workdir / "start"), state)
        fsdp.shard_train_state_(state, axes)
        step = make_train_step(inputs["train_cfg"])
        b = inputs["micro"][0]["residue_mask"].shape[0] // d
        rows = slice(axes.data_index * b, (axes.data_index + 1) * b)
        micro = [{k: v[rows] for k, v in mb.items()} for mb in inputs["micro"]]
        metrics = []
        for noises in inputs["noises"]:
            out = step(state, micro, noises)
            metrics.append({k: float(out[k]) for k in ("loss", "grad_norm")})
        net, opt = state.net, state.optimizer
        moments = fsdp.whole_optimizer_state(net, opt)["state"]
        names = [n for n, _ in net.named_parameters()]
        torch.save({
            "metrics": metrics, "step": state.step, "position": (axes.data_index, axes.model_index),
            "digest": mesh.assert_replicas_equal(net),
            "params": fsdp.whole_state_dict(net), "ema": fsdp.whole_state_dict(state.ema),
            "mu": {names[i]: e["exp_avg"] for i, e in moments.items()},
            "nu": {names[i]: e["exp_avg_sq"] for i, e in moments.items()},
            "shard_shapes": {n: tuple(p.shape) for n, p in net.named_parameters()},
            "moment_shapes": {n: tuple(opt.state[p]["exp_avg"].shape)
                              for n, p in net.named_parameters()},
            "ema_shapes": {n: tuple(p.shape) for n, p in state.ema.named_parameters()},
        }, workdir / f"rank{rank}.pt")
    dist.destroy_process_group()


def sp_rank(rank: int, world: int, port: int, workdir: str) -> None:
    """A rank of a (1, world) mesh: ``sp_inputs.pt``'s sequence-parallel
    Denoiser forwards (saved as ``sp<world>_rank<r>.pt``) and, where given,
    its train step (saved as ``sp_train_rank<r>.pt``)."""
    import torch
    import torch.distributed as dist

    from protein_redesign_tpu_torch.models.denoiser import Denoiser
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
    from protein_redesign_tpu_torch.ops.attention import LAUNCHES
    from protein_redesign_tpu_torch.parallel.train_step import make_train_state, make_train_step
    from protein_redesign_tpu_torch.utils.checkpoint import load_train_state, step_dir

    mesh = _join(rank, world, port)
    workdir = Path(workdir)
    inputs = torch.load(workdir / "sp_inputs.pt", weights_only=False)
    with mesh.on_mesh(mesh.mesh_axes(1, world)):
        outs = []
        for case in inputs["forwards"]:
            den = Denoiser(case["cfg"])
            den.load_state_dict(case["state_dict"])
            with torch.no_grad():
                outs.append(den(case["single"], case["pair"], case["mask"]))
        torch.save(outs, workdir / f"sp{world}_rank{rank}.pt")
        if "train" in inputs:
            t = inputs["train"]
            state = make_train_state(ProteinReDiffNet(t["cfg"]))
            load_train_state(step_dir(workdir / "sp_start"), state)
            metrics = make_train_step(t["train_cfg"])(state, t["micro"], t["noises"])
            torch.save({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                        "params": state.net.state_dict(), "launches": dict(LAUNCHES)},
                       workdir / f"sp_train_rank{rank}.pt")
    dist.destroy_process_group()
