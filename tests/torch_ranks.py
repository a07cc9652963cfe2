"""Rank bodies that ``tests/test_torch_multidevice.py`` spawns with
``torch.multiprocessing``. They import torch and the port only (a spawned
child imports this module by name), so a rank never pays for jax."""

from pathlib import Path


def train_rank(rank: int, world: int, port: int, workdir: str) -> None:
    """Join a gloo group on the CPU, run ``inputs.pt``'s train steps on this
    rank's rows of each global micro-batch (the draws are the global ones)
    and save the metrics, the state and the checksum as ``rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
    from protein_redesign_tpu_torch.parallel import mesh
    from protein_redesign_tpu_torch.parallel.train_step import make_train_state, make_train_step
    from protein_redesign_tpu_torch.utils.checkpoint import load_train_state, step_dir

    torch.set_num_threads(1)
    mesh.join(mesh.Cluster(rank, world, rank, f"tcp://127.0.0.1:{port}"), "cpu")
    workdir = Path(workdir)
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    net = ProteinReDiffNet(inputs["cfg"])
    state = make_train_state(net)
    load_train_state(step_dir(workdir / "start"), state)
    step = make_train_step(inputs["train_cfg"])
    b = inputs["micro"][0]["residue_mask"].shape[0] // world
    rows = slice(rank * b, (rank + 1) * b)
    micro = [{k: v[rows] for k, v in m.items()} for m in inputs["micro"]]
    metrics = []
    for noises in inputs["noises"]:
        m = step(state, micro, noises)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    digest = mesh.assert_replicas_equal(net)
    opt = state.optimizer
    torch.save({
        "metrics": metrics, "digest": digest, "step": state.step,
        "params": net.state_dict(), "ema": state.ema.state_dict(),
        "mu": {n: opt.state[p]["exp_avg"] for n, p in net.named_parameters()},
        "nu": {n: opt.state[p]["exp_avg_sq"] for n, p in net.named_parameters()},
    }, workdir / f"rank{rank}.pt")
    dist.destroy_process_group()
