"""Data-parallel training and sampling of the port (``parallel/mesh.py``)
against the JAX package's (2, 1) meshes on the CPU (the conftest's 8 virtual
devices), at the tiny widths of ``test_sampling_mesh.py`` and
``test_torch_train_step.py``:

- ``make_mesh``'s shape and its ValueError, as JAX's; the row split and
  gather, and the JAX runner's padding of an uneven group;
- the train step on 2 gloo ranks (spawned, CPU) against JAX's step jitted on
  a (2, 1) mesh from one start state, 2 steps of 2 accumulated micro-batches
  in reference loss mode with the clip active, JAX's draws injected:
  ``test_torch_train_step.py``'s tolerances, and the two ranks' parameters
  bit-equal;
- DDIM through 2 CPU replicas (``ReplicatedNet``) with JAX's draws against
  JAX's runner on a (2, 1) mesh at 1e-4, and the 2-replica runner against
  the one-device runner at 1e-5; Picard at tol 0 with its window over 2
  replicas against ``test_paratime.py``'s mesh run at 1e-4, and the
  uneven-window warning;
- the train CLI on 2 CPU ranks, through ``--num_devices 2`` (with a resume)
  and through the JAX cluster variables: equal step losses on both ranks,
  JAX's ``mesh:`` and ``multi-host fixed bucket:`` lines, one metrics row a
  step from rank 0, the checkpoint, and no jax in any rank's modules; and
  SIGTERM to the ``--num_devices 2`` CLI's process, which both ranks stop
  on, rank 0 checkpointing the step. These runs start with the module's
  first test and overlap the JAX compiles.

Torch runs on one thread in this process (and each rank on one): the
replica split and the GEMMs then sum in one order from call to call.
"""

import os
import re
import signal
import subprocess
import sys
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402
from test_torch_net import make_batch, perturbed_params  # noqa: E402
from test_torch_sampler import jax_draws  # noqa: E402
from test_torch_selfcond import train_draws  # noqa: E402
from test_torch_seq_reverse import sampler_draws  # noqa: E402
from test_torch_train_step import CFG as TRAIN_NET_CFG  # noqa: E402
from test_torch_train_step import TRAIN_CFG, _adam, _start_state, _tree  # noqa: E402

from protein_redesign_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from protein_redesign_tpu.models.paratime import sample_ddim_parallel as jax_parallel  # noqa: E402
from protein_redesign_tpu.models.prdiff import ProteinReDiffModel  # noqa: E402
from protein_redesign_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from protein_redesign_tpu.parallel.train_step import make_train_step as jax_train_step  # noqa: E402
from protein_redesign_tpu_torch.config import ModelConfig  # noqa: E402
from protein_redesign_tpu_torch.models import paratime as PT  # noqa: E402
from protein_redesign_tpu_torch.models import prdiff as P  # noqa: E402
from protein_redesign_tpu_torch.parallel import mesh as M  # noqa: E402
from protein_redesign_tpu_torch.utils.weights import (  # noqa: E402
    state_dict_from_jax,
    train_state_from_jax,
)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(esm_dim=16, time_dim=8, dist_dim=8, single_dim=16, pair_dim=8, head_dim=4,
            num_heads=2, num_blocks=1, dtype="float32", remat=False)
TWO_CPUS = ["cpu", "cpu"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- meshes and rows ----------------------------------------------------------


@pytest.mark.parametrize("n,shape", [(2, None), (4, None), (2, (2, 1)), (8, (8, 1)),
                                     (4, (2, 1)), (2, (4, 1))])
def test_make_mesh_matches_jax(n, shape):
    try:
        want = dict(jax_make_mesh(jax.devices()[:n], shape).shape)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            M.make_mesh(["cpu"] * n, shape)
        return
    mesh = M.make_mesh(["cpu"] * n, shape)
    assert mesh.shape == want
    assert mesh.data_devices == [torch.device("cpu")] * want["data"]


def test_rows_split_gather_and_pad():
    mesh = M.make_mesh(TWO_CPUS)
    batch = {"a": torch.arange(12.0).reshape(4, 3), "b": torch.arange(4),
             "table": torch.zeros(7), "name": "x"}
    blocks = M.shard_batch(mesh, batch, rows=4)
    assert [b["b"].tolist() for b in blocks] == [[0, 1], [2, 3]]
    assert all(b["table"].shape == (7,) and b["name"] == "x" for b in blocks)
    for k in ("a", "b"):
        assert torch.equal(M.gather_rows([b[k] for b in blocks], "cpu"), batch[k])
    # an uneven split takes ceil-sized blocks, as JAX pads it
    assert [b["a"].shape[0] for b in M.shard_batch(mesh, {"a": torch.zeros(3)}, rows=3)] == [2, 1]
    assert M.host_scalar(torch.tensor(2.5)) == 2.5 and M.host_scalar(np.int32(3)) == 3
    # the JAX runner pads a group with its last sample to the data axis
    assert M.pad_rows(["x", "y", "z"], 2) == ["x", "y", "z", "z"]
    assert M.pad_rows(["x", "y"], 2) == ["x", "y"]
    assert M.row_blocks(16, 2) == [(0, 8), (8, 16)]
    assert M.row_blocks(6, 4) == [(0, 2), (2, 4), (4, 6)]


# -- training -------------------------------------------------------------------


def _train_step_runs(workdir: Path):
    """Two gloo ranks of the port's train step, one row of each micro-batch
    apiece, spawned, and meanwhile JAX's step on a (2, 1) mesh, from one
    start state with JAX's draws: (each rank's saved results, JAX's
    metrics, JAX's final state)."""
    import torch.multiprocessing as mp

    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
    from protein_redesign_tpu_torch.parallel.train_step import make_train_state
    from protein_redesign_tpu_torch.utils.checkpoint import CheckpointManager
    from torch_ranks import train_rank

    cfg = TRAIN_NET_CFG
    micro = [make_batch(B=2, seed=s) for s in (11, 12)]
    B, N = micro[0]["residue_mask"].shape
    j_state = _start_state(cfg)
    adam = _adam(j_state.opt_state)
    state = make_train_state(ProteinReDiffNet(cfg))
    train_state_from_jax(state, {
        "params": _tree(j_state.params), "ema_params": _tree(j_state.ema_params),
        "mu": _tree(adam.mu), "nu": _tree(adam.nu), "count": int(adam.count),
        "step": int(j_state.step), "ema_updates": int(j_state.ema_updates),
    })
    CheckpointManager(workdir / "start").save(state)
    keys = [jax.random.PRNGKey(100 + i) for i in range(2)]
    torch.save({
        "cfg": cfg, "train_cfg": TRAIN_CFG,
        "micro": [{k: torch.from_numpy(v) for k, v in m.items()} for m in micro],
        "noises": [[train_draws(k, B, N, cfg) for k in jax.random.split(key, 2)]
                   for key in keys],
    }, workdir / "inputs.pt")
    ranks = mp.spawn(train_rank, args=(2, M.free_port(), str(workdir)), nprocs=2, join=False)

    mesh = jax_make_mesh(jax.devices()[:2], (2, 1))
    rep = NamedSharding(mesh, PartitionSpec())
    rows = NamedSharding(mesh, PartitionSpec(None, "data"))
    batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
    j_step = jax.jit(jax_train_step(ProteinReDiffModel(cfg.replace(remat=False)), TRAIN_CFG),
                     in_shardings=(rep, {k: rows for k in batch}, rep),
                     out_shardings=(rep, rep))
    j_state = jax.device_put(j_state, rep)
    jb = {k: jax.device_put(jnp.asarray(v), rows) for k, v in batch.items()}
    j_metrics = []
    for key in keys:
        j_state, m = j_step(j_state, jb, key)
        j_metrics.append({k: float(v) for k, v in m.items()})
    while not ranks.join():
        pass
    got = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return got, j_metrics, j_state


# -- sampling -------------------------------------------------------------------


def _replicated(cfg, params):
    net = P.ProteinReDiffNet(cfg)
    net.load_state_dict(state_dict_from_jax(params, cfg))
    return net.eval(), M.ReplicatedNet(net, M.make_mesh(TWO_CPUS))


def _complex():
    from protein_redesign_tpu.chem import mol_from_smiles, protein_from_sequence, update_mol_positions
    from protein_redesign_tpu.data import ligand_to_data, protein_to_data

    mol = update_mol_positions(mol_from_smiles("CCO"), np.zeros((3, 3)))
    data = {**ligand_to_data(mol), **protein_to_data(protein_from_sequence("ACDEFGHIKL"),
                                                     esm_dim=16)}
    data["residue_esm"] = np.random.RandomState(3).randn(*data["residue_esm"].shape).astype(
        np.float32)
    return data


def test_ddim_over_two_replicas_matches_jax_mesh_runner():
    """JAX's runner on a (2, 1) mesh (batch 2 split 1 + 1) against the port's
    DDIM through 2 CPU replicas with the runner's draws."""
    from protein_redesign_tpu.cli.common import SamplingRunner as JaxRunner
    from protein_redesign_tpu.data import collate_fn
    from protein_redesign_tpu.data.collate import numeric_batch

    cfg = ModelConfig(**TINY, num_steps=12)
    params = perturbed_params(cfg, seed=4, scale=0.1)
    data = _complex()
    key, steps = jax.random.PRNGKey(5), 4
    runner = JaxRunner(ProteinReDiffModel(JaxModelConfig(**TINY, num_steps=12)), params,
                       buckets=(16,), batch_size=2, mask_prob=0.5, sampler="ddim",
                       ddim_steps=steps, mesh=jax_make_mesh(jax.devices()[:2], (2, 1)))
    want = runner.run([data, data], key)

    _, net2 = _replicated(cfg, params)
    batch = {k: torch.from_numpy(v) for k, v in
             numeric_batch(collate_fn([data, data], buckets=(16,))).items()}
    B, N = batch["residue_mask"].shape
    noise = jax_draws(jax.random.split(key)[1], B, N, steps)
    pos, logits = P.sample_ddim(net2, batch, steps, 0.0, 0.5, noise=noise)
    n = data["num_atoms"] + data["num_residues"]
    for row, (w_pos, w_logits) in enumerate(want):
        np.testing.assert_allclose(pos[row, :n].numpy(), w_pos, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(logits[row, :n].numpy(), w_logits, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "ddim_parallel"])
def test_two_replica_runner_matches_one_device(sampler):
    """The port's runner with a 2-replica mesh against the same runner on one
    device at one seed: the draws stay global, the rows split."""
    from protein_redesign_tpu_torch.cli.common import SamplingRunner

    cfg = ModelConfig(**TINY, num_steps=8)
    net, _ = _replicated(cfg, perturbed_params(cfg, seed=6, scale=0.1))
    kw = dict(buckets=(16,), mask_prob=0.5, sampler=sampler, ddim_steps=4, window=4, ptol=0.0)
    datas = [_complex()] * 4
    one = SamplingRunner(net, "cpu", batch_size=2, **kw).run(datas, seed=3)
    two_runner = SamplingRunner(net, "cpu", batch_size=1, mesh=M.make_mesh(TWO_CPUS), **kw)
    # the batch floor rises to the data axis (not under ddim_parallel)
    assert two_runner.batch_size == (1 if sampler == "ddim_parallel" else 2)
    if sampler == "ddim_parallel":
        two_runner.batch_size = 2
    two = two_runner.run(datas, seed=3)
    for (p1, l1), (p2, l2) in zip(one, two):
        np.testing.assert_allclose(p2, p1, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(l2, l1, atol=1e-5, rtol=1e-5)
    launches = two_runner.net.launches
    assert len(launches) == 2 and not any(launches)  # the plain versions ran on the CPU


def test_runner_pads_groups_to_the_data_axis():
    """3 complexes at batch 2 over 2 replicas: the second group is padded to
    2 rows and its copy dropped, as the JAX runner does."""
    from protein_redesign_tpu_torch.cli.common import SamplingRunner

    cfg = ModelConfig(**TINY, num_steps=4)
    net, _ = _replicated(cfg, perturbed_params(cfg, seed=6, scale=0.1))
    runner = SamplingRunner(net, "cpu", batch_size=2, mask_prob=0.5, buckets=(16,),
                            mesh=M.make_mesh(TWO_CPUS))
    results = runner.run([_complex()] * 3, seed=1)
    assert len(results) == 3 and [t[1] for t in runner.timings] == [2, 2]


def test_picard_window_over_two_replicas_matches_jax_mesh():
    """``test_paratime.py``'s window-sharded setup (bucket 32, S = 8, window
    8, tol 0) with ``test_torch_paratime.py``'s perturbed weights: the
    port's window split 4 + 4 over two replicas against JAX's window sharded
    over a (2, 1) mesh, and against the port on one device."""
    from __graft_entry__ import _make_batch

    cfg = ModelConfig(**TINY, num_steps=32)
    params = perturbed_params(cfg, seed=2, scale=0.1)
    batch = _make_batch(4, 12, 32, esm_dim=16)
    key, S, W = jax.random.PRNGKey(7), 8, 8
    model = ProteinReDiffModel(JaxModelConfig(**TINY, num_steps=32))
    mesh = jax_make_mesh(jax.devices()[:2], (2, 1))
    j_pos, j_logits, j_stats = jax.jit(lambda p, b, k: jax_parallel(
        model, p, b, k, ddim_steps=S, window=W, tol=0.0, mask_prob=0.3, mesh=mesh))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, key)

    net, net2 = _replicated(cfg, params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    B, N = batch["residue_mask"].shape
    noise = sampler_draws(key, B, N, S, cfg, "ddim")
    pos, logits, stats = PT.sample_ddim_parallel(net2, tb, S, W, 0.0, 0.3, noise=noise)
    np.testing.assert_allclose(pos.numpy(), np.asarray(j_pos), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=1e-4)
    assert stats["iterations"] == int(j_stats["iterations"]) <= 2 * S + 2
    pos1, logits1, stats1 = PT.sample_ddim_parallel(net, tb, S, W, 0.0, 0.3, noise=noise)
    np.testing.assert_allclose(pos.numpy(), pos1.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(logits.numpy(), logits1.numpy(), atol=1e-5, rtol=1e-5)
    assert stats == stats1

    with pytest.warns(UserWarning, match="window=3 is not a multiple of the mesh data axis"):
        PT.sample_ddim_parallel(net2, tb, 2, 3, 0.0, 0.3, noise=sampler_draws(key, B, N, 2, cfg,
                                                                               "ddim"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        PT.sample_ddim_parallel(net2, tb, 2, 2, 0.0, 0.3, noise=sampler_draws(key, B, N, 2, cfg,
                                                                               "ddim"))


# -- training, read after the sampling tests so its background run overlaps them --


def test_train_step_on_two_ranks_matches_jax_mesh(background):
    """Two gloo ranks, one row of each micro-batch apiece, against JAX's
    step on a (2, 1) mesh; both ranks end with the same bits."""
    cfg = TRAIN_NET_CFG
    assert cfg.loss_mode == "reference" and TRAIN_CFG.gradient_clip_norm > 0
    got, j_metrics, j_state = background["train_step"].result(timeout=600)
    assert got[0]["digest"] == got[1]["digest"]
    for name in ("params", "ema", "mu", "nu"):
        for k, v in got[0][name].items():
            assert torch.equal(v, got[1][name][k]), f"{name} {k} differs between the ranks"
    assert got[0]["metrics"] == got[1]["metrics"]
    for i, (m, jm) in enumerate(zip(got[0]["metrics"], j_metrics)):
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(m[name], jm[name], rtol=1e-5, err_msg=f"step {i} {name}")
        assert jm["grad_norm"] > TRAIN_CFG.gradient_clip_norm  # the clip acts
    assert got[0]["step"] == int(j_state.step)
    adam = _adam(j_state.opt_state)
    expected = {
        "params": state_dict_from_jax(_tree(j_state.params), cfg),
        "ema": state_dict_from_jax(_tree(j_state.ema_params), cfg),
        "mu": state_dict_from_jax(_tree(adam.mu), cfg),
        "nu": state_dict_from_jax(_tree(adam.nu), cfg),
    }
    for what, tensors in expected.items():
        for name, want in tensors.items():
            if name not in got[0][what]:
                continue  # the EMA copy's buffers are the net's
            np.testing.assert_allclose(got[0][what][name].numpy(), want.numpy(),
                                       atol=0.0 if what == "nu" else 1e-5, rtol=1e-4,
                                       err_msg=f"{what} {name}")


# -- the train CLI on two CPU ranks ---------------------------------------------

CLI_FLAGS = [
    "--buckets", "16,24", "--esm_dim", "16", "--time_dim", "8", "--dist_dim", "8",
    "--single_dim", "16", "--pair_dim", "8", "--head_dim", "4", "--num_heads", "2",
    "--num_blocks", "1", "--num_steps", "4", "--dtype", "float32", "--warmup_steps", "2",
    "--log_every_steps", "1", "--val_every_steps", "0", "--device", "cpu", "--seed", "3",
]
# Runs the train CLI; every process that imports this file (the spawned
# ranks re-import it as __mp_main__) reports at exit what it imported.
CLI_SCRIPT = """import atexit, os, sys
def report():  # one write: the ranks share a stdout, and print() writes in pieces
    loaded = sorted(m for m in ("jax", "flax", "protein_redesign_tpu") if m in sys.modules)
    sys.stdout.write(f"modules {os.getpid()} {loaded}\\n")
    sys.stdout.flush()
atexit.register(report)
if __name__ == "__main__":
    from protein_redesign_tpu_torch.cli.train import main
    main(sys.argv[1:])
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "PRD_"))}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="2", **extra)
    return env


def _write_mini_data(data_dir: Path) -> None:
    """``test_train_cli.py``'s mini dataset, written with the port's
    featurization (four training complexes, one validation one)."""
    from protein_redesign_tpu_torch.chem.mol import mol_from_smiles, update_mol_positions
    from protein_redesign_tpu_torch.chem.protein import protein_from_sequence
    from protein_redesign_tpu_torch.data.dataset import save_complex_cache
    from protein_redesign_tpu_torch.data.featurize import ligand_to_data, protein_to_data

    rng = np.random.RandomState(0)
    data_dir.mkdir(parents=True)
    for split, names in {"train": ["t1", "t2", "t3", "t4"], "val": ["v1"]}.items():
        (data_dir / f"PRD_{split}_pdb_ids").write_text("\n".join(names) + "\n")
        for name in names:
            mol = update_mol_positions(mol_from_smiles("CCO"), rng.randn(3, 3).astype(np.float32))
            n_res = int(rng.randint(5, 9))
            prot = protein_from_sequence("ACDEFGHIKLMN"[:n_res])
            prot.atom_pos[:, 1] = rng.randn(n_res, 3)
            esm = rng.randn(n_res, 16).astype(np.float32)
            save_complex_cache(data_dir / "PDB_processed_cache", name,
                               {**ligand_to_data(mol), **protein_to_data(prot, residue_esm=esm)})


def _run(argv, **env):
    proc = subprocess.run(argv, env=_env(**env), cwd=REPO, text=True, timeout=300,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    assert proc.returncode == 0, proc.stdout
    return proc.stdout


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """The module's runs that take processes or long compiles, started with
    its first test on threads of their own so that they overlap each other
    and the tests' JAX compiles: the 2-rank train step and its JAX
    counterpart, and the train CLI's multi-rank runs; the tests read their
    results."""
    from concurrent.futures import ThreadPoolExecutor

    root = tmp_path_factory.mktemp("cli")
    _write_mini_data(root / "data")
    script = root / "train_cli.py"
    script.write_text(CLI_SCRIPT)
    common = [sys.executable, str(script), "--data_dir", str(root / "data"), *CLI_FLAGS]

    def spawned():
        save_dir = root / "spawned"
        argv = [*common, "--save_dir", str(save_dir), "--batch_size", "2", "--num_devices", "2"]
        first = _run([*argv, "--max_steps", "2"])
        metrics, ckpts = _metrics(save_dir), sorted(p.name for p in (save_dir / "checkpoints").iterdir())
        resumed = _run([*argv, "--max_steps", "3", "--trained_ckpt", str(save_dir / "checkpoints")])
        return first, metrics, ckpts, resumed, _metrics(save_dir)

    def cluster():
        save_dir = root / "cluster"
        argv = [*common, "--save_dir", str(save_dir), "--batch_size", "1", "--max_steps", "2"]
        port = str(M.free_port())
        with ThreadPoolExecutor(2) as pool:
            outs = list(pool.map(lambda i: _run(
                argv, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
                JAX_PROCESS_ID=str(i)), range(2)))
        return outs, _metrics(save_dir), sorted(p.name for p in (save_dir / "checkpoints").iterdir())

    def signalled():
        """SIGTERM to the CLI's process once both ranks have taken step 1."""
        save_dir = root / "signalled"
        proc = subprocess.Popen([*common, "--save_dir", str(save_dir), "--batch_size", "2",
                                 "--num_devices", "2", "--max_steps", "100000"], env=_env(),
                                cwd=REPO, text=True, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        watchdog = threading.Timer(300, proc.kill)
        watchdog.start()
        out = ""
        try:
            for line in proc.stdout:
                out += line
                if all(f"[rank {r}] step 1: loss=" in out for r in range(2)):
                    proc.send_signal(signal.SIGTERM)
                    break
            out += proc.stdout.read()
            return proc.wait(), out, save_dir
        finally:
            watchdog.cancel()

    (root / "step").mkdir()
    pool = ThreadPoolExecutor(4)
    runs = {"train_step": pool.submit(_train_step_runs, root / "step"),
            "spawned": pool.submit(spawned), "cluster": pool.submit(cluster),
            "signalled": pool.submit(signalled)}
    yield runs
    pool.shutdown(wait=True)


def _lines(out, pattern):
    return [ln for ln in out.splitlines() if re.search(pattern, ln)]


def _no_jax(outs, processes):
    reports = [m for out in outs for m in re.findall(r"modules \d+ (\[[^\]]*\])", out)]
    assert reports == ["[]"] * processes, reports


def _metrics(save_dir):
    import json

    return [json.loads(ln) for ln in (save_dir / "metrics.jsonl").read_text().splitlines()]


def test_train_cli_num_devices_two_cpu_ranks(background):
    """``--num_devices 2``: two spawned ranks, then a resume on both."""
    out, metrics, ckpts, resumed, metrics2 = background["spawned"].result(timeout=600)
    _no_jax([out, resumed], 6)  # each run: the CLI's process and its two ranks
    assert "mesh: {'data': 2, 'model': 1} on cpu" in out
    # the ranks share one stdout, so their lines are found anywhere in it
    steps = [re.findall(rf"\[rank {r}\] step (\d+): loss=(\S+)", out) for r in range(2)]
    assert len(steps[0]) == 2 and sorted(steps[0]) == sorted(steps[1])
    checksums = re.findall(r"\[rank \d\] parameter checksum ([0-9a-f]+), equal on the 2 ranks",
                           out)
    assert len(checksums) == 2 and len(set(checksums)) == 1
    rows = [m for m in metrics if "train_loss" in m]
    assert [m["step"] for m in rows] == [1, 2]
    assert all(m["grad_bytes"] > 0 and m["allreduce_seconds"] > 0 for m in rows)
    assert ckpts == ["2"]
    for r in range(2):
        assert re.search(rf"\[rank {r}\] resumed from .* at step 2", resumed), resumed
        assert re.search(rf"\[rank {r}\] step 3: loss=", resumed), resumed
    assert [m["step"] for m in metrics2 if "train_loss" in m] == [1, 2, 3]


def test_train_cli_jax_cluster_variables(background):
    """Two processes joined by the JAX CLI's cluster variables, one row of
    the global batch each, pinned to one bucket."""
    outs, metrics, ckpts = background["cluster"].result(timeout=600)
    _no_jax(outs, 2)
    for out in outs:
        assert "mesh: {'data': 2, 'model': 1} on cpu" in out
        assert "multi-host fixed bucket: 16" in out
    steps = [_lines(out, r"^step \d+: loss=") for out in outs]
    assert len(steps[0]) == 2 and steps[0] == steps[1]
    finals = [_lines(out, r"final val_loss=") for out in outs]
    assert finals[0] and finals[0] == finals[1]
    assert [m["step"] for m in metrics if "train_loss" in m] == [1, 2]
    assert ckpts == ["2"]


def test_train_cli_sigterm_reaches_both_ranks(background):
    """SIGTERM to the ``--num_devices 2`` CLI's process: the process that
    spawned the ranks passes it on, both ranks stop at the same step, rank 0
    checkpoints it without validation, and the CLI exits 0 once both ranks
    have exited."""
    from protein_redesign_tpu_torch.utils.checkpoint import read_state

    code, out, save_dir = background["signalled"].result(timeout=600)
    assert code == 0, out
    stops = [re.findall(rf"\[rank {r}\] interrupted at step (\d+); checkpoint saved", out)
             for r in range(2)]
    assert len(stops[0]) == 1 and stops[0] == stops[1], out
    step = int(stops[0][0])
    assert sorted(p.name for p in (save_dir / "checkpoints").iterdir()) == [str(step)]
    assert read_state(save_dir / "checkpoints" / str(step)) == {
        "step": step, "ema_updates": step, "val_loss": None}
    _no_jax([out], 3)
