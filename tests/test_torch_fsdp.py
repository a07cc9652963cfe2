"""FSDP of the port (``--mesh_shape d,m``, ``parallel/fsdp.py``) against the
JAX package's (d, m) meshes on the CPU (the conftest's 8 virtual devices):

- ``shard_axes`` against JAX's ``_param_spec`` for every leaf of the
  paper-width tree (``jax.eval_shape``, no compile) at m = 2, 4 and 8,
  through the port's layout of each tensor;
- rank r at mesh position (r // m, r % m), JAX's device array at (1, 2),
  (2, 2) and (4, 2);
- the train step on 2 gloo ranks at (1, 2) and 4 at (2, 2) against JAX's
  step with its params and EMA sharded over 'model' (``test_training.py:
  73-98``), from one start state, 2 steps of 2 accumulated micro-batches
  with the clip active and JAX's draws injected: loss and grad_norm at 1e-5
  relative, the gathered parameters, EMA and moments at
  ``test_torch_train_step.py``'s tolerances, and each rank's shards;
- the train CLI with ``--num_devices 2 --mesh_shape 1,2 --device cpu``
  resuming a ``--mesh_shape 2,1`` checkpoint, its checkpoint whole and
  loading on one rank, and the generate CLI sampling from it.

The spawned runs start with the module's first test and overlap the JAX
compiles.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402
from test_torch_multidevice import CLI_FLAGS, _env, _metrics, _write_mini_data  # noqa: E402
from test_torch_net import make_batch  # noqa: E402
from test_torch_selfcond import train_draws  # noqa: E402
from test_torch_train_step import CFG as TRAIN_NET_CFG  # noqa: E402
from test_torch_train_step import TRAIN_CFG, _adam, _start_state, _tree  # noqa: E402

from protein_redesign_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from protein_redesign_tpu.models.prdiff import ProteinReDiffModel  # noqa: E402
from protein_redesign_tpu.parallel.mesh import _param_spec  # noqa: E402
from protein_redesign_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from protein_redesign_tpu.parallel.mesh import param_sharding  # noqa: E402
from protein_redesign_tpu.parallel.train_step import make_train_step as jax_train_step  # noqa: E402
from protein_redesign_tpu_torch.config import ModelConfig  # noqa: E402
from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet  # noqa: E402
from protein_redesign_tpu_torch.parallel import fsdp  # noqa: E402
from protein_redesign_tpu_torch.parallel import mesh as M  # noqa: E402
from protein_redesign_tpu_torch.utils.weights import (  # noqa: E402
    state_dict_from_jax,
    train_state_from_jax,
)

REPO = Path(__file__).resolve().parents[1]
SHAPES = {(1, 2): 2, (2, 2): 4}


def _jax_steps(j_state, batch, keys, shape):
    """JAX's step on a ``shape`` mesh, params and EMA sharded as its train
    CLI shards them, the micro-batches' rows over 'data'."""
    d, m = shape
    mesh = jax_make_mesh(jax.devices()[:d * m], shape)
    rep = NamedSharding(mesh, PartitionSpec())
    psh = param_sharding(mesh, j_state.params)
    state_sh = jax.tree_util.tree_map(lambda _: rep, j_state).replace(params=psh, ema_params=psh)
    rows = NamedSharding(mesh, PartitionSpec(None, "data"))
    step = jax.jit(jax_train_step(ProteinReDiffModel(TRAIN_NET_CFG.replace(remat=False)),
                                  TRAIN_CFG),
                   in_shardings=(state_sh, {k: rows for k in batch}, rep),
                   out_shardings=(state_sh, rep))
    j_state = jax.device_put(j_state, state_sh)
    jb = {k: jax.device_put(jnp.asarray(v), rows) for k, v in batch.items()}
    metrics = []
    for key in keys:
        j_state, out = step(j_state, jb, key)
        metrics.append({k: float(v) for k, v in out.items()})
    return metrics, j_state


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """Started with the module's first test: the (1, 2) and (2, 2) rank
    runs, and the train CLI's runs (on a thread of their own)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch.multiprocessing as mp

    from protein_redesign_tpu_torch.parallel.train_step import make_train_state
    from protein_redesign_tpu_torch.utils.checkpoint import CheckpointManager
    from test_torch_mesh_ranks import fsdp_rank

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
    keys = [jax.random.PRNGKey(100 + i) for i in range(2)]
    inputs = {
        "cfg": cfg, "train_cfg": TRAIN_CFG,
        "micro": [{k: torch.from_numpy(v) for k, v in mb.items()} for mb in micro],
        "noises": [[train_draws(k, B, N, cfg) for k in jax.random.split(key, 2)]
                   for key in keys],
    }
    runs = {}
    for shape, world in SHAPES.items():
        workdir = tmp_path_factory.mktemp(f"fsdp{shape[0]}x{shape[1]}")
        CheckpointManager(workdir / "start").save(state)
        torch.save(inputs, workdir / "inputs.pt")
        runs[shape] = (mp.spawn(fsdp_rank, args=(world, M.free_port(), str(workdir), *shape),
                                nprocs=world, join=False), workdir, world)

    root = tmp_path_factory.mktemp("cli")
    _write_mini_data(root / "data")
    pool = ThreadPoolExecutor(1)
    cli = pool.submit(_cli_runs, root)

    def result(shape):
        procs, workdir, world = runs[shape]
        while not procs.join():
            pass
        return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]

    yield {"result": result, "j_state": j_state, "micro": micro, "keys": keys, "cli": cli,
           "cfg": cfg}
    for procs, _, _ in runs.values():
        while not procs.join():
            pass
    pool.shutdown()


def _run(argv):
    proc = subprocess.run(argv, env=_env(PRD_DISABLE_ESM="1"), cwd=REPO, text=True,
                          timeout=300, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    assert proc.returncode == 0, proc.stdout
    return proc.stdout


def _cli_runs(root: Path):
    """(2, 1) for a step, then (1, 2) resuming it for another, then the
    generate CLI on the (1, 2) run's checkpoint."""
    train = [sys.executable, "-m", "protein_redesign_tpu_torch.cli.train", "--data_dir",
             str(root / "data"), *CLI_FLAGS, "--batch_size", "2", "--num_devices", "2"]
    first = _run([*train, "--save_dir", str(root / "dp"), "--max_steps", "1",
                  "--mesh_shape", "2,1"])
    second = _run([*train, "--save_dir", str(root / "fsdp"), "--max_steps", "2",
                   "--mesh_shape", "1,2", "--trained_ckpt", str(root / "dp" / "checkpoints")])
    gen = _run([sys.executable, "-m", "protein_redesign_tpu_torch.cli.generate", "-c",
                str(root / "fsdp" / "checkpoints"), "-o", str(root / "gen"), "-p", "ACDEFGHIK",
                "-l", "CCO", "-n", "2", "--num_steps", "4", "--device", "cpu"])
    return first, second, gen, _metrics(root / "fsdp"), root


# -- the sharding rule and the mesh ----------------------------------------------


def _varying_axis(t: torch.Tensor):
    axes = [k for k in range(t.dim()) if t.shape[k] > 1 and bool((t.diff(dim=k) != 0).any())]
    assert len(axes) <= 1
    return axes[0] if axes else None


@pytest.mark.parametrize("m", [2, 4, 8])
def test_shard_axes_follow_jax_param_spec_at_paper_width(m):
    """JAX's spec of each leaf, encoded as a ramp along its sharded axis,
    carried through ``state_dict_from_jax``: the port shards each tensor
    along the axis the ramp lands on, and replicates the rest."""
    cfg = ModelConfig()
    batch = make_batch(B=1, n_atoms=5, n_res=9, bucket=16)
    batch["residue_esm"] = np.zeros((1, 16, cfg.esm_dim), np.float32)
    model = ProteinReDiffModel(JaxModelConfig())
    shapes = jax.eval_shape(lambda: model.init_params(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()}))

    def ramp(leaf):
        spec = _param_spec(tuple(leaf.shape), m)
        axis = next((i for i, a in enumerate(spec) if a == "model"), None)
        if axis is None:
            return np.zeros(leaf.shape, np.float32)
        view = [1] * len(leaf.shape)
        view[axis] = leaf.shape[axis]
        return np.broadcast_to(np.arange(leaf.shape[axis], dtype=np.float32).reshape(view),
                               leaf.shape)

    encoded = state_dict_from_jax(jax.tree_util.tree_map(ramp, shapes), cfg)
    with torch.device("meta"):
        net = ProteinReDiffNet(cfg)
    got = fsdp.shard_axes(net, m)
    assert set(got) <= set(encoded)
    assert any(a is not None for a in got.values())
    for name, axis in got.items():
        assert axis == _varying_axis(encoded[name]), name


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (4, 2)])
def test_mesh_positions_match_jax_device_array(shape):
    d, m = shape
    n = d * m
    want = jax_make_mesh(jax.devices()[:n], shape).devices
    mesh = M.make_mesh([f"cuda:{i}" for i in range(n)], shape)
    assert [[dev.index for dev in row] for row in mesh.devices] == [
        [dev.id for dev in row] for row in want]
    assert [M.mesh_position(r, m) for r in range(n)] == [
        tuple(int(i) for i in np.argwhere(want == dev)[0]) for dev in jax.devices()[:n]]
    with pytest.raises(ValueError, match=re.escape(f"mesh_shape {(d, m + 1)} != {n} devices")):
        M.make_mesh(["cpu"] * n, (d, m + 1))


def test_param_spec_edges():
    """The rule itself: the largest axis m divides with at least 2 m, ties
    to the first axis (a square kernel's flax in-dim), 1-D leaves whole."""
    assert fsdp.param_spec((64, 64), 2) == 0
    assert fsdp.param_spec((3, 64), 2) == 1
    assert fsdp.param_spec((64, 6), 4) == 0
    assert fsdp.param_spec((5, 7), 2) is None
    assert fsdp.param_spec((4, 2), 4) is None
    assert fsdp.param_spec((512,), 2) is None
    assert fsdp.param_spec((64, 64), 1) is None
    for shape in ((64, 64), (3, 64), (5, 7), (128, 8, 4)):
        spec = _param_spec(shape, 2)
        want = next((i for i, a in enumerate(spec) if a == "model"), None)
        assert fsdp.param_spec(shape, 2) == want


# -- the train step ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_fsdp_train_step_matches_jax_mesh(background, shape):
    cfg = background["cfg"]
    micro = background["micro"]
    batch = {k: np.stack([mb[k] for mb in micro]) for k in micro[0]}
    j_metrics, j_state = _jax_steps(background["j_state"], batch, background["keys"], shape)
    got = background["result"](shape)
    d, m = shape
    assert [g["position"] for g in got] == [M.mesh_position(r, m) for r in range(d * m)]
    assert len({g["digest"] for g in got}) == 1
    for r, g in enumerate(got):
        assert g["metrics"] == got[0]["metrics"]
        for what in ("params", "ema", "mu", "nu"):
            for k, v in g[what].items():
                assert torch.equal(v, got[0][what][k]), f"rank {r} {what} {k}"
    for i, (mt, jm) in enumerate(zip(got[0]["metrics"], j_metrics)):
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(mt[name], jm[name], rtol=1e-5, err_msg=f"step {i} {name}")
        assert jm["grad_norm"] > TRAIN_CFG.gradient_clip_norm  # the clip acts
    assert got[0]["step"] == int(j_state.step)
    # each rank holds its shards: the whole shape with the sharded axis / m
    net = ProteinReDiffNet(cfg)
    spec = fsdp.shard_axes(net, m)
    assert any(a is not None for a in spec.values())
    for name, p in net.named_parameters():
        want = list(p.shape)
        if spec[name] is not None:
            want[spec[name]] //= m
        for g in got:
            assert g["shard_shapes"][name] == tuple(want), name
            assert g["moment_shapes"][name] == tuple(want), name
            assert g["ema_shapes"][name] == tuple(want), name
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


# -- the train CLI -------------------------------------------------------------------


def test_train_cli_model_axis_resumes_across_layouts_and_samples(background):
    from protein_redesign_tpu_torch.parallel.train_step import make_train_state
    from protein_redesign_tpu_torch.utils.checkpoint import load_train_state, read_config, step_dir

    first, second, gen, metrics, root = background["cli"].result(timeout=600)
    assert "mesh: {'data': 2, 'model': 1} on cpu" in first
    assert "mesh: {'data': 1, 'model': 2} on cpu" in second
    for rank in (0, 1):
        assert f"[rank {rank}] resumed from" in second and "at step 1" in second
        assert re.search(rf"\[rank {rank}\] FSDP over 2 ranks: \d+ of \d+ parameter", second)
    digests = set(re.findall(r"parameter checksum ([0-9a-f]+), equal on the 2 ranks", second))
    assert len(digests) == 1
    losses = [re.findall(rf"\[rank {r}\] step 2: loss=(\S+)", second) for r in (0, 1)]
    assert losses[0] == losses[1] and len(losses[0]) == 1
    assert [row["step"] for row in metrics if "train_loss" in row] == [2]
    # the checkpoint holds whole tensors: it resumes on one rank
    ckpt = step_dir(root / "fsdp" / "checkpoints")
    cfg = read_config(ckpt)
    state = make_train_state(ProteinReDiffNet(cfg))
    load_train_state(ckpt, state)
    assert state.step == 2
    assert "ACDEFGHIK" in gen or any((root / "gen").rglob("*.pdb"))
    assert any((root / "gen").rglob("*.pdb"))
