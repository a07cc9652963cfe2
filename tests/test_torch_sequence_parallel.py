"""Sequence parallelism of the port (``sequence_parallel`` inside
``parallel.mesh.on_mesh``, ``models/denoiser.py``) against the JAX package on
the CPU (the conftest's 8 virtual devices), at ``test_sampling_mesh.py``'s
tiny widths:

- the Denoiser forward on 2 and 4 spawned gloo ranks, ``outer_factored`` off
  and on, and N = 18 over 4 ranks (the last block short), against JAX's
  Denoiser with ``sequence_parallel`` under ``with mesh`` on (4, 2) and
  (2, 4) meshes, at ``test_sampling_mesh.py``'s 1e-5;
- the train step on 2 ranks (``attn_chunk=8, remat=True``,
  ``test_training.py:122-124``; 2 micro-batches, the clip active, JAX's
  draws injected) against JAX's unsharded step from one start state: loss
  and grad_norm at 1e-5 relative, the parameters after at
  ``test_torch_train_step.py``'s tolerances, and no kernel launch;
- without a mesh context the forward raises, as JAX's sharding constraint
  does; on a model axis of 1 it equals JAX's output.

The spawned runs start with the module's first test and overlap the JAX
compiles.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_net import make_batch  # noqa: E402
from test_torch_selfcond import train_draws  # noqa: E402
from test_torch_train_step import CFG as TRAIN_NET_CFG  # noqa: E402
from test_torch_train_step import TRAIN_CFG, _adam, _start_state, _tree  # noqa: E402

from protein_redesign_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from protein_redesign_tpu.models.denoiser import Denoiser as JaxDenoiser  # noqa: E402
from protein_redesign_tpu.models.prdiff import ProteinReDiffModel  # noqa: E402
from protein_redesign_tpu.parallel.mesh import make_mesh as jax_make_mesh  # noqa: E402
from protein_redesign_tpu.parallel.train_step import make_train_step as jax_train_step  # noqa: E402
from protein_redesign_tpu_torch.config import ModelConfig  # noqa: E402
from protein_redesign_tpu_torch.models.denoiser import Denoiser  # noqa: E402
from protein_redesign_tpu_torch.parallel import mesh as M  # noqa: E402
from protein_redesign_tpu_torch.utils import weights as W  # noqa: E402

TINY = dict(esm_dim=16, time_dim=8, dist_dim=8, single_dim=16, pair_dim=8, head_dim=4,
            num_heads=2, num_blocks=2, num_steps=2, dtype="float32", remat=False)
# (model axis, outer_factored, N) of each forward case
FORWARDS = {2: [(False, 16), (True, 16)], 4: [(False, 16), (True, 16), (False, 18)]}


def _forward_case(factored: bool, N: int, seed: int):
    """JAX params (init, perturbed) and inputs of a Denoiser case, and the
    port's state dict of the same params."""
    cfg = JaxModelConfig(**TINY, outer_factored=factored)
    rng = np.random.RandomState(seed)
    B = 2
    single = rng.randn(B, N, cfg.single_dim).astype(np.float32)
    pair = rng.randn(B, N, N, cfg.pair_dim).astype(np.float32)
    mask = (rng.rand(B, N) > 0.2).astype(np.float32)
    params = JaxDenoiser(cfg).init(jax.random.PRNGKey(seed), jnp.asarray(single),
                                   jnp.asarray(pair), jnp.asarray(mask))["params"]
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.05 * rng.standard_normal(x.shape).astype(np.float32), params)
    sd = {}
    W._denoiser(sd, params, cfg.num_blocks, "")
    return cfg, params, (single, pair, mask), sd


def _jax_sp_forward(cfg, params, inputs, m):
    """JAX's sequence-parallel Denoiser under ``with mesh`` on (8 / m, m)."""
    mesh = jax_make_mesh(jax.devices(), (8 // m, m))
    sharded = JaxDenoiser(cfg.replace(sequence_parallel=True))
    with mesh:
        s, p = jax.jit(lambda prm: sharded.apply({"params": prm}, *map(jnp.asarray, inputs)))(
            params)
    return np.asarray(s), np.asarray(p)


def _port_cfg(cfg, **kw):
    return ModelConfig(**TINY, outer_factored=cfg.outer_factored, sequence_parallel=True, **kw)


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """The spawned runs, started with the module's first test: 2 ranks (the
    forward cases and the train step) and 4 ranks (the forward cases)."""
    import torch.multiprocessing as mp

    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
    from protein_redesign_tpu_torch.parallel.train_step import make_train_state
    from protein_redesign_tpu_torch.utils.checkpoint import CheckpointManager
    from test_torch_mesh_ranks import sp_rank

    cases = {m: [_forward_case(f, n, seed=10 * m + i) for i, (f, n) in enumerate(c)]
             for m, c in FORWARDS.items()}
    runs = {}
    for m, world_cases in cases.items():
        workdir = tmp_path_factory.mktemp(f"sp{m}")
        inputs = {"forwards": [
            {"cfg": _port_cfg(cfg), "state_dict": {k: v for k, v in sd.items()},
             "single": torch.from_numpy(x[0]), "pair": torch.from_numpy(x[1]),
             "mask": torch.from_numpy(x[2])}
            for cfg, _, x, sd in world_cases]}
        if m == 2:
            cfg = TRAIN_NET_CFG
            micro = [make_batch(B=2, seed=s) for s in (11, 12)]
            B, N = micro[0]["residue_mask"].shape
            j_state = _start_state(cfg)
            adam = _adam(j_state.opt_state)
            state = make_train_state(ProteinReDiffNet(cfg))
            W.train_state_from_jax(state, {
                "params": _tree(j_state.params), "ema_params": _tree(j_state.ema_params),
                "mu": _tree(adam.mu), "nu": _tree(adam.nu), "count": int(adam.count),
                "step": int(j_state.step), "ema_updates": int(j_state.ema_updates),
            })
            CheckpointManager(workdir / "sp_start").save(state)
            key = jax.random.PRNGKey(100)
            inputs["train"] = {
                "cfg": cfg.replace(sequence_parallel=True, attn_chunk=8, remat=True),
                "train_cfg": TRAIN_CFG,
                "micro": [{k: torch.from_numpy(v) for k, v in mb.items()} for mb in micro],
                "noises": [train_draws(k, B, N, cfg) for k in jax.random.split(key, 2)],
            }
            runs["train"] = (cfg, micro, j_state, key)
        torch.save(inputs, workdir / "sp_inputs.pt")
        procs = mp.spawn(sp_rank, args=(m, M.free_port(), str(workdir)), nprocs=m, join=False)
        runs[m] = (procs, workdir)

    def result(m):
        procs, workdir = runs[m]
        while not procs.join():
            pass
        return [torch.load(workdir / f"sp{m}_rank{r}.pt", weights_only=False) for r in range(m)]

    yield {"cases": cases, "result": result, "runs": runs}
    for m in FORWARDS:
        procs = runs[m][0]
        while not procs.join():
            pass


@pytest.mark.parametrize("m", [2, 4])
def test_sp_denoiser_forward_matches_jax_mesh(background, m):
    """Each case's output on every rank against JAX's sequence-parallel
    Denoiser on the mesh of the same model axis, at 1e-5."""
    for i, (cfg, params, inputs, _) in enumerate(background["cases"][m]):
        s_ref, p_ref = _jax_sp_forward(cfg, params, inputs, m)
        for rank, outs in enumerate(background["result"](m)):
            s, p = outs[i]
            np.testing.assert_allclose(s.numpy(), s_ref, atol=1e-5, rtol=1e-5,
                                       err_msg=f"case {i} rank {rank} single")
            np.testing.assert_allclose(p.numpy(), p_ref, atol=1e-5, rtol=1e-5,
                                       err_msg=f"case {i} rank {rank} pair")


def test_uneven_split_blocks():
    """N = 18 over 4 ranks: blocks of 5, the last 3, as JAX pads."""
    assert [M.sp_rows(18, M.MeshAxes(1, 4, 0, i)) for i in range(4)] == [
        (0, 5), (5, 10), (10, 15), (15, 18)]
    assert M.sp_rows(3, M.MeshAxes(1, 4, 0, 3)) == (3, 3)


def test_sp_train_step_matches_jax_unsharded(background):
    """Two ranks of one model group, the complex axis sharded (attn_chunk 8,
    remat): one step against JAX's unsharded step; both ranks equal, no
    kernel launched."""
    cfg, micro, j_state, key = background["runs"]["train"]
    batch = {k: np.stack([mb[k] for mb in micro]) for k in micro[0]}
    j_step = jax.jit(jax_train_step(ProteinReDiffModel(cfg.replace(remat=False)), TRAIN_CFG))
    j_state, j_metrics = j_step(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    background["result"](2)
    workdir = background["runs"][2][1]
    got = [torch.load(workdir / f"sp_train_rank{r}.pt", weights_only=False) for r in range(2)]
    for name in ("loss", "grad_norm"):
        assert got[0][name] == got[1][name]
        np.testing.assert_allclose(got[0][name], float(j_metrics[name]), rtol=1e-5, err_msg=name)
    assert float(j_metrics["grad_norm"]) > TRAIN_CFG.gradient_clip_norm  # the clip acts
    assert not any(got[0]["launches"].values())
    want = W.state_dict_from_jax(_tree(j_state.params), cfg)
    for name, t in got[0]["params"].items():
        assert torch.equal(t, got[1]["params"][name]), name
        if name in want:
            np.testing.assert_allclose(t.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4,
                                       err_msg=name)


def test_no_mesh_context_raises_and_model_axis_one_matches_jax():
    """Without ``on_mesh`` the forward raises RuntimeError naming the
    context; on a (1, 1) mesh it runs the SP plan on whole tensors and
    equals JAX's output (on the (8, 1) mesh, 1e-5)."""
    cfg, params, inputs, sd = _forward_case(True, 16, seed=3)
    den = Denoiser(_port_cfg(cfg))
    den.load_state_dict(sd)
    t = [torch.from_numpy(x) for x in inputs]
    with pytest.raises(RuntimeError, match="on_mesh"):
        den(*t)
    with torch.no_grad(), M.on_mesh(M.mesh_axes(1, 1)):
        s, p = den(*t)
    s_ref, p_ref = _jax_sp_forward(cfg, params, inputs, 1)
    np.testing.assert_allclose(s.numpy(), s_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(p.numpy(), p_ref, atol=1e-5, rtol=1e-5)
