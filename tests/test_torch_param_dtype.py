"""Parameters in bfloat16 (``ModelConfig.param_dtype``) against the JAX
package, at ``test_torch_net.py``'s tiny widths:

- which leaves are bf16: JAX's ``init`` tree (``jax.eval_shape``) carried
  through the convert name map onto the port's parameters (the affine
  LayerNorms stay f32 in both);
- the net's forward on the same bf16 weights with ``dtype`` f32 (1e-4, as
  ``test_torch_net.py``: the same f32 math on the same values) and bf16
  (2e-2 relative norm, ``test_torch_denoiser.py``'s bf16 tolerance);
- one train step of 2 micro-batches (clip active, JAX's draws) from one
  bf16 start state: loss and grad_norm at 2e-2 relative (the gradients are
  bf16, summed in another order), the EMA in the parameters' dtype and
  Adam's moments in the dtype of JAX's optax state;
- a checkpoint written by the train CLI with ``--param_dtype bfloat16``
  keeps the dtypes and samples in the generate CLI.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_net import TINY, make_batch, perturbed_params  # noqa: E402
from test_torch_selfcond import train_draws  # noqa: E402
from test_torch_train_cli import TINY_FLAGS  # noqa: E402
from test_torch_train_step import TRAIN_CFG, _adam, _tree  # noqa: E402
from test_train_cli import mini_data  # noqa: E402,F401

from protein_redesign_tpu.config import ModelConfig as JaxModelConfig  # noqa: E402
from protein_redesign_tpu.models.prdiff import ProteinReDiffModel  # noqa: E402
from protein_redesign_tpu.parallel.train_step import TrainState, make_optimizer  # noqa: E402
from protein_redesign_tpu.parallel.train_step import make_train_step as jax_train_step  # noqa: E402
from protein_redesign_tpu_torch.config import ModelConfig  # noqa: E402
from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet  # noqa: E402
from protein_redesign_tpu_torch.parallel.train_step import (  # noqa: E402
    make_train_state,
    make_train_step,
)
from protein_redesign_tpu_torch.utils.weights import (  # noqa: E402
    state_dict_from_jax,
    train_state_from_jax,
)

BF16 = dict(param_dtype="bfloat16")


def _jax_dtypes(cfg):
    """JAX's init tree of ``cfg`` as shapes and dtypes, without a compile."""
    batch = make_batch()
    return jax.eval_shape(lambda: ProteinReDiffModel(cfg).init_params(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()}))


def _bf16_params(cfg, seed):
    """``perturbed_params`` with each leaf in the dtype of JAX's init tree."""
    params = perturbed_params(ModelConfig(**{**TINY, "param_dtype": "float32",
                                             "self_cond": cfg.self_cond}), seed=seed)
    return jax.tree_util.tree_map(lambda p, s: jnp.asarray(p, s.dtype), params, _jax_dtypes(cfg))


def test_leaf_dtypes_match_jax_init_tree():
    """Every leaf's dtype through the convert name map (a leaf encoded as
    ones where JAX's is bf16, zeros where f32)."""
    cfg = JaxModelConfig(**TINY, **BF16, self_cond=True)
    encoded = state_dict_from_jax(jax.tree_util.tree_map(
        lambda s: np.full(s.shape, float(s.dtype == jnp.bfloat16), np.float32),
        _jax_dtypes(cfg)), cfg)
    net = ProteinReDiffNet(ModelConfig(**TINY, **BF16, self_cond=True))
    kinds = set()
    for name, p in net.named_parameters():
        flag = encoded[name]
        assert bool(flag.min() == flag.max()), name
        assert (p.dtype == torch.bfloat16) == bool(flag.max() == 1.0), name
        assert p.dtype in (torch.bfloat16, torch.float32)
        kinds.add(p.dtype)
    assert kinds == {torch.bfloat16, torch.float32}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    cfg = JaxModelConfig(**{**TINY, "dtype": dtype}, **BF16)
    params = _bf16_params(cfg, seed=2)
    batch = make_batch(seed=2)
    rng = np.random.RandomState(12)
    B, N = batch["residue_mask"].shape
    z = rng.randn(B, N, 3).astype(np.float32)
    seq_t = rng.randn(B, N, 21).astype(np.float32)
    mask = batch["atom_mask"] + batch["residue_mask"]
    t = rng.randint(0, cfg.num_steps, (B,))
    j_noise, j_seq = ProteinReDiffModel(cfg).apply(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(z),
        jnp.asarray(seq_t), jnp.asarray(mask), jnp.asarray(t, jnp.int32))
    net = ProteinReDiffNet(ModelConfig(**{**TINY, "dtype": dtype}, **BF16))
    net.load_state_dict(state_dict_from_jax(params, cfg))
    with torch.no_grad():
        noise, seq = net({k: torch.from_numpy(v) for k, v in batch.items()},
                         torch.from_numpy(z), torch.from_numpy(seq_t), torch.from_numpy(mask),
                         torch.from_numpy(t))
    for got, want in ((noise, j_noise), (seq, j_seq)):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        else:
            assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2


def test_train_step_matches_jax_with_bf16_params():
    cfg = JaxModelConfig(**TINY, **BF16, mask_prob=0.6, training_mode=True, warmup_steps=6,
                         learning_rate=1e-3, ema_decay=0.99)
    params = _bf16_params(cfg, seed=7)
    clip, adam, sched = make_optimizer(cfg, TRAIN_CFG).init(params)
    j_state = TrainState(step=jnp.int32(0), params=params, opt_state=(clip, adam, sched),
                         ema_params=params, ema_updates=jnp.int32(0))
    micro = [make_batch(B=2, seed=s) for s in (11, 12)]
    B, N = micro[0]["residue_mask"].shape
    net = ProteinReDiffNet(ModelConfig(**TINY, **BF16, mask_prob=0.6, training_mode=True,
                                       warmup_steps=6, learning_rate=1e-3, ema_decay=0.99))
    state = make_train_state(net)
    j_adam = _adam(j_state.opt_state)
    train_state_from_jax(state, {
        "params": _tree(params), "ema_params": _tree(params), "mu": _tree(j_adam.mu),
        "nu": _tree(j_adam.nu), "count": 0, "step": 0, "ema_updates": 0})
    key = jax.random.PRNGKey(40)
    batch = {k: jnp.asarray(np.stack([m[k] for m in micro])) for k in micro[0]}
    j_state, j_metrics = jax.jit(jax_train_step(ProteinReDiffModel(cfg), TRAIN_CFG))(
        j_state, batch, key)
    metrics = make_train_step(TRAIN_CFG)(
        state, [{k: torch.from_numpy(v) for k, v in m.items()} for m in micro],
        [train_draws(k, B, N, cfg) for k in jax.random.split(key, 2)])
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[name]), float(j_metrics[name]), rtol=2e-2,
                                   err_msg=name)
    j_adam = _adam(j_state.opt_state)
    j_mu = jax.tree_util.tree_leaves(j_adam.mu)
    assert {str(x.dtype) for x in j_mu} == {"bfloat16", "float32"}
    for p, q in zip(net.parameters(), state.ema.parameters()):
        assert q.dtype == p.dtype
        moments = state.optimizer.state[p]
        assert moments["exp_avg"].dtype == moments["exp_avg_sq"].dtype == p.dtype
    # JAX's optax moments take each parameter's dtype too
    leaves = jax.tree_util.tree_leaves(params)
    assert [x.dtype for x in j_mu] == [x.dtype for x in leaves]


def test_bf16_checkpoint_through_the_clis(mini_data, tmp_path, monkeypatch):  # noqa: F811
    from protein_redesign_tpu_torch.cli.generate import main as generate
    from protein_redesign_tpu_torch.cli.train import main as train
    from protein_redesign_tpu_torch.utils.checkpoint import load_weights

    save = tmp_path / "run"
    train(["--save_dir", str(save), "--data_dir", str(mini_data), *TINY_FLAGS,
           "--max_steps", "1", "--param_dtype", "bfloat16"])
    sd, cfg, step = load_weights(save / "checkpoints")
    assert cfg.param_dtype == "bfloat16" and step == 1
    net = ProteinReDiffNet(cfg)
    dtypes = {n: p.dtype for n, p in net.named_parameters()}
    assert {n: sd[n].dtype for n in dtypes} == dtypes
    assert torch.bfloat16 in dtypes.values()
    monkeypatch.setenv("PRD_DISABLE_ESM", "1")
    for name in ("USE_TF", "USE_FLAX"):
        monkeypatch.setenv(name, "0")
    out = tmp_path / "out"
    generate(["-c", str(save / "checkpoints"), "-o", str(out), "-p", "ACDEFGHIK", "-l", "CCO",
              "-n", "2", "--num_steps", "4", "--device", "cpu"])
    assert (out / "sample_protein.pdb").read_text().count("MODEL") >= 2
