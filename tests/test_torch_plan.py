"""The port's attention plan and ``fast_softmax`` against the JAX package on
the CPU (its Pallas kernels in interpret mode):

- ``resolve_attention_plan``: the port's copy returns the JAX function's
  (use_pallas, attn_chunk) on a grid of every field it reads and of n;
- ``attention_reference_fast`` against ``_attention_reference(...,
  fast_softmax=True)`` in bf16, with and without bias and mask: both round
  at the same points, but XLA may keep an intermediate in f32 where the
  port rounds, so 1e-2 of max |out|; and the mean error must be at least 2x
  smaller than against the f32-logit function, so an ignored flag fails;
- the tiny 2-block net of ``test_torch_net.py`` under the JAX default plan
  (no ``use_pallas=True``) with ``fast_softmax`` on, ``pallas_auto_min_n``
  = 32 so that bucket 16 takes XLA and bucket 32 Pallas, ``use_pallas_bwd``
  on and off: f32 within 1e-5 of max |out| wherever no K1 fast runs (the
  flag changes nothing in f32 there); K1 fast (bucket 32 without
  ``use_pallas_bwd``) rounds its softmax to bf16 on both sides, and logit
  sums taken in another order flip roundings, so 1e-2 of max |out| as in
  ``test_torch_fast_softmax.py``; bf16 within 2e-2 relative norm. The
  routes are counted: the bf16-logit attention for all 2 x 3 + 1
  attentions at bucket 16 in bf16, K1 fast for the 2 x 2 triangle ones at
  bucket 32 without ``use_pallas_bwd``;
- ``--use_pallas``, ``--pallas_auto_min_n`` (and ``--trimul_dmajor``)
  reach the config in the generate, serve and both batch CLIs by the JAX
  package's ``sampler_cfg_overrides`` rules (the auto threshold always set,
  384 by default; the switches only when given, so a checkpoint's own
  ``use_pallas`` survives), and in the train CLI as JAX's
  ``model_config_from_args`` sets them;
- the f32 loss gradient with ``fast_softmax`` on under the default
  (training) plan, and the loss and gradient of a ``head_dim=64,
  num_heads=1`` net (K7's plain version at C = 64 on the CPU), against the
  JAX package's, per tensor at 1e-4 as ``test_torch_loss.py`` holds them.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_loss import LOSS_CFG, jax_train_draws, key_for_policy  # noqa: E402
from test_torch_net import CFG, make_batch, perturbed_params  # noqa: E402
from test_train_cli import mini_data  # noqa: E402,F401

from protein_redesign_tpu.models.denoiser import resolve_attention_plan as jax_plan  # noqa: E402
from protein_redesign_tpu.models.prdiff import ProteinReDiffModel  # noqa: E402
from protein_redesign_tpu.ops.pallas_attention import _attention_reference  # noqa: E402
from protein_redesign_tpu_torch.config import ModelConfig as PortConfig  # noqa: E402
from protein_redesign_tpu_torch.models import prdiff as P  # noqa: E402
from protein_redesign_tpu_torch.models.denoiser import resolve_attention_plan  # noqa: E402
from protein_redesign_tpu_torch.ops import attention as A  # noqa: E402
from protein_redesign_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

PLAN_N = (16, 256, 383, 384, 512, 768, 1024, 2048, 4096)


@pytest.mark.parametrize("head_dim", [8, 16, 32, 48, 64])
def test_plan_matches_jax(head_dim):
    grid = itertools.product(
        (False, True), (False, True), (0, 64), (False, True), (1, 4), (False, True),
        (False, True), (0, 384, 512), ("float32", "bfloat16"))
    for (training, use_pallas, chunk, bwd, heads, stream, sp, min_n, dtype) in grid:
        fields = dict(training_mode=training, use_pallas=use_pallas, attn_chunk=chunk,
                      use_pallas_bwd=bwd, head_dim=head_dim, num_heads=heads,
                      pair_stream_bf16=stream, sequence_parallel=sp, pallas_auto_min_n=min_n,
                      dtype=dtype)
        jcfg, pcfg = CFG.replace(**fields), PortConfig(**{**dataclasses.asdict(CFG), **fields})
        for n in PLAN_N:
            assert resolve_attention_plan(pcfg, n) == jax_plan(jcfg, n), (fields, n)


class _Built(Exception):
    pass


def _record_config(monkeypatch) -> dict:
    """Stops a CLI where it builds its net, keeping the config it built."""
    from protein_redesign_tpu_torch.models import prdiff

    built = {}

    def record(cfg):
        built["cfg"] = cfg
        raise _Built

    monkeypatch.setattr(prdiff, "ProteinReDiffNet", record)
    return built


PLAN_FLAGS = {"none": [], "use_pallas": ["--use_pallas"],
              "pallas_auto_min_n": ["--pallas_auto_min_n", "16"],
              "trimul_dmajor": ["--trimul_dmajor", "--pallas_auto_min_n", "0"]}


@pytest.mark.parametrize("flags", list(PLAN_FLAGS))
@pytest.mark.parametrize("checkpoint_pallas", [False, True], ids=["ckpt_xla", "ckpt_pallas"])
@pytest.mark.parametrize("cli", ["generate", "serve", "predict_batch_sequence",
                                 "predict_batch_structure"])
def test_sampling_clis_set_the_plan_fields_as_jax(cli, checkpoint_pallas, flags, tmp_path,
                                                  monkeypatch):
    import importlib
    from argparse import ArgumentParser

    from protein_redesign_tpu.cli.common import add_sampler_args as jax_sampler_args
    from protein_redesign_tpu.cli.common import sampler_cfg_overrides as jax_overrides
    from test_torch_generate import TINY

    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
    from protein_redesign_tpu_torch.utils.weights import save_checkpoint

    ckpt = TINY.replace(use_pallas=checkpoint_pallas, pallas_auto_min_n=32)
    save_checkpoint(tmp_path / "ckpt", ProteinReDiffNet(ckpt).state_dict(), ckpt)
    argv = ["-c", str(tmp_path / "ckpt"), "-o", str(tmp_path / "out"), "--device", "cpu",
            *PLAN_FLAGS[flags]]
    if cli == "generate":
        argv += ["-p", "GMASKLLEVAKRLG", "-l", "CCO", "-n", "1"]
    elif cli.startswith("predict_batch"):
        (tmp_path / "in.fasta").write_text(">a\nGMASKLLEVAKRLG\n")
        argv += ["-p", str(tmp_path / "in.fasta")]
    built = _record_config(monkeypatch)
    with pytest.raises(_Built):
        importlib.import_module(f"protein_redesign_tpu_torch.cli.{cli}").main(argv)
    parser = ArgumentParser()
    jax_sampler_args(parser)
    want = CFG.replace(**{k: getattr(ckpt, k) for k in ("use_pallas", "pallas_auto_min_n")})
    want = want.replace(**jax_overrides(parser.parse_known_args(PLAN_FLAGS[flags])[0]))
    got = built["cfg"]
    for field in ("use_pallas", "pallas_auto_min_n", "trimul_dmajor"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("flags", list(PLAN_FLAGS))
def test_train_cli_sets_the_plan_fields_as_jax(flags, mini_data, tmp_path,  # noqa: F811
                                               monkeypatch):
    from argparse import ArgumentParser

    from protein_redesign_tpu.config import add_model_args, model_config_from_args
    from test_torch_train_cli import TINY_FLAGS

    from protein_redesign_tpu_torch.cli.train import main

    built = _record_config(monkeypatch)
    with pytest.raises(_Built):
        main(["--save_dir", str(tmp_path / "run"), "--data_dir", str(mini_data), *TINY_FLAGS,
              "--max_steps", "1", *PLAN_FLAGS[flags]])
    parser = ArgumentParser()
    add_model_args(parser)
    want = model_config_from_args(parser.parse_known_args(PLAN_FLAGS[flags])[0])
    for field in ("use_pallas", "pallas_auto_min_n", "trimul_dmajor"):
        assert getattr(built["cfg"], field) == getattr(want, field), field


def _fast_inputs(R=4, N=24, H=2, C=16, seed=0):
    rng = np.random.RandomState(seed)
    q, k = (2.0 * rng.randn(R, N, H, C).astype(np.float32) for _ in range(2))
    v = rng.randn(R, N, H, C).astype(np.float32)
    mask = (rng.rand(R, N) > 0.3).astype(np.float32)
    mask[1] = 0.0  # a fully masked row
    bias = rng.randn(R, H, N, N).astype(np.float32)
    rnd = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    return [rnd(x) for x in (q, k, v)] + [mask, rnd(bias)]


@pytest.mark.parametrize("with_mask,with_bias", [(True, True), (True, False), (False, True),
                                                 (False, False)])
def test_attention_reference_fast_matches_jax(with_mask, with_bias):
    q, k, v, mask, bias = _fast_inputs()
    mask = mask if with_mask else None
    bias = bias if with_bias else None
    scale = 0.25

    def jax_ref(fast):
        j = lambda x: None if x is None else jnp.asarray(x, jnp.bfloat16)  # noqa: E731
        out = _attention_reference(j(q), j(k), j(v), None if mask is None else jnp.asarray(mask),
                                   j(bias), scale, fast_softmax=fast)
        return np.asarray(out.astype(jnp.float32))

    t = lambda x: None if x is None else torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    got = A.attention_reference_fast(t(q), t(k), t(v),
                                     None if mask is None else torch.from_numpy(mask), t(bias),
                                     scale)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want, slow = jax_ref(True), jax_ref(False)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    assert np.abs(got - want).mean() * 2 <= np.abs(got - slow).mean()
    # in f32 it is the f32-logit reference
    f32 = [None if x is None else torch.from_numpy(x) for x in (q, k, v, mask, bias)]
    torch.testing.assert_close(A.attention_reference_fast(*f32, scale),
                               A.attention_reference(*f32, scale), atol=1e-6, rtol=1e-6)


def _count(monkeypatch, name):
    calls = []
    real = getattr(A, name)
    monkeypatch.setattr(A, name, lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bucket", [16, 32])
@pytest.mark.parametrize("bwd", [True, False], ids=["bwd", "no_bwd"])
def test_net_fast_default_plan_matches_jax(monkeypatch, dtype, bucket, bwd):
    cfg = CFG.replace(use_pallas=False, pallas_auto_min_n=32, fast_softmax=True,
                      use_pallas_bwd=bwd, dtype=dtype)
    batch = make_batch(B=2, bucket=bucket, seed=4)
    params = perturbed_params(cfg, seed=4)
    rng = np.random.RandomState(14)
    B, N = batch["residue_mask"].shape
    z, seq_t = rng.randn(B, N, 3).astype(np.float32), rng.randn(B, N, 21).astype(np.float32)
    mask, t = batch["atom_mask"] + batch["residue_mask"], rng.randint(0, cfg.num_steps, (B,))
    use_pallas = bucket >= 32
    assert jax_plan(cfg, N) == (use_pallas, 0) == resolve_attention_plan(cfg, N)
    want = jax.jit(ProteinReDiffModel(cfg).apply)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(z),
        jnp.asarray(seq_t), jnp.asarray(mask), jnp.asarray(t, jnp.int32))

    xla_calls = _count(monkeypatch, "attention_reference_fast")
    k1_fast_calls = _count(monkeypatch, "rows_attention_fast_reference")
    net = P.ProteinReDiffNet(cfg)
    net.load_state_dict(state_dict_from_jax(params, cfg))
    with torch.no_grad():
        got = net({k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(z),
                  torch.from_numpy(seq_t), torch.from_numpy(mask), torch.from_numpy(t))
    k1_fast = use_pallas and not bwd
    blocks = cfg.num_blocks
    assert len(xla_calls) == (0 if use_pallas or dtype == "float32" else 3 * blocks + 1)
    assert len(k1_fast_calls) == (2 * blocks if k1_fast else 0)
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert np.isfinite(g).all()
        if dtype == "bfloat16":
            assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w)
        else:
            tol = 1e-2 if k1_fast else 1e-5
            assert np.abs(g - w).max() <= tol * np.abs(w).max()


def _grads_match(cfg, seed):
    batch = make_batch(B=2, seed=seed)
    params = perturbed_params(cfg, seed=seed)
    key = key_for_policy("random")
    model = ProteinReDiffModel(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss(p, jb, key, training=True)[0]))(params)

    net = P.ProteinReDiffNet(cfg)
    net.load_state_dict(state_dict_from_jax(params, cfg))
    B, N = batch["residue_mask"].shape
    mean, _ = P.loss(net, {k: torch.from_numpy(v) for k, v in batch.items()},
                     noise=jax_train_draws(key, B, N, cfg))
    np.testing.assert_allclose(float(mean), float(j_loss), rtol=1e-4, atol=1e-4)
    mean.backward()
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_grads), cfg)
    names = [name for name, _ in net.named_parameters()]
    total = np.sqrt(sum(np.sum(ref[name].numpy() ** 2) for name in names))
    for name, p in net.named_parameters():
        b = ref[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - b)
        assert err <= 1e-4 * max(np.linalg.norm(b), 1e-3 * total), name


@pytest.mark.parametrize("bwd", [True, False], ids=["bwd", "no_bwd"])
def test_fast_loss_gradient_default_plan_matches_jax(bwd):
    """f32 under the training plan (XLA at bucket 16): the flag changes
    nothing, on either side."""
    _grads_match(LOSS_CFG.replace(fast_softmax=True, use_pallas_bwd=bwd), seed=6)


def test_wide_head_loss_gradient_matches_jax(monkeypatch):
    """h64x1 (JAX's recommended training layout): the port's triangle
    attentions take K1 and K7 at C = 64 (their plain versions on the CPU)."""
    bwd_calls = _count(monkeypatch, "rows_attention_bwd_reference")
    _grads_match(LOSS_CFG.replace(head_dim=64, num_heads=1), seed=7)
    assert len(bwd_calls) == 2 * LOSS_CFG.num_blocks
