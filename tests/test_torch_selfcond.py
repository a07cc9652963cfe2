"""Coordinate self-conditioning (``ModelConfig.self_cond``) in the port
against the JAX package (Pallas attention in interpret mode) at the tiny
``CFG`` of ``test_torch_net.py``, in float32 at 1e-4:

- the ``embed_sc_dist`` weights: the JAX parameter tree, the strict load,
  and a self-cond absorbing checkpoint through ``save_checkpoint`` /
  ``load_checkpoint`` and the generate CLI;
- the net with self-conditioning inputs, and ``sc_flag = 0`` bit-equal to
  no inputs;
- ``x0_hat``;
- the training loss on both sequence processes under both values of the
  coin, and its parameter gradients (the gate of ``test_torch_loss.py``);
- DDPM and DDIM sampling with self-conditioning on both sequence processes
  (the absorbing reveal's commitments exactly).

Each JAX draw is redone from its key (`prdiff.py:453-468, 573-575, 721-739,
994`) and injected into the port.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_loss import LOSS_CFG, jax_train_draws  # noqa: E402
from test_torch_net import CFG, make_batch, perturbed_params  # noqa: E402

from protein_redesign_tpu.models.prdiff import ProteinReDiffModel  # noqa: E402
from protein_redesign_tpu_torch.models import prdiff as P  # noqa: E402
from protein_redesign_tpu_torch.utils.weights import (  # noqa: E402
    load_checkpoint,
    save_checkpoint,
    state_dict_from_jax,
)

SC_CFG = CFG.replace(self_cond=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def design_params(cfg, seed=0, scale=0.3, seq_gain=1.0):
    """``perturbed_params`` plus a seeded ``embed_sc_dist`` kernel where
    ``cfg.self_cond`` (the JAX converter does not map it). ``seq_gain``
    scales the sequence head's output layer: wider-spread logits keep the
    absorbing reveal's decisions away from ties at small weights."""
    params = perturbed_params(cfg, seed, scale)
    if seq_gain != 1.0:
        head = params["seq_mlp"]["PRLinear_1"]["Dense_0"]
        params = {**params, "seq_mlp": {**params["seq_mlp"], "PRLinear_1": {
            "Dense_0": {**head, "kernel": head["kernel"] * seq_gain}}}}
    if cfg.self_cond:
        rng = np.random.RandomState(seed + 2)
        kernel = (scale * rng.randn(cfg.dist_dim, cfg.pair_dim)).astype(np.float32)
        params = {**params, "embed_sc_dist": {"dense": {"Dense_0": {"kernel": jnp.asarray(kernel)}}}}
    return params


def port_net(cfg, params):
    net = P.ProteinReDiffNet(cfg)
    net.load_state_dict(state_dict_from_jax(params, cfg), strict=True)
    return net


def train_draws(key, B, N, cfg):
    """The raw draws of ProteinReDiffModel.loss(params, batch, key) in
    every mode: the absorbing corruption uniforms and the self-conditioning
    coin besides ``jax_train_draws``'s."""
    noise = jax_train_draws(key, B, N, cfg)
    _, ks = jax.random.split(jax.random.split(key, 3)[2])
    return dataclasses.replace(
        noise, corrupt_u=_t(jax.random.uniform(ks, (B, N))),
        sc_coin=float(jax.random.uniform(jax.random.fold_in(ks, 17), ())))


def key_with_coin(first_pass: bool, cfg):
    """The first PRNGKey(seed) whose coin runs (or skips) the first pass
    and whose masking policy is random masking of at least 0.15."""
    for seed in range(400):
        key = jax.random.PRNGKey(seed)
        d = train_draws(key, 1, 1, cfg)
        if (d.sc_coin < 0.5) == first_pass and float(d.rt) < 0.3 and float(d.rand_u * d.p) >= 0.15:
            return key
    raise AssertionError(first_pass)


def _flat_names(tree):
    return {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_sc_weights_match_the_jax_tree_and_load_strictly():
    batch = make_batch(B=1)
    init = jax.eval_shape(ProteinReDiffModel(SC_CFG).init_params, jax.random.PRNGKey(0),
                          _jb(batch))
    params = design_params(SC_CFG)
    assert _flat_names(params) == _flat_names(init)
    sd = state_dict_from_jax(params, SC_CFG)
    net = port_net(SC_CFG, params)
    assert set(net.state_dict()) == set(sd)
    np.testing.assert_array_equal(
        sd["embed_sc_dist.1.weight"].numpy(),
        np.asarray(params["embed_sc_dist"]["dense"]["Dense_0"]["kernel"]).T)
    torch.testing.assert_close(sd["embed_sc_dist.0.center"], sd["embed_dist.0.center"])
    assert "embed_sc_dist.1.weight" not in P.ProteinReDiffNet(CFG).state_dict()


def _forward_inputs(batch, seed):
    rng = np.random.RandomState(seed)
    B, N = batch["residue_mask"].shape
    return dict(z=rng.randn(B, N, 3).astype(np.float32),
                seq_t=rng.randn(B, N, 21).astype(np.float32),
                mask=batch["atom_mask"] + batch["residue_mask"],
                t=rng.randint(0, CFG.num_steps, (B,)),
                z_sc=(2.0 * rng.randn(B, N, 3)).astype(np.float32))


def test_forward_with_sc_inputs_matches_jax():
    """One sample with a live estimate (flag 1), one with flag 0."""
    batch = make_batch(B=2, seed=6)
    params = design_params(SC_CFG, seed=6)
    x = _forward_inputs(batch, 13)
    sc_flag = np.array([1.0, 0.0], np.float32)
    j_noise, j_seq = ProteinReDiffModel(SC_CFG).apply(
        params, _jb(batch), jnp.asarray(x["z"]), jnp.asarray(x["seq_t"]), jnp.asarray(x["mask"]),
        jnp.asarray(x["t"], jnp.int32), jnp.asarray(x["z_sc"]), jnp.asarray(sc_flag))
    net = port_net(SC_CFG, params)
    with torch.no_grad():
        noise, seq = net(_tb(batch), *(torch.from_numpy(x[k]) for k in ("z", "seq_t", "mask", "t")),
                         torch.from_numpy(x["z_sc"]), torch.from_numpy(sc_flag))
    np.testing.assert_allclose(noise.numpy(), np.asarray(j_noise), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(seq.numpy(), np.asarray(j_seq), atol=1e-4, rtol=1e-4)


def test_flag_zero_is_an_exact_noop():
    """sc_flag 0 with any z_sc gives the bits of no self-conditioning input;
    flag 1 changes the output."""
    batch = _tb(make_batch(B=2, seed=7))
    x = _forward_inputs(make_batch(B=2, seed=7), 14)
    net = port_net(SC_CFG, design_params(SC_CFG, seed=7))
    args = [torch.from_numpy(x[k]) for k in ("z", "seq_t", "mask", "t")]
    garbage = torch.full_like(args[0], 7.5)
    with torch.no_grad():
        none = net(batch, *args)
        zero = net(batch, *args, garbage, torch.zeros(2))
        live = net(batch, *args, garbage, torch.ones(2))
    for a, b in zip(none, zero):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.allclose(none[0], live[0])


def test_x0_hat_matches_jax():
    rng = np.random.RandomState(3)
    B, N = 2, 16
    z, eps = (rng.randn(B, N, 3).astype(np.float32) * s for s in (30.0, 1.0))
    mask = (rng.rand(B, N) > 0.3).astype(np.float32)
    a_t = np.array([0.9, 1e-3], np.float32)[:, None, None]  # the second clips at ±20 nm
    want = ProteinReDiffModel(SC_CFG)._x0_hat(*(jnp.asarray(v) for v in (z, eps, a_t, mask)))
    got = P.x0_hat(*(torch.from_numpy(v) for v in (z, eps, a_t, mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert float(got.abs().max()) > 19.0 and not got.requires_grad


def assert_grads_match(net, j_grads, cfg):
    """Per tensor, ||port - JAX|| <= 1e-4 of the larger of the tensor's norm
    and 1e-3 of the global norm (``test_torch_loss.py``'s gate)."""
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_grads), cfg)
    names = [name for name, _ in net.named_parameters()]
    total = np.sqrt(sum(np.sum(ref[name].numpy() ** 2) for name in names))
    for name, p in net.named_parameters():
        b = ref[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - b)
        assert err <= 1e-4 * max(np.linalg.norm(b), 1e-3 * total), name


def loss_matches_jax(cfg, key, seed):
    """The port's per-sample loss and gradients against the JAX loss under
    ``key``'s draws; returns the port's metrics."""
    batch = make_batch(B=2, seed=seed)
    params = design_params(cfg, seed=seed)
    model = ProteinReDiffModel(cfg)
    jb = _jb(batch)

    def per_sample(p):
        per = model.loss(p, jb, key, training=True, reduction="none")[0]
        return per.mean(), per

    (_, j_per), j_grads = jax.jit(jax.value_and_grad(per_sample, has_aux=True))(params)
    net = port_net(cfg, params)
    B, N = batch["residue_mask"].shape
    noise = train_draws(key, B, N, cfg)
    per, metrics = P.loss(net, _tb(batch), reduction="none", noise=noise)
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(j_per), atol=1e-4, rtol=1e-4)
    per.mean().backward()
    assert_grads_match(net, j_grads, cfg)
    return net, metrics


@pytest.mark.parametrize("proc", ["gaussian", "absorbing"])
@pytest.mark.parametrize("first_pass", [True, False])
def test_self_cond_loss_and_grads_match_jax(proc, first_pass):
    """Both coin values on both sequence processes: the first pass runs
    without gradient, so the embed_sc_dist gradient is live only where it
    ran (flag 1); elsewhere it is exactly zero."""
    cfg = LOSS_CFG.replace(self_cond=True, seq_process=proc)
    net, metrics = loss_matches_jax(cfg, key_with_coin(first_pass, cfg), seed=8)
    assert metrics["sc_pass"] is first_pass
    sc_grad = float(net.embed_sc_dist[1].weight.grad.abs().sum())
    assert (sc_grad > 0) == first_pass


def _sampler_inputs(cfg, seed):
    batch = make_batch(B=2, seed=seed)
    params = design_params(cfg, seed=seed, scale=0.1,
                           seq_gain=4.0 if cfg.seq_process == "absorbing" else 1.0)
    return batch, params, port_net(cfg, params)


@pytest.mark.parametrize("proc,sampler", [("gaussian", "ddpm"), ("absorbing", "ddim")])
def test_self_cond_sampling_matches_jax(proc, sampler):
    """DDPM (T = 4) on the Gaussian sequence channel and DDIM (4 of 12
    steps, eta 1) under absorbing, with self-conditioning: positions at
    1e-4, the absorbing commitments exactly; the estimate is live (zeroing
    embed_sc_dist changes the positions)."""
    from test_torch_absorbing import jax_absorbing_run
    from test_torch_seq_reverse import MASK_PROB, sampler_draws

    cfg = SC_CFG.replace(seq_process=proc, num_steps=4 if sampler == "ddpm" else 12)
    batch, params, net = _sampler_inputs(cfg, seed=9)
    key = jax.random.PRNGKey(19)
    steps = cfg.num_steps if sampler == "ddpm" else 4
    kw = dict(ddim_steps=4, eta=1.0) if sampler == "ddim" else {}
    if proc == "absorbing":
        j_pos, j_logits = jax_absorbing_run(cfg, params, batch, key, MASK_PROB, **kw)
    elif sampler == "ddim":
        j_pos, j_logits = ProteinReDiffModel(cfg).sample_ddim(params, _jb(batch), key,
                                                              mask_prob=MASK_PROB, **kw)
    else:
        j_pos, j_logits = ProteinReDiffModel(cfg).sample(params, _jb(batch), key,
                                                         mask_prob=MASK_PROB)
    B, N = batch["residue_mask"].shape
    noise = sampler_draws(key, B, N, steps, cfg, sampler)
    run = (lambda n: P.sample_ddim(n, _tb(batch), 4, 1.0, MASK_PROB, noise=noise)) \
        if sampler == "ddim" else (lambda n: P.sample(n, _tb(batch), MASK_PROB, noise=noise))
    pos, logits = run(net)
    np.testing.assert_allclose(pos.numpy(), np.asarray(j_pos), atol=1e-4, rtol=1e-4)
    if proc == "absorbing":
        np.testing.assert_array_equal(logits.numpy(), np.asarray(j_logits))
    else:
        np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        net.embed_sc_dist[1].weight.zero_()
    assert not torch.allclose(run(net)[0], pos)


def test_self_cond_absorbing_checkpoint_round_trip(tmp_path, monkeypatch):
    """A self-cond absorbing checkpoint keeps its weights and its
    sequence-design fields through save_checkpoint / load_checkpoint, and
    the generate CLI samples from it with DDPM and with a one-step DDIM."""
    from test_torch_generate import ARGS, TINY

    from protein_redesign_tpu_torch.cli.generate import main

    cfg = TINY.replace(self_cond=True, seq_process="absorbing", seq_reverse="ancestral",
                       reveal_schedule="cosine", reveal_temperature=0.5, reveal_conf_noise=0.25)
    torch.manual_seed(0)
    net = P.ProteinReDiffNet(cfg)
    save_checkpoint(tmp_path / "ckpt", net.state_dict(), cfg)
    sd, loaded = load_checkpoint(tmp_path / "ckpt")
    assert dataclasses.asdict(loaded) == dataclasses.asdict(cfg)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(sd[k], v, atol=0, rtol=0)
    assert "embed_sc_dist.1.weight" in sd
    monkeypatch.setenv("PRD_DISABLE_ESM", "1")
    for name in ("USE_TF", "USE_FLAX"):
        monkeypatch.setenv(name, "0")
    out = tmp_path / "out"
    argv = ["-c", str(tmp_path / "ckpt"), "-o", str(out), *ARGS, "--mask_prob", "0.5",
            "--reveal_schedule", "cosine", "--reveal_temperature", "0.5",
            "--reveal_conf_noise", "0.25"]
    main(argv)
    assert (out / "sample_protein.pdb").read_text().count("MODEL") == 2
    main([*argv, "--sampler", "ddim", "--ddim_steps", "1", "-o", str(tmp_path / "ddim")])
    assert (tmp_path / "ddim" / "sample_ligand.sdf").read_text().count("$$$$") == 2
