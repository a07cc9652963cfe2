"""The port's training loss against the JAX package on the CPU, with every
draw of ``ProteinReDiffModel.loss`` redone from its keys (`prdiff.py:371-394,
438-462, 633-636`) and injected through ``TrainNoise``:

- ``spatial_mask`` (exact masks);
- the training branch of ``prepare_batch`` under each masking policy
  (random, spatial, none; exact masks);
- ``loss`` per sample in both ``loss_mode``s (1e-4 relative in float32) and
  its parameter gradients: per tensor, ||port - JAX|| <= 1e-4 of the larger
  of the tensor's norm and 1e-3 of the global norm (a few gradients are
  zero in exact arithmetic, such as a bias added to every logit of a
  softmax, and both sides give rounding noise there).

The JAX model runs with ``use_pallas=False``: at these sizes its trainer's
default plan takes XLA attention, and the Pallas backward is held against
the port's in ``test_torch_attention_grad.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_net import CFG, make_batch, perturbed_params  # noqa: E402

from protein_redesign_tpu.models.masking import spatial_mask as jax_spatial_mask  # noqa: E402
from protein_redesign_tpu.models.prdiff import ProteinReDiffModel  # noqa: E402
from protein_redesign_tpu_torch.models import prdiff as P  # noqa: E402
from protein_redesign_tpu_torch.models.masking import spatial_mask  # noqa: E402
from protein_redesign_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

LOSS_CFG = CFG.replace(mask_prob=0.6, training_mode=True, use_pallas=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_train_draws(key, B, N, cfg):
    """The raw draws of ProteinReDiffModel.loss(params, batch, key)."""
    k_prep, k_t, k_loss = jax.random.split(key, 3)
    k_rt, k_p, k_rand, k_spatial = jax.random.split(k_prep, 4)
    _, p_key = jax.random.split(k_spatial)
    kz, ks = jax.random.split(k_loss)
    return P.TrainNoise(
        rt=_t(jax.random.uniform(k_rt, ())),
        p=_t(jax.random.uniform(k_p, (), minval=0.1, maxval=cfg.mask_prob)),
        rand_u=_t(jax.random.uniform(k_rand, ())),
        rand_scores=_t(jax.random.uniform(jax.random.fold_in(k_rand, 1), (B * N,))),
        spatial_u=_t(jax.random.uniform(p_key, ())),
        t=_t(jax.random.randint(k_t, (B,), 0, cfg.num_steps)),
        noise_z=_t(jax.random.normal(kz, (B, N, 3), jnp.float32)),
        noise_seq=_t(jax.random.normal(ks, (B, N, 21), jnp.float32)),
    )


def key_for_policy(policy):
    """The first PRNGKey(seed) whose masking policy draw picks ``policy``,
    with a fraction of at least 0.15 for the two masking policies (so they
    mask residues of a 9-residue complex)."""
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        d = jax_train_draws(key, 1, 1, LOSS_CFG)
        rt = float(d.rt)
        if policy == "none" and rt >= 0.5:
            return key
        if policy == "random" and rt < 0.3 and float(d.rand_u * d.p) >= 0.15:
            return key
        if policy == "spatial" and 0.3 <= rt < 0.5 and float(d.spatial_u * d.p) >= 0.15:
            return key
    raise AssertionError(policy)


def test_spatial_mask_matches_jax():
    rng = np.random.RandomState(0)
    B, N = 4, 20
    residue_mask = np.zeros((B, N), np.float32)
    for b, n in enumerate((8, 11, 6, 13)):  # median 9.5: the mean of the middle two
        residue_mask[b, 5:5 + n] = 1.0
    atom_mask = np.zeros((B, N), np.float32)
    atom_mask[:, :5] = 1.0
    ca = rng.randn(B, N, 3).astype(np.float32)
    atom_pos = rng.randn(B, N, 3).astype(np.float32)
    counts = []
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        j_extra, j_inv = jax_spatial_mask(key, jnp.asarray(ca), jnp.asarray(residue_mask),
                                          jnp.asarray(atom_pos), jnp.asarray(atom_mask),
                                          jnp.float32(0.9))
        frac_u = _t(jax.random.uniform(jax.random.split(key)[1], ()))
        extra, inv = spatial_mask(*(torch.from_numpy(x) for x in (ca, residue_mask, atom_pos,
                                                                   atom_mask)),
                                  torch.tensor(0.9), frac_u)
        np.testing.assert_array_equal(extra.numpy(), np.asarray(j_extra))
        np.testing.assert_array_equal(inv.numpy(), np.asarray(j_inv))
        counts.append(int(inv.sum()))
    assert max(counts) > 0, counts


@pytest.mark.parametrize("policy", ["random", "spatial", "none"])
def test_training_prepare_batch_matches_jax(policy):
    batch = make_batch(B=2, seed=4)
    key = key_for_policy(policy)
    model = ProteinReDiffModel(LOSS_CFG)
    k_prep = jax.random.split(key, 3)[0]
    j = model.prepare_batch({k: jnp.asarray(v) for k, v in batch.items()}, k_prep, training=True)
    B, N = batch["residue_mask"].shape
    noise = jax_train_draws(key, B, N, LOSS_CFG)
    t = P.prepare_batch({k: torch.from_numpy(v) for k, v in batch.items()}, LOSS_CFG.mask_prob,
                        training=True, train_noise=noise)
    for name in ("residue_extra_mask", "residue_inv_extra_mask", "residue_one_hot",
                 "residue_esm", "x", "residue_and_atom_mask"):
        np.testing.assert_allclose(t[name].numpy(), np.asarray(j[name]), atol=1e-6, rtol=1e-6,
                                   err_msg=name)
    masked = int(t["residue_inv_extra_mask"].sum())
    assert (masked == 0) == (policy == "none")


@pytest.mark.parametrize("loss_mode", ["reference", "per_position"])
def test_loss_and_grads_match_jax(loss_mode):
    cfg = LOSS_CFG.replace(loss_mode=loss_mode)
    batch = make_batch(B=2, seed=5)
    params = perturbed_params(cfg, seed=5)
    key = key_for_policy("random")
    model = ProteinReDiffModel(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def per_sample(p):
        per = model.loss(p, jb, key, training=True, reduction="none")[0]
        return per.mean(), per

    (_, j_per), j_grads = jax.jit(jax.value_and_grad(per_sample, has_aux=True))(params)

    net = P.ProteinReDiffNet(cfg)
    net.load_state_dict(state_dict_from_jax(params, cfg))
    B, N = batch["residue_mask"].shape
    noise = jax_train_draws(key, B, N, cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    per, _ = P.loss(net, tb, reduction="none", noise=noise)
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(j_per), atol=1e-4, rtol=1e-4)
    mean, metrics = P.loss(net, tb, noise=noise)
    torch.testing.assert_close(mean, per.mean())
    mean.backward()

    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_grads), cfg)
    names = [name for name, _ in net.named_parameters()]
    total = np.sqrt(sum(np.sum(ref[name].numpy() ** 2) for name in names))
    for name, p in net.named_parameters():
        b = ref[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - b)
        assert err <= 1e-4 * max(np.linalg.norm(b), 1e-3 * total), name
