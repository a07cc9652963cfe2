"""``seq_reverse="ancestral"`` in the port against the JAX package (Pallas
attention in interpret mode) at the tiny ``CFG`` of ``test_torch_net.py``:
DDPM (T = 4) and DDIM (4 of 12 steps, eta 0 and 1), positions and sequence
logits in float32 at 1e-4, with every JAX draw redone from its key and
injected (``sampler_draws``, shared by the other sequence-design tests).
Also the JAX package's properties (`tests/test_seq_reverse.py`): the mode
differs from the reference recurrence, its sequence depends on the weights,
known residues stay clamped, and an unknown mode raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_net import CFG, make_batch, perturbed_params  # noqa: E402

from protein_redesign_tpu.models.prdiff import ProteinReDiffModel  # noqa: E402
from protein_redesign_tpu_torch.models import prdiff as P  # noqa: E402
from protein_redesign_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

MASK_PROB = 0.5
ANC_CFG = CFG.replace(seq_reverse="ancestral")


def _t(a):
    return torch.from_numpy(np.array(a))


def sampler_draws(key, B, N, steps, cfg, sampler="ddpm"):
    """The raw draws of ProteinReDiffModel.sample / sample_ddim for ``key``
    (`prdiff.py:683-685, 721-739, 837-839, 867, 994, 1198`): mask scores,
    initial coordinates and sequence, and per step the coordinate normal,
    the ancestral DDPM sequence normal and the absorbing reveal's Gumbels,
    each where the mode draws it."""
    k_prep, k_z, k_seq, k_scan = jax.random.split(key, 4)
    keys = jax.random.split(k_scan, steps)
    noise = P.SamplerNoise(
        mask_scores=_t(jax.random.uniform(k_prep, (B * N,))),
        z0=_t(jax.random.normal(k_z, (B, N, 3), jnp.float32)),
        s0=_t(jax.random.normal(k_seq, (B, N, 21), jnp.float32)),
    )
    z, seq, g_cls, g_conf = [], [], [], []
    for k in keys:
        if cfg.seq_process == "absorbing":
            kz, kc, kg = jax.random.split(k, 3)
            g_cls.append(jax.random.gumbel(kc, (B, N, 20)))
            g_conf.append(jax.random.gumbel(kg, (B, N)))
        elif cfg.seq_reverse == "ancestral" and sampler == "ddpm":
            kz, ks = jax.random.split(k)
            seq.append(jax.random.normal(ks, (B, N, 21), jnp.float32))
        else:
            kz = k
        z.append(jax.random.normal(kz, (B, N, 3), jnp.float32))
    noise.steps = _t(jnp.stack(z))
    if seq:
        noise.seq_steps = _t(jnp.stack(seq))
    if g_cls:
        noise.gumbel_cls, noise.gumbel_conf = _t(jnp.stack(g_cls)), _t(jnp.stack(g_conf))
    return noise


def _setup(cfg, seed):
    batch = make_batch(B=2, seed=seed)
    params = perturbed_params(cfg, seed=seed, scale=0.1)
    net = P.ProteinReDiffNet(cfg)
    net.load_state_dict(state_dict_from_jax(params, cfg))
    return batch, params, net


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("sampler,eta", [("ddpm", 0.0), ("ddim", 0.0), ("ddim", 1.0)])
def test_ancestral_matches_jax(sampler, eta):
    cfg = ANC_CFG.replace(num_steps=4 if sampler == "ddpm" else 12)
    batch, params, net = _setup(cfg, seed=21)
    key = jax.random.PRNGKey(23)
    model = ProteinReDiffModel(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    B, N = batch["residue_mask"].shape
    if sampler == "ddpm":
        j_pos, j_logits = model.sample(params, jb, key, mask_prob=MASK_PROB)
        noise = sampler_draws(key, B, N, cfg.num_steps, cfg)
        pos, logits = P.sample(net, _tb(batch), MASK_PROB, noise=noise)
    else:
        j_pos, j_logits = model.sample_ddim(params, jb, key, ddim_steps=4, eta=eta,
                                            mask_prob=MASK_PROB)
        noise = sampler_draws(key, B, N, 4, cfg, "ddim")
        pos, logits = P.sample_ddim(net, _tb(batch), 4, eta, MASK_PROB, noise=noise)
    assert np.isfinite(pos.numpy()).all() and np.isfinite(logits.numpy()).all()
    np.testing.assert_allclose(pos.numpy(), np.asarray(j_pos), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=1e-4)


def _capture_seq_t(net, batch, mask_prob, seed, ddim=False):
    """(logits, every step's carried seq_t) of a seeded run."""
    frames = []
    gen = torch.Generator().manual_seed(seed)
    hook = lambda i, carry: frames.append(carry[1].clone())  # noqa: E731
    if ddim:
        out = P.sample_ddim(net, _tb(batch), 3, 0.0, mask_prob, gen, on_step=hook)
    else:
        out = P.sample(net, _tb(batch), mask_prob, gen, on_step=hook)
    return out, frames


@pytest.mark.parametrize("ddim", [False, True])
def test_ancestral_differs_from_reference_and_depends_on_weights(ddim):
    """The two reverse processes give different samples from the same
    draws, and the ancestral sequence moves with the weights (the
    reference recurrence's need not: JAX README.md)."""
    cfg = ANC_CFG.replace(num_steps=6)
    batch, params, net = _setup(cfg, seed=24)
    ref = P.ProteinReDiffNet(cfg.replace(seq_reverse="reference"))
    ref.load_state_dict(net.state_dict())
    (_, s_anc), _ = _capture_seq_t(net, batch, MASK_PROB, 5, ddim)
    (_, s_ref), _ = _capture_seq_t(ref, batch, MASK_PROB, 5, ddim)
    assert np.isfinite(s_anc.numpy()).all()
    assert not torch.allclose(s_anc, s_ref)
    other = P.ProteinReDiffNet(cfg)
    other.load_state_dict(state_dict_from_jax(perturbed_params(cfg, seed=25, scale=0.1), cfg))
    (_, s_other), _ = _capture_seq_t(other, batch, MASK_PROB, 5, ddim)
    assert not torch.allclose(s_anc, s_other)


@pytest.mark.parametrize("ddim", [False, True])
def test_known_positions_stay_clamped(ddim):
    """With nothing masked, every step's carried sequence is the
    conditioning ±1 one-hot at every residue."""
    cfg = ANC_CFG.replace(num_steps=6)
    batch, _, net = _setup(cfg, seed=26)
    _, frames = _capture_seq_t(net, batch, 0.0, 6, ddim)
    res = batch["residue_mask"] > 0.5
    want = np.eye(21, dtype=np.float32)[batch["residue_type"]] * 2.0 - 1.0
    assert len(frames) == (3 if ddim else 6)
    for seq_t in frames:
        np.testing.assert_array_equal(seq_t.numpy()[res], want[res])


def test_invalid_seq_reverse_raises():
    _, _, net = _setup(CFG, seed=27)
    net.cfg = CFG.replace(seq_reverse="bogus")
    tb = _tb(make_batch(B=1))
    with pytest.raises(ValueError, match="seq_reverse"):
        P.sample(net, tb, MASK_PROB)
    with pytest.raises(ValueError, match="seq_reverse"):
        P.sample_ddim(net, tb, 2)
