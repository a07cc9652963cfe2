"""The slice as a whole: the port's DDPM sampler against
``ProteinReDiffModel.sample`` over T=4 steps with perturbed weights.

``jax.random`` streams cannot be reproduced in torch, so the test redoes
the JAX sampler's key splits (`prdiff.py:683-685, 721-739, 867`) to recover
its mask scores, initial coordinates and sequence, and each step's noise,
and injects them into the port. Tolerance 1e-4 in float32 on the final
positions (Å) and sequence logits.
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


def jax_draws(key, B, N, T):
    """The raw draws of ProteinReDiffModel.sample for ``key``."""
    k_prep, k_z, k_seq, k_scan = jax.random.split(key, 4)
    keys = jax.random.split(k_scan, T)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return P.SamplerNoise(
        mask_scores=t(jax.random.uniform(k_prep, (B * N,))),
        z0=t(jax.random.normal(k_z, (B, N, 3), jnp.float32)),
        s0=t(jax.random.normal(k_seq, (B, N, 21), jnp.float32)),
        steps=t(jnp.stack([jax.random.normal(k, (B, N, 3), jnp.float32) for k in keys])),
    )


def test_sample_matches_jax():
    batch = make_batch(B=2, seed=3)
    params = perturbed_params(CFG, seed=3, scale=0.1)  # 0.3 amplifies f32 drift over steps
    key = jax.random.PRNGKey(7)
    model = ProteinReDiffModel(CFG)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_pos, j_logits = model.sample(params, dict(jb), key, mask_prob=MASK_PROB)
    j_extra, j_inv = model.inference_extra_mask(key, jb["residue_mask"], MASK_PROB)

    net = P.ProteinReDiffNet(CFG)
    net.load_state_dict(state_dict_from_jax(params, CFG))
    B, N = batch["residue_mask"].shape
    noise = jax_draws(key, B, N, CFG.num_steps)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    prepared = P.prepare_batch(tb, MASK_PROB, noise.mask_scores)
    np.testing.assert_array_equal(prepared["residue_extra_mask"].numpy(), np.asarray(j_extra))
    np.testing.assert_array_equal(prepared["residue_inv_extra_mask"].numpy(), np.asarray(j_inv))
    assert 0 < prepared["residue_inv_extra_mask"].sum() < batch["residue_mask"].sum()

    pos, logits = P.sample(net, tb, MASK_PROB, noise=noise)
    assert np.isfinite(pos.numpy()).all() and np.isfinite(logits.numpy()).all()
    np.testing.assert_allclose(pos.numpy(), np.asarray(j_pos), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=1e-4)


def test_generator_draws_are_seeded():
    """Without injected noise the sampler draws from its generator: the
    same seed gives the same sample, another seed another one."""
    torch.manual_seed(0)
    net = P.ProteinReDiffNet(CFG).eval()
    tb = {k: torch.from_numpy(v) for k, v in make_batch(B=1, seed=4).items()}
    run = lambda seed: P.sample(net, tb, MASK_PROB, torch.Generator().manual_seed(seed))  # noqa
    a, b, c = run(1), run(1), run(2)
    torch.testing.assert_close(a[0], b[0], atol=0, rtol=0)
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (1, 16, 3) and a[1].shape == (1, 16, 21)


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_schedule_matches_jax(schedule):
    from protein_redesign_tpu.models.diffusion import DiffusionSchedule as JaxSchedule
    from protein_redesign_tpu_torch.models.diffusion import DiffusionSchedule

    import dataclasses

    ref = JaxSchedule.create(1000, schedule)
    port = DiffusionSchedule.create(1000, schedule)
    for field in dataclasses.fields(port):
        np.testing.assert_array_equal(getattr(port, field.name).numpy(),
                                      np.asarray(getattr(ref, field.name)), err_msg=field.name)


def test_guard_is_identity_on_healthy_state():
    x = torch.tensor([[1.0, -2.0], [float("nan"), float("inf")], [-float("inf"), 3e4]])
    out = P.guard(x)
    torch.testing.assert_close(out, torch.tensor([[1.0, -2.0], [0.0, 1e4], [-1e4, 1e4]]))
    torch.testing.assert_close(P.guard(x[:1]), x[:1], atol=0, rtol=0)
