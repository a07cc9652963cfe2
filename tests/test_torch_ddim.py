"""The port's DDIM sampler against ``ProteinReDiffModel.sample_ddim`` (Pallas
attention in interpret mode) over a 4-step tau grid of a 12-step schedule,
at eta 0 and eta 1, with perturbed weights.

``jax.random`` streams cannot be reproduced in torch, so the test redoes the
JAX sampler's key splits (`prdiff.py:721-739, 1049-1051, 1161`) to recover
its mask scores, initial coordinates and sequence, and each tau's noise, and
injects them into the port. Tolerance 1e-4 in float32 on the final
positions (Å) and sequence logits.

Also the serving features of ``SamplingRunner`` at tiny width: trajectory
frames, ``pad_to_batch``, the per-run ``mask_prob`` and the sampler
arguments.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_generate import TINY  # noqa: E402
from test_torch_net import CFG, make_batch, perturbed_params  # noqa: E402
from test_torch_sampler import jax_draws  # noqa: E402

from protein_redesign_tpu.models.prdiff import (  # noqa: E402
    ProteinReDiffModel,
    ddim_tau_grid,
    ddim_taus_np,
)
from protein_redesign_tpu_torch.models import prdiff as P  # noqa: E402
from protein_redesign_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

DDIM_CFG = CFG.replace(num_steps=12)
DDIM_STEPS, MASK_PROB = 4, 0.5


@pytest.mark.parametrize("num_steps,ddim_steps", [(12, 4), (1000, 50), (64, 64), (4, 6)])
def test_tau_grid_matches_jax(num_steps, ddim_steps):
    taus, taus_prev = P.ddim_tau_grid(num_steps, ddim_steps)
    j_taus, j_prev = ddim_tau_grid(num_steps, ddim_steps)
    np.testing.assert_array_equal(taus, ddim_taus_np(num_steps, ddim_steps))
    np.testing.assert_array_equal(taus, np.asarray(j_taus))
    np.testing.assert_array_equal(taus_prev, np.asarray(j_prev))
    assert taus[-1] == 0 and taus_prev[-1] == -1


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_sample_ddim_matches_jax(eta):
    batch = make_batch(B=2, seed=5)
    params = perturbed_params(DDIM_CFG, seed=5, scale=0.1)
    key = jax.random.PRNGKey(11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_pos, j_logits = ProteinReDiffModel(DDIM_CFG).sample_ddim(
        params, jb, key, ddim_steps=DDIM_STEPS, eta=eta, mask_prob=MASK_PROB)

    net = P.ProteinReDiffNet(DDIM_CFG)
    net.load_state_dict(state_dict_from_jax(params, DDIM_CFG))
    B, N = batch["residue_mask"].shape
    noise = jax_draws(key, B, N, DDIM_STEPS)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pos, logits = P.sample_ddim(net, tb, DDIM_STEPS, eta, MASK_PROB, noise=noise)
    assert np.isfinite(pos.numpy()).all() and np.isfinite(logits.numpy()).all()
    np.testing.assert_allclose(pos.numpy(), np.asarray(j_pos), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=1e-4)


def test_ddim_coord_update_guards():
    """A repeated tau (a_t = a_prev) leaves sigma and the direction
    coefficient finite at eta 0 and 1, and the -1 sentinel's a_prev = 1 makes
    the last step return the centred x0 prediction."""
    g = torch.Generator().manual_seed(0)
    z, eps, noise = (torch.randn(1, 6, 3, generator=g) for _ in range(3))
    mask = torch.ones(1, 6)
    a = torch.tensor(0.7)
    for eta in (0.0, 1.0):
        out = P.ddim_coord_update(z, eps, mask, a, a * (1 + 1e-7), eta, noise)
        assert torch.isfinite(out).all()
    last = P.ddim_coord_update(z, eps, mask, a, torch.tensor(1.0), 1.0, noise)
    x0 = P.remove_mean((z - torch.sqrt(1 - a) * eps) / torch.sqrt(a), mask)
    torch.testing.assert_close(last, x0)


def _runner_inputs(n):
    """``n`` copies of one featurized complex (8 residues, 2 ligand atoms)."""
    from protein_redesign_tpu_torch.chem.mol import mol_from_smiles, update_mol_positions
    from protein_redesign_tpu_torch.chem.protein import protein_from_sequence
    from protein_redesign_tpu_torch.cli.common import complex_data

    mol = update_mol_positions(mol_from_smiles("CC"), np.zeros((2, 3)))
    return [complex_data(protein_from_sequence("ACDEFGHI"), mol,
                         np.zeros((8, TINY.esm_dim), np.float32))] * n


def _runner(**kw):
    """A runner over a tiny net whose every weight is perturbed (its
    zero-initialised output layers would hide the inputs)."""
    from protein_redesign_tpu_torch.cli.common import SamplingRunner

    torch.manual_seed(0)
    net = P.ProteinReDiffNet(TINY).eval()
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.1 * torch.randn_like(p))
    return SamplingRunner(net, "cpu", mask_prob=0.5, buckets=(16,), **kw)


@pytest.mark.parametrize("sampler,frames", [("ddpm", 2), ("ddim", 4)])
def test_runner_trajectory_frames(sampler, frames):
    """K frames [K, n, 3] in Å, the last the final positions, and the same
    sample with and without capture."""
    runner = _runner(batch_size=2, sampler=sampler, ddim_steps=4)
    datas = _runner_inputs(2)
    plain = runner.run(datas, seed=3)
    captured = runner.run(datas, seed=3, trajectory=frames)
    for (pos, logits), (pos2, logits2, traj) in zip(plain, captured):
        assert traj.shape == (frames,) + pos.shape
        np.testing.assert_array_equal(traj[-1], pos)
        np.testing.assert_array_equal(pos2, pos)
        np.testing.assert_array_equal(logits2, logits)
    with pytest.raises(ValueError, match="divisor"):
        runner.run(datas, seed=3, trajectory=3)


def test_runner_pad_to_batch_and_mask_prob():
    """pad_to_batch fills the last group with its last complex, so every
    batch has batch_size rows; a run's mask_prob overrides the runner's."""
    runner = _runner(batch_size=2, pad_to_batch=True)
    out = runner.run(_runner_inputs(3), seed=0)
    assert len(out) == 3 and all(np.isfinite(p).all() for p, _ in out)
    assert [rows for _, rows, _, _ in runner.timings] == [2, 2]
    first = runner.run(_runner_inputs(1), seed=0, mask_prob=0.0)
    again = runner.run(_runner_inputs(1), seed=0, mask_prob=0.0)
    other = runner.run(_runner_inputs(1), seed=0, mask_prob=1.0)
    np.testing.assert_array_equal(first[0][1], again[0][1])
    assert not np.array_equal(first[0][1], other[0][1])


def test_runner_sampler_arguments():
    with pytest.raises(ValueError, match="ddim sampler"):
        _runner(sampler="ddpm", eta=0.5)
    with pytest.raises(ValueError, match="deterministic"):
        _runner(sampler="ddim_parallel", eta=0.5)
    with pytest.raises(ValueError, match="Unknown sampler"):
        _runner(sampler="euler")
    assert _runner(sampler="ddim_parallel", ddim_steps=5).step_count() == 5
    assert _runner(sampler="ddim", ddim_steps=7).step_count() == 7
    assert _runner().step_count() == TINY.num_steps
