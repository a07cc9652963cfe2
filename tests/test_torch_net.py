"""Weights carried between the packages, and the port's ProteinReDiffNet
forward against the JAX net (Pallas attention in interpret mode) on a
``__graft_entry__._make_batch``-style batch with perturbed weights.
The weights round trip is exact; the forward tolerance is 1e-4 in float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _make_batch  # noqa: E402
from protein_redesign_tpu.config import ModelConfig  # noqa: E402
from protein_redesign_tpu.models.prdiff import ProteinReDiffModel  # noqa: E402
from protein_redesign_tpu.utils.convert import convert_state_dict  # noqa: E402
from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet  # noqa: E402
from protein_redesign_tpu_torch.utils.weights import (  # noqa: E402
    load_checkpoint,
    save_checkpoint,
    state_dict_from_jax,
)

TINY = dict(
    esm_dim=16, time_dim=8, dist_dim=8, single_dim=32, pair_dim=16,
    head_dim=8, num_heads=2, num_blocks=2, num_steps=4,
    dtype="float32", remat=False,
)
CFG = ModelConfig(**TINY, use_pallas=True)


def make_batch(B=2, n_atoms=5, n_res=9, bucket=16, seed=0):
    b = _make_batch(n_atoms, n_res, bucket, esm_dim=CFG.esm_dim, batch=B)
    rng = np.random.RandomState(seed)
    b["atom_feats"][:, :n_atoms] = rng.randint(0, 2, (B, n_atoms, 9))
    b["bond_mask"][:, :n_atoms, :n_atoms] = rng.rand(B, n_atoms, n_atoms) > 0.5
    b["bond_distance"][:, :n_atoms, :n_atoms] = rng.randint(0, 9, (B, n_atoms, n_atoms))
    b["residue_esm"][:, n_atoms:n_atoms + n_res] = rng.randn(B, n_res, CFG.esm_dim)
    b["residue_chain_index"][:, n_atoms + n_res // 2:n_atoms + n_res] = 1
    return b


def perturbed_params(cfg, seed=0, scale=0.3):
    """JAX params: the port's seeded init plus seeded noise on every
    parameter, converted with ``convert_state_dict`` (whose tree matches a
    flax init, `test_convert_structure.py`)."""
    torch.manual_seed(seed)
    sd = ProteinReDiffNet(cfg).state_dict()
    rng = np.random.RandomState(seed + 1)
    sd = {k: v.numpy() + scale * rng.randn(*v.shape).astype(np.float32) for k, v in sd.items()}
    return convert_state_dict(sd, cfg)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_weights_round_trip_exact():
    params = perturbed_params(CFG)
    sd = state_dict_from_jax(params, CFG)
    back = _flat(convert_state_dict({k: v.numpy() for k, v in sd.items()}, CFG))
    orig = _flat(params)
    assert back.keys() == orig.keys()
    for k in orig:
        np.testing.assert_array_equal(back[k], orig[k])
    # the port registers exactly these names: a strict load succeeds
    net = ProteinReDiffNet(CFG)
    net.load_state_dict(sd, strict=True)
    assert set(net.state_dict()) == set(sd)


def test_checkpoint_directory_round_trip(tmp_path):
    torch.manual_seed(0)
    net = ProteinReDiffNet(CFG)
    save_checkpoint(tmp_path, net.state_dict(), CFG)
    sd, cfg = load_checkpoint(tmp_path, num_steps=7)
    assert cfg == CFG.replace(num_steps=7)
    for k, v in net.state_dict().items():
        torch.testing.assert_close(sd[k], v, atol=0, rtol=0)


def test_forward_matches_jax():
    batch = make_batch(B=2, seed=2)
    params = perturbed_params(CFG, seed=2)
    rng = np.random.RandomState(12)
    B, N = batch["residue_mask"].shape
    z = rng.randn(B, N, 3).astype(np.float32)
    seq_t = rng.randn(B, N, 21).astype(np.float32)
    mask = batch["atom_mask"] + batch["residue_mask"]
    t = rng.randint(0, CFG.num_steps, (B,))

    j_noise, j_seq = ProteinReDiffModel(CFG).apply(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(z),
        jnp.asarray(seq_t), jnp.asarray(mask), jnp.asarray(t, jnp.int32),
    )
    net = ProteinReDiffNet(CFG)
    net.load_state_dict(state_dict_from_jax(params, CFG))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        noise, seq = net(tb, torch.from_numpy(z), torch.from_numpy(seq_t),
                         torch.from_numpy(mask), torch.from_numpy(t))
    np.testing.assert_allclose(noise.numpy(), np.asarray(j_noise), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(seq.numpy(), np.asarray(j_seq), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("field,value", [
    ("param_dtype", "bfloat16"), ("self_cond", True), ("seq_process", "absorbing"),
    ("seq_reverse", "ancestral"), ("fast_softmax", True), ("attn_chunk", 64),
    ("sequence_parallel", True), ("use_pallas_trimul", True),
    ("use_pallas_transition", True), ("use_pallas_outer", True),
    ("use_pallas_fused_gated", True),
])
def test_fields_outside_the_slice_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        ProteinReDiffNet(CFG.replace(**{field: value}))
