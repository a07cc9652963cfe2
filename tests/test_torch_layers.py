"""The port's layer vocabulary against the flax modules of
``protein_redesign_tpu/models/layers.py`` on the same inputs and weights.

Weights are the flax init with seeded noise added to every parameter, so
the zero-initialised 'final' and 'gating' layers are exercised too. The
JAX GatedAttention runs its Pallas kernel in interpret mode. Tolerance
1e-5 in float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from protein_redesign_tpu.chem.features import ATOM_FEATURE_SIZES, BOND_FEATURE_SIZES  # noqa: E402
from protein_redesign_tpu.models import layers as J  # noqa: E402
from protein_redesign_tpu_torch.models import layers as T  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def perturbed_init(module, *args, seed=0, scale=0.3):
    """Flax params of ``module`` with seeded noise on every leaf, as numpy."""
    params = module.init(jax.random.PRNGKey(seed), *args)["params"]
    rng = np.random.RandomState(seed + 1)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + scale * rng.randn(*p.shape).astype(np.float32), params
    )


def flax_to_torch(tree, rename=None):
    """A flax param tree as a torch state_dict: Dense kernels transposed,
    LayerNorm scale -> weight, the Dense_0/LayerNorm_0 levels dropped, and
    path components renamed through ``rename``."""
    rename = rename or {}
    sd = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(p.key) for p in path]
        leaf = np.asarray(leaf, np.float32)
        if keys[-1] == "kernel":
            keys[-1], leaf = "weight", leaf.T
        elif keys[-1] == "scale":
            keys[-1] = "weight"
        keys = [rename.get(k, k) for k in keys if k not in ("Dense_0", "LayerNorm_0")]
        sd[".".join(keys)] = torch.from_numpy(np.ascontiguousarray(leaf))
    return sd


TRANSITION = {"PRLinear_0": "1", "PRLinear_1": "3"}


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
def test_gated_attention(with_bias):
    B, N, D, H, C = 2, 16, 12, 2, 8
    x = _x(B, N, D)
    mask = (np.random.RandomState(1).rand(B, N) > 0.25).astype(np.float32)
    bias = _x(B, H, N, N, seed=2) if with_bias else None
    jmod = J.GatedAttention(C, H, use_pallas=True)
    jb = None if bias is None else jnp.asarray(bias)
    params = perturbed_init(jmod, jnp.asarray(x), jnp.asarray(mask), jb)
    ref = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), jb)

    mod = T.GatedAttention(D, C, H)
    mod.load_state_dict(flax_to_torch(params))
    with torch.no_grad():
        out = mod(torch.from_numpy(x), torch.from_numpy(mask),
                  None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_transition_mlp():
    x = _x(2, 5, 7, 12)
    jmod = J.TransitionMLP(48, 12, out_bias=False)
    params = perturbed_init(jmod, jnp.asarray(x))
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    mod = T.TransitionMLP(12, 48, 12, out_bias=False)
    mod.load_state_dict(flax_to_torch(params, TRANSITION))
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("affine", [False, True])
def test_layer_norm(affine):
    x = 3.0 + 2.0 * _x(4, 9, 24)
    jmod = J.LayerNorm(affine=affine)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    mod = T.LayerNorm(24, affine=affine)
    if affine:
        params = perturbed_init(jmod, jnp.asarray(x))
        variables = {"params": params}
        mod.load_state_dict(flax_to_torch(params["LayerNorm_0"]))
    ref = jmod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["atom", "bond"])
def test_categorical_embedding(kind, dtype):
    """bf16 too: the 1/sqrt(F) scale is rounded to bf16 first, as JAX
    rounds a weak Python scalar, so the two agree bit for bit."""
    sizes = ATOM_FEATURE_SIZES if kind == "atom" else BOND_FEATURE_SIZES
    rng = np.random.RandomState(4)
    feats = np.stack([rng.randint(0, s, (2, 6)) for s in sizes], axis=-1).astype(np.int64)
    jcls = J.AtomEmbedding if kind == "atom" else J.BondEmbedding
    params = perturbed_init(jcls(10), jnp.asarray(feats))
    ref = jcls(10, dtype=jnp.dtype(dtype)).apply({"params": params}, jnp.asarray(feats))
    table = np.asarray(params["FusedCategoricalEmbedding_0"]["table"])
    mod = (T.AtomEmbedding if kind == "atom" else T.BondEmbedding)(10, getattr(torch, dtype))
    parts = np.split(table, np.cumsum(sizes)[:-1])
    mod.load_state_dict({f"embeddings.{i}.weight": torch.from_numpy(p.copy())
                         for i, p in enumerate(parts)})
    with torch.no_grad():
        out = mod(torch.from_numpy(feats)).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(out, np.asarray(ref, np.float32))
    else:
        np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_embed_and_projections():
    idx = np.random.RandomState(5).randint(0, 8, (3, 4))
    jmod = J.Embed(8, 6)
    params = perturbed_init(jmod, jnp.asarray(idx))
    mod = T.Embed(8, 6)
    mod.load_state_dict({"weight": torch.from_numpy(np.asarray(params["table"]))})
    with torch.no_grad():
        np.testing.assert_allclose(
            mod(torch.from_numpy(idx)).numpy(),
            np.asarray(jmod.apply({"params": params}, jnp.asarray(idx))), **TOL,
        )
    d = np.abs(_x(3, 5, 5, seed=6))
    rbf = J.RadialBasisProjection(16).apply({}, jnp.asarray(d))
    sin = J.SinusoidalProjection(8).apply({}, jnp.asarray(d))
    np.testing.assert_allclose(T.RadialBasisProjection(16)(torch.from_numpy(d)).numpy(),
                               np.asarray(rbf), **TOL)
    np.testing.assert_allclose(T.SinusoidalProjection(8)(torch.from_numpy(d)).numpy(),
                               np.asarray(sin), **TOL)


def test_masked_softmax():
    logits = _x(2, 3, 7)
    mask = (np.random.RandomState(7).rand(2, 1, 7) > 0.3).astype(np.float32)
    ref = J.masked_softmax(jnp.asarray(logits), jnp.asarray(mask))
    out = T.masked_softmax(torch.from_numpy(logits), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("init", ["default", "relu", "glorot", "normal", "gating", "final"])
def test_init_vocabulary_statistics(init):
    """Torch init matches the flax initialiser's support and spread."""
    torch.manual_seed(0)
    lin = T.PRLinear(256, 128, init=init)
    w = lin.weight.detach().numpy().T  # flax [in, out]
    ref = np.asarray(J.make_initializer(init)(jax.random.PRNGKey(0), (256, 128)))
    np.testing.assert_allclose(w.std(), ref.std(), rtol=0.05, atol=1e-6)
    np.testing.assert_allclose(np.abs(w).max(), np.abs(ref).max(), rtol=0.1, atol=1e-6)
    assert float(lin.bias.detach().mean()) == (1.0 if init == "gating" else 0.0)
