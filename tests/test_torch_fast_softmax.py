"""K1 fast (``cfg.fast_softmax``: the bf16 softmax of triangle attention)
against the JAX package on the CPU, its Pallas kernels in interpret mode:

- op level: ``rows_attention_fast_reference`` against
  ``_rows_attention_impl(..., fast=True)`` in bf16 and f32, with ~30% masked
  keys, a fully masked row and logits of |l| ~ 5. Logit sums taken in
  another order flip bf16 roundings, so the tolerance is 1e-2 of max |out|;
  and the mean abs error must be at least 2x smaller than against the same
  call with ``fast=False``, so an ignored flag fails;
- routing: ``gated_attention_core`` reaches K1 fast only with ``fast`` and
  ``kernel_bwd`` off, as the JAX ``fused_attention`` drops the flag;
- net level: a 2-block ``ProteinReDiffNet`` with ``fast_softmax`` and
  ``use_pallas_bwd`` off against the JAX net (Pallas, interpret mode): in
  f32 at 1e-2 of max |out| (bf16 roundings flip, as at op level), in bf16
  at 2e-2 relative norm (the two bf16 nets round at other points too, as
  ``test_torch_denoiser.py`` holds them); the default ``use_pallas_bwd``
  drops the flag on both sides;
- gradient: the f32 loss gradient with ``use_pallas_bwd`` off (kernel
  forward, plain VJP of the f32 reference backward) against the JAX
  package's, per tensor at 1e-4 as ``test_torch_loss.py`` holds it.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_loss import LOSS_CFG, jax_train_draws, key_for_policy  # noqa: E402
from test_torch_net import CFG, make_batch, perturbed_params  # noqa: E402

from protein_redesign_tpu.models.prdiff import ProteinReDiffModel  # noqa: E402
from protein_redesign_tpu.ops.pallas_attention import _rows_attention_impl  # noqa: E402
from protein_redesign_tpu_torch.models import prdiff as P  # noqa: E402
from protein_redesign_tpu_torch.ops import attention as A  # noqa: E402
from protein_redesign_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
SCALE = 0.25


def _inputs(jdt, R=6, N=48, H=4, C=16, seed=0):
    """q, k, v rounded to ``jdt`` (numpy f32), mask [R, N] with row 1 fully
    masked; q and k scaled so that |logits| ~ 5."""
    rng = np.random.RandomState(seed)
    q, k = (2.2 * rng.randn(R, N, H, C).astype(np.float32) for _ in range(2))
    v = rng.randn(R, N, H, C).astype(np.float32)
    mask = (rng.rand(R, N) > 0.3).astype(np.float32)
    mask[1] = 0.0
    q, k, v = (np.asarray(jnp.asarray(x, jdt).astype(jnp.float32)) for x in (q, k, v))
    return q, k, v, mask


def _jax_rows(q, k, v, mask, jdt, fast):
    """The JAX K1 (``fast``: K1 fast) in interpret mode, [R, N, H, C] f32."""
    t = lambda x: jnp.swapaxes(jnp.asarray(x, jdt), 1, 2)  # noqa: E731
    out = _rows_attention_impl(t(q) * jnp.asarray(SCALE, jdt), t(k), t(v), jnp.asarray(mask),
                               True, fast=fast)
    return np.asarray(jnp.swapaxes(out, 1, 2).astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fast_reference_matches_jax_fast_kernel(dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v, mask = _inputs(jdt)
    j_fast = _jax_rows(q, k, v, mask, jdt, fast=True)
    j_slow = _jax_rows(q, k, v, mask, jdt, fast=False)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    before = dict(A.LAUNCHES)
    got = A.rows_attention_fast(tq, tk, tv, torch.from_numpy(mask), SCALE)
    assert A.LAUNCHES == before  # CPU tensors never launch a kernel
    assert got.dtype == tdt
    got = got.float().numpy()
    np.testing.assert_array_equal(
        got, A.rows_attention_fast_reference(tq, tk, tv, torch.from_numpy(mask), SCALE)
        .float().numpy())
    assert np.isfinite(got).all()
    assert np.abs(got - j_fast).max() <= 1e-2 * np.abs(j_fast).max()
    assert np.abs(got - j_fast).mean() * 2 <= np.abs(got - j_slow).mean()
    # the fully masked row averages v, in both routes
    np.testing.assert_allclose(got[1], j_fast[1], atol=1e-2 * np.abs(j_fast).max())


def test_fast_reference_matches_jax_fast_kernel_at_head_width_256():
    """Past head width 128, where the f32 K1 fast takes its wide body on the
    card: the plain version (the CPU route) against the JAX K1 fast in
    interpret mode, f32, one head of 256, the fully masked row included."""
    jdt = jnp.float32
    q, k, v, mask = _inputs(jdt, R=3, N=40, H=1, C=256, seed=4)
    q = 0.25 * q  # |logits| ~ 5 at C = 256
    j_fast = _jax_rows(q, k, v, mask, jdt, fast=True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    before = dict(A.LAUNCHES)
    got = A.rows_attention_fast(tq, tk, tv, torch.from_numpy(mask), SCALE)
    assert A.LAUNCHES == before
    want = A.rows_attention_fast_reference(tq, tk, tv, torch.from_numpy(mask), SCALE)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    got = got.numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - j_fast).max() <= 1e-2 * np.abs(j_fast).max()
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(0), got[1].shape),
                               atol=1e-2 * np.abs(j_fast).max())


def test_rows_attention_fast_needs_a_mask():
    q = torch.zeros(2, 4, 1, 8)
    with pytest.raises(ValueError, match="mask"):
        A.rows_attention_fast(q, q, q, None, SCALE)


@pytest.mark.parametrize("fast,kernel_bwd,route", [
    (True, False, "fast"), (True, True, "plain"), (False, False, "plain"),
])
def test_core_reaches_fast_only_without_kernel_bwd(monkeypatch, fast, kernel_bwd, route):
    calls = []
    real = A.rows_attention_fast_reference
    monkeypatch.setattr(A, "rows_attention_fast_reference",
                        lambda *a: calls.append(1) or real(*a))
    q, k, v, mask = (torch.from_numpy(x) for x in _inputs(jnp.float32, R=2, N=8))
    out = A.gated_attention_core(q, k, v, mask, None, SCALE, fast, kernel_bwd)
    want = (real if route == "fast" else
            lambda *a: A.attention_reference(*a[:4], None, a[4]))(q, k, v, mask, SCALE)
    assert len(calls) == (route == "fast")
    torch.testing.assert_close(out, want, atol=0, rtol=0)


def _port_net(cfg, params, batch, inputs):
    net = P.ProteinReDiffNet(cfg)
    net.load_state_dict(state_dict_from_jax(params, cfg))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        out = net(tb, *(torch.from_numpy(a) for a in inputs))
    return [o.float().numpy() for o in out]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_net_fast_matches_jax(monkeypatch, dtype):
    batch = make_batch(B=2, seed=3)
    params = perturbed_params(CFG, seed=3)
    rng = np.random.RandomState(13)
    B, N = batch["residue_mask"].shape
    inputs = (rng.randn(B, N, 3).astype(np.float32), rng.randn(B, N, 21).astype(np.float32),
              batch["atom_mask"] + batch["residue_mask"], rng.randint(0, CFG.num_steps, (B,)))
    cfg = CFG.replace(dtype=dtype, fast_softmax=True, use_pallas_bwd=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    z, seq_t, mask, t = inputs
    want = jax.jit(ProteinReDiffModel(cfg).apply)(
        params, jb, jnp.asarray(z), jnp.asarray(seq_t), jnp.asarray(mask),
        jnp.asarray(t, jnp.int32))
    calls = []
    real = A.rows_attention_fast_reference
    monkeypatch.setattr(A, "rows_attention_fast_reference",
                        lambda *a: calls.append(1) or real(*a))
    for got, w in zip(_port_net(cfg, params, batch, inputs), want):
        w = np.asarray(w, np.float32)
        assert np.isfinite(got).all()
        if dtype == "float32":
            assert np.abs(got - w).max() <= 1e-2 * np.abs(w).max()
        else:  # bf16 nets round at other points too (test_torch_denoiser.py)
            assert np.linalg.norm(got - w) <= 2e-2 * np.linalg.norm(w)
    # both triangle attentions of each block take K1 fast ...
    assert len(calls) == 2 * CFG.num_blocks
    # ... and none under the default use_pallas_bwd, which drops the flag
    del calls[:]
    _port_net(cfg.replace(use_pallas_bwd=True), params, batch, inputs)
    assert not calls


def test_plain_vjp_gradient_matches_jax(monkeypatch):
    cfg = LOSS_CFG.replace(use_pallas=True, use_pallas_bwd=False)
    batch = make_batch(B=2, seed=5)
    params = perturbed_params(cfg, seed=5)
    key = key_for_policy("random")
    model = ProteinReDiffModel(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j_grads = jax.jit(jax.grad(lambda p: model.loss(p, jb, key, training=True)[0]))(params)

    net = P.ProteinReDiffNet(cfg)
    net.load_state_dict(state_dict_from_jax(params, cfg))
    B, N = batch["residue_mask"].shape
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    bwd_calls = []
    real_bwd = A.rows_attention_bwd_reference
    monkeypatch.setattr(A, "rows_attention_bwd_reference",
                        lambda *a: bwd_calls.append(1) or real_bwd(*a))
    monkeypatch.setattr(A, "_WARNED", set())
    with pytest.warns(UserWarning, match="plain VJP backward"):
        mean, _ = P.loss(net, tb, noise=jax_train_draws(key, B, N, cfg))
        mean.backward()
    assert not bwd_calls  # no K7: the plain VJP instead

    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_grads), cfg)
    names = [name for name, _ in net.named_parameters()]
    total = np.sqrt(sum(np.sum(ref[name].numpy() ** 2) for name in names))
    for name, p in net.named_parameters():
        b = ref[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - b)
        assert err <= 1e-4 * max(np.linalg.norm(b), 1e-3 * total), name
