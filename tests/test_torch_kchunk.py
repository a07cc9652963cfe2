"""The port's K-chunk attention regime (K3, K5, K6 and the switch) against
the JAX package on the CPU, with the switch lowered on both sides to N = 16
and the chunk to 8, as ``tests/test_pallas.py::TestKChunkedRowsKernel``
lowers it, so N = 32 runs in four key chunks:

- K3's plain version against the three JAX variants in interpret mode (the
  CN grid kernel, the NC grid kernel, the fori kernel);
- K5's out, m and log s, separately, with fully masked rows;
- K6's dq, dk, dv against ``_rows_attention_kchunk_bwd_cn`` and against
  ``jax.grad`` through ``fused_attention(kernel_bwd=True)``;
- ``kchunk_select`` against ``_kchunk_select`` over the bucket ladder, at
  the real switch points;
- a 2-block f32 net's loss and parameter gradients against the JAX model
  with ``use_pallas=True`` in the K-chunk regime.

Tolerances: 1e-5 x max(1, max|ref|) in float32 (the same algorithm, sums
in another order) and 2e-2 x max(1, max|ref|) in bfloat16 (one flip of a
bf16 rounding of a probability or of dS); the net as ``test_torch_loss.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_loss import jax_train_draws, key_for_policy  # noqa: E402
from test_torch_net import CFG, make_batch, perturbed_params  # noqa: E402

import protein_redesign_tpu.ops.pallas_attention as pa  # noqa: E402
from protein_redesign_tpu.config import DataConfig  # noqa: E402
from protein_redesign_tpu.models.prdiff import ProteinReDiffModel  # noqa: E402
from protein_redesign_tpu_torch.models import prdiff as P  # noqa: E402
from protein_redesign_tpu_torch.ops import attention as A  # noqa: E402
from protein_redesign_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

SCALE = 0.35
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.fixture
def kchunk_regime(monkeypatch):
    """The switch at N = 16 in both dtypes and a chunk of 8, on both sides."""
    for mod in (A, pa):
        monkeypatch.setattr(mod, "ROWS_KCHUNK_MIN_N", 16)
        monkeypatch.setattr(mod, "ROWS_KCHUNK_MIN_N_F32", 16)
    monkeypatch.setattr(A, "KCHUNK", 8)
    monkeypatch.setattr(pa, "_KCHUNK_TARGET", 8)


def _inputs(R=3, N=32, H=2, C=8, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(R, N, H, C).astype(np.float32) for _ in range(4))
    mask = (rng.rand(R, N) > 0.25).astype(np.float32)
    mask[1] = 0.0  # a fully masked row
    return q, k, v, g, mask


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    tol = TOL[dtype] * max(1.0, float(np.abs(want).max()))
    assert err <= tol, (err, tol)


def _torch(arrays, dtype):
    return [torch.from_numpy(x).to(DTYPES[dtype][1]) for x in arrays]


def _swap(x):
    return jnp.swapaxes(x, 1, 2)


VARIANTS = {"cn_grid": (True, True), "nc_grid": (True, False), "fori": (False, True)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_k3_plain_matches_jax_variants(kchunk_regime, monkeypatch, variant, dtype):
    grid, cn = VARIANTS[variant]
    monkeypatch.setattr(pa, "_KCHUNK_GRID", grid)
    monkeypatch.setattr(pa, "_KCHUNK_CN", cn)
    q, k, v, _, mask = _inputs(seed=1)
    jdt = DTYPES[dtype][0]
    fused = pa.fused_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                               jnp.asarray(mask), None, SCALE, True)
    assert pa._kchunk_select(32, jdt) == 8 and A.kchunk_select(32, DTYPES[dtype][1]) == 8
    tq, tk, tv = _torch((q, k, v), dtype)
    before = dict(A.LAUNCHES)
    plain = A.rows_attention_kchunk_reference(tq, tk, tv, torch.from_numpy(mask), SCALE)
    routed = A.rows_attention(tq, tk, tv, torch.from_numpy(mask), SCALE)
    assert A.LAUNCHES == before  # CPU tensors never launch a kernel
    assert plain.dtype == DTYPES[dtype][1]
    _close(plain.float().numpy(), jnp.asarray(fused, jnp.float32), dtype)
    torch.testing.assert_close(routed, plain, atol=0, rtol=0)
    # the fully masked row: uniform weights, the mean of v
    _close(plain[1].float().numpy(), np.broadcast_to(
        np.asarray(tv[1].float()).mean(0, keepdims=True), q[1].shape), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k5_out_and_split_stats_match_jax(kchunk_regime, dtype):
    jdt = DTYPES[dtype][0]
    q, k, v, _, mask = _inputs(seed=2)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    j_out, j_m, j_logs = pa._rows_attention_fwd_stats_impl(
        _swap(jq * SCALE), _swap(jk), _swap(jv), jnp.asarray(mask), True)
    out, m, logs = A.rows_attention_kchunk_stats(*_torch((q, k, v), dtype),
                                                 torch.from_numpy(mask), SCALE)
    assert m.dtype == logs.dtype == torch.float32 and m.shape == logs.shape == (3, 2, 32)
    _close(out.float().numpy(), _swap(j_out).astype(jnp.float32), dtype)
    _close(m.numpy(), j_m, dtype)
    np.testing.assert_allclose(logs.numpy(), np.asarray(j_logs), atol=1e-5, rtol=1e-5)
    # fully masked row: m is the fill itself and log s = log N, exactly as in JAX
    assert (m[1] == A.NEG_INF).all() and (np.asarray(j_m)[1] == A.NEG_INF).all()
    np.testing.assert_allclose(logs[1].numpy(), np.log(32.0), rtol=1e-6)
    # K3 is K5's output without the stats
    torch.testing.assert_close(
        A.rows_attention_kchunk(*_torch((q, k, v), dtype), torch.from_numpy(mask), SCALE),
        out, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k6_matches_jax_kchunk_bwd_cn(kchunk_regime, dtype):
    jdt = DTYPES[dtype][0]
    q, k, v, g, mask = _inputs(seed=3)
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    dqt, dkt, dvt = pa._rows_attention_kchunk_bwd_cn(
        _swap(jq * SCALE), _swap(jk), _swap(jv), jnp.asarray(mask), _swap(jg), 8, 1, True)
    j_grads = (_swap(dqt) * SCALE, _swap(dkt), _swap(dvt))
    tq, tk, tv, tg = _torch((q, k, v, g), dtype)
    tm = torch.from_numpy(mask)
    out, m, logs = A.rows_attention_kchunk_stats(tq, tk, tv, tm, SCALE)
    before = dict(A.LAUNCHES)
    grads = A.rows_attention_kchunk_bwd(tq, tk, tv, tm, tg, out, m, logs, SCALE)
    assert A.LAUNCHES == before
    for got, want in zip(grads, j_grads):
        assert got.dtype == DTYPES[dtype][1]
        _close(got.float().numpy(), want.astype(jnp.float32), dtype)
    # the fully masked row: uniform P feeds dv, dS is zero
    assert torch.count_nonzero(grads[0][1]) == 0 and torch.count_nonzero(grads[1][1]) == 0
    assert torch.count_nonzero(grads[2][1]) > 0


def test_k6_matches_jax_kchunk_bwd_cn_at_head_width_256(kchunk_regime):
    """Past head width 128, where K6 takes its wide body on the card: the
    plain K6 from the plain K5's split stats against the JAX K6 in
    interpret mode, f32, one head of 256, the fully masked row included."""
    q, k, v, g, mask = _inputs(R=2, N=32, H=1, C=256, seed=5)
    jq, jk, jv, jg = (jnp.asarray(x, jnp.float32) for x in (q, k, v, g))
    dqt, dkt, dvt = pa._rows_attention_kchunk_bwd_cn(
        _swap(jq * SCALE), _swap(jk), _swap(jv), jnp.asarray(mask), _swap(jg), 8, 1, True)
    j_grads = (_swap(dqt) * SCALE, _swap(dkt), _swap(dvt))
    tq, tk, tv, tg = _torch((q, k, v, g), "f32")
    tm = torch.from_numpy(mask)
    out, m, logs = A.rows_attention_kchunk_stats(tq, tk, tv, tm, SCALE)
    before = dict(A.LAUNCHES)
    grads = A.rows_attention_kchunk_bwd(tq, tk, tv, tm, tg, out, m, logs, SCALE)
    assert A.LAUNCHES == before
    for got, want in zip(grads, j_grads):
        _close(got.numpy(), want, "f32")
    assert torch.count_nonzero(grads[0][1]) == 0 and torch.count_nonzero(grads[1][1]) == 0
    assert torch.count_nonzero(grads[2][1]) > 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_k6_route_matches_jax_grad_of_fused_attention(kchunk_regime, dtype):
    """The autograd route at or above the switch: K5 forward, K6 backward,
    against jax.grad through the custom VJP with kernel_bwd (K5 + K6)."""
    jdt, tdt = DTYPES[dtype]
    q, k, v, _, mask = _inputs(seed=4)

    def f(q, k, v):
        out = pa.fused_attention(q, k, v, jnp.asarray(mask), None, SCALE, True, True)
        return jnp.sum(jnp.cos(out.astype(jnp.float32)))

    j_grads = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x, jdt) for x in (q, k, v)))
    tq, tk, tv = (x.requires_grad_() for x in _torch((q, k, v), dtype))
    out = A.rows_attention(tq, tk, tv, torch.from_numpy(mask), SCALE)
    torch.cos(out.float()).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), j_grads):
        assert got.dtype == tdt
        _close(got.float().numpy(), want.astype(jnp.float32), dtype)
    assert torch.count_nonzero(tq.grad[1]) == 0 and torch.count_nonzero(tk.grad[1]) == 0


def test_plain_route_takes_the_plain_kchunk_versions(kchunk_regime):
    """Inside plain_route() the K-chunk regime runs the plain K5/K6 through
    the same autograd Function: identical to the CPU route."""
    q, k, v, g, mask = _inputs(seed=5)
    grads = []
    for plain in (False, True):
        inputs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        with A.plain_route() if plain else torch.enable_grad():
            out = A.gated_attention_core(*inputs, torch.from_numpy(mask), None, SCALE)
        out.backward(torch.from_numpy(g))
        grads.append([out.detach()] + [t.grad for t in inputs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kchunk_select_matches_jax_over_the_ladder(dtype):
    jdt, tdt = DTYPES[dtype]
    sizes = list(DataConfig().buckets) + [1000, 1152, 2050, 3072]
    got = [A.kchunk_select(n, tdt) for n in sizes]
    assert got == [pa._kchunk_select(n, jdt) for n in sizes]
    switch = 1024 if dtype == "f32" else 2048
    assert [n for n, kc in zip(sizes, got) if kc] == [n for n in sizes if n >= switch and n != 2050]


def test_kchunk_wrappers_check_their_inputs():
    """Head width is bounded by the kernels' registers; the CPU route takes
    any width, a CUDA tensor above it raises before any launch."""
    q, k, v, g, mask = _inputs(C=8)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    with pytest.raises(ValueError, match="needs a key mask"):
        A.rows_attention(*t, None, SCALE)
    with pytest.raises(ValueError, match="must be on"):
        A._check_kchunk(*t, torch.from_numpy(mask))
    wide = torch.zeros(2, 4, 1, A.MAX_HEAD_DIM + 4)
    with pytest.raises(ValueError, match="head width"):
        A._check_kchunk(wide, wide, wide, torch.ones(2, 4))


def test_net_loss_and_grads_match_jax_in_kchunk_regime(kchunk_regime):
    """A 2-block f32 net at bucket 32 with remat: every triangle attention
    runs K5 forward (again in the recompute) and K6 backward on both sides
    (the JAX Pallas kernels in interpret mode)."""
    cfg = CFG.replace(mask_prob=0.6, training_mode=True, use_pallas=True, use_pallas_bwd=True,
                      remat=True)
    batch = make_batch(B=2, bucket=32, seed=6)
    params = perturbed_params(cfg, seed=6)
    key = key_for_policy("random")
    model = ProteinReDiffModel(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def per_sample(p):
        per = model.loss(p, jb, key, training=True, reduction="none")[0]
        return per.mean(), per

    (_, j_per), j_grads = jax.value_and_grad(per_sample, has_aux=True)(params)

    net = P.ProteinReDiffNet(cfg)
    net.load_state_dict(state_dict_from_jax(params, cfg))
    B, N = batch["residue_mask"].shape
    assert N == 32 and A.kchunk_select(N, torch.float32) == 8
    noise = jax_train_draws(key, B, N, cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    per, _ = P.loss(net, tb, reduction="none", noise=noise)
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(j_per), atol=1e-4, rtol=1e-4)
    per.mean().backward()

    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_grads), cfg)
    names = [name for name, _ in net.named_parameters()]
    total = np.sqrt(sum(np.sum(ref[name].numpy() ** 2) for name in names))
    for name, p in net.named_parameters():
        b = ref[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - b)
        assert err <= 1e-4 * max(np.linalg.norm(b), 1e-3 * total), name
