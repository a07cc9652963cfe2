"""The port's attention (plain version and kernel wrappers on CPU tensors)
against the JAX ``fused_attention`` Pallas kernels in interpret mode and
``_attention_reference``.

Tolerances: float32 1e-5 absolute and relative, as ``test_pallas.py``;
bfloat16 2e-2 (one bf16 rounding of a probability is ~2^-8 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from protein_redesign_tpu.ops.pallas_attention import (  # noqa: E402
    _attention_reference,
    fused_attention,
)
from protein_redesign_tpu_torch.ops import attention as A  # noqa: E402


def _inputs(R, N, H, C, seed=0, masked_rows=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(R, N, H, C).astype(np.float32) for _ in range(3))
    mask = (rng.rand(R, N) > 0.2).astype(np.float32)
    mask[:masked_rows] = 0.0
    bias = rng.randn(R, H, N, N).astype(np.float32)
    return q, k, v, mask, bias


CASES = {
    "rows": (True, False),       # triangle attention: mask, no bias (K1)
    "mask_bias": (True, True),   # single attention (K2)
    "bias_only": (False, True),  # SPAttention (K2)
}


@pytest.mark.parametrize("C", [8, 64])
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_kernel_and_reference(case, C):
    with_mask, with_bias = CASES[case]
    q, k, v, mask, bias = _inputs(3, 16, 2, C, seed=C)
    m = mask if with_mask else None
    b = bias if with_bias else None
    scale = 1.0 / np.sqrt(C)
    jm = None if m is None else jnp.asarray(m)
    jb = None if b is None else jnp.asarray(b)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    j_kernel = np.asarray(fused_attention(jq, jk, jv, jm, jb, scale, True))
    j_ref = np.asarray(_attention_reference(jq, jk, jv, jm, jb, scale))

    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    tm = None if m is None else torch.from_numpy(m)
    tb = None if b is None else torch.from_numpy(b)
    before = dict(A.LAUNCHES)
    routed = A.fused_attention(tq, tk, tv, tm, tb, scale).numpy()
    plain = A.attention_reference(tq, tk, tv, tm, tb, scale).numpy()
    assert A.LAUNCHES == before  # CPU tensors never launch a kernel
    np.testing.assert_allclose(plain, j_kernel, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(plain, j_ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(routed, plain)


def test_fully_masked_row_is_mean_of_v():
    q, k, v, mask, _ = _inputs(4, 16, 2, 8, seed=3, masked_rows=2)
    j_kernel = np.asarray(fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), None, 0.35, True
    ))
    out = A.rows_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(mask), 0.35).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[:2], np.broadcast_to(v[:2].mean(1, keepdims=True), v[:2].shape),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, j_kernel, atol=1e-5, rtol=1e-5)


def test_bf16_matches_jax_kernel():
    q, k, v, mask, bias = _inputs(2, 32, 4, 16, seed=5)
    bf = jnp.bfloat16
    j_kernel = fused_attention(
        jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf), jnp.asarray(mask),
        jnp.asarray(bias, bf), 0.25, True,
    )
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    out = A.tiled_attention(t(q), t(k), t(v), torch.from_numpy(mask), t(bias), 0.25)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(j_kernel, np.float32),
                               atol=2e-2, rtol=2e-2)


def test_weak_scalar_rounds_like_jax():
    assert A.weak_scalar(1 / np.sqrt(8), torch.float32) == float(np.float32(1 / np.sqrt(8)))
    assert A.weak_scalar(1 / np.sqrt(8), torch.bfloat16) == float(
        jnp.asarray(1 / np.sqrt(8), jnp.bfloat16)
    )


def test_wrappers_route_by_mask_and_bias():
    q, k, v, mask, _ = _inputs(2, 8, 1, 4)
    t = torch.from_numpy
    with pytest.raises(ValueError):
        A.rows_attention(t(q), t(k), t(v), None, 1.0)
    with pytest.raises(ValueError):
        A.tiled_attention(t(q), t(k), t(v), t(mask), None, 1.0)
    with pytest.raises(ValueError):
        A.fused_attention(t(q), t(k), t(v), None, None, 1.0)
