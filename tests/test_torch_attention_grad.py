"""Gradients of the port's attention against the JAX package on the CPU:

- the K1 route's backward (``rows_attention``, whose CPU backward is K7's
  plain version) against ``fused_attention(..., interpret=True,
  kernel_bwd=True)``, the Pallas flash backward in interpret mode, as
  ``tests/test_pallas.py::TestRowsKernelBackward`` runs it, with a fully
  masked row (dq = dk = 0 there, dv not);
- ``rows_attention_bwd_reference`` against ``_rows_attention_bwd_impl`` in
  interpret mode;
- the K2 route's dq/dk/dv/dbias against ``jax.vjp`` of
  ``_attention_reference``.

Tolerances: float32 1e-5 (the same algorithm, sums in another order);
bfloat16 2e-2 relative to the gradient's scale (one flip of a bf16 rounding
of a probability or of dS moves a sum by ~2^-8 of a term).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from protein_redesign_tpu.ops.pallas_attention import (  # noqa: E402
    _attention_reference,
    _rows_attention_bwd_impl,
    fused_attention,
)
from protein_redesign_tpu_torch.ops import attention as A  # noqa: E402

SCALE = 0.35
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(R=3, N=16, H=2, C=8, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(R, N, H, C).astype(np.float32) for _ in range(4))
    mask = (rng.rand(R, N) > 0.25).astype(np.float32)
    mask[0] = 0.0  # a fully masked row
    bias = rng.randn(R, H, N, N).astype(np.float32)
    return q, k, v, g, mask, bias


def _close(a, b, dtype):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if dtype == "f32":
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(a, b, atol=2e-2 * np.abs(b).max(), rtol=2e-2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rows_route_backward_matches_jax_kernel_bwd(dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v, _, mask, _ = _inputs()

    def f(q, k, v):
        out = fused_attention(q, k, v, jnp.asarray(mask), None, SCALE, True, True)
        return jnp.sum(jnp.cos(out.astype(jnp.float32)))

    j_grads = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x, jdt) for x in (q, k, v)))

    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v))
    before = dict(A.LAUNCHES)
    out = A.rows_attention(tq, tk, tv, torch.from_numpy(mask), SCALE)
    torch.cos(out.float()).sum().backward()
    assert A.LAUNCHES == before  # CPU tensors never launch a kernel
    for t_grad, j_grad in zip((tq.grad, tk.grad, tv.grad), j_grads):
        assert t_grad.dtype == tdt
        _close(t_grad.float().numpy(), j_grad, dtype)
    # the fully masked row: uniform probabilities feed dv, dS is zero
    assert torch.count_nonzero(tq.grad[0]) == 0 and torch.count_nonzero(tk.grad[0]) == 0
    assert torch.count_nonzero(tv.grad[0]) > 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bwd_reference_matches_pallas_bwd_impl(dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v, g, mask, _ = _inputs(seed=1)
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    swap = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731
    dqt, dkt, dvt = _rows_attention_bwd_impl(
        swap(jq * SCALE), swap(jk), swap(jv), jnp.asarray(mask), swap(jg), True
    )
    j_grads = (swap(dqt) * SCALE, swap(dkt), swap(dvt))
    t_grads = A.rows_attention_bwd_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), torch.from_numpy(mask),
        torch.from_numpy(g).to(tdt), SCALE,
    )
    for t_grad, j_grad in zip(t_grads, j_grads):
        _close(t_grad.float().numpy(), j_grad.astype(jnp.float32), dtype)


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask_bias", "bias_only"])
def test_tiled_route_backward_matches_jax_vjp(with_mask):
    q, k, v, g, mask, bias = _inputs(seed=2)
    m = mask if with_mask else None
    jm = None if m is None else jnp.asarray(m)
    _, vjp = jax.vjp(lambda q, k, v, b: _attention_reference(q, k, v, jm, b, SCALE),
                     *(jnp.asarray(x) for x in (q, k, v, bias)))
    j_grads = vjp(jnp.asarray(g))

    inputs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    tm = None if m is None else torch.from_numpy(m)
    out = A.tiled_attention(inputs[0], inputs[1], inputs[2], tm, inputs[3], SCALE)
    out.backward(torch.from_numpy(g))
    for t_in, j_grad in zip(inputs, j_grads):
        np.testing.assert_allclose(t_in.grad.numpy(), np.asarray(j_grad), atol=1e-5, rtol=1e-5)


def test_plain_route_backward_is_autograd_of_the_reference():
    """Inside plain_route() the model's attention is the reference under
    autograd; its gradients agree with the K1 route's in f32."""
    q, k, v, g, mask, _ = _inputs(seed=3)
    grads = []
    for plain in (False, True):
        inputs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        tm = torch.from_numpy(mask)
        if plain:
            with A.plain_route():
                out = A.gated_attention_core(*inputs, tm, None, SCALE)
        else:
            out = A.gated_attention_core(*inputs, tm, None, SCALE)
        out.backward(torch.from_numpy(g))
        grads.append([t.grad for t in inputs])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
