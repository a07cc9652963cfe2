"""The arithmetic of the f32 tensor-core body of K3 and K5 (3xTF32,
``attention_tf32.cu``), emulated on the CPU: no card needed.

Each f32 operand x splits into x = big + small, big = tf32(x) and small =
tf32(x - big), rounding to nearest (ties away) on the 13 low mantissa bits
as ``cvt.rna.tf32.f32`` does, here through an int32 view. A product is
a_small b_big + a_big b_small + a_big b_big (a_small b_small dropped); a
product of two TF32 values is exact in f32, so an f32 matmul of the parts
emulates the tensor cores up to the order of the f32 sums.

K5's f32 function (online softmax over the kernel's 64-key tiles, P left in
f32 for P.V) with every product in 3xTF32 matches the plain version
``rows_attention_kchunk_reference(stats=True)`` within the CUDA test's 1e-5
on out, m and log s, fully masked rows included; with one TF32 product per
product, as the tensor cores' TF32 mode takes it, the same inputs miss
1e-5: the three products are what keeps the f32 parity.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from protein_redesign_tpu_torch.ops import attention as A  # noqa: E402

TOL = 1e-5  # the f32 CUDA tests' tolerance (TF32 off)
KEY_TILE = 64  # attention_tf32.cu's key tile


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (a_big, a_small), (b_big, b_small) = split(a), split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)


def kchunk_stats_emulated(q, k, v, mask, scale: float, matmul):
    """K5's f32 function as the kernel takes it: q pre-scaled in f32, logits
    with -2^15 at masked keys, a running max over 64-key tiles, p = exp(l -
    m') in f32, P.V with p unrounded; every product through ``matmul``."""
    R, N, H, C = q.shape
    qt = (q * scale).permute(0, 2, 1, 3)  # [R, H, N, C]
    kt = k.permute(0, 2, 3, 1)  # [R, H, C, N]
    vt = v.permute(0, 2, 1, 3)
    m = torch.full((R, H, N), float("-inf"))
    s = torch.zeros((R, H, N))
    acc = torch.zeros((R, H, N, C))
    for k0 in range(0, N, KEY_TILE):
        logits = matmul(qt, kt[..., k0:k0 + KEY_TILE])
        logits = torch.where(mask[:, None, None, k0:k0 + KEY_TILE] < 0.5, A.NEG_INF, logits)
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        s = s * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + matmul(p, vt[:, :, k0:k0 + KEY_TILE])
        m = m_new
    return (acc / s[..., None]).permute(0, 2, 1, 3), m, torch.log(s)


def _inputs(N, C, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(3, N, 2, C).astype(np.float32)) for _ in range(3))
    mask = torch.from_numpy((rng.rand(3, N) > 0.2).astype(np.float32))
    mask[0] = 0.0  # a fully masked row
    return q, k, v, mask


def _excess(got, want) -> float:
    """How far ``got`` lies past TOL of ``want`` (atol = rtol = TOL)."""
    return float(((got - want).abs() - TOL - TOL * want.abs()).max())


def test_tf32_rounding_and_split():
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 3 * 2.0**-12), 3.0e-3])
    np.testing.assert_array_equal(tf32(x)[:3].numpy(),
                                  np.float32([1.0 + 2.0**-10, 1.0, -(1.0 + 2.0**-10)]))
    big, small = split(x)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((small.view(torch.int32) & 0x1FFF) == 0).all()
    np.testing.assert_allclose((big + small).numpy(), x.numpy(), rtol=2.0**-21, atol=0)


@pytest.mark.parametrize("N", [45, 200])
@pytest.mark.parametrize("C", [8, 16, 64])
def test_3xtf32_keeps_k5_within_1e5_where_one_tf32_product_misses(N, C):
    q, k, v, mask = _inputs(N, C, seed=N + C)
    scale = A.weak_scalar(C ** -0.5, torch.float32)
    ref, ref_m, ref_logs = A.rows_attention_kchunk_reference(q, k, v, mask, C ** -0.5, stats=True)
    out, m, logs = kchunk_stats_emulated(q, k, v, mask, scale, matmul_3xtf32)
    for got, want in ((out, ref), (m, ref_m), (logs, ref_logs)):
        assert torch.isfinite(got).all() and _excess(got, want) <= 0
    assert (m[0] == A.NEG_INF).all()
    torch.testing.assert_close(out[0], v[0].mean(0, keepdim=True).expand_as(out[0]),
                               atol=TOL, rtol=TOL)
    out1, m1, logs1 = kchunk_stats_emulated(q, k, v, mask, scale, matmul_tf32)
    assert max(_excess(out1, ref), _excess(m1, ref_m), _excess(logs1, ref_logs)) > 0
