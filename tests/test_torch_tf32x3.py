"""The arithmetic of the f32 tensor-core bodies of K3 and K5 (3xTF32,
``attention_tf32.cu``) and of K6 and K7 (``attention_bwd_tf32.cu``),
emulated on the CPU: no card needed.

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
1e-5: the three products are what keeps the f32 parity. The same holds for
the backward: K6's function (P from K5's split stats, delta = rowsum(dO o
O)) and K7's (softmax and delta = rowsum(dP o P) computed), every product
in 3xTF32, meet their plain versions within 1e-5 of max(1, max |grad|).

The backward kernels take P as exp2(l log2 e - m log2 e) times a normaliser,
the FFMA's one rounding emulated through float64; K6 stages -m log2 e and
exp(-log s) apart. At a fully masked row (l = m = -2^15, log s = log N) the
exponent is then exactly 0 and P = exp(-log s) within f32 rounding, while
the folded offset m + log s, rounded to f32's spacing near -2^15, moves P
by up to 0.1%.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from protein_redesign_tpu_torch.ops import attention as A  # noqa: E402

TOL = 1e-5  # the f32 CUDA tests' tolerance (TF32 off)
KEY_TILE = 64  # attention_tf32.cu's key tile (attention_bwd_tf32.cu's at C <= 16)
LOG2E = np.float32(1.4426950408889634)


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


# the backward's softmax stats -------------------------------------------------


def _fma_exp2(l, nm):
    """exp2(fma(l, log2 e, nm)) in f32: the product and sum exact in float64,
    rounded once to f32 as the FFMA rounds, exp2 rounded to f32."""
    x = (l.astype(np.float64) * np.float64(LOG2E) + nm.astype(np.float64)).astype(np.float32)
    return np.exp2(x.astype(np.float64)).astype(np.float32)


def _split_p(l, m, logs):
    """P as the kernels take it: -m log2 e and exp(-log s) staged apart."""
    nm = (-m * LOG2E).astype(np.float32)
    return _fma_exp2(l, nm) * np.exp(-logs.astype(np.float64)).astype(np.float32)


def test_split_stats_keep_p_where_the_folded_offset_does_not():
    """A fully masked row (l = m = -2^15, log s = log N for N keys): the
    split stats give P = 1/N within 1e-6, the folded m + log s does not; on
    ordinary rows the split form meets exp((l - m) - log s) within 1e-6."""
    n = np.arange(2, 2049)
    logs = np.log(n).astype(np.float32)
    l = m = np.full(n.shape, -(2.0**15), np.float32)
    exact = 1.0 / n
    split = _split_p(l, m, logs)
    folded = np.exp((l.astype(np.float64) - (m + logs).astype(np.float64))).astype(np.float32)
    assert np.abs(split / exact - 1).max() <= 1e-6
    assert np.abs(folded / exact - 1).max() > 1e-4
    rng = np.random.RandomState(0)
    m = rng.uniform(-8, 8, 10000).astype(np.float32)
    l = (m - rng.exponential(3.0, m.shape)).astype(np.float32)  # l <= m, as under a row max
    logs = rng.uniform(0, 8, m.shape).astype(np.float32)
    want = np.exp((l.astype(np.float64) - m) - logs)
    assert np.abs(_split_p(l, m, logs) - want).max() <= 1e-6


def backward_emulated(q, k, v, mask, dout, scale: float, matmul, stats=None):
    """K6's f32 function (``stats`` = K5's m and log s plus delta = rowsum(dO
    o O)) or K7's (``stats`` None: softmax and delta = rowsum(dP o P)) as
    the kernels take it: qt = q * scale in f32, P = exp2(l log2 e - m log2
    e) times exp(-log s) or 1 / s, every product through ``matmul``, sums
    over 64-row tiles. Returns (dq, dk, dv), dq w.r.t. the unscaled q."""
    qt = (q * scale).permute(0, 2, 1, 3)  # [R, H, N, C]
    kt, vt, g = (t.permute(0, 2, 1, 3) for t in (k, v, dout))
    masked = mask[:, None, None, :] < 0.5
    logits = torch.cat([matmul(qt, kt[:, :, j:j + KEY_TILE].transpose(-1, -2))
                        for j in range(0, k.shape[1], KEY_TILE)], -1)
    logits = torch.where(masked, A.NEG_INF, logits)
    if stats is None:
        m = logits.amax(-1)
        inv = 1.0 / torch.exp(logits - m[..., None]).sum(-1)
    else:
        m, logs, delta = stats
        inv = torch.exp(-logs)
    nm = (-m * torch.from_numpy(np.asarray(LOG2E))).numpy()
    p = torch.from_numpy(_fma_exp2(logits.numpy(), nm[..., None])) * inv[..., None]
    dp = matmul(g, vt.transpose(-1, -2))
    if stats is None:
        delta = (p * dp).sum(-1)
    ds = torch.where(masked, 0.0, p * (dp - delta[..., None]))
    tiles = range(0, q.shape[1], KEY_TILE)
    dq = sum(matmul(ds[..., j:j + KEY_TILE], kt[:, :, j:j + KEY_TILE]) for j in tiles)
    dk = sum(matmul(ds[..., i:i + KEY_TILE, :].transpose(-1, -2), qt[:, :, i:i + KEY_TILE])
             for i in tiles)
    dv = sum(matmul(p[..., i:i + KEY_TILE, :].transpose(-1, -2), g[:, :, i:i + KEY_TILE])
             for i in tiles)
    return tuple(t.permute(0, 2, 1, 3) for t in (dq * scale, dk, dv))


def _grad_excess(got, want) -> float:
    """How far the gradients lie past TOL x max(1, max |want|), the CUDA
    tests' backward tolerance."""
    return max(float((a - b).abs().max()) - TOL * max(1.0, float(b.abs().max()))
               for a, b in zip(got, want))


@pytest.mark.parametrize("name", ["k6", "k7"])
@pytest.mark.parametrize("N", [45, 200])
@pytest.mark.parametrize("C", [8, 16, 64])
def test_3xtf32_keeps_the_backward_within_1e5(name, N, C):
    """K6 and K7 in emulated 3xTF32 against their plain versions, a fully
    masked row included (exact zeros in its dq and dk); the delta of each is
    its own (K6 the caller's rowsum(dO o O), K7 rowsum(dP o P)). One TF32
    product per product misses the same tolerance."""
    q, k, v, mask = _inputs(N, C, seed=2 * N + C)
    dout = torch.from_numpy(np.random.RandomState(N).randn(3, N, 2, C).astype(np.float32))
    scale = A.weak_scalar(C ** -0.5, torch.float32)
    stats = None
    if name == "k6":
        out, m, logs = A.rows_attention_kchunk_reference(q, k, v, mask, C ** -0.5, stats=True)
        want = A.rows_attention_kchunk_bwd_reference(q, k, v, mask, dout, out, m, logs, C ** -0.5)
        stats = (m, logs, A._kchunk_delta(dout, out))
    else:
        want = A.rows_attention_bwd_reference(q, k, v, mask, dout, C ** -0.5)
    got = backward_emulated(q, k, v, mask, dout, scale, matmul_3xtf32, stats)
    assert all(torch.isfinite(t).all() for t in got) and _grad_excess(got, want) <= 0
    assert torch.count_nonzero(got[0][0]) == 0 and torch.count_nonzero(got[1][0]) == 0
    one = backward_emulated(q, k, v, mask, dout, scale, matmul_tf32, stats)
    assert _grad_excess(one, want) > 0

