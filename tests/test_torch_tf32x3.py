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

K2's f32 function (``attention_tiled_tf32.cu``: the bias added to the f32
logits, then the -2^15 fill, online softmax over 64-key tiles, or 32 from
C = 24 to 128) and K1's (``attention_tf32.cu``, K3's one pass at a query
tile of 64 or 128) are emulated in the kernels' order of sums: each 8-deep
step's three products summed into a fresh value that is added to the logit
or the output in f32, the narrow bodies' P.V over each 8-key step with its
keys renumbered as the S accumulators hold them (slot t key 2t, slot t + 4
key 2t + 1), the wide body's (C > 128) in key order from shared memory, the
bias added at each logit's own key. Against the plain ``attention_reference``
they meet 1e-5 at C <= 128 and 1e-4 at C = 512 and 768, with a bias drawn
for every (query, key, head), a mask with a fully masked row, and no mask;
one TF32 product per product misses at C = 512.
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



# K1 and K2 in f32 -------------------------------------------------------------

PERM = [0, 2, 4, 6, 1, 3, 5, 7]  # P.V's slot t: key 2t; slot t + 4: key 2t + 1


def stepwise(a: torch.Tensor, b: torch.Tensor, matmul, renumber: bool = False) -> torch.Tensor:
    """a @ b as the tensor cores sum it: one product per 8-deep step, each
    step's result added to the sum in f32 in order; ``renumber`` takes each
    step's depth in the S accumulators' order (PERM). The depth is padded
    with zeros to a multiple of 8, as the kernels zero-fill."""
    pad = -a.shape[-1] % 8
    a = torch.nn.functional.pad(a, (0, pad))
    b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for k0 in range(0, a.shape[-1], 8):
        idx = [k0 + j for j in PERM] if renumber else list(range(k0, k0 + 8))
        out = out + matmul(a[..., idx], b[..., idx, :])
    return out


def key_tile(C: int) -> int:
    """Keys per tile: the one-pass body's 64 up to C = 16 and 32 to C = 128,
    the wide body's 64."""
    return 64 if C <= 16 or C > 128 else 32


def attention_emulated(q, k, v, mask, bias, scale: float, matmul, queries: int = 64):
    """K1's (``bias`` None) or K2's f32 function as the kernels take it:
    query tiles of ``queries`` rows (each on its own, as the blocks are),
    q pre-scaled in f32, per key tile S = q k^T stepwise, plus the bias at
    each logit's key, -2^15 at masked keys, online softmax, acc += P V
    stepwise (renumbered at C <= 128); out = acc / s."""
    R, N, H, C = q.shape
    tile, narrow = key_tile(C), C <= 128
    qt = (q * scale).permute(0, 2, 1, 3)  # [R, H, N, C]
    kt, vt = k.permute(0, 2, 3, 1), v.permute(0, 2, 1, 3)  # [R, H, C, N], [R, H, N, C]
    outs = []
    for q0 in range(0, N, queries):
        rows = slice(q0, q0 + queries)
        n = qt[:, :, rows].shape[2]
        m = torch.full((R, H, n), float("-inf"))
        s = torch.zeros((R, H, n))
        acc = torch.zeros((R, H, n, C))
        for k0 in range(0, N, tile):
            keys = slice(k0, k0 + tile)
            logits = stepwise(qt[:, :, rows], kt[..., keys], matmul)
            if bias is not None:
                logits = logits + bias[:, :, rows, keys]
            if mask is not None:
                logits = torch.where(mask[:, None, None, keys] < 0.5, A.NEG_INF, logits)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            s = s * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + stepwise(p, vt[:, :, keys], matmul, renumber=narrow)
            m = m_new
        outs.append(acc / s[..., None])
    return torch.cat(outs, 2).permute(0, 2, 1, 3)


def _tiled_inputs(N, C, seed, H=2):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(2, N, H, C).astype(np.float32)) for _ in range(3))
    bias = torch.from_numpy(rng.randn(2, H, N, N).astype(np.float32))  # every (query, key, head)
    mask = torch.from_numpy((rng.rand(2, N) > 0.2).astype(np.float32))
    mask[0] = 0.0  # row 0 masks every key
    return q, k, v, mask, bias


def _excess_at(got, want, tol: float) -> float:
    return float(((got - want).abs() - tol - tol * want.abs()).max())


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask_bias", "bias"])
@pytest.mark.parametrize("C,N", [(16, 45), (16, 130), (512, 45), (768, 37)])
def test_3xtf32_keeps_k2_within_its_gate_where_one_tf32_product_misses(C, N, with_mask):
    """K2 in emulated 3xTF32 against the plain attention_reference: 1e-5 at
    C = 16, 1e-4 at C = 512 and 768 (the wide-head f32 gate); the fully
    masked row gives the mean of v. At C = 512 one TF32 product per product
    misses 1e-4."""
    tol = 1e-4 if C >= 512 else TOL
    q, k, v, mask, bias = _tiled_inputs(N, C, seed=N + C)
    m = mask if with_mask else None
    scale = A.weak_scalar(C ** -0.5, torch.float32)
    want = A.attention_reference(q, k, v, m, bias, C ** -0.5)
    got = attention_emulated(q, k, v, m, bias, scale, matmul_3xtf32)
    assert torch.isfinite(got).all() and _excess_at(got, want, tol) <= 0
    if with_mask:
        mean_v = v[0].mean(0, keepdim=True).expand_as(got[0])
        assert _excess_at(got[0], mean_v, tol) <= 0
    if C == 512:
        one = attention_emulated(q, k, v, m, bias, scale, matmul_tf32)
        assert _excess_at(one, want, tol) > 0


def test_k2_bias_at_the_accumulators_own_key():
    """The bias belongs at each logit's own key: the same emulation with the
    bias taken at P.V's renumbered slot (key 2t where the accumulator holds
    key t) misses 1e-5 at C = 16 with a bias drawn for every key."""
    q, k, v, mask, bias = _tiled_inputs(64, 16, seed=7)
    scale = A.weak_scalar(0.25, torch.float32)
    want = A.attention_reference(q, k, v, mask, bias, 0.25)
    assert _excess_at(attention_emulated(q, k, v, mask, bias, scale, matmul_3xtf32), want, TOL) <= 0
    slots = [k0 + j for k0 in range(0, 64, 8) for j in PERM]
    wrong = attention_emulated(q, k, v, mask, bias[..., slots], scale, matmul_3xtf32)
    assert _excess_at(wrong, want, TOL) > 0


@pytest.mark.parametrize("queries", [64, 128])
@pytest.mark.parametrize("C,N", [(8, 45), (16, 130), (64, 70), (128, 45)])
def test_3xtf32_keeps_k1_within_1e5(C, N, queries):
    """K1 in f32 on K3's one-pass body at a query tile of 64 or 128 (N not a
    multiple of it), against the plain two-pass attention_reference within
    1e-5, the fully masked row at the mean of v; one TF32 product per
    product misses."""
    q, k, v, mask = _inputs(N, C, seed=3 * N + C)
    scale = A.weak_scalar(C ** -0.5, torch.float32)
    want = A.attention_reference(q, k, v, mask, None, C ** -0.5)
    got = attention_emulated(q, k, v, mask, None, scale, matmul_3xtf32, queries)
    assert torch.isfinite(got).all() and _excess(got, want) <= 0
    assert _excess(got[0], v[0].mean(0, keepdim=True).expand_as(got[0])) <= 0
    one = attention_emulated(q, k, v, mask, None, scale, matmul_tf32, queries)
    assert _excess(one, want) > 0


# K1 fast in f32 -----------------------------------------------------------------

NEAR_F32 = 32  # attention_tf32.cu's kNearF32, in units of 2^-24 |q| |k|
TOL_BF16 = 2e-2  # K1 fast's gate in both dtypes (p is rounded to bf16)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def error_units(qt: torch.Tensor, kt: torch.Tensor) -> torch.Tensor:
    """2^-24 |q_i| |k_j| for [R, H, N, C] rows: the scale of a logit's f32
    error (both 3xTF32's and a reordered sum's grow with sum |q_c k_c|)."""
    return 2.0**-24 * qt.norm(dim=-1)[..., :, None] * kt.norm(dim=-1)[..., None, :]


def near_midpoint(l: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """attention_tf32.cu's near_bf16_midpoint_f32: l's low 16 bits' distance
    from 0x8000 times its ulp, at most ``window``."""
    bits = l.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    ulp = torch.ldexp(torch.ones_like(l), (torch.clamp((bits >> 23) & 0xFF, min=1) - 150).int())
    return ((bits & 0xFFFF) - 0x8000).abs().float() * ulp <= window


def fma_chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_c a[..., c] b[..., c] as one FMA chain over c in order (dot_smem):
    each step's product and sum exact in float64, rounded once to f32."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]), dtype=torch.float64)
    for c in range(a.shape[-1]):
        acc = (acc + a[..., c].double() * b[..., c].double()).float().double()
    return acc.float()


def matmul_2xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The bf16-valued P against split X: a b_small + a b_big, the 3xTF32
    product without a_small b_big (a is exact in TF32)."""
    b_big, b_small = split(b)
    return a @ b_small + a @ b_big


def fast_logits_emulated(q, k, mask, scale: float):
    """K1 fast's f32 logits as the kernel takes them, [R, H, N, N]: the 3xTF32
    logits of the pre-scaled q (stepwise), the -2^15 fill; a kept logit in
    the window recomputed by the FMA chain; each rounded to bf16. Returns
    (the rounded logits, the 3xTF32 logits before the fill, the window's
    mask)."""
    qt = (q * scale).permute(0, 2, 1, 3)  # [R, H, N, C]
    kt = k.permute(0, 2, 1, 3)
    raw = stepwise(qt, kt.transpose(-1, -2), matmul_3xtf32)
    kept = (mask[:, None, None, :] >= 0.5).expand_as(raw)
    near = near_midpoint(raw, NEAR_F32 * error_units(qt, kt)) & kept
    chain = fma_chain(qt[..., :, None, :], kt[..., None, :, :])
    logits = torch.where(near, chain, raw)
    logits = torch.where(kept, logits, torch.tensor(A.NEG_INF))
    return bf16(logits), raw, near


def fast_emulated(q, k, v, mask, scale: float, pv=matmul_2xtf32):
    """K1 fast's f32 function as its tensor-core body takes it: the logits of
    fast_logits_emulated; m = max; e = bf16(exp(bf16(l - m))); s = bf16(sum
    e in f32); p = bf16(e / s); P.V stepwise over 8-key steps renumbered as
    the accumulators hold them, each step through ``pv``."""
    l, _, _ = fast_logits_emulated(q, k, mask, scale)
    e = bf16(torch.exp(bf16(l - l.amax(-1, keepdim=True))))
    p = bf16(e / bf16(e.sum(-1, keepdim=True)))
    out = stepwise(p, v.permute(0, 2, 1, 3), pv, renumber=True)
    return out.permute(0, 2, 1, 3)


def _fast_inputs(N, C, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(3, N, 2, C).astype(np.float32)) for _ in range(3))
    mask = torch.from_numpy((rng.rand(3, N) > 0.2).astype(np.float32))
    mask[0] = 0.0  # a fully masked row
    return 3.0 * q, k, v, mask  # logits of |l| up to ~15 at scale C^-0.5


def test_k1_fast_pv_in_two_tf32_products_equals_three():
    """P is a bf16 value, exact in TF32: its small part is 0, so P.V in two
    TF32 products (p v_small + p v_big) equals the 3xTF32 product bit for bit
    (as f32 values), step by step over the renumbered keys."""
    q, k, v, mask = _fast_inputs(70, 16, seed=5)
    a, b = (fast_emulated(q, k, v, mask, 0.25, pv) for pv in (matmul_2xtf32, matmul_3xtf32))
    assert torch.equal(a, b)
    p = bf16(torch.rand(4, 70, 70))
    assert torch.equal(split(p)[1], torch.zeros_like(p))


@pytest.mark.parametrize("C", [16, 32, 64, 128])
def test_k1_fast_logit_window_holds_4x_the_3xtf32_distance(C):
    """The largest distance between the 3xTF32 logits and the plain f32
    logits (``rows_attention_fast_reference``'s einsum), in units of 2^-24
    |q| |k|, at C = 16, 32, 64 and 128 over seeded logits of |l| up to ~15:
    at most 4.0 (in f32 ulps of max(|l|, 1) it reaches 19 at C = 16: the
    error follows the terms, not the logit); the kernel's window of 32 such
    units holds it at least 4x. Every kept logit outside the window then
    rounds to the plain version's bf16; 1-3% fall inside and are
    recomputed."""
    q, k, v, mask = _fast_inputs(120, C, seed=C)
    scale = A.weak_scalar(C ** -0.5, torch.float32)
    l, raw, near = fast_logits_emulated(q, k, mask, scale)
    plain = torch.einsum("rihc,rjhc->rhij", q * scale, k)
    units = error_units((q * scale).permute(0, 2, 1, 3), k.permute(0, 2, 1, 3))
    distance = float(((raw - plain).abs() / units).max())
    print(f"C={C}: largest distance {distance:.2f} x 2^-24 |q| |k|; "
          f"{float(near.float().mean()):.4f} of the logits in the window")
    assert 4 * distance <= NEAR_F32
    kept = (mask[:, None, None, :] >= 0.5).expand_as(raw)
    outside = kept & ~near
    assert torch.equal(l[outside], bf16(plain)[outside])
    want = bf16(torch.where(kept, plain, torch.tensor(A.NEG_INF)))
    assert torch.equal(l[~kept], want[~kept])  # the fill, the fully masked row included
    assert float(near[kept].float().mean()) < 0.05


@pytest.mark.parametrize("C,N", [(16, 45), (16, 130), (64, 70), (128, 45)])
def test_k1_fast_f32_body_within_its_gate(C, N):
    """K1 fast's f32 tensor-core body, emulated, against
    ``rows_attention_fast_reference`` within 2e-2 (atol and rtol, the CUDA
    test's gate), the fully masked row at the mean of v."""
    q, k, v, mask = _fast_inputs(N, C, seed=N + 2 * C)
    scale = A.weak_scalar(C ** -0.5, torch.float32)
    got = fast_emulated(q, k, v, mask, scale)
    want = A.rows_attention_fast_reference(q, k, v, mask, C ** -0.5)
    torch.testing.assert_close(got, want, atol=TOL_BF16, rtol=TOL_BF16)
    torch.testing.assert_close(got[0], v[0].mean(0, keepdim=True).expand_as(got[0]),
                               atol=TOL_BF16, rtol=TOL_BF16)


# K10 ----------------------------------------------------------------------------

FUSED_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
HIDDEN_CHUNK = 64  # transition_mma.cu's kHid


def transition_emulated(x, w1, b1, w2, b2, dtype, matmul=matmul_3xtf32):
    """K10's tensor-core arithmetic: x^ = LN(x) in f32 rounded to the dtype;
    per 64-unit hidden chunk h = ReLU(x^ W1^T + b1) rounded, taken from the
    accumulators; out summed chunk by chunk in f32, + b2, rounded. bf16: the
    products of rounded operands exact in f32, summed in f32; f32: each
    product 3xTF32 (``matmul``) over 8-deep steps into fresh sums, the second
    product's units renumbered as the accumulators hold them."""
    xl = A.layer_norm_f32(x).to(dtype).float()
    w1r, w2r = w1.to(dtype).float(), w2.to(dtype).float()
    out = torch.zeros(x.shape[:-1] + (w2.shape[0],))
    for h0 in range(0, w1.shape[0], HIDDEN_CHUNK):
        units = slice(h0, h0 + HIDDEN_CHUNK)
        if dtype == torch.float32:
            acc = stepwise(xl, w1r[units].t(), matmul)
        else:
            acc = xl @ w1r[units].t()
        h = torch.relu(acc + b1[units]).to(dtype).float()
        if dtype == torch.float32:
            out = out + stepwise(h, w2r[:, units].t(), matmul, renumber=True)
        else:
            out = out + h @ w2r[:, units].t()
    if b2 is not None:
        out = out + b2
    return out.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M,D,Hd,Dout", [(40, 64, 256, 64), (24, 512, 2048, 512),
                                         (8, 768, 3072, 768), (16, 128, 512, 128)],
                         ids=["pair_fc", "single_fc", "single_768", "pair_128"])
def test_k10_tensor_core_arithmetic_within_fused_tol(dtype, M, D, Hd, Dout):
    """K10's tensor-core arithmetic against ``transition_reference`` within
    FUSED_TOL (relative norm: 1e-5 in f32, 2e-2 in bf16) at pair_fc,
    single_fc, single_dim 768 and pair width 128 (small M); in f32 one TF32
    product per product misses 1e-5."""
    rng = np.random.RandomState(D + M)
    x = torch.from_numpy(rng.randn(M, D).astype(np.float32)).to(dtype)
    w1 = torch.from_numpy((rng.randn(Hd, D) * D ** -0.5).astype(np.float32))
    b1 = torch.from_numpy((0.3 * rng.randn(Hd)).astype(np.float32))
    w2 = torch.from_numpy((rng.randn(Dout, Hd) * Hd ** -0.5).astype(np.float32))
    b2 = torch.from_numpy((0.3 * rng.randn(Dout)).astype(np.float32))
    from protein_redesign_tpu_torch.ops import transition as T

    want = T.transition_reference(x, w1, b1, w2, b2).float()

    def rel(got):
        return float((got.float() - want).norm() / want.norm())

    assert rel(transition_emulated(x, w1, b1, w2, b2, dtype)) <= FUSED_TOL[dtype]
    if dtype == torch.float32:
        assert rel(transition_emulated(x, w1, b1, w2, b2, dtype, matmul_tf32)) > FUSED_TOL[dtype]
