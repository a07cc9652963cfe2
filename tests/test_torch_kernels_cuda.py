"""The port's CUDA attention kernels against their plain PyTorch version, on
the card. Skipped where torch has no CUDA device; on a machine with one,
run ``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``
(``--noconftest``: the suite's conftest imports jax, which the GPU machine
need not have).

Tolerances: float32 with TF32 off 1e-5 (1e-4 at head width 512, a
512-term f32 dot per logit), bfloat16 2e-2 (probabilities are rounded to
bf16 before P.V, so one rounding flip moves an output by ~2^-8). The
backward (K7) is held to the same tolerances relative to the largest
gradient entry: its sums run over N unnormalized terms (dv_j sums P_ij dO_i
over all queries i), so the error scales with the gradient, and in bf16 dS
is rounded before the dq and dk sums. The K-chunk kernels (K3, K5, K6) are
held to their plain versions in the same way; m and log s to 1e-5.
"""

import pytest

torch = pytest.importorskip("torch")

from protein_redesign_tpu_torch.ops import attention as A  # noqa: E402

pytestmark = pytest.mark.cuda


def _launches(**counts):
    """The whole launch record: the given counts, every other kernel 0."""
    return {**{name: 0 for name in A.LAUNCHES}, **counts}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(R, N, H, C, dtype, device, seed=0, masked_rows=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(R, N, H, C, generator=g).to(device, dtype) for _ in range(3))
    mask = (torch.rand(R, N, generator=g) > 0.2).float()
    mask[:masked_rows] = 0.0  # fully masked rows: uniform weights
    bias = torch.randn(R, H, N, N, generator=g).to(device, dtype)
    return q, k, v, mask.to(device), bias


def _tol(dtype, C):
    if dtype == torch.bfloat16:
        return 2e-2
    return 1e-4 if C >= 512 else 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [16, 45, 192])
@pytest.mark.parametrize("C", [8, 12, 16, 64, 128])
def test_rows_kernel_matches_plain(device, dtype, N, C):
    """K1 through its wrapper: the tensor-core bodies at every C here (bf16
    attention_mma.cu, C = 12 by its 8-byte staging; f32 3xTF32
    attention_tf32.cu)."""
    assert A.takes_tensor_cores("rows_attention", dtype, C)
    q, k, v, mask, _ = _inputs(6, N, 2, C, dtype, device, masked_rows=2)
    before = A.LAUNCHES["rows_attention"]
    out = A.rows_attention(q, k, v, mask, 0.35)
    torch.cuda.synchronize()
    assert A.LAUNCHES["rows_attention"] == before + 1
    ref = A.attention_reference(q, k, v, mask, None, 0.35)
    tol = _tol(dtype, C)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    # fully masked rows give the mean of v
    mean_v = v[:2].float().mean(1, keepdim=True).expand_as(out[:2])
    torch.testing.assert_close(out[:2].float(), mean_v, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask_bias", "bias"])
@pytest.mark.parametrize("C", [16, 20, 64, 512, 768, 1024])
def test_tiled_kernel_matches_plain(device, dtype, with_mask, C):
    """K2 through its wrapper: the tensor-core bodies at C a multiple of 8
    (bf16 attention_mma.cu; f32 attention_tiled_tf32.cu, its one-pass body
    up to 128 and its wide body above), the CUDA-core body at C = 20."""
    assert A.takes_tensor_cores("tiled_attention", dtype, C) == (C % 8 == 0)
    q, k, v, mask, bias = _inputs(2, 70, 4, C, dtype, device, seed=1)
    m = mask if with_mask else None
    out = A.tiled_attention(q, k, v, m, bias, 1.0 / C ** 0.5)
    torch.cuda.synchronize()
    ref = A.attention_reference(q, k, v, m, bias, 1.0 / C ** 0.5)
    tol = _tol(dtype, C)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_strided_operands(device):
    """The 'ending' triangle layout: k and v read through strides (K1 in f32
    on its 3xTF32 body)."""
    N, H, C = 40, 4, 16
    q, k, v, mask, _ = _inputs(N, N, H, C, torch.float32, device, seed=2)
    qt, kt, vt = (x.transpose(0, 1) for x in (q, k, v))  # swapped pair axes, no copy
    assert not kt.is_contiguous()
    out = A.rows_attention(qt, kt, vt, mask, 0.25)
    ref = A.attention_reference(qt.contiguous(), kt.contiguous(), vt.contiguous(), mask,
                                None, 0.25)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,C", [("tiled_attention", 16), ("tiled_attention", 512),
                                    ("rows_attention", 16), ("rows_attention", 64)])
def test_f32_tensor_core_bodies_strided(device, name, C):
    """K1 and K2 in f32 on their 3xTF32 bodies (K2 at C = 512 on the wide
    one) in the 'ending' layout, q, k and v read through strides, with the
    bias of every (query, key, head) drawn on its own, fully masked rows
    included: the same bits as on contiguous copies, 1e-5 (1e-4 at C = 512)
    of the plain version."""
    assert A.takes_tf32x3(name, torch.float32, C)
    N, H = 40, 2
    q, k, v, mask, bias = _inputs(N, N, H, C, torch.float32, device, seed=60, masked_rows=2)
    qt, kt, vt = (x.transpose(0, 1) for x in (q, k, v))
    assert not kt.is_contiguous()
    dense = [x.contiguous() for x in (qt, kt, vt)]
    b = bias if name == "tiled_attention" else None
    got = A.attention_body(name, qt, kt, vt, mask, b, C ** -0.5, mma=True)
    want = A.attention_body(name, *dense, mask, b, C ** -0.5, mma=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    tol = _tol(torch.float32, C)
    torch.testing.assert_close(got, A.attention_reference(*dense, mask, b, C ** -0.5),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("name,C", [("rows_attention", 16), ("rows_attention", 128),
                                    ("tiled_attention", 16), ("tiled_attention", 128),
                                    ("tiled_attention", 512), ("tiled_attention", 768)])
@pytest.mark.parametrize("N", [45, 192])
def test_f32_bodies_agree(device, name, C, N):
    """K1's and K2's two f32 bodies on the same inputs, the CUDA-core one
    kept callable to time it beside the 3xTF32 one: within the f32 gate of
    each other (1e-5, 1e-4 from C = 512), K2 with and without its mask."""
    q, k, v, mask, bias = _inputs(3, N, 2, C, torch.float32, device, seed=61, masked_rows=1)
    tol = _tol(torch.float32, C)
    for m, b in ((mask, bias), (None, bias)) if name == "tiled_attention" else ((mask, None),):
        tc = A.attention_body(name, q, k, v, m, b, C ** -0.5, mma=True)
        cc = A.attention_body(name, q, k, v, m, b, C ** -0.5, mma=False)
        assert torch.isfinite(tc).all()
        torch.testing.assert_close(tc, cc, atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["rows_attention", "tiled_attention", "rows_attention_fast"])
def test_more_rows_than_a_grid_dimension_holds(device, name):
    """R above 65535 (the bound of grid.y and grid.z): rows share grid.x
    with the query tiles."""
    q, k, v, mask, bias = _inputs(70000, 20, 1, 4, torch.float32, device, seed=4)
    if name == "rows_attention":
        out, ref = A.rows_attention(q, k, v, mask, 0.5), A.attention_reference(
            q, k, v, mask, None, 0.5)
    elif name == "rows_attention_fast":
        out, ref = A.rows_attention_fast(q, k, v, mask, 0.5), A.rows_attention_fast_reference(
            q, k, v, mask, 0.5)
        torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)
        return
    else:
        out, ref = A.tiled_attention(q, k, v, mask, bias, 0.5), A.attention_reference(
            q, k, v, mask, bias, 0.5)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [16, 45, 192])
@pytest.mark.parametrize("C", [8, 12, 16, 64, 128])
def test_rows_fast_kernel_matches_plain(device, dtype, N, C):
    """K1 fast against its plain version: the same bf16 rounding points, the
    f32 logits summed in another order (a flip of a bf16 rounding moves a
    probability by 2^-8), so 2e-2 in both dtypes. Every C here takes the
    tensor-core bodies (f32: 3xTF32; bf16 C = 12 by the 8-byte staging)."""
    q, k, v, mask, _ = _inputs(6, N, 4, C, dtype, device, masked_rows=2)
    q = 3.0 * q  # logits of |l| ~ 5 at C = 16
    before = A.LAUNCHES["rows_attention_fast"]
    out = A.rows_attention_fast(q, k, v, mask, 0.25)
    torch.cuda.synchronize()
    assert A.LAUNCHES["rows_attention_fast"] == before + 1
    ref = A.rows_attention_fast_reference(q, k, v, mask, 0.25)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


def test_rows_fast_strided_operands(device):
    """K1 fast in the 'ending' triangle layout: k and v read through strides."""
    N, H, C = 40, 4, 16
    q, k, v, mask, _ = _inputs(N, N, H, C, torch.bfloat16, device, seed=2)
    qt, kt, vt = (x.transpose(0, 1) for x in (q, k, v))
    assert not kt.is_contiguous()
    out = A.rows_attention_fast(qt, kt, vt, mask, 0.25)
    ref = A.rows_attention_fast_reference(qt.contiguous(), kt.contiguous(), vt.contiguous(),
                                          mask, 0.25)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


def test_wrapper_rejects(device):
    q, k, v, mask, bias = _inputs(2, 16, 2, 8, torch.float32, device)
    with pytest.raises(ValueError):  # K7: 4 x C / 32 accumulators per lane, C <= 1024
        wide_q = torch.zeros(2, 16, 1, 1028, device=device)
        A.rows_attention_bwd(wide_q, wide_q, wide_q, mask, wide_q, 0.5)
    with pytest.raises(ValueError):
        A.rows_attention(q, k, v, mask.cpu(), 0.5)
    wide = torch.zeros(2, 16, 1, 1028, device=device)
    with pytest.raises(ValueError):  # the CUDA-core body takes C <= 1024
        A.tiled_attention(wide, wide, wide, None, torch.zeros(2, 1, 16, 16, device=device), 1.0)
    with pytest.raises(ValueError, match="K7"):  # raised before the forward launches K1
        wide_q = torch.zeros(2, 16, 1, 1028, device=device, requires_grad=True)
        A.rows_attention(wide_q, wide_q, wide_q, mask, 0.5)
    with pytest.raises(TypeError):
        A.rows_attention(q.detach().half(), k.half(), v.half(), mask, 0.5)
    with pytest.raises(ValueError):
        A.rows_attention_fast(q, k, v, mask.cpu(), 0.5)
    with pytest.raises(TypeError):
        A.rows_attention_fast(q.half(), k.half(), v.half(), mask, 0.5)


def test_denoiser_kernel_route_matches_plain(device):
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.models.denoiser import Denoiser

    cfg = ModelConfig(single_dim=32, pair_dim=16, head_dim=8, num_heads=2, num_blocks=2,
                      dtype="float32")
    torch.manual_seed(0)
    mod = Denoiser(cfg).to(device)
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(0.1 * torch.randn_like(p))
    g = torch.Generator(device="cpu").manual_seed(3)
    single = torch.randn(2, 40, 32, generator=g).to(device)
    pair = torch.randn(2, 40, 40, 16, generator=g).to(device)
    mask = (torch.arange(40) < 33).float().expand(2, 40).to(device)
    with torch.inference_mode():
        A.reset_launch_counts()
        kernel = mod(single, pair, mask)
        assert A.LAUNCHES == _launches(rows_attention=4, tiled_attention=3)
        with A.plain_route():
            plain = mod(single, pair, mask)
        assert A.LAUNCHES == _launches(rows_attention=4, tiled_attention=3)
    for a, b in zip(kernel, plain):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_denoiser_fast_route_matches_plain(device):
    """fast_softmax with use_pallas_bwd off under the Pallas plan
    (use_pallas, as the JAX plan at N >= 384): both triangle attentions of
    each block take K1 fast, in the forward and under autograd, and no K7
    runs (the backward is the plain VJP)."""
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.models.denoiser import Denoiser

    cfg = ModelConfig(single_dim=32, pair_dim=16, head_dim=8, num_heads=2, num_blocks=2,
                      dtype="bfloat16", fast_softmax=True, use_pallas_bwd=False, use_pallas=True)
    torch.manual_seed(0)
    mod = Denoiser(cfg).to(device)
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(0.1 * torch.randn_like(p))
    g = torch.Generator(device="cpu").manual_seed(3)
    single = torch.randn(2, 40, 32, generator=g).to(device)
    pair = torch.randn(2, 40, 40, 16, generator=g).to(device)
    mask = (torch.arange(40) < 33).float().expand(2, 40).to(device)
    with torch.inference_mode():
        A.reset_launch_counts()
        kernel = mod(single, pair, mask)
        assert A.LAUNCHES == _launches(rows_attention_fast=4, tiled_attention=3)
        with A.plain_route():
            plain = mod(single, pair, mask)
        assert A.LAUNCHES == _launches(rows_attention_fast=4, tiled_attention=3)
    for a, b in zip(kernel, plain):
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), atol=3e-2 * scale, rtol=3e-2)
    A.reset_launch_counts()
    with pytest.warns(UserWarning, match="fast_softmax is on"):
        sum(o.float().sum() for o in mod(single, pair.requires_grad_(), mask)).backward()
    # remat (on by default): the backward recomputes each block's forward
    assert A.LAUNCHES["rows_attention_fast"] == 8 and A.LAUNCHES["rows_attention_bwd"] == 0
    assert torch.isfinite(pair.grad).all()


def _assert_grads_close(got, want, dtype):
    tol = _tol(dtype, 16)
    for a, b in zip(got, want):
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), atol=tol * max(scale, 1.0), rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [16, 45, 192])
@pytest.mark.parametrize("C", [8, 12, 16, 20, 32, 48, 64, 128])
def test_rows_bwd_kernel_matches_plain(device, dtype, N, C):
    """K7 against its plain version: C a multiple of 8 on its tensor-core
    bodies (bf16 attention_bwd_mma.cu, f32 3xTF32 attention_bwd_tf32.cu at
    1e-5), C = 12 and 20 (4 mod 8) on its CUDA-core body, attention_bwd.cu,
    which the main path takes at those widths."""
    tensor_cores = C % 8 == 0
    assert A.takes_mma("rows_attention_bwd", dtype, C) == (tensor_cores and dtype == torch.bfloat16)
    assert A.takes_tf32x3("rows_attention_bwd", dtype, C) == (tensor_cores
                                                               and dtype == torch.float32)
    q, k, v, mask, _ = _inputs(6, N, 2, C, dtype, device, seed=5, masked_rows=2)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(6)).to(device, dtype)
    before = A.LAUNCHES["rows_attention_bwd"]
    grads = A.rows_attention_bwd(q, k, v, mask, g, 0.35)
    torch.cuda.synchronize()
    assert A.LAUNCHES["rows_attention_bwd"] == before + 1
    ref = A.rows_attention_bwd_reference(q, k, v, mask, g, 0.35)
    _assert_grads_close(grads, ref, dtype)
    # fully masked rows: dq = dk = 0, dv from the uniform probabilities
    assert torch.count_nonzero(grads[0][:2]) == 0 and torch.count_nonzero(grads[1][:2]) == 0
    assert torch.count_nonzero(grads[2][:2]) > 0


def test_rows_bwd_strided_operands(device):
    """The 'ending' triangle layout: k, v and dO read through strides."""
    N, H, C = 40, 4, 16
    q, k, v, mask, _ = _inputs(N, N, H, C, torch.float32, device, seed=7)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(8)).to(device)
    qt, kt, vt, gt = (x.transpose(0, 1) for x in (q, k, v, g))
    grads = A.rows_attention_bwd(qt, kt, vt, mask, gt, 0.25)
    ref = A.rows_attention_bwd_reference(*(x.contiguous() for x in (qt, kt, vt)), mask,
                                         gt.contiguous(), 0.25)
    _assert_grads_close(grads, ref, torch.float32)


def _backward(name, q, k, v, mask, g, scale, mma=None):
    """K7 (``name`` "rows_attention_bwd") or K6 on K5's plain stats, and its
    plain version: (grads, ref). ``mma`` None: the wrapper's own body."""
    if name == "rows_attention_bwd":
        ref = A.rows_attention_bwd_reference(q, k, v, mask, g, scale)
        if mma is None:
            return A.rows_attention_bwd(q, k, v, mask, g, scale), ref
        return A.attention_body(name, q, k, v, mask, None, scale, mma=mma, dout=g), ref
    dense = [x.contiguous() for x in (q, k, v)]
    out, m, logs = A.rows_attention_kchunk_reference(*dense, mask, scale, stats=True)
    ref = A.rows_attention_kchunk_bwd_reference(*dense, mask, g.contiguous(), out, m, logs, scale)
    if mma is None:
        return A.rows_attention_kchunk_bwd(q, k, v, mask, g, out, m, logs, scale), ref
    return A.attention_body(name, q, k, v, mask, None, scale, mma=mma, dout=g, out=out, m=m,
                            logs=logs), ref


@pytest.mark.parametrize("name", ["rows_attention_bwd", "rows_attention_kchunk_bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [12, 16, 64])
def test_rows_bwd_mma_strided_operands(device, name, dtype, C):
    """K7's and K6's tensor-core bodies (bf16, and 3xTF32 in f32) in the
    'ending' triangle layout: q, k, v and dO read through strides, fully
    masked rows included; at C = 12 their CUDA-core bodies, in the same
    layout."""
    assert A.takes_tensor_cores(name, dtype, C) == (C % 8 == 0)
    N, H = 40, 1 if C == 64 else 4
    q, k, v, mask, _ = _inputs(N, N, H, C, dtype, device, seed=7, masked_rows=3)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(8)).to(device, dtype)
    qt, kt, vt, gt = (x.transpose(0, 1) for x in (q, k, v, g))
    assert not kt.is_contiguous()
    grads, ref = _backward(name, qt, kt, vt, mask, gt, 0.25)
    _assert_grads_close(grads, ref, dtype)


@pytest.mark.parametrize("name", ["rows_attention_bwd", "rows_attention_kchunk_bwd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("C", [16, 64])
def test_rows_bwd_bodies_agree(device, name, dtype, C):
    """The two bodies of K7 and of K6 on the same inputs (N = 192, 147 nodes
    valid), each against the plain version, in both dtypes: the CUDA-core one
    stays callable (attention_body) for timing beside the tensor-core one."""
    N, H = 192, 4 if C == 16 else 1
    q, k, v, _, _ = _inputs(2 * N, N, H, C, dtype, device, seed=19)
    node = (torch.arange(N, device=device) < 147).float()
    mask = (node[:, None] * node[None, :]).repeat(2, 1)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(20)).to(device, dtype)
    before = A.LAUNCHES[name]
    for mma in (True, False):
        grads, ref = _backward(name, q, k, v, mask, g, 0.25, mma=mma)
        _assert_grads_close(grads, ref, dtype)
        assert torch.count_nonzero(grads[0][147:N]) == 0  # row 0's padded queries
        assert torch.count_nonzero(grads[1][147:N]) == 0
    assert A.LAUNCHES[name] == before + 2


@pytest.mark.parametrize("name", ["rows_attention", "tiled_attention"])
def test_autograd_launches_kernels(device, name):
    """Forward through K1/K2 and backward through K7 (K1) or the plain
    recompute (K2), against autograd of the plain version."""
    q, k, v, mask, bias = _inputs(4, 30, 2, 16, torch.float32, device, seed=9, masked_rows=1)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(10)).to(device)
    grads = []
    for plain in (False, True):
        inputs = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        b = None if name == "rows_attention" else inputs[3]
        A.reset_launch_counts()
        if plain:
            out = A.attention_reference(*inputs[:3], mask, b, 0.25)
        elif name == "rows_attention":
            out = A.rows_attention(*inputs[:3], mask, 0.25)
        else:
            out = A.tiled_attention(*inputs[:3], mask, b, 0.25)
        out.backward(g)
        torch.cuda.synchronize()
        if not plain:
            assert A.LAUNCHES == _launches(rows_attention=int(name == "rows_attention"),
                                           tiled_attention=int(name == "tiled_attention"),
                                           rows_attention_bwd=int(name == "rows_attention"))
        grads.append([t.grad for t in inputs[: 3 if b is None else 4]])
    _assert_grads_close(grads[0], grads[1], torch.float32)


def test_denoiser_grad_kernel_route_matches_plain(device):
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.models.denoiser import Denoiser

    cfg = ModelConfig(single_dim=32, pair_dim=16, head_dim=8, num_heads=2, num_blocks=2,
                      dtype="float32", remat=True)
    torch.manual_seed(0)
    mod = Denoiser(cfg).to(device)
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(0.1 * torch.randn_like(p))
    gen = torch.Generator(device="cpu").manual_seed(3)
    single = torch.randn(2, 40, 32, generator=gen).to(device)
    pair = torch.randn(2, 40, 40, 16, generator=gen).to(device)
    mask = (torch.arange(40) < 33).float().expand(2, 40).to(device)
    grads = []
    for plain in (False, True):
        mod.zero_grad()
        A.reset_launch_counts()
        if plain:
            with A.plain_route():
                s, p = mod(single, pair, mask)
                (s.square().sum() + p.square().sum()).backward()
            assert A.LAUNCHES == _launches()
        else:
            s, p = mod(single, pair, mask)
            (s.square().sum() + p.square().sum()).backward()
            # remat: each block's forward runs again in the backward
            assert A.LAUNCHES == _launches(rows_attention=8, tiled_attention=5,
                                           rows_attention_bwd=4)
        grads.append(torch.cat([q.grad.flatten() for q in mod.parameters()]))
    # Relative norm of the whole gradient: the parameters' gradients span
    # five decades here, so an error carried from the large ones swamps a
    # per-tensor bound on the small ones (f32: sums in another order).
    kernel, plain = grads
    assert float((kernel - plain).norm() / plain.norm()) <= 1e-5


@pytest.fixture
def kchunk_regime(monkeypatch):
    """The K-chunk switch lowered to N = 16 in both dtypes, chunk 8."""
    monkeypatch.setattr(A, "ROWS_KCHUNK_MIN_N", 16)
    monkeypatch.setattr(A, "ROWS_KCHUNK_MIN_N_F32", 16)
    monkeypatch.setattr(A, "KCHUNK", 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [16, 45, 200])
@pytest.mark.parametrize("C", [8, 16, 64, 128])
def test_kchunk_kernels_match_plain(device, dtype, N, C):
    """K3 and K5 against their plain version, with fully masked rows: both on
    their tensor-core body (bf16: attention_mma.cu; f32: 3xTF32,
    attention_tf32.cu, every C here a multiple of 8), one body, so K5's
    output is K3's bit for bit."""
    name = "rows_attention_kchunk_stats"
    assert A.takes_tensor_cores(name, dtype, C) and A.takes_tensor_cores(name[:-6], dtype, C)
    q, k, v, mask, _ = _inputs(6, N, 2, C, dtype, device, seed=11, masked_rows=2)
    before = dict(A.LAUNCHES)
    out = A.rows_attention_kchunk(q, k, v, mask, 0.35)
    out_s, m, logs = A.rows_attention_kchunk_stats(q, k, v, mask, 0.35)
    torch.cuda.synchronize()
    assert A.LAUNCHES["rows_attention_kchunk"] == before["rows_attention_kchunk"] + 1
    assert A.LAUNCHES["rows_attention_kchunk_stats"] == before["rows_attention_kchunk_stats"] + 1
    ref, ref_m, ref_logs = A.rows_attention_kchunk_reference(q, k, v, mask, 0.35, stats=True)
    tol = _tol(dtype, C)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(out_s, out, atol=0, rtol=0)
    torch.testing.assert_close(m, ref_m, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(logs, ref_logs, atol=1e-5, rtol=1e-5)
    mean_v = v[:2].float().mean(1, keepdim=True).expand_as(out[:2])
    torch.testing.assert_close(out[:2].float(), mean_v, atol=tol, rtol=tol)
    assert (m[:2] == A.NEG_INF).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [16, 45, 48, 200, 1030])
@pytest.mark.parametrize("C", [8, 12, 16, 20, 64, 128])
def test_kchunk_bwd_kernel_matches_plain(device, dtype, N, C):
    """K6 against its plain version on the same stats: C a multiple of 8 on
    its tensor-core bodies (bf16 attention_bwd_mma.cu, f32 3xTF32
    attention_bwd_tf32.cu at 1e-5), C = 12 and 20 on its CUDA-core body,
    attention_kchunk_bwd.cu; fully masked rows give exact zeros in dq and
    dk."""
    name, tensor_cores = "rows_attention_kchunk_bwd", C % 8 == 0
    assert A.takes_mma(name, dtype, C) == (tensor_cores and dtype == torch.bfloat16)
    assert A.takes_tf32x3(name, dtype, C) == (tensor_cores and dtype == torch.float32)
    q, k, v, mask, _ = _inputs(6, N, 2, C, dtype, device, seed=12, masked_rows=2)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(13)).to(device, dtype)
    out, m, logs = A.rows_attention_kchunk_reference(q, k, v, mask, 0.35, stats=True)
    before = A.LAUNCHES["rows_attention_kchunk_bwd"]
    grads = A.rows_attention_kchunk_bwd(q, k, v, mask, g, out, m, logs, 0.35)
    torch.cuda.synchronize()
    assert A.LAUNCHES["rows_attention_kchunk_bwd"] == before + 1
    ref = A.rows_attention_kchunk_bwd_reference(q, k, v, mask, g, out, m, logs, 0.35)
    _assert_grads_close(grads, ref, dtype)
    assert torch.count_nonzero(grads[0][:2]) == 0 and torch.count_nonzero(grads[1][:2]) == 0
    assert torch.count_nonzero(grads[2][:2]) > 0


def test_kchunk_strided_operands(device):
    """The 'ending' triangle layout: K3, K5 (f32: the 3xTF32 body) and K6
    read through strides."""
    N, H, C = 40, 4, 16
    q, k, v, mask, _ = _inputs(N, N, H, C, torch.float32, device, seed=14)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(15)).to(device)
    qt, kt, vt, gt = (x.transpose(0, 1) for x in (q, k, v, g))
    dense = [x.contiguous() for x in (qt, kt, vt)]
    out, m, logs = A.rows_attention_kchunk_stats(qt, kt, vt, mask, 0.25)
    ref, ref_m, ref_logs = A.rows_attention_kchunk_reference(*dense, mask, 0.25, stats=True)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    grads = A.rows_attention_kchunk_bwd(qt, kt, vt, mask, gt, ref, ref_m, ref_logs, 0.25)
    want = A.rows_attention_kchunk_bwd_reference(*dense, mask, gt.contiguous(), ref, ref_m,
                                                 ref_logs, 0.25)
    _assert_grads_close(grads, want, torch.float32)


def test_kchunk_offsets_past_2_31_elements(device):
    """One operand of more than 2^31 elements: offsets are 64-bit. The last
    rows, whose elements lie past 2^31, against the plain version: K3, K5
    (its stats too), K6 and K7, each on its bf16 tensor-core body."""
    R, N, H, C = 70000, 64, 4, 128
    assert R * N * H * C > 2**31
    g = torch.Generator(device=device).manual_seed(16)
    q, k, v = (torch.randn(R, N, H, C, generator=g, device=device, dtype=torch.bfloat16)
               for _ in range(3))
    mask = torch.ones(R, N, device=device)
    tail = slice(R - 3, R)
    out = A.rows_attention_kchunk(q, k, v, mask, 0.1)
    ref = A.rows_attention_kchunk_reference(q[tail], k[tail], v[tail], mask[tail], 0.1)
    torch.testing.assert_close(out[tail].float(), ref.float(), atol=2e-2, rtol=2e-2)
    out_s, m, logs = A.rows_attention_kchunk_stats(q, k, v, mask, 0.1)
    torch.testing.assert_close(out_s[tail], out[tail], atol=0, rtol=0)
    del out, out_s
    _, ref_m, ref_logs = A.rows_attention_kchunk_reference(q[tail], k[tail], v[tail], mask[tail],
                                                           0.1, stats=True)
    torch.testing.assert_close(m[tail], ref_m, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(logs[tail], ref_logs, atol=1e-5, rtol=1e-5)
    dout = torch.randn(R, N, H, C, generator=g, device=device, dtype=torch.bfloat16)
    out = A.rows_attention_kchunk(q, k, v, mask, 0.1)
    grads = A.rows_attention_kchunk_bwd(q, k, v, mask, dout, out, m, logs, 0.1)
    want = A.rows_attention_kchunk_bwd_reference(q[tail], k[tail], v[tail], mask[tail],
                                                 dout[tail], out[tail], m[tail], logs[tail], 0.1)
    _assert_grads_close([t[tail] for t in grads], want, torch.bfloat16)
    del out, m, logs, grads
    grads = A.rows_attention_bwd(q, k, v, mask, dout, 0.1)
    want = A.rows_attention_bwd_reference(q[tail], k[tail], v[tail], mask[tail], dout[tail], 0.1)
    _assert_grads_close([t[tail] for t in grads], want, torch.bfloat16)


def test_bwd_f32_offsets_past_2_31_elements(device):
    """K6 and K7 on their f32 body (3xTF32) with operands and gradients of
    more than 2^31 elements: offsets are 64-bit. q and k are the two halves
    of one buffer (v reads q, dO reads k) to fit the card's memory; the last
    rows, whose elements lie past 2^31, against the plain version."""
    R, N, H, C = 65540, 64, 4, 128
    assert R * N * H * C > 2**31
    assert A.takes_tf32x3("rows_attention_kchunk_bwd", torch.float32, C)
    assert A.takes_tf32x3("rows_attention_bwd", torch.float32, C)
    buf = torch.randn(R, N, H, 2 * C, generator=torch.Generator(device=device).manual_seed(17),
                      device=device)
    q, k = buf[..., :C], buf[..., C:]
    v, dout = q, k
    mask = torch.ones(R, N, device=device)
    tail = slice(R - 3, R)
    rows = [x[tail].contiguous() for x in (q, k, v, dout)]
    out, m, logs = A.rows_attention_kchunk_stats(q, k, v, mask, 0.1)
    grads = A.rows_attention_kchunk_bwd(q, k, v, mask, dout, out, m, logs, 0.1)
    want = A.rows_attention_kchunk_bwd_reference(*rows[:3], mask[tail], rows[3], out[tail],
                                                 m[tail], logs[tail], 0.1)
    _assert_grads_close([t[tail] for t in grads], want, torch.float32)
    del out, m, logs, grads
    grads = A.rows_attention_bwd(q, k, v, mask, dout, 0.1)
    want = A.rows_attention_bwd_reference(*rows[:3], mask[tail], rows[3], 0.1)
    _assert_grads_close([t[tail] for t in grads], want, torch.float32)


def test_kchunk_autograd_launches_kernels(device, kchunk_regime):
    """At or above the switch: K3 without a gradient; K5 and K6 with one,
    never K1 or K7, matching autograd of the plain reference."""
    q, k, v, mask, _ = _inputs(4, 30, 2, 16, torch.float32, device, seed=17, masked_rows=1)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(18)).to(device)
    A.reset_launch_counts()
    with torch.no_grad():
        A.rows_attention(q, k, v, mask, 0.25)
    assert A.LAUNCHES == _launches(rows_attention_kchunk=1)
    grads = []
    for plain in (False, True):
        inputs = [t.clone().requires_grad_() for t in (q, k, v)]
        A.reset_launch_counts()
        if plain:
            out = A.attention_reference(*inputs, mask, None, 0.25)
        else:
            out = A.rows_attention(*inputs, mask, 0.25)
        out.backward(g)
        torch.cuda.synchronize()
        if not plain:
            assert A.LAUNCHES == _launches(rows_attention_kchunk_stats=1,
                                           rows_attention_kchunk_bwd=1)
        grads.append([t.grad for t in inputs])
    _assert_grads_close(grads[0], grads[1], torch.float32)


def test_kchunk_wrappers_reject(device):
    q, k, v, mask, _ = _inputs(2, 16, 2, 8, torch.float32, device)
    wide = torch.zeros(2, 16, 1, 1028, device=device)
    with pytest.raises(ValueError):  # 4 x C / 32 accumulators per lane: C <= 1024
        A.rows_attention_kchunk(wide, wide, wide, mask, 0.5)
    with pytest.raises(ValueError):
        A.rows_attention_kchunk_stats(q, k, v, mask.cpu(), 0.5)
    out, m, logs = A.rows_attention_kchunk_stats(q, k, v, mask, 0.5)
    with pytest.raises(ValueError):
        A.rows_attention_kchunk_bwd(q, k, v, mask, q, out, m[:, :1], logs, 0.5)
    with pytest.raises(TypeError):
        A.rows_attention_kchunk(q.half(), k.half(), v.half(), mask, 0.5)


def test_denoiser_kchunk_grad_route_matches_plain(device, kchunk_regime):
    """A remat'd denoiser whose triangle attentions all run in the K-chunk
    regime: K5 twice (forward and recompute) and K6 once per attention."""
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.models.denoiser import Denoiser

    cfg = ModelConfig(single_dim=32, pair_dim=16, head_dim=8, num_heads=2, num_blocks=2,
                      dtype="float32", remat=True)
    torch.manual_seed(0)
    mod = Denoiser(cfg).to(device)
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(0.1 * torch.randn_like(p))
    gen = torch.Generator(device="cpu").manual_seed(3)
    single = torch.randn(2, 40, 32, generator=gen).to(device)
    pair = torch.randn(2, 40, 40, 16, generator=gen).to(device)
    mask = (torch.arange(40) < 33).float().expand(2, 40).to(device)
    grads = []
    for plain in (False, True):
        mod.zero_grad()
        A.reset_launch_counts()
        with A.plain_route() if plain else torch.enable_grad():
            s, p = mod(single, pair, mask)
            (s.square().sum() + p.square().sum()).backward()
        expected = _launches() if plain else _launches(
            rows_attention_kchunk_stats=8, rows_attention_kchunk_bwd=4, tiled_attention=5)
        assert A.LAUNCHES == expected
        grads.append(torch.cat([q.grad.flatten() for q in mod.parameters()]))
    kernel, plain = grads
    assert float((kernel - plain).norm() / plain.norm()) <= 1e-5


# The fused kernels K8-K11 against their plain versions: relative norm of the
# difference, 1e-5 in float32 and 2e-2 in bfloat16 (the kernels sum in another
# order; in bf16 the rounded operands then round differently).
FUSED_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _randn(*shape, seed=0, scale=1.0, device="cuda"):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (scale * torch.randn(*shape, generator=g)).to(device)


def _pair_mask(B, N, device, masked_rows=0, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    m = (torch.rand(B, N, generator=g) > 0.2).float()
    m2 = m[:, :, None] * m[:, None, :]
    m2[0, :masked_rows] = 0.0
    return m2.to(device)


def _linear(out_dim, in_dim, device, seed):
    return (_randn(out_dim, in_dim, seed=seed, scale=in_dim ** -0.5, device=device),
            _randn(out_dim, seed=seed + 1, scale=0.3, device=device))


@DTYPES
@pytest.mark.parametrize("D,Hd,Dout,M,with_b2", [(64, 256, 64, 1000, True), (512, 2048, 512, 37, True),
                                                 (16, 64, 24, 5, False), (40, 72, 100, 130, False),
                                                 (96, 100, 70, 70, True), (768, 3072, 768, 37, True),
                                                 (700, 96, 40, 70, False), (128, 512, 128, 1000, True),
                                                 (64, 256, 64, 70000, True), (24, 200, 136, 100, True)])
def test_transition_kernel_matches_plain(device, dtype, D, Hd, Dout, M, with_b2):
    from protein_redesign_tpu_torch.ops import transition as T

    x = _randn(M, D, seed=1, device=device).to(dtype)
    w1, b1 = _linear(Hd, D, device, 2)
    w2, b2 = _linear(Dout, Hd, device, 4)
    b2 = b2 if with_b2 else None
    before = A.LAUNCHES["fused_transition"]
    got = T.transition(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert A.LAUNCHES["fused_transition"] == before + 1
    assert got.dtype == dtype and got.shape == (M, Dout)
    assert _rel(got, T.transition_reference(x, w1, b1, w2, b2)) <= FUSED_TOL[dtype]


@DTYPES
@pytest.mark.parametrize("tensor_cores", [True, False], ids=["mma", "cuda_cores"])
@pytest.mark.parametrize("D,Hd,Dout,M", [(512, 2048, 512, 1536), (768, 3072, 768, 37),
                                         (40, 200, 136, 100)])
def test_transition_split_repeats_bit_for_bit(device, dtype, tensor_cores, D, Hd, Dout, M,
                                             monkeypatch):
    """K10's split layouts (an output wider than the rows layouts take: each
    hidden chunk's partial sums in its own slab, summed in chunk order) give
    the same bits at every call, on both bodies: parallel-in-time sampling
    at tolerance 0 converges only on bit-equal repeats."""
    from protein_redesign_tpu_torch.ops import transition as T

    assert T.transition_layout(D, Hd, Dout, dtype) == "split"
    if not tensor_cores:
        monkeypatch.setattr(T, "transition_takes_tensor_cores", lambda *a: False)
    x = _randn(M, D, seed=11, device=device).to(dtype)
    w1, b1 = _linear(Hd, D, device, 12)
    w2, b2 = _linear(Dout, Hd, device, 14)
    first = T.transition(x, w1, b1, w2, b2)
    for _ in range(3):
        assert torch.equal(T.transition(x, w1, b1, w2, b2), first)
    assert _rel(first, T.transition_reference(x, w1, b1, w2, b2)) <= FUSED_TOL[dtype]


@DTYPES
@pytest.mark.parametrize("D,Hd,Dout,M", [(64, 256, 64, 3000), (128, 512, 128, 300),
                                         (512, 2048, 512, 37), (768, 3072, 768, 20)])
def test_transition_bodies_agree(device, dtype, D, Hd, Dout, M, monkeypatch):
    """K10's tensor-core body (transition_mma.cu, in the layout its
    predicate names, which the library's own layout_of agrees with) and its
    CUDA-core body (transition.cu, the predicate patched, as chip_smoke times
    it) on the same inputs: one launch each, each held to the plain version."""
    from protein_redesign_tpu_torch.kernels import build
    from protein_redesign_tpu_torch.ops import transition as T

    layout = T.transition_layout(D, Hd, Dout, dtype)
    code = build().lib.prd_transition_mma_layout(int(dtype == torch.bfloat16), D, Hd, Dout)
    assert layout == {0: "resident", 1: "streamed", 2: "split"}[code]
    x = _randn(M, D, seed=3, device=device).to(dtype)
    w1, b1 = _linear(Hd, D, device, 5)
    w2, b2 = _linear(Dout, Hd, device, 7)
    want = T.transition_reference(x, w1, b1, w2, b2)
    before = A.LAUNCHES["fused_transition"]
    tensor_cores = T.transition(x, w1, b1, w2, b2)
    monkeypatch.setattr(T, "transition_takes_tensor_cores", lambda *a: False)
    cuda_cores = T.transition(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert A.LAUNCHES["fused_transition"] == before + 2
    for got in (tensor_cores, cuda_cores):
        assert got.dtype == dtype and _rel(got, want) <= FUSED_TOL[dtype]


@pytest.mark.parametrize("N,C", [(45, 16), (384, 16), (384, 128), (1800, 16), (1400, 128),
                                 (192, 256), (640, 256), (70, 1024), (1900, 1024)])
def test_rows_fast_f32_bodies(device, N, C):
    """K1 fast in f32 on its 3xTF32 body (logits kept in shared memory up to
    N ~ 1680 at C = 16 and ~ 1280 at C = 128, recomputed in each pass past
    that: N = 1800 and 1400; past C = 128 the wide body, which keeps them up
    to N = 576 at C <= 512 and 1856 above: N = 640 and 1900 recompute) and
    on its CUDA-core body, the padded rows fully masked: each held to the
    plain version within 2e-2; the outputs that a bf16 rounding flip moved
    (past the f32 sums' 1e-5) stay rare, so a near-midpoint logit recomputed
    into the wrong row or key shows."""
    q, k, v, mask, _ = _inputs(4, N, 2, C, torch.float32, device, seed=N + C, masked_rows=1)
    q = 3.0 * q * (16 / C) ** 0.5
    ref = A.rows_attention_fast_reference(q, k, v, mask, C ** -0.5)
    before = A.LAUNCHES["rows_attention_fast"]
    for mma in (True, False):
        out = A.attention_body("rows_attention_fast", q, k, v, mask, None, C ** -0.5, mma=mma)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)
        moved = (out - ref).abs() > 1e-5 * (1 + ref.abs())
        assert float(moved.float().mean()) < 0.05
    assert A.LAUNCHES["rows_attention_fast"] == before + 2


@DTYPES
@pytest.mark.parametrize("body", ["tensor_cores", "cuda_cores"])
@pytest.mark.parametrize("B,N,S,D", [(2, 45, 64, 64), (1, 130, 512, 64), (1, 7, 16, 8),
                                     (1, 33, 128, 128), (2, 20, 32, 96), (1, 7, 40, 24),
                                     (2, 45, 40, 8), (1, 130, 16, 128), (2, 45, 512, 96),
                                     (1, 130, 40, 24), (1, 7, 512, 128)])
def test_outer_kernel_matches_plain(device, dtype, body, B, N, S, D, monkeypatch):
    """K11 on its tensor-core body (outer_mma.cu) and on its CUDA-core body
    (outer.cu, the predicate patched, as chip_smoke times it) at shapes that
    hit the tails: N not a multiple of the 32-row j tile or of the 16- and
    8-row i tiles, S past the last 64-wide chunk (16, 40), D not a multiple
    of 64."""
    from protein_redesign_tpu_torch.ops import outer as O

    assert O.outer_takes_tensor_cores(S, D, dtype)
    if body == "cuda_cores":
        monkeypatch.setattr(O, "outer_takes_tensor_cores", lambda S, D, dtype: False)
    x = _randn(B, N, S, seed=5, device=device).to(dtype)
    w, b = _linear(D, 2 * S, device, 6)
    before = A.LAUNCHES["fused_outer_linear"]
    got = O.outer(x, w, b)
    torch.cuda.synchronize()
    assert A.LAUNCHES["fused_outer_linear"] == before + 1
    assert got.shape == (B, N, N, D) and got.dtype == dtype
    assert _rel(got, O.outer_reference(x, w, b)) <= FUSED_TOL[dtype]


@pytest.mark.parametrize("dtype,B,N,S,D", [
    (torch.float32, 1, 7, 16, 12), (torch.float32, 2, 45, 64, 20),
    (torch.bfloat16, 1, 7, 16, 12), (torch.bfloat16, 2, 45, 64, 20),
    (torch.bfloat16, 1, 7, 12, 8), (torch.bfloat16, 2, 45, 20, 64)])
def test_outer_cuda_core_route(device, dtype, B, N, S, D):
    """Shapes past the tensor-core body (D = 4 mod 8, or bf16 S not a
    multiple of 8) take outer.cu with nothing patched: one launch, its
    kernel alone on the profiler, within FUSED_TOL of the plain version."""
    from protein_redesign_tpu_torch.ops import outer as O

    assert O.outer_fits(B, N, D, dtype) and not O.outer_takes_tensor_cores(S, D, dtype)
    x = _randn(B, N, S, seed=7, device=device).to(dtype)
    w, b = _linear(D, 2 * S, device, 8)
    before = A.LAUNCHES["fused_outer_linear"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = O.outer(x, w, b)
        torch.cuda.synchronize()
    assert A.LAUNCHES["fused_outer_linear"] == before + 1
    names = [e.key for e in prof.key_averages() if "outer" in e.key]
    assert any("outer_kernel" in n for n in names) and not any("outer_mma" in n for n in names)
    assert got.shape == (B, N, N, D) and got.dtype == dtype
    assert _rel(got, O.outer_reference(x, w, b)) <= FUSED_TOL[dtype]


@DTYPES
@pytest.mark.parametrize("B,N,S,D", [(2, 45, 512, 64), (1, 33, 40, 128), (1, 7, 16, 24)])
def test_outer_tensor_cores_one_hot(device, dtype, B, N, S, D):
    """W1 picks column s_d for output d (W2 and the bias zero), so the
    tensor-core body's output d is the product round_T(xl_i[s_d] xl_j[s_d])
    itself: in bf16 bit for bit (__hmul2 rounds as the plain version's bf16
    product, and the one nonzero term sums exactly); in f32 within 2^-22 of
    it, since 3xTF32's split keeps 22 of the product's 24 bits. A wrong k
    column, n-tile or row of the fragments moves an output by O(1)."""
    from protein_redesign_tpu_torch.ops import outer as O

    x = _randn(B, N, S, seed=9, device=device).to(dtype)
    s_d = torch.randperm(S, generator=torch.Generator().manual_seed(D))[:D].to(device)
    if D > S:
        s_d = torch.arange(D, device=device) % S
    w = torch.zeros(D, 2 * S, device=device)
    w[torch.arange(D, device=device), s_d] = 1.0
    b = torch.zeros(D, device=device)
    got = O.outer(x, w, b)
    xl = O._ln_u(x, w)[0]
    want = (xl[:, :, None, :] * xl[:, None, :, :])[..., s_d]  # rounded to the dtype
    torch.cuda.synchronize()
    assert got.shape == want.shape
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        assert bool(((got - want).abs() <= 2.0 ** -22 * want.abs()).all())


def test_outer_raises_and_does_not_fall_back(device, monkeypatch):
    """A failed launch of the tensor-core body raises: neither the CUDA-core
    body nor the plain version runs in its place, and no launch is counted."""
    from protein_redesign_tpu_torch.kernels import build
    from protein_redesign_tpu_torch.ops import outer as O

    lib = build()
    calls = []
    monkeypatch.setattr(lib.lib, "prd_outer_mma", lambda *a: calls.append("mma") or 1)
    monkeypatch.setattr(lib.lib, "prd_outer", lambda *a: calls.append("core") or 0)
    monkeypatch.setattr(O, "outer_reference", lambda *a: calls.append("plain"))
    x = _randn(1, 20, 64, seed=5, device=device).to(torch.bfloat16)
    w, b = _linear(64, 128, device, 6)
    before = A.LAUNCHES["fused_outer_linear"]
    with pytest.raises(RuntimeError, match="fused_outer_linear"):
        O.fused_outer_linear(x, w, b)
    assert calls == ["mma"] and A.LAUNCHES["fused_outer_linear"] == before


@DTYPES
@pytest.mark.parametrize("mode", ["outgoing", "incoming"])
@pytest.mark.parametrize("B,N,D", [(2, 45, 64), (1, 40, 16), (1, 17, 24), (1, 33, 128),
                                   (1, 20, 72), (1, 130, 64), (2, 64, 16), (1, 70, 128),
                                   (1, 67, 24), (2, 41, 72)])
def test_trimul_kernel_matches_plain(device, dtype, mode, B, N, D):
    from protein_redesign_tpu_torch.ops import trimul as M

    pair = _randn(B, N, N, D, seed=7, device=device).to(dtype)
    mask = _pair_mask(B, N, device, masked_rows=3)
    ws = [*_linear(2 * D, D, device, 8), *_linear(2 * D, D, device, 10),
          *_linear(D, D, device, 12), *_linear(D, D, device, 14)]
    got = M.trimul(pair, mask, *ws, mode)
    torch.cuda.synchronize()
    assert _rel(got, M.trimul_reference(pair, mask, *ws, mode)) <= FUSED_TOL[dtype]


@DTYPES
@pytest.mark.parametrize("view", ["starting", "ending"])
@pytest.mark.parametrize("N,D,H,C", [(45, 64, 4, 16), (40, 16, 2, 8), (20, 24, 3, 32),
                                     (33, 128, 4, 32), (20, 96, 4, 16), (45, 64, 1, 64),
                                     (70, 128, 4, 64), (33, 64, 4, 128), (20, 128, 1, 128),
                                     (20, 24, 2, 12), (30, 64, 8, 12), (33, 20, 4, 16),
                                     (130, 64, 4, 16)])
def test_fused_gated_kernel_matches_plain(device, dtype, view, N, D, H, C):
    """The tensor-core body at C a multiple of 8 (h16x4, h64x1, h64x4, up to
    H C = 512), the CUDA-core body at C = 4 mod 8."""
    pair = _randn(2, N, N, D, seed=15, device=device).to(dtype)
    mask = _pair_mask(2, N, device, masked_rows=3)
    if view == "ending":  # the transposed view TriangleAttention hands in, read through strides
        pair, mask = pair.transpose(1, 2), mask.transpose(1, 2)
    ws = [_randn(H * C, D, seed=16 + i, scale=D ** -0.5, device=device) for i in range(4)]
    ws += [_randn(H * C, seed=20, scale=0.3, device=device), *_linear(D, H * C, device, 21)]
    got = A.fused_gated(pair, mask, *ws, H)
    torch.cuda.synchronize()
    want = A.fused_gated_reference(pair, mask, *ws, H)
    assert _rel(got, want) <= FUSED_TOL[dtype]
    if view == "starting":  # fully masked rows attend uniformly, as the plain softmax does
        assert _rel(got[0, :3], want[0, :3]) <= FUSED_TOL[dtype]


def _fused_case(name, device):
    """(differentiable entry point, plain version, inputs, launch counter)."""
    from protein_redesign_tpu_torch.ops import outer as O
    from protein_redesign_tpu_torch.ops import transition as T
    from protein_redesign_tpu_torch.ops import trimul as M

    if name == "transition":
        return (T.fused_transition, T.transition_reference,
                [_randn(30, 16, seed=1, device=device), *_linear(64, 16, device, 2),
                 *_linear(16, 64, device, 4)], "fused_transition")
    if name == "outer":
        return (O.fused_outer_linear, O.outer_reference,
                [_randn(2, 12, 16, seed=5, device=device), *_linear(8, 32, device, 6)],
                "fused_outer_linear")
    if name == "trimul":
        ws = [*_linear(16, 8, device, 8), *_linear(16, 8, device, 10), *_linear(8, 8, device, 12),
              *_linear(8, 8, device, 14)]
        return (lambda *a: M.triangle_multiply(*a, "outgoing"),
                lambda *a: M.trimul_reference(*a, "outgoing"),
                [_randn(2, 12, 12, 8, seed=7, device=device), _pair_mask(2, 12, device), *ws],
                "triangle_multiply")
    ws = [_randn(8, 8, seed=16 + i, scale=8 ** -0.5, device=device) for i in range(4)]
    ws += [_randn(8, seed=20, scale=0.3, device=device), *_linear(8, 8, device, 21)]
    return (lambda *a: A.fused_gated_rows_attention(*a, 2),
            lambda *a: A.fused_gated_reference(*a, 2),
            [_randn(2, 12, 12, 8, seed=15, device=device), _pair_mask(2, 12, device, 2), *ws],
            "fused_gated_rows_attention")


@pytest.mark.parametrize("name", ["transition", "outer", "trimul", "fused_gated"])
def test_fused_autograd_launches_kernel(device, name):
    """The forward launches the kernel once; the backward (autograd of the
    plain version, no kernel) matches autograd of the plain version."""
    fn, plain, inputs, counter = _fused_case(name, device)
    needs = [t.dim() > 0 and not (name in ("trimul", "fused_gated") and i == 1)
             for i, t in enumerate(inputs)]
    grads = []
    for use_plain in (False, True):
        leaves = [t.clone().requires_grad_(n) for t, n in zip(inputs, needs)]
        A.reset_launch_counts()
        out = (plain if use_plain else fn)(*leaves)
        out.backward(torch.ones_like(out))
        torch.cuda.synchronize()
        assert A.LAUNCHES == (_launches() if use_plain else _launches(**{counter: 1}))
        grads.append([t.grad for t, n in zip(leaves, needs) if n])
    for got, want in zip(*grads):
        assert _rel(got, want) <= 1e-5


def test_fused_wrappers_reject(device):
    from protein_redesign_tpu_torch.ops import outer as O
    from protein_redesign_tpu_torch.ops import transition as T
    from protein_redesign_tpu_torch.ops import trimul as M

    with pytest.raises(ValueError):  # pair width beyond 512
        ws = [*_linear(1026, 513, device, 0), *_linear(1026, 513, device, 0),
              *_linear(513, 513, device, 0), *_linear(513, 513, device, 0)]
        M.trimul(torch.zeros(1, 4, 4, 513, device=device), torch.ones(1, 4, 4, device=device),
                 *ws, "outgoing")
    with pytest.raises(ValueError):  # output channels beyond 512
        O.outer(torch.zeros(1, 4, 8, device=device), *_linear(513, 16, device, 0))
    hd = T.MAX_SPLIT_HIDDEN + 64  # a split output's hidden chunks beyond grid.y
    with pytest.raises(ValueError):
        T.transition(torch.zeros(3, 1, device=device), torch.zeros(1, 1, device=device).expand(hd, 1),
                     torch.zeros(hd, device=device),
                     torch.zeros(1, 1, device=device).expand(128, hd))
    # K8 past the JAX kernel's reach: C past 1024, H C past 4096, C not a
    # multiple of 4, D past 512
    for D, H, C in ((16, 1, 1028), (16, 1025, 4), (16, 2, 34), (513, 4, 16)):
        ws = [torch.zeros(H * C, D, device=device) for _ in range(4)]
        with pytest.raises(ValueError):
            A.fused_gated(torch.zeros(1, 4, 4, D, device=device),
                          torch.ones(1, 4, 4, device=device), *ws,
                          torch.zeros(H * C, device=device), torch.zeros(D, H * C, device=device),
                          torch.zeros(D, device=device), H)
    with pytest.raises(TypeError):
        O.outer(torch.zeros(1, 4, 8, device=device).half(), *_linear(8, 16, device, 0))


@DTYPES
def test_fused_cuda_core_bodies_stay_callable(device, dtype, monkeypatch):
    """K8 and K9 on their CUDA-core bodies (the predicates patched, as
    chip_smoke times them) agree with the tensor-core bodies' function."""
    from protein_redesign_tpu_torch.ops import trimul as M

    pair = _randn(2, 45, 45, 64, seed=15, device=device).to(dtype)
    mask = _pair_mask(2, 45, device, masked_rows=3)
    ws = [_randn(64, 64, seed=16 + i, scale=0.125, device=device) for i in range(4)]
    ws += [_randn(64, seed=20, scale=0.3, device=device), *_linear(64, 64, device, 21)]
    tw = [*_linear(128, 64, device, 8), *_linear(128, 64, device, 10), *_linear(64, 64, device, 12),
          *_linear(64, 64, device, 14)]
    monkeypatch.setattr(A, "fused_gated_takes_tensor_cores", lambda D, H, C: False)
    monkeypatch.setattr(M, "trimul_takes_tensor_cores", lambda D: False)
    got = A.fused_gated(pair, mask, *ws, 4)
    assert _rel(got, A.fused_gated_reference(pair, mask, *ws, 4)) <= FUSED_TOL[dtype]
    got = M.trimul(pair, mask, *tw, "incoming")
    assert _rel(got, M.trimul_reference(pair, mask, *tw, "incoming")) <= FUSED_TOL[dtype]


def test_denoiser_fused_route_matches_plain(device):
    """A remat'd denoiser with the four switches: each fused kernel once per
    module in the forward and again in the recompute, K2 as before, no K1 or
    K7; forward and whole gradient against the plain route."""
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.models.denoiser import Denoiser

    cfg = ModelConfig(single_dim=32, pair_dim=16, head_dim=8, num_heads=2, num_blocks=2,
                      dtype="float32", remat=True, use_pallas_trimul=True,
                      use_pallas_transition=True, use_pallas_outer=True,
                      use_pallas_fused_gated=True)
    torch.manual_seed(0)
    mod = Denoiser(cfg).to(device)
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(0.1 * torch.randn_like(p))
    single = _randn(2, 40, 32, seed=3, device=device)
    pair = _randn(2, 40, 40, 16, seed=4, device=device)
    mask = (torch.arange(40) < 33).float().expand(2, 40).to(device)
    outs, grads = [], []
    for plain in (False, True):
        mod.zero_grad()
        A.reset_launch_counts()
        with A.plain_route() if plain else torch.enable_grad():
            s, p = mod(single, pair, mask)
            (s.square().sum() + p.square().sum()).backward()
        expected = _launches() if plain else _launches(
            fused_gated_rows_attention=8, triangle_multiply=8, fused_transition=8,
            fused_outer_linear=4, tiled_attention=5)
        assert A.LAUNCHES == expected
        outs.append((s.detach(), p.detach()))
        grads.append(torch.cat([q.grad.flatten() for q in mod.parameters()]))
    for a, b in zip(*outs):
        assert _rel(a, b) <= 1e-5
    kernel, plain = grads
    assert float((kernel - plain).norm() / plain.norm()) <= 1e-5


# The tensor-core bodies of K2 and K1 fast (attention_mma.cu), bf16 only:
# K2's online softmax rounds p against the running max where the plain
# version rounds the normalised probabilities, and both sum the logits in
# another order than the einsum, so 2e-2 as every bf16 kernel here.
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask_bias", "bias"])
@pytest.mark.parametrize("N", [1, 33, 147, 192, 520])
@pytest.mark.parametrize("C", [16, 64, 512, 640])
def test_tiled_mma_matches_plain(device, with_mask, N, C):
    q, k, v, mask, bias = _inputs(2, N, 4, C, torch.bfloat16, device, seed=30, masked_rows=1)
    m = mask if with_mask else None
    before = A.LAUNCHES["tiled_attention"]
    out = A.tiled_attention(q, k, v, m, bias, 1.0 / C ** 0.5)
    torch.cuda.synchronize()
    assert A.LAUNCHES["tiled_attention"] == before + 1
    ref = A.attention_reference(q, k, v, m, bias, 1.0 / C ** 0.5)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    if with_mask:  # row 0 masks every key: the mean of v
        mean_v = v[:1].float().mean(1, keepdim=True).expand_as(out[:1])
        torch.testing.assert_close(out[:1].float(), mean_v, atol=2e-2, rtol=2e-2)


def test_tiled_mma_strided_and_many_rows(device):
    """K2's tensor-core body on the 'ending' layout (k and v read through
    strides) and with R = 70000 rows (above grid.y and grid.z's 65535)."""
    N, H, C = 40, 4, 16
    q, k, v, mask, bias = _inputs(N, N, H, C, torch.bfloat16, device, seed=31, masked_rows=2)
    qt, kt, vt = (x.transpose(0, 1) for x in (q, k, v))
    assert not kt.is_contiguous()
    out = A.tiled_attention(qt, kt, vt, mask, bias, 0.25)
    ref = A.attention_reference(qt.contiguous(), kt.contiguous(), vt.contiguous(), mask, bias,
                                0.25)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    q, k, v, mask, bias = _inputs(70000, 20, 1, 8, torch.bfloat16, device, seed=32)
    out = A.tiled_attention(q, k, v, mask, bias, 0.5)
    ref = A.attention_reference(q, k, v, mask, bias, 0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


def test_tiled_f32_and_cuda_core_body(device):
    """f32 K2 on its 3xTF32 body and on its CUDA-core one at 1e-5; the bf16
    CUDA-core body, kept for timing against the tensor-core one, still
    matches."""
    q, k, v, mask, bias = _inputs(2, 70, 4, 16, torch.float32, device, seed=33)
    ref = A.attention_reference(q, k, v, mask, bias, 0.25)
    torch.testing.assert_close(A.tiled_attention(q, k, v, mask, bias, 0.25), ref, atol=1e-5,
                               rtol=1e-5)
    got = A.attention_body("tiled_attention", q, k, v, mask, bias, 0.25, mma=False)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    qb, kb, vb, bb = (t.to(torch.bfloat16) for t in (q, k, v, bias))
    for name, b in (("tiled_attention", bb), ("rows_attention_fast", None)):
        got = A.attention_body(name, qb, kb, vb, mask, b, 0.25, mma=False)
        want = (A.attention_reference(qb, kb, vb, mask, b, 0.25) if b is not None
                else A.rows_attention_fast_reference(qb, kb, vb, mask, 0.25))
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    wide = torch.zeros(2, 16, 1, 1176, device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # the tiles of C = 1176 exceed shared memory
        A.tiled_attention(wide, wide, wide, None,
                          torch.zeros(2, 1, 16, 16, device=device, dtype=torch.bfloat16), 1.0)


@pytest.mark.parametrize("N", [192, 384])
def test_rows_fast_mma_matches_plain(device, N):
    """K1 fast's tensor-core body at the serving buckets (R = 2N, H = 4, C =
    16, padded rows fully masked): the same rounding points as the plain
    version, the logits summed in another order, so a bf16 rounding flips
    now and then: 2e-2, and the flips stay rare."""
    q, k, v, mask, _ = _inputs(2 * N, N, 4, 16, torch.bfloat16, device, seed=34, masked_rows=3)
    q = 3.0 * q
    before = A.LAUNCHES["rows_attention_fast"]
    out = A.rows_attention_fast(q, k, v, mask, 0.25)
    torch.cuda.synchronize()
    assert A.LAUNCHES["rows_attention_fast"] == before + 1
    ref = A.rows_attention_fast_reference(q, k, v, mask, 0.25)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2, rtol=2e-2)
    assert float((out != ref).float().mean()) < 0.05
    wide = A.rows_attention_fast(q[:8].repeat(1, 1, 1, 8), k[:8].repeat(1, 1, 1, 8),
                                 v[:8].repeat(1, 1, 1, 8), mask[:8], 0.1)  # C = 128
    want = A.rows_attention_fast_reference(q[:8].repeat(1, 1, 1, 8), k[:8].repeat(1, 1, 1, 8),
                                           v[:8].repeat(1, 1, 1, 8), mask[:8], 0.1)
    torch.testing.assert_close(wide.float(), want.float(), atol=2e-2, rtol=2e-2)


def _paper_denoiser(device, **fields):
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.models.denoiser import Denoiser

    cfg = ModelConfig(**fields)
    torch.manual_seed(0)
    mod = Denoiser(cfg).to(device)
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(0.5 / p.shape[-1] ** 0.5 * torch.randn_like(p) if p.dim() == 2
                   else 0.1 * torch.randn_like(p))
    return mod, cfg


def _trunk_inputs(cfg, N, n_valid, device, B=2):
    g = torch.Generator(device="cpu").manual_seed(N)
    single = torch.randn(B, N, cfg.single_dim, generator=g).to(device)
    pair = torch.randn(B, N, N, cfg.pair_dim, generator=g).to(device)
    mask = (torch.arange(N) < n_valid).float().expand(B, N).to(device)
    return single, pair, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,n_valid", [(192, 147), (384, 360)])
def test_h64x1_train_step_matches_plain(device, dtype, N, n_valid):
    """An h64x1 training step of the trunk (paper widths, 4 blocks, remat),
    kernel route against plain route: K1 and K7 at C = 64, under the whole
    gradient gates of PERF.md section 2 (f32 5e-4, bf16 5e-2)."""
    mod, cfg = _paper_denoiser(device, head_dim=64, num_heads=1, num_blocks=4, dtype=dtype,
                               training_mode=True, remat=True)
    single, pair, mask = _trunk_inputs(cfg, N, n_valid, device)
    grads = []
    for plain in (False, True):
        mod.zero_grad()
        A.reset_launch_counts()
        with A.plain_route() if plain else torch.enable_grad():
            s, p = mod(single, pair, mask)
            (s.float().square().mean() + p.float().square().mean()).backward()
        if not plain:
            assert A.LAUNCHES == _launches(rows_attention=16, rows_attention_bwd=8,
                                           tiled_attention=9)
        grads.append(torch.cat([q.grad.flatten().float() for q in mod.parameters()]))
    kernel, plain = grads
    assert torch.isfinite(kernel).all()
    rel = float((kernel - plain).norm() / plain.norm())
    assert rel <= (5e-4 if dtype == "float32" else 5e-2), rel


@pytest.mark.parametrize("N,use_pallas_bwd,launches", [
    (192, False, {}), (192, True, {}),
    (384, False, {"rows_attention_fast": 24, "tiled_attention": 13}),
])
def test_fast_plan_routes_on_the_card(device, N, use_pallas_bwd, launches):
    """The attention plan with fast_softmax on, at paper width in bf16 (B =
    2): at bucket 192 the JAX plan takes XLA, so every attention computes
    the bf16-logit attention and no K1 fast or K2 launches; at 384 (Pallas,
    inference, use_pallas_bwd off) the 24 triangle attentions take K1 fast
    and the 13 others K2. Against the plain route at 2e-2 relative norm."""
    mod, cfg = _paper_denoiser(device, dtype="bfloat16", fast_softmax=True,
                               use_pallas_bwd=use_pallas_bwd)
    single, pair, mask = _trunk_inputs(cfg, N, N - 30, device)
    with torch.inference_mode():
        A.reset_launch_counts()
        got = mod(single, pair, mask)
        torch.cuda.synchronize()
        assert A.LAUNCHES == _launches(**launches)
        with A.plain_route():
            want = mod(single, pair, mask)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert float((a.float() - b.float()).norm() / b.float().norm()) <= 2e-2


# The tensor-core bodies of K1 and K3 (attention_mma.cu), bf16 with C a
# multiple of 8: K1 rounds the normalised probabilities to bf16 as the plain
# version does (the logits summed in another order), K3 rounds p against
# the running max as its plain version does; 2e-2 as every bf16 kernel here,
# relative to each element and, for the absolute part, to the output's RMS
# (at N = 2048 a typical |out| is ~0.03, so an absolute 2e-2 would pass an
# error as large as the output).
def _close_to_scale(got, want, tol=2e-2):
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=tol,
                               atol=tol * float(want.square().mean().sqrt()))


def _check_body(name, q, k, v, mask, scale, masked_rows):
    before = A.LAUNCHES[name]
    if name == "rows_attention":
        out = A.rows_attention(q, k, v, mask, scale)
        ref = A.attention_reference(q, k, v, mask, None, scale)
    else:
        out = A.rows_attention_kchunk(q, k, v, mask, scale)
        ref = A.rows_attention_kchunk_reference(q, k, v, mask, scale)
    torch.cuda.synchronize()
    assert A.LAUNCHES[name] == before + 1
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    _close_to_scale(out, ref)
    if masked_rows:  # fully masked rows: the mean of v
        mean_v = v[:masked_rows].float().mean(1, keepdim=True).expand_as(out[:masked_rows])
        _close_to_scale(out[:masked_rows], mean_v)


@pytest.mark.parametrize("N", [16, 147, 192, 384])
@pytest.mark.parametrize("C", [8, 16, 64, 128, 256])
def test_rows_mma_matches_plain(device, N, C):
    assert A.takes_mma("rows_attention", torch.bfloat16, C)
    q, k, v, mask, _ = _inputs(6, N, 2, C, torch.bfloat16, device, seed=40, masked_rows=2)
    _check_body("rows_attention", q, k, v, mask, 1.0 / C ** 0.5, 2)


@pytest.mark.parametrize("N", [256, 2048])
@pytest.mark.parametrize("C", [8, 16, 64, 128, 256])
def test_kchunk_mma_matches_plain(device, N, C):
    assert A.takes_mma("rows_attention_kchunk", torch.bfloat16, C)
    q, k, v, mask, _ = _inputs(4 if N == 2048 else 6, N, 2, C, torch.bfloat16, device, seed=41,
                               masked_rows=1)
    _check_body("rows_attention_kchunk", q, k, v, mask, 1.0 / C ** 0.5, 1)


@pytest.mark.parametrize("N", [256, 2048])
@pytest.mark.parametrize("C", [8, 16, 64, 128, 256])
def test_kchunk_stats_mma_matches_plain(device, N, C):
    """K5 on K3's bf16 tensor-core body: its output K3's bit for bit, m and
    log s within 1e-5 of the plain version (64-key tiles against its chunks
    of 256), a fully masked row at m = -2^15 and log s = log N."""
    assert A.takes_mma("rows_attention_kchunk_stats", torch.bfloat16, C)
    q, k, v, mask, _ = _inputs(4 if N == 2048 else 6, N, 2, C, torch.bfloat16, device, seed=41,
                               masked_rows=1)
    scale = 1.0 / C ** 0.5
    out, m, logs = A.rows_attention_kchunk_stats(q, k, v, mask, scale)
    torch.testing.assert_close(out, A.rows_attention_kchunk(q, k, v, mask, scale), atol=0, rtol=0)
    ref, ref_m, ref_logs = A.rows_attention_kchunk_reference(q, k, v, mask, scale, stats=True)
    _close_to_scale(out, ref)
    torch.testing.assert_close(m, ref_m, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(logs, ref_logs, atol=1e-5, rtol=1e-5)
    assert (m[0] == A.NEG_INF).all()
    torch.testing.assert_close(logs[0], torch.full_like(logs[0], float(N)).log(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("N", [45, 256, 1024])
@pytest.mark.parametrize("C", [8, 16, 64, 128])
def test_kchunk_tf32x3_matches_plain(device, N, C):
    """K3 and K5 in f32 on their 3xTF32 body, up to the f32 switch (N =
    1024), a fully masked row included: out, m and log s within 1e-5 of the
    plain version (TF32 off), K5's output K3's bit for bit."""
    assert A.takes_tf32x3("rows_attention_kchunk_stats", torch.float32, C)
    q, k, v, mask, _ = _inputs(4, N, 2, C, torch.float32, device, seed=45, masked_rows=1)
    scale = 1.0 / C ** 0.5
    out = A.rows_attention_kchunk(q, k, v, mask, scale)
    out_s, m, logs = A.rows_attention_kchunk_stats(q, k, v, mask, scale)
    ref, ref_m, ref_logs = A.rows_attention_kchunk_reference(q, k, v, mask, scale, stats=True)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out_s, out, atol=0, rtol=0)
    torch.testing.assert_close(m, ref_m, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(logs, ref_logs, atol=1e-5, rtol=1e-5)
    mean_v = v[:1].mean(1, keepdim=True).expand_as(out[:1])
    torch.testing.assert_close(out[:1], mean_v, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["rows_attention", "rows_attention_kchunk"])
def test_rows_and_kchunk_mma_strided_and_many_rows(device, name):
    """The 'ending' layout (k and v read through strides), and R = 70000
    rows (above grid.y and grid.z's 65535)."""
    N, H, C = 40, 4, 16
    q, k, v, mask, _ = _inputs(N, N, H, C, torch.bfloat16, device, seed=42, masked_rows=2)
    qt, kt, vt = (x.transpose(0, 1) for x in (q, k, v))
    assert not kt.is_contiguous()
    dense = [x.contiguous() for x in (qt, kt, vt)]
    got = A.attention_body(name, qt, kt, vt, mask, None, 0.25, mma=True)
    want = A.attention_body(name, *dense, mask, None, 0.25, mma=True)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    ref = A.attention_reference(*dense, mask, None, 0.25)
    _close_to_scale(got, ref)
    q, k, v, mask, _ = _inputs(70000, 20, 1, 8, torch.bfloat16, device, seed=43, masked_rows=3)
    _check_body(name, q, k, v, mask, 0.5, 3)


@pytest.mark.parametrize("name", ["rows_attention", "rows_attention_kchunk"])
def test_rows_and_kchunk_bodies_stay_callable(device, name):
    """Both bodies of K1 and K3 in bf16 (the CUDA-core one kept to time it
    against the tensor-core one), and f32 on the CUDA-core body at 1e-5; in
    f32, the tensor-core body of both is the 3xTF32 one (1e-5 too)."""
    q, k, v, mask, _ = _inputs(4, 100, 2, 16, torch.float32, device, seed=44, masked_rows=1)
    ref = A.attention_reference(q, k, v, mask, None, 0.3)
    got = A.attention_body(name, q, k, v, mask, None, 0.3, mma=False)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    refb = A.attention_reference(qb, kb, vb, mask, None, 0.3)
    for mma in (False, True):
        got = A.attention_body(name, qb, kb, vb, mask, None, 0.3, mma=mma)
        _close_to_scale(got, refb)
    got = A.attention_body(name, q, k, v, mask, None, 0.3, mma=True)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):  # no tensor-core body at C = 6, not a multiple of 4
        A.attention_body(name, q[..., :6], k[..., :6], v[..., :6], mask, None, 0.3, mma=True)


FOUR_SWITCHES = dict(use_pallas_trimul=True, use_pallas_transition=True, use_pallas_outer=True,
                     use_pallas_fused_gated=True)


@pytest.mark.parametrize("fields,launches,tol", [
    (dict(pair_dim=128, dtype="bfloat16", **FOUR_SWITCHES),
     dict(fused_gated_rows_attention=4, triangle_multiply=4, fused_outer_linear=2,
          tiled_attention=3, fused_transition=4), 2e-2),
    (dict(single_dim=768, dtype="float32"), dict(rows_attention=4, tiled_attention=3), 5e-4),
    (dict(single_dim=768, dtype="bfloat16", use_pallas_transition=True),
     dict(rows_attention=4, tiled_attention=3, fused_transition=4), 2e-2),
], ids=["pair_dim_128_fused", "f32_single_dim_768", "bf16_single_dim_768_transition"])
def test_wide_configurations_run_the_kernels_on_the_card(device, fields, launches, tol):
    """Configurations past the kernels' former bounds: the four switches
    at AlphaFold2's pair width 128 (K8, K9 and K11 now take D <= 128), an
    f32 model with single_dim 768 (SPAttention's head width: K2's wide 3xTF32
    body) and a bf16 one with the transition switch (K10 at D = 768). Every
    module launches its kernel, and the forward holds to the plain route
    (bf16 2e-2, f32 5e-4 relative norm)."""
    mod, cfg = _paper_denoiser(device, num_blocks=2, **fields)
    single, pair, mask = _trunk_inputs(cfg, 64, 50, device)
    with torch.inference_mode():
        A.reset_launch_counts()
        got = mod(single, pair, mask)
        torch.cuda.synchronize()
        assert A.LAUNCHES == _launches(**launches)
        with A.plain_route():
            want = mod(single, pair, mask)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert float((a.float() - b.float()).norm() / b.float().norm()) <= tol


# K1's and K1 fast's CUDA-core kernels, which their wide f32 bodies replace
WIDE_F32_ROWS = {"rows_attention": ("rows_attention_wide_tf32x3_kernel", "rows_attention_kernel"),
                 "rows_attention_fast": ("rows_attention_fast_wide_tf32x3_kernel",
                                         "rows_attention_fast_kernel")}


@pytest.mark.parametrize("name", ["tiled_attention", "rows_attention", "rows_attention_fast"])
@pytest.mark.parametrize("C", [132, 136, 256, 516, 768, 1024])
def test_wide_f32_heads_on_the_cuda_core_body(device, name, C):
    """K2, K1 and K1 fast in f32 past C = 128 on the CUDA-core body (past C
    = 512 its last pass stages V into K's buffer), and through the wrapper:
    K2 at C a multiple of 8 on its wide 3xTF32 body (C = 132 and 516 on the
    CUDA-core body), K1 and K1 fast on theirs at every C here (the profiler
    shows the wide kernel and not the CUDA-core one); N = 70, not a
    multiple of the key tile. Against the plain version at 1e-4 at C >= 512 and 1e-5 below (K1
    fast 2e-2, its bf16 softmax), fully masked rows included; C = 1028 is
    refused."""
    q, k, v, mask, bias = _inputs(2, 70, 1, C, torch.float32, device, seed=50, masked_rows=1)
    scale = C ** -0.5
    b = bias if name == "tiled_attention" else None
    if name == "rows_attention_fast":
        ref, tol = A.rows_attention_fast_reference(q, k, v, mask, scale), 2e-2
    else:
        ref, tol = A.attention_reference(q, k, v, mask, b, scale), _tol(torch.float32, C)
    out = A.attention_body(name, q, k, v, mask, b, scale, mma=False)
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
    tensor_cores = C % 8 == 0 or name != "tiled_attention"
    assert A.takes_tensor_cores(name, torch.float32, C) is tensor_cores
    if name == "tiled_attention":
        out = A.tiled_attention(q, k, v, mask, bias, scale)
    else:
        fn = A.rows_attention_fast if name == "rows_attention_fast" else A.rows_attention
        out, names = _kernel_names(lambda: fn(q, k, v, mask, scale))
        wide_kernel, core_kernel = WIDE_F32_ROWS[name]
        assert any(wide_kernel in n for n in names), names
        assert not any(core_kernel in n for n in names), names
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
    mean_v = v[:1].mean(1, keepdim=True).expand_as(out[:1])
    torch.testing.assert_close(out[:1], mean_v, atol=tol, rtol=tol)
    wide = torch.zeros(2, 16, 1, 1028, device=device)
    wide_bias = torch.zeros(2, 1, 16, 16, device=device) if name == "tiled_attention" else None
    with pytest.raises(ValueError, match="head width 1028"):
        A.attention_body(name, wide, wide, wide, torch.ones(2, 16, device=device), wide_bias,
                         1.0, mma=False)


# the widths the JAX kernels take past the tensor-core bodies' ---------------


@DTYPES
@pytest.mark.parametrize("name", ["rows_attention_bwd", "rows_attention_kchunk_bwd"])
@pytest.mark.parametrize("N,C", [(45, 132), (40, 256), (33, 516), (20, 1024)])
def test_wide_head_backwards_match_plain(device, dtype, name, N, C):
    """K7 and K6 past the narrow tensor-core bodies' 128 against the plain
    versions, fully masked rows and the padding rows of a ragged N included:
    both on their wide tensor-core bodies at multiples of 8 (256, 1024), on
    the CUDA-core bodies at C = 4 mod 8 (CPL 8 and 16 with two staged tiles,
    CPL 32 with one buffer shared by K and V)."""
    assert A.takes_tensor_cores(name, dtype, C) is (C % 8 == 0)
    q, k, v, mask, _ = _inputs(4, N, 2, C, dtype, device, seed=21, masked_rows=1)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(22)).to(device, dtype)
    before = A.LAUNCHES[name]
    grads, ref = _backward(name, q, k, v, mask, g, C ** -0.5)
    torch.cuda.synchronize()
    assert A.LAUNCHES[name] == before + 1
    _assert_grads_close(grads, ref, dtype)
    assert torch.count_nonzero(grads[0][:1]) == 0 and torch.count_nonzero(grads[1][:1]) == 0


@pytest.mark.parametrize("N,C", [(45, 132), (40, 256), (33, 516), (20, 1024)])
def test_wide_head_kchunk_forward_f32_matches_plain(device, N, C):
    """K3 and K5 in f32 past 128 on the wide 3xTF32 body at every multiple
    of 4 (C = 132 and 516: the last 128-channel chunk zero-padded past C):
    against the plain version, K5's output K3's."""
    assert A.takes_tensor_cores("rows_attention_kchunk", torch.float32, C)
    q, k, v, mask, _ = _inputs(4, N, 2, C, torch.float32, device, seed=23, masked_rows=1)
    out = A.rows_attention_kchunk(q, k, v, mask, C ** -0.5)
    out_s, m, logs = A.rows_attention_kchunk_stats(q, k, v, mask, C ** -0.5)
    torch.cuda.synchronize()
    ref, ref_m, ref_logs = A.rows_attention_kchunk_reference(q, k, v, mask, C ** -0.5, stats=True)
    tol = _tol(torch.float32, C)
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)
    torch.testing.assert_close(out_s, out, atol=0, rtol=0)
    torch.testing.assert_close(m, ref_m, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(logs, ref_logs, atol=1e-5, rtol=1e-5)


@DTYPES
@pytest.mark.parametrize("mode", ["outgoing", "incoming"])
@pytest.mark.parametrize("B,N,D", [(1, 17, 1), (2, 45, 36), (1, 33, 136), (1, 20, 192),
                                   (1, 9, 512)])
def test_trimul_wide_body_matches_plain(device, dtype, mode, B, N, D, monkeypatch):
    """K9's CUDA-core wide body: at widths not a multiple of 8 as routed, and
    past 128 with ``trimul_takes_tensor_cores`` patched False (as chip_smoke
    times it beside the tensor-core body); one launch, within FUSED_TOL of
    the plain version."""
    from protein_redesign_tpu_torch.ops import trimul as M

    if D % 8 == 0:
        monkeypatch.setattr(M, "trimul_takes_tensor_cores", lambda D: False)
    assert M.trimul_body(D) == "wide"
    pair = _randn(B, N, N, D, seed=7, device=device).to(dtype)
    mask = _pair_mask(B, N, device, masked_rows=3)
    ws = [*_linear(2 * D, D, device, 8), *_linear(2 * D, D, device, 10),
          *_linear(D, D, device, 12), *_linear(D, D, device, 14)]
    before = A.LAUNCHES["triangle_multiply"]
    got = M.trimul(pair, mask, *ws, mode)
    torch.cuda.synchronize()
    assert A.LAUNCHES["triangle_multiply"] == before + 1
    assert _rel(got, M.trimul_reference(pair, mask, *ws, mode)) <= FUSED_TOL[dtype]


@DTYPES
@pytest.mark.parametrize("B,N,S,D", [(1, 7, 16, 1), (2, 45, 64, 36), (1, 33, 40, 192),
                                     (1, 9, 24, 512), (1, 20, 512, 136)])
def test_outer_wide_widths_match_plain(device, dtype, B, N, S, D):
    """K11 at widths past its tensor-core body: outer.cu (a block per
    128-channel slice past 128), within FUSED_TOL of the plain version."""
    from protein_redesign_tpu_torch.ops import outer as O

    assert O.outer_fits(B, N, D, dtype) and not O.outer_takes_tensor_cores(S, D, dtype)
    x = _randn(B, N, S, seed=7, device=device).to(dtype)
    w, b = _linear(D, 2 * S, device, 8)
    got = O.outer(x, w, b)
    torch.cuda.synchronize()
    assert got.shape == (B, N, N, D) and got.dtype == dtype
    assert _rel(got, O.outer_reference(x, w, b)) <= FUSED_TOL[dtype]


# the wide tensor-core bodies of K3/K5 (f32) and K7 (both dtypes) ------------


def _kernel_names(fn, calls=3):
    """fn's last result and the CUDA kernels ``calls`` calls of it ran, by
    the profiler. A spin on the card runs to its end in the window before
    the calls, and the window stays open 0.1 s after them: the profiler has
    been seen to drop the first kernels of a window (a single call's
    kernels, all of them), and kernels near its end."""
    import time

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda._sleep(200_000_000)
        torch.cuda.synchronize()
        for _ in range(calls):
            got = fn()
        torch.cuda.synchronize()
        time.sleep(0.1)
    return got, [e.key for e in prof.key_averages() if "kernel" in e.key]


# the tensor-core kernel each wide body must run, and the CUDA-core one it
# replaces, which must not run (K6: each body's dk/dv kernel; the dq kernels
# are checked by name too)
WIDE_KERNELS = {
    ("rows_attention_kchunk_bwd", torch.float32): ("rows_attention_kchunk_bwd_dkdv_wide_tf32x3_kernel",
                                                   "rows_attention_kchunk_dkdv_kernel"),
    ("rows_attention_kchunk_bwd", torch.bfloat16): ("rows_attention_kchunk_bwd_dkdv_wide_mma_kernel",
                                                    "rows_attention_kchunk_dkdv_kernel"),
    ("rows_attention", torch.float32): WIDE_F32_ROWS["rows_attention"],
    ("rows_attention_fast", torch.float32): WIDE_F32_ROWS["rows_attention_fast"],
    ("rows_attention_kchunk", torch.float32): ("rows_attention_kchunk_wide_tf32x3_kernel",
                                               "rows_attention_kchunk_kernel"),
    ("rows_attention_kchunk_stats", torch.float32): ("rows_attention_kchunk_wide_tf32x3_kernel",
                                                     "rows_attention_kchunk_kernel"),
    ("rows_attention_bwd", torch.float32): ("rows_attention_bwd_dkdv_wide_tf32x3_kernel",
                                            "rows_attention_bwd_wide_dq_kernel"),
    ("rows_attention_bwd", torch.bfloat16): ("rows_attention_bwd_dkdv_wide_mma_kernel",
                                             "rows_attention_bwd_wide_dq_kernel"),
}


@pytest.mark.parametrize("name,dtype", list(WIDE_KERNELS), ids=["k6_f32", "k6_bf16", "k1_f32",
                                                                 "k1_fast_f32", "k3_f32", "k5_f32",
                                                                 "k7_f32", "k7_bf16"])
@pytest.mark.parametrize("N,C", [(45, 136), (100, 136), (192, 256), (45, 256), (33, 1024),
                                 (70, 1024)])
def test_wide_tensor_core_bodies_match_plain(device, name, dtype, N, C):
    """K1, K1 fast, K3 and K5 in f32 and K6 and K7 in both dtypes past C =
    128 on their wide tensor-core bodies, ragged N and a fully masked row
    included, against the plain versions (the narrow bodies' gates: K1, K3
    and K5 f32 1e-5, 1e-4 at C >= 512, m and log s 1e-5; K1 fast 2e-2; K6
    and K7 relative to the largest gradient, f32 1e-5, bf16 2e-2); the
    profiler shows the tensor-core kernel and not the CUDA-core one it
    replaces."""
    assert A.takes_tensor_cores(name, dtype, C)
    want_kernel, core_kernel = WIDE_KERNELS[(name, dtype)]
    q, k, v, mask, _ = _inputs(3, N, 2, C, dtype, device, seed=80 + C, masked_rows=1)
    scale = C ** -0.5
    before = A.LAUNCHES[name] + 2  # the profiled calls: two before the one checked
    if name in ("rows_attention_bwd", "rows_attention_kchunk_bwd"):
        g = torch.randn(q.shape, generator=torch.Generator().manual_seed(81)).to(device, dtype)
        if name == "rows_attention_bwd":
            fn = lambda: A.rows_attention_bwd(q, k, v, mask, g, scale)  # noqa: E731
            ref = A.rows_attention_bwd_reference(q, k, v, mask, g, scale)
        else:
            out, m, logs = A.rows_attention_kchunk_reference(q, k, v, mask, scale, stats=True)
            fn = lambda: A.rows_attention_kchunk_bwd(q, k, v, mask, g, out, m, logs,  # noqa: E731
                                                     scale)
            ref = A.rows_attention_kchunk_bwd_reference(q, k, v, mask, g, out, m, logs, scale)
        got, names = _kernel_names(fn)
        _assert_grads_close(got, ref, dtype)
        assert torch.count_nonzero(got[0][:1]) == 0 and torch.count_nonzero(got[1][:1]) == 0
        assert any(want_kernel.replace("dkdv", "dq") in n for n in names), names
        assert not any(core_kernel.replace("dkdv", "dq") in n for n in names), names
    elif name in WIDE_F32_ROWS:
        fast = name == "rows_attention_fast"
        fn = A.rows_attention_fast if fast else A.rows_attention
        got, names = _kernel_names(lambda: fn(q, k, v, mask, scale))
        ref = (A.rows_attention_fast_reference(q, k, v, mask, scale) if fast
               else A.attention_reference(q, k, v, mask, None, scale))
        tol = 2e-2 if fast else _tol(dtype, C)
        torch.testing.assert_close(got, ref, atol=tol, rtol=tol)
        mean_v = v[:1].mean(1, keepdim=True).expand_as(got[:1])
        torch.testing.assert_close(got[:1], mean_v, atol=tol, rtol=tol)
    else:
        stats = name == "rows_attention_kchunk_stats"
        fn = A.rows_attention_kchunk_stats if stats else A.rows_attention_kchunk
        got, names = _kernel_names(lambda: fn(q, k, v, mask, scale))
        ref = A.rows_attention_kchunk_reference(q, k, v, mask, scale, stats=stats)
        tol = _tol(dtype, C)
        for a, b, t in zip(got if stats else (got,), ref if stats else (ref,), (tol, 1e-5, 1e-5)):
            torch.testing.assert_close(a, b, atol=t, rtol=t)
    assert A.LAUNCHES[name] == before + 1
    assert any(want_kernel in n for n in names), names
    assert not any(core_kernel in n for n in names), names


@pytest.mark.parametrize("C,N", [(256, 640), (1024, 1900)])
def test_wide_k1_fast_recomputes_its_logits_past_shared_memory(device, C, N):
    """K1 fast's f32 wide body where the rounded logits of a block no longer
    fit shared memory (past N = 576 at C <= 512, 1856 above): its sum and
    P.V passes recompute them, against the plain version within 2e-2, the
    fully masked row at the mean of v; the profiler shows the kernel's
    recomputing instantiation (STORE false) and not the storing one."""
    assert A.fast_wide_tf32x3_smem_bytes(C, N, store=True) > A.MMA_SMEM_BYTES
    q, k, v, mask, _ = _inputs(2, N, 1, C, torch.float32, device, seed=94, masked_rows=1)
    got, names = _kernel_names(lambda: A.rows_attention_fast(q, k, v, mask, C ** -0.5))
    assert any("rows_attention_fast_wide_tf32x3_kernel<false" in n for n in names), names
    assert not any("rows_attention_fast_wide_tf32x3_kernel<true" in n for n in names), names
    ref = A.rows_attention_fast_reference(q, k, v, mask, C ** -0.5)
    torch.testing.assert_close(got, ref, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got[:1], v[:1].mean(1, keepdim=True).expand_as(got[:1]),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("C", [136, 1024])
def test_wide_f32_kchunk_stats_output_is_k3s(device, C):
    """K5's output on the wide body is K3's bit for bit, and both bodies
    (wide tensor-core and CUDA-core, ``mma=False``) stay callable."""
    q, k, v, mask, _ = _inputs(2, 50, 1, C, torch.float32, device, seed=90, masked_rows=1)
    out = A.rows_attention_kchunk(q, k, v, mask, 0.1)
    out_s, _, _ = A.rows_attention_kchunk_stats(q, k, v, mask, 0.1)
    torch.testing.assert_close(out_s, out, atol=0, rtol=0)
    core = A.attention_body("rows_attention_kchunk", q, k, v, mask, None, 0.1, mma=False)
    tol = _tol(torch.float32, C)
    torch.testing.assert_close(core, out, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wide_k7_body_strided_and_cuda_core_callable(device, dtype):
    """K7's wide body in the 'ending' layout (q, k, v and dO through
    strides) gives the bits it gives on contiguous copies; its CUDA-core body
    (``mma=False``) stays callable and agrees within the gate."""
    N, H, C = 40, 2, 256
    q, k, v, mask, _ = _inputs(N, N, H, C, dtype, device, seed=91, masked_rows=2)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(92)).to(device, dtype)
    qt, kt, vt, gt = (x.transpose(0, 1) for x in (q, k, v, g))
    assert not kt.is_contiguous()
    got = A.rows_attention_bwd(qt, kt, vt, mask, gt, 0.1)
    dense = A.rows_attention_bwd(*(x.contiguous() for x in (qt, kt, vt)), mask, gt.contiguous(),
                                 0.1)
    for a, b in zip(got, dense):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    core = A.attention_body("rows_attention_bwd", qt, kt, vt, mask, None, 0.1, mma=False, dout=gt)
    _assert_grads_close(got, core, dtype)


@pytest.mark.parametrize("entry,name,dtype,C", [
    ("prd_rows_attention_kchunk_wide_tf32x3", "rows_attention_kchunk", torch.float32, 256),
    ("prd_rows_attention_bwd_wide_tf32x3", "rows_attention_bwd", torch.float32, 256),
    ("prd_rows_attention_bwd_wide_mma", "rows_attention_bwd", torch.bfloat16, 1024),
    ("prd_rows_attention_wide_tf32x3", "rows_attention", torch.float32, 136),
    ("prd_rows_attention_fast_wide_tf32x3", "rows_attention_fast", torch.float32, 1024),
    ("prd_rows_attention_kchunk_bwd_wide_tf32x3", "rows_attention_kchunk_bwd", torch.float32, 256),
    ("prd_rows_attention_kchunk_bwd_wide_mma", "rows_attention_kchunk_bwd", torch.bfloat16, 512)])
def test_wide_bodies_raise_and_do_not_fall_back(device, monkeypatch, entry, name, dtype, C):
    """A failed launch of a wide tensor-core body raises: neither the
    CUDA-core body nor the plain version runs in its place, and no launch is
    counted."""
    from protein_redesign_tpu_torch.kernels import build

    lib = build()
    calls = []
    monkeypatch.setattr(lib.lib, entry, lambda *a: calls.append("tc") or 1)
    core = {"rows_attention_kchunk": "prd_rows_attention_kchunk"}.get(name, f"prd_{name}")
    monkeypatch.setattr(lib.lib, core, lambda *a: calls.append("core") or 0)
    q, k, v, mask, _ = _inputs(2, 20, 1, C, dtype, device, seed=93)
    stats = [torch.zeros(2, 1, 20, device=device) for _ in range(2)]
    calls_by_name = {
        "rows_attention_bwd": lambda: A.rows_attention_bwd(q, k, v, mask, q, 0.1),
        "rows_attention_kchunk": lambda: A.rows_attention_kchunk(q, k, v, mask, 0.1),
        "rows_attention": lambda: A.rows_attention(q, k, v, mask, 0.1),
        "rows_attention_fast": lambda: A.rows_attention_fast(q, k, v, mask, 0.1),
        "rows_attention_kchunk_bwd": lambda: A.rows_attention_kchunk_bwd(q, k, v, mask, q, q,
                                                                         *stats, 0.1)}
    before = A.LAUNCHES[name]
    with pytest.raises(RuntimeError, match=name):
        calls_by_name[name]()
    assert calls == ["tc"] and A.LAUNCHES[name] == before


@DTYPES
@pytest.mark.parametrize("N,D,H,C", [(20, 512, 4, 16), (24, 192, 4, 16), (17, 64, 1, 1024),
                                     (12, 64, 1024, 4), (20, 64, 2, 36), (16, 128, 8, 128),
                                     (20, 136, 4, 12), (33, 64, 1, 256)])
def test_fused_gated_new_edges_match_plain(device, dtype, N, D, H, C):
    """K8 at the JAX kernel's edges: D = 512 and 192 on the tensor-core body
    (out-projection slices past 128, the K-sliced projection), C = 1024, H C
    = 4096, C = 36, H C = 1024, D = 136 at C = 4 mod 8 and C = 256 on the
    split route, one launch each, fully masked rows included, within the
    fused gates of the plain version."""
    body = A.fused_gated_body(D, H, C)
    assert body == ("tensor cores" if D in (512, 192) else "split")
    pair = _randn(2, N, N, D, seed=17, device=device).to(dtype)
    mask = _pair_mask(2, N, device, masked_rows=3)
    ws = [_randn(H * C, D, seed=18 + i, scale=D ** -0.5, device=device) for i in range(4)]
    ws += [_randn(H * C, seed=22, scale=0.3, device=device), *_linear(D, H * C, device, 23)]
    before = dict(A.LAUNCHES)
    got = A.fused_gated(pair, mask, *ws, H)
    torch.cuda.synchronize()
    # one K8 launch; the split route's K-chunk forward counts as K8's
    assert A.LAUNCHES == {**before, "fused_gated_rows_attention":
                          before["fused_gated_rows_attention"] + 1}
    want = A.fused_gated_reference(pair, mask, *ws, H)
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert _rel(got, want) <= FUSED_TOL[dtype]
    assert _rel(got[0, :3], want[0, :3]) <= FUSED_TOL[dtype]


# K8 and K9 on ln_project.cuh's wide block past pair width 128, and K8's split
# route (projection and gate + out-projection) on the tensor cores ----------

# the tensor-core kernels each route must show on the profiler, and the
# CUDA-core ones they replaced, which must not run (substrings of the
# profiler's names)
K8_CORE_KERNELS = ("fused_gated_project_kernel", "fused_gated_out_kernel")
K9_CORE_KERNELS = ("trimul_project_wide_kernel", "trimul_out_wide_kernel")


def _gated_inputs(N, D, H, C, dtype, device, view, seed=30):
    pair = _randn(2, N, N, D, seed=seed, device=device).to(dtype)
    mask = _pair_mask(2, N, device, masked_rows=3)
    if view == "ending":  # the transposed view, read through strides
        pair, mask = pair.transpose(1, 2), mask.transpose(1, 2)
    ws = [_randn(H * C, D, seed=seed + 1 + i, scale=D ** -0.5, device=device) for i in range(4)]
    ws += [_randn(H * C, seed=seed + 5, scale=0.3, device=device), *_linear(D, H * C, device,
                                                                           seed + 6)]
    return pair, mask, ws


@DTYPES
@pytest.mark.parametrize("view", ["starting", "ending"])
@pytest.mark.parametrize("N,D,H,C,body", [
    (70, 136, 4, 16, "tensor cores"), (20, 192, 4, 16, "tensor cores"),
    (33, 256, 2, 32, "tensor cores"), (20, 512, 1, 128, "tensor cores"),
    (17, 140, 2, 16, "tensor cores"), (24, 64, 1, 256, "split"), (16, 128, 8, 128, "split"),
    (20, 64, 4, 36, "split"), (20, 136, 4, 12, "split"), (12, 36, 1, 36, "split"),
    (12, 260, 1, 36, "split"), (12, 512, 2, 132, "split")])
def test_fused_gated_wide_routes_match_plain(device, dtype, view, N, D, H, C, body):
    """K8 past pair width 128 (the wide block's projection; D = 140 not a
    multiple of 8) and on the split route (the tensor-core projection at
    every D, K3's bodies, the tensor-core gate + out-projection; D = 36 and
    260 pad W_o's columns to a multiple of 8, H C = 36 takes the
    projection's element-wise epilogue), both views, ragged N, fully masked
    rows: one K8 launch, within FUSED_TOL of the plain version."""
    assert A.fused_gated_body(D, H, C) == body
    pair, mask, ws = _gated_inputs(N, D, H, C, dtype, device, view)
    before = dict(A.LAUNCHES)
    got = A.fused_gated(pair, mask, *ws, H)
    torch.cuda.synchronize()
    assert A.LAUNCHES == {**before, "fused_gated_rows_attention":
                          before["fused_gated_rows_attention"] + 1}
    want = A.fused_gated_reference(pair, mask, *ws, H)
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert _rel(got, want) <= FUSED_TOL[dtype]
    if view == "starting":
        assert _rel(got[0, :3], want[0, :3]) <= FUSED_TOL[dtype]


@DTYPES
@pytest.mark.parametrize("mode", ["outgoing", "incoming"])
@pytest.mark.parametrize("B,N,D", [(1, 33, 136), (1, 70, 192), (2, 20, 256), (1, 9, 512),
                                   (1, 65, 512)])
def test_trimul_wide_tensor_cores_match_plain(device, dtype, mode, B, N, D):
    """K9 past pair width 128 on the tensor cores (the wide block's LN +
    projection stages around the contraction), ragged N, fully masked rows:
    one launch, within FUSED_TOL of the plain version."""
    from protein_redesign_tpu_torch.ops import trimul as M

    assert M.trimul_body(D) == "tensor cores"
    pair = _randn(B, N, N, D, seed=7, device=device).to(dtype)
    mask = _pair_mask(B, N, device, masked_rows=3)
    ws = [*_linear(2 * D, D, device, 8), *_linear(2 * D, D, device, 10),
          *_linear(D, D, device, 12), *_linear(D, D, device, 14)]
    before = A.LAUNCHES["triangle_multiply"]
    got = M.trimul(pair, mask, *ws, mode)
    torch.cuda.synchronize()
    assert A.LAUNCHES["triangle_multiply"] == before + 1
    assert _rel(got, M.trimul_reference(pair, mask, *ws, mode)) <= FUSED_TOL[dtype]


@DTYPES
@pytest.mark.parametrize("what,shape,kernels", [
    ("k8", (192, 4, 16), ("fused_gated_project_mma_wide_kernel",
                          "fused_gated_attention_")),
    ("k8", (64, 1, 256), ("fused_gated_project_mma_kernel", "fused_gated_out_mma_kernel")),
    ("k8", (512, 1, 128), ("fused_gated_project_mma_wide_kernel",)),
    ("k8", (512, 2, 132), ("fused_gated_project_mma_wide_kernel", "fused_gated_out_mma_kernel")),
    ("k9", (192,), ("trimul_project_mma_wide_kernel", "trimul_out_mma_wide_kernel"))],
    ids=["k8_d192", "k8_split_c256", "k8_d512", "k8_split_d512", "k9_d192"])
def test_wide_fused_routes_run_tensor_core_kernels(device, dtype, what, shape, kernels):
    """The profiler shows the tensor-core kernels of K8's wide block and
    split route and of K9's wide block, and none of the CUDA-core kernels
    they replaced."""
    from protein_redesign_tpu_torch.ops import trimul as M

    if what == "k8":
        D, H, C = shape
        pair, mask, ws = _gated_inputs(12, D, H, C, dtype, device, "starting")
        fn = lambda: A.fused_gated(pair, mask, *ws, H)  # noqa: E731
        core = K8_CORE_KERNELS
    else:
        D = shape[0]
        pair = _randn(1, 12, 12, D, seed=7, device=device).to(dtype)
        ws = [*_linear(2 * D, D, device, 8), *_linear(2 * D, D, device, 10),
              *_linear(D, D, device, 12), *_linear(D, D, device, 14)]
        fn = lambda: M.trimul(pair, _pair_mask(1, 12, device), *ws, "outgoing")  # noqa: E731
        core = K9_CORE_KERNELS
    _, names = _kernel_names(fn)
    for kernel in kernels:
        assert any(kernel in n for n in names), (kernel, names)
    assert not any(c in n for c in core for n in names), names


def test_wide_fused_routes_raise_and_do_not_fall_back(device, monkeypatch):
    """A failed launch of K8's split-route out-projection, of K8's wide
    projection or of K9's tensor-core body past 128 raises: no CUDA-core
    body and no plain version runs in its place, and no launch is
    counted."""
    from protein_redesign_tpu_torch.kernels import build
    from protein_redesign_tpu_torch.ops import trimul as M

    lib = build()
    calls = []
    monkeypatch.setattr(lib.lib, "prd_fused_gated_out_mma", lambda *a: calls.append("out") or 1)
    monkeypatch.setattr(lib.lib, "prd_fused_gated_mma", lambda *a: calls.append("mma") or 1)
    monkeypatch.setattr(lib.lib, "prd_fused_gated", lambda *a: calls.append("core") or 0)
    monkeypatch.setattr(lib.lib, "prd_trimul_mma", lambda *a: calls.append("k9 mma") or 1)
    monkeypatch.setattr(lib.lib, "prd_trimul_wide", lambda *a: calls.append("k9 wide") or 0)
    monkeypatch.setattr(A, "fused_gated_reference", lambda *a: calls.append("plain"))
    monkeypatch.setattr(M, "trimul_reference", lambda *a: calls.append("plain"))
    before = dict(A.LAUNCHES)
    for D, H, C, want in ((64, 1, 256, "out"), (192, 4, 16, "mma")):
        pair, mask, ws = _gated_inputs(8, D, H, C, torch.bfloat16, device, "starting")
        with pytest.raises(RuntimeError, match="fused_gated_rows_attention"):
            A.fused_gated(pair, mask, *ws, H)
        assert calls[-1] == want and "core" not in calls and "plain" not in calls
    pair = _randn(1, 8, 8, 192, seed=7, device=device).to(torch.bfloat16)
    ws = [*_linear(384, 192, device, 8), *_linear(384, 192, device, 10),
          *_linear(192, 192, device, 12), *_linear(192, 192, device, 14)]
    with pytest.raises(RuntimeError, match="triangle_multiply"):
        M.trimul(pair, _pair_mask(1, 8, device), *ws, "outgoing")
    assert calls == ["out", "mma", "k9 mma"] and A.LAUNCHES == before


# head widths C = 4 mod 8 on the tensor cores: K1, K1 fast, K3 and K5 ---------

NARROW_NAMES = ("rows_attention", "rows_attention_fast", "rows_attention_kchunk",
                "rows_attention_kchunk_stats")
# each name's tensor-core kernel by dtype, and the CUDA-core kernel it
# replaced at C = 4 mod 8 (none is a substring of another kernel's name)
NARROW_KERNELS = {
    "rows_attention": ("rows_attention_mma_kernel", "rows_attention_tf32x3_kernel",
                       "rows_attention_kernel"),
    "rows_attention_fast": ("rows_attention_fast_mma_kernel", "rows_attention_fast_tf32x3_kernel",
                            "rows_attention_fast_kernel"),
    "rows_attention_kchunk": ("rows_attention_kchunk_mma_kernel",
                              "rows_attention_kchunk_tf32x3_kernel",
                              "rows_attention_kchunk_kernel"),
    "rows_attention_kchunk_stats": ("rows_attention_kchunk_mma_kernel",
                                    "rows_attention_kchunk_tf32x3_kernel",
                                    "rows_attention_kchunk_kernel"),
}


def _narrow_case(name, q, k, v, mask, scale):
    """The wrapper call of ``name`` and its plain version (K1 fast's logits
    to |l| ~ 5 by the caller)."""
    plain = {"rows_attention": lambda: A.attention_reference(q, k, v, mask, None, scale),
             "rows_attention_fast": lambda: A.rows_attention_fast_reference(q, k, v, mask, scale),
             "rows_attention_kchunk": lambda: A.rows_attention_kchunk_reference(q, k, v, mask,
                                                                               scale),
             "rows_attention_kchunk_stats": lambda: A.rows_attention_kchunk_reference(
                 q, k, v, mask, scale, stats=True)}[name]
    return (lambda: getattr(A, name)(q, k, v, mask, scale)), plain


def _narrow_close(name, got, want, dtype, C):
    """The gates of the multiple-of-8 rows: bf16 2e-2 to scale, f32 1e-5
    (1e-4 from C = 512), K1 fast 2e-2 (its bf16 softmax); K5's m and log s
    1e-5."""
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all()
        if i:
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
        elif name == "rows_attention_fast":
            torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=2e-2)
        elif dtype == torch.bfloat16:
            _close_to_scale(a, b)
        else:
            torch.testing.assert_close(a, b, atol=_tol(dtype, C), rtol=_tol(dtype, C))


@DTYPES
@pytest.mark.parametrize("name", NARROW_NAMES)
@pytest.mark.parametrize("C", [4, 12, 36, 132, 260, 1020])
def test_narrow_heads_match_plain(device, dtype, name, C):
    """K1, K1 fast, K3 and K5 at C = 4 mod 8 on their tensor-core bodies
    (bf16: attention_mma.cu's NARROW instantiations, 8-byte staging; f32:
    attention_tf32.cu up to 128, the wide bodies past it, the last chunk
    zero-padded), N = 70 (not a multiple of any key tile) with a fully
    masked row at the mean of v, against the plain version within the
    multiple-of-8 rows' gates; K5's output K3's bit for bit; the profiler
    shows the tensor-core kernel (bf16: its NARROW instantiation) and not
    the CUDA-core one."""
    assert A.takes_tensor_cores(name, dtype, C)
    q, k, v, mask, _ = _inputs(3, 70, 2, C, dtype, device, seed=100 + C, masked_rows=1)
    if name == "rows_attention_fast":
        q = (5.0 * q.float()).to(dtype)  # |l| ~ 5
    scale = C ** -0.5
    fn, plain = _narrow_case(name, q, k, v, mask, scale)
    before = A.LAUNCHES[name]
    got, names = _kernel_names(fn)
    assert A.LAUNCHES[name] == before + 3
    want = plain()
    _narrow_close(name, got, want, dtype, C)
    out = got[0] if isinstance(got, tuple) else got
    torch.testing.assert_close(out[:1].float(), v[:1].float().mean(1, keepdim=True).expand_as(
        out[:1]), atol=2e-2, rtol=2e-2)
    if name == "rows_attention_kchunk_stats":
        torch.testing.assert_close(out, A.rows_attention_kchunk(q, k, v, mask, scale), atol=0,
                                   rtol=0)
    bf16_kernel, f32_kernel, core = NARROW_KERNELS[name]
    if dtype == torch.bfloat16:
        assert any(bf16_kernel in n and "true>" in n for n in names), names
    else:
        wide = {"rows_attention": "rows_attention_wide_tf32x3_kernel",
                "rows_attention_fast": "rows_attention_fast_wide_tf32x3_kernel"}.get(
                    name, "rows_attention_kchunk_wide_tf32x3_kernel")
        assert any((wide if C > 128 else f32_kernel) in n for n in names), names
    assert not any(core in n for n in names), names


@pytest.mark.parametrize("name", NARROW_NAMES)
def test_narrow_heads_off_16_bytes(device, name):
    """bf16, C = 36, H = 3: heads 72 bytes apart, so head 1 of every
    position and every head of the odd positions start on 8 bytes, not 16;
    in the 'ending' layout (q, k and v through strides) too. The wrapper
    passes them to the kernel in place (8-byte rows suffice), which gives
    the bits it gives on contiguous copies and agrees with the plain
    version; the fully masked rows give the mean of v."""
    N, H, C = 40, 3, 36
    q, k, v, mask, _ = _inputs(N, N, H, C, torch.bfloat16, device, seed=110, masked_rows=2)
    qt, kt, vt = (x.transpose(0, 1) for x in (q, k, v))
    assert not kt.is_contiguous() and kt.stride(2) * 2 % 16 == 8 and kt.stride(0) * 2 % 16 == 8
    assert all(A._aligned_rows(x) is x for x in (qt, kt, vt))
    fn, plain = _narrow_case(name, qt, kt, vt, mask, 0.2)
    got = fn()
    dense_fn, _ = _narrow_case(name, *(x.contiguous() for x in (qt, kt, vt)), mask, 0.2)
    dense = dense_fn()
    for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, dense))):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    _narrow_close(name, got, plain(), torch.bfloat16, C)
    out = got[0] if isinstance(got, tuple) else got
    mean_v = vt[:2].float().mean(1, keepdim=True).expand_as(out[:2])
    torch.testing.assert_close(out[:2].float(), mean_v, atol=2e-2, rtol=2e-2)


def _template_args(names, kernel):
    """The template arguments of ``kernel`` in the profiler's names."""
    import re

    found = [re.search(kernel + r"<([^>]*)>", n) for n in names]
    return [tuple(a.strip() for a in m.group(1).split(",")) for m in found if m]


@DTYPES
@pytest.mark.parametrize("name", NARROW_NAMES)
def test_multiple_of_8_keeps_its_kernel(device, dtype, name):
    """C = 40, the multiple of 8 that pads to C = 36's width (48 in bf16, 64
    in f32), runs the instantiation it ran before C = 4 mod 8 came to the
    tensor cores: in bf16 the NARROW flag false, at C = 36 true, the other
    template arguments alike; in f32 one instantiation for both widths."""
    bf16_kernel, f32_kernel, _ = NARROW_KERNELS[name]
    kernel = bf16_kernel if dtype == torch.bfloat16 else f32_kernel
    args = {}
    for C in (36, 40):
        q, k, v, mask, _ = _inputs(4, 64, 2, C, dtype, device, seed=120)
        fn, _ = _narrow_case(name, q, k, v, mask, 0.2)
        _, names = _kernel_names(fn)
        (args[C],) = set(_template_args(names, kernel))
    if dtype == torch.bfloat16:
        assert args[40][-1] == "false" and args[36][-1] == "true", args
        assert args[40][:-1] == args[36][:-1], args
    else:
        assert args[40] == args[36], args


@pytest.mark.parametrize("entry,name,dtype,C", [
    ("prd_rows_attention_mma", "rows_attention", torch.bfloat16, 36),
    ("prd_rows_attention_fast_mma", "rows_attention_fast", torch.bfloat16, 36),
    ("prd_rows_attention_kchunk_mma", "rows_attention_kchunk", torch.bfloat16, 36),
    ("prd_rows_attention_tf32x3", "rows_attention", torch.float32, 36),
    ("prd_rows_attention_fast_tf32x3", "rows_attention_fast", torch.float32, 36),
    ("prd_rows_attention_kchunk_tf32x3", "rows_attention_kchunk", torch.float32, 36),
    ("prd_rows_attention_kchunk_wide_tf32x3", "rows_attention_kchunk", torch.float32, 260)])
def test_narrow_heads_raise_and_do_not_fall_back(device, monkeypatch, entry, name, dtype, C):
    """A failed launch of a tensor-core body at C = 4 mod 8 raises: neither
    the CUDA-core body nor the plain version runs in its place, and no
    launch is counted."""
    from protein_redesign_tpu_torch.kernels import build

    lib = build()
    calls = []
    monkeypatch.setattr(lib.lib, entry, lambda *a: calls.append("tc") or 1)
    monkeypatch.setattr(lib.lib, f"prd_{name}", lambda *a: calls.append("core") or 0)
    plain = {"rows_attention": "attention_reference",
             "rows_attention_fast": "rows_attention_fast_reference"}.get(
                 name, "rows_attention_kchunk_reference")
    monkeypatch.setattr(A, plain, lambda *a, **kw: calls.append("plain"))
    q, k, v, mask, _ = _inputs(2, 20, 1, C, dtype, device, seed=93)
    before = A.LAUNCHES[name]
    with pytest.raises(RuntimeError, match=name):
        getattr(A, name)(q, k, v, mask, 0.1)
    assert calls == ["tc"] and A.LAUNCHES[name] == before


@DTYPES
def test_k8_split_route_at_c36_runs_k3s_tensor_cores(device, dtype):
    """K8's split route at (D, H, C) = (64, 4, 36) runs K3's tensor-core
    kernel over the scratch's heads (72 bytes apart in bf16), not K3's
    CUDA-core one, and matches its plain version; one K8 launch, no K3
    launch counted."""
    D, H, C = 64, 4, 36
    assert A.fused_gated_body(D, H, C) == "split"
    pair, mask, ws = _gated_inputs(20, D, H, C, dtype, device, "starting")
    before = dict(A.LAUNCHES)
    got, names = _kernel_names(lambda: A.fused_gated(pair, mask, *ws, H))
    bf16_kernel, f32_kernel, core = NARROW_KERNELS["rows_attention_kchunk"]
    assert any((bf16_kernel if dtype == torch.bfloat16 else f32_kernel) in n for n in names), names
    assert not any(core in n for n in names), names
    assert A.LAUNCHES == {**before, "fused_gated_rows_attention":
                          before["fused_gated_rows_attention"] + 3}
    assert _rel(got, A.fused_gated_reference(pair, mask, *ws, H)) <= FUSED_TOL[dtype]
