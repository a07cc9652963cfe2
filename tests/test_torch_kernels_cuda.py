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
is rounded before the dq and dk sums.
"""

import pytest

torch = pytest.importorskip("torch")

from protein_redesign_tpu_torch.ops import attention as A  # noqa: E402

pytestmark = pytest.mark.cuda


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
@pytest.mark.parametrize("C", [8, 16, 64])
def test_rows_kernel_matches_plain(device, dtype, N, C):
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
@pytest.mark.parametrize("C", [16, 512])
def test_tiled_kernel_matches_plain(device, dtype, with_mask, C):
    q, k, v, mask, bias = _inputs(2, 70, 4, C, dtype, device, seed=1)
    m = mask if with_mask else None
    out = A.tiled_attention(q, k, v, m, bias, 1.0 / C ** 0.5)
    torch.cuda.synchronize()
    ref = A.attention_reference(q, k, v, m, bias, 1.0 / C ** 0.5)
    tol = _tol(dtype, C)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_strided_operands(device):
    """The 'ending' triangle layout: k and v read through strides."""
    N, H, C = 40, 4, 16
    q, k, v, mask, _ = _inputs(N, N, H, C, torch.float32, device, seed=2)
    qt, kt, vt = (x.transpose(0, 1) for x in (q, k, v))  # swapped pair axes, no copy
    assert not kt.is_contiguous()
    out = A.rows_attention(qt, kt, vt, mask, 0.25)
    ref = A.attention_reference(qt.contiguous(), kt.contiguous(), vt.contiguous(), mask,
                                None, 0.25)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["rows_attention", "tiled_attention"])
def test_more_rows_than_a_grid_dimension_holds(device, name):
    """R above 65535 (the bound of grid.y and grid.z): rows share grid.x
    with the query tiles."""
    q, k, v, mask, bias = _inputs(70000, 20, 1, 4, torch.float32, device, seed=4)
    if name == "rows_attention":
        out, ref = A.rows_attention(q, k, v, mask, 0.5), A.attention_reference(
            q, k, v, mask, None, 0.5)
    else:
        out, ref = A.tiled_attention(q, k, v, mask, bias, 0.5), A.attention_reference(
            q, k, v, mask, bias, 0.5)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


def test_wrapper_rejects(device):
    q, k, v, mask, bias = _inputs(2, 16, 2, 8, torch.float32, device)
    with pytest.raises(ValueError):  # K7 keeps a row in registers: C <= 32
        wide_q = torch.zeros(2, 16, 1, 64, device=device)
        A.rows_attention_bwd(wide_q, wide_q, wide_q, mask, wide_q, 0.5)
    with pytest.raises(ValueError):
        A.rows_attention(q, k, v, mask.cpu(), 0.5)
    wide = torch.zeros(2, 16, 1, 516, device=device)
    with pytest.raises(ValueError):
        A.tiled_attention(wide, wide, wide, None, torch.zeros(2, 1, 16, 16, device=device), 1.0)
    with pytest.raises(TypeError):
        A.rows_attention(q.detach().half(), k.half(), v.half(), mask, 0.5)


def test_denoiser_kernel_route_matches_plain(device):
    from protein_redesign_tpu.config import ModelConfig
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
        assert A.LAUNCHES == {"rows_attention": 4, "tiled_attention": 3, "rows_attention_bwd": 0}
        with A.plain_route():
            plain = mod(single, pair, mask)
        assert A.LAUNCHES == {"rows_attention": 4, "tiled_attention": 3, "rows_attention_bwd": 0}
    for a, b in zip(kernel, plain):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def _assert_grads_close(got, want, dtype):
    tol = _tol(dtype, 16)
    for a, b in zip(got, want):
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), atol=tol * max(scale, 1.0), rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("N", [16, 45, 192])
@pytest.mark.parametrize("C", [8, 16, 32])
def test_rows_bwd_kernel_matches_plain(device, dtype, N, C):
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
            assert A.LAUNCHES == {"rows_attention": int(name == "rows_attention"),
                                  "tiled_attention": int(name == "tiled_attention"),
                                  "rows_attention_bwd": int(name == "rows_attention")}
        grads.append([t.grad for t in inputs[: 3 if b is None else 4]])
    _assert_grads_close(grads[0], grads[1], torch.float32)


def test_denoiser_grad_kernel_route_matches_plain(device):
    from protein_redesign_tpu.config import ModelConfig
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
            assert A.LAUNCHES == {"rows_attention": 0, "tiled_attention": 0,
                                  "rows_attention_bwd": 0}
        else:
            s, p = mod(single, pair, mask)
            (s.square().sum() + p.square().sum()).backward()
            # remat: each block's forward runs again in the backward
            assert A.LAUNCHES == {"rows_attention": 8, "tiled_attention": 5,
                                  "rows_attention_bwd": 4}
        grads.append(torch.cat([q.grad.flatten() for q in mod.parameters()]))
    # Relative norm of the whole gradient: the parameters' gradients span
    # five decades here, so an error carried from the large ones swamps a
    # per-tensor bound on the small ones (f32: sums in another order).
    kernel, plain = grads
    assert float((kernel - plain).norm() / plain.norm()) <= 1e-5
