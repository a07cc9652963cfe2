"""The fused triangle multiplication, the plain PyTorch version and the
dispatch to its hand-written Hopper kernel.

Port of ``protein_redesign_tpu/ops/pallas_trimul.py``: ``triangle_multiply``
replaces the Pallas kernel K9 (``fused_triangle_multiply`` :145 ->
``_trimul_kernel`` :76) with ``kernels/csrc/trimul_mma.cu`` (tensor cores:
mma.sync in bf16, 3xTF32 in f32, at pair widths that are multiples of 8 up
to 512, past 128 with the LN + projection stages of ``trimul_wide_mma.cu``;
``trimul.cu``, the CUDA-core body it replaced up to 128, and
``trimul_mma.cu``'s CUDA-core wide body past it stay callable through
``trimul_takes_tensor_cores`` to time them side by side; every other width
up to 512 takes the wide body, see ``trimul_body``); its backward
differentiates the plain version, as ``_tm_bwd`` (:288) differentiates
``_reference_impl``. The whole module op:

    x = LN(pair);  a, b = sigmoid(x Wg + bg) * (x Wp + bp) * mask_2d
    outgoing: p[i, j, d] = sum_k a[i, k, d] b[j, k, d]
    incoming: p[i, j, d] = sum_k a[k, i, d] b[k, j, d]
    out = sigmoid(x Wog + bog) * (LN(p) Wop + bop)

The computation takes the pair's dtype, as the kernel does: LN statistics
and the contraction in f32, a, b, the LN outputs and the weights rounded to
the dtype, f32 sums, f32 biases and gates, the output in the dtype. In
float32 that is f32 throughout, the Pallas kernel's function in interpret
mode and ``_reference_impl``'s (the TPU kernel rounds to bf16 even in an f32
model; the port does not). ``fast_accum`` does not apply, as in the JAX
package's fused path.

Weights keep the torch Linear layout (ab_gate, ab_proj [2D, D]; out_gate,
out_proj [D, D]). A CPU tensor runs the plain version; a CUDA tensor
launches the kernel or raises; inside ``ops.attention.plain_route()`` the
autograd entry point runs the plain version on any device.
"""

from __future__ import annotations

import torch

from .attention import (
    LAUNCHES,
    _DTYPE_CODES,
    _on_cpu,
    layer_norm_f32,
    plain_route_active,
    plain_vjp,
    stream_of,
)

MODES = ("outgoing", "incoming")
# trimul.cu (CUDA cores): 8 warps of D / 8 channels, D / 32 values per lane in
# the epilogue
MAX_CORE_PAIR_DIM = 128
# trimul_mma.cu: ln_project.cuh's blocks (the wide one past 128, whose A tile
# [64, D] is what grows with D: ``attention.ln_project_smem_bytes``), the
# contraction a block per (b, d, 64 x 64 tile); the wide body: a [D, 68] f32
# LN tile and a [128, 128] weight slice in shared memory (200 KB at 512)
MAX_PAIR_DIM = 512
MAX_N = 65535 * 16  # trimul.cu's grid.y: one block per 16 x 16 output tile
MAX_POSITIONS = 64 * (2**31 - 1)  # one projection block per 64 of the B N^2 positions


def trimul_fits(B: int, N: int, D: int, dtype: torch.dtype) -> bool:
    """Whether K9 takes a [B, N, N, D] pair in ``dtype``: D from 1 to
    MAX_PAIR_DIM, B up to 65535, N up to MAX_N and B N^2 up to
    MAX_POSITIONS."""
    return (0 < D <= MAX_PAIR_DIM and 0 < B <= 65535 and 0 < N <= MAX_N
            and B * N * N <= MAX_POSITIONS)


def trimul_takes_tensor_cores(D: int) -> bool:
    """Whether K9 runs its tensor-core body (trimul_mma.cu, either dtype) at
    pair width D: a multiple of 8 up to MAX_PAIR_DIM. Where this is patched
    to False those widths take the CUDA-core bodies (trimul.cu up to 128,
    the wide body past it), to time them."""
    return 0 < D <= MAX_PAIR_DIM and D % 8 == 0


def trimul_body(D: int) -> str:
    """K9's body at pair width D: "tensor cores" (trimul_mma.cu), "cuda
    cores" (trimul.cu: multiples of 8 up to 128 with
    ``trimul_takes_tensor_cores`` patched False) or "wide" (trimul_mma.cu's
    CUDA-core LN + projection kernels around its contraction: every other
    width up to 512)."""
    if trimul_takes_tensor_cores(D):
        return "tensor cores"
    return "cuda cores" if 0 < D <= MAX_CORE_PAIR_DIM and D % 8 == 0 else "wide"


def _interleaved(gate, proj):
    """[2D, ...] gate and projection rows as trimul_mma.cu's projection reads
    them: 8 gate rows, then the same 8 channels' projection rows, in turn."""
    return torch.stack([gate.reshape(-1, 8, *gate.shape[1:]),
                        proj.reshape(-1, 8, *proj.shape[1:])], 1).reshape(-1, *gate.shape[1:])


def trimul_reference(pair, mask_2d, wg, bg, wp, bp, wog, bog, wop, bop, mode: str):
    """Plain version of K9: pair [B, N, N, D], mask_2d [B, N, N]."""
    if mode not in MODES:
        raise ValueError(f"Invalid mode: {mode}")
    dt = pair.dtype
    D = pair.shape[-1]
    x = layer_norm_f32(pair).to(dt).float()

    def dense(w, b):
        return x @ w.to(dt).float().t() + b.float()

    ab = (torch.sigmoid(dense(wg, bg)) * dense(wp, bp) * mask_2d[..., None].float()).to(dt)
    a, b = ab[..., :D].float(), ab[..., D:].float()
    if mode == "outgoing":
        prod = torch.einsum("...ikd,...jkd->...ijd", a, b)
    else:
        prod = torch.einsum("...kid,...kjd->...ijd", a, b)
    normed = layer_norm_f32(prod).to(dt).float()
    core = normed @ wop.to(dt).float().t() + bop.float()
    return (torch.sigmoid(dense(wog, bog)) * core).to(dt)


def _launch(pair, mask_2d, wg, bg, wp, bp, wog, bog, wop, bop, mode: str) -> torch.Tensor:
    from ..kernels import build

    if mode not in MODES:
        raise ValueError(f"Invalid mode: {mode}")
    if not pair.is_cuda or pair.dtype not in _DTYPE_CODES:
        raise TypeError(f"the triangle kernel takes CUDA float32 or bfloat16, got {pair.dtype} "
                        f"on {pair.device}")
    if pair.dim() != 4 or pair.shape[1] != pair.shape[2]:
        raise ValueError(f"pair must be [B, N, N, D], got {tuple(pair.shape)}")
    B, N, _, D = pair.shape
    if mask_2d.shape != (B, N, N):
        raise ValueError(f"mask_2d must be [B, N, N] = {(B, N, N)}, got {tuple(mask_2d.shape)}")
    if not trimul_fits(B, N, D, pair.dtype):
        raise ValueError(f"the triangle kernel takes a pair width from 1 to {MAX_PAIR_DIM}, B "
                         f"from 1 to 65535 and N from 1 to {MAX_N}; got B={B}, N={N}, D={D}")
    shapes = {"ab_gate": (wg, bg, 2 * D), "ab_proj": (wp, bp, 2 * D), "out_gate": (wog, bog, D),
              "out_proj": (wop, bop, D)}
    for name, (w, b, out_dim) in shapes.items():
        if w.shape != (out_dim, D) or b.shape != (out_dim,):
            raise ValueError(f"{name} must be [{out_dim}, {D}] with a bias [{out_dim}], got "
                             f"{tuple(w.shape)} and {tuple(b.shape)}")
        if w.device != pair.device or b.device != pair.device:
            raise ValueError(f"{name} must be on {pair.device}")
    lib = build()
    dt = pair.dtype
    pair = pair.contiguous()
    mask = mask_2d.to(torch.float32).contiguous()
    wop_t = wop.to(dt).t().contiguous()  # [D, D]
    bop_f = bop.float().contiguous()
    gate = torch.empty((B, N, N, D), dtype=torch.float32, device=pair.device)  # the out gate
    out = torch.empty_like(pair)
    body = trimul_body(D)
    if body == "tensor cores":
        # [D, 5D]: gate and projection columns interleaved 8 by 8, then the out gate
        w_in = torch.cat([_interleaved(wg, wp), wog]).to(dt).t().contiguous()
        b_in = torch.cat([_interleaved(bg, bp), bog]).float().contiguous()
        # scratch: gated a and b channel-major in the pair's (x, y) order, rows
        # padded to a multiple of 8; the f32 product channel-major
        a_t = torch.empty((B, D, N, -(-N // 8) * 8), dtype=dt, device=pair.device)
        b_t = torch.empty_like(a_t)
        prod = torch.empty((B, D, N, N), dtype=torch.float32, device=pair.device)
        with torch.cuda.device(pair.device):
            code = lib.lib.prd_trimul_mma(
                pair.data_ptr(), mask.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
                wop_t.data_ptr(), bop_f.data_ptr(), a_t.data_ptr(), b_t.data_ptr(),
                gate.data_ptr(), prod.data_ptr(), out.data_ptr(), _DTYPE_CODES[dt],
                MODES.index(mode), B, N, D, stream_of(pair),
            )
    elif body == "wide":
        w_in = torch.cat([wg, wp, wog]).to(dt).t().contiguous()  # gates | projections | out gate
        b_in = torch.cat([bg, bp, bog]).float().contiguous()
        # scratch as the tensor-core body's
        a_t = torch.empty((B, D, N, -(-N // 8) * 8), dtype=dt, device=pair.device)
        b_t = torch.empty_like(a_t)
        prod = torch.empty((B, D, N, N), dtype=torch.float32, device=pair.device)
        with torch.cuda.device(pair.device):
            code = lib.lib.prd_trimul_wide(
                pair.data_ptr(), mask.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
                wop_t.data_ptr(), bop_f.data_ptr(), a_t.data_ptr(), b_t.data_ptr(),
                gate.data_ptr(), prod.data_ptr(), out.data_ptr(), _DTYPE_CODES[dt],
                MODES.index(mode), B, N, D, stream_of(pair),
            )
    else:
        w_in = torch.cat([wg, wp, wog]).to(dt).t().contiguous()  # gates | projections | out gate
        b_in = torch.cat([bg, bp, bog]).float().contiguous()
        # scratch: gated a and b channel-major [B, D, N, N] (k-major rows)
        a_t = torch.empty((B, D, N, N), dtype=dt, device=pair.device)
        b_t = torch.empty_like(a_t)
        with torch.cuda.device(pair.device):
            code = lib.lib.prd_trimul(
                pair.data_ptr(), mask.data_ptr(), w_in.data_ptr(), b_in.data_ptr(),
                wop_t.data_ptr(), bop_f.data_ptr(), a_t.data_ptr(), b_t.data_ptr(),
                gate.data_ptr(), out.data_ptr(), _DTYPE_CODES[dt], MODES.index(mode), B, N, D,
                stream_of(pair),
            )
    lib.check(code, "triangle_multiply")
    LAUNCHES["triangle_multiply"] += 1
    return out


def trimul(pair, mask_2d, wg, bg, wp, bp, wog, bog, wop, bop, mode: str) -> torch.Tensor:
    """K9: the plain version for a CPU tensor, the kernel for a CUDA one."""
    if _on_cpu(pair):
        return trimul_reference(pair, mask_2d, wg, bg, wp, bp, wog, bog, wop, bop, mode)
    return _launch(pair, mask_2d, wg, bg, wp, bp, wog, bog, wop, bop, mode)


class _TriangleMultiply(torch.autograd.Function):
    """K9 forward; backward by autograd of the plain version (``_tm_bwd``)."""

    @staticmethod
    def forward(ctx, pair, mask_2d, wg, bg, wp, bp, wog, bog, wop, bop, mode):
        ctx.save_for_backward(pair, mask_2d, wg, bg, wp, bp, wog, bog, wop, bop)
        ctx.mode = mode
        fn = trimul_reference if plain_route_active() else trimul
        return fn(pair, mask_2d, wg, bg, wp, bp, wog, bog, wop, bop, mode)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors  # once: remat's checkpoint unpacks each tensor once
        grads = plain_vjp(trimul_reference, saved, ctx.needs_input_grad, dout, ctx.mode)
        return (*grads, None)


def triangle_multiply(pair, mask_2d, wg, bg, wp, bp, wog, bog, wop, bop, mode: str):
    """The whole triangle multiplication as one kernel, differentiable."""
    return _TriangleMultiply.apply(pair, mask_2d, wg, bg, wp, bp, wog, bog, wop, bop, mode)
