# Copied from protein_redesign_tpu/utils/flops.py so the port imports nothing of the JAX
# package; compiled_flops (XLA's cost analysis) is replaced by counted_flops (torch's
# FLOP counter), and the H100's peaks are added, the bf16 one as mfu's default.
"""FLOP accounting and MFU (model FLOPs utilization) for the denoiser.

Two counts, cross-checked against each other in tests/test_torch_flops.py:

- ``counted_flops``: torch's own count of a callable's work
  (``torch.utils.flop_counter.FlopCounterMode``: every matmul, batched
  matmul and convolution aten op it dispatches).
- ``denoiser_forward_flops``: an analytic matmul-FLOP model of one
  denoiser forward (reference architecture: ``model.py:139-158`` dims,
  ``modules.py:290-343`` block structure), the denominator of MFU (and the
  documentation of where the FLOPs are).

MFU convention: analytic/total FLOPs divided by (time x card peak). The
peaks are one NVIDIA H100 SXM's (``PEAK_FLOPS``); ``mfu`` defaults to its
dense bf16 peak, and an f32 program passes ``PEAK_FLOPS["float32"]``.
"""

from __future__ import annotations

from typing import Callable

PEAK_FLOPS_V5E = 1.97e14  # bf16 peak, one v5e chip (the JAX package's card)

# Dense peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
# sheet; the card these were checked on reads "NVIDIA H100 80GB HBM3,
# 700.00 W"): bf16 on the tensor cores; f32 products at f32 accuracy the
# fastest way the card has, 3xTF32 on the tensor cores: three TF32 products
# (495 TFLOP/s) for one, 165 TFLOP/s. f32 FMAs outside the tensor cores
# give 67 TFLOP/s (F32_CUDA_CORE_FLOPS); HBM bandwidth 3.35 TB/s.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
F32_CUDA_CORE_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# The exponentials' rate: 16 a clock on each SM (the SFU).
EXP_PER_SM_CLOCK = 16


def counted_flops(fn: Callable[[], object]) -> float:
    """FLOPs of the aten ops ``fn()`` dispatches, as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them (matmuls,
    batched matmuls, convolutions, attention; elementwise work is not
    counted). The counter sees only aten ops: a kernel launched through
    ctypes is invisible to it. So count on the CPU, where every kernel of
    the port runs as its plain version: the count is then the function's
    work, whatever implements it on the card."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def mfu(flops: float, seconds: float,
        peak_flops: float = PEAK_FLOPS["bfloat16"]) -> float:
    """Fraction of chip peak achieved by `flops` of work in `seconds`.
    seconds <= 0 (an op benchmarked below the measurement floor) maps to
    inf rather than raising — probe harnesses print and move on."""
    if seconds <= 0:
        return float("inf")
    return flops / (seconds * peak_flops)


def denoiser_forward_flops(cfg, batch: int, n: int) -> float:
    """Analytic matmul FLOPs (2*M*N*K per dot) of ONE denoiser forward
    at padded complex size ``n`` — the O(N^2)/O(N^3) terms plus every
    projection with an N or N^2 leading extent. Elementwise/LayerNorm
    work is excluded (sub-percent at paper dims); so are the embedding
    and readout heads (vocab-sized, <2% at N>=128 — the cross-check test
    bounds the total error vs XLA's count).

    Matches the module structure in models/denoiser.py:
    OPM + SPAttention once, then per FoldingBlock the bias projection,
    single gated attention + transition, OuterLinear, two triangle
    multiplications, two triangle attentions, and the pair transition.
    """
    S = cfg.single_dim
    D = cfg.pair_dim
    H = cfg.num_heads
    C = cfg.head_dim
    tf = cfg.transition_factor
    HC = H * C
    N2 = float(n) ** 2
    N3 = float(n) ** 3

    # --- once per forward ---
    hid = S // 4  # OuterProductUpdate hidden (modules.py:372-374)
    opm = 2 * (2 * n * S * hid) + 2 * N2 * hid * D
    # SPAttention: per-head width is the FULL single_dim (parity quirk,
    # AF2_modules.py:369-473): q/k/v/gate project S -> H*S.
    spa = (
        2 * N2 * D * H            # pair-bias projection
        + 4 * (2 * n * S * H * S)  # q, k, v, gate
        + 2 * (2 * H * S * N2)     # logits + AV
        + 2 * n * H * S * S        # out projection
    )

    # --- per block ---
    single_attn = (
        4 * (2 * n * S * HC)       # q, k, v, gate
        + 2 * (2 * H * C * N2)     # logits + AV
        + 2 * n * HC * S           # out projection
    )
    single_fc = 2 * (2 * n * S * S * tf)
    outer_linear = 2 * N2 * (2 * S) * D
    trimul = 12 * N2 * D * D + 2 * D * N3
    tri_attn = (
        4 * (2 * N2 * D * HC)      # q, k, v, gate over every row
        + 2 * (2 * H * C * N3)     # logits + AV, N rows
        + 2 * N2 * HC * D          # out projection
    )
    pair_fc = 2 * (2 * N2 * D * D * tf)
    block = (
        2 * N2 * D * H             # attn_bias projection
        + single_attn + single_fc + outer_linear
        + 2 * trimul + 2 * tri_attn + pair_fc
    )
    return float(batch) * (opm + spa + cfg.num_blocks * block)
