"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: CUDA is required; prints the card's name and power limit.
2. Build: nvcc builds the attention kernels from the sources in the
   checkout (protein_redesign_tpu_torch/kernels/csrc) into
   protein_redesign_tpu_torch/kernels/_build; prints the build time and
   ptxas's registers and spills of K8's, K9's and K10's tensor-core kernels
   (fused_gated_mma.cu, trimul_mma.cu, transition_mma.cu) and of K1 fast's
   f32 body (attention_tf32.cu), then K8's, K9's and K10's (pair_fc and
   single_fc) device time by CUDA kernel at the fused configuration's shape
   (torch.profiler, first in the process).
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   card at the main path's shapes (buckets 192 and 512), with the warm time
   of both from CUDA events; K1 and K2 run their tensor-core bodies (bf16
   attention_mma.cu; f32 3xTF32, K1 attention_tf32.cu, K2
   attention_tiled_tf32.cu), each timed beside its CUDA-core body (CUDA
   events and device time), K2 at C = 16 and at SPAttention's C = 512, K1's
   fully masked rows at the mean of v, with SDPA in the same dtype and the
   bound for every case.
4. Whole forward: ProteinReDiffNet at paper width (ModelConfig(), bf16)
   with seeded, perturbed weights, B=2 at bucket 192, kernel route against
   plain route, and exactly 24 rows-kernel and 13 tiled-kernel launches per
   forward; the kernel route's device time by kernel group (torch.profiler).
5. Main path: the port's generate CLI with those weights, a 110-residue
   sequence and imatinib (147 nodes, bucket 192), 2 samples in one batch,
   64 DDPM steps: three output files, finite coordinates, and 64 x 24 and
   64 x 13 kernel launches.
6. K7 vs plain: the rows-attention backward kernel against its plain
   version at buckets 192 and 384 (147 and 360 nodes valid, so padded rows
   are fully masked), f32 (3xTF32 tensor-core body, attention_bwd_tf32.cu)
   and bf16 (tensor-core body, attention_bwd_mma.cu), H=4 x C=16 and H=1 x
   C=64 (the h64x1 layout), with both times; in both dtypes the CUDA-core
   body timed beside the tensor-core one, SDPA's forward + backward in the
   same dtype and the bound at both buckets and widths.
7. Whole-net gradient: the training loss's parameter gradients at paper
   width, B=2, bucket 192, kernel route against plain route, in f32 and
   bf16, and in f32 at bucket 512, B=1 (a seeded 460-residue sequence and
   imatinib), with exactly 48 K1, 25 K2 and 24 K7 launches per micro-step
   (remat: 24 + 24 K1, 13 + 12 K2); the kernel route's device time per
   micro-step by kernel group (torch.profiler): f32 at 192 and 512, each
   with K1 and K2 on their 3xTF32 bodies and again on their CUDA-core ones,
   bf16 at 192 and 384.
8. Training main path: the port's train CLI at paper width on a mini
   dataset written from --seed (two T4 lysozyme 1-110 + imatinib complexes
   at bucket 192, two ~330-residue synthetic complexes at bucket 384, one
   validation complex), batch 2 x 2 accumulated micro-batches: 2 optimizer
   steps at 192, then a resume from the written checkpoint for 2 steps at
   384; finite losses, metrics.jsonl, checkpoint files and exact launch
   counts; seconds per optimizer step and peak device memory per bucket.
   Then the h64x1 layout (--head_dim 64 --num_heads 1, the JAX package's
   recommended training layout): the whole gradient of a micro-step, kernel
   route (K1 and K7 at C = 64) against plain route, at bucket 192 in f32 and
   bf16 and at 384 in bf16, and the train CLI at 192 for 2 optimizer steps.
9. K-chunk kernels vs plain: K3, K5 and K6 at bucket 2048 in bf16 (R =
   2048) and at 1024 in f32 (R = 1024), each against its plain version on
   the same inputs (the plain versions take rows in blocks, so their memory
   stays bounded), with the kernel's time, its bound and the library call's
   time; all three run their tensor-core bodies (bf16: attention_mma.cu,
   K6 attention_bwd_mma.cu; f32: 3xTF32, attention_tf32.cu, K6
   attention_bwd_tf32.cu), each timed beside its CUDA-core body; in bf16
   K3's and K5's outputs and K6's gradients are held to TOL_BF16 of each
   element plus TOL_BF16 of the tensor's RMS (at N = 2048 they are ~0.03, so
   an absolute TOL_BF16 would pass a K6 that left out delta), in f32 to
   TOL_F32 of max(1, max |x|); K6 with exact zeros in dq and dk on the fully
   masked rows.
10. Generation at 2048: the generate CLI at bucket 2048, bf16, B=1, a seeded
   2000-residue sequence and imatinib, 3 DDPM steps: s/step, peak memory,
   finite outputs, exactly 24 K3, 13 K2 and no K1 launch per forward.
11. Forward at 1024: the f32 net at bucket 1024, B=1, kernel route against
   plain route (24 K3 and 13 K2 per forward), with the kernel route's device
   time by kernel group.
12. Gradient and training at 1024 and 2048: one f32 micro-step's whole
   parameter gradient at 1024, kernel route against plain route (48 K5, 24
   K6, 25 K2, no K1 or K7), its device time by kernel group; one bf16
   micro-step at 2048, B=1, paper widths with num_blocks cut to 2 for the
   time limit (8 K5 and 4 K6 on their tensor-core bodies, 5 K2), kernel route
   against plain route; then the train CLI at bucket 1024, --dtype float32,
   batch 1, 2 optimizer steps: s per optimizer step, peak memory and exact
   launch counts; the same at bucket 512 (K1, K7 and K2 in f32, below the
   switch).
13. Fused kernels vs plain: K8 (fused gated triangle attention, starting and
   ending view), K9 (triangle multiplication, both modes), K10 (transition,
   single_fc and pair_fc) and K11 (OuterLinear) against their plain versions
   at bucket 192, B=2 (147 nodes valid), in f32 and bf16 (and bf16 at pair
   width 128), with the kernel's, the plain version's and the unfused module
   route's time and the kernel's bound; K8 and K9 on the device on their
   tensor-core bodies (fused_gated_mma.cu, trimul_mma.cu: mma.sync in bf16,
   3xTF32 in f32) and on the CUDA-core bodies they replaced, in the same run;
   K10 likewise (transition_mma.cu, with its layout named, against
   transition.cu) at pair_fc and single_fc, at pair width 128 in both dtypes
   and at single_fc 768 in both dtypes; K8 at the h64x1 and h64x4 head
   layouts (bf16, against its plain version and the unfused GatedAttention).
14. The fused configuration (the four switches use_pallas_{trimul,transition,
   outer,fused_gated} on): the paper-width bf16 forward at bucket 192, B=2,
   kernel route against plain route, exactly 24 K8, 24 K9, 24 K10, 12 K11,
   13 K2 and no K1 per forward, and its device time by kernel group; the
   forward at bucket 512, B=1 (K9's N^3); the f32 whole gradient at 192,
   kernel vs plain route (48 K8, 48 K9, 48 K10, 24 K11, 25 K2, no K1 or K7
   per micro-step); the generate CLI with the four flags at bucket 192, B=2,
   64 DDPM steps; the train CLI with the four flags at bucket 192, 2
   optimizer steps.
15. Serving (K1 fast, the bf16-softmax triangle attention of a checkpoint
   trained with --no-use_pallas_bwd and served with --fast_softmax, where
   the attention plan takes Pallas: inference from bucket 384): K1 fast
   against its plain version at buckets 384 (R = 768) and 192 (R = 384),
   its tensor-core bodies in bf16 (attention_mma.cu) and f32 (3xTF32,
   attention_tf32.cu), each timed beside its CUDA-core body, with the share
   of outputs that differ, its time, the plain version's, K1's, SDPA's and
   its bound; the train CLI with
   --no-use_pallas_bwd --fast_softmax on phase 8's data at bucket 192, 2
   optimizer steps (the training plan takes XLA: bf16-logit attention, no
   attention kernel); the serve CLI on that checkpoint with --sampler ddim
   --ddim_steps 50 over a 1000-step schedule, --batch_size 2
   --warmup_buckets 192,384, over a JSONL file of four requests (lysozyme
   1-110 + imatinib with 2 samples, the same with a 5-frame trajectory, a
   seeded 330-residue sequence + imatinib at bucket 384, one over
   --max_nodes that must come back as an error line): no attention kernel
   in the batches at 192 (bf16-logit attention), 24 x 50 K1 fast and 13 x
   50 K2 launches per batch at 384, the output files and s per DDIM step;
   one request to the serve CLI in TCP mode (--port 0) in a process of its
   own; the paper-width fast forward at 192 and 384 against its plain
   route, by kernel group.
16. Wide configurations: three configurations past the kernels' former
   bounds (the four switches at AlphaFold2's pair_dim 128 in bf16: K8, K9
   and K11 at D = 128; f32 with single_dim 768: K2's wide 3xTF32 body at C =
   768; bf16 single_dim 768 with use_pallas_transition: K10 at D = 768), 2
   blocks, the forward at bucket 192, B=2: exact launch counts of every
   kernel, against the plain route, and both routes' forward time.
17. K1 fast in f32, where a user runs it: the paper-width f32 net with
   fast_softmax on and use_pallas_bwd off, its forward at bucket 384, B=2,
   against the plain route (exactly 24 K1 fast, 13 K2, no K1; by kernel
   group), then one request served from its checkpoint through the serve
   CLI (--fast_softmax --sampler ddim, 5 DDIM steps, bucket 384): s per
   step and exact launches; the phase's wall time.

Each main path (phases 5, 8, 10, 12's train CLIs, 14's generate and train
CLIs, 15's train and serve CLIs and 17's serve CLI) runs with every launch
count set to 0 just before it and read just after; the f32 train CLI at 512
gives the launches of K1's and K2's f32 entries in the kernels' record, the
f32 served request K1 fast's. Every kernel's time and
the library call's come from CUDA events; the bound is the larger of the
operations this run's data needs (a query against its row's unmasked keys)
over the card's peak for the dtype (f32: 3xTF32 on the tensor cores) and
the bytes moved once over 3.35 TB/s; beside it the exponentials' floor,
one per logit at 16 per SM and clock.
The last three lines of standard output are the kernels' JSON record, the
card's name and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

# f32 with TF32 off: 1e-5, 1e-4 at head width 512 (a 512-term f32 dot per
# logit); bf16: 2e-2 (probabilities are rounded to bf16 before P.V).
TOL_F32, TOL_F32_WIDE, TOL_BF16 = 1e-5, 1e-4, 2e-2
FORWARD_REL_TOL = 2e-2  # ||kernel - plain|| / ||plain|| of the bf16 network outputs
# The same in f32 at bucket 1024: sums in another order through 12 blocks of
# the seeded, perturbed net (as GRAD_REL_TOL's f32 gate below).
FORWARD_REL_TOL_F32 = 5e-4
SEQUENCE = (  # the first 110 residues of T4 lysozyme
    "MNIFEMLRIDEGLRLKIYKDTEGYYTIGIGHLLTKSPSLNAAKSELDKAIGRNTNGVITKDEAEKLFNQDVDAAVRGI"
    "LRNAKLKPVYDSLDAVRRAAINMVFQMGETGV"
)
LIGAND = "Cc1ccc(NC(=O)c2ccc(CN3CCN(C)CC3)cc2)cc1Nc1nccc(-c2cccnc2)n1"  # imatinib
STEPS = 64
CSRC = "protein_redesign_tpu_torch/kernels/csrc/"
# K1, K1 fast, K2, K3 and K7 run their tensor-core bodies on the (bf16) main
# path; K5's and K6's record is the f32 training path at 1024, on their
# 3xTF32 bodies
SOURCES = {"rows_attention": CSRC + "attention_mma.cu",
           "rows_attention_fast": CSRC + "attention_mma.cu",
           "tiled_attention": CSRC + "attention_mma.cu",
           "rows_attention_bwd": CSRC + "attention_bwd_mma.cu",
           "rows_attention_kchunk": CSRC + "attention_mma.cu",
           "rows_attention_kchunk_stats": CSRC + "attention_tf32.cu",
           "rows_attention_kchunk_bwd": CSRC + "attention_bwd_tf32.cu",
           "fused_gated_rows_attention": CSRC + "fused_gated_mma.cu",
           "triangle_multiply": CSRC + "trimul_mma.cu",
           "fused_transition": CSRC + "transition_mma.cu",
           "fused_outer_linear": CSRC + "outer.cu"}
# K1, K2 and K1 fast in f32 run their 3xTF32 bodies: the JSON record's own
# entries, (kernel, source), K1's and K2's with the launches of the f32
# train CLI at bucket 512, K1 fast's with those of the f32 served request
F32_BODIES = {"rows_attention_f32": ("rows_attention", CSRC + "attention_tf32.cu"),
              "tiled_attention_f32": ("tiled_attention", CSRC + "attention_tiled_tf32.cu"),
              "rows_attention_fast_f32": ("rows_attention_fast", CSRC + "attention_tf32.cu")}
REPLACES = {
    "rows_attention": "protein_redesign_tpu/ops/pallas_attention.py:725",
    "rows_attention_fast": "protein_redesign_tpu/ops/pallas_attention.py:725",
    "tiled_attention": "protein_redesign_tpu/ops/pallas_attention.py:1315",
    "rows_attention_bwd": "protein_redesign_tpu/ops/pallas_attention.py:834",
    "rows_attention_kchunk": "protein_redesign_tpu/ops/pallas_attention.py:320",
    "rows_attention_kchunk_stats": "protein_redesign_tpu/ops/pallas_attention.py:426",
    "rows_attention_kchunk_bwd": "protein_redesign_tpu/ops/pallas_attention.py:583",
    "fused_gated_rows_attention": "protein_redesign_tpu/ops/pallas_attention.py:1164",
    "triangle_multiply": "protein_redesign_tpu/ops/pallas_trimul.py:145",
    "fused_transition": "protein_redesign_tpu/ops/pallas_transition.py:71",
    "fused_outer_linear": "protein_redesign_tpu/ops/pallas_outer.py:72",
}
# The fused-kernel configuration: the JAX CLIs' four switches, all on.
FUSED = ("use_pallas_trimul", "use_pallas_transition", "use_pallas_outer", "use_pallas_fused_gated")
FUSED_NAMES = ("fused_gated_rows_attention", "triangle_multiply", "fused_transition",
               "fused_outer_linear")
FUSED_BUCKET_LARGE = (512, 460)  # one forward at bucket 512: 460 residues + imatinib
# Dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet): bf16 on the
# tensor cores; f32 products at f32 accuracy the fastest way the card has,
# 3xTF32 on the tensor cores: three TF32 products (495 TFLOP/s) for one,
# 165 TFLOP/s (f32 FMAs outside them give 67); HBM bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12
# The exponentials' floor: 16 a clock on each SM (the SFU), at the card's
# maximum SM clock.
EXP_PER_SM_CLOCK = 16
# The long-context paths: (bucket, residues of a seeded sequence); with
# imatinib's 37 atoms 2037 and 997 nodes, so the padded rows are fully masked.
LONG_GENERATE, LONG_TRAIN, IMATINIB_ATOMS = (2048, 2000), (1024, 960), 37
LONG_STEPS = 3  # DDPM steps of the generate run at bucket 2048
# Relative norm of the whole parameter gradient, kernel route vs plain route:
# f32 (TF32 off): sums in another order through 12 blocks of a net whose
# seeded, perturbed weights amplify rounding (the plain route alone differs
# by ~1e-4 between the card and the CPU on these weights); bf16: K7 rounds
# dS to bf16 before the dq and dk sums, as the Pallas kernel does, while the
# plain route's autograd keeps dS in f32.
GRAD_REL_TOL = {"float32": 5e-4, "bfloat16": 5e-2}
# The serving path: DDIM steps over a schedule of SERVE_SCHEDULE steps, and
# the residues of the request over --max_nodes (with imatinib 237 nodes).
# The serve CLI warms buckets 192 and 384; its requests are lysozyme (147
# nodes), a seeded SERVE_LONG-residue sequence (367 nodes, bucket 384) and one
# over --max_nodes (384, the largest warmed bucket; 397 nodes).
SERVE_STEPS, SERVE_SCHEDULE, SERVE_LONG, SERVE_OVERSIZED = 50, 1000, 330, 360
# The JAX package's recommended training layout, one head of width 64
# (`protein_redesign_tpu/models/denoiser.py:513-519`): K1 and K7 at C = 64.
H64 = dict(head_dim=64, num_heads=1)
# The bf16 micro-step at bucket 2048 (phase 12): paper widths, depth cut to
# two FoldingBlocks for the time limit.
GRAD_2048_BLOCKS = 2
# f32 training below the K-chunk switch at bucket 512 (phases 7 and 12):
# (bucket, residues of a seeded sequence), 497 nodes with imatinib.
TRAIN_F32_512 = (512, 460)


def launch_record(**counts) -> dict:
    """A whole launch record: the given counts and 0 for every other kernel."""
    return {**{name: 0 for name in REPLACES}, **counts}


def forward_launches(cfg, remat: bool = False, kchunk: bool = False, n: int = 192) -> dict:
    """Launches of one forward at bucket ``n`` (``remat``: of one
    micro-step, whose backward recomputes every block's forward). K2 for the
    single attentions and SPAttention. With the four fused switches: K8 for
    both triangle attentions, K9 for both triangle multiplications, K10 for
    single_fc and pair_fc, K11 for outer_linear. Without them the triangle
    attentions take K1 and, in a micro-step, K7 per K1 of the forward; with
    use_pallas_bwd off they take K1 fast where fast_softmax is on and the
    attention plan takes Pallas, and no K7; in the K-chunk regime
    (``kchunk``) K3 without a gradient, else K5 and one K6 per attention.
    Where the plan leaves Pallas with fast_softmax on in a bf16 model, every
    attention computes the bf16-logit attention: no attention kernel runs."""
    from protein_redesign_tpu_torch.models.denoiser import resolve_attention_plan

    k, blocks = (2 if remat else 1), cfg.num_blocks
    use_pallas, _ = resolve_attention_plan(cfg, n)
    if cfg.fast_softmax and not use_pallas and cfg.dtype == "bfloat16":
        counts = {}
        if cfg.use_pallas_fused_gated:  # K9-K11 stay; K8 gives way to the bf16 logits
            counts.update({name: 2 * k * blocks for name in FUSED_NAMES[1:3]},
                          fused_outer_linear=k * blocks)
        return launch_record(**counts)
    counts = {"tiled_attention": k * blocks + 1}
    if cfg.use_pallas_fused_gated:
        counts.update({name: 2 * k * blocks for name in FUSED_NAMES[:3]},
                      fused_outer_linear=k * blocks)
    elif kchunk:
        counts["rows_attention_kchunk_stats" if remat else "rows_attention_kchunk"] = 2 * k * blocks
        if remat:
            counts["rows_attention_kchunk_bwd"] = 2 * blocks
    else:
        fast = cfg.fast_softmax and use_pallas and not cfg.use_pallas_bwd
        counts["rows_attention_fast" if fast else "rows_attention"] = 2 * k * blocks
        if remat and cfg.use_pallas_bwd:
            counts["rows_attention_bwd"] = 2 * blocks
    return launch_record(**counts)


def main_path_launches() -> dict:
    """The launch counts of the main path just run."""
    from protein_redesign_tpu_torch.ops import attention as A

    return dict(A.LAUNCHES)


def cuda_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 3) -> float:
    """ms of device time per call of ``fn``: CUDA events around ``iters``
    calls queued behind a spin on the card (``torch.cuda._sleep``, ~0.05 s),
    so that the events time the kernels back to back and not the host's
    launch path, which bounds a small kernel's CUDA-event time. (A short
    torch.profiler window loses kernels once the process has run a while:
    K1 at 192 read 0.079, 0.052, 0.026 ms, then nothing, through phase 7.)"""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def body_times(name, q, k, v, mask, bias, scale, **backward) -> str:
    """The two bodies of K1, K1 fast, K2, K3, K5, K7 (``dout`` given) or K6
    (``dout``, ``out``, ``m`` and ``logs`` given) on the same inputs (bf16
    or f32), each one launch without autograd: CUDA-event ms per call and
    device ms per call."""
    from protein_redesign_tpu_torch.ops import attention as A

    # the K-chunk CUDA-core bodies: up to ~0.45 s a call (K6 in bf16 at 2048 ~1.2 s)
    iters = 2 if name in A.KCHUNK_FORWARDS + ("rows_attention_kchunk_bwd",) else 10
    parts = []
    for mma, label in ((True, "tensor-core"), (False, "CUDA-core")):
        fn = lambda: A.attention_body(name, q, k, v, mask, bias, scale, mma=mma,  # noqa: E731
                                      **backward)
        parts.append(f"{label} body {cuda_ms(fn, 1, iters):.4f} ms, on the device "
                     f"{device_ms(fn, min(iters, 3)):.4f} ms")
    return "; ".join(parts)


def bound(flops: float, nbytes: float, dtype) -> dict:
    """The least time the card could take: operations over the dtype's peak
    or bytes over the HBM rate, whichever is larger."""
    ops_s, bytes_s = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


@functools.lru_cache(maxsize=None)
def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout
    return 1e6 * float(out.strip().splitlines()[0])


def exp_floor_ms(q, mask) -> float:
    """The exponentials' floor of an attention function on q's shape: one
    exp per (query, unmasked key, head) logit at EXP_PER_SM_CLOCK a clock on
    every SM, at the maximum SM clock."""
    R, N, H, C = q.shape
    pairs = N * float(mask.sum()) if mask is not None else float(R * N * N)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return pairs * H / (EXP_PER_SM_CLOCK * sms * max_sm_clock_hz()) * 1e3


def attention_bound(q, mask, bias, products: int, operands: int, extra_bytes: float = 0.0):
    """Bound of an attention function on q's shape: ``products`` matrix
    products of 2 operations per (query, key) pair and channel, over the
    pairs this data needs (each query against its row's unmasked keys, all
    keys without a mask), and ``operands`` [R, N, H, C] tensors plus the
    mask, the bias and ``extra_bytes`` moved once."""
    R, N, H, C = q.shape
    pairs = N * float(mask.sum()) if mask is not None else float(R * N * N)
    nbytes = operands * q.numel() * q.element_size() + extra_bytes
    nbytes += 0 if mask is None else mask.numel() * 4
    nbytes += 0 if bias is None else bias.numel() * bias.element_size()
    return bound(products * 2 * H * C * pairs, nbytes, q.dtype)


def library_ms(q, k, v, mask, bias, scale, dout=None):
    """ms of one torch.nn.functional.scaled_dot_product_attention call on the
    same inputs (the memory-efficient backend, or the cuDNN one where it
    refuses the inputs; the key mask as an additive -2^15 term), forward and
    backward when ``dout`` is given: the library yardstick, which the port
    never calls. None where both refuse the inputs."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    add = None
    if mask is not None:
        add = torch.where(mask < 0.5, -(2.0**15), 0.0).to(q.dtype)[:, None, None, :]
    if bias is not None:
        add = bias if add is None else bias + add
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(dout is not None) for t in (q, k, v))

    def call():
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add, scale=scale)
        if dout is not None:
            torch.autograd.grad(out, (qt, kt, vt), dout.transpose(1, 2))

    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel(backend):
                ms = cuda_ms(call, 1, 3)
        except RuntimeError as e:
            print(f"[library] scaled_dot_product_attention ({backend.name}) refused "
                  f"{tuple(q.shape)} {q.dtype}: {str(e).splitlines()[0][:160]}")
            continue
        if backend != SDPBackend.EFFICIENT_ATTENTION:
            print(f"[library] {tuple(q.shape)} {q.dtype}: timed the {backend.name} backend")
        return ms
    return None


def phase_device() -> tuple:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; a CUDA card is required")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; max SM clock "
          f"{max_sm_clock_hz() / 1e6:.0f} MHz")
    return name, smi


def phase_build() -> None:
    from protein_redesign_tpu_torch import kernels

    lib = kernels.build()
    if lib.build_seconds is None:
        print(f"[build] reused {lib.path.name} (sources unchanged)")
    else:
        print(f"[build] nvcc built {lib.path.name} in {lib.build_seconds:.1f} s")
    spills = [line.strip() for line in lib.build_log.splitlines()
              if "spill" in line and not line.strip().startswith("0 bytes stack")]
    if spills:
        print(f"[build] ptxas reports spills in {len(spills)} instantiations")
    for source in ("fused_gated_mma.cu", "trimul_mma.cu", "transition_mma.cu", "attention_tf32.cu"):
        for name, regs, stores, loads in ptxas_report(lib.build_log, source):
            if source == "attention_tf32.cu" and "fast" not in name:
                continue
            print(f"[build] ptxas {source} {name}: {regs} registers, {stores} bytes spill stores, "
                  f"{loads} bytes spill loads")


def ptxas_report(log: str, source: str) -> list:
    """(kernel, registers, spill store bytes, spill load bytes) of every entry
    function ptxas compiled from ``source``, names demangled by c++filt where
    the machine has it."""
    section = log.split(f"== {source}\n", 1)[-1].split("\n== ", 1)[0] if source in log else ""
    rows, name, spill = [], None, ("?", "?")
    for line in section.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name = found.group(1)
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if found:
            spill = found.groups()
        found = re.search(r"Used (\d+) registers", line)
        if found and name:
            rows.append([name, int(found.group(1)), *spill])
            name, spill = None, ("?", "?")
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, check=True).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                r[0] = re.sub(r"\(anonymous namespace\)::|\(.*\)$", "", n)
    except (OSError, subprocess.CalledProcessError):
        pass
    return [tuple(r) for r in rows]


def _attention_case(R, N, H, C, dtype, n_valid, with_mask, with_bias, rows_mask, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    q, k, v = (torch.randn(R, N, H, C, generator=g, device=dev).to(dtype) for _ in range(3))
    node = (torch.arange(N, device=dev) < n_valid).float()
    if rows_mask:  # triangle rows: row (b, i) masks keys by mask[b, i] * mask[b, :]
        mask = (node[:, None] * node[None, :]).repeat(R // N, 1)
    else:
        mask = node.expand(R, N).contiguous()
    bias = torch.randn(R, H, N, N, generator=g, device=dev).to(dtype) if with_bias else None
    return q, k, v, (mask if with_mask else None), bias


def phase_fused_breakdown() -> None:
    """K8, K9 and K10 by CUDA kernel at the fused configuration's shape
    (bucket 192, B=2, paper width: K8 h16x4 at D = 64, K9 outgoing, K10
    pair_fc and single_fc), bf16 and f32, seeded random weights: device time
    per kernel from torch.profiler, run first in the process (a profiler
    window later in a long run loses kernels)."""
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.ops import transition as T
    from protein_redesign_tpu_torch.ops import trimul as M

    N, D, H, C = 192, 64, 4, 16
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator("cuda").manual_seed(350)
        pair = torch.randn(2, N, N, D, generator=g, device="cuda").to(dtype)
        mask = (torch.rand(2, N, N, generator=g, device="cuda") > 0.2).float()
        gw = [torch.randn(H * C, D, generator=g, device="cuda") * D ** -0.5 for _ in range(4)]
        gw += [torch.randn(H * C, generator=g, device="cuda"),
               torch.randn(D, H * C, generator=g, device="cuda") * 0.1,
               torch.randn(D, generator=g, device="cuda")]
        tw = []
        for out_dim in (2 * D, 2 * D, D, D):
            tw += [torch.randn(out_dim, D, generator=g, device="cuda") * D ** -0.5,
                   torch.randn(out_dim, generator=g, device="cuda")]
        single = torch.randn(2, N, 512, generator=g, device="cuda").to(dtype)
        mlps = {}
        for view, dim in (("pair_fc", D), ("single_fc", 512)):
            mlps[view] = (torch.randn(4 * dim, dim, generator=g, device="cuda") * dim ** -0.5,
                          torch.randn(4 * dim, generator=g, device="cuda"),
                          torch.randn(dim, 4 * dim, generator=g, device="cuda") * (4 * dim) ** -0.5,
                          torch.randn(dim, generator=g, device="cuda"))
        label = str(dtype).replace("torch.", "")
        with torch.inference_mode():
            for name, fn in (("fused_gated_rows_attention", lambda: A.fused_gated(pair, mask, *gw, H)),
                             ("triangle_multiply", lambda: M.trimul(pair, mask, *tw, "outgoing")),
                             ("fused_transition pair_fc",
                              lambda: T.transition(pair, *mlps["pair_fc"])),
                             ("fused_transition single_fc",
                              lambda: T.transition(single, *mlps["single_fc"]))):
                parts = device_time_by_kernel(fn)
                print(f"[fused-breakdown] {name} {label}, device time by kernel: "
                      + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                  sorted(parts.items(), key=lambda kv: -kv[1])))


def phase_kernels() -> dict:
    """K1 and K2 against their plain version at buckets 192 and 512, in f32
    and bf16 (K2 at C = 16, the single attention, and C = 512, SPAttention).
    Both dtypes run the tensor-core bodies (bf16 attention_mma.cu; f32
    3xTF32, K1 attention_tf32.cu, K2 attention_tiled_tf32.cu); their
    CUDA-core bodies are timed on the same inputs, with SDPA in the same
    dtype and the bound. The record holds the bf16 main path's shape (bucket
    192, K2 at C = 16) and, for the f32 entries, the f32 training path's
    (bucket 512, K2 at C = 16)."""
    from protein_redesign_tpu_torch.ops import attention as A

    cases = []
    for bucket, n_valid in ((192, 147), (512, 401)):
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(("rows_attention", bucket, dtype, 2 * bucket, 16, True, False, n_valid))
            cases.append(("tiled_attention", bucket, dtype, 2, 16, True, True, n_valid))
            cases.append(("tiled_attention", bucket, dtype, 2, 512, False, True, n_valid))
    record = {name: {"max_abs_err": 0.0} for name in (*REPLACES, *F32_BODIES)}
    for seed, (name, N, dtype, R, C, with_mask, with_bias, n_valid) in enumerate(cases):
        q, k, v, mask, bias = _attention_case(R, N, 4, C, dtype, n_valid, with_mask, with_bias,
                                              name == "rows_attention", seed)
        scale = 1.0 / math.sqrt(C)
        if name == "rows_attention":
            kernel = lambda: A.rows_attention(q, k, v, mask, scale)  # noqa: E731
        else:
            kernel = lambda: A.tiled_attention(q, k, v, mask, bias, scale)  # noqa: E731
        plain = lambda: A.attention_reference(q, k, v, mask, bias, scale)  # noqa: E731
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        tol = TOL_BF16 if dtype == torch.bfloat16 else (TOL_F32_WIDE if C >= 512 else TOL_F32)
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        excess = float((diff - tol * ref.float().abs()).max())
        if not (torch.isfinite(out).all() and excess <= tol):
            raise AssertionError(f"{name} R={R} N={N} C={C} {dtype}: max abs err {err} > tol {tol}")
        if name == "rows_attention":  # the padded rows are fully masked: the mean of v
            mean_v = v[N - 1::N].float().mean(1, keepdim=True).expand(-1, N, -1, -1)
            masked_err = float((out[N - 1::N].float() - mean_v).abs().max())
            if not masked_err <= tol * (1 + float(mean_v.abs().max())):
                raise AssertionError(f"{name} N={N} {dtype}: fully masked rows off the mean of v "
                                     f"by {masked_err}")
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        label = str(dtype).replace("torch.", "")
        print(f"[kernels] {name} R={R} H=4 N={N} C={C} {label} mask={with_mask} "
              f"bias={with_bias}: max_abs_err {err:.3e} (tol {tol:g}); kernel {ms:.4f} ms "
              f"(tensor cores; {body_times(name, q, k, v, mask, bias, scale)}), plain "
              f"{plain_ms:.4f} ms")
        at = attention_bound(q, mask, bias, products=2, operands=4)
        lib_ms = library_ms(q, k, v, mask, bias, scale)
        print(f"[kernels] {name} C={C} at bucket {N}, {label}: bound {at['bound_ms']:.4f} ms "
              f"({at['bound_by']}), library ({label}) {lib_ms} ms")
        f32 = dtype == torch.float32
        rec = record[f"{name}_f32" if f32 else name]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        # the JSON record carries the main path's own shape: bf16 at bucket
        # 192, f32 at 512, and for tiled_attention the single-attention call
        if C == 16 and N == (512 if f32 else 192):
            rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **at)
    return record


def perturb(module, seed: int):
    """``module`` with seeded noise on every parameter (the 'final' and
    'gating' layers start at zero and would hide a wrong kernel)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            std = 0.5 / math.sqrt(p.shape[-1]) if p.dim() == 2 else 0.1
            p.add_(torch.randn(p.shape, generator=g) * std)
    return module


def perturbed_net(cfg, seed: int = 0):
    """ProteinReDiffNet's seeded init plus seeded noise on every parameter."""
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet

    torch.manual_seed(seed)
    return perturb(ProteinReDiffNet(cfg), seed + 1)


def complex_batch(runner, batch_rows: int = 2, sequence: str = SEQUENCE):
    from protein_redesign_tpu_torch.cli.common import complex_data, load_protein_arg, parse_ligand_arg

    protein, ligand = load_protein_arg(sequence), parse_ligand_arg(LIGAND)
    esm = np.zeros((len(protein.aatype), runner.net.cfg.esm_dim), np.float32)
    return runner.collate([complex_data(protein, ligand, esm)] * batch_rows)


def phase_forward(net, tag: str = "forward", bucket: int = 192,
                  tol: float = FORWARD_REL_TOL) -> None:
    """The net's forward at ``bucket`` (192: lysozyme and imatinib; 384: a
    seeded SERVE_LONG-residue sequence and imatinib), B=2, kernel route
    against plain route within ``tol``, its exact launches and device time
    by group."""
    from protein_redesign_tpu_torch.cli.common import SamplingRunner
    from protein_redesign_tpu_torch.models.prdiff import prepare_batch
    from protein_redesign_tpu_torch.ops import attention as A

    runner = SamplingRunner(net, "cuda")
    sequence = SEQUENCE if bucket == 192 else long_sequence(51, SERVE_LONG)
    landed, batch = complex_batch(runner, sequence=sequence)
    if landed != bucket:
        raise AssertionError(f"the smoke complex landed in bucket {landed}, not {bucket}")
    batch = prepare_batch(batch, 0.3, generator=torch.Generator("cuda").manual_seed(0))
    B, N = batch["residue_mask"].shape
    g = torch.Generator("cuda").manual_seed(1)
    z = torch.randn(B, N, 3, generator=g, device="cuda")
    seq_t = torch.randn(B, N, 21, generator=g, device="cuda")
    mask = batch["residue_and_atom_mask"]
    t = torch.tensor([5, 40], device="cuda")

    def forward(plain: bool):
        if not plain:
            return net(batch, z, seq_t, mask, t)
        with A.plain_route():
            return net(batch, z, seq_t, mask, t)

    with torch.inference_mode():
        A.reset_launch_counts()
        noise_k, seq_k = forward(False)
        torch.cuda.synchronize()
        launches = main_path_launches()
        noise_p, seq_p = forward(True)
        torch.cuda.synchronize()
        expected = forward_launches(net.cfg, n=bucket)
        if launches != expected:
            raise AssertionError(f"launches per forward {launches} != {expected}")
        for name, a, b in (("noise_pred", noise_k, noise_p), ("seq_pred", seq_k, seq_p)):
            if a.shape != b.shape or not torch.isfinite(a).all():
                raise AssertionError(f"{name}: shape {tuple(a.shape)} or non-finite values")
            rel = float((a - b).norm() / b.norm())
            print(f"[{tag}] {name} {tuple(a.shape)}: ||kernel - plain|| / ||plain|| = "
                  f"{rel:.3e} (tol {tol:g})")
            if not rel <= tol:
                raise AssertionError(f"{name}: relative error {rel} > {tol}")
        kernel_ms, plain_ms = cuda_ms(lambda: forward(False), 2, 5), cuda_ms(lambda: forward(True), 2, 5)
        busy = device_time_by_group(lambda: forward(False))
    print(f"[{tag}] paper width, {net.cfg.dtype}, B={B}, bucket {bucket}: kernel route "
          f"{kernel_ms:.2f} ms, "
          f"plain route {plain_ms:.2f} ms per forward; launches per forward "
          f"{ {k: v for k, v in launches.items() if v} }")
    total = sum(busy.values())
    print(f"[{tag}] kernel route, device time per forward from torch.profiler: {total:.2f} ms busy "
          f"({1 - total / kernel_ms:.1%} of the CUDA-event time idle); "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(busy.items(), key=lambda kv: -kv[1])))


# Device-time groups, matched on the CUDA kernel's name, in order.
GROUPS = (("fused_gated", "K8 fused_gated"), ("trimul", "K9 trimul"),
          ("transition_mma", "K10 transition (tensor cores)"),
          ("transition_kernel", "K10 transition"), ("outer_kernel", "K11 outer"),
          ("rows_attention_kchunk_bwd_d", "K6 rows_attention_kchunk_bwd (tensor cores)"),
          ("rows_attention_kchunk_mma_kernel<true", "K5 rows_attention_kchunk_stats (mma)"),
          ("rows_attention_kchunk_mma", "K3 rows_attention_kchunk (tensor cores)"),
          ("rows_attention_kchunk_tf32x3_kernel<true", "K5 rows_attention_kchunk_stats (3xTF32)"),
          ("rows_attention_kchunk_tf32x3", "K3 rows_attention_kchunk (3xTF32)"),
          ("rows_attention_tf32x3", "K1 rows_attention (3xTF32)"),
          ("tiled_attention_wide_tf32x3", "K2 tiled_attention wide (3xTF32)"),
          ("tiled_attention_tf32x3", "K2 tiled_attention (3xTF32)"),
          ("rows_attention_mma", "K1 rows_attention (tensor cores)"),
          ("rows_attention_kchunk_d", "K6 rows_attention_kchunk_bwd"),
          ("rows_attention_kchunk", "K3/K5 rows_attention_kchunk"),
          ("rows_attention_bwd_dq_mma", "K7 rows_attention_bwd (tensor cores)"),
          ("rows_attention_bwd_dkdv_mma", "K7 rows_attention_bwd (tensor cores)"),
          ("rows_attention_bwd_dq_tf32x3", "K7 rows_attention_bwd (3xTF32)"),
          ("rows_attention_bwd_dkdv_tf32x3", "K7 rows_attention_bwd (3xTF32)"),
          ("rows_attention_bwd", "K7 rows_attention_bwd"),
          ("rows_attention_fast_mma", "K1 fast rows_attention_fast (tensor cores)"),
          ("rows_attention_fast_tf32x3", "K1 fast rows_attention_fast (3xTF32)"),
          ("rows_attention_fast", "K1 fast rows_attention_fast"),
          ("rows_attention", "K1 rows_attention"),
          ("tiled_attention_mma", "K2 tiled_attention (tensor cores)"),
          ("tiled_attention", "K2 tiled_attention"),
          ("layer_norm", "layer_norm"), ("gemm", "gemm/bmm"), ("nvjet", "gemm/bmm"),
          ("xmma", "gemm/bmm"), ("softmax", "softmax"), ("copy", "copy/cast"))


def device_time_by_group(fn, iters: int = 5) -> dict:
    """ms per call of ``fn`` on the card, by kernel group (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    groups: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = us if us is not None else e.self_cuda_time_total
        group = next((g for key, g in GROUPS if key in e.key), "elementwise/other")
        groups[group] = groups.get(group, 0.0) + us / iters / 1e3
    if not groups:
        raise AssertionError("torch.profiler recorded no device time")
    return groups


def device_time_by_kernel(fn, iters: int = 5) -> dict:
    """ms per call of ``fn`` on the card, by CUDA kernel (torch.profiler),
    names cut to the function and its template arguments."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels: dict = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = us if us is not None else e.self_cuda_time_total
        name = re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", e.key)[:60]
        kernels[name] = kernels.get(name, 0.0) + us / iters / 1e3
    return kernels


def phase_generate(net, flags=(), tag: str = "generate") -> dict:
    from protein_redesign_tpu_torch.cli.generate import main
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.utils.weights import save_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_checkpoint(tmp / "ckpt", net.state_dict(), net.cfg)
        argv = ["-c", str(tmp / "ckpt"), "-o", str(tmp / "out"), "-p", SEQUENCE, "-l", LIGAND,
                "-n", "2", "--batch_size", "2", "--num_steps", str(STEPS), "--device", "cuda",
                *flags]
        A.reset_launch_counts()
        began = time.perf_counter()
        timings = main(argv)
        wall = time.perf_counter() - began
        launches = main_path_launches()
        out = tmp / "out"
        pdb = (out / "sample_protein.pdb").read_text()
        sdf = (out / "sample_ligand.sdf").read_text()
        scores = (out / "sample_tmscores.txt").read_text().split()
    coords = [[float(line[30:38]), float(line[38:46]), float(line[46:54])]
              for line in pdb.splitlines() if line.startswith("ATOM")]
    if len(coords) != 2 * len(SEQUENCE) or not all(math.isfinite(c) for xyz in coords for c in xyz):
        raise AssertionError(f"sample_protein.pdb: {len(coords)} CA records or non-finite coordinates")
    if sdf.count("$$$$") != 2 or len(scores) != 2:
        raise AssertionError("sample_ligand.sdf or sample_tmscores.txt incomplete")
    forwards = STEPS * len(timings)
    cfg = net.cfg.replace(**{f.lstrip("-"): True for f in flags})
    expected = {k: forwards * v for k, v in forward_launches(cfg).items()}
    if launches != expected:
        raise AssertionError(f"generate launches {launches} != {expected}")
    for bucket, rows, steps, seconds in timings:
        print(f"[{tag}] bucket {bucket}, {rows} samples per batch: {steps} DDPM steps in "
              f"{seconds:.3f} s = {seconds / steps:.4f} s/step")
    print(f"[{tag}] main() wall {wall:.2f} s; TM-scores {scores}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def phase_k7() -> dict:
    """K7 against its plain version on the main path's shapes (B=2, H=4,
    C=16) and on the h64x1 layout's (H=1, C=64), at buckets 192 and 384: f32
    on the 3xTF32 body, bf16 on the bf16 tensor-core body, each timed beside
    its CUDA-core body, SDPA (forward + backward, same dtype) and the bound."""
    from protein_redesign_tpu_torch.ops import attention as A

    rec = {"max_abs_err": 0.0}
    shapes = [(N, n_valid, H, C) for H, C in ((4, 16), (1, 64))
              for N, n_valid in ((192, 147), (384, 360))]
    for seed, (N, n_valid, H, C) in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask, _ = _attention_case(2 * N, N, H, C, dtype, n_valid, True, False,
                                               True, 100 + seed)
            g = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(seed),
                            device="cuda").to(dtype)
            scale = 1.0 / math.sqrt(C)
            kernel = lambda: A.rows_attention_bwd(q, k, v, mask, g, scale)  # noqa: E731
            plain = lambda: A.rows_attention_bwd_reference(q, k, v, mask, g, scale)  # noqa: E731
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            # tolerances relative to the gradient's scale: dv_j sums P_ij dO_i
            # over all N queries, unnormalized
            tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
            errs = []
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                scale_b = max(float(b.float().abs().max()), 1.0)
                diff = (a.float() - b.float()).abs()
                errs.append(float(diff.max()))
                if not (torch.isfinite(a).all() and float(diff.max()) <= tol * scale_b):
                    raise AssertionError(f"K7 {name} N={N} {dtype}: max abs err "
                                         f"{float(diff.max())} > {tol} x {scale_b}")
            pad = slice(n_valid, N)  # rows (b=0, i >= n_valid): all keys masked
            if torch.count_nonzero(got[0][pad]) or torch.count_nonzero(got[1][pad]):
                raise AssertionError("K7: fully masked rows have nonzero dq or dk")
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            label = str(dtype).replace("torch.", "")
            print(f"[k7] rows_attention_bwd R={2 * N} H={H} N={N} C={C} {label} ({n_valid} valid): "
                  f"max abs err dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol {tol:g} "
                  f"x max(1, max|grad|)); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            rec["max_abs_err"] = max(rec["max_abs_err"], *errs)
            at = attention_bound(q, mask, None, products=5, operands=7)
            lib_ms = library_ms(q, k, v, mask, None, scale, dout=g)
            if dtype == torch.bfloat16 and C == 16 and N == 192:  # the record's shape
                rec.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **at)
            bodies = body_times("rows_attention_bwd", q, k, v, mask, None, scale, dout=g)
            print(f"[k7] H={H} C={C} at bucket {N}, {label} ({bodies}): bound "
                  f"{at['bound_ms']:.4f} ms ({at['bound_by']}), exp floor "
                  f"{exp_floor_ms(q, mask):.4f} ms, library (forward + backward, {label}) "
                  f"{lib_ms} ms")
    return rec


def synthetic_complex(sequence: str, seed: int, esm_dim: int) -> dict:
    """A featurized complex of ``sequence`` and imatinib with coordinates
    made from ``seed``: a CA trace at 3.8 A steps and a ligand laid out along
    its bond graph at 1.5 A steps from the trace's centre (the framework-free
    chem layer has no conformer generator)."""
    from collections import deque

    from protein_redesign_tpu_torch.chem.mol import update_mol_positions
    from protein_redesign_tpu_torch.cli.common import complex_data, load_protein_arg, parse_ligand_arg

    rng = np.random.RandomState(seed)
    protein = load_protein_arg(sequence)
    steps = rng.randn(len(sequence), 3)
    protein.atom_pos[:, 1] = np.cumsum(3.8 * steps / np.linalg.norm(steps, axis=1, keepdims=True),
                                       axis=0)
    ligand = parse_ligand_arg(LIGAND)
    pos = np.zeros((ligand.num_atoms(), 3))
    pos[0] = protein.atom_pos[:, 1].mean(0)
    placed, queue = {0}, deque([0])
    while queue:
        i = queue.popleft()
        for j in ligand.neighbors(i):
            if j not in placed:
                d = rng.randn(3)
                pos[j] = pos[i] + 1.5 * d / np.linalg.norm(d)
                placed.add(j)
                queue.append(j)
    ligand = update_mol_positions(ligand, pos.astype(np.float32))
    return complex_data(protein, ligand, np.zeros((len(sequence), esm_dim), np.float32))


def long_sequence(seed: int, n: int = 330) -> str:
    rng = np.random.RandomState(seed)
    return "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n))


def collated(datas, bucket: int) -> dict:
    from protein_redesign_tpu_torch.data.collate import collate_fn, numeric_batch

    batch = {}
    for k, v in numeric_batch(collate_fn(datas, buckets=(bucket,))).items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        batch[k] = (t.float() if t.is_floating_point() else t).to("cuda")
    return batch


def fixed_noise(batch: dict, seed: int):
    """Draws for one loss: the random masking policy with half of the
    residues scored out, fixed timesteps, seeded normals."""
    from protein_redesign_tpu_torch.models.prdiff import TrainNoise

    B, N = batch["residue_mask"].shape
    g = torch.Generator().manual_seed(seed)
    return TrainNoise(rt=torch.tensor(0.1), p=torch.tensor(0.5), rand_u=torch.tensor(0.6),
                      rand_scores=torch.rand(B * N, generator=g), spatial_u=torch.tensor(0.5),
                      t=torch.tensor([7, 40])[:B], noise_z=torch.randn(B, N, 3, generator=g),
                      noise_seq=torch.randn(B, N, 21, generator=g))


def micro_step(net, batch: dict, noise):
    """One micro-step of training: the loss and its backward."""
    from protein_redesign_tpu_torch.models.prdiff import loss

    net.zero_grad(set_to_none=True)
    value, _ = loss(net, batch, noise=noise)
    value.backward()
    return value.detach()


@contextlib.contextmanager
def cuda_core_bodies(*names):
    """Inside the block, kernels ``names`` in f32 take their CUDA-core bodies
    (attention.cu), the route before their 3xTF32 bodies came, so that a
    path can be timed on both in one run. Launch counts are the same."""
    from protein_redesign_tpu_torch.ops import attention as A

    takes = A.takes_tf32x3
    A.takes_tf32x3 = lambda name, dtype, C: name not in names and takes(name, dtype, C)
    try:
        yield
    finally:
        A.takes_tf32x3 = takes


def time_micro_step(tag: str, step, bodies=("tensor-core",)) -> None:
    """One micro-step's time on the kernel route and the plain route, and the
    kernel route's device time by kernel group; with "CUDA-core" in
    ``bodies`` also with K1 and K2 in f32 on their CUDA-core bodies."""
    from protein_redesign_tpu_torch.ops import attention as A

    with A.plain_route():
        plain_ms = cuda_ms(step, 1, 2)
    for body in bodies:
        ctx = (cuda_core_bodies("rows_attention", "tiled_attention") if body == "CUDA-core"
               else contextlib.nullcontext())
        with ctx:
            kernel_ms = cuda_ms(step, 1, 3)
            busy = device_time_by_group(step, iters=3)
        total = sum(busy.values())
        print(f"[grad] {tag} (loss + backward, remat), {body} bodies: kernel route "
              f"{kernel_ms:.2f} ms, plain route {plain_ms:.2f} ms; kernel route device time "
              f"{total:.2f} ms busy ({1 - total / kernel_ms:.1%} idle); "
              + ", ".join(f"{k} {v:.2f}" for k, v in sorted(busy.items(), key=lambda kv: -kv[1])))


def grad_check(net, batch: dict, noise, tag: str) -> None:
    """The whole parameter gradient of one micro-step, kernel route against
    plain route, and its exact launches."""
    from protein_redesign_tpu_torch.ops import attention as A

    A.reset_launch_counts()
    loss_k = micro_step(net, batch, noise)
    torch.cuda.synchronize()
    launches = main_path_launches()
    grads_k = torch.cat([p.grad.flatten().float() for p in net.parameters()])
    with A.plain_route():
        loss_p = micro_step(net, batch, noise)
    grads_p = torch.cat([p.grad.flatten().float() for p in net.parameters()])
    B, N = batch["residue_mask"].shape
    expected = forward_launches(net.cfg, remat=True, n=N)
    if launches != expected:
        raise AssertionError(f"{tag}: launches per micro-step {launches} != {expected}")
    rel = float((grads_k - grads_p).norm() / grads_p.norm())
    finite = bool(torch.isfinite(grads_k).all() and torch.isfinite(loss_k))
    dtype = net.cfg.dtype
    print(f"[grad] {tag}, {dtype}, B={B}, bucket {N}: loss kernel {float(loss_k):.6f}, "
          f"plain {float(loss_p):.6f}; ||grad_kernel - grad_plain|| / ||grad_plain|| = "
          f"{rel:.3e} (tol {GRAD_REL_TOL[dtype]:g}); launches per micro-step {launches}")
    if not (finite and rel <= GRAD_REL_TOL[dtype]):
        raise AssertionError(f"{tag} {dtype} gradient: finite={finite}, relative error {rel}")


def phase_grad(seed: int) -> None:
    """Paper-width parameter gradients, kernel route vs plain route, at
    bucket 192 (B=2) in f32 and bf16 and at 512 (B=1) in f32, below the f32
    K-chunk switch (K1, K7 and K2 on their tensor-core bodies), and the
    kernel route's time per micro-step, by kernel group: f32 at 192 and 512
    on both of K1's and K2's f32 bodies, bf16 at 192 and 384."""
    from protein_redesign_tpu_torch.config import ModelConfig

    for dtype in ("float32", "bfloat16"):
        net = perturbed_net(ModelConfig(dtype=dtype, training_mode=True, mask_prob=0.5),
                            seed).to("cuda")
        batch = collated([synthetic_complex(SEQUENCE, seed + s, net.cfg.esm_dim) for s in (1, 2)],
                         192)
        noise = fixed_noise(batch, seed)
        grad_check(net, batch, noise, "paper width")
        if dtype == "float32":
            time_micro_step("f32 micro-step, B=2, bucket 192",
                            lambda: micro_step(net, batch, noise), ("tensor-core", "CUDA-core"))
            bucket, residues = TRAIN_F32_512
            b = collated([synthetic_complex(long_sequence(seed + 25, residues), seed + 25,
                                            net.cfg.esm_dim)], bucket)
            n = fixed_noise(b, seed)
            grad_check(net, b, n, "paper width")
            time_micro_step(f"f32 micro-step, B=1, bucket {bucket}", lambda: micro_step(net, b, n),
                            ("tensor-core", "CUDA-core"))
        else:
            long_batch = collated([synthetic_complex(long_sequence(seed + s), seed + s,
                                                     net.cfg.esm_dim) for s in (3, 4)], 384)
            for bucket, b in ((192, batch), (384, long_batch)):
                n = fixed_noise(b, seed)
                time_micro_step(f"bf16 micro-step, B=2, bucket {bucket}",
                                lambda: micro_step(net, b, n))
        del net


def write_dataset(directory: Path, split: dict) -> None:
    """A data directory for the train CLI: PRD_{part}_pdb_ids and the cached
    complexes of each part ({"train": [...], "val": [...]})."""
    from protein_redesign_tpu_torch.data.dataset import save_complex_cache

    directory.mkdir(parents=True, exist_ok=True)
    for part, datas in split.items():
        ids = [f"{part}{i}" for i in range(len(datas))]
        (directory / f"PRD_{part}_pdb_ids").write_text("\n".join(ids) + "\n")
        for pdb_id, data in zip(ids, datas):
            save_complex_cache(directory / "PDB_processed_cache", pdb_id, data)


def phase_train(seed: int) -> dict:
    """The port's train CLI at paper width: 2 optimizer steps at bucket 192,
    then a resume for 2 steps at bucket 384."""
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.cli.train import main as train
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.utils.checkpoint import read_state

    esm_dim = ModelConfig().esm_dim
    splits = {
        "d192": {"train": [synthetic_complex(SEQUENCE, seed + s, esm_dim) for s in (10, 11)]},
        "d384": {"train": [synthetic_complex(long_sequence(seed + s), seed + s, esm_dim)
                           for s in (12, 13)]},
    }
    val = synthetic_complex(SEQUENCE, seed + 14, esm_dim)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name, split in splits.items():
            write_dataset(tmp / name, {**split, "val": [val]})
        run = tmp / "run"
        common = ["--save_dir", str(run), "--batch_size", "2", "--accumulate_grad_batches", "2",
                  "--val_every_steps", "0", "--log_every_steps", "1", "--warmup_steps", "10",
                  "--seed", str(seed), "--device", "cuda"]
        A.reset_launch_counts()
        peaks = {}
        for bucket, data, extra in ((192, "d192", ["--max_steps", "2"]),
                                    (384, "d384", ["--max_steps", "4", "--trained_ckpt",
                                                   str(run / "checkpoints")])):
            torch.cuda.reset_peak_memory_stats()
            state = train([*common, "--data_dir", str(tmp / data), *extra])
            torch.cuda.synchronize()
            peaks[bucket] = torch.cuda.max_memory_allocated() / 2**30
            del state
        launches = main_path_launches()
        metrics = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        saved = {p.name: sorted(f.name for f in p.iterdir())
                 for p in (run / "checkpoints").iterdir()}
        final = read_state(run / "checkpoints" / "4")
    steps = [m for m in metrics if "train_loss" in m]
    vals = [m for m in metrics if "val_loss" in m]
    losses = [m["train_loss"] for m in steps] + [m["val_loss"] for m in vals]
    if [m["step"] for m in steps] != [1, 2, 3, 4] or len(vals) != 2:
        raise AssertionError(f"metrics.jsonl: steps {[m['step'] for m in steps]}, "
                             f"{len(vals)} validations")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    files = ["config.json", "ema.pt", "optimizer.pt", "params.pt", "state.json"]
    if sorted(saved) != ["2", "4"] or any(v != files for v in saved.values()):
        raise AssertionError(f"checkpoints {saved}")
    if final["step"] != 4 or final["ema_updates"] != 4:
        raise AssertionError(f"resumed state {final}")
    micro = 2 * len(steps)
    per_micro, per_eval = forward_launches(ModelConfig(), remat=True), forward_launches(ModelConfig())
    expected = {k: micro * per_micro[k] + len(vals) * per_eval[k] for k in REPLACES}
    if launches != expected:
        raise AssertionError(f"train launches {launches} != {expected}")
    for m in steps:
        print(f"[train] step {m['step']} bucket {int(m['bucket'])}: loss {m['train_loss']:.4f}, "
              f"grad_norm {m['grad_norm']:.4f}, {m['step_seconds']:.3f} s per optimizer step "
              f"(2 micro-batches of 2)")
    for bucket, peak in peaks.items():
        print(f"[train] bucket {bucket}: peak device memory {peak:.2f} GiB")
    print(f"[train] val_loss {[round(m['val_loss'], 4) for m in vals]}; checkpoints {sorted(saved)}; "
          f"resumed to step {final['step']}; launches {launches}")
    return launches


def phase_h64(seed: int) -> dict:
    """The h64x1 layout (one head of width 64) in training: the whole
    parameter gradient of one micro-step, kernel route (K1 and K7 at C = 64)
    against plain route, at bucket 192 in f32 and bf16 and at 384 in bf16;
    then the train CLI with --head_dim 64 --num_heads 1 at bucket 192, 2
    optimizer steps of 2 x 2 micro-batches, with exact launch counts."""
    from protein_redesign_tpu_torch.cli.train import main as train
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.ops import attention as A

    esm_dim = ModelConfig().esm_dim
    short = [synthetic_complex(SEQUENCE, seed + s, esm_dim) for s in (1, 2)]
    long = [synthetic_complex(long_sequence(seed + s), seed + s, esm_dim) for s in (3, 4)]
    for dtype, bucket, datas in (("float32", 192, short), ("bfloat16", 192, short),
                                 ("bfloat16", 384, long)):
        net = perturbed_net(ModelConfig(dtype=dtype, training_mode=True, mask_prob=0.5, **H64),
                            seed).to("cuda")
        batch = collated(datas, bucket)
        noise = fixed_noise(batch, seed)
        A.reset_launch_counts()
        loss_k = micro_step(net, batch, noise)
        torch.cuda.synchronize()
        launches = main_path_launches()
        grads_k = torch.cat([p.grad.flatten().float() for p in net.parameters()])
        with A.plain_route():
            loss_p = micro_step(net, batch, noise)
        grads_p = torch.cat([p.grad.flatten().float() for p in net.parameters()])
        if launches != forward_launches(net.cfg, remat=True, n=bucket):
            raise AssertionError(f"h64x1 launches per micro-step {launches}")
        rel = float((grads_k - grads_p).norm() / grads_p.norm())
        step_ms = cuda_ms(lambda: micro_step(net, batch, noise), 1, 2)
        print(f"[h64] head_dim 64 x 1 head, {dtype}, B=2, bucket {bucket}: loss kernel "
              f"{float(loss_k):.6f}, plain {float(loss_p):.6f}; ||grad_kernel - grad_plain|| / "
              f"||grad_plain|| = {rel:.3e} (tol {GRAD_REL_TOL[dtype]:g}); micro-step "
              f"{step_ms:.1f} ms; launches {({k: v for k, v in launches.items() if v})}")
        if not (torch.isfinite(grads_k).all() and rel <= GRAD_REL_TOL[dtype]):
            raise AssertionError(f"h64x1 {dtype} gradient at {bucket}: relative error {rel}")
        del net
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_dataset(tmp, {"train": [synthetic_complex(SEQUENCE, seed + s, esm_dim)
                                      for s in (10, 11)],
                            "val": [synthetic_complex(SEQUENCE, seed + 14, esm_dim)]})
        run = tmp / "run"
        argv = ["--save_dir", str(run), "--data_dir", str(tmp), "--batch_size", "2",
                "--accumulate_grad_batches", "2", "--val_every_steps", "0",
                "--log_every_steps", "1", "--warmup_steps", "10", "--seed", str(seed),
                "--device", "cuda", "--max_steps", "2", "--head_dim", "64", "--num_heads", "1"]
        A.reset_launch_counts()
        state = train(argv)
        torch.cuda.synchronize()
        launches = main_path_launches()
        cfg = state.net.cfg
        del state
        metrics = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    steps = [m for m in metrics if "train_loss" in m]
    vals = [m for m in metrics if "val_loss" in m]
    if (cfg.head_dim, cfg.num_heads) != (64, 1) or [m["step"] for m in steps] != [1, 2] or len(
            vals) != 1 or not all(math.isfinite(m["train_loss"]) for m in steps):
        raise AssertionError(f"h64x1 train: {cfg.head_dim} x {cfg.num_heads}, metrics {metrics}")
    micro, evaluation = forward_launches(cfg, remat=True), forward_launches(cfg)
    expected = {k: 4 * micro[k] + evaluation[k] for k in REPLACES}
    if launches != expected or not launches["rows_attention_bwd"]:
        raise AssertionError(f"h64x1 train launches {launches} != {expected}")
    for m in steps:
        print(f"[h64-train] step {m['step']} bucket {int(m['bucket'])}: loss "
              f"{m['train_loss']:.4f}, grad_norm {m['grad_norm']:.4f}, {m['step_seconds']:.3f} s "
              f"per optimizer step (2 micro-batches of 2)")
    print(f"[h64-train] --head_dim 64 --num_heads 1: val_loss {vals[0]['val_loss']:.4f}; launches "
          f"{({k: v for k, v in launches.items() if v})}")
    return launches


def _check_close(what: str, got, want, tol: float, to_scale: bool = False) -> float:
    """Max abs error of ``got`` against ``want``, held to tol x max(1, max|want|);
    ``to_scale``: each element to tol x (|want| + RMS(want)) instead, for bf16
    tensors much smaller than 1 (at N = 2048 K3's and K5's outputs and K6's
    gradients are ~0.03)."""
    want = want.float()
    diff = (got.float() - want).abs()
    err = float(diff.max())
    if to_scale:
        rms = float(want.square().mean().sqrt())
        excess, limit = float((diff - tol * want.abs()).max()), tol * rms
    else:
        excess, limit = err, tol * max(1.0, float(want.abs().max()))
    if not (torch.isfinite(got).all() and excess <= limit):
        raise AssertionError(f"{what}: max abs err {err}, beyond the limit by {excess - limit}")
    return err


def phase_kchunk_kernels() -> dict:
    """K3, K5 and K6 at bucket 2048 (bf16) and 1024 (f32), against their
    plain versions at B=1 (R = N rows) with the long paths' valid node
    counts, so the padded rows are fully masked. All run their tensor-core
    bodies (bf16; f32 in 3xTF32); their CUDA-core bodies are timed on the
    same inputs, each with the bound, the exp floor and SDPA's time (K6:
    forward + backward)."""
    from protein_redesign_tpu_torch.ops import attention as A

    names = ("rows_attention_kchunk", "rows_attention_kchunk_stats", "rows_attention_kchunk_bwd")
    record = {name: {"max_abs_err": 0.0} for name in names}
    for seed, ((N, residues), dtype) in enumerate(((LONG_GENERATE, torch.bfloat16),
                                                    (LONG_TRAIN, torch.float32))):
        n_valid = residues + IMATINIB_ATOMS
        q, k, v, mask, _ = _attention_case(N, N, 4, 16, dtype, n_valid, True, False, True,
                                           200 + seed)
        scale, tol = 0.25, (TOL_BF16 if dtype == torch.bfloat16 else TOL_F32)
        label = str(dtype).replace("torch.", "")
        cases = [
            ("rows_attention_kchunk", lambda: A.rows_attention_kchunk(q, k, v, mask, scale),
             lambda: A.rows_attention_kchunk_reference(q, k, v, mask, scale), 2, 4, 0.0, None),
            ("rows_attention_kchunk_stats",
             lambda: A.rows_attention_kchunk_stats(q, k, v, mask, scale),
             lambda: A.rows_attention_kchunk_reference(q, k, v, mask, scale, stats=True),
             2, 4, 8.0 * N * 4 * N, None),
        ]
        g = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(seed),
                        device="cuda").to(dtype)
        out, m, logs = A.rows_attention_kchunk_reference(q, k, v, mask, scale, stats=True)
        cases.append((
            "rows_attention_kchunk_bwd",
            lambda: A.rows_attention_kchunk_bwd(q, k, v, mask, g, out, m, logs, scale),
            lambda: A.rows_attention_kchunk_bwd_reference(q, k, v, mask, g, out, m, logs, scale),
            5, 8, 8.0 * N * 4 * N, g))
        for name, kernel, plain, products, operands, extra, dout in cases:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            parts = ("dq", "dk", "dv") if dout is not None else ("out", "m", "logs")
            errs = []
            for part, a, b in zip(parts, got, want):
                # the stats are f32 whatever the operands: held to 1e-5
                t = tol if part in ("out", "dq", "dk", "dv") else TOL_F32
                errs.append(_check_close(f"{name} {part} N={N} {label}", a, b, t,
                                         to_scale=t == TOL_BF16))
            if dout is not None and (torch.count_nonzero(got[0][n_valid:])
                                     or torch.count_nonzero(got[1][n_valid:])):
                raise AssertionError(f"{name}: fully masked rows have nonzero dq or dk")
            ms, plain_ms = cuda_ms(kernel, 1, 3), cuda_ms(plain, 1, 2)
            rec = record[name]
            rec["max_abs_err"] = max(rec["max_abs_err"], *errs)
            # the record: K3 on generation at 2048 (bf16), K5 and K6 on
            # training at 1024 (f32); the other lines are printed (K6 at 2048
            # in bf16 is the 2-block micro-step's, phase 12)
            at_record = (name == "rows_attention_kchunk") == (dtype == torch.bfloat16)
            bound_rec = attention_bound(q, mask, None, products, operands, extra)
            yardstick = library_ms(q, k, v, mask, None, scale, dout=dout)
            if at_record:
                rec.update(ms=ms, plain_ms=plain_ms, library_ms=yardstick, **bound_rec)
            stats = {} if dout is None else dict(dout=dout, out=out, m=m, logs=logs)
            bodies = f" (tensor cores; {body_times(name, q, k, v, mask, None, scale, **stats)})"
            print(f"[kchunk] {name} R={N} H=4 N={N} C=16 {label} ({n_valid} valid): max abs err "
                  + "/".join(f"{e:.3e}" for e in errs) + f" ({'/'.join(parts[:len(errs)])}); "
                  f"kernel {ms:.3f} ms{bodies}, plain {plain_ms:.3f} ms; bound "
                  f"{bound_rec['bound_ms']:.3f} ms ({bound_rec['bound_by']}), exp floor "
                  f"{exp_floor_ms(q, mask):.3f} ms, library {yardstick} ms")
    return record


def phase_generate_long(net) -> dict:
    """The generate CLI at bucket 2048 (bf16, B=1): a seeded 2000-residue
    sequence and imatinib (2037 nodes), LONG_STEPS DDPM steps."""
    from protein_redesign_tpu_torch.cli.generate import main
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.utils.weights import save_checkpoint

    bucket, residues = LONG_GENERATE
    sequence = long_sequence(7, residues)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_checkpoint(tmp / "ckpt", net.state_dict(), net.cfg)
        argv = ["-c", str(tmp / "ckpt"), "-o", str(tmp / "out"), "-p", sequence, "-l", LIGAND,
                "-n", "1", "--num_steps", str(LONG_STEPS), "--device", "cuda"]
        torch.cuda.reset_peak_memory_stats()
        A.reset_launch_counts()
        timings = main(argv)
        torch.cuda.synchronize()
        launches = main_path_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        pdb = (tmp / "out" / "sample_protein.pdb").read_text()
        scores = (tmp / "out" / "sample_tmscores.txt").read_text().split()
    # the random weights can put coordinates past the PDB's 8-column fields,
    # which then run together: look for non-finite values by their names
    atoms = [line[30:].lower() for line in pdb.splitlines() if line.startswith("ATOM")]
    if len(atoms) != len(sequence) or any("nan" in a or "inf" in a for a in atoms):
        raise AssertionError(f"sample_protein.pdb: {len(atoms)} CA records or non-finite")
    if [t[0] for t in timings] != [bucket] or len(scores) != 1:
        raise AssertionError(f"generate at {bucket}: timings {timings}, scores {scores}")
    blocks = net.cfg.num_blocks
    expected = launch_record(rows_attention_kchunk=LONG_STEPS * 2 * blocks,
                             tiled_attention=LONG_STEPS * (blocks + 1))
    if launches != expected:
        raise AssertionError(f"generate launches at {bucket} {launches} != {expected}")
    _, rows, steps, seconds = timings[0]
    print(f"[generate-long] bucket {bucket}, bf16, {rows} sample: {steps} DDPM steps in {seconds:.3f} s "
          f"= {seconds / steps:.3f} s/step; peak device memory {peak:.2f} GiB; TM-score {scores}; "
          f"launches {launches}")
    return launches


def long_complex(seed: int, esm_dim: int) -> dict:
    """A seeded LONG_TRAIN complex: a random sequence and imatinib."""
    return synthetic_complex(long_sequence(seed, LONG_TRAIN[1]), seed, esm_dim)


def phase_forward_long(seed: int) -> None:
    """The f32 net at bucket 1024, B=1: kernel route (K3) against plain route."""
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.models.prdiff import prepare_batch
    from protein_redesign_tpu_torch.ops import attention as A

    net = perturbed_net(ModelConfig(dtype="float32"), seed).to("cuda").eval()
    N = LONG_TRAIN[0]
    batch = prepare_batch(collated([long_complex(seed + 20, net.cfg.esm_dim)], N), 0.3,
                          generator=torch.Generator("cuda").manual_seed(0))
    g = torch.Generator("cuda").manual_seed(1)
    z = torch.randn(1, N, 3, generator=g, device="cuda")
    seq_t = torch.randn(1, N, 21, generator=g, device="cuda")
    mask, t = batch["residue_and_atom_mask"], torch.tensor([40], device="cuda")

    def forward(plain: bool):
        if not plain:
            return net(batch, z, seq_t, mask, t)
        with A.plain_route():
            return net(batch, z, seq_t, mask, t)

    with torch.inference_mode():
        A.reset_launch_counts()
        kernel_out = forward(False)
        torch.cuda.synchronize()
        launches = main_path_launches()
        plain_out = forward(True)
        expected = forward_launches(net.cfg, kchunk=True)
        if launches != expected:
            raise AssertionError(f"launches per forward at 1024 {launches} != {expected}")
        for name, a, b in zip(("noise_pred", "seq_pred"), kernel_out, plain_out):
            rel = float((a - b).norm() / b.norm())
            print(f"[forward-long] {name} {tuple(a.shape)}: ||kernel - plain|| / ||plain|| = "
                  f"{rel:.3e} (tol {FORWARD_REL_TOL_F32:g})")
            if not (torch.isfinite(a).all() and rel <= FORWARD_REL_TOL_F32):
                raise AssertionError(f"{name} at 1024: relative error {rel}")
        kernel_ms, plain_ms = cuda_ms(lambda: forward(False), 0, 2), cuda_ms(lambda: forward(True), 0, 2)
        busy = device_time_by_group(lambda: forward(False), iters=2)
    total = sum(busy.values())
    print(f"[forward-long] f32, B=1: kernel route {kernel_ms:.1f} ms, plain route {plain_ms:.1f} ms "
          f"per forward; device busy {total:.1f} ms ({1 - total / kernel_ms:.1%} idle); "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(busy.items(), key=lambda kv: -kv[1])))


def phase_grad_long(seed: int) -> None:
    """One f32 micro-step at bucket 1024, B=1: the whole parameter gradient,
    kernel route (K5, K6) against plain route, and its device time."""
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.ops import attention as A

    net = perturbed_net(ModelConfig(dtype="float32", training_mode=True, mask_prob=0.5),
                        seed).to("cuda")
    batch = collated([long_complex(seed + 21, net.cfg.esm_dim)], LONG_TRAIN[0])
    noise = fixed_noise(batch, seed)
    step = lambda: micro_step(net, batch, noise)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    loss_k = step()
    torch.cuda.synchronize()
    launches = main_path_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    grads_k = torch.cat([p.grad.flatten().float() for p in net.parameters()])
    with A.plain_route():
        loss_p = step()
    grads_p = torch.cat([p.grad.flatten().float() for p in net.parameters()])
    if launches != forward_launches(net.cfg, remat=True, kchunk=True):
        raise AssertionError(f"launches per micro-step at 1024 {launches}")
    rel = float((grads_k - grads_p).norm() / grads_p.norm())
    print(f"[grad-long] f32, B=1: loss kernel {float(loss_k):.6f}, plain {float(loss_p):.6f}; "
          f"||grad_kernel - grad_plain|| / ||grad_plain|| = {rel:.3e} "
          f"(tol {GRAD_REL_TOL['float32']:g}); launches per micro-step {launches}")
    if not (torch.isfinite(grads_k).all() and rel <= GRAD_REL_TOL["float32"]):
        raise AssertionError(f"f32 gradient at 1024: relative error {rel}")
    kernel_ms = cuda_ms(step, 0, 1)
    with A.plain_route():
        plain_ms = cuda_ms(step, 0, 1)
    busy = device_time_by_group(step, iters=1)
    total = sum(busy.values())
    print(f"[grad-long] micro-step (loss + backward, remat): kernel route {kernel_ms:.1f} ms, "
          f"plain route {plain_ms:.1f} ms; peak device memory {peak:.2f} GiB; kernel route "
          f"device busy {total:.1f} ms ({1 - total / kernel_ms:.1%} idle); "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(busy.items(), key=lambda kv: -kv[1])))


def phase_grad_2048(seed: int) -> None:
    """One bf16 micro-step at bucket 2048, B=1: paper widths, num_blocks cut
    to GRAD_2048_BLOCKS for the time limit; the whole parameter gradient,
    kernel route (K5 on its tensor-core body, K6, K2) against plain route,
    exact launch counts, and its time."""
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.ops import attention as A

    cfg = ModelConfig(training_mode=True, mask_prob=0.5, num_blocks=GRAD_2048_BLOCKS)
    net = perturbed_net(cfg, seed).to("cuda")
    bucket, residues = LONG_GENERATE
    batch = collated([synthetic_complex(long_sequence(seed + 24, residues), seed + 24,
                                        net.cfg.esm_dim)], bucket)
    noise = fixed_noise(batch, seed)
    step = lambda: micro_step(net, batch, noise)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    loss_k = step()
    torch.cuda.synchronize()
    launches = main_path_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    grads_k = torch.cat([p.grad.flatten().float() for p in net.parameters()])
    with A.plain_route():
        loss_p = step()
    grads_p = torch.cat([p.grad.flatten().float() for p in net.parameters()])
    expected = forward_launches(net.cfg, remat=True, kchunk=True)
    if launches != expected:
        raise AssertionError(f"launches per micro-step at {bucket} {launches} != {expected}")
    rel = float((grads_k - grads_p).norm() / grads_p.norm())
    finite = bool(torch.isfinite(grads_k).all() and torch.isfinite(loss_k))
    print(f"[grad-2048] bf16, B=1, {GRAD_2048_BLOCKS} blocks: loss kernel {float(loss_k):.6f}, "
          f"plain {float(loss_p):.6f}; ||grad_kernel - grad_plain|| / ||grad_plain|| = {rel:.3e} "
          f"(tol {GRAD_REL_TOL['bfloat16']:g}); launches per micro-step {launches}")
    if not (finite and rel <= GRAD_REL_TOL["bfloat16"]):
        raise AssertionError(f"bf16 gradient at {bucket}: finite={finite}, relative error {rel}")
    kernel_ms = cuda_ms(step, 0, 1)
    with A.plain_route():
        plain_ms = cuda_ms(step, 0, 1)
    busy = device_time_by_group(step, iters=1)
    total = sum(busy.values())
    print(f"[grad-2048] micro-step (loss + backward, remat): kernel route {kernel_ms:.1f} ms, "
          f"plain route {plain_ms:.1f} ms; peak device memory {peak:.2f} GiB; kernel route "
          f"device busy {total:.1f} ms ({1 - total / kernel_ms:.1%} idle); "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(busy.items(), key=lambda kv: -kv[1])))
    del net


def phase_train_long(seed: int, shape=LONG_TRAIN) -> dict:
    """The train CLI at a (bucket, residues) ``shape``, --dtype float32,
    batch 1: 2 optimizer steps and the final validation. At 1024 the
    K-chunk regime (K5, K6); at 512 below the switch (K1, K7)."""
    from protein_redesign_tpu_torch.cli.train import main as train
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.ops import attention as A

    esm_dim = ModelConfig().esm_dim
    bucket, residues = shape
    split = {part: [synthetic_complex(long_sequence(seed + s, residues), seed + s, esm_dim)]
             for part, s in (("train", 22), ("val", 23))}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_dataset(tmp, split)
        run = tmp / "run"
        argv = ["--save_dir", str(run), "--data_dir", str(tmp), "--dtype", "float32",
                "--batch_size", "1", "--val_every_steps", "0", "--log_every_steps", "1",
                "--warmup_steps", "10", "--seed", str(seed), "--device", "cuda", "--max_steps", "2"]
        torch.cuda.reset_peak_memory_stats()
        A.reset_launch_counts()
        state = train(argv)
        torch.cuda.synchronize()
        launches = main_path_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        cfg = state.net.cfg
        del state
        metrics = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    steps = [m for m in metrics if "train_loss" in m]
    vals = [m for m in metrics if "val_loss" in m]
    if [m["step"] for m in steps] != [1, 2] or len(vals) != 1 or any(
            int(m["bucket"]) != bucket for m in steps):
        raise AssertionError(f"metrics.jsonl at {bucket}: {metrics}")
    if not all(math.isfinite(x) for x in [m["train_loss"] for m in steps] + [vals[0]["val_loss"]]):
        raise AssertionError(f"non-finite losses at {bucket}: {metrics}")
    kchunk = A.kchunk_select(bucket, torch.float32) > 0
    micro = forward_launches(cfg, remat=True, kchunk=kchunk, n=bucket)
    evaluation = forward_launches(cfg, kchunk=kchunk, n=bucket)
    expected = {k: 2 * micro[k] + evaluation[k] for k in REPLACES}
    if launches != expected:
        raise AssertionError(f"train launches at {bucket} {launches} != {expected}")
    for m in steps:
        print(f"[train-{bucket}] step {m['step']} bucket {bucket}, f32, batch 1: loss "
              f"{m['train_loss']:.4f}, grad_norm {m['grad_norm']:.4f}, {m['step_seconds']:.3f} s "
              f"per optimizer step")
    print(f"[train-{bucket}] val_loss {vals[0]['val_loss']:.4f}; peak device memory {peak:.2f} GiB; "
          f"launches {launches}")
    return launches


def _nbytes(*tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors if t is not None))


def fused_bound(name: str, args: tuple, out) -> dict:
    """The bound of one fused kernel call on these inputs: each input read
    once and the output written once; the operations this data needs (K8: a
    query against its row's unmasked keys; K9: the contraction over each
    complex's valid nodes; the projections and MLPs over every position)."""
    if name == "fused_gated_rows_attention":
        x, mask, wq, *_, H = args
        N, D = x.shape[-2:]
        HC, positions = wq.shape[0], x.numel() // D
        pairs = N * float(mask.sum())
        flops = 4 * (HC // H) * H * pairs + 2 * positions * D * 5 * HC
    elif name == "triangle_multiply":
        pair, mask = args[:2]
        B, N, _, D = pair.shape
        nodes = torch.diagonal(mask, dim1=-2, dim2=-1).sum(-1)
        flops = 2 * B * N * N * D * 6 * D + 2 * D * float((nodes ** 3).sum())
    elif name == "fused_transition":
        x, w1, _, w2 = args[:4]
        flops = 2 * (x.numel() // x.shape[-1]) * w1.shape[0] * (w1.shape[1] + w2.shape[0])
    else:
        x, w, _ = args
        B, N, S = x.shape
        flops = 2 * B * N * N * S * w.shape[0]
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    return bound(flops, _nbytes(*tensors, out), out.dtype)


@contextlib.contextmanager
def fused_cuda_core_bodies():
    """Inside the block, K8, K9 and K10 take the CUDA-core bodies that their
    tensor-core ones replaced (fused_gated.cu, trimul.cu, transition.cu), so
    that both can be timed in one run. Launch counts are the same."""
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.ops import transition as T
    from protein_redesign_tpu_torch.ops import trimul as M

    takes = (A.fused_gated_takes_tensor_cores, M.trimul_takes_tensor_cores,
             T.transition_takes_tensor_cores)
    A.fused_gated_takes_tensor_cores = lambda D, H, C: False
    M.trimul_takes_tensor_cores = lambda D: False
    T.transition_takes_tensor_cores = lambda D, Hd, Dout, dtype: False
    try:
        yield
    finally:
        (A.fused_gated_takes_tensor_cores, M.trimul_takes_tensor_cores,
         T.transition_takes_tensor_cores) = takes


def phase_fused_kernels() -> dict:
    """K8-K11 against their plain versions at the fused configuration's shapes
    at bucket 192, B=2 (147 nodes valid): f32 and bf16 errors; the kernel's,
    the plain version's and the unfused module route's time in both; K8, K9
    and K10 on the device on their tensor-core bodies and on the CUDA-core
    bodies those replaced; the record (bf16) keeps K8's starting view, K9
    outgoing, K10 pair_fc. Then the same in bf16 at AlphaFold2's pair width
    128 (K10's pair_fc there in f32 too), K8 at the h64x1 and h64x4 head
    layouts (bf16) and K10 at single_fc 768 (both dtypes), outside the
    record."""
    from protein_redesign_tpu_torch.models.denoiser import OuterLinear, TriangleMultiplication
    from protein_redesign_tpu_torch.models.layers import GatedAttention, TransitionMLP
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.ops import outer as O
    from protein_redesign_tpu_torch.ops import transition as T
    from protein_redesign_tpu_torch.ops import trimul as M

    N, n_valid, tol = 192, 147, {torch.float32: TOL_F32, torch.bfloat16: TOL_BF16}
    record = {name: {"max_abs_err": 0.0, "library_ms": None} for name in FUSED_NAMES}
    node = (torch.arange(N, device="cuda") < n_valid).float()
    mask2d = (node[:, None] * node[None, :]).expand(2, N, N).contiguous()
    # (dtype, pair width, K8's heads x width, single width; the paper's layout
    # runs every kernel, the others K8 or K10 alone)
    widths = ((torch.float32, 64, (4, 16), 512), (torch.bfloat16, 64, (4, 16), 512),
              (torch.bfloat16, 128, (4, 16), 512), (torch.float32, 128, None, None),
              (torch.bfloat16, 64, (1, 64), None), (torch.bfloat16, 64, (4, 64), None),
              (torch.bfloat16, 64, None, 768), (torch.float32, 64, None, 768))
    for seed, (dtype, D, heads, single_dim) in enumerate(widths):
        paper = heads == (4, 16) and single_dim == 512
        g = torch.Generator("cuda").manual_seed(300 + seed)
        pair = torch.randn(2, N, N, D, generator=g, device="cuda").to(dtype)
        cases = []
        if heads is not None:
            H, C = heads
            ga = perturb(GatedAttention(D, C, H, dtype), 310).to("cuda")
            gw = (ga.q_proj.weight, ga.k_proj.weight, ga.v_proj.weight, ga.gate_proj.weight,
                  ga.gate_proj.bias, ga.out_proj.weight, ga.out_proj.bias, H)
            for view, x, m in (("starting", pair, mask2d),
                               ("ending", pair.transpose(1, 2), mask2d.transpose(1, 2))):
                cases.append(("fused_gated_rows_attention", f"{view}, h{C}x{H}", A.fused_gated,
                              A.fused_gated_reference, (x, m, *gw),
                              lambda ga=ga, x=x, m=m: ga(x, m)))
        if paper:
            for mode in ("outgoing", "incoming"):
                tm = perturb(TriangleMultiplication(D, mode, dtype=dtype), 320).to("cuda")
                tw = (tm.ab_gate.weight, tm.ab_gate.bias, tm.ab_proj.weight, tm.ab_proj.bias,
                      tm.out_gate.weight, tm.out_gate.bias, tm.out_proj.weight, tm.out_proj.bias)
                cases.append(("triangle_multiply", mode, lambda *a, mode=mode: M.trimul(*a, mode),
                              lambda *a, mode=mode: M.trimul_reference(*a, mode),
                              (pair, mask2d, *tw), lambda tm=tm: tm(pair, mask2d)))
        single = None
        if single_dim is not None:
            single = torch.randn(2, N, single_dim, generator=g, device="cuda").to(dtype)
        views = (("pair_fc", pair, D), ("single_fc", single, single_dim)) if paper else (
            ("single_fc", single, single_dim),) if single_dim is not None else (
            ("pair_fc", pair, D),) if heads is None else ()
        for view, x, dim in views:
            mlp = perturb(TransitionMLP(dim, 4 * dim, dim, dtype=dtype), 330).to("cuda")
            cases.append(("fused_transition", view, T.transition, T.transition_reference,
                          (x, mlp[1].weight, mlp[1].bias, mlp[3].weight, mlp[3].bias),
                          lambda mlp=mlp, x=x: mlp(x)))
        if paper:
            ol = perturb(OuterLinear(512, D, factored=True, dtype=dtype), 340).to("cuda")
            cases.append(("fused_outer_linear", "factored route", O.outer, O.outer_reference,
                          (single, ol.linear.weight, ol.linear.bias), lambda ol=ol: ol(single)))
        label = str(dtype).replace("torch.", "") + ("" if D == 64 else f", D={D}") + (
            "" if single_dim in (None, 512) else f", single {single_dim}")
        with torch.inference_mode():
            for name, view, kernel, plain, args, unfused in cases:
                got, want = kernel(*args), plain(*args)
                torch.cuda.synchronize()
                rel = float((got.float() - want.float()).norm() / want.float().norm())
                err = float((got.float() - want.float()).abs().max())
                if not (torch.isfinite(got).all() and rel <= tol[dtype]):
                    raise AssertionError(f"{name} {view} {label}: relative error {rel} > "
                                         f"{tol[dtype]}")
                ms = cuda_ms(lambda: kernel(*args))
                plain_ms, unfused_ms = cuda_ms(lambda: plain(*args)), cuda_ms(unfused)
                rec = record[name]
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                b = fused_bound(name, args, got)
                bodies = ""
                if name in FUSED_NAMES[:3]:  # K8, K9, K10: both bodies on the device
                    dev = device_ms(lambda: kernel(*args))
                    layout = ""
                    if name == "fused_transition":
                        w1, w2 = args[1], args[3]
                        layout = ", " + T.transition_layout(w1.shape[1], w1.shape[0], w2.shape[0],
                                                            dtype) + " layout"
                    bodies = f"; on the device {dev:.4f} ms (tensor-core body{layout})"
                    core_fits = (name != "fused_gated_rows_attention"
                                 or A.fused_gated_core_fits(D, *heads))
                    if core_fits:
                        with fused_cuda_core_bodies():
                            core = kernel(*args)
                            core_dev = device_ms(lambda: kernel(*args))
                        torch.cuda.synchronize()
                        core_rel = float((core.float() - want.float()).norm() / want.float().norm())
                        bodies += (f", CUDA-core body {core_dev:.4f} ms (its error {core_rel:.3e}, "
                                   f"{core_dev / dev:.1f}x the tensor-core body's time)")
                print(f"[fused-kernels] {name} ({view}) {label}: ||kernel - plain|| / ||plain|| "
                      f"{rel:.3e} (tol {tol[dtype]:g}), max abs err {err:.3e}; kernel {ms:.4f} ms"
                      f"{bodies}, plain {plain_ms:.4f} ms, unfused module route {unfused_ms:.4f} "
                      f"ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
                if dtype == torch.bfloat16 and paper and D == 64 and view.split(",")[0] in (
                        "starting", "outgoing", "pair_fc", "factored route"):
                    rec.update(ms=ms, plain_ms=plain_ms, unfused_ms=unfused_ms, **b)
    return record


def fused_net(dtype: str = "bfloat16", **overrides):
    from protein_redesign_tpu_torch.config import ModelConfig

    return perturbed_net(ModelConfig(dtype=dtype, **{f: True for f in FUSED}, **overrides))


def phase_fused_forward_large(seed: int) -> None:
    """The fused configuration's bf16 forward at bucket 512, B=1: kernel
    route against plain route, launches, device time by kernel group."""
    from protein_redesign_tpu_torch.models.prdiff import prepare_batch
    from protein_redesign_tpu_torch.ops import attention as A

    net = fused_net().to("cuda").eval()
    N, residues = FUSED_BUCKET_LARGE
    data = synthetic_complex(long_sequence(seed + 30, residues), seed + 30, net.cfg.esm_dim)
    batch = prepare_batch(collated([data], N), 0.3,
                          generator=torch.Generator("cuda").manual_seed(0))
    g = torch.Generator("cuda").manual_seed(1)
    z = torch.randn(1, N, 3, generator=g, device="cuda")
    seq_t = torch.randn(1, N, 21, generator=g, device="cuda")
    mask, t = batch["residue_and_atom_mask"], torch.tensor([40], device="cuda")

    def forward(plain: bool):
        if not plain:
            return net(batch, z, seq_t, mask, t)
        with A.plain_route():
            return net(batch, z, seq_t, mask, t)

    with torch.inference_mode():
        A.reset_launch_counts()
        kernel_out = forward(False)
        torch.cuda.synchronize()
        launches = main_path_launches()
        plain_out = forward(True)
        if launches != forward_launches(net.cfg):
            raise AssertionError(f"fused launches per forward at {N} {launches}")
        for name, a, b in zip(("noise_pred", "seq_pred"), kernel_out, plain_out):
            rel = float((a - b).norm() / b.norm())
            print(f"[fused-forward-512] {name} {tuple(a.shape)}: ||kernel - plain|| / ||plain|| = "
                  f"{rel:.3e} (tol {FORWARD_REL_TOL:g})")
            if not (torch.isfinite(a).all() and rel <= FORWARD_REL_TOL):
                raise AssertionError(f"{name} at {N}: relative error {rel}")
        kernel_ms, plain_ms = cuda_ms(lambda: forward(False), 1, 3), cuda_ms(lambda: forward(True), 1, 3)
        busy = device_time_by_group(lambda: forward(False), iters=3)
    total = sum(busy.values())
    print(f"[fused-forward-512] bf16, B=1, {residues + IMATINIB_ATOMS} nodes: kernel route "
          f"{kernel_ms:.2f} ms, plain route {plain_ms:.2f} ms per forward; device busy {total:.2f} ms "
          f"({1 - total / kernel_ms:.1%} idle); "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(busy.items(), key=lambda kv: -kv[1])))


def phase_fused_grad(seed: int) -> None:
    """The fused configuration's f32 whole parameter gradient at bucket 192,
    B=2, kernel route against plain route; then the bf16 micro-step's time
    and device time by kernel group."""
    from protein_redesign_tpu_torch.ops import attention as A

    for dtype in ("float32", "bfloat16"):
        net = fused_net(dtype, training_mode=True, mask_prob=0.5).to("cuda")
        batch = collated([synthetic_complex(SEQUENCE, seed + s, net.cfg.esm_dim) for s in (1, 2)],
                         192)
        noise = fixed_noise(batch, seed)
        step = lambda: micro_step(net, batch, noise)  # noqa: E731
        if dtype == "float32":
            A.reset_launch_counts()
            loss_k = step()
            torch.cuda.synchronize()
            launches = main_path_launches()
            grads_k = torch.cat([p.grad.flatten().float() for p in net.parameters()])
            with A.plain_route():
                loss_p = step()
            grads_p = torch.cat([p.grad.flatten().float() for p in net.parameters()])
            expected = forward_launches(net.cfg, remat=True)
            if launches != expected:
                raise AssertionError(f"fused launches per micro-step {launches} != {expected}")
            rel = float((grads_k - grads_p).norm() / grads_p.norm())
            print(f"[fused-grad] f32, B=2, bucket 192: loss kernel {float(loss_k):.6f}, plain "
                  f"{float(loss_p):.6f}; ||grad_kernel - grad_plain|| / ||grad_plain|| = {rel:.3e} "
                  f"(tol {GRAD_REL_TOL['float32']:g}); launches per micro-step "
                  f"{ {k: v for k, v in launches.items() if v} }")
            if not (torch.isfinite(grads_k).all() and rel <= GRAD_REL_TOL["float32"]):
                raise AssertionError(f"fused f32 gradient: relative error {rel}")
        else:
            kernel_ms = cuda_ms(step, 1, 3)
            with A.plain_route():
                plain_ms = cuda_ms(step, 1, 3)
            busy = device_time_by_group(step, iters=3)
            total = sum(busy.values())
            print(f"[fused-grad] bf16 micro-step (loss + backward, remat), B=2, bucket 192: kernel "
                  f"route {kernel_ms:.2f} ms, plain route {plain_ms:.2f} ms; kernel route device "
                  f"time {total:.2f} ms busy ({1 - total / kernel_ms:.1%} idle); "
                  + ", ".join(f"{k} {v:.2f}" for k, v in
                              sorted(busy.items(), key=lambda kv: -kv[1])))
        del net


def phase_fused_train(seed: int) -> dict:
    """The train CLI with the four switches at bucket 192, batch 2 x 2
    micro-batches: 2 optimizer steps and the final validation."""
    from protein_redesign_tpu_torch.cli.train import main as train
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.utils.checkpoint import read_config

    esm_dim = ModelConfig().esm_dim
    split = {"train": [synthetic_complex(SEQUENCE, seed + s, esm_dim) for s in (40, 41)],
             "val": [synthetic_complex(SEQUENCE, seed + 42, esm_dim)]}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_dataset(tmp, split)
        run = tmp / "run"
        argv = ["--save_dir", str(run), "--data_dir", str(tmp), "--batch_size", "2",
                "--accumulate_grad_batches", "2", "--val_every_steps", "0", "--log_every_steps", "1",
                "--warmup_steps", "10", "--seed", str(seed), "--device", "cuda", "--max_steps", "2",
                *[f"--{f}" for f in FUSED]]
        torch.cuda.reset_peak_memory_stats()
        A.reset_launch_counts()
        state = train(argv)
        torch.cuda.synchronize()
        launches = main_path_launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        cfg = state.net.cfg
        del state
        metrics = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        saved = sorted(p.name for p in (run / "checkpoints" / "2").iterdir())
        saved_cfg = read_config(run / "checkpoints" / "2")
    steps = [m for m in metrics if "train_loss" in m]
    vals = [m for m in metrics if "val_loss" in m]
    if [m["step"] for m in steps] != [1, 2] or len(vals) != 1:
        raise AssertionError(f"fused train metrics.jsonl: {metrics}")
    if not all(math.isfinite(x) for x in [m["train_loss"] for m in steps] + [vals[0]["val_loss"]]):
        raise AssertionError(f"fused train: non-finite losses {metrics}")
    if saved != ["config.json", "ema.pt", "optimizer.pt", "params.pt", "state.json"] or not all(
            getattr(saved_cfg, f) for f in FUSED):
        raise AssertionError(f"fused train checkpoint {saved}, config {saved_cfg}")
    micro, evaluation = forward_launches(cfg, remat=True), forward_launches(cfg)
    expected = {k: 4 * micro[k] + evaluation[k] for k in REPLACES}
    if launches != expected:
        raise AssertionError(f"fused train launches {launches} != {expected}")
    for m in steps:
        print(f"[fused-train] step {m['step']} bucket {int(m['bucket'])}: loss {m['train_loss']:.4f}, "
              f"grad_norm {m['grad_norm']:.4f}, {m['step_seconds']:.3f} s per optimizer step "
              f"(2 micro-batches of 2)")
    print(f"[fused-train] val_loss {vals[0]['val_loss']:.4f}; peak device memory {peak:.2f} GiB; "
          f"checkpoint with the four switches; launches {({k: v for k, v in launches.items() if v})}")
    return launches


def phase_fast_kernel() -> dict:
    """K1 fast against its plain version, to TOL_BF16 (p is rounded to bf16
    in both dtypes), at bucket 384 (R = 768, 360 nodes valid; its serving
    shape) and 192 (R = 384, 147 valid), in bf16 and f32: its tensor-core
    body (bf16 attention_mma.cu, f32 3xTF32 attention_tf32.cu) timed beside
    its CUDA-core body, with the share of output elements that differ from
    the plain version (in f32: past the f32 sums' TOL_F32, the bf16 rounding
    flips) and the plain version's, K1's and SDPA's time on the same inputs
    and the bound. The record keeps bf16 at 384, its f32 entry f32 at 384."""
    from protein_redesign_tpu_torch.ops import attention as A

    rec = {"max_abs_err": 0.0}
    rec_f32 = {"max_abs_err": 0.0}
    cases = ((384, 360, torch.bfloat16), (192, 147, torch.bfloat16), (384, 360, torch.float32),
             (192, 147, torch.float32))
    for seed, (N, n_valid, dtype) in enumerate(cases):
        q, k, v, mask, _ = _attention_case(2 * N, N, 4, 16, dtype, n_valid, True, False, True,
                                           400 + seed)
        scale = 0.25
        kernel = lambda: A.rows_attention_fast(q, k, v, mask, scale)  # noqa: E731
        plain = lambda: A.rows_attention_fast_reference(q, k, v, mask, scale)  # noqa: E731
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        excess = float((diff - TOL_BF16 * ref.float().abs()).max())
        if not (out.dtype == dtype and torch.isfinite(out).all() and excess <= TOL_BF16):
            raise AssertionError(f"rows_attention_fast {dtype}: max abs err {err} > tol {TOL_BF16}")
        bf16 = dtype == torch.bfloat16
        moved = (out != ref) if bf16 else diff > TOL_F32 * (1 + ref.float().abs())
        differ = f"{float(moved.float().mean()):.2e} of the outputs differ from the plain version"
        if not bf16:
            differ += f" past {TOL_F32:g}"
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        k1_ms = cuda_ms(lambda: A.rows_attention(q, k, v, mask, scale))
        label = str(dtype).replace("torch.", "")
        body = ("tensor cores; " if bf16 else "3xTF32; ") + body_times(
            "rows_attention_fast", q, k, v, mask, None, scale)
        print(f"[fast-kernel] rows_attention_fast R={2 * N} H=4 N={N} C=16 {label} "
              f"({n_valid} valid): max_abs_err {err:.3e} (tol {TOL_BF16:g}), {differ}; kernel "
              f"{ms:.4f} ms ({body}), plain {plain_ms:.4f} ms, K1 on the same inputs "
              f"{k1_ms:.4f} ms")
        r = rec if bf16 else rec_f32
        r["max_abs_err"] = max(r["max_abs_err"], err)
        at = attention_bound(q, mask, None, 2, 4)
        lib_ms = library_ms(q, k, v, mask, None, scale)
        if N == 384:
            r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **at)
        print(f"[fast-kernel] R={2 * N} N={N} {label}: bound {at['bound_ms']:.4f} ms "
              f"({at['bound_by']}; exp floor {exp_floor_ms(q, mask):.4f} ms), library "
              f"({label} SDPA) {lib_ms} ms")
    return {"rows_attention_fast": rec, "rows_attention_fast_f32": rec_f32}


def _fast_train(tmp: Path, seed: int) -> Path:
    """The train CLI with --no-use_pallas_bwd --fast_softmax on phase 8's
    data at bucket 192: 2 optimizer steps of 2 x 2 micro-batches and the
    final validation. Returns the checkpoint directory."""
    from protein_redesign_tpu_torch.cli.train import main as train
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.utils.checkpoint import read_config

    esm_dim = ModelConfig().esm_dim
    write_dataset(tmp / "data", {
        "train": [synthetic_complex(SEQUENCE, seed + s, esm_dim) for s in (10, 11)],
        "val": [synthetic_complex(SEQUENCE, seed + 14, esm_dim)]})
    run = tmp / "run"
    argv = ["--save_dir", str(run), "--data_dir", str(tmp / "data"), "--batch_size", "2",
            "--accumulate_grad_batches", "2", "--val_every_steps", "0", "--log_every_steps", "1",
            "--warmup_steps", "10", "--seed", str(seed), "--device", "cuda", "--max_steps", "2",
            "--no-use_pallas_bwd", "--fast_softmax"]
    A.reset_launch_counts()
    state = train(argv)
    torch.cuda.synchronize()
    launches = main_path_launches()
    cfg = state.net.cfg
    del state
    metrics = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    saved_cfg = read_config(run / "checkpoints" / "2")
    steps = [m for m in metrics if "train_loss" in m]
    vals = [m for m in metrics if "val_loss" in m]
    if [m["step"] for m in steps] != [1, 2] or len(vals) != 1:
        raise AssertionError(f"fast train metrics.jsonl: {metrics}")
    if not all(math.isfinite(x) for x in [m["train_loss"] for m in steps] + [vals[0]["val_loss"]]):
        raise AssertionError(f"fast train: non-finite losses {metrics}")
    if not saved_cfg.fast_softmax or saved_cfg.use_pallas_bwd:
        raise AssertionError(f"fast train checkpoint config {saved_cfg}")
    # training without use_pallas_bwd: the plan takes XLA at every bucket,
    # so with fast_softmax the bf16 model's attentions are bf16-logit ones
    micro, evaluation = forward_launches(cfg, remat=True), forward_launches(cfg)
    if any(micro.values()) or any(evaluation.values()):
        raise AssertionError(f"fast train: expected no attention kernel, got {micro}")
    expected = {k: 4 * micro[k] + evaluation[k] for k in REPLACES}
    if launches != expected:
        raise AssertionError(f"fast train launches {launches} != {expected}")
    for m in steps:
        print(f"[serve-train] step {m['step']} bucket {int(m['bucket'])}: loss "
              f"{m['train_loss']:.4f}, grad_norm {m['grad_norm']:.4f}, {m['step_seconds']:.3f} s "
              f"per optimizer step (2 micro-batches of 2)")
    print(f"[serve-train] --no-use_pallas_bwd --fast_softmax: val_loss {vals[0]['val_loss']:.4f}; "
          f"no attention kernel launched (the training plan's bf16-logit attention); launches "
          f"{({k: v for k, v in launches.items() if v})}")
    return run / "checkpoints"


def _serve_jsonl(tmp: Path, ckpt: Path, seed: int) -> dict:
    """The serve CLI over a JSONL file of three requests; returns its launches."""
    from protein_redesign_tpu_torch.cli.serve import main as serve
    from protein_redesign_tpu_torch.ops import attention as A

    request = {"protein": SEQUENCE, "ligand": LIGAND, "num_samples": 2}
    requests = [{**request, "id": "lysozyme", "seed": 1},
                {**request, "id": "lysozyme-trajectory", "seed": 2, "trajectory": 5},
                {**request, "id": "long", "seed": 3, "protein": long_sequence(seed + 51, SERVE_LONG)},
                {**request, "id": "oversized", "num_samples": 1,
                 "protein": long_sequence(seed + 50, SERVE_OVERSIZED)}]
    reqs, results = tmp / "requests.jsonl", tmp / "results.jsonl"
    reqs.write_text("".join(json.dumps(r) + "\n" for r in requests))
    argv = ["-c", str(ckpt), "-o", str(tmp / "served"), "--num_steps", str(SERVE_SCHEDULE),
            "--fast_softmax", "--sampler", "ddim", "--ddim_steps", str(SERVE_STEPS),
            "--batch_size", "2", "--warmup_buckets", "192,384", "--input", str(reqs),
            "--output", str(results), "--device", "cuda"]
    A.reset_launch_counts()
    began = time.perf_counter()
    runner = serve(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - began
    launches = main_path_launches()
    lines = [json.loads(line) for line in results.read_text().splitlines()]
    if [line["id"] for line in lines] != [r["id"] for r in requests]:
        raise AssertionError(f"serve: responses {lines}")
    plain, movie, long, oversized = lines
    for line in (plain, movie, long):
        if "error" in line or len(line["sequences"]) != 2 or not all(
                0.0 <= x <= 1.0 for x in line["tmscores"]):
            raise AssertionError(f"serve: response {line}")
        for path in line["pdb_files"] + line["sdf_files"] + line.get("trajectory_files", []):
            if not Path(path).is_file() or not Path(path).stat().st_size:
                raise AssertionError(f"serve: missing output {path}")
        for path in line["pdb_files"]:
            # CA records; non-finite values are looked for by name (the
            # 2-step checkpoint can put coordinates past the 8-column fields)
            atoms = [a[30:].lower() for a in Path(path).read_text().splitlines()
                     if a.startswith("ATOM")]
            residues = SERVE_LONG if line is long else len(SEQUENCE)
            if len(atoms) != residues or any("nan" in a or "inf" in a for a in atoms):
                raise AssertionError(f"serve: {path} has {len(atoms)} CA records or non-finite")
    frames = [Path(path).read_text().count("MODEL") for path in movie["trajectory_files"]]
    if frames != [5, 5] or "max_nodes" not in oversized.get("error", ""):
        raise AssertionError(f"serve: trajectory frames {frames}, oversized {oversized}")
    # a warm-up batch per bucket and one per request; only the batches at 384
    # take the Pallas plan (K1 fast, K2): at 192 the bf16-logit attention
    buckets = [t[0] for t in runner.timings]
    per_forward = {n: forward_launches(runner.net.cfg, n=n) for n in (192, 384)}
    if any(per_forward[192].values()):
        raise AssertionError(f"serve: the 192 batches would launch {per_forward[192]}")
    expected = launch_record(**{k: SERVE_STEPS * sum(per_forward[n][k] for n in buckets)
                                for k in REPLACES})
    if sorted(buckets) != [192, 192, 192, 384, 384] or launches != expected:
        raise AssertionError(f"serve launches {launches} over batches at {buckets} != {expected}")
    print(f"[serve] the 192 batches launched no K1 fast and no K2; each batch at 384 "
          f"{SERVE_STEPS} x {per_forward[384]['rows_attention_fast']} K1 fast and "
          f"{SERVE_STEPS} x {per_forward[384]['tiled_attention']} K2")
    for bucket, rows, steps, seconds in runner.timings:
        print(f"[serve] bucket {bucket}, {rows} samples per batch: {steps} DDIM steps in "
              f"{seconds:.3f} s = {seconds / steps:.4f} s/step")
    print(f"[serve] main() wall {wall:.2f} s (startup, warm-up and 4 requests); TM-scores "
          f"{plain['tmscores']} / {movie['tmscores']} / {long['tmscores']}; oversized: "
          f"{oversized['error'][:60]}...; "
          f"launches {({k: v for k, v in launches.items() if v})}")
    return launches


def _serve_tcp(tmp: Path, ckpt: Path) -> None:
    """One request to the serve CLI in TCP mode (--port 0), in a process of
    its own, which is stopped afterwards."""
    argv = [sys.executable, "-m", "protein_redesign_tpu_torch.cli.serve", "-c", str(ckpt),
            "-o", str(tmp / "tcp"), "--num_steps", str(SERVE_SCHEDULE), "--fast_softmax",
            "--sampler", "ddim", "--ddim_steps", str(SERVE_STEPS), "--port", "0",
            "--device", "cuda"]
    began = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=REPO, stderr=subprocess.PIPE, text=True)
    log, ports = [], []
    listening = threading.Event()

    def drain():
        for line in proc.stderr:
            log.append(line)
            found = re.search(r"listening on [^:]+:(\d+)", line)
            if found:
                ports.append(int(found.group(1)))
                listening.set()
        listening.set()

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    try:
        if not listening.wait(600) or not ports:
            raise AssertionError("serve --port 0 did not start: " + "".join(log[-20:]))
        ready = time.perf_counter() - began
        request = {"id": "tcp", "protein": SEQUENCE, "ligand": LIGAND, "num_samples": 1, "seed": 3}
        sent = time.perf_counter()
        with socket.create_connection(("127.0.0.1", ports[0]), timeout=600) as conn:
            stream = conn.makefile("rw")
            stream.write(json.dumps(request) + "\n")
            stream.flush()
            response = json.loads(stream.readline())
        latency = time.perf_counter() - sent
    finally:
        proc.terminate()
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        reader.join(10)
    if "error" in response or len(response["sequences"]) != 1 or not Path(
            response["pdb_files"][0]).is_file():
        raise AssertionError(f"serve --port: response {response}")
    print(f"[serve-tcp] listening after {ready:.1f} s (process start, checkpoint, ESM backend); "
          f"one request (1 sample, {SERVE_STEPS} DDIM steps, first at this bucket) answered in "
          f"{latency:.2f} s; TM-score {response['tmscores']}")


def phase_serving(seed: int) -> dict:
    """Phase 15's train CLI, serve CLI and TCP request on one checkpoint;
    returns the serve CLI's launches."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = _fast_train(tmp, seed)
        launches = _serve_jsonl(tmp, ckpt, seed)
        _serve_tcp(tmp, ckpt)
    return launches


# DDIM steps of the request served from the f32 fast-softmax checkpoint.
F32_SERVE_STEPS = 5


def phase_fast_f32(seed: int) -> dict:
    """K1 fast in f32 where a user runs it: the paper-width f32 net with
    fast_softmax on and use_pallas_bwd off (the attention plan takes Pallas
    from bucket 384), its forward at bucket 384, B=2, against the plain route
    (exactly 24 K1 fast, 13 K2 and no K1; by kernel group), held to
    FORWARD_REL_TOL_F32: both routes round the softmax to bf16 at the same
    points, and only a logit that the order of the f32 sums rounds the other
    way differs; then its checkpoint (utils.weights.save_checkpoint) served
    through the serve CLI with --fast_softmax --sampler ddim, warmed at 384,
    one request of a seeded SERVE_LONG-residue sequence and imatinib (2
    samples, bucket 384) over F32_SERVE_STEPS DDIM steps: s per step and
    exact launches (24 K1 fast per forward). Returns the serve CLI's
    launches."""
    from protein_redesign_tpu_torch.cli.serve import main as serve
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.utils.weights import save_checkpoint

    began = time.perf_counter()
    cfg = ModelConfig(dtype="float32", fast_softmax=True, use_pallas_bwd=False)
    net = perturbed_net(cfg, seed).to("cuda").eval()
    per_forward = forward_launches(cfg, n=384)
    if per_forward["rows_attention_fast"] != 2 * cfg.num_blocks or per_forward["rows_attention"]:
        raise AssertionError(f"the f32 fast forward at 384 would launch {per_forward}")
    phase_forward(net, tag="fast-f32-forward-384", bucket=384, tol=FORWARD_REL_TOL_F32)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_checkpoint(tmp / "ckpt", net.state_dict(), net.cfg)
        del net
        request = {"id": "long-f32", "protein": long_sequence(seed + 51, SERVE_LONG),
                   "ligand": LIGAND, "num_samples": 2, "seed": 4}
        reqs, results = tmp / "requests.jsonl", tmp / "results.jsonl"
        reqs.write_text(json.dumps(request) + "\n")
        argv = ["-c", str(tmp / "ckpt"), "-o", str(tmp / "served"), "--num_steps",
                str(SERVE_SCHEDULE), "--fast_softmax", "--sampler", "ddim", "--ddim_steps",
                str(F32_SERVE_STEPS), "--batch_size", "2", "--warmup_buckets", "384",
                "--input", str(reqs), "--output", str(results), "--device", "cuda"]
        A.reset_launch_counts()
        served = time.perf_counter()
        runner = serve(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - served
        launches = main_path_launches()
        line = json.loads(results.read_text().splitlines()[0])
        if "error" in line or len(line["sequences"]) != 2 or not all(
                0.0 <= x <= 1.0 for x in line["tmscores"]) or not all(
                Path(f).is_file() for f in line["pdb_files"] + line["sdf_files"]):
            raise AssertionError(f"f32 serve: response {line}")
    if runner.net.cfg.dtype != "float32":
        raise AssertionError(f"f32 serve: the checkpoint loaded as {runner.net.cfg.dtype}")
    buckets = [t[0] for t in runner.timings]  # the warm-up batch and the request's
    per_forward = forward_launches(runner.net.cfg, n=384)
    expected = launch_record(**{k: F32_SERVE_STEPS * len(buckets) * per_forward[k]
                                for k in REPLACES})
    if buckets != [384, 384] or launches != expected:
        raise AssertionError(f"f32 serve launches {launches} over batches at {buckets} != "
                             f"{expected}")
    for bucket, rows, steps, seconds in runner.timings:
        print(f"[fast-f32-serve] bucket {bucket}, {rows} samples per batch: {steps} DDIM steps "
              f"in {seconds:.3f} s = {seconds / steps:.4f} s/step")
    print(f"[fast-f32-serve] f32 checkpoint with --fast_softmax: main() wall {wall:.2f} s "
          f"(startup, warm-up and 1 request); TM-scores {line['tmscores']}; launches "
          f"{({k: v for k, v in launches.items() if v})}; phase wall "
          f"{time.perf_counter() - began:.1f} s")
    return launches


# Configurations past the kernels' former bounds, with the launches of one
# 2-block forward at bucket 192: the four switches at AlphaFold2's pair width
# 128 (K8, K9 and K11 at D = 128; K10 on both transitions), an f32 model
# with single_dim 768 (SPAttention's head width: K2's wide 3xTF32 body at
# C = 768) and a bf16 one with the transition switch (K10 at D = 768, past
# its whole-row tile).
WIDE_CONFIGS = (
    ("pair_dim 128, four switches, bf16",
     dict(pair_dim=128, dtype="bfloat16", **{f: True for f in FUSED}),
     dict(fused_gated_rows_attention=4, triangle_multiply=4, fused_outer_linear=2,
          tiled_attention=3, fused_transition=4), FORWARD_REL_TOL),
    ("single_dim 768, f32", dict(single_dim=768, dtype="float32"),
     dict(rows_attention=4, tiled_attention=3), FORWARD_REL_TOL_F32),
    ("single_dim 768, use_pallas_transition, bf16",
     dict(single_dim=768, dtype="bfloat16", use_pallas_transition=True),
     dict(rows_attention=4, tiled_attention=3, fused_transition=4), FORWARD_REL_TOL),
)


def phase_wide(seed: int) -> None:
    """The WIDE_CONFIGS configurations' forward at bucket 192, B=2, 2 blocks:
    exact launch counts, and the kernel route against the plain route."""
    from protein_redesign_tpu_torch.cli.common import SamplingRunner
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.models.prdiff import prepare_batch
    from protein_redesign_tpu_torch.ops import attention as A

    for tag, fields, expected, tol in WIDE_CONFIGS:
        net = perturbed_net(ModelConfig(num_blocks=2, **fields), seed).to("cuda").eval()
        _, batch = complex_batch(SamplingRunner(net, "cuda"))
        batch = prepare_batch(batch, 0.3, generator=torch.Generator("cuda").manual_seed(0))
        B, N = batch["residue_mask"].shape
        g = torch.Generator("cuda").manual_seed(1)
        z = torch.randn(B, N, 3, generator=g, device="cuda")
        seq_t = torch.randn(B, N, 21, generator=g, device="cuda")
        mask, t = batch["residue_and_atom_mask"], torch.tensor([5, 40], device="cuda")
        forward = lambda: net(batch, z, seq_t, mask, t)  # noqa: E731
        with torch.inference_mode():
            A.reset_launch_counts()
            kernel_out = forward()
            torch.cuda.synchronize()
            launches = dict(A.LAUNCHES)
            kernel_ms = cuda_ms(forward, 1, 3)
            with A.plain_route():
                plain_out = forward()
                plain_ms = cuda_ms(forward, 1, 3)
        if launches != launch_record(**expected):
            raise AssertionError(f"{tag}: launches {launches}")
        rels = []
        for name, a, b in zip(("noise_pred", "seq_pred"), kernel_out, plain_out):
            rels.append(float((a.float() - b.float()).norm() / b.float().norm()))
            if not (torch.isfinite(a).all() and rels[-1] <= tol):
                raise AssertionError(f"{tag} {name}: relative error {rels[-1]} > {tol}")
        print(f"[wide] {tag}, 2 blocks, B={B}, bucket {N}: launches "
              f"{({k: v for k, v in launches.items() if v})}; ||kernel - plain|| / ||plain|| = "
              f"{rels[0]:.3e} / {rels[1]:.3e} (tol {tol:g}); forward {kernel_ms:.2f} ms, plain "
              f"route {plain_ms:.2f} ms")
        del net


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of weights and synthetic data")
    args = parser.parse_args()
    name, smi = phase_device()
    from protein_redesign_tpu_torch.models.prdiff import ModelConfig

    phase_build()
    phase_fused_breakdown()
    record = phase_kernels()
    record["rows_attention_bwd"] = phase_k7()
    net = perturbed_net(ModelConfig()).to("cuda").eval()
    print(f"[forward] ModelConfig(): single {net.cfg.single_dim}, pair {net.cfg.pair_dim}, "
          f"{net.cfg.num_heads} heads x {net.cfg.head_dim}, {net.cfg.num_blocks} blocks, "
          f"{net.cfg.dtype}")
    phase_forward(net)
    phase_generate(net)
    del net
    phase_grad(args.seed)
    launches = phase_train(args.seed)
    phase_h64(args.seed)
    record.update(phase_kchunk_kernels())
    net = perturbed_net(ModelConfig()).to("cuda").eval()
    long_launches = phase_generate_long(net)
    del net
    phase_forward_long(args.seed)
    phase_grad_long(args.seed)
    phase_grad_2048(args.seed)
    train_long = phase_train_long(args.seed)
    train_512 = phase_train_long(args.seed, TRAIN_F32_512)
    record.update(phase_fused_kernels())
    net = fused_net().to("cuda").eval()
    phase_forward(net, tag="fused-forward")
    del net
    phase_fused_forward_large(args.seed)
    phase_fused_grad(args.seed)
    net = perturbed_net(ModelConfig()).to("cuda").eval()
    fused_generate = phase_generate(net, flags=[f"--{f}" for f in FUSED], tag="fused-generate")
    del net
    phase_fused_train(args.seed)
    record.update(phase_fast_kernel())
    served = phase_serving(args.seed)
    served_f32 = phase_fast_f32(args.seed)
    net = perturbed_net(ModelConfig(fast_softmax=True, use_pallas_bwd=False)).to("cuda").eval()
    phase_forward(net, tag="fast-forward")
    phase_forward(net, tag="fast-forward-384", bucket=384)
    del net
    phase_wide(args.seed)
    # each kernel's launches on its own main path: K1, K2 and K7 on the train
    # CLI at 192/384, K3 on generation at 2048, K5 and K6 on training at 1024,
    # K8-K11 on generation with the four switches at 192, K1 fast on serving
    launches.update(rows_attention_kchunk=long_launches["rows_attention_kchunk"],
                    rows_attention_kchunk_stats=train_long["rows_attention_kchunk_stats"],
                    rows_attention_kchunk_bwd=train_long["rows_attention_kchunk_bwd"],
                    rows_attention_fast=served["rows_attention_fast"],
                    **{k: fused_generate[k] for k in FUSED_NAMES})
    loaded = sorted(m for m in ("jax", "flax", "protein_redesign_tpu") if m in sys.modules)
    if loaded:
        raise AssertionError(f"the port's run imported {loaded}")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
         "launches": launches[k], **{key: record[k][key] for key in keys}}
        for k in REPLACES
    ]
    # K1 and K2 in f32 on their 3xTF32 bodies: launches on the f32 train CLI
    # at 512; K1 fast in f32 on the f32 served request
    f32_launches = {"rows_attention_f32": train_512["rows_attention"],
                    "tiled_attention_f32": train_512["tiled_attention"],
                    "rows_attention_fast_f32": served_f32["rows_attention_fast"]}
    kernels += [
        {"name": k, "route": "cuda", "source": source, "replaces": REPLACES[kernel],
         "launches": f32_launches[k], **{key: record[k][key] for key in keys}}
        for k, (kernel, source) in F32_BODIES.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
