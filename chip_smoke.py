"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: CUDA is required; prints the card's name and power limit.
2. Build: nvcc builds the attention kernels from the sources in the
   checkout (protein_redesign_tpu_torch/kernels/csrc) into
   protein_redesign_tpu_torch/kernels/_build; prints the build time and
   ptxas's registers and spills of K8's, K9's, K10's and K11's tensor-core
   kernels (fused_gated_mma.cu, trimul_mma.cu, transition_mma.cu,
   outer_mma.cu) and of K1 fast's f32 body (attention_tf32.cu), then K8's,
   K9's, K10's (pair_fc and single_fc) and K11's device time by CUDA kernel
   at the fused configuration's shape (torch.profiler, first in the
   process).
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
   width (GRAD_BLOCKS blocks), B=2, bucket 192, kernel route against plain
   route, in f32 and
   bf16, and in f32 at bucket 512, B=1 (a seeded 460-residue sequence and
   imatinib), with exactly 4 K1, 2 K2 and 2 K7 launches a block per
   micro-step (remat: 2 + 2 K1, 1 + 1 K2, and one K2 more for
   SPAttention); the kernel route's device time per
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
11. Forward at 1024: the f32 net (LONG_BLOCKS blocks) at bucket 1024, B=1,
   kernel route against plain route (2 K3 a block and one K2 a block plus
   one per forward), with the kernel route's device time by kernel group.
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
   and at single_fc 768 in both dtypes; K11 likewise (outer_mma.cu against
   outer.cu) in f32 and bf16 and at pair width 128 in bf16, and at bucket
   512, B=1, in both dtypes; K8 at the
   h64x1 and h64x4 head layouts (bf16, against its plain version and the
   unfused GatedAttention).
14. The fused configuration (the four switches use_pallas_{trimul,transition,
   outer,fused_gated} on): the paper-width bf16 forward at bucket 192, B=2,
   kernel route against plain route, exactly 24 K8, 24 K9, 24 K10, 12 K11,
   13 K2 and no K1 per forward, and its device time by kernel group (K11's
   time all in outer_mma_kernel, none in outer.cu's); the forward at bucket
   512, B=1 (K9's N^3), likewise; the f32 whole gradient at 192,
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
   --ddim_steps SERVE_STEPS (20) over a 1000-step schedule, --batch_size 2
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
18. Sequence design (run after phase 8, whose final Gaussian checkpoint it
   keeps): ModelConfig() with seq_process="absorbing" and self_cond=True,
   bf16, bucket 192. A forward with a live estimate (sc_flag 1, a seeded
   z_sc) and one micro-step whose coin runs the first pass, kernel route
   against plain route (2e-2 and 5e-2); the train CLI with --seq_process
   absorbing --self_cond on phase 8's data, 2 optimizer steps of 2 x 2
   (its coins printed, exact K1/K2/K7 launches: each micro-step's plus one
   forward for each first pass, the validation's one or two); on its
   checkpoint the generate CLI (DDPM absorbing, 64 steps, --reveal_schedule
   cosine --reveal_temperature 0.5), the serve CLI (one request, DDIM 10,
   2 samples, --reveal_conf_noise 0.5) and both batch CLIs (a 2-entry FASTA:
   lysozyme 1-110 with an X run and a seeded second chain, imatinib, 2
   samples each, DDIM 10, --mask_prob 0: every X committed to a real
   residue, every other residue kept); the share of committed identities on
   which the kernel and plain routes agree (printed, not gated); then
   --seq_reverse ancestral, DDPM (8 steps) and DDIM (4, eta 1), on phase
   8's checkpoint. Wall and s per step of each run; the phase's wall time.
   Also on the design checkpoint: the absorbing Picard sampler
   (deterministic reveal, ptol 0; the net without self_cond, whose
   estimate-free function it computes) against the sequential absorbing
   DDIM, the share of equal commitments printed; and the offline CLIs:
   export_params on the train checkpoint, the generate CLI from the export
   and from the checkpoint directory with one seed, equal byte for byte,
   evaluate over that output (every group with TM-scores), and
   preprocess_pdbbind --limit 2 --device cuda over a two-complex PDBbind
   layout written from --seed.
19. Parallel-in-time DDIM (Picard): ModelConfig() at paper width, bucket
   192, B=1, on a checkpoint written by the port, over a 1000-step
   schedule. bf16: the generate CLI with --sampler ddim --eta 0
   --ddim_steps 20 (PICARD_STEPS), and --sampler ddim_parallel --window 8 at --ptol 0, at
   --ptol 1e-3 and at --ptol 1e-3 --coarse_init 5, each with exact K1 and
   K2 launches (the per-forward counts times the sweeps plus the coarse
   steps); each run again through the same runner under torch.profiler
   (sweeps, nfe, s per sample, device busy time; the same sweeps as the
   CLI's). The ptol-0 run ends below the 2S + 2 cap and agrees with the
   sequential one within PICARD_POS_TOL (Å) and PICARD_LOGIT_TOL; f32
   (3xTF32 kernels): the sequential and ptol-0 runs within 1e-3 Å or
   PICARD_CONTROL times the one-ulp response, the larger. First, each
   fused kernel (K8-K11) must repeat its bits at a sweep's shape, and
   Picard at ptol 0 with all four switches must end below the cap.
20. Query-chunked attention where the plan leaves the kernels: the h64x4
   layout with fast_softmax at paper width, bf16. One forward at bucket
   1024, B=1 (the plan's chunk 128) against the same weights unchunked:
   relative norm, ms and peak memory of each, no attention kernel; one
   training micro-step of 2 blocks at 768 (chunk 128): the whole gradient
   against the unchunked one, ms and peak memory of each.
21. ESM-2 and the JAX CLIs' single-device switches (needs transformers).
   An ESM-2 650M directory in the HF layout (esm2_t33_650M_UR50D's shape,
   weights from --seed, a tokenizer of the ESM alphabet); the port's
   encoder (models/esm2.py) in f32 (TF32 off) against HF's EsmModel on the
   card within 1e-5 relative norm and in bf16 against its f32 within 2e-2,
   on lysozyme 1-110 with ten residues masked (112 tokens) and a seeded
   1022-residue sequence (1024 tokens); ms per embedding (best of 3 warm,
   CUDA events) of the port's f32 and bf16 and HF's f32, each beside its
   bound, and HF's f32 on the host CPU at 112 tokens. The generate CLI with
   --require_esm on that directory at bucket 192, 2 samples, 64 DDPM steps,
   with --esm_backend jax and torch: the embedder on the card, nonzero
   features that agree across the backends within 1e-5, exact K1 and K2
   launches, main() wall beside the same run without ESM just before and
   phase 5's. The serving net (bf16,
   fast_softmax, use_pallas_bwd off) for one DDIM step at 192 through the
   generate CLI: no attention kernel under the default plan, 24 K1 fast and
   13 K2 with --use_pallas and with --pallas_auto_min_n 192, each reaching
   the config. --trimul_dmajor: the paper-width forward at 192 and 384, B=2,
   bf16 and f32, against the same weights without it within the forward
   gates, both routes' device time. --profile: the train CLI at 192 for 2
   optimizer steps writes a non-empty torch.profiler trace with the card's
   kernels under <save_dir>/profile, exact launches.
22. Multi-device on this one card (ModelConfig(), bf16, bucket 192, lysozyme
   1-110 + imatinib): --num_devices past the visible cards makes the train
   and generate CLIs exit non-zero with the JAX CLIs' message; the train CLI
   on a mini dataset, batch 2, 2 steps, on one rank in this process (exact
   launches) and on two ranks sharing cuda:0 over gloo (--num_devices 2
   --device cuda:0, PRD_DIST_BACKEND=gloo): both ranks' losses and
   parameter checksums equal, step 1's loss and grad_norm within
   GRAD_REL_TOL of one rank's, one metrics row a step with the all-reduce's
   bytes and seconds, one checkpoint, each rank's launches (a row each),
   rank 0's profiler trace counting its K1, K2 and K7 (phase 23 resumes
   its checkpoint); the CLI under the JAX cluster variables at world size 1 with
   the default backend (nccl joins and all-reduces on the card). Then
   SamplingRunner on a 2-replica mesh (make_mesh([cuda:0, cuda:0])) against
   one device at one seed: DDIM SERVE_STEPS at batch 2 within FORWARD_REL_TOL, and
   Picard in f32 at ptol 0 (DDIM 20, window 8, B = 2: 16 rows a sweep, 8 a
   replica), the sweeps within MULTI_SWEEP_TOL and the sample within phase
   19's f32 gate (PICARD_CONTROL), each replica's launches; one f32 forward through the
   replicas against the net within 1e-5. Times here
   are the overhead of sharing one card, not scaling. (The same comparison
   of one and two ranks in f32, callable alone:
   _multi_train(tmp, seed, "float32", 1, profile=False).)
23. The model axis on this one card, and the kernels' widths (paper
   width, bf16, after phase 22 and on its data): K9 and K11 at pair widths
   36 and 192 on their wide bodies, K7 and K6 at head width 256 in both
   dtypes and K3/K5 in f32, each against its plain version at the fused
   and attention gates with its device time, bound and SDPA's time, the
   paper-width K9 and K11 rows timed again (5%), and a fused bf16 net at
   pair width 36; FSDP: the train CLI with --num_devices 2 --mesh_shape 1,2
   --device cuda:0 over gloo resuming phase 22's (2, 1) checkpoint for 2
   steps, its first step against one rank resuming the same checkpoint
   within GRAD_REL_TOL, equal losses and whole checksums, each rank's
   bytes of parameters, EMA and moments, rank 0's trace of K1, K2 and K7,
   and the generate CLI on its checkpoint; --param_dtype bfloat16: the
   train CLI on one rank, the checkpoint's dtypes (f32 LayerNorms only),
   the generate CLI on it, K1, K2 and K7 launched; sequence parallelism:
   two gloo ranks on cuda:0 as one model group (bf16, remat,
   SP_STEP_BLOCKS blocks) against one rank on a model axis of 1, the loss
   and whole gradient within GRAD_REL_TOL, peak memory a rank at 384 and
   for a forward at 1024, and no kernel launched.
24. The installed port: a wheel of the checkout (pyproject.toml, README.md
   and both packages copied to a temporary directory; pip wheel
   --no-build-isolation, then pip install --target, both without an index;
   the wheel needs setuptools), the installed port made read-only. A process
   outside the checkout whose PYTHONPATH holds the install directory only
   loads phase 2's library through PRD_TORCH_KERNEL_DIR with no rebuild and
   reports the user cache as the build directory it would take without the
   variable; the installed prd-torch-generate (ModelConfig(), seeded and
   perturbed weights, bucket 192, 2 samples, INSTALLED_STEPS DDPM steps)
   writes files bit-equal to the checkout's generate CLI with the same seed
   and flags. ProteinReDiffModel(ModelConfig(), device="cuda") samples at
   bucket 192, B=2, bit-equal to the free sample with the same generator
   seed, with exact K1 and K2 launches. Then one line of MFU: the analytic
   FLOPs of utils/flops.denoiser_forward_flops over the profiled busy time
   of phase 4's bf16 forward at 192 and phase 15's fast forward at 384,
   against the H100's dense bf16 peak.
Each phase's wall is printed as [wall] <phase>: N s, and the whole run's.

Each main path (phases 5, 8, 10, 12's train CLIs, 14's generate and train
CLIs, 15's train and serve CLIs, 17's serve CLI, 18's CLIs, 19's generate
CLI and sampler runs, 21's generate and train CLIs, and 22's train CLI and
runners, 24's facade sample) runs with every launch count set to 0 just
before it and read just after; the f32 train CLI at 512
gives the launches of K1's and K2's f32 entries in the kernels' record, the
f32 served request K1 fast's. Every kernel's time and
the library call's come from CUDA events; the bound is the larger of the
operations this run's data needs (a query against its row's unmasked keys)
over the card's peak for the dtype (f32: 3xTF32 on the tensor cores) and
the bytes moved once over 3.35 TB/s (the peaks are utils/flops.py's);
beside it the exponentials' floor, one per logit at 16 per SM and clock.
The last three lines of standard output are the kernels' JSON record, the
card's name and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
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

# The H100's dense peaks and memory rate (NVIDIA's data sheet, 700 W), by
# compute dtype; the exponentials' rate a clock on each SM.
from protein_redesign_tpu_torch.utils.flops import (  # noqa: E402
    EXP_PER_SM_CLOCK,
    F32_CUDA_CORE_FLOPS,
    HBM_BYTES_PER_S,
    PEAK_FLOPS,
)

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
           "fused_outer_linear": CSRC + "outer_mma.cu"}
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
SERVE_STEPS, SERVE_SCHEDULE, SERVE_LONG, SERVE_OVERSIZED = 20, 1000, 330, 360
# Depth of the paper-width nets of the gradient phase (7) and of the f32
# forward and micro-step at 1024 (11): cut from 12 so that the whole smoke
# stays within its time limit (PERF.md §4 lists the cuts and the walls).
GRAD_BLOCKS, LONG_BLOCKS = 4, 4
# The JAX package's recommended training layout, one head of width 64
# (`protein_redesign_tpu/models/denoiser.py:513-519`): K1 and K7 at C = 64.
H64 = dict(head_dim=64, num_heads=1)
# The bf16 micro-step at bucket 2048 (phase 12): paper widths, depth cut to
# two FoldingBlocks for the time limit.
GRAD_2048_BLOCKS = 2
# f32 training below the K-chunk switch at bucket 512 (phases 7 and 12):
# (bucket, residues of a seeded sequence), 497 nodes with imatinib.
TRAIN_F32_512 = (512, 460)
# Parallel-in-time DDIM (phase 19): DDIM steps (20, where the served
# stack takes 50, to keep the whole run inside its time limit with phase
# 22), the Picard window, the coarse warm start's steps; the served
# schedule (SERVE_SCHEDULE) and shape
# (lysozyme and imatinib, bucket 192, B = 1). The tol-0 Picard run against
# the sequential DDIM run with the same draws, largest |difference| of the
# positions in Å and ||difference|| / ||sequential|| of the logits: in f32
# (3xTF32 kernels) the arithmetic's reordering only, which the trajectory
# amplifies as it amplifies any rounding, so the f32 gate widens to
# PICARD_CONTROL times the difference that one ulp more on the initial
# coordinates makes to the sequential run, where that is larger (seeded
# random weights drive the coordinates to ~3e4 Å, where one f32 ulp is
# 2e-3 Å); in bf16 also the net's rounding at batch W (Picard) against
# batch 1 (sequential). Measured runs put Picard at 0.5-1.1 times that
# one-ulp response, so PICARD_CONTROL = 3 leaves room for their spread and
# fails a drift several times the rounding's.
PICARD_STEPS, PICARD_WINDOW, PICARD_COARSE = 20, 8, 5
PICARD_POS_TOL = {"float32": 1e-3, "bfloat16": 0.5}
PICARD_LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
PICARD_CONTROL = 3.0
# Query-chunked attention (phase 20): the h64x4 layout with fast_softmax in
# bf16, whose attention plan leaves the kernels and chunks queries by 128
# from bucket 768 (forward at 1024: the logits pass the plan's 4 GB line;
# gradient at 768, depth cut to CHUNK_GRAD_BLOCKS); (bucket, residues).
H64X4 = dict(head_dim=64, num_heads=4, fast_softmax=True)
CHUNK_FORWARD, CHUNK_GRAD, CHUNK_GRAD_BLOCKS = (1024, 960), (768, 720), 2
# ESM-2 and the JAX CLIs' single-device switches (phase 21). The published
# esm2_t33_650M_UR50D shape (facebook/esm2_t33_650M_UR50D's config.json),
# weights from --seed; inputs lysozyme 1-110 with ESM_MASKS <mask> residues
# (112 tokens) and a seeded ESM_LONG-residue sequence (1024 tokens, ESM-2's
# longest). The port's f32 encoder (TF32 off) against HF's within
# ESM_F32_TOL relative norm, its bf16 one against its f32 within
# ESM_BF16_TOL; f32 GEMMs without TF32 run on the CUDA cores, whose dense
# peak is 67 TFLOP/s (NVIDIA's data sheet, H100 SXM).
ESM2_650M = dict(vocab_size=33, hidden_size=1280, num_hidden_layers=33, num_attention_heads=20,
                 intermediate_size=5120, max_position_embeddings=1026,
                 position_embedding_type="rotary", token_dropout=True,
                 emb_layer_norm_before=False, layer_norm_eps=1e-5, pad_token_id=1,
                 mask_token_id=32, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
ESM_MASKS, ESM_LONG = 10, 1022
# DDPM steps of phase 21's generate runs (ESM-2 on the card in each; cut
# from STEPS: the sampler's steps are phase 5's)
ESM_GENERATE_STEPS = 8
ESM_F32_TOL, ESM_BF16_TOL = 1e-5, 2e-2
# The installed copy (phase 24): DDPM steps of its generate CLI run.
INSTALLED_STEPS = 4


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


def device_ms(fn, iters: int = 3, spin: int = 100_000_000) -> float:
    """ms of device time per call of ``fn``: CUDA events around ``iters``
    calls queued behind a spin on the card (``torch.cuda._sleep`` of
    ``spin`` cycles, ~0.05 s by default; the calls' host time must fit in
    it), so that the events time the kernels back to back and not the host's
    launch path, which bounds a small kernel's CUDA-event time. (A short
    torch.profiler window loses kernels once the process has run a while:
    K1 at 192 read 0.079, 0.052, 0.026 ms, then nothing, through phase 7.)"""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def body_times(name, q, k, v, mask, bias, scale, **backward) -> str:
    """The two bodies of K1, K1 fast, K2, K3, K5, K7 (``dout`` given) or K6
    (``dout``, ``out``, ``m`` and ``logs`` given) on the same inputs (bf16
    or f32), each one launch without autograd: the tensor-core body's
    CUDA-event ms per call and device ms per call; the CUDA-core body's
    device ms of one call after a warm one (PERF.md §6 keeps its earlier
    times; at 2048 a K-chunk call takes 0.45-1.2 s)."""
    from protein_redesign_tpu_torch.ops import attention as A

    iters = 2 if name in A.KCHUNK_FORWARDS + ("rows_attention_kchunk_bwd",) else 10
    fn = lambda mma: lambda: A.attention_body(name, q, k, v, mask, bias, scale,  # noqa: E731
                                              mma=mma, **backward)
    return (f"tensor-core body {cuda_ms(fn(True), 1, iters):.4f} ms, on the device "
            f"{device_ms(fn(True), min(iters, 3)):.4f} ms; CUDA-core body on the device "
            f"{device_ms(fn(False), 1):.4f} ms")


def bound(flops: float, nbytes: float, dtype) -> dict:
    """The least time the card could take: operations over the dtype's peak
    or bytes over the HBM rate, whichever is larger."""
    peak = PEAK_FLOPS[str(dtype).removeprefix("torch.")]
    ops_s, bytes_s = flops / peak, nbytes / HBM_BYTES_PER_S
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


def library_ms(q, k, v, mask, bias, scale, dout=None, report: bool = False):
    """ms of one torch.nn.functional.scaled_dot_product_attention call on the
    same inputs (the memory-efficient backend, or the cuDNN one where it
    refuses the inputs, or the math one where both do, as they do a bf16
    head of C = 4 mod 8; the key mask as an additive -2^15 term), forward
    and backward when ``dout`` is given: the library yardstick, which the
    port never calls. None where all three refuse the inputs. ``report``:
    (ms, the backend's name)."""
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

    for backend in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                ms = cuda_ms(call, 1, 3)
        except RuntimeError as e:
            print(f"[library] scaled_dot_product_attention ({backend.name}) refused "
                  f"{tuple(q.shape)} {q.dtype}: {str(e).splitlines()[0][:160]}")
            continue
        if backend != SDPBackend.EFFICIENT_ATTENTION and not report:
            print(f"[library] {tuple(q.shape)} {q.dtype}: timed the {backend.name} backend")
        return (ms, backend.name) if report else ms
    return (None, "none") if report else None


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
        last = sorted(lib.source_seconds.items(), key=lambda kv: -kv[1])[:3]
        print(f"[build] nvcc built {lib.path.name} in {lib.build_seconds:.1f} s, "
              f"{len(lib.source_seconds)} sources in parallel; the last to end: "
              + ", ".join(f"{src} at {s:.1f} s" for src, s in last))
    spills = [line.strip() for line in lib.build_log.splitlines()
              if "spill" in line and not line.strip().startswith("0 bytes stack")]
    if spills:
        print(f"[build] ptxas reports spills in {len(spills)} instantiations")
    for source in ("fused_gated_mma.cu", "fused_gated_wide.cu", "trimul_mma.cu",
                   "trimul_wide_mma.cu", "transition_mma.cu", "outer_mma.cu",
                   "attention_tf32.cu", "attention_kchunk_wide_tf32.cu",
                   "attention_bwd_wide_tf32.cu", "attention_bwd_wide_mma.cu"):
        for name, regs, stores, loads in ptxas_report(lib.build_log, source):
            if source.startswith("attention") and not ("fast" in name or "wide" in name):
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
    """K8, K9, K10 and K11 by CUDA kernel at the fused configuration's shape
    (bucket 192, B=2, paper width: K8 h16x4 at D = 64, K9 outgoing, K10
    pair_fc and single_fc, K11 512 -> 64, and K11 at pair width 128 and at
    bucket 512, B=1), and K8's split route and K8 and K9 past pair width
    128 at phase 23's rows, bf16 and f32, seeded random weights: device time per
    kernel from torch.profiler (K11's call with its LayerNorm and u), run
    first in the process (a profiler window later in a long run loses
    kernels)."""
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.ops import outer as O
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
        ow, ow128 = ((torch.randn(d, 2 * 512, generator=g, device="cuda") * 1024 ** -0.5,
                      torch.randn(d, generator=g, device="cuda")) for d in (D, 2 * D))
        single512 = torch.randn(1, 512, 512, generator=g, device="cuda").to(dtype)
        label = str(dtype).replace("torch.", "")
        with torch.inference_mode():
            for name, fn in (("fused_gated_rows_attention", lambda: A.fused_gated(pair, mask, *gw, H)),
                             ("triangle_multiply", lambda: M.trimul(pair, mask, *tw, "outgoing")),
                             ("fused_transition pair_fc",
                              lambda: T.transition(pair, *mlps["pair_fc"])),
                             ("fused_transition single_fc",
                              lambda: T.transition(single, *mlps["single_fc"])),
                             ("fused_outer_linear", lambda: O.outer(single, *ow)),
                             ("fused_outer_linear D=128", lambda: O.outer(single, *ow128)),
                             ("fused_outer_linear bucket 512, B=1",
                              lambda: O.outer(single512, *ow))):
                parts = device_time_by_kernel(fn)
                print(f"[fused-breakdown] {name} {label}, device time by kernel: "
                      + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                  sorted(parts.items(), key=lambda kv: -kv[1])))
    # the wide routes of phase 23 (147 nodes valid): K8's split route at
    # (128, 8, 128), its projection past 128 at (192, 4, 16), K9 at 192
    mask2d = _widths_mask2d()
    for dtype in (torch.bfloat16, torch.float32):
        label = str(dtype).replace("torch.", "")
        split, wide = (_k8_args(*w, dtype, mask2d, 1) for w in ((128, 8, 128), (192, 4, 16)))
        k9 = _k9_args(192, dtype, "outgoing", mask2d, 1)
        with torch.inference_mode():
            for name, fn in (("fused_gated_rows_attention (128, 8, 128), split",
                              lambda: A.fused_gated(*split)),
                             ("fused_gated_rows_attention (192, 4, 16)", lambda: A.fused_gated(*wide)),
                             ("triangle_multiply D=192", lambda: M.trimul(*k9, "outgoing"))):
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


def complex_batch_data(runner, sequence: str = SEQUENCE) -> dict:
    """One featurized complex of ``sequence`` and imatinib, ESM features zero."""
    from protein_redesign_tpu_torch.cli.common import complex_data, load_protein_arg, parse_ligand_arg

    protein = load_protein_arg(sequence)
    esm = np.zeros((len(protein.aatype), runner.net.cfg.esm_dim), np.float32)
    return complex_data(protein, parse_ligand_arg(LIGAND), esm)


def complex_batch(runner, batch_rows: int = 2, sequence: str = SEQUENCE):
    return runner.collate([complex_batch_data(runner, sequence)] * batch_rows)


def forward_inputs(net, bucket: int = 192) -> tuple:
    """The net's inputs at ``bucket`` (192: lysozyme and imatinib; 384: a
    seeded SERVE_LONG-residue sequence and imatinib), B=2, from fixed seeds.
    A self-conditioned net takes a live estimate: sc_flag 1 and a seeded,
    nonzero z_sc."""
    from protein_redesign_tpu_torch.cli.common import SamplingRunner
    from protein_redesign_tpu_torch.models.prdiff import prepare_batch

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
    sc = ((torch.randn(B, N, 3, generator=g, device="cuda"), torch.ones(B, device="cuda"))
          if net.cfg.self_cond else ())
    return (batch, z, seq_t, mask, t, *sc)


# Each forward's device busy ms (torch.profiler), B, bucket and config, by tag.
FORWARD_BUSY: dict = {}


def phase_forward(net, tag: str = "forward", bucket: int = 192,
                  tol: float = FORWARD_REL_TOL) -> None:
    """The net's forward on ``forward_inputs(net, bucket)``, kernel route
    against plain route within ``tol``, its exact launches and device time
    by group."""
    from protein_redesign_tpu_torch.ops import attention as A

    inputs = forward_inputs(net, bucket)
    B = inputs[0]["residue_mask"].shape[0]

    def forward(plain: bool):
        if not plain:
            return net(*inputs)
        with A.plain_route():
            return net(*inputs)

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
    check_outer_body(net.cfg, busy, tag)
    FORWARD_BUSY[tag] = (sum(busy.values()), B, bucket, net.cfg)
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
          ("transition_kernel", "K10 transition"), ("outer_mma", "K11 outer (tensor cores)"),
          ("outer_kernel", "K11 outer"),
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


def check_outer_body(cfg, busy: dict, tag: str) -> None:
    """K11's two bodies add to one launch count, so the profiler tells which
    ran: with the fused OuterLinear on at the paper's widths, the forward
    must have run outer_mma_kernel and no outer_kernel."""
    if not cfg.use_pallas_outer:
        return
    mma, core = busy.get("K11 outer (tensor cores)", 0.0), busy.get("K11 outer", 0.0)
    if not (mma > 0 and core == 0):
        raise AssertionError(f"[{tag}] K11 ran outer_mma_kernel for {mma} ms and outer_kernel "
                             f"for {core} ms: its tensor-core body must take every launch")


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


# Each generate run's main() wall time (s) and the config its net ran, by tag.
GENERATED: dict = {}


def phase_generate(net, flags=(), tag: str = "generate", cfg=None, steps: int = STEPS) -> dict:
    """The generate CLI on ``net``'s weights with ``flags``: lysozyme and
    imatinib, 2 samples in one batch, ``steps`` DDPM steps unless the flags
    choose another sampler; the output files and the exact launches of
    every forward under ``cfg`` (default: the net's config with each
    switch in ``flags`` on)."""
    from protein_redesign_tpu_torch.cli.generate import main
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.utils.weights import save_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_checkpoint(tmp / "ckpt", net.state_dict(), net.cfg)
        argv = ["-c", str(tmp / "ckpt"), "-o", str(tmp / "out"), "-p", SEQUENCE, "-l", LIGAND,
                "-n", "2", "--batch_size", "2", "--num_steps", str(steps), "--device", "cuda",
                *flags]
        A.reset_launch_counts()
        began = time.perf_counter()
        runner = main(argv)
        wall = time.perf_counter() - began
        timings = runner.timings
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
    forwards = sum(steps for _, _, steps, _ in timings)
    cfg = cfg or net.cfg.replace(**{f.lstrip("-"): True for f in flags})
    expected = {k: forwards * v for k, v in forward_launches(cfg).items()}
    if launches != expected:
        raise AssertionError(f"generate launches {launches} != {expected}")
    GENERATED[tag] = {"wall": wall, "cfg": runner.net.cfg}
    for bucket, rows, steps, seconds in timings:
        print(f"[{tag}] bucket {bucket}, {rows} samples per batch: {steps} {runner.sampler} "
              f"steps in {seconds:.3f} s = {seconds / steps:.4f} s/step")
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


def time_micro_step(tag: str, step) -> None:
    """One micro-step's time on the kernel route and the plain route, and the
    kernel route's device time by kernel group."""
    from protein_redesign_tpu_torch.ops import attention as A

    with A.plain_route():
        plain_ms = cuda_ms(step, 1, 2)
    kernel_ms = cuda_ms(step, 1, 3)
    busy = device_time_by_group(step, iters=3)
    total = sum(busy.values())
    print(f"[grad] {tag} (loss + backward, remat), tensor-core bodies: kernel route "
          f"{kernel_ms:.2f} ms, plain route {plain_ms:.2f} ms; kernel route device time "
          f"{total:.2f} ms busy ({1 - total / kernel_ms:.1%} idle); "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(busy.items(), key=lambda kv: -kv[1])))


def grad_check(net, batch: dict, noise, tag: str) -> None:
    """The whole parameter gradient of one micro-step, kernel route against
    plain route, and its exact launches (with a self-conditioning coin that
    runs the first pass, one forward more)."""
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
    if net.cfg.self_cond and noise.sc_coin < 0.5:  # the first pass: a forward without gradient
        expected = {k: v + forward_launches(net.cfg, n=N)[k] for k, v in expected.items()}
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
    kernel route's time per micro-step, by kernel group: f32 at 192 and 512,
    bf16 at 192 and 384 (the f32 steps on K1's and K2's CUDA-core bodies
    are in PERF.md §5, PR 10's; phase 3 still times those bodies)."""
    from protein_redesign_tpu_torch.config import ModelConfig

    for dtype in ("float32", "bfloat16"):
        net = perturbed_net(ModelConfig(dtype=dtype, training_mode=True, mask_prob=0.5,
                                        num_blocks=GRAD_BLOCKS), seed).to("cuda")
        batch = collated([synthetic_complex(SEQUENCE, seed + s, net.cfg.esm_dim) for s in (1, 2)],
                         192)
        noise = fixed_noise(batch, seed)
        grad_check(net, batch, noise, "paper width")
        if dtype == "float32":
            time_micro_step("f32 micro-step, B=2, bucket 192", lambda: micro_step(net, batch, noise))
            bucket, residues = TRAIN_F32_512
            b = collated([synthetic_complex(long_sequence(seed + 25, residues), seed + 25,
                                            net.cfg.esm_dim)], bucket)
            n = fixed_noise(b, seed)
            grad_check(net, b, n, "paper width")
            time_micro_step(f"f32 micro-step, B=1, bucket {bucket}", lambda: micro_step(net, b, n))
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


def phase_train(seed: int, keep: Path) -> dict:
    """The port's train CLI at paper width: 2 optimizer steps at bucket 192,
    then a resume for 2 steps at bucket 384. The final step's EMA weights
    and config are kept in ``keep`` (phase 18's gaussian checkpoint)."""
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
        (keep / "4").mkdir(parents=True)
        for name in ("config.json", "ema.pt", "state.json"):
            shutil.copy(run / "checkpoints" / "4" / name, keep / "4" / name)
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


# The design phase (18): the JAX package's sequence-design configuration,
# absorbing sequence diffusion with coordinate self-conditioning, at paper
# width in bf16; its DDIM runs take DESIGN_DDIM_STEPS steps. The batch CLIs'
# FASTA gives lysozyme residues X_RUN as X (designed) beside a second chain of
# CHAIN_B residues; the ancestral runs take ANCESTRAL_STEPS (a DDPM schedule
# of that length, then DDIM steps of the 64-step one, eta 1).
DESIGN = dict(seq_process="absorbing", self_cond=True)
DESIGN_DDIM_STEPS, X_RUN, CHAIN_B, ANCESTRAL_STEPS = 10, (30, 42), 90, (8, 4)


def _design_train(tmp: Path, seed: int) -> Path:
    """The train CLI with --seq_process absorbing --self_cond on phase 8's
    data at bucket 192: 2 optimizer steps of 2 x 2 micro-batches and the
    final validation. Exact launches: each micro-step's, one forward without
    gradient for each coin that ran the first pass, and the validation's
    one or two forwards. Returns the checkpoint directory."""
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
            "--seq_process", "absorbing", "--self_cond"]
    A.reset_launch_counts()
    began = time.perf_counter()
    state = train(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - began
    launches = main_path_launches()
    del state
    cfg = read_config(run / "checkpoints" / "2")
    metrics = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    steps = [m for m in metrics if "train_loss" in m]
    vals = [m for m in metrics if "val_loss" in m]
    if [m["step"] for m in steps] != [1, 2] or len(vals) != 1 or not all(
            math.isfinite(x) for x in [m["train_loss"] for m in steps] + [vals[0]["val_loss"]]):
        raise AssertionError(f"design train metrics.jsonl: {metrics}")
    if not (cfg.self_cond and cfg.seq_process == "absorbing"):
        raise AssertionError(f"design train checkpoint config {cfg}")
    passes = sum(int(m["sc_passes"]) for m in steps)
    val_passes = int(vals[0]["val_sc_passes"])
    micro, forward = forward_launches(cfg, remat=True), forward_launches(cfg)
    expected = {k: 4 * micro[k] + (passes + 1 + val_passes) * forward[k] for k in REPLACES}
    if launches != expected or not launches["rows_attention_bwd"]:
        raise AssertionError(f"design train launches {launches} != {expected}")
    for m in steps:
        print(f"[design-train] step {m['step']} bucket {int(m['bucket'])}: loss "
              f"{m['train_loss']:.4f}, grad_norm {m['grad_norm']:.4f}, {m['step_seconds']:.3f} s "
              f"per optimizer step (2 micro-batches of 2), {int(m['sc_passes'])} self-cond first "
              f"passes")
    print(f"[design-train] absorbing + self_cond: val_loss {vals[0]['val_loss']:.4f} "
          f"({val_passes} first pass); {passes} of 4 micro-batch coins ran the first pass; "
          f"main() wall {wall:.2f} s; launches {({k: v for k, v in launches.items() if v})} = 4 "
          f"micro-steps + {passes + 1 + val_passes} forwards without gradient")
    return run / "checkpoints"


def _design_grad(seed: int) -> None:
    """One self-conditioned micro-step (the coin runs the first pass) of the
    absorbing loss at paper width, bf16, B=2, bucket 192: the whole gradient,
    kernel route against plain route."""
    from protein_redesign_tpu_torch.config import ModelConfig

    net = perturbed_net(ModelConfig(training_mode=True, mask_prob=0.5, **DESIGN), seed).to("cuda")
    batch = collated([synthetic_complex(SEQUENCE, seed + s, net.cfg.esm_dim) for s in (1, 2)], 192)
    B, N = batch["residue_mask"].shape
    g = torch.Generator().manual_seed(seed + 3)
    noise = dataclasses.replace(fixed_noise(batch, seed), corrupt_u=torch.rand(B, N, generator=g),
                                sc_coin=0.0)
    grad_check(net, batch, noise, "design micro-step (absorbing, self-cond first pass)")
    del net


def _design_generate(ckpt: Path, out: Path, cfg, tag: str, extra: list, steps: int,
                     designed: bool) -> None:
    """The generate CLI on ``ckpt`` (lysozyme 1-110 and imatinib, 2 samples
    in one batch): the three output files, finite coordinates (every residue
    decoded where ``designed``: no X to strip), exact launches."""
    from protein_redesign_tpu_torch.cli.generate import main
    from protein_redesign_tpu_torch.ops import attention as A

    argv = ["-c", str(ckpt), "-o", str(out), "-p", SEQUENCE, "-l", LIGAND, "-n", "2",
            "--batch_size", "2", "--device", "cuda", *extra]
    A.reset_launch_counts()
    began = time.perf_counter()
    timings = main(argv).timings
    torch.cuda.synchronize()
    wall = time.perf_counter() - began
    launches = main_path_launches()
    pdb = (out / "sample_protein.pdb").read_text()
    coords = [[float(line[30:38]), float(line[38:46]), float(line[46:54])]
              for line in pdb.splitlines() if line.startswith("ATOM")]
    scores = [float(x) for x in (out / "sample_tmscores.txt").read_text().split()]
    want = 2 * len(SEQUENCE)
    if not (len(coords) == want if designed else 0 < len(coords) <= want) or not all(
            math.isfinite(c) for xyz in coords for c in xyz):
        raise AssertionError(f"[{tag}] {len(coords)} CA records or non-finite coordinates")
    if (out / "sample_ligand.sdf").read_text().count("$$$$") != 2 or len(scores) != 2 or not all(
            0.0 <= x <= 1.0 for x in scores):
        raise AssertionError(f"[{tag}] sample_ligand.sdf or TM-scores {scores}")
    expected = {k: steps * len(timings) * v for k, v in forward_launches(cfg).items()}
    if launches != expected:
        raise AssertionError(f"[{tag}] launches {launches} != {expected}")
    for bucket, rows, n, seconds in timings:
        print(f"[{tag}] bucket {bucket}, {rows} samples per batch: {n} steps in {seconds:.3f} s "
              f"= {seconds / n:.4f} s/step")
    print(f"[{tag}] {' '.join(extra)}: main() wall {wall:.2f} s; TM-scores {scores}; launches "
          f"{({k: v for k, v in launches.items() if v})}")


def _design_serve(ckpt: Path, tmp: Path, cfg) -> None:
    """One request (lysozyme and imatinib, 2 samples) to the serve CLI with
    DDIM absorbing and --reveal_conf_noise 0.5."""
    from protein_redesign_tpu_torch.cli.serve import main as serve
    from protein_redesign_tpu_torch.ops import attention as A

    reqs, results = tmp / "design_requests.jsonl", tmp / "design_results.jsonl"
    reqs.write_text(json.dumps({"id": "design", "protein": SEQUENCE, "ligand": LIGAND,
                                "num_samples": 2, "seed": 4}) + "\n")
    argv = ["-c", str(ckpt), "-o", str(tmp / "served"), "--sampler", "ddim", "--ddim_steps",
            str(DESIGN_DDIM_STEPS), "--reveal_conf_noise", "0.5", "--batch_size", "2",
            "--input", str(reqs), "--output", str(results), "--device", "cuda"]
    A.reset_launch_counts()
    began = time.perf_counter()
    runner = serve(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - began
    launches = main_path_launches()
    (line,) = [json.loads(x) for x in results.read_text().splitlines()]
    if "error" in line or [len(x) for x in line["sequences"]] != [len(SEQUENCE)] * 2 or not all(
            0.0 <= x <= 1.0 for x in line["tmscores"]):
        raise AssertionError(f"design serve: response {line}")
    for path in line["pdb_files"] + line["sdf_files"]:
        if not Path(path).is_file() or not Path(path).stat().st_size:
            raise AssertionError(f"design serve: missing output {path}")
    expected = {k: DESIGN_DDIM_STEPS * len(runner.timings) * v
                for k, v in forward_launches(cfg).items()}
    if launches != expected:
        raise AssertionError(f"design serve launches {launches} != {expected}")
    for bucket, rows, n, seconds in runner.timings:
        print(f"[design-serve] bucket {bucket}, {rows} samples per batch: {n} DDIM steps in "
              f"{seconds:.3f} s = {seconds / n:.4f} s/step")
    print(f"[design-serve] --sampler ddim --ddim_steps {DESIGN_DDIM_STEPS} --reveal_conf_noise "
          f"0.5: main() wall {wall:.2f} s (startup and 1 request); TM-scores {line['tmscores']}; "
          f"launches {({k: v for k, v in launches.items() if v})}")


def _design_batch(ckpt: Path, tmp: Path, cfg, seed: int) -> None:
    """Both batch CLIs on a 2-entry FASTA (lysozyme 1-110 with residues
    X_RUN given as X, and a seeded second chain), imatinib for each, 2
    samples each, DDIM absorbing: --mask_prob 0, so exactly the X positions
    are designable; each must be committed to a real residue and every other
    position keep its residue."""
    from protein_redesign_tpu_torch.cli.predict_batch_sequence import main as batch_sequence
    from protein_redesign_tpu_torch.cli.predict_batch_structure import main as batch_structure
    from protein_redesign_tpu_torch.ops import attention as A

    lo, hi = X_RUN
    inputs = {"lysozyme_x": SEQUENCE[:lo] + "X" * (hi - lo) + SEQUENCE[hi:],
              "chain_b": long_sequence(seed + 60, CHAIN_B)}
    fasta, smiles = tmp / "design.fasta", tmp / "design.smiles"
    fasta.write_text("".join(f">{k}\n{v}\n" for k, v in inputs.items()))
    smiles.write_text(f"{LIGAND}\n{LIGAND}\n")
    common = ["-c", str(ckpt), "-p", str(fasta), "-l", str(smiles), "-n", "2", "--batch_size", "2",
              "--sampler", "ddim", "--ddim_steps", str(DESIGN_DDIM_STEPS), "--mask_prob", "0.0",
              "--seed", str(seed), "--device", "cuda"]
    for tag, cli in (("design-batch-sequence", batch_sequence),
                     ("design-batch-structure", batch_structure)):
        out = tmp / tag
        A.reset_launch_counts()
        began = time.perf_counter()
        timings = cli(["-o", str(out), *common])
        torch.cuda.synchronize()
        wall = time.perf_counter() - began
        launches = main_path_launches()
        expected = {k: DESIGN_DDIM_STEPS * sum(forward_launches(cfg, n=b)[k] for b, *_ in timings)
                    for k in REPLACES}
        if launches != expected:
            raise AssertionError(f"[{tag}] launches {launches} != {expected}")
        if cli is batch_sequence:
            lines = (out / "sample_sequences.fasta").read_text().splitlines()
            designed = 0
            for header, seq in zip(lines[::2], lines[1::2]):
                given = inputs[header[1:].rsplit("_sample_", 1)[0]]
                if len(seq) != len(given) or "X" in seq or any(
                        a != b for a, b in zip(seq, given) if b != "X"):
                    raise AssertionError(f"[{tag}] {header}: {seq} from {given}")
                designed += given.count("X")
            if len(lines) != 8:
                raise AssertionError(f"[{tag}] sample_sequences.fasta: {lines}")
            what = (f"{designed} X positions all committed to real residues, every known "
                    f"residue kept")
        else:
            for name, given in inputs.items():
                scores = [float(x) for x in
                          (out / f"sample_tmscores_{name}.txt").read_text().split()]
                for i in range(2):
                    pdb = (out / f"sample_protein_{name}_model_{i}.pdb").read_text()
                    atoms = [a[30:54] for a in pdb.splitlines() if a.startswith("ATOM")]
                    if len(atoms) != len(given) or any("nan" in a.lower() for a in atoms):
                        raise AssertionError(f"[{tag}] {name} model {i}: {len(atoms)} CA records")
                    if not (out / f"sample_ligand_{name}_model_{i}.sdf").stat().st_size:
                        raise AssertionError(f"[{tag}] {name} model {i}: empty SDF")
                if len(scores) != 2 or not all(0.0 <= x <= 1.0 for x in scores):
                    raise AssertionError(f"[{tag}] {name}: TM-scores {scores}")
            what = "per-name PDB, SDF and TM-score files"
        for bucket, rows, n, seconds in timings:
            print(f"[{tag}] bucket {bucket}, {rows} samples per batch: {n} DDIM steps in "
                  f"{seconds:.3f} s = {seconds / n:.4f} s/step")
        print(f"[{tag}] main() wall {wall:.2f} s; {what}; launches "
              f"{({k: v for k, v in launches.items() if v})}")


def _design_route_agreement(ckpt: Path, seed: int) -> None:
    """The share of committed identities on which the kernel route and the
    plain route agree: DDIM absorbing, every residue designable (mask_prob
    1), lysozyme and imatinib, B=2. Printed, not gated: a bf16 difference
    can flip a ranking."""
    from protein_redesign_tpu_torch.cli.common import SamplingRunner
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.utils.weights import load_checkpoint

    state_dict, cfg = load_checkpoint(ckpt, num_steps=STEPS)
    net = ProteinReDiffNet(cfg.replace(training_mode=False))
    net.load_state_dict(state_dict)
    runner = SamplingRunner(net.to("cuda").eval(), "cuda", batch_size=2, mask_prob=1.0,
                            sampler="ddim", ddim_steps=DESIGN_DDIM_STEPS)
    datas = [complex_batch_data(runner)] * 2
    kernel = runner.run(datas, seed)
    with A.plain_route():
        plain = runner.run(datas, seed)
    n_lig = IMATINIB_ATOMS
    same = [np.argmax(k[1][n_lig:], -1) == np.argmax(p[1][n_lig:], -1)
            for k, p in zip(kernel, plain)]
    if not all(np.isfinite(r[0]).all() for r in kernel + plain):
        raise AssertionError("design route agreement: non-finite positions")
    print(f"[design-agreement] DDIM {DESIGN_DDIM_STEPS} absorbing, all {len(SEQUENCE)} residues "
          f"designed, 2 samples: the kernel and plain routes commit the same identity at "
          f"{float(np.mean(np.concatenate(same))):.1%} of the positions (not gated)")
    del net


def _design_picard(ckpt: Path, seed: int) -> None:
    """The absorbing Picard sampler (deterministic reveal, tol 0) on the
    design checkpoint's weights against the sequential absorbing DDIM with
    the same draws: every residue designable, lysozyme and imatinib, B = 2;
    the share of committed identities the two agree on (printed, not
    gated). Picard rejects self_cond, so the net is built without it and
    without embed_sc_dist: the self-conditioned net computes exactly this
    function where it has no estimate (sc_flag 0 adds exact zeros)."""
    from protein_redesign_tpu_torch.cli.common import SamplingRunner
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
    from protein_redesign_tpu_torch.utils.weights import load_checkpoint

    state_dict, cfg = load_checkpoint(ckpt, num_steps=STEPS)
    cfg = cfg.replace(training_mode=False, self_cond=False, reveal_temperature=0.0,
                      reveal_conf_noise=0.0)
    net = ProteinReDiffNet(cfg)
    net.load_state_dict({k: v for k, v in state_dict.items() if not k.startswith("embed_sc")})
    net.to("cuda").eval()
    out, stats = {}, None
    for sampler in ("ddim", "ddim_parallel"):
        runner = SamplingRunner(net, "cuda", batch_size=2, mask_prob=1.0, sampler=sampler,
                                ddim_steps=DESIGN_DDIM_STEPS, window=PICARD_WINDOW, ptol=0.0)
        out[sampler] = runner.run([complex_batch_data(runner)] * 2, seed)
        stats = runner.picard_stats or stats
    (stats,) = stats
    n_lig, cap = IMATINIB_ATOMS, 2 * DESIGN_DDIM_STEPS + 2
    same = [np.argmax(p[1][n_lig:], -1) == np.argmax(q[1][n_lig:], -1)
            for p, q in zip(out["ddim"], out["ddim_parallel"])]
    dpos = max(float(np.abs(p[0] - q[0]).max()) for p, q in zip(out["ddim"], out["ddim_parallel"]))
    if not all(np.isfinite(r[0]).all() for r in out["ddim_parallel"]) or stats["iterations"] >= cap:
        raise AssertionError(f"absorbing Picard: non-finite positions or {stats} at the cap {cap}")
    print(f"[design-picard] absorbing, DDIM {DESIGN_DDIM_STEPS}, window {PICARD_WINDOW}, ptol 0: "
          f"{stats['iterations']} sweeps (cap {cap}), nfe {stats['nfe']}; commitments equal to the "
          f"sequential absorbing DDIM's at {float(np.mean(np.concatenate(same))):.1%} of the "
          f"positions (not gated); max |positions difference| {dpos:.3e} A")
    del net


def _pdbbind_layout(root: Path, seed: int) -> Path:
    """A two-complex PDBbind layout (aspirin and an 8- and a 12-residue
    chain, coordinates from ``seed``), as tests/test_preprocess_cli.py
    builds one."""
    from protein_redesign_tpu_torch.chem.mol import mol_from_smiles, mol_to_sdf, update_mol_positions
    from protein_redesign_tpu_torch.chem.protein import protein_from_sequence, protein_to_pdb_file

    rng = np.random.RandomState(seed)
    for i, pdb_id in enumerate(("1abc", "2xyz")):
        src = root / "PDBbind_processed" / pdb_id
        src.mkdir(parents=True)
        mol = mol_from_smiles("CC(=O)Oc1ccccc1C(=O)O")
        mol = update_mol_positions(mol, rng.randn(mol.num_atoms(), 3).astype(np.float32))
        (src / f"{pdb_id}_ligand.sdf").write_text(mol_to_sdf(mol))
        prot = protein_from_sequence("ARNDCQEGHILKMFPSTWYV"[: 8 + 4 * i])
        prot.atom_pos[:, 1] = rng.randn(len(prot.aatype), 3)
        protein_to_pdb_file(prot, src / f"{pdb_id}_protein_processed.pdb")
    for split, ids in (("train", "1abc\n"), ("val", "2xyz\n"), ("test", "")):
        (root / f"PRD_{split}_pdb_ids").write_text(ids)
    return root


def _offline_clis(ckpt: Path, tmp: Path, seed: int) -> None:
    """The offline CLIs on the design run: export_params on its train
    checkpoint; the generate CLI from the export and from the checkpoint
    directory with one seed (DDIM, 2 samples), whose outputs must match
    byte for byte; evaluate over that output (a JSON report whose every
    group has TM-scores); preprocess_pdbbind --limit 2 on the card over a
    two-complex PDBbind layout."""
    from protein_redesign_tpu_torch.cli.evaluate import main as evaluate
    from protein_redesign_tpu_torch.cli.export_params import main as export
    from protein_redesign_tpu_torch.cli.generate import main as generate
    from protein_redesign_tpu_torch.cli.preprocess_pdbbind import main as preprocess
    from protein_redesign_tpu_torch.data.dataset import load_complex_cache

    began = time.perf_counter()
    export([str(ckpt), str(tmp / "export")])
    common = ["-p", SEQUENCE, "-l", LIGAND, "-n", "2", "--batch_size", "2", "--sampler", "ddim",
              "--ddim_steps", str(DESIGN_DDIM_STEPS), "--num_steps", str(STEPS), "--seed",
              str(seed), "--device", "cuda"]
    for name, source in (("from-ckpt", ckpt), ("from-export", tmp / "export")):
        generate(["-c", str(source), "-o", str(tmp / name), *common])
    for f in ("sample_protein.pdb", "sample_ligand.sdf", "sample_tmscores.txt"):
        if (tmp / "from-ckpt" / f).read_bytes() != (tmp / "from-export" / f).read_bytes():
            raise AssertionError(f"export: {f} differs between the checkpoint and its export")
    evaluate(["-i", str(tmp / "from-export")])
    report = json.loads((tmp / "from-export" / "evaluation.json").read_text())
    if not report["groups"] or not all(g.get("tm") for g in report["groups"].values()):
        raise AssertionError(f"evaluate: report without TM-scores {report}")
    data = _pdbbind_layout(tmp / "pdbbind", seed)
    preprocess(["--data_dir", str(data), "--pdbbind_dir", str(data / "PDBbind_processed"),
                "--esm_model", str(tmp / "no-esm"), "--limit", "2", "--device", "cuda"])
    for i, pdb_id in enumerate(("1abc", "2xyz")):
        d = load_complex_cache(data / "PDB_processed_cache", pdb_id)
        if d["num_residues"] != 8 + 4 * i or d["residue_esm"].shape != (8 + 4 * i, 1280):
            raise AssertionError(f"preprocess: {pdb_id} cached {d['num_residues']} residues")
    groups = {k: [round(x, 4) for x in g["tm"]] for k, g in report["groups"].items()}
    print(f"[offline] export_params, two generate runs equal byte for byte (export and "
          f"checkpoint), evaluate (TM-scores {groups}), preprocess_pdbbind --limit 2 --device "
          f"cuda: {time.perf_counter() - began:.1f} s")


def phase_design(seed: int, gaussian_ckpt: Path) -> None:
    """Phase 18: sequence design at paper width, bf16, bucket 192."""
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.utils.checkpoint import read_config, step_dir

    began = time.perf_counter()
    net = perturbed_net(ModelConfig(**DESIGN)).to("cuda").eval()
    phase_forward(net, tag="design-forward")
    del net
    _design_grad(seed)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = _design_train(tmp, seed)
        cfg = read_config(step_dir(ckpt))
        _design_generate(ckpt, tmp / "ddpm", cfg, "design-ddpm",
                         ["--num_steps", str(STEPS), "--reveal_schedule", "cosine",
                          "--reveal_temperature", "0.5"], STEPS, designed=True)
        _design_serve(ckpt, tmp, cfg)
        _design_batch(ckpt, tmp, cfg, seed)
        _design_route_agreement(ckpt, seed)
        _design_picard(ckpt, seed)
        _offline_clis(ckpt, tmp, seed)
        g_cfg = read_config(step_dir(gaussian_ckpt))
        ddpm, ddim = ANCESTRAL_STEPS
        _design_generate(gaussian_ckpt, tmp / "anc-ddpm", g_cfg, "ancestral-ddpm",
                         ["--seq_reverse", "ancestral", "--num_steps", str(ddpm)], ddpm,
                         designed=False)
        _design_generate(gaussian_ckpt, tmp / "anc-ddim", g_cfg, "ancestral-ddim",
                         ["--seq_reverse", "ancestral", "--sampler", "ddim", "--ddim_steps",
                          str(ddim), "--eta", "1.0", "--num_steps", str(STEPS)], ddim,
                         designed=False)
    print(f"[design] phase wall {time.perf_counter() - began:.1f} s")


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
            # the plain version: one call, warm from the check above (0.8-1.6 s at 2048)
            ms, plain_ms = cuda_ms(kernel, 1, 3), cuda_ms(plain, 0, 1)
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
        timings = main(argv).timings
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

    net = perturbed_net(ModelConfig(dtype="float32", num_blocks=LONG_BLOCKS), seed).to("cuda").eval()
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

    net = perturbed_net(ModelConfig(dtype="float32", training_mode=True, mask_prob=0.5,
                                    num_blocks=LONG_BLOCKS),
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
    complex's valid nodes; the projections and MLPs over every position;
    K11: the pairs i <= j, since round_T(xl_i * xl_j) . W1 is symmetric in
    (i, j) and only u_i - u_j tells out[i, j] from out[j, i])."""
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
        flops = 2 * B * (N * (N + 1) // 2) * S * w.shape[0]
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    return bound(flops, _nbytes(*tensors, out), out.dtype)


@contextlib.contextmanager
def fused_cuda_core_bodies():
    """Inside the block, K8, K9, K10 and K11 take the CUDA-core bodies that
    their tensor-core ones replaced (fused_gated.cu, trimul.cu,
    transition.cu, outer.cu), so that both can be timed in one run. Launch
    counts are the same."""
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.ops import outer as O
    from protein_redesign_tpu_torch.ops import transition as T
    from protein_redesign_tpu_torch.ops import trimul as M

    takes = (A.fused_gated_takes_tensor_cores, M.trimul_takes_tensor_cores,
             T.transition_takes_tensor_cores, O.outer_takes_tensor_cores)
    A.fused_gated_takes_tensor_cores = lambda D, H, C: False
    M.trimul_takes_tensor_cores = lambda D: False
    T.transition_takes_tensor_cores = lambda D, Hd, Dout, dtype: False
    O.outer_takes_tensor_cores = lambda S, D, dtype: False
    try:
        yield
    finally:
        (A.fused_gated_takes_tensor_cores, M.trimul_takes_tensor_cores,
         T.transition_takes_tensor_cores, O.outer_takes_tensor_cores) = takes


def fused_body_times(name: str, kernel, args: tuple, want, dtype, heads=None) -> str:
    """One fused kernel (K8-K11) on the device on its tensor-core body and,
    where the CUDA-core body it replaced takes the shape, on that one (the
    predicates patched): device ms of each (the whole call) and the
    CUDA-core body's error against the plain version's output ``want``."""
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.ops import transition as T

    dev = device_ms(lambda: kernel(*args))
    layout = ""
    if name == "fused_transition":
        w1, w2 = args[1], args[3]
        layout = T.transition_layout(w1.shape[1], w1.shape[0], w2.shape[0], dtype)
        layout = f", {layout} layout"
    out = f"; on the device {dev:.4f} ms (tensor-core body{layout})"
    D = args[0].shape[-1]
    if name == "fused_gated_rows_attention" and not A.fused_gated_core_fits(D, *heads):
        return out
    with fused_cuda_core_bodies():
        core = kernel(*args)
        core_dev = device_ms(lambda: kernel(*args))
    torch.cuda.synchronize()
    core_rel = float((core.float() - want.float()).norm() / want.float().norm())
    return out + (f", CUDA-core body {core_dev:.4f} ms (its error {core_rel:.3e}, "
                  f"{core_dev / dev:.1f}x the tensor-core body's time)")


def phase_fused_kernels() -> dict:
    """K8-K11 against their plain versions at the fused configuration's shapes
    at bucket 192, B=2 (147 nodes valid): f32 and bf16 errors; the kernel's,
    the plain version's and the unfused module route's time in both; each on
    the device on its tensor-core body and on the CUDA-core body it
    replaced; the record (bf16) keeps K8's starting view, K9 outgoing, K10
    pair_fc, K11. Then the same in bf16 at AlphaFold2's pair width 128
    (K10's pair_fc there in f32 too), K8 at the h64x1 and h64x4 head layouts
    (bf16), K10 at single_fc 768 (both dtypes) and K11 at bucket 512, B=1
    (both dtypes), outside the record."""
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
                bodies = fused_body_times(name, kernel, args, want, dtype, heads)
                print(f"[fused-kernels] {name} ({view}) {label}: ||kernel - plain|| / ||plain|| "
                      f"{rel:.3e} (tol {tol[dtype]:g}), max abs err {err:.3e}; kernel {ms:.4f} ms"
                      f"{bodies}, plain {plain_ms:.4f} ms, unfused module route {unfused_ms:.4f} "
                      f"ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
                if dtype == torch.bfloat16 and paper and D == 64 and view.split(",")[0] in (
                        "starting", "outgoing", "pair_fc", "factored route"):
                    rec.update(ms=ms, plain_ms=plain_ms, unfused_ms=unfused_ms, **b)
    # K11 at bucket 512, B=1: the fused forward's other measured shape
    N = FUSED_BUCKET_LARGE[0]
    for seed, dtype in enumerate((torch.bfloat16, torch.float32)):
        g = torch.Generator("cuda").manual_seed(360 + seed)
        single = torch.randn(1, N, 512, generator=g, device="cuda").to(dtype)
        ol = perturb(OuterLinear(512, 64, factored=True, dtype=dtype), 340).to("cuda")
        args = (single, ol.linear.weight, ol.linear.bias)
        with torch.inference_mode():
            got, want = O.outer(*args), O.outer_reference(*args)
            torch.cuda.synchronize()
            rel = float((got.float() - want.float()).norm() / want.float().norm())
            if not (torch.isfinite(got).all() and rel <= tol[dtype]):
                raise AssertionError(f"fused_outer_linear at 512 {dtype}: relative error {rel} > "
                                     f"{tol[dtype]}")
            ms = cuda_ms(lambda: O.outer(*args))
            plain_ms = cuda_ms(lambda: O.outer_reference(*args))
            unfused_ms = cuda_ms(lambda: ol(single))
            bodies = fused_body_times("fused_outer_linear", O.outer, args, want, dtype)
        b = fused_bound("fused_outer_linear", args, got)
        label = str(dtype).replace("torch.", "")
        print(f"[fused-kernels] fused_outer_linear (factored route) {label}, bucket {N}, B=1: "
              f"||kernel - plain|| / ||plain|| {rel:.3e} (tol {tol[dtype]:g}); kernel {ms:.4f} "
              f"ms{bodies}, plain {plain_ms:.4f} ms, unfused module route {unfused_ms:.4f} ms; "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
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
    check_outer_body(net.cfg, busy, "fused-forward-512")
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


def _coarse_steps(S: int, coarse_init: int) -> int:
    """The sequential steps of a ``coarse_init`` warm start over S DDIM
    steps (the sub-grid ``sample_ddim_parallel`` takes)."""
    if not coarse_init:
        return 0
    return len(np.unique(np.round(np.linspace(0, S, min(coarse_init, S) + 1)))) - 1


def _picard_expected(cfg, runner) -> dict:
    """The launches of the runner's last run: one forward per DDIM step, or
    per Picard sweep plus one per coarse step."""
    if runner.sampler == "ddim":
        forwards = runner.ddim_steps * len(runner.timings)
    else:
        coarse = _coarse_steps(runner.ddim_steps, runner.coarse_init)
        forwards = sum(s["iterations"] + coarse for s in runner.picard_stats)
    return {k: forwards * v for k, v in forward_launches(cfg).items()}


def _picard_agreement(tag: str, dtype: str, got, want, control=None) -> str:
    """The tol-0 Picard sample against the sequential one: the largest
    |positions difference| (Å) within PICARD_POS_TOL, or in f32 within
    PICARD_CONTROL times ``control`` (the sequential sample from one ulp
    more on the initial coordinates) where that is larger; the logits'
    relative norm within PICARD_LOGIT_TOL, likewise widened."""
    (pos, logits), (pos_s, logits_s) = got[0][:2], want[0][:2]

    def diff(a, b):
        return (float(np.abs(a[0] - b[0]).max()),
                float(np.linalg.norm(a[1] - b[1]) / np.linalg.norm(b[1])))

    dpos, dlog = diff((pos, logits), (pos_s, logits_s))
    pos_tol, log_tol, line = PICARD_POS_TOL[dtype], PICARD_LOGIT_TOL[dtype], ""
    if control is not None:
        cpos, clog = diff(control, (pos_s, logits_s))
        pos_tol, log_tol = max(pos_tol, PICARD_CONTROL * cpos), max(log_tol, PICARD_CONTROL * clog)
        line = (f"; one ulp more on the initial coordinates moves the sequential sample by "
                f"{cpos:.3e} A (logits {clog:.3e}); max |sequential positions| "
                f"{float(np.abs(pos_s).max()):.4g} A")
    if not (np.isfinite(pos).all() and dpos <= pos_tol and dlog <= log_tol):
        raise AssertionError(f"[{tag}] Picard at ptol 0 against sequential DDIM: positions "
                             f"{dpos} A (tol {pos_tol}), logits {dlog} (tol {log_tol}){line}")
    return (f"against the sequential DDIM: max |positions difference| {dpos:.3e} A (tol "
            f"{pos_tol:.3g}), ||logits difference|| / ||logits|| {dlog:.3e} (tol "
            f"{log_tol:.3g}){line}")


def _ulp_control(net, runner, data, seed: int):
    """The sequential DDIM sample of ``runner``'s first run with its draws
    made as the runner's generator makes them (mask scores, then the initial
    coordinates and sequence) and the initial coordinates one ulp larger:
    how far the trajectory carries a rounding-sized change."""
    from protein_redesign_tpu_torch.models.prdiff import SamplerNoise, sample_ddim

    _, batch = runner.collate([data])
    B, N = batch["residue_mask"].shape
    g = torch.Generator("cuda").manual_seed(seed)
    scores = torch.rand(B * N, generator=g, device="cuda")
    z0 = torch.randn((B, N, 3), generator=g, device="cuda")
    s0 = torch.randn((B, N, 21), generator=g, device="cuda")
    noise = SamplerNoise(mask_scores=scores, z0=torch.nextafter(z0, z0 + torch.sign(z0)), s0=s0)
    pos, logits = sample_ddim(net, batch, runner.ddim_steps, 0.0, runner.mask_prob, noise=noise)
    n = data["num_atoms"] + data["num_residues"]
    return pos[0, :n].cpu().numpy(), logits[0, :n].cpu().numpy()


def _fused_repeats(seed: int) -> None:
    """Each fused kernel (K8-K11, one switch a net; K10's single_fc layout
    sums through per-chunk slabs of an f32 scratch) must give the same bits
    twice for one input at a Picard sweep's shape (batch PICARD_WINDOW,
    bucket 192), and the Picard sweeps at ptol 0 (DDIM DESIGN_DDIM_STEPS)
    with all four switches must end below the 2S + 2 cap: ptol 0 converges
    only on bit-equal repeats."""
    from protein_redesign_tpu_torch.cli.common import SamplingRunner
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.models.prdiff import prepare_batch

    repeats = {}
    for switch in FUSED:
        net = perturbed_net(ModelConfig(**{switch: True}), seed).to("cuda").eval()
        runner = SamplingRunner(net, "cuda")
        _, batch = complex_batch(runner, PICARD_WINDOW)
        batch = prepare_batch(batch, 0.3, generator=torch.Generator("cuda").manual_seed(0))
        B, N = batch["residue_mask"].shape
        g = torch.Generator("cuda").manual_seed(seed)
        z, seq_t = (torch.randn(B, N, c, generator=g, device="cuda") for c in (3, 21))
        t = torch.arange(B, device="cuda") * 100
        with torch.inference_mode():
            first, second = (net(batch, z, seq_t, batch["residue_and_atom_mask"], t)[0]
                             for _ in range(2))
        repeats[switch] = float((first - second).norm() / first.norm())
        if not torch.equal(first, second):
            raise AssertionError(f"[picard] {switch}: two forwards on one input differ, "
                                 f"||first - second|| / ||first|| = {repeats[switch]:.3e}")
        del net
    net = fused_net(num_steps=SERVE_SCHEDULE).to("cuda").eval()
    runner = SamplingRunner(net, "cuda", sampler="ddim_parallel", ddim_steps=DESIGN_DDIM_STEPS,
                            window=PICARD_WINDOW, ptol=0.0)
    runner.run([complex_batch_data(runner, SEQUENCE)], seed)
    stats, cap = runner.picard_stats[0], 2 * DESIGN_DDIM_STEPS + 2
    if stats["iterations"] >= cap:
        raise AssertionError(f"[picard] ptol 0 with the four fused switches: {stats} at the "
                             f"2S + 2 cap {cap}")
    print(f"[picard] two forwards at batch {PICARD_WINDOW}, bucket 192, one fused switch each: "
          f"bit-equal ({', '.join(repeats)}); Picard at ptol 0 with all four, DDIM "
          f"{DESIGN_DDIM_STEPS}: {stats} (cap {cap})")
    del net


def _forward_busy(net, runner, data, rows: int) -> float:
    """ms of device time of one net call on ``rows`` copies of ``data``
    (torch.profiler over 3 calls): a DDIM step's at 1 row, a Picard sweep's
    at PICARD_WINDOW rows."""
    from protein_redesign_tpu_torch.models.prdiff import prepare_batch

    _, batch = runner.collate([data] * rows)
    batch = prepare_batch(batch, 0.3, generator=torch.Generator("cuda").manual_seed(0))
    N = batch["residue_mask"].shape[1]
    g = torch.Generator("cuda").manual_seed(1)
    z, seq_t = (torch.randn(rows, N, c, generator=g, device="cuda") for c in (3, 21))
    t = torch.full((rows,), SERVE_SCHEDULE // 2, device="cuda")
    with torch.inference_mode():
        busy = device_time_by_group(
            lambda: net(batch, z, seq_t, batch["residue_and_atom_mask"], t), iters=3)
    return sum(busy.values())


def phase_picard(seed: int, trained: Path) -> None:
    """Phase 19: parallel-in-time DDIM at paper width, bucket 192, B = 1,
    on checkpoints written by the port. bf16, seeded random weights: the
    generate CLI with --sampler ddim (eta 0) and --sampler ddim_parallel
    --window 8 at --ptol 0, at --ptol 1e-3 and at --ptol 1e-3 --coarse_init
    5: sweeps, nfe, wall per sample, exact K1 and K2 launches, and an
    estimate of the device busy time per sample: the forwards times one
    forward's device time at their batch (torch.profiler: a trace of a
    whole run takes minutes to process), without the Picard loop's own
    device work (cumsum, errors, selection). The sequential and ptol-0 runs
    again in the process through the same runner (the same sweeps), the
    ptol-0 sample against the sequential one. f32 (3xTF32 kernels), on the same weights and on phase
    8's trained checkpoint (``trained``): the sequential and ptol-0 runs in
    the process, held within 1e-3 Å, or PICARD_CONTROL times the
    trajectory's response to one ulp on its initial coordinates where that
    is larger."""
    from protein_redesign_tpu_torch.cli.common import SamplingRunner
    from protein_redesign_tpu_torch.cli.generate import main as generate
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.utils.weights import load_checkpoint, save_checkpoint

    began = time.perf_counter()
    _fused_repeats(seed)
    S, W = PICARD_STEPS, PICARD_WINDOW
    runs = (("ddim", dict(sampler="ddim")),
            ("picard-ptol0", dict(sampler="ddim_parallel", ptol=0.0)),
            ("picard-ptol1e-3", dict(sampler="ddim_parallel", ptol=1e-3)),
            ("picard-ptol1e-3-coarse5", dict(sampler="ddim_parallel", ptol=1e-3,
                                             coarse_init=PICARD_COARSE)))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for dtype, weights in (("bfloat16", "seeded"), ("float32", "seeded"),
                               ("float32", "trained")):
            ckpt = trained
            if weights == "seeded":
                ckpt = tmp / dtype
                net = perturbed_net(ModelConfig(dtype=dtype), seed)
                save_checkpoint(ckpt, net.state_dict(), net.cfg)
                del net
            state_dict, cfg = load_checkpoint(ckpt, num_steps=SERVE_SCHEDULE, dtype=dtype)
            cfg = cfg.replace(training_mode=False)
            net = ProteinReDiffNet(cfg)
            net.load_state_dict(state_dict)
            net.to("cuda").eval()
            data = complex_batch_data(SamplingRunner(net, "cuda"), SEQUENCE)  # the CLI's -p
            busy = {1: _forward_busy(net, SamplingRunner(net, "cuda"), data, 1),
                    W: _forward_busy(net, SamplingRunner(net, "cuda"), data, W)}
            print(f"[picard] {dtype} {weights}: one forward {busy[1]:.2f} ms busy at batch 1, "
                  f"{busy[W]:.2f} at batch {W} (torch.profiler)")
            samples = {}
            for tag, kw in runs if dtype == "bfloat16" else runs[:2]:
                kw = {"ddim_steps": S, "window": W, **kw}
                runner = SamplingRunner(net, "cuda", batch_size=1, mask_prob=0.3, **kw)
                line, stats = f"[picard] {dtype} {weights} {tag}", None
                if dtype == "bfloat16":
                    A.reset_launch_counts()
                    cli = generate(["-c", str(ckpt), "-o", str(tmp / tag), "-p", SEQUENCE, "-l",
                                    LIGAND, "-n", "1", "--batch_size", "1", "--num_steps",
                                    str(SERVE_SCHEDULE), "--seed", str(seed), "--device", "cuda",
                                    *[x for k, v in kw.items() for x in (f"--{k}", str(v))]])
                    torch.cuda.synchronize()
                    launches = main_path_launches()
                    if launches != _picard_expected(cfg, cli):
                        raise AssertionError(f"{line}: generate CLI launches {launches} != "
                                             f"{_picard_expected(cfg, cli)}")
                    (_, _, _, seconds), = cli.timings
                    stats = cli.picard_stats[0] if cli.picard_stats else None
                    line += (f": generate CLI {seconds:.3f} s per sample, launches "
                             f"{ {k: v for k, v in launches.items() if v} }")
                if tag in ("ddim", "picard-ptol0"):
                    A.reset_launch_counts()
                    samples[tag] = runner.run([data], seed)
                    torch.cuda.synchronize()
                    if main_path_launches() != _picard_expected(cfg, runner):
                        raise AssertionError(f"{line}: launches {main_path_launches()}")
                    (_, _, _, seconds), = runner.timings
                    if dtype == "bfloat16" and runner.picard_stats != cli.picard_stats:
                        raise AssertionError(f"{line}: {runner.picard_stats} in the process, "
                                             f"{cli.picard_stats} through the CLI")
                    stats = runner.picard_stats[0] if runner.picard_stats else None
                    line += f"; in the process {seconds:.3f} s per sample"
                if stats is None:  # sequential DDIM
                    stats, forwards = {"iterations": S, "nfe": S}, {1: S}
                else:
                    forwards = {1: _coarse_steps(S, kw.get("coarse_init", 0)),
                                W: stats["iterations"]}
                    if stats["iterations"] >= 2 * S + 2:
                        raise AssertionError(f"{line}: {stats} at the 2S + 2 cap")
                dev = sum(n * busy[rows] for rows, n in forwards.items())
                line += (f"; {stats['iterations']} {'sweeps' if W in forwards else 'steps'}, "
                         f"nfe {stats['nfe']}; device busy, estimated as forwards x one "
                         f"profiled forward, {dev / 1e3:.3f} s per sample "
                         f"({1 - dev / 1e3 / seconds:.1%} idle)")
                if tag == "picard-ptol0":
                    control = _ulp_control(net, runner, data, seed) if dtype == "float32" else None
                    line += "; " + _picard_agreement(line, dtype, samples[tag], samples["ddim"],
                                                     control)
                print(line)
            del net
    print(f"[picard] phase wall {time.perf_counter() - began:.1f} s")


def _chunk_nets(cfg, seed: int):
    """(the net under ``cfg``'s plan, the same weights with the plan's chunk
    off: pallas_auto_min_n 0 leaves the kernels and chunks nothing)."""
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet

    chunked = perturbed_net(cfg, seed).to("cuda")
    whole = ProteinReDiffNet(cfg.replace(pallas_auto_min_n=0)).to("cuda")
    whole.load_state_dict(chunked.state_dict())
    return chunked, whole


def phase_chunked(seed: int) -> None:
    """Phase 20: query-chunked attention where the plan leaves the kernels:
    the h64x4 layout with fast_softmax in bf16 at paper width. One forward
    at bucket 1024, B = 1 (chunk 128), chunked against unchunked (same
    weights, the plan's chunk off): relative norm, ms and peak memory each,
    no attention kernel launched; then one training micro-step of 2 blocks
    at 768 (chunk 128 under the training plan): the whole gradient against
    the unchunked one, ms and peak memory each."""
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.models.denoiser import resolve_attention_plan
    from protein_redesign_tpu_torch.models.prdiff import prepare_batch
    from protein_redesign_tpu_torch.ops import attention as A

    began = time.perf_counter()
    cfg = ModelConfig(**H64X4)
    N, n_res = CHUNK_FORWARD
    if resolve_attention_plan(cfg, N) != (False, 128):
        raise AssertionError(f"the plan at {N}: {resolve_attention_plan(cfg, N)}")
    chunked, whole = _chunk_nets(cfg, seed)
    batch = prepare_batch(collated([synthetic_complex(long_sequence(seed + 70, n_res), seed + 70,
                                                      cfg.esm_dim)], N), 0.3,
                          generator=torch.Generator("cuda").manual_seed(0))
    g = torch.Generator("cuda").manual_seed(1)
    z = torch.randn(1, N, 3, generator=g, device="cuda")
    seq_t = torch.randn(1, N, 21, generator=g, device="cuda")
    mask, t = batch["residue_and_atom_mask"], torch.tensor([40], device="cuda")
    outs, ms, peak = {}, {}, {}
    with torch.inference_mode():
        for name, net in (("chunked", chunked), ("unchunked", whole)):
            net.eval()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            A.reset_launch_counts()
            outs[name] = net(batch, z, seq_t, mask, t)
            torch.cuda.synchronize()
            peak[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
            if any(main_path_launches().values()):
                raise AssertionError(f"[chunked] {name} launched {main_path_launches()}")
            ms[name] = cuda_ms(lambda: net(batch, z, seq_t, mask, t), 1, 2)
    for i, what in enumerate(("noise_pred", "seq_pred")):
        a, b = outs["chunked"][i].float(), outs["unchunked"][i].float()
        rel = float((a - b).norm() / b.norm())
        print(f"[chunked] forward at {N}, {what} {tuple(a.shape)}: ||chunked - unchunked|| / "
              f"||unchunked|| = {rel:.3e} (tol {FORWARD_REL_TOL:g})")
        if not (torch.isfinite(a).all() and rel <= FORWARD_REL_TOL):
            raise AssertionError(f"[chunked] {what}: relative difference {rel}")
    print(f"[chunked] h64x4 fast_softmax bf16, B=1, bucket {N}, chunk 128: chunked "
          f"{ms['chunked']:.1f} ms, peak {peak['chunked']:.2f} GiB; unchunked "
          f"{ms['unchunked']:.1f} ms, peak {peak['unchunked']:.2f} GiB per forward (peak above "
          f"the weights and inputs); no attention kernel launched")
    del chunked, whole, outs

    N, n_res = CHUNK_GRAD
    cfg = ModelConfig(training_mode=True, mask_prob=0.5, num_blocks=CHUNK_GRAD_BLOCKS, **H64X4)
    if resolve_attention_plan(cfg, N) != (False, 128):
        raise AssertionError(f"the training plan at {N}: {resolve_attention_plan(cfg, N)}")
    chunked, whole = _chunk_nets(cfg, seed)
    batch = collated([synthetic_complex(long_sequence(seed + 71, n_res), seed + 71,
                                        cfg.esm_dim)], N)
    noise = fixed_noise(batch, seed)
    grads = {}
    for name, net in (("chunked", chunked), ("unchunked", whole)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        A.reset_launch_counts()
        loss = micro_step(net, batch, noise)
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        if any(main_path_launches().values()):
            raise AssertionError(f"[chunked] {name} micro-step launched {main_path_launches()}")
        grads[name] = torch.cat([p.grad.flatten().float() for p in net.parameters()])
        ms[name] = cuda_ms(lambda: micro_step(net, batch, noise), 0, 1)
        print(f"[chunked] {name} micro-step loss {float(loss):.6f}")
    rel = float((grads["chunked"] - grads["unchunked"]).norm() / grads["unchunked"].norm())
    print(f"[chunked] gradient, {CHUNK_GRAD_BLOCKS} blocks, bucket {N}, bf16 fast_softmax, chunk "
          f"128: ||chunked - unchunked|| / ||unchunked|| = {rel:.3e} (tol "
          f"{GRAD_REL_TOL['bfloat16']:g}); micro-step chunked {ms['chunked']:.1f} ms, peak "
          f"{peak['chunked']:.2f} GiB; unchunked {ms['unchunked']:.1f} ms, peak "
          f"{peak['unchunked']:.2f} GiB")
    if not (torch.isfinite(grads["chunked"]).all() and rel <= GRAD_REL_TOL["bfloat16"]):
        raise AssertionError(f"[chunked] gradient: relative difference {rel}")
    del chunked, whole
    print(f"[chunked] phase wall {time.perf_counter() - began:.1f} s")


def write_seeded_esm2(directory: Path, seed: int) -> None:
    """An ESM-2 650M checkpoint directory in the HF layout (config, weights
    and tokenizer), its weights HF's initialisation from ``seed``."""
    from transformers import EsmConfig, EsmModel, EsmTokenizer

    from protein_redesign_tpu_torch.utils.esm import ESM_ALPHABET

    torch.manual_seed(seed)
    with torch.device("cuda"):  # HF's initialisation of 650M parameters, on the card
        model = EsmModel(EsmConfig(**ESM2_650M), add_pooling_layer=False)
    model.save_pretrained(directory)
    del model
    vocab = directory / "vocab.txt"
    vocab.write_text("\n".join(ESM_ALPHABET) + "\n")
    EsmTokenizer(str(vocab)).save_pretrained(directory)


def esm_inputs(seed: int) -> dict:
    """{name: token ids [L]}: lysozyme 1-110 with ESM_MASKS residues masked,
    and a seeded ESM_LONG-residue sequence; each with cls and eos."""
    from protein_redesign_tpu_torch.utils.esm import ESM_TOKEN_INDEX, esm_tokens

    masked = esm_tokens(SEQUENCE)
    masked[np.random.RandomState(seed).choice(len(SEQUENCE), ESM_MASKS, replace=False)] = \
        ESM_TOKEN_INDEX["<mask>"]
    cls, eos = ESM_TOKEN_INDEX["<cls>"], ESM_TOKEN_INDEX["<eos>"]
    return {f"lysozyme, {ESM_MASKS} masked": np.concatenate([[cls], masked, [eos]]),
            f"{ESM_LONG} residues": np.concatenate(
                [[cls], esm_tokens(long_sequence(seed + 21, ESM_LONG)), [eos]])}


def best_ms(fn, runs: int = 3) -> float:
    """The best of ``runs`` warm calls, each timed by CUDA events."""
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return min(times)


def esm_bound(model, tokens: int) -> dict:
    """The least time of one embedding of ``tokens`` tokens by an ESM-2 650M
    ``model`` (the port's or HF's): the projections, MLP, logits and P.V
    over the peak of its compute dtype (bf16 on the tensor cores, f32 on the
    CUDA cores), or its weights read once over the HBM rate."""
    D, Fd = ESM2_650M["hidden_size"], ESM2_650M["intermediate_size"]
    flops = ESM2_650M["num_hidden_layers"] * (2 * tokens * D * (4 * D + 2 * Fd)
                                              + 4 * tokens * tokens * D)
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    peak = PEAK_FLOPS["bfloat16"] if model.dtype == torch.bfloat16 else F32_CUDA_CORE_FLOPS
    ops_s, bytes_s = flops / peak, nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(ops_s, bytes_s) * 1e3, "gflop": flops / 1e9,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    return float((a - b).norm() / b.norm())


@contextlib.contextmanager
def recorded_embedders():
    """Every ESMEmbedder the sampling CLIs build while inside, with the
    features each computed (``features``)."""
    from protein_redesign_tpu_torch.utils import esm

    made, real = [], esm.ESMEmbedder

    class Recorded(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.features = []
            made.append(self)

        def embed_protein(self, protein):
            out = super().embed_protein(protein)
            self.features.append(out)
            return out

    esm.ESMEmbedder = Recorded
    try:
        yield made
    finally:
        esm.ESMEmbedder = real


def _esm_encoders(esm_dir: Path, seed: int) -> None:
    """The port's encoder against HF's on the card, and the times."""
    from transformers import EsmModel

    from protein_redesign_tpu_torch.models.esm2 import load_esm2

    port = {dtype: load_esm2(str(esm_dir), dtype=dtype, device="cuda")
            for dtype in ("float32", "bfloat16")}
    hf_cpu, hf = (EsmModel.from_pretrained(esm_dir, local_files_only=True, add_pooling_layer=False)
                  .eval().requires_grad_(False) for _ in range(2))
    hf.to("cuda")
    for name, ids in esm_inputs(seed).items():
        ids_t = torch.as_tensor(ids, device="cuda")[None]
        ones = torch.ones_like(ids_t)

        def run_port(dtype):
            return lambda: port[dtype].model(ids_t, ones)

        def run_hf():
            return hf(input_ids=ids_t).last_hidden_state

        with torch.inference_mode():
            f32, bf16, want = run_port("float32")(), run_port("bfloat16")(), run_hf()
            for label, out in (("f32", f32), ("bf16", bf16)):
                if out.shape != want.shape or not torch.isfinite(out).all():
                    raise AssertionError(f"[esm] {name}, {label}: shape {tuple(out.shape)} "
                                         "or non-finite values")
            rel_f32, rel_bf16 = _rel(f32, want), _rel(bf16, f32)
            print(f"[esm] {name} ({len(ids)} tokens): port f32 against HF f32 "
                  f"||d|| / ||HF|| = {rel_f32:.3e} (tol {ESM_F32_TOL:g}); port bf16 against "
                  f"port f32 {rel_bf16:.3e} (tol {ESM_BF16_TOL:g})")
            if not (rel_f32 <= ESM_F32_TOL and rel_bf16 <= ESM_BF16_TOL):
                raise AssertionError(f"[esm] {name}: the port's encoder disagrees")
            # ~1 s of spin: three embeddings' host time fits behind it
            times = {label: (best_ms(fn), device_ms(fn, spin=2_000_000_000),
                             esm_bound(model, len(ids)))
                     for label, fn, model in (
                         ("port f32", run_port("float32"), port["float32"].model),
                         ("port bf16", run_port("bfloat16"), port["bfloat16"].model),
                         ("HF f32", run_hf, hf))}
            if len(ids) == len(SEQUENCE) + 2:
                ids_cpu = ids_t.cpu()
                hf_cpu(input_ids=ids_cpu)
                host = []
                for _ in range(3):
                    began = time.perf_counter()
                    hf_cpu(input_ids=ids_cpu)
                    host.append((time.perf_counter() - began) * 1e3)
                print(f"[esm] {name}: HF f32 on the host CPU ({torch.get_num_threads()} threads) "
                      f"{min(host):.1f} ms per embedding, best of 3 warm")
        print(f"[esm] {name}: ms per embedding on the card, best of 3 warm (CUDA events), and "
              f"on the device (calls queued behind a spin): "
              + "; ".join(f"{k} {ms:.3f}, on the device {dev:.3f} (bound {b['bound_ms']:.3f}, "
                          f"{b['bound_by']}, {b['gflop']:.1f} GFLOP)"
                          for k, (ms, dev, b) in times.items()))
    del port, hf, hf_cpu
    torch.cuda.empty_cache()


def _esm_generate(esm_dir: Path, seed: int) -> None:
    """The generate CLI with --require_esm on the seeded ESM-2 directory,
    both backends: the embedder on the card, nonzero features that agree
    across the backends, exact launches, main() wall time."""
    from protein_redesign_tpu_torch.config import ModelConfig

    net = perturbed_net(ModelConfig(), seed).to("cuda").eval()
    # no weights under the default name: zeros
    phase_generate(net, tag="esm-generate-without", steps=ESM_GENERATE_STEPS)
    features = {}
    for backend in ("jax", "torch"):
        with recorded_embedders() as made:
            phase_generate(net, flags=["--esm_model", str(esm_dir), "--esm_backend", backend,
                                       "--require_esm"], tag=f"esm-generate-{backend}",
                           cfg=net.cfg, steps=ESM_GENERATE_STEPS)
        (embedder,) = made
        model = embedder._encoder.model if backend == "jax" else embedder._model
        device = next(model.parameters()).device
        if embedder.device != "cuda" or device.type != "cuda" or not embedder.available:
            raise AssertionError(f"[esm-generate-{backend}] the embedder ran on {device}")
        (features[backend],) = embedder.features
        if not np.abs(features[backend]).max() > 0:
            raise AssertionError(f"[esm-generate-{backend}] residue_esm is zero")
        print(f"[esm-generate-{backend}] ESM-2 on {device}: residue_esm "
              f"{features[backend].shape}, max |x| {np.abs(features[backend]).max():.3f}")
    rel = _rel(features["jax"], features["torch"])
    print(f"[esm-generate] residue_esm, --esm_backend jax against torch: ||d|| / ||torch|| = "
          f"{rel:.3e} (tol {ESM_F32_TOL:g})")
    if not rel <= ESM_F32_TOL:
        raise AssertionError("[esm-generate] the two backends' features disagree")
    walls = {tag: GENERATED[tag]["wall"] for tag in ("esm-generate-jax", "esm-generate-torch",
                                                      "esm-generate-without")}
    phase5 = (f"{GENERATED['generate']['wall']:.2f} s" if "generate" in GENERATED
              else "not run in this process")
    print(f"[esm-generate] main() wall, {ESM_GENERATE_STEPS} DDPM steps: --esm_backend jax "
          f"{walls['esm-generate-jax']:.2f} s, torch {walls['esm-generate-torch']:.2f} s (each "
          f"loading the 650M weights onto the card); without ESM just before "
          f"{walls['esm-generate-without']:.2f} s; phase 5 ({STEPS} steps) {phase5}")


def _use_pallas_generate(seed: int) -> None:
    """The serving net at 192 (bf16, fast_softmax, use_pallas_bwd off) for
    one DDIM step through the generate CLI: the plan takes XLA there (no
    attention kernel), --use_pallas and --pallas_auto_min_n 192 its kernel
    branch (K1 fast and K2)."""
    from protein_redesign_tpu_torch.config import ModelConfig

    net = perturbed_net(ModelConfig(fast_softmax=True, use_pallas_bwd=False), seed).to("cuda")
    one_step = ["--fast_softmax", "--sampler", "ddim", "--ddim_steps", "1"]
    for tag, flags, cfg in (
        ("plan-default", [], net.cfg),
        ("plan-use_pallas", ["--use_pallas"], net.cfg.replace(use_pallas=True)),
        ("plan-min_n-192", ["--pallas_auto_min_n", "192"], net.cfg.replace(pallas_auto_min_n=192)),
    ):
        launches = phase_generate(net.eval(), flags=[*one_step, *flags], tag=tag, cfg=cfg)
        got = GENERATED[tag]["cfg"]
        if (got.use_pallas, got.pallas_auto_min_n) != (cfg.use_pallas, cfg.pallas_auto_min_n):
            raise AssertionError(f"[{tag}] config {got.use_pallas}, {got.pallas_auto_min_n}")
        print(f"[{tag}] use_pallas {got.use_pallas}, pallas_auto_min_n {got.pallas_auto_min_n}: "
              f"launches in one forward {launches['rows_attention_fast']} K1 fast, "
              f"{launches['tiled_attention']} K2, {launches['rows_attention']} K1")


def _trimul_dmajor(seed: int) -> None:
    """--trimul_dmajor: the paper-width forward at 192 and 384, B=2, bf16 and
    f32, against the same weights without the switch; both routes' device
    time per forward, measured in turns."""
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet

    for dtype, tol in (("bfloat16", FORWARD_REL_TOL), ("float32", FORWARD_REL_TOL_F32)):
        net = perturbed_net(ModelConfig(dtype=dtype), seed).to("cuda").eval()
        dmajor = ProteinReDiffNet(net.cfg.replace(trimul_dmajor=True))
        dmajor.load_state_dict(net.state_dict())
        dmajor.to("cuda").eval()
        trimuls = [m for m in dmajor.modules() if type(m).__name__ == "TriangleMultiplication"]
        if len(trimuls) != 2 * net.cfg.num_blocks or not all(m.dmajor for m in trimuls):
            raise AssertionError("[dmajor] the switch did not reach every triangle multiplication")
        for bucket in (192, 384):
            inputs = forward_inputs(net, bucket)
            with torch.inference_mode():
                want, got = net(*inputs), dmajor(*inputs)
                rels = [_rel(a, b) for a, b in zip(got, want)]
                if not all(torch.isfinite(a).all() for a in got) or max(rels) > tol:
                    raise AssertionError(f"[dmajor] {dtype} at {bucket}: relative {rels}")
                # in turns, each behind ~0.3 s of spin, which three forwards' host time fits in
                ms = {"d-minor": [], "channel-major": []}
                for name, m in (("d-minor", net), ("channel-major", dmajor),
                                ("channel-major", dmajor), ("d-minor", net)):
                    ms[name].append(device_ms(lambda m=m: m(*inputs), spin=600_000_000))
            equal = all(torch.equal(a, b) for a, b in zip(got, want))
            print(f"[dmajor] {dtype}, bucket {bucket}, B=2: --trimul_dmajor against without, "
                  f"noise {rels[0]:.3e}, seq {rels[1]:.3e} (tol {tol:g}; bit-equal: {equal}); "
                  f"device ms per forward (without, with, with, without): "
                  f"{ms['d-minor'][0]:.2f}, {ms['channel-major'][0]:.2f}, "
                  f"{ms['channel-major'][1]:.2f}, {ms['d-minor'][1]:.2f}")
        del net, dmajor
        torch.cuda.empty_cache()


def _profile_train(seed: int) -> None:
    """The train CLI with --profile at 192 for 2 optimizer steps: a
    non-empty torch.profiler trace with the card's kernels under
    <save_dir>/profile, and exact launches."""
    from protein_redesign_tpu_torch.cli.train import main as train
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.ops import attention as A

    esm_dim = ModelConfig().esm_dim
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_dataset(tmp / "data", {
            "train": [synthetic_complex(SEQUENCE, seed + s, esm_dim) for s in (10, 11)],
            "val": [synthetic_complex(SEQUENCE, seed + 14, esm_dim)]})
        run = tmp / "run"
        A.reset_launch_counts()
        began = time.perf_counter()
        train(["--save_dir", str(run), "--data_dir", str(tmp / "data"), "--batch_size", "2",
               "--val_every_steps", "0", "--log_every_steps", "1", "--warmup_steps", "10",
               "--seed", str(seed), "--device", "cuda", "--max_steps", "2", "--profile"])
        wall = time.perf_counter() - began
        launches = main_path_launches()
        metrics = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
        traces = sorted((run / "profile").glob("*.json"))
        sizes = [t.stat().st_size for t in traces]
        kernels = sum(t.read_bytes().count(b'"cat": "kernel"') for t in traces)
    steps = [m for m in metrics if "train_loss" in m]
    vals = [m for m in metrics if "val_loss" in m]
    if len(steps) != 2 or not all(math.isfinite(m["train_loss"]) for m in steps):
        raise AssertionError(f"[profile] metrics {metrics}")
    if not traces or not all(sizes) or not kernels:
        raise AssertionError(f"[profile] traces {traces}, {sizes} bytes, {kernels} kernel events")
    per_micro, per_eval = forward_launches(ModelConfig(), remat=True), forward_launches(ModelConfig())
    expected = {k: len(steps) * per_micro[k] + len(vals) * per_eval[k] for k in REPLACES}
    if launches != expected:
        raise AssertionError(f"[profile] train launches {launches} != {expected}")
    per_step = ", ".join(f"{m['step_seconds']:.3f}" for m in steps)
    print(f"[profile] train CLI --profile, bucket 192, 2 optimizer steps of batch 2: "
          f"{len(traces)} trace file(s) under <save_dir>/profile, {sum(sizes) / 2**20:.1f} MiB, "
          f"{kernels} CUDA kernel events; main() wall {wall:.1f} s (trace written included); "
          f"{per_step} s per step")


def phase_esm(seed: int) -> None:
    """Phase 21: ESM-2 650M on the card (the port's encoder, both CLI
    backends) and the JAX CLIs' single-device switches."""
    import os

    began = time.perf_counter()
    # transformers imports TensorFlow and jax where they are installed unless told not to
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    with tempfile.TemporaryDirectory() as tmp:
        esm_dir = Path(tmp) / "esm2_t33_650M_seeded"
        write_seeded_esm2(esm_dir, seed)
        print(f"[esm] seeded ESM-2 650M directory (33 layers x 1280, 20 heads, FFN 5120) "
              f"written in {time.perf_counter() - began:.1f} s")
        _esm_encoders(esm_dir, seed)
        _esm_generate(esm_dir, seed)
    _use_pallas_generate(seed)
    _trimul_dmajor(seed)
    _profile_train(seed)
    print(f"[esm] phase wall {time.perf_counter() - began:.1f} s")


# Multi-device on one card (phase 22): two training ranks over gloo and two
# sampling replicas share the card; the gates are the single-device ones
# (GRAD_REL_TOL for a step's loss and grad_norm, FORWARD_REL_TOL for bf16
# samples, PICARD_POS_TOL and PICARD_LOGIT_TOL for Picard at ptol 0) and
# 1e-5 for one f32 forward through the replicas. Picard runs phase 19's
# f32 configuration (DDIM PICARD_STEPS, window PICARD_WINDOW) at B = 2 (16
# rows a sweep, 8 a replica), where phase 19's gate is sharp (bf16's, from
# the same one-ulp response, reaches thousands of Å on these weights). At
# ptol 0 a step converges when its state repeats bit for bit, and the
# split changes the rows' rounding and so the sweep at which a small change
# is first absorbed: the sweeps of the two runs may differ (measured: f32
# DDIM 20, 36 on one device and 38 on the replicas; bf16 DDIM 8, 16 and
# 14), so they must agree within MULTI_SWEEP_TOL of the larger and both
# end below the 2S + 2 cap.
MULTI_F32_TOL, MULTI_SWEEP_TOL = 1e-5, 0.15
# The rank-0 trace's kernels that count K1, K2 and K7 (bf16 bodies; K7's dq
# kernel, one a launch).
TRACE_KERNELS = {"rows_attention": "rows_attention_mma_kernel",
                 "tiled_attention": "tiled_attention_mma_kernel",
                 "rows_attention_bwd": "rows_attention_bwd_dq_mma_kernel"}


def _cli(module: str, argv: list, **env) -> tuple:
    """``python -m protein_redesign_tpu_torch.cli.<module> argv`` in a process
    of its own: (exit code, stdout and stderr, wall s)."""
    import os

    began = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"protein_redesign_tpu_torch.cli.{module}",
                           *argv], cwd=REPO, text=True, capture_output=True, timeout=600,
                          env={**os.environ, "PYTHONPATH": str(REPO), **env})
    return proc.returncode, proc.stdout + proc.stderr, time.perf_counter() - began


def _rank_values(out: str, pattern: str, ranks: int = 2) -> list:
    """Each rank's matches of ``pattern`` after its ``[rank r]`` tag."""
    return [re.findall(rf"\[rank {r}\] {pattern}", out) for r in range(ranks)]


def _trace_kernels(trace_dir: Path) -> dict:
    """Kernel events by TRACE_KERNELS name in the torch.profiler traces."""
    counts = dict.fromkeys(TRACE_KERNELS, 0)
    for trace in trace_dir.glob("*.json"):
        for event in json.loads(trace.read_text())["traceEvents"]:
            if event.get("cat") == "kernel":
                for name, kernel in TRACE_KERNELS.items():
                    counts[name] += kernel in event.get("name", "")
    return counts


def _multi_reject(tmp: Path) -> None:
    """--num_devices past the visible cards: both CLIs exit non-zero with the
    JAX CLIs' message (checked before anything loads)."""
    n = torch.cuda.device_count() + 1
    want = f"--num_devices {n} requested but only {n - 1} CUDA devices are visible"
    from concurrent.futures import ThreadPoolExecutor

    argv = {"train": ["--save_dir", str(tmp / "rejected"), "--data_dir", str(tmp / "data"),
                      "--num_devices", str(n)],
            "generate": ["-c", str(tmp / "none"), "-o", str(tmp / "rejected"), "-p", SEQUENCE,
                         "-l", LIGAND, "-n", "2", "--num_devices", str(n)]}
    with ThreadPoolExecutor(2) as pool:
        runs = dict(zip(argv, pool.map(lambda cli: _cli(cli, argv[cli]), argv)))
    for cli, (code, out, _) in runs.items():
        if code == 0 or want not in out:
            raise AssertionError(f"[multi] {cli} --num_devices {n}: exit {code}\n{out[-2000:]}")
    print(f"[multi] --num_devices {n} with {n - 1} card(s): train and generate exit non-zero "
          f"with \"{want}\"")


def _multi_train(tmp: Path, seed: int, dtype: str, steps: int, profile: bool) -> dict:
    """The train CLI at paper width on phase 22's data, batch 2: one rank in
    this process (exact launches), then two ranks on this card over gloo
    (--num_devices 2 --device cuda:0, one row each). Both ranks' losses and
    checksums agree; step 1's loss and grad_norm agree with one rank's within
    GRAD_REL_TOL; each rank's launches are one rank's micro-steps at batch 1
    and the final validation. Returns the two runs' metrics."""
    from protein_redesign_tpu_torch.cli.train import main as train
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.ops import attention as A

    common = ["--data_dir", str(tmp / "data"), "--batch_size", "2", "--val_every_steps", "0",
              "--log_every_steps", "1", "--warmup_steps", "10", "--seed", str(seed),
              "--dtype", dtype, "--max_steps", str(steps)]
    one_dir, two_dir = tmp / f"one-{dtype}", tmp / f"two-{dtype}"
    A.reset_launch_counts()
    began = time.perf_counter()
    train([*common, "--save_dir", str(one_dir), "--device", "cuda"])
    one_wall = time.perf_counter() - began
    one_launches = main_path_launches()
    cfg = ModelConfig(dtype=dtype)
    per_micro, per_eval = forward_launches(cfg, remat=True), forward_launches(cfg)
    expected = {k: steps * per_micro[k] + per_eval[k] for k in REPLACES}
    if one_launches != expected:
        raise AssertionError(f"[multi] one rank, {dtype}: launches {one_launches} != {expected}")
    code, out, two_wall = _cli("train", [*common, "--save_dir", str(two_dir), "--num_devices", "2",
                                         "--device", "cuda:0", *(["--profile"] if profile else [])],
                               PRD_DIST_BACKEND="gloo")
    if code != 0:
        raise AssertionError(f"[multi] two ranks, {dtype}: exit {code}\n{out[-4000:]}")
    groups = _rank_values(out, r"process group: (\w+), rank \d of 2 on (\S+)")
    losses = _rank_values(out, r"step (\d+): loss=(\S+)")
    sums = _rank_values(out, r"parameter checksum ([0-9a-f]+), equal on the 2 ranks")
    launches = [[eval(x) for x in v] for v in _rank_values(out, r"parameter checksum [0-9a-f]+, "
                                                             r"equal on the 2 ranks; kernel "
                                                             r"launches (\{[^}]*\})")]
    if "mesh: {'data': 2, 'model': 1} on gpu" not in out or groups != [[("gloo", "cuda:0")]] * 2:
        raise AssertionError(f"[multi] two ranks: mesh or group\n{out[-4000:]}")
    if len(losses[0]) != steps or losses[0] != losses[1] or len(sums[0]) != 1 or sums[0] != sums[1]:
        raise AssertionError(f"[multi] two ranks disagree: losses {losses}, checksums {sums}"
                             f"\n{out[-4000:]}")
    want = {k: steps * per_micro[k] + per_eval[k] for k in REPLACES}  # a row a rank
    for r in range(2):
        got = {k: launches[r][0].get(k, 0) for k in REPLACES}
        if got != want:
            raise AssertionError(f"[multi] rank {r} launches {got} != {want}")
    metrics = {name: [json.loads(ln) for ln in (d / "metrics.jsonl").read_text().splitlines()]
               for name, d in (("one", one_dir), ("two", two_dir))}
    rows = {k: [m for m in v if "train_loss" in m] for k, v in metrics.items()}
    if [m["step"] for m in rows["two"]] != list(range(1, steps + 1)):
        raise AssertionError(f"[multi] metrics.jsonl of two ranks: {metrics['two']}")
    if sorted(p.name for p in (two_dir / "checkpoints").iterdir()) != [str(steps)]:
        raise AssertionError("[multi] two ranks: checkpoints")
    gaps = {}
    for key in ("train_loss", "grad_norm"):
        a, b = rows["two"][0][key], rows["one"][0][key]
        gaps[key] = abs(a - b) / abs(b)
        if not gaps[key] <= GRAD_REL_TOL[dtype]:
            raise AssertionError(f"[multi] {dtype} step 1 {key}: two ranks {a}, one rank {b}")
    mean = lambda k, rs: float(np.mean([m[k] for m in rs]))  # noqa: E731
    print(f"[multi] train CLI, {dtype}, bucket 192, batch 2, {steps} step(s): one rank "
          f"{mean('step_seconds', rows['one']):.3f} s per step (main() {one_wall:.1f} s); two "
          f"gloo ranks on cuda:0, a row each, {mean('step_seconds', rows['two']):.3f} s per step, "
          f"all-reduce {mean('allreduce_seconds', rows['two']):.4f} s of "
          f"{rows['two'][0]['grad_bytes'] / 2**20:.2f} MiB a step (host staged), CLI wall "
          f"{two_wall:.1f} s; step 1 loss {rows['two'][0]['train_loss']:.6f} against "
          f"{rows['one'][0]['train_loss']:.6f}, grad_norm {rows['two'][0]['grad_norm']:.6f} "
          f"against {rows['one'][0]['grad_norm']:.6f} (relative {gaps['train_loss']:.2e}, "
          f"{gaps['grad_norm']:.2e}; gate {GRAD_REL_TOL[dtype]}); ranks' losses "
          f"{[float(x) for _, x in losses[0]]} equal, checksum {sums[0][0]} on both; launches "
          f"a rank {{K1 {want['rows_attention']}, K2 {want['tiled_attention']}, K7 "
          f"{want['rows_attention_bwd']}}}")
    if profile:
        # the trace spans the training loop, not the final validation
        traced = _trace_kernels(two_dir / "profile")
        looped = {k: steps * per_micro[k] for k in TRACE_KERNELS}
        if traced != looped:
            raise AssertionError(f"[multi] rank 0's trace {traced} != its steps' launches "
                                 f"{looped}")
        print(f"[multi] rank 0's torch.profiler trace of the loop: {traced} kernel events, the "
              f"launches of its {steps} micro-steps: a micro-step {per_micro['rows_attention']} "
              f"K1 (24 forward + 24 recomputed), {per_micro['tiled_attention']} K2 (13 + 12), "
              f"{per_micro['rows_attention_bwd']} K7")
    return {"two_dir": two_dir, "common": common, "rows": rows}


def _multi_nccl(tmp: Path, trained: dict) -> None:
    """The CLI under the JAX cluster variables at world size 1 with the
    default backend: NCCL joins and all-reduces on the card. (The resume of
    the two ranks' checkpoint is phase 23's, under a (1, 2) mesh.)"""
    import contextlib as ctx
    import io
    import os

    from protein_redesign_tpu_torch.cli.train import main as train
    from protein_redesign_tpu_torch.parallel.mesh import free_port

    common = trained["common"]
    cluster = {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}", "JAX_NUM_PROCESSES": "1",
               "JAX_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in [*cluster, "PRD_DIST_BACKEND"]}
    os.environ.update(cluster)
    os.environ.pop("PRD_DIST_BACKEND", None)
    buffer = io.StringIO()
    try:
        with ctx.redirect_stdout(buffer):
            train([*common[:-1], "2", "--save_dir", str(tmp / "nccl"), "--device", "cuda"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    text = buffer.getvalue()
    rows = [json.loads(ln) for ln in (tmp / "nccl" / "metrics.jsonl").read_text().splitlines()]
    if "process group: nccl, rank 0 of 1 on cuda:0" not in text or "grad_bytes" not in rows[0]:
        raise AssertionError(f"[multi] NCCL at world size 1: {text[-2000:]}\n{rows}")
    steps = [m for m in rows if "grad_bytes" in m]
    reduce_ms = ", ".join(f"{m['allreduce_seconds'] * 1e3:.2f}" for m in steps)
    step_s = ", ".join(f"{m['step_seconds']:.3f}" for m in steps)
    print(f"[multi] JAX cluster variables, world size 1, default backend: nccl joined on cuda:0, "
          f"the gradient all-reduce of {rows[0]['grad_bytes'] / 2**20:.2f} MiB took {reduce_ms} "
          f"ms on the card in steps 1 and 2 (cold, then warm); {step_s} s per step")


def _multi_sample(seed: int) -> None:
    """SamplingRunner with a 2-replica mesh on this card against the runner
    on one device at one seed, on one set of weights, with each replica's
    launches: DDIM SERVE_STEPS at batch 2 in bf16; Picard at ptol 0 (16 rows a
    sweep) in f32; one f32 forward through the replicas against the net."""
    from protein_redesign_tpu_torch.cli.common import SamplingRunner
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.models.prdiff import prepare_batch
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.parallel.mesh import ReplicatedNet, make_mesh

    mesh = make_mesh(["cuda:0", "cuda:0"])
    B = 2

    def timed(runner, data):
        """(results, s, launches, forwards) of one run after a 2-step warm run."""
        steps = runner.ddim_steps
        runner.ddim_steps = 2
        runner.run([data] * B, seed)
        runner.ddim_steps = steps
        runner.timings.clear()
        runner.picard_stats.clear()
        A.reset_launch_counts()
        if runner.mesh is not None:
            runner.net.reset_launches()
        out = runner.run([data] * B, seed)
        forwards = steps if runner.sampler == "ddim" else runner.picard_stats[0]["iterations"]
        return out, runner.timings[0][3], dict(A.LAUNCHES), forwards

    for dtype, sampler, kw in (
            ("bfloat16", "ddim", dict(ddim_steps=SERVE_STEPS)),
            ("float32", "ddim_parallel", dict(ddim_steps=PICARD_STEPS, window=PICARD_WINDOW,
                                              ptol=0.0))):
        cfg = ModelConfig(num_steps=SERVE_SCHEDULE, dtype=dtype)
        net = perturbed_net(cfg, seed).to("cuda").eval()
        per_forward = forward_launches(cfg)
        one = SamplingRunner(net, "cuda", batch_size=B, sampler=sampler, **kw)
        two = SamplingRunner(net, "cuda", batch_size=B, sampler=sampler, mesh=mesh, **kw)
        data = complex_batch_data(one)
        out1, t1, l1, f1 = timed(one, data)
        out2, t2, _, f2 = timed(two, data)
        per_replica = [dict(x) for x in two.net.launches]
        pos1, pos2 = (np.stack([r[0] for r in o]) for o in (out1, out2))
        log1, log2 = (np.stack([r[1] for r in o]) for o in (out1, out2))
        rel_pos = float(np.linalg.norm(pos2 - pos1) / np.linalg.norm(pos1))
        rel_log = float(np.linalg.norm(log2 - log1) / np.linalg.norm(log1))
        dpos = float(np.abs(pos2 - pos1).max())
        want = {k: f1 * v for k, v in per_forward.items()}
        if l1 != want:
            raise AssertionError(f"[multi] {sampler} one device: launches {l1} != {want}")
        for r, got in enumerate(per_replica):
            if {k: got.get(k, 0) for k in REPLACES} != {k: f2 * v for k, v in per_forward.items()}:
                raise AssertionError(f"[multi] {sampler} replica {r}: launches {got}")
        if sampler == "ddim":
            ok = rel_pos <= FORWARD_REL_TOL and rel_log <= FORWARD_REL_TOL
            gate, work = f"gate {FORWARD_REL_TOL} relative norm", f"{f1} steps"
        else:
            # phase 19's f32 gate: PICARD_CONTROL x what one ulp more on z0
            # does to the sequential DDIM sample of these weights
            cpos, clog = _ulp_control(net, one, data, seed)
            n = data["num_atoms"] + data["num_residues"]
            ref = SamplingRunner(net, "cuda", sampler="ddim", ddim_steps=one.ddim_steps)
            spos, slog = ref.run([data], seed)[0][:2]
            pos_tol = max(PICARD_POS_TOL[dtype],
                          PICARD_CONTROL * float(np.abs(cpos[:n] - spos).max()))
            log_tol = max(PICARD_LOGIT_TOL[dtype], PICARD_CONTROL * float(
                np.linalg.norm(clog[:n] - slog) / np.linalg.norm(slog)))
            sweeps_ok = (abs(f1 - f2) <= MULTI_SWEEP_TOL * max(f1, f2)
                         and max(f1, f2) < 2 * PICARD_STEPS + 2)
            ok = sweeps_ok and dpos <= pos_tol and rel_log <= log_tol
            gate = (f"gates {pos_tol:.4g} A and {log_tol:.3g} (PICARD_CONTROL x the one-ulp "
                    f"response of the sequential sample); sweeps {f1} and {f2} (within "
                    f"{MULTI_SWEEP_TOL:.0%} of the larger, below the cap {2 * PICARD_STEPS + 2})")
            work = (f"DDIM {PICARD_STEPS}, {f1} sweeps of {PICARD_WINDOW * B} rows, "
                    f"{PICARD_WINDOW * B // 2} a replica")
        if not ok:
            raise AssertionError(f"[multi] {sampler}: two replicas against one device: positions "
                                 f"{rel_pos} ({dpos} A), logits {rel_log}; {gate}")
        equal = np.array_equal(pos1, pos2) and np.array_equal(log1, log2)
        print(f"[multi] {sampler}, {dtype}, bucket 192, B = {B}, {work}: one device {t1:.3f} s, "
              f"two replicas on cuda:0 {t2:.3f} s; positions {rel_pos:.2e} relative "
              f"({dpos:.3e} A), logits {rel_log:.2e} ({'' if equal else 'not '}bit-equal; "
              f"{gate}); launches replica 0 {per_replica[0]}, replica 1 {per_replica[1]}")
        if dtype == "bfloat16":
            del net, one, two

    replicated = ReplicatedNet(net, mesh)
    _, batch = complex_batch(one, 2)
    batch = prepare_batch(batch, 0.3, generator=torch.Generator("cuda").manual_seed(0))
    g = torch.Generator("cuda").manual_seed(seed)
    N = batch["residue_mask"].shape[1]
    z, seq_t = (torch.randn(2, N, c, generator=g, device="cuda") for c in (3, 21))
    t = torch.tensor([10, 500], device="cuda")
    mask = batch["residue_and_atom_mask"]
    with torch.inference_mode():
        want, got = net(batch, z, seq_t, mask, t), replicated(batch, z, seq_t, mask, t)
    gaps = [_rel(a, b) for a, b in zip(got, want)]
    if not max(gaps) <= MULTI_F32_TOL:
        raise AssertionError(f"[multi] f32 forward through two replicas: {gaps}")
    print(f"[multi] f32 forward at 192, B = 2, through two replicas (a row each) against the net: "
          f"{gaps[0]:.2e} and {gaps[1]:.2e} relative (gate {MULTI_F32_TOL}); launches "
          f"{replicated.launches}")


def phase_multidevice(seed: int, tmp: Path) -> dict:
    """Phase 22: data-parallel training and sampling on this one card; its
    data and the two ranks' run stay in ``tmp`` for phase 23."""
    from protein_redesign_tpu_torch.config import ModelConfig

    began = time.perf_counter()
    esm_dim = ModelConfig().esm_dim
    write_dataset(tmp / "data", {
        "train": [synthetic_complex(SEQUENCE, seed + s, esm_dim) for s in (10, 11)],
        "val": [synthetic_complex(SEQUENCE, seed + 14, esm_dim)]})
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:  # the rejections' processes overlap the training
        rejected = pool.submit(_multi_reject, tmp)
        trained = _multi_train(tmp, seed, "bfloat16", 2, profile=True)
        rejected.result()
    _multi_nccl(tmp, trained)
    _multi_sample(seed)
    print(f"[multi] one card: these times are overhead of sharing it, not scaling; phase wall "
          f"{time.perf_counter() - began:.1f} s")
    return trained


# -- phase 23: the model axis on one card -------------------------------------

# K9 and K11 past their tensor-core bodies; K3/K5 (f32), K6 and K7 past 128
MODEL_AXIS_PAIR_WIDTHS, MODEL_AXIS_HEAD_WIDTH = (36, 192), 256
K9_WIDE = 512  # K9 at the JAX kernel's widest pair width, bf16, on ln_project.cuh's wide block
# the paper-width rows these widths must leave alone (PERF.md §6, on the
# device, bf16, bucket 192, B=2): K9 outgoing, K11's whole call
PAPER_DEVICE_MS = {"triangle_multiply": 0.182, "fused_outer_linear": 0.0491}
PAPER_DRIFT = 0.05
# sequence parallelism: the micro-step at 384 and the forward at 1024 at
# paper width with the depth cut to these blocks (each rank time-slices the
# one card, and every gather crosses the host under gloo)
SP_STEP_BLOCKS, SP_FORWARD_BLOCKS, SP_LONG = 2, 2, LONG_TRAIN


def _width_check(tag: str, got, want, tol: float) -> float:
    rel = float((got.float() - want.float()).norm() / want.float().norm())
    if not (torch.isfinite(got).all() and rel <= tol):
        raise AssertionError(f"[widths] {tag}: relative error {rel} > {tol}")
    return rel


def _k9_args(D: int, dtype, mode: str, mask2d, seed: int) -> tuple:
    """K9's arguments at pair width D, bucket 192, B = 2: a seeded pair and a
    perturbed TriangleMultiplication's weights."""
    from protein_redesign_tpu_torch.models.denoiser import TriangleMultiplication

    N = mask2d.shape[-1]
    g = torch.Generator("cuda").manual_seed(seed)
    pair = torch.randn(2, N, N, D, generator=g, device="cuda").to(dtype)
    tm = perturb(TriangleMultiplication(D, mode, dtype=dtype), 710).to("cuda")
    return (pair, mask2d, tm.ab_gate.weight, tm.ab_gate.bias, tm.ab_proj.weight, tm.ab_proj.bias,
            tm.out_gate.weight, tm.out_gate.bias, tm.out_proj.weight, tm.out_proj.bias)


def _widths_fused() -> None:
    """K9 and K11 at pair widths 36 and 192 (bucket 192, B=2, 147 nodes
    valid) against the plain versions, both dtypes (K9 at 192 on its
    tensor-core body and, timed beside it, on the CUDA-core wide body it
    replaced; at 36 on the wide body; K11 on its CUDA-core body), K9 at 512
    in bf16, and the paper-width rows timed again."""
    from protein_redesign_tpu_torch.models.denoiser import OuterLinear
    from protein_redesign_tpu_torch.ops import outer as O
    from protein_redesign_tpu_torch.ops import trimul as M

    N = 192
    tol = {torch.float32: TOL_F32, torch.bfloat16: TOL_BF16}
    mask2d = _widths_mask2d(N)
    for seed, (D, dtype) in enumerate((D, dt) for D in (*MODEL_AXIS_PAIR_WIDTHS, 64, K9_WIDE)
                                      for dt in (torch.bfloat16, torch.float32)):
        paper, wide = D == 64, D == K9_WIDE
        if (paper or wide) and dtype == torch.float32:
            continue
        g = torch.Generator("cuda").manual_seed(700 + seed)
        single = torch.randn(2, N, 512, generator=g, device="cuda").to(dtype)
        label = f"{str(dtype).replace('torch.', '')}, D={D}"
        cases = []
        for mode in ("outgoing", "incoming")[:1 if paper or wide else 2]:
            cases.append(("triangle_multiply", mode, lambda *a, m=mode: M.trimul(*a, m),
                          lambda *a, m=mode: M.trimul_reference(*a, m),
                          _k9_args(D, dtype, mode, mask2d, 700 + seed)))
        if not wide:
            ol = perturb(OuterLinear(512, D, factored=True, dtype=dtype), 720).to("cuda")
            cases.append(("fused_outer_linear", "factored route", O.outer, O.outer_reference,
                          (single, ol.linear.weight, ol.linear.bias)))
        with torch.inference_mode():
            for name, view, kernel, plain, args in cases:
                body = (M.trimul_body(D) if name == "triangle_multiply" else
                        "tensor cores" if O.outer_takes_tensor_cores(512, D, dtype)
                        else "cuda cores")
                expected = ("tensor cores" if paper or (name == "triangle_multiply" and D % 8 == 0)
                            else "wide" if name == "triangle_multiply" else "cuda cores")
                if body != expected:
                    raise AssertionError(f"[widths] {name} {label} took the {body} body")
                got, want = kernel(*args), plain(*args)
                torch.cuda.synchronize()
                rel = _width_check(f"{name} {view} {label}", got, want, tol[dtype])
                ms, plain_ms = device_ms(lambda: kernel(*args)), device_ms(lambda: plain(*args))
                b = fused_bound(name, args, got)
                line = (f"[widths] {name} ({view}) {label} on the {body} body: ||kernel - plain|| "
                        f"/ ||plain|| {rel:.3e} (tol {tol[dtype]:g}); on the device {ms:.4f} ms, "
                        f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
                if name == "triangle_multiply" and D > 128:  # the CUDA-core wide body it replaced
                    with fused_cuda_core_bodies():
                        core = kernel(*args)
                        core_ms = device_ms(lambda: kernel(*args))
                    torch.cuda.synchronize()
                    core_rel = _width_check(f"{name} {view} {label} wide body", core, want,
                                            tol[dtype])
                    line += (f"; the CUDA-core wide body {core_ms:.4f} ms (its error "
                             f"{core_rel:.3e}, {core_ms / ms:.1f}x)")
                if paper:
                    was = PAPER_DEVICE_MS[name]
                    drift = ms / was - 1
                    line += (f"; the paper-width row was {was} ms: {drift:+.1%} "
                             f"({'held' if abs(drift) <= PAPER_DRIFT else 'missed'}, 5%)")
                print(line)


# The wide tensor-core bodies past head width 128: the kernel each
# must show on the profiler (K6 and K7: their dk/dv kernel, and their dq
# kernel by the same name), and the CUDA-core kernels they replaced, which
# must not run (matched as substrings of the profiler's names: none is part
# of a wide kernel's name).
WIDE_TC_KERNELS = {
    ("rows_attention_kchunk", torch.float32): "rows_attention_kchunk_wide_tf32x3_kernel",
    ("rows_attention_kchunk_stats", torch.float32): "rows_attention_kchunk_wide_tf32x3_kernel",
    ("rows_attention_bwd", torch.float32): "rows_attention_bwd_dkdv_wide_tf32x3_kernel",
    ("rows_attention_bwd", torch.bfloat16): "rows_attention_bwd_dkdv_wide_mma_kernel",
    ("rows_attention", torch.float32): "rows_attention_wide_tf32x3_kernel",
    ("rows_attention_fast", torch.float32): "rows_attention_fast_wide_tf32x3_kernel",
    ("rows_attention_kchunk_bwd", torch.float32): "rows_attention_kchunk_bwd_dkdv_wide_tf32x3_kernel",
    ("rows_attention_kchunk_bwd", torch.bfloat16): "rows_attention_kchunk_bwd_dkdv_wide_mma_kernel",
}
WIDE_CORE_KERNELS = ("rows_attention_kchunk_kernel", "rows_attention_bwd_wide_dq_kernel",
                     "rows_attention_bwd_wide_dkdv_kernel", "rows_attention_kernel",
                     "rows_attention_fast_kernel", "rows_attention_kchunk_dq_kernel",
                     "rows_attention_kchunk_dkdv_kernel")
# the paper-width rows the wide and the C = 4 mod 8 bodies must leave alone
# (PERF.md §6, on the device, H = 4, C = 16, R = 2N up to 384 and R = N from
# 1024): K7 bf16 at 192, K3 f32 at 1024, K1 f32 at 192, K1 fast f32 at 384,
# K6 f32 at 1024, K1 bf16 at 192, K3 bf16 at 2048
PAPER_ATTENTION_MS = {("rows_attention_bwd", 192, torch.bfloat16): 0.2126,
                      ("rows_attention_kchunk", 1024, torch.float32): 7.990,
                      ("rows_attention", 192, torch.float32): 0.1316,
                      ("rows_attention_fast", 384, torch.float32): 2.711,
                      ("rows_attention_kchunk_bwd", 1024, torch.float32): 28.71,
                      ("rows_attention", 192, torch.bfloat16): 0.0801,
                      ("rows_attention_kchunk", 2048, torch.bfloat16): 20.22}
PAPER_VALID = {192: 147, 384: 360, 1024: 997, 2048: 2037}


# Phase 23's kernel names, read by torch.profiler in one fresh process: late
# in this one (after the multi-device phase) the profiler returned no kernel
# at all, even for a window of three calls behind a finished spin; and in a
# fresh process it has dropped a window's kernels (all of a call's) where no
# spin ran before the calls. So each window runs a spin to its end first and
# stays open 0.1 s after the calls, as the CUDA tests' _kernel_names does.
# "attention": K1, K1 fast, K3, K5 (f32), K6 and K7 (both dtypes) at head
# width C; "fused": K8 at K8_WIDTHS and K8_WIDE, K9 at 192 and K9_WIDE, both
# dtypes, and one forward of the bf16 fused net at pair width 192 (2 blocks);
# "narrow": K1, K1 fast, K3 and K5 at NARROW_C and NARROW_C + 4 (R = 384, N =
# 192, H = 4), both dtypes, and one forward of narrow_net.
_WIDTH_NAMES = r"""
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as c
from protein_redesign_tpu_torch.ops import attention as A
from protein_redesign_tpu_torch.ops import trimul as M

def names(fn):
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda._sleep(200_000_000)
        torch.cuda.synchronize()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.1)
    return [e.key for e in prof.key_averages() if "kernel" in e.key]

C, attention, fused = int(sys.argv[2]), {}, {}
for name, dt in (("rows_attention_kchunk", "float32"), ("rows_attention_kchunk_stats", "float32"),
                 ("rows_attention_bwd", "float32"), ("rows_attention_bwd", "bfloat16"),
                 ("rows_attention", "float32"), ("rows_attention_fast", "float32"),
                 ("rows_attention_kchunk_bwd", "float32"),
                 ("rows_attention_kchunk_bwd", "bfloat16")):
    g = torch.Generator("cuda").manual_seed(0)
    q, k, v, dout = (torch.randn(4, 64, 1, C, generator=g, device="cuda").to(getattr(torch, dt))
                     for _ in range(4))
    mask = torch.ones(4, 64, device="cuda")
    if name == "rows_attention_bwd":
        fn = lambda: A.rows_attention_bwd(q, k, v, mask, dout, 0.1)
    elif name == "rows_attention_kchunk_bwd":
        o, m, logs = A.rows_attention_kchunk_reference(q, k, v, mask, 0.1, stats=True)
        fn = lambda: A.rows_attention_kchunk_bwd(q, k, v, mask, dout, o, m, logs, 0.1)
    else:
        fn = lambda: getattr(A, name)(q, k, v, mask, 0.1)
    attention[f"{name} {dt}"] = names(fn)
mask2d = c._widths_mask2d()
with torch.inference_mode():
    for dt in (torch.bfloat16, torch.float32):
        for D, H, C8 in (*c.K8_WIDTHS, c.K8_WIDE):
            args = c._k8_args(D, H, C8, dt, mask2d, 1)
            fused[f"k8 {D} {H} {C8} {dt}"] = names(lambda: A.fused_gated(*args))
        for D in (192, c.K9_WIDE):
            args = c._k9_args(D, dt, "outgoing", mask2d, 1)
            fused[f"k9 {D} {dt}"] = names(lambda: M.trimul(*args, "outgoing"))
    net = c.fused_net(pair_dim=192, num_blocks=2).to("cuda").eval()
    inputs = c.forward_inputs(net)
    fused["net"] = names(lambda: net(*inputs))
    del net
narrow = {}
for dt in ("bfloat16", "float32"):
    for Cn in (c.NARROW_C, c.NARROW_C + 4):
        q, k, v, mask, _ = c._attention_case(384, 192, 4, Cn, getattr(torch, dt), 147, True, False,
                                             True, 0)
        for name in c.NARROW_NAMES:
            narrow[f"{name} {dt} {Cn}"] = names(lambda: getattr(A, name)(q, k, v, mask, 0.2))
with torch.inference_mode():
    net = c.narrow_net().to("cuda").eval()
    inputs = c.forward_inputs(net)
    narrow["net"] = names(lambda: net(*inputs))
print(json.dumps({"attention": attention, "fused": fused, "narrow": narrow}))
"""
_WIDTH_NAMES_RAN: dict = {}


def _width_kernel_names() -> dict:
    """_WIDTH_NAMES's {"attention": {(name, dtype): kernels}, "fused": {tag:
    kernels}, "narrow": {tag: kernels}} ("attention" at head width
    MODEL_AXIS_HEAD_WIDTH, "narrow" at NARROW_C and NARROW_C + 4 and the
    narrow_net forward), from one fresh process (the library is built
    already), run by the first caller."""
    if not _WIDTH_NAMES_RAN:
        proc = subprocess.run([sys.executable, "-c", _WIDTH_NAMES, str(REPO),
                               str(MODEL_AXIS_HEAD_WIDTH)], capture_output=True, text=True,
                              timeout=600, env={**os.environ, "PRD_DISABLE_ESM": "1"})
        if proc.returncode != 0:
            raise AssertionError(f"[widths] the kernel-name process failed:\n"
                                 f"{proc.stderr[-3000:]}")
        ran = json.loads(proc.stdout.strip().splitlines()[-1])
        _WIDTH_NAMES_RAN["fused"] = ran["fused"]
        _WIDTH_NAMES_RAN["narrow"] = ran["narrow"]
        _WIDTH_NAMES_RAN["attention"] = {(key.split()[0], getattr(torch, key.split()[1])): v
                                         for key, v in ran["attention"].items()}
    return _WIDTH_NAMES_RAN


def _widths_attention() -> None:
    """Triangle attention at head width 256 (R = 384 rows at bucket 192, one
    head, 147 nodes valid) against the plain versions, with SDPA's time and
    the bound: K6 and K7 in both dtypes and K1, K1 fast, K3 and K5 in f32 on
    their wide tensor-core bodies (the profiler shows which kernel ran),
    each beside its CUDA-core body; K3, K5 and K6 in f32 also at N = 1024 (R
    = 1024), where the f32 plan takes them (K6 there on its wide body only).
    Then the paper-width rows of PAPER_ATTENTION_MS timed again."""
    from protein_redesign_tpu_torch.ops import attention as A

    C = MODEL_AXIS_HEAD_WIDTH
    scale = 1.0 / math.sqrt(C)
    ran = _width_kernel_names()["attention"]
    for (name, dtype), want_kernel in WIDE_TC_KERNELS.items():
        names = ran[(name, dtype)]
        wanted = {want_kernel, want_kernel.replace("dkdv", "dq")}  # K7: both of its kernels
        if (not all(any(w in n for n in names) for w in wanted)
                or any(c in n for n in names for c in WIDE_CORE_KERNELS)):
            raise AssertionError(f"[widths] {name} at C={C} {dtype} ran {names}")
    print(f"[widths] the profiler (a fresh process) shows the wide tensor-core kernels at C={C}: "
          f"{sorted(set(WIDE_TC_KERNELS.values()))} (and K7's dq kernels), and none of "
          f"{list(WIDE_CORE_KERNELS)}")
    for seed, (dtype, N, n_valid) in enumerate(((torch.float32, 192, 147),
                                                (torch.bfloat16, 192, 147),
                                                (torch.float32, 1024, 997))):
        label = str(dtype).replace("torch.", "")
        q, k, v, mask, _ = _attention_case((2 if N == 192 else 1) * N, N, 1, C, dtype, n_valid,
                                           True, False, True, 730 + seed)
        R = q.shape[0]
        g = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(740 + seed),
                        device="cuda").to(dtype)
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
        cases = []
        if N == 192:
            out, m, logs = A.rows_attention_kchunk_reference(q, k, v, mask, scale, stats=True)
            cases += [("rows_attention_bwd",
                       lambda: A.rows_attention_bwd(q, k, v, mask, g, scale),
                       lambda: A.rows_attention_bwd_reference(q, k, v, mask, g, scale), 5, 7, 0.0,
                       dict(dout=g)),
                      ("rows_attention_kchunk_bwd",
                       lambda: A.rows_attention_kchunk_bwd(q, k, v, mask, g, out, m, logs, scale),
                       lambda: A.rows_attention_kchunk_bwd_reference(q, k, v, mask, g, out, m, logs,
                                                                     scale), 5, 8,
                       3 * m.numel() * 4, dict(dout=g, out=out, m=m, logs=logs))]
            if dtype == torch.float32:
                cases += [("rows_attention",
                           lambda: (A.rows_attention(q, k, v, mask, scale),),
                           lambda: (A.attention_reference(q, k, v, mask, None, scale),), 2, 4,
                           0.0, {}),
                          ("rows_attention_fast",
                           lambda: (A.rows_attention_fast(q, k, v, mask, scale),),
                           lambda: (A.rows_attention_fast_reference(q, k, v, mask, scale),), 2,
                           4, 0.0, {})]
        else:  # K6 in its regime, from the plain K5's stats; its wide body only
            out, m, logs = A.rows_attention_kchunk_reference(q, k, v, mask, scale, stats=True)
            cases += [("rows_attention_kchunk_bwd",
                       lambda: A.rows_attention_kchunk_bwd(q, k, v, mask, g, out, m, logs, scale),
                       lambda: A.rows_attention_kchunk_bwd_reference(q, k, v, mask, g, out, m, logs,
                                                                     scale), 5, 8,
                       3 * m.numel() * 4, None)]
        if dtype == torch.float32:
            cases += [("rows_attention_kchunk",
                       lambda: (A.rows_attention_kchunk(q, k, v, mask, scale),),
                       lambda: (A.rows_attention_kchunk_reference(q, k, v, mask, scale),), 2, 4,
                       0.0, {}),
                      ("rows_attention_kchunk_stats",
                       lambda: A.rows_attention_kchunk_stats(q, k, v, mask, scale),
                       lambda: A.rows_attention_kchunk_reference(q, k, v, mask, scale,
                                                                 stats=True), 2, 4,
                       2 * R * N * 4, {})]
        for name, kernel, plain, products, operands, extra, core_args in cases:
            wide = (name, dtype) in WIDE_TC_KERNELS
            if A.takes_tensor_cores(name, dtype, C) != wide:
                raise AssertionError(f"[widths] {name} at C={C} {label}: tensor cores "
                                     f"{A.takes_tensor_cores(name, dtype, C)}, expected {wide}")
            before = A.LAUNCHES[name]
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if A.LAUNCHES[name] != before + 1:
                raise AssertionError(f"[widths] {name} at C={C}: no launch")
            tol_name = TOL_BF16 if name == "rows_attention_fast" else tol  # its bf16 softmax

            def max_err(outs, body):
                errs = []
                for a, b in zip(outs, want):
                    scale_b = max(float(b.float().abs().max()), 1.0)
                    err = float((a.float() - b.float()).abs().max())
                    errs.append(err)
                    if not (torch.isfinite(a).all() and err <= tol_name * scale_b):
                        raise AssertionError(f"[widths] {name} at C={C} {label} on the {body}: max "
                                             f"abs err {err} > {tol_name} x {scale_b}")
                return max(errs)

            body = "CUDA-core body"
            if wide:
                body = f"wide tensor-core body ({WIDE_TC_KERNELS[(name, dtype)]})"
            err = max_err(got, body)
            iters = 2 if N == 192 else 1
            ms, plain_ms = device_ms(kernel, iters), device_ms(plain, iters)
            line = f"on the device {ms:.4f} ms"
            if wide and core_args is not None:
                core = lambda: A.attention_body(name, q, k, v, mask, None, scale,  # noqa: E731
                                                mma=False, **core_args)
                core_out = core()
                torch.cuda.synchronize()
                core_err = max_err(core_out if isinstance(core_out, tuple) else (core_out,),
                                   "CUDA-core body")
                core_ms = device_ms(core, iters)
                line += (f" (its CUDA-core body: max abs err {core_err:.3e}, {core_ms:.4f} ms, "
                         f"{core_ms / ms:.1f}x)")
            bnd = attention_bound(q, mask, None, products=products, operands=operands,
                                  extra_bytes=extra)
            lib = library_ms(q, k, v, mask, None, scale,
                             dout=g if name.endswith("bwd") else None)
            lib_txt = "refused" if lib is None else f"{lib:.4f}"
            verdict = "" if lib is None else (f"; {'held' if ms <= lib else 'missed'} against "
                                              f"SDPA ({ms / lib:.2f}x)")
            print(f"[widths] {name} R={R} H=1 N={N} C={C} {label} on the {body}: max abs err "
                  f"{err:.3e} (tol {tol_name:g} x max(1, max|x|)); {line}, plain {plain_ms:.4f} "
                  f"ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), library (SDPA, "
                  f"{label}) {lib_txt} ms{verdict}")
        del q, k, v, g
        if N == 1024:
            del out, m, logs
    for (name, N, dtype), was in PAPER_ATTENTION_MS.items():
        q, k, v, mask, _ = _attention_case((2 if N <= 384 else 1) * N, N, 4, 16, dtype,
                                           PAPER_VALID[N], True, False, True, 750)
        if name not in ("rows_attention_bwd", "rows_attention_kchunk_bwd"):
            fn = lambda: getattr(A, name)(q, k, v, mask, 0.25)  # noqa: E731
        elif name == "rows_attention_bwd":
            g = torch.randn_like(q)
            fn = lambda: A.rows_attention_bwd(q, k, v, mask, g, 0.25)  # noqa: E731
        else:
            g = torch.randn_like(q)
            out, m, logs = A.rows_attention_kchunk_stats(q, k, v, mask, 0.25)
            fn = lambda: A.rows_attention_kchunk_bwd(q, k, v, mask, g, out, m, logs,  # noqa: E731
                                                     0.25)
        if A.takes_tensor_cores(name, dtype, 16) is not True:
            raise AssertionError(f"[widths] paper-width {name}: not on its tensor-core body")
        ms = device_ms(fn, 3)
        drift = ms / was - 1
        print(f"[widths] paper-width {name} at {N} ({str(dtype).replace('torch.', '')}): on the "
              f"device {ms:.4f} ms; the row was {was} ms: {drift:+.1%} "
              f"({'held' if abs(drift) <= PAPER_DRIFT else 'missed'}, 5%)")


# Head widths C = 4 mod 8 on the tensor cores (K1, K1 fast, K3, K5): the
# rows at NARROW_C beside NARROW_C + 4, the multiple of 8 that pads to the
# same width, at bucket 192, B = 2 (R = 384, N = 192, H = 4, 147 nodes
# valid); each C = 36 body within NARROW_SLOWDOWN of its C = 40 time in the
# same run. The CUDA-core kernels they replaced (substrings of the
# profiler's names), which must not run at C = 36 nor in narrow_net.
NARROW_C, NARROW_SLOWDOWN = 36, 1.15
NARROW_NAMES = ("rows_attention", "rows_attention_fast", "rows_attention_kchunk",
                "rows_attention_kchunk_stats")
NARROW_CORE_KERNELS = ("rows_attention_kernel", "rows_attention_fast_kernel",
                       "rows_attention_kchunk_kernel")


def narrow_net():
    """ModelConfig() at head width NARROW_C, 2 blocks, seeded and perturbed
    weights (bf16): its triangle attentions take K1 at C = 36, its single
    attentions K2's CUDA-core body."""
    from protein_redesign_tpu_torch.models.prdiff import ModelConfig

    return perturbed_net(ModelConfig(head_dim=NARROW_C, num_blocks=2))


def _narrow_fns(name, q, k, v, mask, scale):
    """``name``'s wrapper call, its plain version and its CUDA-core body."""
    from protein_redesign_tpu_torch.ops import attention as A

    plain = {"rows_attention": lambda: A.attention_reference(q, k, v, mask, None, scale),
             "rows_attention_fast": lambda: A.rows_attention_fast_reference(q, k, v, mask, scale),
             "rows_attention_kchunk": lambda: A.rows_attention_kchunk_reference(q, k, v, mask,
                                                                               scale),
             "rows_attention_kchunk_stats": lambda: A.rows_attention_kchunk_reference(
                 q, k, v, mask, scale, stats=True)}[name]
    return (lambda: getattr(A, name)(q, k, v, mask, scale), plain,
            lambda: A.attention_body(name, q, k, v, mask, None, scale, mma=False))


def _narrow_err(tag: str, name: str, got, want, dtype) -> float:
    """Max abs error against the plain version, held to phase 23's gates
    (bf16 and K1 fast 2e-2, f32 1e-5; K5's m and log s 1e-5) times max(1,
    max|plain|)."""
    got, want = ((x,) if torch.is_tensor(x) else x for x in (got, want))
    errs = []
    for i, (a, b) in enumerate(zip(got, want)):
        tol = (TOL_F32 if i or (dtype == torch.float32 and name != "rows_attention_fast")
               else TOL_BF16)
        scale_b = max(float(b.float().abs().max()), 1.0)
        err = float((a.float() - b.float()).abs().max())
        if not (torch.isfinite(a).all() and err <= tol * scale_b):
            raise AssertionError(f"[narrow] {tag}: max abs err {err} > {tol} x {scale_b}")
        errs.append(err)
    return max(errs)


def _short_name(names, want: str) -> str:
    """The profiler's name of the kernel that contains ``want``, without its
    namespace and parameters."""
    hits = [re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "", n) for n in names if want in n]
    return hits[0] if hits else "none"


def _narrow_library(ms: float, q, k, v, mask, bias, scale, dout=None) -> str:
    """SDPA's time on the same inputs, its backend and ms / SDPA; where only
    the math backend takes them (bf16 at C = 4 mod 8), also the
    memory-efficient one on q, k, v (and dO) zero-padded to a multiple of 8,
    which gives the same function."""
    lib, backend = library_ms(q, k, v, mask, bias, scale, dout=dout, report=True)
    text = f"SDPA ({backend}) " + ("refused" if lib is None else f"{lib:.4f} ms, {ms / lib:.2f}x")
    if backend == "MATH":
        pad = -q.shape[-1] % 8
        padded = [torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v)]
        g = None if dout is None else torch.nn.functional.pad(dout, (0, pad))
        lib_p, backend_p = library_ms(*padded, mask, bias, scale, dout=g, report=True)
        text += (f"; SDPA ({backend_p}) on the head zero-padded to {q.shape[-1] + pad} "
                 + ("refused" if lib_p is None else f"{lib_p:.4f} ms, {ms / lib_p:.2f}x"))
    return text


def _widths_narrow() -> None:
    """K1, K1 fast, K3 and K5 at C = 36 (4 mod 8) on their tensor-core bodies
    beside C = 40, both dtypes: against the plain versions, the kernel the
    profiler showed (a fresh process), device ms against C = 40's, the
    CUDA-core body's at 36 (one warm call), SDPA's and its backend, the
    bound. Then parity only at C = 260 (H = 1) in both dtypes and at N =
    1024 (f32, R = 1024) for K3 and K5; K2, K6 and K7 at C = 36, timing only
    (their CUDA-core bodies against SDPA); and narrow_net, kernel route
    against plain route, exact launches, no CUDA-core K1 or K3 kernel on
    the profiler."""
    from protein_redesign_tpu_torch.ops import attention as A

    ran = _width_kernel_names()["narrow"]
    kernels = {torch.bfloat16: {"rows_attention": "rows_attention_mma_kernel",
                                "rows_attention_fast": "rows_attention_fast_mma_kernel"},
               torch.float32: {"rows_attention": "rows_attention_tf32x3_kernel",
                               "rows_attention_fast": "rows_attention_fast_tf32x3_kernel"}}
    for dtype, kchunk in ((torch.bfloat16, "rows_attention_kchunk_mma_kernel"),
                          (torch.float32, "rows_attention_kchunk_tf32x3_kernel")):
        label = str(dtype).replace("torch.", "")
        times = {}
        for C in (NARROW_C + 4, NARROW_C):
            q, k, v, mask, _ = _attention_case(384, 192, 4, C, dtype, 147, True, False, True,
                                               780 + C)
            scale = C ** -0.5
            for name in NARROW_NAMES:
                tag = f"{name} C={C} {label}"
                if not A.takes_tensor_cores(name, dtype, C):
                    raise AssertionError(f"[narrow] {tag}: not on its tensor-core body")
                names = ran[f"{name} {label} {C}"]
                want_kernel = kernels[dtype].get(name, kchunk)
                if (not any(want_kernel in n for n in names)
                        or any(c in n for n in names for c in NARROW_CORE_KERNELS)):
                    raise AssertionError(f"[narrow] {tag} ran {names}")
                kernel, plain, core = _narrow_fns(name, q, k, v, mask, scale)
                before = A.LAUNCHES[name]
                got = kernel()
                torch.cuda.synchronize()
                if A.LAUNCHES[name] != before + 1:
                    raise AssertionError(f"[narrow] {tag}: no launch")
                err = _narrow_err(tag, name, got, plain(), dtype)
                # ten calls behind the spin: the C = 36 / 40 ratio is the gate
                ms, plain_ms = device_ms(kernel, 10), device_ms(plain, 1)
                times[(name, C)] = ms
                extra = 2 * q.shape[0] * 4 * 192 * 4 if name.endswith("stats") else 0.0
                bnd = attention_bound(q, mask, None, products=2, operands=4, extra_bytes=extra)
                line = (f"[narrow] {name} R=384 H=4 N=192 C={C} {label} on "
                        f"{_short_name(names, want_kernel)}: max abs err {err:.3e}; on the device "
                        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
                        f"({bnd['bound_by']}), " + _narrow_library(ms, q, k, v, mask, None, scale))
                if C == NARROW_C:
                    core_err = _narrow_err(f"{tag} CUDA-core body", name, core(), plain(), dtype)
                    core_ms = device_ms(core, 1)
                    ratio = ms / times[(name, C + 4)]
                    line += (f"; its CUDA-core body {core_ms:.4f} ms (max abs err {core_err:.3e}, "
                             f"{core_ms / ms:.1f}x); against C={C + 4} {ratio:.3f}x ("
                             f"{'held' if ratio <= NARROW_SLOWDOWN else 'missed'}, "
                             f"{NARROW_SLOWDOWN})")
                print(line)
            del q, k, v, mask
    # parity only: C = 260 (one head, as the C = 256 rows), and K3 and K5 at
    # N = 1024 in f32 (R = 1024, 997 nodes valid)
    for dtype, R, N, H, C, n_valid, names in (
            (torch.bfloat16, 384, 192, 1, 260, 147, NARROW_NAMES),
            (torch.float32, 384, 192, 1, 260, 147, NARROW_NAMES),
            (torch.float32, 1024, 1024, 4, NARROW_C, 997, NARROW_NAMES[2:])):
        label = str(dtype).replace("torch.", "")
        q, k, v, mask, _ = _attention_case(R, N, H, C, dtype, n_valid, True, False, True, 790 + C)
        errs = []
        for name in names:
            kernel, plain, _ = _narrow_fns(name, q, k, v, mask, C ** -0.5)
            err = _narrow_err(f"{name} N={N} C={C} {label}", name, kernel(), plain(), dtype)
            errs.append(f"{name} {err:.3e}")
        print(f"[narrow] parity R={R} H={H} N={N} C={C} {label} on the tensor cores, max abs err: "
              + ", ".join(errs))
        del q, k, v, mask
    # K2, K6 and K7 at C = 36: their CUDA-core bodies (timing only), K2 at
    # its main-path shape (single attention: R = B = 2, key mask and bias)
    for dtype in (torch.bfloat16, torch.float32):
        label = str(dtype).replace("torch.", "")
        C = NARROW_C
        scale = C ** -0.5
        q, k, v, mask, _ = _attention_case(384, 192, 4, C, dtype, 147, True, False, True, 800)
        g = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(801),
                        device="cuda").to(dtype)
        out, m, logs = A.rows_attention_kchunk_reference(q, k, v, mask, scale, stats=True)
        q2, k2, v2, mask2, bias2 = _attention_case(2, 192, 4, C, dtype, 147, True, True, False,
                                                   802)
        for name, fn, lib_args, bnd in (
                ("tiled_attention", lambda: A.tiled_attention(q2, k2, v2, mask2, bias2, scale),
                 (q2, k2, v2, mask2, bias2, scale), attention_bound(q2, mask2, bias2, 2, 4)),
                ("rows_attention_bwd", lambda: A.rows_attention_bwd(q, k, v, mask, g, scale),
                 (q, k, v, mask, None, scale, g), attention_bound(q, mask, None, 5, 7)),
                ("rows_attention_kchunk_bwd",
                 lambda: A.rows_attention_kchunk_bwd(q, k, v, mask, g, out, m, logs, scale),
                 (q, k, v, mask, None, scale, g),
                 attention_bound(q, mask, None, 5, 8, 3 * m.numel() * 4))):
            if A.takes_tensor_cores(name, dtype, C):
                raise AssertionError(f"[narrow] {name} C={C} {label} took a tensor-core body")
            ms = device_ms(fn, 1)
            R = lib_args[0].shape[0]
            print(f"[narrow] {name} R={R} H=4 N=192 C={C} {label} on its CUDA-core body: on the "
                  f"device {ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}), "
                  + _narrow_library(ms, *lib_args))
        del q, k, v, mask, g, out, m, logs, q2, k2, v2, mask2, bias2
    # narrow_net: the kernel route against the plain route, launches, kernels
    names = ran["net"]
    core = [n for n in names if any(c in n for c in NARROW_CORE_KERNELS)]
    if core or not any("rows_attention_mma_kernel" in n for n in names):
        raise AssertionError(f"[narrow] the C={NARROW_C} net ran {names}")
    net = narrow_net().to("cuda").eval()
    inputs = forward_inputs(net)
    with torch.inference_mode():
        A.reset_launch_counts()
        kernel_out = net(*inputs)
        torch.cuda.synchronize()
        launches = main_path_launches()
        with A.plain_route():
            plain_out = net(*inputs)
    if launches != forward_launches(net.cfg):
        raise AssertionError(f"[narrow] the C={NARROW_C} net launched {launches}")
    rels = [_width_check(f"C={NARROW_C} net output {i}", a, b, FORWARD_REL_TOL)
            for i, (a, b) in enumerate(zip(kernel_out, plain_out))]
    print(f"[narrow] bf16 net at head width {NARROW_C}, 2 blocks, bucket 192, B=2: noise_pred and "
          f"seq_pred {rels[0]:.3e}, {rels[1]:.3e} from the plain route (tol {FORWARD_REL_TOL:g}); "
          f"launches {({k: n for k, n in launches.items() if n})}; the profiler shows "
          f"{_short_name(names, 'rows_attention_mma_kernel')} and "
          f"{_short_name(names, 'tiled_attention_kernel')} (K2's CUDA-core body), none of "
          f"{list(NARROW_CORE_KERNELS)}")
    del net


# K8 past its old bound of 128: (D, H, C) on the tensor-core body at pair
# width 192, and on the split route one head of 256, C = 36 (4 mod 8, past
# 32) and H C = 1024; the paper-width row it must leave alone (0.157 ms on
# the device, bf16, bucket 192, B = 2)
K8_WIDTHS = ((192, 4, 16), (64, 1, 256), (64, 4, 36), (128, 8, 128))
K8_WIDE = (512, 1, 128)  # the widest pair width, bf16, on ln_project.cuh's wide block
K8_PAPER_MS = 0.157
# the split route at C = 36 runs K3's tensor-core body since C = 4 mod 8
# came to it: under K8_NARROW_MS in bf16 (1.538 on the CUDA-core K3), under
# its plain version in f32
K8_NARROW, K8_NARROW_MS = (64, 4, 36), 0.6
# The CUDA-core projection kernels that K8's and K9's tensor-core routes
# replaced past pair width 128 and on K8's split route (substrings of the
# profiler's kernel names): none may run in the pair-192 net or on any of
# K8_WIDTHS, K8_WIDE, K9 at 192 and K9_WIDE.
CORE_PROJECTIONS = ("fused_gated_project_kernel", "fused_gated_out_kernel",
                    "trimul_project_wide_kernel", "trimul_out_wide_kernel")


def k8_tensor_core_kernels(D: int, H: int, C: int, dtype) -> tuple:
    """The tensor-core kernels K8's route at (D, H, C) launches in ``dtype``
    (substrings of the profiler's names): the LN + projection
    (ln_project.cuh's block up to D = 128, its wide block past it, and on
    the split route where ``split_projection_block`` picks it), then the
    fused attention body, or on the split route K3's tensor-core body and
    the gate + out-projection."""
    from protein_redesign_tpu_torch.ops import attention as A

    split = A.fused_gated_body(D, H, C) == "split"
    wide = D > 128 or (split and A.split_projection_block(D, dtype) == "wide")
    project = "fused_gated_project_mma_wide_kernel" if wide else "fused_gated_project_mma_kernel"
    if not split:
        return (project, "fused_gated_attention_")
    k3 = ("rows_attention_kchunk_mma_kernel" if dtype == torch.bfloat16 else
          "rows_attention_kchunk_tf32x3_kernel" if C <= A.MAX_TC_HEAD_DIM else
          "rows_attention_kchunk_wide_tf32x3_kernel")
    return (project, k3, "fused_gated_out_mma_kernel")


K9_TC_KERNELS = {True: ("trimul_project_mma_wide_kernel", "trimul_contract_kernel",
                        "trimul_out_mma_wide_kernel"),
                 False: ("trimul_project_mma_kernel", "trimul_contract_kernel",
                         "trimul_out_mma_kernel")}  # past 128 or not


def _k8_args(D: int, H: int, C: int, dtype, mask2d, seed: int) -> tuple:
    """K8's arguments at (D, H, C), bucket 192, B = 2, the starting view: a
    seeded pair and weights."""
    N = mask2d.shape[-1]
    g = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn(2, N, N, D, generator=g, device="cuda").to(dtype)
    ws = [torch.randn(H * C, D, generator=g, device="cuda") * D ** -0.5 for _ in range(4)]
    ws += [0.3 * torch.randn(H * C, generator=g, device="cuda"),
           torch.randn(D, H * C, generator=g, device="cuda") * (H * C) ** -0.5,
           0.1 * torch.randn(D, generator=g, device="cuda")]
    return (x, mask2d, *ws, H)


def _widths_mask2d(N: int = 192, n_valid: int = 147):
    """Phase 23's pair mask at bucket N, B = 2: the first n_valid nodes."""
    node = (torch.arange(N, device="cuda") < n_valid).float()
    return (node[:, None] * node[None, :]).expand(2, N, N).contiguous()


def _check_kernel_names(tag: str, names: list, want: tuple) -> None:
    """``want`` all ran, and none of CORE_PROJECTIONS nor K3's CUDA-core
    kernel (K8's split route at C = 4 mod 8 takes K3's tensor cores)."""
    missing = [k for k in want if not any(k in n for n in names)]
    core = [n for n in names
            if any(k in n for k in CORE_PROJECTIONS + ("rows_attention_kchunk_kernel",))]
    if missing or core:
        raise AssertionError(f"[widths] {tag}: missing {missing}, CUDA-core projections {core} "
                             f"(ran {names})")


def _widths_fused_gated() -> None:
    """K8 at K8_WIDTHS (bucket 192, B = 2, 147 nodes valid, the starting
    view) against its plain version in both dtypes and at K8_WIDE in bf16,
    with its route (its tensor-core kernels by the predicates, and by the
    profiler's names in a fresh process, with K9's), device time, the plain
    version's and the bound; then the paper-width K8 (D = 64, h16x4, bf16)
    timed again."""
    from protein_redesign_tpu_torch.ops import attention as A

    names = _width_kernel_names()["fused"]
    for tag, ran in names.items():
        if tag == "net":
            continue
        parts = tag.split()
        if parts[0] == "k8":
            want = k8_tensor_core_kernels(*map(int, parts[1:4]), getattr(torch, parts[4][6:]))
        else:
            want = K9_TC_KERNELS[int(parts[1]) > 128]
        _check_kernel_names(tag, ran, want)
        print(f"[widths] {tag.replace('torch.', '')} ran "
              + ", ".join(sorted({re.sub(r"^void |\(anonymous namespace\)::|<.*$", "", n)
                                  for n in ran})))
    _check_kernel_names("the pair-192 net", names["net"],
                        ("fused_gated_project_mma_wide_kernel", "trimul_project_mma_wide_kernel"))
    print(f"[widths] the bf16 pair-192 net ran no CUDA-core projection kernel "
          f"({', '.join(CORE_PROJECTIONS)}): {len(names['net'])} kernels on the profiler")

    tol = {torch.float32: TOL_F32, torch.bfloat16: TOL_BF16}
    mask2d = _widths_mask2d()
    for seed, ((D, H, C), dtype) in enumerate(
            (w, dt) for w in (*K8_WIDTHS, K8_WIDE, (64, 4, 16))
            for dt in (torch.bfloat16, torch.float32)):
        paper = (D, H, C) == (64, 4, 16)
        if (paper or (D, H, C) == K8_WIDE) and dtype == torch.float32:
            continue
        args = _k8_args(D, H, C, dtype, mask2d, 760 + seed)
        label = f"{str(dtype).replace('torch.', '')}, D={D}, H={H}, C={C}"
        body = A.fused_gated_body(D, H, C)
        if not (paper or body == "split" or A.fused_gated_takes_tensor_cores(D, H, C)):
            raise AssertionError(f"[widths] K8 {label} took the {body} route")
        body += " (" + ", ".join(k8_tensor_core_kernels(D, H, C, dtype)) + ")"
        with torch.inference_mode():
            A.reset_launch_counts()
            got = A.fused_gated(*args)
            torch.cuda.synchronize()
            if main_path_launches() != launch_record(fused_gated_rows_attention=1):
                raise AssertionError(f"[widths] K8 {label}: launches {main_path_launches()}")
            want = A.fused_gated_reference(*args)
            rel = _width_check(f"fused_gated_rows_attention {label}", got, want, tol[dtype])
            ms = device_ms(lambda: A.fused_gated(*args))
            plain_ms = device_ms(lambda: A.fused_gated_reference(*args))
        b = fused_bound("fused_gated_rows_attention", args, got)
        line = (f"[widths] fused_gated_rows_attention {label} on the {body} route: ||kernel - "
                f"plain|| / ||plain|| {rel:.3e} (tol {tol[dtype]:g}); on the device {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        if paper:
            drift = ms / K8_PAPER_MS - 1
            line += (f"; the paper-width row was {K8_PAPER_MS} ms: {drift:+.1%} "
                     f"({'held' if abs(drift) <= PAPER_DRIFT else 'missed'}, 5%)")
        if (D, H, C) == K8_NARROW:
            target = K8_NARROW_MS if dtype == torch.bfloat16 else plain_ms
            line += (f"; {'held' if ms < target else 'missed'} against "
                     f"{'its plain version' if dtype == torch.float32 else 'the limit'} "
                     f"{target:.4f} ms")
        print(line)


def _widths_forward(seed: int) -> None:
    """The bf16 net at pair widths 36 and 192 with the four fused switches,
    2 blocks, bucket 192, B = 2: kernel route against plain route, with the
    exact launch counts; K9 on its wide body at 36 and its tensor-core body
    at 192, K11 on its CUDA-core body in both nets, K8 on its tensor-core
    body at 192 (past its old bound of 128; _widths_fused_gated shows on the
    profiler that no CUDA-core projection kernel ran in this net)."""
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.ops import trimul as M

    for pair_dim in MODEL_AXIS_PAIR_WIDTHS:
        net = fused_net(pair_dim=pair_dim, num_blocks=2).to("cuda").eval()
        inputs = forward_inputs(net)
        with torch.inference_mode():
            A.reset_launch_counts()
            kernel_out = net(*inputs)
            torch.cuda.synchronize()
            launches = main_path_launches()
            with A.plain_route():
                plain_out = net(*inputs)
        if launches != forward_launches(net.cfg):
            raise AssertionError(f"[widths] pair {pair_dim} launches {launches}")
        rels = [_width_check(f"pair-{pair_dim} forward {i}", a, b, FORWARD_REL_TOL)
                for i, (a, b) in enumerate(zip(kernel_out, plain_out))]
        k8 = A.fused_gated_body(pair_dim, net.cfg.num_heads, net.cfg.head_dim)
        k9 = M.trimul_body(pair_dim)
        print(f"[widths] fused bf16 net at pair width {pair_dim}, 2 blocks, bucket 192 (K8 on "
              f"the {k8} route, K9 on the {k9} body): noise_pred and seq_pred {rels[0]:.3e}, "
              f"{rels[1]:.3e} from the plain route (tol {FORWARD_REL_TOL:g}); launches "
              f"{({k: n for k, n in launches.items() if n})}")
        del net


def _fsdp(tmp: Path, seed: int, trained: dict) -> None:
    """The train CLI on a (1, 2) mesh, two gloo ranks on cuda:0, resuming
    phase 22's (2, 1) checkpoint for 2 steps; its first step against one
    rank resuming the same checkpoint in this process; the generate CLI on
    its checkpoint."""
    from protein_redesign_tpu_torch.cli.train import main as train
    from protein_redesign_tpu_torch.config import ModelConfig

    two_dir, common = trained["two_dir"], trained["common"]
    steps = trained["rows"]["two"][-1]["step"]
    ckpt = str(two_dir / "checkpoints")
    one_dir, fsdp_dir = tmp / "one-resume", tmp / "fsdp"
    train([*common[:-1], str(steps + 1), "--save_dir", str(one_dir), "--device", "cuda",
           "--trained_ckpt", ckpt])
    code, out, wall = _cli("train", [*common[:-1], str(steps + 2), "--save_dir", str(fsdp_dir),
                                     "--num_devices", "2", "--mesh_shape", "1,2", "--device",
                                     "cuda:0", "--trained_ckpt", ckpt, "--profile"],
                           PRD_DIST_BACKEND="gloo")
    if code != 0:
        raise AssertionError(f"[fsdp] exit {code}\n{out[-4000:]}")
    resumed = _rank_values(out, rf"resumed from \S+ at step ({steps})")
    losses = _rank_values(out, r"step (\d+): loss=(\S+)")
    sums = _rank_values(out, r"parameter checksum ([0-9a-f]+), equal on the 2 ranks")
    held = _rank_values(out, r"this rank holds (\S+) MiB of parameters, (\S+) MiB of EMA and "
                             r"(\S+) MiB of Adam moments")
    sharded = _rank_values(out, r"FSDP over 2 ranks: (\d+) of (\d+) parameter tensors sharded")
    if ("mesh: {'data': 1, 'model': 2} on gpu" not in out or [len(r) for r in resumed] != [1, 1]
            or len(losses[0]) != 2 or losses[0] != losses[1] or len(sums[0]) != 1
            or sums[0] != sums[1] or [len(h) for h in held] != [1, 1]):
        raise AssertionError(f"[fsdp] mesh, resume, losses or checksums\n{out[-4000:]}")
    rows = {name: [json.loads(ln) for ln in (d / "metrics.jsonl").read_text().splitlines()
                   if "train_loss" in ln] for name, d in (("one", one_dir), ("fsdp", fsdp_dir))}
    gaps = {}
    for key in ("train_loss", "grad_norm"):
        a, b = rows["fsdp"][0][key], rows["one"][0][key]
        gaps[key] = abs(a - b) / abs(b)
        if not gaps[key] <= GRAD_REL_TOL["bfloat16"]:
            raise AssertionError(f"[fsdp] step {steps + 1} {key}: two ranks {a}, one rank {b}")
    per_micro = forward_launches(ModelConfig(), remat=True)
    traced = _trace_kernels(fsdp_dir / "profile")
    looped = {k: 2 * per_micro[k] for k in TRACE_KERNELS}
    if traced != looped:
        raise AssertionError(f"[fsdp] rank 0's trace {traced} != {looped}")
    whole = trained["rows"]["two"][0]["grad_bytes"] / 2**20
    print(f"[fsdp] train CLI, bf16, bucket 192, batch 2, --mesh_shape 1,2: two gloo ranks on "
          f"cuda:0 resumed phase 22's (2, 1) step {steps} and took 2 steps, "
          f"{np.mean([r['step_seconds'] for r in rows['fsdp']]):.3f} s per step (CLI wall "
          f"{wall:.1f} s); step {steps + 1} loss {rows['fsdp'][0]['train_loss']:.6f}, grad_norm "
          f"{rows['fsdp'][0]['grad_norm']:.6f} against one rank's {rows['one'][0]['train_loss']:.6f}"
          f", {rows['one'][0]['grad_norm']:.6f} from the same checkpoint (relative "
          f"{gaps['train_loss']:.2e}, {gaps['grad_norm']:.2e}; gate {GRAD_REL_TOL['bfloat16']}); "
          f"losses equal on both ranks, whole checksum {sums[0][0]} on both; "
          f"{sharded[0][0][0]} of {sharded[0][0][1]} tensors sharded; each rank holds "
          + " / ".join(f"{h[0][0]} MiB of parameters, {h[0][1]} of EMA, {h[0][2]} of moments"
                       for h in held)
          + f" against one rank's {whole:.2f} MiB of parameters; rank 0's trace of the loop "
          f"{traced} (2 micro-steps, each rank both rows)")
    from protein_redesign_tpu_torch.cli.generate import main as generate

    began = time.perf_counter()
    generate(["-c", str(fsdp_dir / "checkpoints"), "-o", str(tmp / "fsdp-generate"), "-p",
              SEQUENCE, "-l", LIGAND, "-n", "2", "--num_steps", "8"])
    pdb = tmp / "fsdp-generate" / "sample_protein.pdb"
    if not pdb.exists() or pdb.read_text().count("MODEL") < 2:
        raise AssertionError("[fsdp] generate on the (1, 2) checkpoint wrote no samples")
    print(f"[fsdp] the generate CLI sampled 2 complexes from the (1, 2) run's checkpoint (whole "
          f"tensors), --num_steps 8: main() {time.perf_counter() - began:.1f} s")


def _param_dtype(tmp: Path, seed: int) -> None:
    """The bf16 train CLI with --param_dtype bfloat16 on one rank, 2 steps;
    the checkpoint's leaf dtypes; the generate CLI on it."""
    from protein_redesign_tpu_torch.cli.generate import main as generate
    from protein_redesign_tpu_torch.cli.train import main as train
    from protein_redesign_tpu_torch.models.layers import LayerNorm
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.utils.checkpoint import load_weights

    save = tmp / "param-bf16"
    A.reset_launch_counts()
    began = time.perf_counter()
    state = train(["--data_dir", str(tmp / "data"), "--batch_size", "2", "--val_every_steps", "0",
                   "--log_every_steps", "1", "--warmup_steps", "10", "--seed", str(seed),
                   "--dtype", "bfloat16", "--param_dtype", "bfloat16", "--max_steps", "2",
                   "--save_dir", str(save), "--device", "cuda"])
    wall = time.perf_counter() - began
    launches = {k: n for k, n in main_path_launches().items() if n}
    if not all(launches.get(k) for k in TRACE_KERNELS):
        raise AssertionError(f"[param-bf16] launches {launches}")
    sd, cfg, _ = load_weights(save / "checkpoints")
    with torch.device("meta"):
        net = ProteinReDiffNet(cfg)
    f32 = {f"{n}.{p}" if n else p for n, mod in net.named_modules()
           if isinstance(mod, LayerNorm) for p, t in mod._parameters.items() if t is not None}
    wrong = [n for n, _ in net.named_parameters()
             if sd[n].dtype != (torch.float32 if n in f32 else torch.bfloat16)]
    moments = [t for s in state.optimizer.state.values() for t in s.values()
               if torch.is_tensor(t) and t.dim()]
    if wrong or cfg.param_dtype != "bfloat16" or {t.dtype for t in moments} != {
            torch.bfloat16, torch.float32}:
        raise AssertionError(f"[param-bf16] leaf dtypes: {wrong[:5]}")
    rows = [json.loads(ln) for ln in (save / "metrics.jsonl").read_text().splitlines()
            if "train_loss" in ln]
    A.reset_launch_counts()
    began_gen = time.perf_counter()
    generate(["-c", str(save / "checkpoints"), "-o", str(tmp / "param-bf16-generate"), "-p",
              SEQUENCE, "-l", LIGAND, "-n", "2", "--num_steps", "8"])
    gen = {k: n for k, n in main_path_launches().items() if n}
    params = sum(t.numel() * t.element_size() for t in state.net.parameters()) / 2**20
    losses = ", ".join(f"{r['train_loss']:.4f}" for r in rows)
    n_bf16 = sum(sd[n].dtype == torch.bfloat16 for n, _ in net.named_parameters())
    print(f"[param-bf16] train CLI --dtype bfloat16 --param_dtype bfloat16, 2 steps at batch 2: "
          f"loss {losses}, {np.mean([r['step_seconds'] for r in rows]):.3f} s per step (main() "
          f"{wall:.1f} s); in the checkpoint {len(f32)} LayerNorm leaves f32 and {n_bf16} "
          f"parameters bf16, as JAX's init tree; parameters {params:.2f} MiB on the card, EMA "
          f"and moments in their dtypes; launches {launches}; generate from it (8 steps): "
          f"{time.perf_counter() - began_gen:.1f} s, launches {gen}")


def _sp_rank(rank: int, world: int, port: int, workdir: str) -> None:
    """A spawned rank of the sequence-parallel leg: the micro-step at 384
    (the gradient averaged over the model group, as the train step does),
    then the forward at 1024; rank 0 saves the numbers."""
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.parallel import mesh

    mesh.join(mesh.Cluster(rank, world, rank, f"tcp://127.0.0.1:{port}"), "cuda:0")
    workdir = Path(workdir)
    inputs = torch.load(workdir / "sp.pt", weights_only=False)
    out = {}
    with mesh.on_mesh(mesh.mesh_axes(1, world)):
        out.update(_sp_step(inputs, mesh))
        out.update(_sp_forward_long(inputs))
    out["launches"] = {k: n for k, n in A.LAUNCHES.items() if n}
    if rank == 0:
        torch.save(out, workdir / "sp_out.pt")
    torch.distributed.destroy_process_group()


def _sp_net(cfg, blocks: int):
    net = perturbed_net(cfg.replace(num_blocks=blocks), seed=23).to("cuda")
    return net


def _sp_step(inputs: dict, mesh) -> dict:
    """One micro-step on ``inputs``'s batch; the whole gradient, averaged
    over the process group where there is one."""
    net = _sp_net(inputs["cfg"], SP_STEP_BLOCKS)
    batch = {k: v.to("cuda") for k, v in inputs["batch"].items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    began = time.perf_counter()
    loss = micro_step(net, batch, inputs["noise"])
    flat = torch.cat([p.grad.float().reshape(-1) for p in net.parameters()])
    if mesh.distributed():
        flat = mesh.all_reduced(flat) / mesh.rank_and_world()[1]
        loss = mesh.all_reduced(loss.float()) / mesh.rank_and_world()[1]
    torch.cuda.synchronize()
    return {"loss": float(loss), "grad": flat.cpu(), "step_s": time.perf_counter() - began,
            "peak_384": torch.cuda.max_memory_allocated() / 2**30}


def _sp_forward_long(inputs: dict) -> dict:
    net = _sp_net(inputs["cfg"], SP_FORWARD_BLOCKS).eval()
    long_inputs = [t.to("cuda") if torch.is_tensor(t) else
                   {k: v.to("cuda") for k, v in t.items()} for t in inputs["long"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    began = time.perf_counter()
    with torch.inference_mode():
        noise, _ = net(*long_inputs)
    torch.cuda.synchronize()
    if not torch.isfinite(noise).all():
        raise AssertionError("[sp] the forward at 1024: non-finite values")
    return {"forward_s": time.perf_counter() - began,
            "peak_1024": torch.cuda.max_memory_allocated() / 2**30}


def _sequence_parallel(seed: int) -> None:
    """Two gloo ranks on cuda:0 as one model group: bf16, sequence_parallel,
    remat; the micro-step at 384 (B = 1) against this process on a model
    axis of 1, the forward at 1024; no kernel launches."""
    import torch.multiprocessing as mp

    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.models.prdiff import prepare_batch
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.parallel import mesh

    cfg = ModelConfig(dtype="bfloat16", sequence_parallel=True, remat=True, training_mode=True)
    batch = collated([synthetic_complex(long_sequence(seed + 60, SERVE_LONG), seed + 60,
                                        cfg.esm_dim)], 384)
    noise = fixed_noise(batch, seed + 61)
    N = SP_LONG[0]
    long = prepare_batch(collated([synthetic_complex(long_sequence(seed + 62, SP_LONG[1]),
                                                     seed + 62, cfg.esm_dim)], N), 0.3,
                         generator=torch.Generator("cuda").manual_seed(0))
    g = torch.Generator("cuda").manual_seed(1)
    long_inputs = [long, torch.randn(1, N, 3, generator=g, device="cuda"),
                   torch.randn(1, N, 21, generator=g, device="cuda"),
                   long["residue_and_atom_mask"], torch.tensor([40], device="cuda")]
    inputs = {"cfg": cfg, "batch": {k: v.cpu() for k, v in batch.items()}, "noise": noise,
              "long": [t.cpu() if torch.is_tensor(t) else {k: v.cpu() for k, v in t.items()}
                       for t in long_inputs]}
    with tempfile.TemporaryDirectory() as workdir:
        torch.save(inputs, Path(workdir) / "sp.pt")
        import os

        os.environ[mesh.BACKEND_VAR] = "gloo"
        began = time.perf_counter()
        try:
            procs = mp.spawn(_sp_rank, args=(2, mesh.free_port(), workdir), nprocs=2, join=False)
            A.reset_launch_counts()
            with mesh.on_mesh(mesh.mesh_axes(1, 1)):
                one = _sp_step(inputs, mesh)
                one_long = _sp_forward_long(inputs)
            one_launches = {k: n for k, n in A.LAUNCHES.items() if n}
            while not procs.join():
                pass
        finally:
            os.environ.pop(mesh.BACKEND_VAR, None)
        wall = time.perf_counter() - began
        two = torch.load(Path(workdir) / "sp_out.pt", weights_only=False)
    loss_gap = abs(two["loss"] - one["loss"]) / abs(one["loss"])
    grad_gap = float((two["grad"] - one["grad"]).norm() / one["grad"].norm())
    tol = GRAD_REL_TOL["bfloat16"]
    if two["launches"] or one_launches:
        raise AssertionError(f"[sp] kernels launched: {two['launches']} / {one_launches}")
    if not (loss_gap <= tol and grad_gap <= tol):
        raise AssertionError(f"[sp] two ranks against one: loss {loss_gap}, gradient {grad_gap}")
    print(f"[sp] bf16, sequence_parallel, remat, paper width with {SP_STEP_BLOCKS} blocks: the "
          f"micro-step at 384 (B = 1) on two gloo ranks on cuda:0 (the complex axis 192 + 192) "
          f"against one rank on a model axis of 1: loss {two['loss']:.6f} against "
          f"{one['loss']:.6f} (relative {loss_gap:.2e}), the whole gradient {grad_gap:.2e} "
          f"relative (gate {tol}); {two['step_s']:.2f} s against {one['step_s']:.2f} s; peak "
          f"memory a rank {two['peak_384']:.2f} GiB against {one['peak_384']:.2f} GiB; no "
          f"kernel launched (the plain route, as JAX's plan and fused_ok)")
    print(f"[sp] the forward at {N} ({SP_LONG[1]} residues + imatinib), {SP_FORWARD_BLOCKS} "
          f"blocks, B = 1: peak memory a rank {two['peak_1024']:.2f} GiB on two ranks, "
          f"{one_long['peak_1024']:.2f} GiB on one; {two['forward_s']:.2f} s against "
          f"{one_long['forward_s']:.2f} s; leg wall {wall:.1f} s")


def phase_model_axis(seed: int, tmp: Path, trained: dict) -> None:
    """Phase 23: the model axis on one card, and the widths the JAX kernels
    take."""
    began = time.perf_counter()
    for label, step in (("K9 and K11 widths", _widths_fused), ("K8 widths", _widths_fused_gated),
                        ("attention widths", _widths_attention),
                        ("C = 4 mod 8", _widths_narrow),
                        ("fused nets", lambda: _widths_forward(seed)),
                        ("FSDP", lambda: _fsdp(tmp, seed, trained)),
                        ("param dtype", lambda: _param_dtype(tmp, seed)),
                        ("sequence parallel", lambda: _sequence_parallel(seed))):
        with wall(f"model axis, {label}"):
            step()
    print(f"[model-axis] one card: FSDP and sequence parallelism share it, so their times are "
          f"overhead of sharing, not scaling; phase wall {time.perf_counter() - began:.1f} s")


def _installed_copy(tmp: Path) -> Path:
    """A wheel of the checkout's packaging files and both packages, built
    and installed under ``tmp`` as a user would (``pip wheel``, then ``pip
    install --target``), the installed port made read-only. Returns the
    install directory."""
    src, site = tmp / "src", tmp / "site"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, src / name)
    for package in ("protein_redesign_tpu", "protein_redesign_tpu_torch"):
        shutil.copytree(REPO / package, src / package,
                        ignore=shutil.ignore_patterns("__pycache__", "_build"))

    def pip(*argv):
        proc = subprocess.run([sys.executable, "-m", "pip", *argv], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise AssertionError(f"pip {argv[0]} failed ({proc.returncode}):\n"
                                 f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")

    began = time.perf_counter()
    # the build backend is setuptools, taken from this interpreter (no isolation)
    pip("wheel", "--no-cache-dir", "--no-deps", "--no-build-isolation", "--no-index", "-w",
        str(tmp / "dist"), str(src))
    (wheel,) = (tmp / "dist").glob("*.whl")
    pip("install", "--no-cache-dir", "--no-deps", "--no-index", "--target", str(site),
        str(wheel))
    package = site / "protein_redesign_tpu_torch"
    for path in [package, *package.rglob("*")]:
        path.chmod(path.stat().st_mode & ~0o222)
    print(f"[installed] wheel built and installed with --target in "
          f"{time.perf_counter() - began:.1f} s; the installed port is read-only")
    return site


# Run by the installed copy, in a process outside the checkout: where it
# loads the library from and where it would build without the variable.
_INSTALLED_LOAD = """
import json, os
import protein_redesign_tpu_torch
from protein_redesign_tpu_torch import kernels
lib = kernels.build()
explicit = os.environ.pop(kernels.KERNEL_DIR_ENV)
print(json.dumps({"package": protein_redesign_tpu_torch.__file__, "library": str(lib.path),
                  "build_seconds": lib.build_seconds, "explicit": explicit,
                  "default_dir": str(kernels.build_dir())}))
"""


def _generated(out: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(out.iterdir()) if p.is_file()}


def phase_installed(seed: int) -> None:
    """The port as ``pip install`` gives it: a wheel of this checkout
    installed into a temporary directory and made read-only. A process
    outside the checkout, whose PYTHONPATH holds that directory only,
    loads phase 2's library through PRD_TORCH_KERNEL_DIR without a rebuild
    (the library's name is a hash of the sources' contents, so every
    source and header arrived byte for byte) and finds that without the
    variable it would build into the user's cache; the installed
    ``prd-torch-generate`` writes files bit-equal to the checkout's
    generate CLI with the same seed and flags. Then the model facade at
    paper width: ``ProteinReDiffModel(ModelConfig())`` samples bit-equal
    to the free ``sample`` with the same generator seed, with exact K1 and
    K2 launches."""
    from protein_redesign_tpu_torch import kernels
    from protein_redesign_tpu_torch.cli.common import SamplingRunner
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffModel, sample
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.utils.tmalign import find_tmalign
    from protein_redesign_tpu_torch.utils.weights import save_checkpoint

    lib = kernels.build()
    cfg = ModelConfig()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        site = _installed_copy(tmp)
        env = {**os.environ, "PYTHONPATH": str(site), "PRD_TMALIGN": find_tmalign(),
               kernels.KERNEL_DIR_ENV: str(lib.path.parent)}
        proc = subprocess.run([sys.executable, "-c", _INSTALLED_LOAD], cwd=tmp, env=env,
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"the installed copy failed to load:\n{proc.stderr[-3000:]}")
        got = json.loads(proc.stdout.splitlines()[-1])
        cache = Path(os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache")
        if not (Path(got["package"]).is_relative_to(site) and got["build_seconds"] is None
                and got["library"] == str(lib.path)
                and got["default_dir"] == str(cache / "protein_redesign_tpu_torch" / "kernels")):
            raise AssertionError(f"installed copy: {got}; phase 2 built {lib.path}")
        print(f"[installed] the installed copy ({got['package']}) loaded "
              f"{Path(got['library']).name} from {got['explicit']} without a rebuild; without "
              f"{kernels.KERNEL_DIR_ENV} it would build into {got['default_dir']} (its package "
              f"directory is read-only)")

        save_checkpoint(tmp / "ckpt", perturbed_net(cfg, seed).state_dict(), cfg)
        argv = ["-c", str(tmp / "ckpt"), "-p", SEQUENCE, "-l", LIGAND, "-n", "2",
                "--batch_size", "2", "--num_steps", str(INSTALLED_STEPS), "--seed", str(seed),
                "--device", "cuda"]
        # both at once, ESM-2 off in both (its features zero, as in phase 5)
        runs = {}
        began = time.perf_counter()
        for where, command, cwd, run_env in (
                ("checkout", [sys.executable, "-m", "protein_redesign_tpu_torch.cli.generate"],
                 REPO, {**os.environ, "PRD_TMALIGN": env["PRD_TMALIGN"]}),
                ("installed", [str(site / "bin" / "prd-torch-generate")], tmp, env)):
            with open(tmp / f"{where}.log", "w") as log:
                runs[where] = subprocess.Popen(
                    [*command, *argv, "-o", str(tmp / where)], cwd=cwd,
                    env={**run_env, "PRD_DISABLE_ESM": "1"}, stdout=log,
                    stderr=subprocess.STDOUT)
        outputs = {}
        try:
            for where, proc in runs.items():
                if proc.wait(timeout=600) != 0:
                    log = (tmp / f"{where}.log").read_text()
                    raise AssertionError(f"{where} generate CLI failed:\n{log[-3000:]}")
                outputs[where] = _generated(tmp / where)
        finally:
            for proc in runs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall = time.perf_counter() - began
        if sorted(outputs["installed"]) != sorted(outputs["checkout"]) or any(
                outputs["installed"][k] != outputs["checkout"][k] for k in outputs["checkout"]):
            raise AssertionError("prd-torch-generate from the installed copy wrote other files "
                                 "than the checkout's generate CLI")
        print(f"[installed] prd-torch-generate (installed) and python -m ...cli.generate "
              f"(checkout), bucket 192, 2 samples, {INSTALLED_STEPS} DDPM steps, seed {seed}: "
              f"{len(outputs['checkout'])} files bit-equal ({', '.join(outputs['checkout'])}); "
              f"both processes side by side in {wall:.1f} s")

    model = ProteinReDiffModel(cfg, device="cuda")
    model.load_params(perturbed_net(cfg, seed).state_dict())
    landed, batch = complex_batch(SamplingRunner(model.net, "cuda"))
    A.reset_launch_counts()
    began = time.perf_counter()
    pos, logits = model.sample(batch, torch.Generator("cuda").manual_seed(seed))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - began
    launches = main_path_launches()
    free = sample(model.net, batch, generator=torch.Generator("cuda").manual_seed(seed))
    if not (torch.equal(pos, free[0]) and torch.equal(logits, free[1])):
        raise AssertionError("ProteinReDiffModel.sample differs from the free sample")
    if not (torch.isfinite(pos).all() and pos.shape == (2, landed, 3)):
        raise AssertionError(f"facade sample: shape {tuple(pos.shape)} or non-finite values")
    expected = {k: cfg.num_steps * v for k, v in forward_launches(cfg).items()}
    if launches != expected:
        raise AssertionError(f"facade sample launches {launches} != {expected}")
    print(f"[installed] ProteinReDiffModel(ModelConfig(), device='cuda').sample at bucket "
          f"{landed}, {cfg.dtype}, B=2, {cfg.num_steps} DDPM steps in {seconds:.2f} s: bit-equal "
          f"to the free sample with the same seed; launches "
          f"{({k: v for k, v in launches.items() if v})}")


def print_mfu() -> None:
    """One line: the analytic forward FLOPs (``utils.flops``) over the
    profiled busy time of phase 4's bf16 forward at 192 and phase 15's fast
    forward at 384, against the H100's dense bf16 peak."""
    from protein_redesign_tpu_torch.utils.flops import denoiser_forward_flops, mfu

    parts = []
    for tag in ("forward", "fast-forward-384"):
        busy_ms, B, bucket, cfg = FORWARD_BUSY[tag]
        flops = denoiser_forward_flops(cfg, B, bucket)
        parts.append(f"{tag} (bucket {bucket}, B={B}) {flops / 1e9:.1f} GFLOP in {busy_ms:.2f} ms "
                     f"busy = {mfu(flops, busy_ms / 1e3):.2%}")
    print(f"[mfu] of {PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s dense bf16: " + "; ".join(parts))


@contextlib.contextmanager
def wall(tag: str):
    """Print the block's wall time as ``[wall] tag``."""
    began = time.perf_counter()
    yield
    print(f"[wall] {tag}: {time.perf_counter() - began:.1f} s", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of weights and synthetic data")
    args = parser.parse_args()
    began = time.perf_counter()
    name, smi = phase_device()
    from protein_redesign_tpu_torch.models.prdiff import ModelConfig

    with wall("build"):
        phase_build()
    with wall("fused breakdown, kernels, K7"):
        phase_fused_breakdown()
        record = phase_kernels()
        record["rows_attention_bwd"] = phase_k7()
    with wall("forward and generate at 192"):
        net = perturbed_net(ModelConfig()).to("cuda").eval()
        print(f"[forward] ModelConfig(): single {net.cfg.single_dim}, pair {net.cfg.pair_dim}, "
              f"{net.cfg.num_heads} heads x {net.cfg.head_dim}, {net.cfg.num_blocks} blocks, "
              f"{net.cfg.dtype}")
        phase_forward(net)
        phase_generate(net)
        del net
    with wall("gradient"):
        phase_grad(args.seed)
    with tempfile.TemporaryDirectory() as kept:
        with wall("train CLI"):
            launches = phase_train(args.seed, keep=Path(kept))
        with wall("h64"):
            phase_h64(args.seed)
        with wall("design"):
            phase_design(args.seed, Path(kept))
        with wall("picard"):
            phase_picard(args.seed, Path(kept))
    with wall("K-chunk kernels"):
        record.update(phase_kchunk_kernels())
    with wall("generate at 2048"):
        net = perturbed_net(ModelConfig()).to("cuda").eval()
        long_launches = phase_generate_long(net)
        del net
    with wall("long forward and gradients"):
        phase_forward_long(args.seed)
        phase_grad_long(args.seed)
        phase_grad_2048(args.seed)
    with wall("long train CLIs"):
        train_long = phase_train_long(args.seed)
        train_512 = phase_train_long(args.seed, TRAIN_F32_512)
    with wall("fused"):
        record.update(phase_fused_kernels())
        net = fused_net().to("cuda").eval()
        phase_forward(net, tag="fused-forward")
        del net
        phase_fused_forward_large(args.seed)
        phase_fused_grad(args.seed)
        net = perturbed_net(ModelConfig()).to("cuda").eval()
        fused_generate = phase_generate(net, flags=[f"--{f}" for f in FUSED],
                                        tag="fused-generate")
        del net
        phase_fused_train(args.seed)
    with wall("serving"):
        record.update(phase_fast_kernel())
        served = phase_serving(args.seed)
        served_f32 = phase_fast_f32(args.seed)
        net = perturbed_net(ModelConfig(fast_softmax=True, use_pallas_bwd=False)).to("cuda").eval()
        phase_forward(net, tag="fast-forward")
        phase_forward(net, tag="fast-forward-384", bucket=384)
        del net
    with wall("wide"):
        phase_wide(args.seed)
    with wall("chunked"):
        phase_chunked(args.seed)
    with wall("esm"):
        phase_esm(args.seed)
    with tempfile.TemporaryDirectory() as shared:
        with wall("multi-device"):
            trained = phase_multidevice(args.seed, Path(shared))
        with wall("model axis"):
            phase_model_axis(args.seed, Path(shared), trained)
    with wall("installed"):
        phase_installed(args.seed)
        print_mfu()
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
    print(f"[wall] whole smoke after startup: {time.perf_counter() - began:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
