"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: CUDA is required; prints the card's name and power limit.
2. Build: nvcc builds the attention kernels from the sources in the
   checkout (protein_redesign_tpu_torch/kernels/csrc) into
   protein_redesign_tpu_torch/kernels/_build; prints the build time.
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   card at the main path's shapes (buckets 192 and 512), with the warm time
   of both from CUDA events.
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
   are fully masked), f32 and bf16, with both times.
7. Whole-net gradient: the training loss's parameter gradients at paper
   width, B=2, bucket 192, kernel route against plain route, in f32 and
   bf16, with exactly 48 K1, 25 K2 and 24 K7 launches per micro-step
   (remat: 24 + 24 K1, 13 + 12 K2); the kernel route's device time per
   micro-step by kernel group at buckets 192 and 384 (torch.profiler).
8. Training main path: the port's train CLI at paper width on a mini
   dataset written from --seed (two T4 lysozyme 1-110 + imatinib complexes
   at bucket 192, two ~330-residue synthetic complexes at bucket 384, one
   validation complex), batch 2 x 2 accumulated micro-batches: 2 optimizer
   steps at 192, then a resume from the written checkpoint for 2 steps at
   384; finite losses, metrics.jsonl, checkpoint files and exact launch
   counts; seconds per optimizer step and peak device memory per bucket.

The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
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
SEQUENCE = (  # the first 110 residues of T4 lysozyme
    "MNIFEMLRIDEGLRLKIYKDTEGYYTIGIGHLLTKSPSLNAAKSELDKAIGRNTNGVITKDEAEKLFNQDVDAAVRGI"
    "LRNAKLKPVYDSLDAVRRAAINMVFQMGETGV"
)
LIGAND = "Cc1ccc(NC(=O)c2ccc(CN3CCN(C)CC3)cc2)cc1Nc1nccc(-c2cccnc2)n1"  # imatinib
STEPS = 64
CSRC = "protein_redesign_tpu_torch/kernels/csrc/"
SOURCES = {"rows_attention": CSRC + "attention.cu", "tiled_attention": CSRC + "attention.cu",
           "rows_attention_bwd": CSRC + "attention_bwd.cu"}
REPLACES = {
    "rows_attention": "protein_redesign_tpu/ops/pallas_attention.py:725",
    "tiled_attention": "protein_redesign_tpu/ops/pallas_attention.py:1315",
    "rows_attention_bwd": "protein_redesign_tpu/ops/pallas_attention.py:834",
}
# Relative norm of the whole parameter gradient, kernel route vs plain route:
# f32 (TF32 off): sums in another order through 12 blocks of a net whose
# seeded, perturbed weights amplify rounding (the plain route alone differs
# by ~1e-4 between the card and the CPU on these weights); bf16: K7 rounds
# dS to bf16 before the dq and dk sums, as the Pallas kernel does, while the
# plain route's autograd keeps dS in f32.
GRAD_REL_TOL = {"float32": 5e-4, "bfloat16": 5e-2}
# Per micro-step at remat: 2 triangle attentions x 12 blocks in the forward
# and again in the recompute (K1), 12 single attentions + SPAttention in the
# forward and the 12 again in the recompute (K2), one K7 per K1 of the forward.
MICRO_STEP_LAUNCHES = {"rows_attention": 48, "tiled_attention": 25, "rows_attention_bwd": 24}
EVAL_LAUNCHES = {"rows_attention": 24, "tiled_attention": 13, "rows_attention_bwd": 0}


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
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
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


def phase_kernels() -> dict:
    from protein_redesign_tpu_torch.ops import attention as A

    cases = []
    for bucket, n_valid in ((192, 147), (512, 401)):
        for dtype in (torch.float32, torch.bfloat16):
            cases.append(("rows_attention", bucket, dtype, 2 * bucket, 16, True, False, n_valid))
            cases.append(("tiled_attention", bucket, dtype, 2, 16, True, True, n_valid))
            cases.append(("tiled_attention", bucket, dtype, 2, 512, False, True, n_valid))
    record = {name: {"max_abs_err": 0.0} for name in REPLACES}
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
        ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
        label = str(dtype).replace("torch.", "")
        print(f"[kernels] {name} R={R} H=4 N={N} C={C} {label} mask={with_mask} "
              f"bias={with_bias}: max_abs_err {err:.3e} (tol {tol:g}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        rec = record[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        # the JSON record carries the main path's own shape: bucket 192, bf16,
        # and for tiled_attention the single-attention call (C=16)
        if N == 192 and dtype == torch.bfloat16 and C == 16:
            rec["ms"], rec["plain_ms"] = ms, plain_ms
    return record


def perturbed_net(cfg, seed: int = 0):
    """Seeded init plus seeded noise on every parameter (the 'final' and
    'gating' layers start at zero and would hide a wrong kernel)."""
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet

    torch.manual_seed(seed)
    net = ProteinReDiffNet(cfg)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in net.parameters():
            std = 0.5 / math.sqrt(p.shape[-1]) if p.dim() == 2 else 0.1
            p.add_(torch.randn(p.shape, generator=g) * std)
    return net


def complex_batch(runner, batch_rows: int = 2):
    from protein_redesign_tpu_torch.cli.common import complex_data, load_protein_arg, parse_ligand_arg

    protein, ligand = load_protein_arg(SEQUENCE), parse_ligand_arg(LIGAND)
    esm = np.zeros((len(protein.aatype), runner.net.cfg.esm_dim), np.float32)
    return runner.collate([complex_data(protein, ligand, esm)] * batch_rows)


def phase_forward(net) -> None:
    from protein_redesign_tpu_torch.cli.common import SamplingRunner
    from protein_redesign_tpu_torch.models.prdiff import prepare_batch
    from protein_redesign_tpu_torch.ops import attention as A

    runner = SamplingRunner(net, "cuda")
    bucket, batch = complex_batch(runner)
    if bucket != 192:
        raise AssertionError(f"the smoke complex landed in bucket {bucket}, not 192")
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
        launches = dict(A.LAUNCHES)
        noise_p, seq_p = forward(True)
        torch.cuda.synchronize()
        blocks = net.cfg.num_blocks
        expected = {"rows_attention": 2 * blocks, "tiled_attention": blocks + 1,
                    "rows_attention_bwd": 0}
        if launches != expected:
            raise AssertionError(f"launches per forward {launches} != {expected}")
        for name, a, b in (("noise_pred", noise_k, noise_p), ("seq_pred", seq_k, seq_p)):
            if a.shape != b.shape or not torch.isfinite(a).all():
                raise AssertionError(f"{name}: shape {tuple(a.shape)} or non-finite values")
            rel = float((a - b).norm() / b.norm())
            print(f"[forward] {name} {tuple(a.shape)}: ||kernel - plain|| / ||plain|| = "
                  f"{rel:.3e} (tol {FORWARD_REL_TOL:g})")
            if not rel <= FORWARD_REL_TOL:
                raise AssertionError(f"{name}: relative error {rel} > {FORWARD_REL_TOL}")
        kernel_ms, plain_ms = cuda_ms(lambda: forward(False), 2, 5), cuda_ms(lambda: forward(True), 2, 5)
        busy = device_time_by_group(lambda: forward(False))
    print(f"[forward] paper width, bf16, B={B}, bucket {bucket}: kernel route {kernel_ms:.2f} ms, "
          f"plain route {plain_ms:.2f} ms per forward; launches per forward {launches}")
    total = sum(busy.values())
    print(f"[forward] kernel route, device time per forward from torch.profiler: {total:.2f} ms busy "
          f"({1 - total / kernel_ms:.1%} of the CUDA-event time idle); "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(busy.items(), key=lambda kv: -kv[1])))


# Device-time groups, matched on the CUDA kernel's name, in order.
GROUPS = (("rows_attention_bwd", "K7 rows_attention_bwd"),
          ("rows_attention", "K1 rows_attention"), ("tiled_attention", "K2 tiled_attention"),
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


def phase_generate(net) -> dict:
    from protein_redesign_tpu_torch.cli.generate import main
    from protein_redesign_tpu_torch.ops import attention as A
    from protein_redesign_tpu_torch.utils.weights import save_checkpoint

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_checkpoint(tmp / "ckpt", net.state_dict(), net.cfg)
        argv = ["-c", str(tmp / "ckpt"), "-o", str(tmp / "out"), "-p", SEQUENCE, "-l", LIGAND,
                "-n", "2", "--batch_size", "2", "--num_steps", str(STEPS), "--device", "cuda"]
        A.reset_launch_counts()
        began = time.perf_counter()
        timings = main(argv)
        wall = time.perf_counter() - began
        launches = dict(A.LAUNCHES)
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
    batches = len(timings)
    blocks = net.cfg.num_blocks
    expected = {"rows_attention": STEPS * 2 * blocks * batches,
                "tiled_attention": STEPS * (blocks + 1) * batches, "rows_attention_bwd": 0}
    if launches != expected:
        raise AssertionError(f"generate launches {launches} != {expected}")
    for bucket, rows, steps, seconds in timings:
        print(f"[generate] bucket {bucket}, {rows} samples per batch: {steps} DDPM steps in "
              f"{seconds:.3f} s = {seconds / steps:.4f} s/step")
    print(f"[generate] main() wall {wall:.2f} s; TM-scores {scores}; launches {launches}")
    return launches


def phase_k7() -> dict:
    """K7 against its plain version on the main path's shapes (B=2, H=4, C=16)."""
    from protein_redesign_tpu_torch.ops import attention as A

    rec = {"max_abs_err": 0.0}
    for seed, (N, n_valid) in enumerate(((192, 147), (384, 360))):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask, _ = _attention_case(2 * N, N, 4, 16, dtype, n_valid, True, False,
                                               True, 100 + seed)
            g = torch.randn(q.shape, generator=torch.Generator("cuda").manual_seed(seed),
                            device="cuda").to(dtype)
            scale = 0.25
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
            print(f"[k7] rows_attention_bwd R={2 * N} H=4 N={N} C=16 {label} ({n_valid} valid): "
                  f"max abs err dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol {tol:g} "
                  f"x max(1, max|grad|)); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            rec["max_abs_err"] = max(rec["max_abs_err"], *errs)
            if N == 192 and dtype == torch.bfloat16:
                rec["ms"], rec["plain_ms"] = ms, plain_ms
    return rec


def synthetic_complex(sequence: str, seed: int, esm_dim: int) -> dict:
    """A featurized complex of ``sequence`` and imatinib with coordinates
    made from ``seed``: a CA trace at 3.8 A steps and a ligand laid out along
    its bond graph at 1.5 A steps from the trace's centre (the framework-free
    chem layer has no conformer generator)."""
    from collections import deque

    from protein_redesign_tpu.chem.mol import update_mol_positions
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
    from protein_redesign_tpu.data.collate import collate_fn, numeric_batch

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
                      t=torch.tensor([7, 40]), noise_z=torch.randn(B, N, 3, generator=g),
                      noise_seq=torch.randn(B, N, 21, generator=g))


def micro_step(net, batch: dict, noise):
    """One micro-step of training: the loss and its backward."""
    from protein_redesign_tpu_torch.models.prdiff import loss

    net.zero_grad(set_to_none=True)
    value, _ = loss(net, batch, noise=noise)
    value.backward()
    return value.detach()


def phase_grad(seed: int) -> None:
    """Paper-width parameter gradients, kernel route vs plain route, and the
    kernel route's time per micro-step, by kernel group, at buckets 192 and 384."""
    from protein_redesign_tpu.config import ModelConfig
    from protein_redesign_tpu_torch.ops import attention as A

    for dtype in ("float32", "bfloat16"):
        net = perturbed_net(ModelConfig(dtype=dtype, training_mode=True, mask_prob=0.5),
                            seed).to("cuda")
        batch = collated([synthetic_complex(SEQUENCE, seed + s, net.cfg.esm_dim) for s in (1, 2)],
                         192)
        noise = fixed_noise(batch, seed)
        A.reset_launch_counts()
        loss_k = micro_step(net, batch, noise)
        torch.cuda.synchronize()
        launches = dict(A.LAUNCHES)
        grads_k = torch.cat([p.grad.flatten().float() for p in net.parameters()])
        with A.plain_route():
            loss_p = micro_step(net, batch, noise)
        grads_p = torch.cat([p.grad.flatten().float() for p in net.parameters()])
        if launches != MICRO_STEP_LAUNCHES:
            raise AssertionError(f"launches per micro-step {launches} != {MICRO_STEP_LAUNCHES}")
        rel = float((grads_k - grads_p).norm() / grads_p.norm())
        finite = bool(torch.isfinite(grads_k).all() and torch.isfinite(loss_k))
        B, N = batch["residue_mask"].shape
        print(f"[grad] paper width, {dtype}, B={B}, bucket {N}: loss kernel {float(loss_k):.6f}, "
              f"plain {float(loss_p):.6f}; ||grad_kernel - grad_plain|| / ||grad_plain|| = "
              f"{rel:.3e} (tol {GRAD_REL_TOL[dtype]:g}); launches per micro-step {launches}")
        if not (finite and rel <= GRAD_REL_TOL[dtype]):
            raise AssertionError(f"{dtype} gradient: finite={finite}, relative error {rel}")
        if dtype == "bfloat16":
            long_batch = collated([synthetic_complex(long_sequence(seed + s), seed + s,
                                                     net.cfg.esm_dim) for s in (3, 4)], 384)
            for bucket, b in ((192, batch), (384, long_batch)):
                n = fixed_noise(b, seed)
                step = lambda: micro_step(net, b, n)  # noqa: E731
                kernel_ms = cuda_ms(step, 1, 3)
                with A.plain_route():
                    plain_ms = cuda_ms(step, 1, 3)
                busy = device_time_by_group(step, iters=3)
                total = sum(busy.values())
                print(f"[grad] bf16 micro-step (loss + backward, remat), B=2, bucket {bucket}: "
                      f"kernel route {kernel_ms:.2f} ms, plain route {plain_ms:.2f} ms; kernel route "
                      f"device time {total:.2f} ms busy ({1 - total / kernel_ms:.1%} idle); "
                      + ", ".join(f"{k} {v:.2f}" for k, v in
                                  sorted(busy.items(), key=lambda kv: -kv[1])))
        del net


def phase_train(seed: int) -> dict:
    """The port's train CLI at paper width: 2 optimizer steps at bucket 192,
    then a resume for 2 steps at bucket 384."""
    from protein_redesign_tpu.config import ModelConfig
    from protein_redesign_tpu.data.dataset import save_complex_cache
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
            split["val"] = [val]
            for part, datas in split.items():
                ids = [f"{part}{i}" for i in range(len(datas))]
                (tmp / name).mkdir(exist_ok=True)
                (tmp / name / f"PRD_{part}_pdb_ids").write_text("\n".join(ids) + "\n")
                for pdb_id, data in zip(ids, datas):
                    save_complex_cache(tmp / name / "PDB_processed_cache", pdb_id, data)
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
        launches = dict(A.LAUNCHES)
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
    expected = {k: micro * MICRO_STEP_LAUNCHES[k] + len(vals) * EVAL_LAUNCHES[k]
                for k in MICRO_STEP_LAUNCHES}
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of weights and synthetic data")
    args = parser.parse_args()
    name, smi = phase_device()
    from protein_redesign_tpu_torch.models.prdiff import ModelConfig

    phase_build()
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
    loaded = sorted(m for m in ("jax", "flax") if m in sys.modules)
    if loaded:
        raise AssertionError(f"the port's run imported {loaded}")
    kernels = [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
         "launches": launches[k], "max_abs_err": record[k]["max_abs_err"],
         "ms": record[k]["ms"], "plain_ms": record[k]["plain_ms"]}
        for k in REPLACES
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
