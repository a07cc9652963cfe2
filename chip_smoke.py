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

The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
SOURCE = "protein_redesign_tpu_torch/kernels/csrc/attention.cu"
REPLACES = {
    "rows_attention": "protein_redesign_tpu/ops/pallas_attention.py:725",
    "tiled_attention": "protein_redesign_tpu/ops/pallas_attention.py:1315",
}


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
        expected = {"rows_attention": 2 * blocks, "tiled_attention": blocks + 1}
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


# Device-time groups of a forward, matched on the CUDA kernel's name, in order.
GROUPS = (("rows_attention", "K1 rows_attention"), ("tiled_attention", "K2 tiled_attention"),
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
                "tiled_attention": STEPS * (blocks + 1) * batches}
    if launches != expected:
        raise AssertionError(f"generate launches {launches} != {expected}")
    for bucket, rows, steps, seconds in timings:
        print(f"[generate] bucket {bucket}, {rows} samples per batch: {steps} DDPM steps in "
              f"{seconds:.3f} s = {seconds / steps:.4f} s/step")
    print(f"[generate] main() wall {wall:.2f} s; TM-scores {scores}; launches {launches}")
    return launches


def main() -> None:
    name, smi = phase_device()
    from protein_redesign_tpu_torch.models.prdiff import ModelConfig

    phase_build()
    record = phase_kernels()
    net = perturbed_net(ModelConfig()).to("cuda").eval()
    print(f"[forward] ModelConfig(): single {net.cfg.single_dim}, pair {net.cfg.pair_dim}, "
          f"{net.cfg.num_heads} heads x {net.cfg.head_dim}, {net.cfg.num_blocks} blocks, "
          f"{net.cfg.dtype}")
    phase_forward(net)
    launches = phase_generate(net)
    loaded = sorted(m for m in ("jax", "flax") if m in sys.modules)
    if loaded:
        raise AssertionError(f"the port's run imported {loaded}")
    kernels = [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
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
