"""Batch-serving CLI: JSONL requests in, JSONL results out (port of
``protein_redesign_tpu/cli/serve.py``).

A long-lived process that loads the model once, builds the CUDA kernels
before its first request (``--warmup_buckets``) and streams redesign
requests through one ``SamplingRunner``.

Request (one JSON object per line on stdin or --input file):
    {"id": "req1", "protein": "<sequence-with-X-or-.pdb-path>",
     "ligand": "<SMILES-or-.sdf/.mol2-path-or-*>",
     "num_samples": 4, "mask_prob": 0.3, "seed": 0, "trajectory": 5}

Response (one JSON per request on stdout or --output file):
    {"id": "req1", "sequences": [...], "tmscores": [...],
     "pdb_files": [...], "sdf_files": [...], "trajectory_files": [...]}

``trajectory_files`` appears when the request asks for K frames
(``"trajectory": K``, a divisor of the sampler's step count). Structures are
written under --output_dir/<id>/; a bad request becomes {"id", "error"}.

    python -m protein_redesign_tpu_torch.cli.serve -c ckpt -o out/ \\
        [--num_steps 1000] [--sampler ddim --ddim_steps 50] [--fast_softmax] \\
        [--batch_size 2 --warmup_buckets 192] [--input reqs.jsonl] [--output results.jsonl]

TCP mode (the same JSONL protocol over a socket; concurrent clients, device
work serialized behind one lock):

    python -m protein_redesign_tpu_torch.cli.serve -c ckpt -o out/ --port 8500

``--fast_softmax`` runs triangle attention through K1 fast for a checkpoint
whose config has ``use_pallas_bwd: false`` (trained with
``--no-use_pallas_bwd``), as the JAX package does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import sys
import threading
from argparse import ArgumentParser
from operator import itemgetter
from pathlib import Path

from . import command

# _claim_lock, _claimed_counts, _safe_dir_name and _claim_request_dir are
# copied from protein_redesign_tpu/cli/serve.py (:40-74), whose module
# imports jax.
_claim_lock = threading.Lock()
_claimed_counts = {}


def _safe_dir_name(req_id: str) -> str:
    """Request ids come from the network: reduce to a single safe path
    component so an id like "../../../home/user" or "/tmp/evil" cannot
    direct writes outside --output_dir (pathlib treats an absolute
    right-hand side as a full replacement)."""
    name = re.sub(r"[^A-Za-z0-9._-]+", "_", str(req_id))[:100]
    name = name.strip("._")
    return name or "request"


def _claim_request_dir(output_dir, req_id):
    """Thread-safe unique output directory per request. Distinct ids keep
    the plain <output_dir>/<sanitized-id> path (the stdin-mode
    contract); a REUSED id — e.g. two concurrent TCP clients both
    omitting "id" (default "request") — gets <id>_2, <id>_3, ... so
    their files never collide (post-processing deliberately runs
    outside the device lock). Directories left by a PREVIOUS server
    process over the same --output_dir are uniquified the same way
    (the in-memory counter starts fresh; never silently overwrite)."""
    base = _safe_dir_name(req_id)
    with _claim_lock:
        n = _claimed_counts.get(base, 0)
        while True:
            n += 1
            name = base if n == 1 else f"{base}_{n}"
            req_dir = Path(output_dir) / name
            if not req_dir.exists():
                break
        _claimed_counts[base] = n
        req_dir.mkdir(parents=True, exist_ok=True)
    return req_dir


def handle_request(req, runner, embedder, output_dir, default_mask_prob,
                   device_lock=None, max_nodes=None, max_samples=None):
    """One request through the runner. The ``num_samples``, ``max_samples``
    and ``max_nodes`` guards run before any ESM or device work. ``mask_prob``
    and ``seed`` (the runner's generator) vary per request. ``device_lock``
    (TCP mode) guards only the sampling: ESM embedding (on the embedder's
    device), featurization, TM-align and the PDB/SDF writes run outside it,
    so concurrent clients overlap that work with each other's sampling."""
    from ..chem.mol import get_mol_positions, mol_to_sdf, update_mol_positions
    from ..chem.protein import protein_to_pdb_file, protein_to_sequence, proteins_to_pdb_file
    from ..utils.tmalign import run_tmalign
    from .common import complex_data, load_protein_arg, parse_ligand_arg, update_pos, update_seq

    req_id = str(req.get("id", "request"))
    num_samples = int(req.get("num_samples", 1))
    mask_prob = float(req.get("mask_prob", default_mask_prob))
    seed = int(req.get("seed", 0))
    trajectory = int(req.get("trajectory", 0))  # K denoising frames per sample
    if num_samples < 1:
        raise ValueError(f"num_samples must be >= 1, got {num_samples}")
    # the volume guard: one request holds the device lock for all its groups
    if max_samples is not None and num_samples > max_samples:
        raise ValueError(
            f"num_samples {num_samples} is over the server ceiling of {max_samples}; raise "
            f"--max_samples (or pass --max_samples 0 for no limit)"
        )
    protein = load_protein_arg(req["protein"])
    ligand = parse_ligand_arg(req["ligand"])
    # the size guard, before any ESM or device work
    n_nodes = ligand.num_atoms() + len(protein.aatype)
    if max_nodes is not None and n_nodes > max_nodes:
        raise ValueError(
            f"request has {n_nodes} nodes (ligand atoms + residues), over the server ceiling "
            f"of {max_nodes}; raise --max_nodes (or pass --max_nodes 0 for no limit) and warm "
            f"the matching bucket at startup"
        )
    data = complex_data(protein, ligand, embedder.embed_protein(protein))
    with device_lock or contextlib.nullcontext():
        results = runner.run([data] * num_samples, seed, mask_prob=mask_prob,
                             trajectory=trajectory)

    req_dir = _claim_request_dir(output_dir, req_id)
    out = {"id": req_id, "sequences": [], "tmscores": [], "pdb_files": [], "sdf_files": []}
    trajectory_files = []
    ref_protein = None
    for i, result in enumerate(results):
        pos, seq_prob = result[0], result[1]
        sp, sl = update_pos(protein, ligand, pos)
        sp = update_seq(sp, seq_prob)
        if trajectory:
            frames = [update_seq(update_pos(protein, ligand, frame)[0], seq_prob)
                      for frame in result[2]]
            traj_path = req_dir / f"sample_trajectory_{i}.pdb"
            proteins_to_pdb_file(frames, traj_path)
            trajectory_files.append(str(traj_path))
        if ref_protein is None:
            ref_protein = sp
        tmscore, t, R = max(
            run_tmalign(sp, ref_protein),
            run_tmalign(sp, ref_protein, mirror=True),
            key=itemgetter(0),
        )
        sp = dataclasses.replace(sp, atom_pos=t + sp.atom_pos @ R)
        sl = update_mol_positions(sl, t + get_mol_positions(sl) @ R)
        pdb_path, sdf_path = req_dir / f"sample_{i}.pdb", req_dir / f"sample_{i}.sdf"
        protein_to_pdb_file(sp, pdb_path)
        sdf_path.write_text(mol_to_sdf(sl))
        out["sequences"].append(protein_to_sequence(sp))
        out["tmscores"].append(float(tmscore))
        out["pdb_files"].append(str(pdb_path))
        out["sdf_files"].append(str(sdf_path))
    if trajectory:
        out["trajectory_files"] = trajectory_files
    return out


def warmup_runner(runner, buckets, esm_dim) -> None:
    """Sample one synthetic complex at each listed bucket, so the first
    request there finds the CUDA kernels built and loaded and the allocator
    warm. The serve runner pads every group to its batch size, so this is
    the one shape the bucket runs. Off-ladder buckets are refused."""
    import numpy as np

    from ..chem.mol import mol_from_smiles, update_mol_positions
    from ..chem.protein import protein_from_sequence
    from ..data.featurize import ligand_to_data, protein_to_data

    bad = [b for b in buckets if b not in runner.buckets]
    if bad:
        raise SystemExit(
            f"--warmup_buckets {bad} are not ladder rungs; pick from {list(runner.buckets)} "
            f"(requests are padded UP to the nearest rung, so warming an off-rung size would "
            f"run a shape no request uses)"
        )
    mol = update_mol_positions(mol_from_smiles("CC"), np.zeros((2, 3)))
    for bucket in buckets:
        prot = protein_from_sequence("A" * (bucket - 2))
        data = {**ligand_to_data(mol), **protein_to_data(prot, esm_dim=esm_dim)}
        print(f"[serve] warming bucket {bucket}...", file=sys.stderr, flush=True)
        runner.run([data], 0)
    if buckets:
        print("[serve] warmup done", file=sys.stderr, flush=True)


def handle_line(line, runner, embedder, output_dir, default_mask_prob,
                device_lock=None, max_nodes=None, max_samples=None):
    """One JSONL request line -> one result dict; never raises (bad
    requests become {"id", "error"} results so the server keeps going)."""
    req = None
    try:
        req = json.loads(line)
        return handle_request(
            req, runner, embedder, output_dir, default_mask_prob,
            device_lock=device_lock, max_nodes=max_nodes, max_samples=max_samples,
        )
    except Exception as e:
        req_id = req.get("id", "?") if isinstance(req, dict) else "?"
        return {"id": str(req_id), "error": f"{type(e).__name__}: {e}"}


def serve_tcp(port, runner, embedder, output_dir, default_mask_prob,
              host="127.0.0.1", max_requests=None, ready_cb=None,
              max_nodes=None, max_samples=None):
    """JSONL over TCP: each client connection streams request lines and
    receives one JSON result line per request. Connections are served by
    threads; the sampling serializes behind one lock while the rest (ESM,
    featurization, TM-align, file writes) overlaps.
    ``max_requests``/``ready_cb`` exist for tests."""
    import socketserver

    device_lock = threading.Lock()
    served = 0
    served_lock = threading.Lock()

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            nonlocal served
            for raw in self.rfile:
                line = raw.decode("utf-8", "replace").strip()
                if not line:
                    continue
                result = handle_line(
                    line, runner, embedder, output_dir, default_mask_prob,
                    device_lock=device_lock, max_nodes=max_nodes, max_samples=max_samples,
                )
                self.wfile.write((json.dumps(result) + "\n").encode())
                self.wfile.flush()
                with served_lock:
                    served += 1
                    if max_requests is not None and served >= max_requests:
                        threading.Thread(target=server.shutdown, daemon=True).start()
                        return

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    with Server((host, port), Handler) as server:
        bound = server.server_address[1]
        print(f"[serve] listening on {host}:{bound}", file=sys.stderr, flush=True)
        if ready_cb is not None:
            ready_cb(bound)
        server.serve_forever(poll_interval=0.05)


@command
def main(argv=None):
    from .common import NUM_DEVICES_HELP, add_esm_args, add_sampler_args

    parser = ArgumentParser()
    parser.add_argument("-c", "--ckpt_path", type=Path, required=True)
    parser.add_argument("-o", "--output_dir", type=Path, required=True)
    parser.add_argument("--num_steps", type=int, default=64)
    parser.add_argument("--mask_prob", type=float, default=0.3)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--num_devices", type=int, default=1, help=NUM_DEVICES_HELP)
    add_sampler_args(parser)
    parser.add_argument("--fast_softmax", action="store_true",
                        help="bf16 attention softmax (K1 fast) for a checkpoint whose config "
                             "has use_pallas_bwd false")
    add_esm_args(parser)
    parser.add_argument("--input", type=str, default=None,
                        help="JSONL request file (default: stdin)")
    parser.add_argument("--output", type=str, default=None,
                        help="JSONL result file (default: stdout)")
    parser.add_argument("--warmup_buckets", type=str, default="",
                        help="comma-separated bucket sizes to sample once at startup (e.g. "
                             "192,256); the runner's ladder is then restricted to them")
    parser.add_argument("--max_nodes", type=int, default=None,
                        help="reject requests above this node count (ligand atoms + residues). "
                             "Default: the largest --warmup_buckets rung when warming, else "
                             "unlimited; 0 = explicitly unlimited")
    parser.add_argument("--max_samples", type=int, default=1024,
                        help="reject requests whose num_samples exceeds this ceiling; "
                             "0 = unlimited")
    parser.add_argument("--port", type=int, default=None,
                        help="serve JSONL over TCP on this port (0: any free one) instead of "
                             "stdin/stdout")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to sample on (cuda or cpu)")
    args = parser.parse_args(argv)

    import torch

    from ..chem.protein import protein_from_sequence
    from ..models.prdiff import ProteinReDiffNet
    from ..utils.esm import ESMEmbedder
    from ..utils.weights import load_checkpoint
    from .common import (
        SamplingRunner,
        apply_serving_defaults,
        check_supported_args,
        make_inference_mesh,
        runner_sampler_kwargs,
        sampler_cfg_overrides,
    )

    check_supported_args(args)
    mesh = make_inference_mesh(args.num_devices, args.device)
    state_dict, cfg = load_checkpoint(args.ckpt_path, num_steps=args.num_steps)
    cfg = apply_serving_defaults(cfg.replace(
        training_mode=False, fast_softmax=args.fast_softmax,
        **sampler_cfg_overrides(args),
    ), args)
    device = torch.device(args.device)
    net = ProteinReDiffNet(cfg)
    net.load_state_dict(state_dict)
    net.to(device).eval()

    # transformers imports TensorFlow and jax where they are installed unless
    # told not to; the port runs torch only.
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    embedder = ESMEmbedder(model_name=args.esm_model, device=args.device, esm_dim=cfg.esm_dim,
                           require=args.require_esm, backend=args.esm_backend)
    # resolve the ESM backend (its weights onto --device, or the zeros
    # fallback) at startup, not on the first request
    print("[serve] resolving ESM backend...", file=sys.stderr, flush=True)
    embedder.embed_protein(protein_from_sequence("A"))
    args.output_dir.mkdir(parents=True, exist_ok=True)

    warm = [int(b) for b in args.warmup_buckets.split(",") if b.strip()]
    runner = SamplingRunner(
        net, device, batch_size=args.batch_size, mask_prob=args.mask_prob,
        # one shape per bucket: remainder groups are padded to batch_size
        pad_to_batch=True,
        # warmed buckets restrict the ladder: a small request pads up to a
        # warmed rung instead of running an unwarmed smaller one
        buckets=sorted(warm) if warm else None,
        mesh=mesh, **runner_sampler_kwargs(args),
    )
    if warm:
        warmup_runner(runner, warm, cfg.esm_dim)
    max_nodes = args.max_nodes
    if max_nodes is None and warm:
        max_nodes = max(warm)
        print(f"[serve] max_nodes defaulting to largest warmed bucket ({max_nodes}); override "
              f"with --max_nodes", file=sys.stderr, flush=True)
    if max_nodes is not None and max_nodes <= 0:
        max_nodes = None
    max_samples = args.max_samples if args.max_samples > 0 else None

    if args.port is not None:
        serve_tcp(args.port, runner, embedder, args.output_dir, args.mask_prob,
                  host=args.host, max_nodes=max_nodes, max_samples=max_samples)
        return runner

    in_f = open(args.input) if args.input else sys.stdin
    out_f = open(args.output, "w") if args.output else sys.stdout
    try:
        for line in in_f:
            line = line.strip()
            if not line:
                continue
            result = handle_line(line, runner, embedder, args.output_dir, args.mask_prob,
                                 max_nodes=max_nodes, max_samples=max_samples)
            out_f.write(json.dumps(result) + "\n")
            out_f.flush()
    finally:
        if args.input:
            in_f.close()
        if args.output:
            out_f.close()
    return runner


if __name__ == "__main__":
    main()
