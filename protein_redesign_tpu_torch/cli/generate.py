"""Single-complex generation CLI (port of ``protein_redesign_tpu/cli/generate.py``).

    python -m protein_redesign_tpu_torch.cli.generate \\
        -c <ckpt_dir or reference .ckpt> -o out/ -p <pdb-or-sequence> \\
        -l <sdf/mol2/SMILES/*> -n 8 [--num_steps 1000] [--mask_prob 0.3] [-r ref.pdb] \\
        [--sampler ddim --ddim_steps 50 --eta 0] [--save_trajectory K] [--fast_softmax] \\
        [--sampler ddim_parallel --window 8 --ptol 1e-3 --coarse_init 0] [--attn_chunk 128] \\
        [--esm_model <HF dir> --esm_backend {torch,jax}] [--use_pallas] [--trimul_dmajor]

``-c`` is a directory holding ``config.json`` and ``model.pt``, or a
reference Lightning ``.ckpt`` (EMA weights preferred). Outputs, as the JAX
CLI writes them: sample_protein.pdb (multi-model), sample_ligand.sdf and
sample_tmscores.txt, the samples rigidly aligned to the reference (or the
first sample) with mirror-trial TM-align; with ``--save_trajectory K`` also
sample_trajectory_<i>.pdb per sample, K denoising frames as one MODEL each.
``--fast_softmax`` runs triangle attention through K1 fast where the
checkpoint's config has ``use_pallas_bwd: false``, as the JAX package does;
otherwise it changes only the triangle product's accumulator. The sequence
process and self-conditioning come from the checkpoint's config;
``--seq_reverse`` and ``--reveal_schedule`` / ``--reveal_temperature`` /
``--reveal_conf_noise`` (absorbing checkpoints) override it. ESM-2 runs on
``--device``: the HF transformers model, or with ``--esm_backend jax`` the
package's own encoder (``models/esm2.py``) on the same weights.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from argparse import ArgumentParser
from operator import itemgetter
from pathlib import Path

from . import command


@command
def main(argv=None):
    from .common import NUM_DEVICES_HELP, add_esm_args, add_sampler_args

    parser = ArgumentParser()
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--num_workers", type=int, default=2, help="accepted and ignored")
    parser.add_argument("--num_devices", "--num_gpus", type=int, default=1,
                        dest="num_devices", help=NUM_DEVICES_HELP)
    parser.add_argument("--num_steps", type=int, default=64)
    parser.add_argument("--mask_prob", type=float, default=0.3)
    parser.add_argument("--training_mode", action="store_true")
    add_esm_args(parser)
    parser.add_argument("-c", "--ckpt_path", type=Path, required=True)
    parser.add_argument("-o", "--output_dir", type=Path, required=True)
    parser.add_argument("-p", "--protein", type=str, required=True)
    parser.add_argument("-l", "--ligand", type=str, required=True)
    parser.add_argument("-n", "--num_samples", type=int, required=True)
    parser.add_argument("-r", "--ref_path", type=Path)
    add_sampler_args(parser)
    parser.add_argument("--fast_softmax", action="store_true",
                        help="bf16 attention softmax (K1 fast) for a checkpoint whose config "
                             "has use_pallas_bwd false")
    parser.add_argument("--save_trajectory", type=int, default=0, metavar="K",
                        help="also write sample_trajectory_<i>.pdb per sample: K denoising "
                             "frames (K must divide the sampler's step count)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to sample on (cuda or cpu)")
    args = parser.parse_args(argv)

    import torch

    from ..chem.mol import get_mol_positions, mols_to_sdf_file, update_mol_positions
    from ..chem.protein import protein_from_pdb_file, proteins_to_pdb_file
    from ..models.prdiff import ProteinReDiffNet
    from ..utils.esm import ESMEmbedder
    from ..utils.tmalign import run_tmalign
    from ..utils.weights import load_checkpoint
    from .common import (
        SamplingRunner,
        apply_serving_defaults,
        check_supported_args,
        make_inference_mesh,
        complex_data,
        load_protein_arg,
        parse_ligand_arg,
        print_timings,
        runner_sampler_kwargs,
        sampler_cfg_overrides,
        update_pos,
        update_seq,
    )

    check_supported_args(args)
    device = torch.device(args.device)
    mesh = make_inference_mesh(args.num_devices, device)
    args.output_dir.mkdir(parents=True, exist_ok=True)

    state_dict, cfg = load_checkpoint(args.ckpt_path, num_steps=args.num_steps)
    cfg = apply_serving_defaults(cfg.replace(
        training_mode=False, fast_softmax=args.fast_softmax,
        **sampler_cfg_overrides(args),
    ), args)
    net = ProteinReDiffNet(cfg)
    net.load_state_dict(state_dict)
    net.to(device).eval()

    protein = load_protein_arg(args.protein)
    ligand = parse_ligand_arg(args.ligand)
    total_num_atoms = len(protein.aatype) + ligand.num_atoms()
    print(f"Total number of atoms: {total_num_atoms}")
    if total_num_atoms > 384:
        warnings.warn("Too many atoms. May take a long time for sample generation.")

    # transformers imports TensorFlow and jax where they are installed unless
    # told not to; the port runs torch only.
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    embedder = ESMEmbedder(model_name=args.esm_model, device=args.device, esm_dim=cfg.esm_dim,
                           require=args.require_esm, backend=args.esm_backend)
    data = complex_data(protein, ligand, embedder.embed_protein(protein))
    if not embedder.available:
        print("ESM-2 weights unavailable: residue_esm is zero")
    ref_protein = protein_from_pdb_file(args.ref_path) if args.ref_path else None

    runner = SamplingRunner(net, device, batch_size=args.batch_size, mask_prob=args.mask_prob,
                            mesh=mesh, **runner_sampler_kwargs(args))
    results = runner.run([data] * args.num_samples, seed=args.seed,
                         trajectory=args.save_trajectory)
    print_timings(runner)

    sample_proteins, sample_ligands, tmscores = [], [], []
    for sample_idx, result in enumerate(results):
        pos, seq_prob = result[0], result[1]
        if args.save_trajectory:
            # the raw diffusion states share the sampler's zero-centred frame:
            # no TM-align fit, unlike the final samples below
            frame_proteins = [update_seq(update_pos(protein, ligand, frame)[0], seq_prob)
                              for frame in result[2]]
            proteins_to_pdb_file(frame_proteins,
                                 args.output_dir / f"sample_trajectory_{sample_idx}.pdb")
        sample_protein, sample_ligand = update_pos(protein, ligand, pos)
        sample_protein = update_seq(sample_protein, seq_prob)
        if ref_protein is None:
            warnings.warn(
                "Using the first sample as a reference. The resulting "
                "structures may be mirror images."
            )
            ref_protein = sample_protein
        tmscore, t, R = max(
            run_tmalign(sample_protein, ref_protein),
            run_tmalign(sample_protein, ref_protein, mirror=True),
            key=itemgetter(0),
        )
        sample_proteins.append(
            dataclasses.replace(sample_protein, atom_pos=t + sample_protein.atom_pos @ R)
        )
        sample_ligands.append(
            update_mol_positions(sample_ligand, t + get_mol_positions(sample_ligand) @ R)
        )
        tmscores.append(tmscore)

    proteins_to_pdb_file(sample_proteins, args.output_dir / "sample_protein.pdb")
    mols_to_sdf_file(sample_ligands, args.output_dir / "sample_ligand.sdf")
    with open(args.output_dir / "sample_tmscores.txt", "w") as f:
        for tmscore in tmscores:
            f.write(str(tmscore) + "\n")
    print(f"wrote {len(sample_proteins)} samples to {args.output_dir}")
    return runner


if __name__ == "__main__":
    main()
