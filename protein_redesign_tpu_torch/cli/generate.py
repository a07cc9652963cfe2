"""Single-complex generation CLI (port of ``protein_redesign_tpu/cli/generate.py``).

    python -m protein_redesign_tpu_torch.cli.generate \\
        -c <ckpt_dir or reference .ckpt> -o out/ -p <pdb-or-sequence> \\
        -l <sdf/mol2/SMILES/*> -n 8 [--num_steps 1000] [--mask_prob 0.3] [-r ref.pdb]

``-c`` is a directory holding ``config.json`` and ``model.pt``, or a
reference Lightning ``.ckpt`` (EMA weights preferred). Outputs, as the JAX
CLI writes them: sample_protein.pdb (multi-model), sample_ligand.sdf and
sample_tmscores.txt, the samples rigidly aligned to the reference (or the
first sample) with mirror-trial TM-align.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from argparse import ArgumentParser
from operator import itemgetter
from pathlib import Path


def main(argv=None):
    from .common import add_esm_args, add_sampler_args

    parser = ArgumentParser()
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--num_devices", "--num_gpus", type=int, default=1,
                        dest="num_devices")
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
    parser.add_argument("--fast_softmax", action="store_true")
    parser.add_argument("--save_trajectory", type=int, default=0, metavar="K")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to sample on (cuda or cpu)")
    args = parser.parse_args(argv)

    import torch

    from protein_redesign_tpu.chem.mol import get_mol_positions, mols_to_sdf_file, update_mol_positions
    from protein_redesign_tpu.chem.protein import protein_from_pdb_file, proteins_to_pdb_file
    from protein_redesign_tpu.utils.esm import ESMEmbedder
    from protein_redesign_tpu.utils.tmalign import run_tmalign

    from ..models.prdiff import ProteinReDiffNet
    from ..utils.weights import load_checkpoint
    from .common import (
        SamplingRunner,
        apply_serving_defaults,
        check_supported_args,
        complex_data,
        load_protein_arg,
        parse_ligand_arg,
        sampler_cfg_overrides,
        update_pos,
        update_seq,
    )

    check_supported_args(args)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    device = torch.device(args.device)

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
    embedder = ESMEmbedder(model_name=args.esm_model, esm_dim=cfg.esm_dim,
                           require=args.require_esm, backend="torch")
    data = complex_data(protein, ligand, embedder.embed_protein(protein))
    if not embedder.available:
        print("ESM-2 weights unavailable: residue_esm is zero")
    ref_protein = protein_from_pdb_file(args.ref_path) if args.ref_path else None

    runner = SamplingRunner(net, device, batch_size=args.batch_size, mask_prob=args.mask_prob)
    results = runner.run([data] * args.num_samples, seed=args.seed)
    for bucket, rows, steps, seconds in runner.timings:
        print(f"sampled {rows} at bucket {bucket}: {steps} steps in {seconds:.3f} s "
              f"({seconds / steps:.4f} s/step)")

    sample_proteins, sample_ligands, tmscores = [], [], []
    for pos, seq_prob in results:
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
    return runner.timings


if __name__ == "__main__":
    main()
