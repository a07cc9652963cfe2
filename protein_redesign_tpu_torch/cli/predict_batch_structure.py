"""Batched structure redesign CLI (port of
``protein_redesign_tpu/cli/predict_batch_structure.py``):

    python -m protein_redesign_tpu_torch.cli.predict_batch_structure \\
        -c <ckpt> -o out/ -p seqs.fasta [-l ligands.smiles] -n 4 \\
        [--num_steps 1000] [--mask_prob 0.3] [--seed 0] [--device cuda]

Outputs: masked_sequences.fasta up front (each input masked from
``--seed``), then per input name sample_protein_<name>_model_<i>.pdb,
sample_ligand_<name>_model_<i>.sdf and sample_tmscores_<name>.txt, each
name's samples rigidly aligned to its first with mirror-trial TM-align.
"""

from __future__ import annotations

import dataclasses
import warnings
from argparse import ArgumentParser
from operator import itemgetter

from . import command


@command
def main(argv=None):
    from .common import add_batch_args

    parser = ArgumentParser()
    add_batch_args(parser)
    args = parser.parse_args(argv)

    from ..chem.mol import get_mol_positions, mol_to_sdf, update_mol_positions
    from ..chem.protein import protein_to_pdb_file
    from ..utils.tmalign import run_tmalign
    from .common import sample_fasta, update_pos, update_seq

    names, proteins, ligands, results, timings = sample_fasta(args)
    n = args.num_samples
    for j, (name, protein, ligand) in enumerate(zip(names, proteins, ligands)):
        ref_protein = None
        sample_proteins, sample_ligands, tmscores = [], [], []
        for result in results[j * n:(j + 1) * n]:
            sample_protein, sample_ligand = update_pos(protein, ligand, result[0])
            sample_protein = update_seq(sample_protein, result[1])
            if ref_protein is None:
                warnings.warn("Using the first sample as a reference. The resulting "
                              "structures may be mirror images.")
                ref_protein = sample_protein
            tmscore, t, R = max(
                run_tmalign(sample_protein, ref_protein),
                run_tmalign(sample_protein, ref_protein, mirror=True),
                key=itemgetter(0),
            )
            sample_proteins.append(
                dataclasses.replace(sample_protein, atom_pos=t + sample_protein.atom_pos @ R))
            sample_ligands.append(
                update_mol_positions(sample_ligand, t + get_mol_positions(sample_ligand) @ R))
            tmscores.append(tmscore)
        for i, sp in enumerate(sample_proteins):
            protein_to_pdb_file(sp, args.output_dir / f"sample_protein_{name}_model_{i}.pdb")
        for i, sl in enumerate(sample_ligands):
            with open(args.output_dir / f"sample_ligand_{name}_model_{i}.sdf", "w") as f:
                f.write(mol_to_sdf(sl))
        with open(args.output_dir / f"sample_tmscores_{name}.txt", "w") as f:
            for tmscore in tmscores:
                f.write(str(tmscore) + "\n")
    print(f"wrote outputs for {len(names)} inputs to {args.output_dir}")
    return timings


if __name__ == "__main__":
    main()
