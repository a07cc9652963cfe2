"""Batched sequence redesign CLI (port of
``protein_redesign_tpu/cli/predict_batch_sequence.py``):

    python -m protein_redesign_tpu_torch.cli.predict_batch_sequence \\
        -c <ckpt> -o out/ -p seqs.fasta [-l ligands.smiles] -n 4 \\
        [--num_steps 1000] [--mask_prob 0.3] [--seed 0] [--device cuda]

The structure CLI's pipeline without the coordinates: writes
masked_sequences.fasta (each input masked from ``--seed``) and
sample_sequences.fasta, the argmax-decoded sequence of every sample with
terminal X stripped.
"""

from __future__ import annotations

from argparse import ArgumentParser

from . import command


@command
def main(argv=None):
    from .common import add_batch_args

    parser = ArgumentParser()
    add_batch_args(parser)
    args = parser.parse_args(argv)

    from .common import predict_seq, sample_fasta

    names, _, _, results, timings = sample_fasta(args)
    rep_names = [n for n in names for _ in range(args.num_samples)]
    with open(args.output_dir / "sample_sequences.fasta", "w") as f:
        for i, (name, result) in enumerate(zip(rep_names, results)):
            f.write(f">{name}_sample_{i % args.num_samples}\n{predict_seq(result[1])}\n")
    print(f"wrote sample_sequences.fasta for {len(names)} inputs")
    return timings


if __name__ == "__main__":
    main()
