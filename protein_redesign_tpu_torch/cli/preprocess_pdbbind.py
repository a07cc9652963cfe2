"""Offline PDBbind featurization (port of
``protein_redesign_tpu/cli/preprocess_pdbbind.py``; reference
`preprocess_pdbbind.py:25-91`).

For each PDB id across the three PRD splits: load the ligand
(<id>_ligand.sdf, fallback .mol2) and the protein
(<id>_protein_processed.pdb), compute per-chain ESM-2 embeddings on
``--device`` with the HF transformers model or, with ``--esm_backend jax``,
the package's own encoder (zeros where the weights are not available
offline), and write the complex cache that training reads.

    python -m protein_redesign_tpu_torch.cli.preprocess_pdbbind \\
        --data_dir data --pdbbind_dir data/PDBbind_processed [--device cpu]
"""

from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path

from tqdm import tqdm


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--data_dir", type=Path, default=Path("data"))
    parser.add_argument("--pdbbind_dir", type=Path, default=Path("data/PDBbind_processed"))
    parser.add_argument("--cache_dir", type=Path, default=None)
    from .common import add_esm_args

    add_esm_args(parser)
    parser.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--limit", type=int, default=0,
                        help="preprocess only the first N ids (shard smoke runs; 0 = all)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device ESM-2 runs on (cuda or cpu)")
    args = parser.parse_args(argv)

    import os

    from ..chem.mol import mol_from_file
    from ..chem.protein import protein_from_pdb_file, protein_to_sequence
    from ..data.dataset import load_split_ids, save_complex_cache
    from ..data.featurize import ligand_to_data, protein_to_data
    from ..utils.esm import ESMEmbedder, esm_tokens

    cache_dir = args.cache_dir or args.data_dir / "PDB_processed_cache"
    pdb_ids = []
    for split in args.splits:
        pdb_ids.extend(load_split_ids(args.data_dir, split))
    if args.limit:
        pdb_ids = pdb_ids[:args.limit]

    # transformers imports TensorFlow and jax where they are installed unless
    # told not to; the port runs torch only.
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    embedder = ESMEmbedder(model_name=args.esm_model, device=args.device,
                           require=args.require_esm, backend=args.esm_backend)
    n_ok, n_fail = 0, 0
    for pdb_id in tqdm(pdb_ids):
        out = Path(cache_dir) / pdb_id / "complex.npz"
        if out.exists() and not args.overwrite:
            continue
        try:
            src = args.pdbbind_dir / pdb_id
            try:
                ligand = mol_from_file(src / f"{pdb_id}_ligand.sdf")
            except Exception:
                ligand = mol_from_file(src / f"{pdb_id}_ligand.mol2")
            protein = protein_from_pdb_file(src / f"{pdb_id}_protein_processed.pdb")
            residue_esm = embedder.embed_protein(protein)
            tokens = esm_tokens(protein_to_sequence(protein))
            data = {
                **ligand_to_data(ligand),
                **protein_to_data(protein, residue_esm=residue_esm, residue_esm_tokens=tokens),
            }
            save_complex_cache(cache_dir, pdb_id, data)
            n_ok += 1
        except Exception as e:
            n_fail += 1
            print(f"[skip] {pdb_id}: {type(e).__name__}: {e}")
    print(f"preprocessed {n_ok} complexes ({n_fail} failed) -> {cache_dir}")


if __name__ == "__main__":
    main()
