# Copied from protein_redesign_tpu/cli/evaluate.py so the port imports nothing of the JAX package.
"""Standalone evaluation CLI over generated redesign outputs.

The reference paper evaluates sequence diversity, structural
preservation, and ligand binding affinity but ships no metric code
(SURVEY.md §6; reference `README.md:201`); its CLIs only emit per-run
`sample_tmscores.txt` computed inline (`generate.py:168-195`,
`scripts/predict_batch_strc_msk_inp.py:235-281`). This tool scores any
finished output directory after the fact, so users can re-evaluate
against a different reference, aggregate batch runs, or compare two
runs without re-sampling.

    python -m protein_redesign_tpu.cli.evaluate -i out/ \\
        [-r ref.pdb] [--ref_dir refs/] [--ref_fasta refs.fasta] \\
        [-o report.json] [--csv report.csv]

Input layouts recognized (both generation CLIs' contracts):
- single-complex (`cli/generate.py`): `sample_protein.pdb`
  (multi-model) -> one group named "sample";
- batch structure (`cli/predict_batch_structure.py`):
  `sample_protein_<name>_model_<i>.pdb` -> one group per input name;
- batch sequence (`cli/predict_batch_sequence.py`):
  `sample_sequences.fasta` (headers `>{name}_sample_{i}`) -> sequence
  groups (no structure metrics);
- `masked_sequences.fasta`, when present, defines the redesign targets
  ('X' positions) for masked-position recovery.

Structure metrics per group: mirror-aware TM-score, Kabsch CA-RMSD,
and CA-lDDT of every model vs the reference structure — `<name>.pdb` (or
`<name>_protein.pdb`) under --ref_dir, or the single --ref_path; with
no reference, the first sample serves as reference (the generation
CLIs' own fallback, `generate.py:142-146`) and the report says so.
Sequence metrics: overall + masked-position recovery vs --ref_fasta
(or the reference PDB's own sequence) and pairwise diversity.

Pure host-side tool: no JAX import, loads no model — runs anywhere the
chem layer and the in-repo TMalign binary do.
"""

from __future__ import annotations

import json
import re
import sys
from argparse import ArgumentParser
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..chem.protein import (
    Protein,
    protein_from_pdb_file,
    protein_to_sequence,
    proteins_from_pdb_file,
    read_fasta,
)
from ..utils.metrics import (
    ca_lddt,
    kabsch_rmsd,
    ligand_interface_stats,
    sequence_diversity,
    sequence_recovery,
    tm_scores,
)

_MODEL_RE = re.compile(r"^sample_protein_(.+)_model_(\d+)\.pdb$")
_LIGAND_RE = re.compile(r"^sample_ligand_(.+)_model_(\d+)\.sdf$")
_SAMPLE_RE = re.compile(r"^(.+)_sample_(\d+)$")


def discover_structure_groups(
    input_dir: Path,
) -> Dict[str, List[Protein]]:
    """Map group name -> ordered list of sampled Protein models."""
    groups: Dict[str, List[Tuple[int, Protein]]] = {}
    single = input_dir / "sample_protein.pdb"
    if single.exists():
        groups["sample"] = [
            (i, p) for i, p in enumerate(proteins_from_pdb_file(single))
        ]
    for path in sorted(input_dir.glob("sample_protein_*_model_*.pdb")):
        m = _MODEL_RE.match(path.name)
        if not m:
            continue
        name, idx = m.group(1), int(m.group(2))
        groups.setdefault(name, []).append(
            (idx, protein_from_pdb_file(path))
        )
    return {
        name: [p for _, p in sorted(models, key=lambda x: x[0])]
        for name, models in groups.items()
    }


def discover_ligand_groups(
    input_dir: Path,
) -> Dict[str, Dict[int, np.ndarray]]:
    """Group name -> {model index -> ligand heavy-atom positions} from
    the generation CLIs' SDF outputs (multi-record `sample_ligand.sdf`
    for the single layout, per-model files for the batch layout)."""
    from ..chem.mol import get_mol_positions, mols_from_sdf_file

    groups: Dict[str, Dict[int, np.ndarray]] = {}
    single = input_dir / "sample_ligand.sdf"
    if single.exists():
        groups["sample"] = {
            i: get_mol_positions(m)
            for i, m in enumerate(mols_from_sdf_file(single))
        }
    for path in sorted(input_dir.glob("sample_ligand_*_model_*.sdf")):
        m = _LIGAND_RE.match(path.name)
        if not m:
            continue
        name, idx = m.group(1), int(m.group(2))
        mols = mols_from_sdf_file(path)
        if mols:
            groups.setdefault(name, {})[idx] = get_mol_positions(mols[0])
    return groups


def discover_sequence_groups(input_dir: Path) -> Dict[str, List[str]]:
    """Map group name -> designed sequences from sample_sequences.fasta."""
    path = input_dir / "sample_sequences.fasta"
    if not path.exists():
        return {}
    groups: Dict[str, List[Tuple[int, str]]] = {}
    for header, seq in read_fasta(path):
        m = _SAMPLE_RE.match(header)
        name, idx = (m.group(1), int(m.group(2))) if m else (header, 0)
        groups.setdefault(name, []).append((idx, seq))
    return {
        name: [s for _, s in sorted(seqs, key=lambda x: x[0])]
        for name, seqs in groups.items()
    }


def read_masked_positions(input_dir: Path) -> Dict[str, List[int]]:
    """Group name -> 0-based 'X' positions from masked_sequences.fasta
    (the redesign targets chosen at generation time)."""
    path = input_dir / "masked_sequences.fasta"
    if not path.exists():
        return {}
    out: Dict[str, List[int]] = {}
    for header, seq in read_fasta(path):
        m = _SAMPLE_RE.match(header)
        name = m.group(1) if m else header
        out.setdefault(
            name, [i for i, c in enumerate(seq) if c == "X"]
        )
    return out


def resolve_reference(
    name: str,
    ref_protein: Optional[Protein],
    ref_dir: Optional[Path],
) -> Optional[Protein]:
    """Reference structure for a group, if the user supplied one."""
    if ref_dir is not None:
        for candidate in (f"{name}.pdb", f"{name}_protein.pdb"):
            p = ref_dir / candidate
            if p.exists():
                return protein_from_pdb_file(p)
    return ref_protein


def _ca_map(prot: Protein) -> Dict[Tuple[int, int], np.ndarray]:
    """(chain_index, residue_index) -> CA position, for residues whose
    CA atom is actually resolved (atom_mask) — external reference PDBs
    routinely have unresolved loops/missing CAs, so metrics must pair by
    residue identity, not array position."""
    return {
        (int(prot.chain_index[i]), int(prot.residue_index[i])):
            prot.atom_pos[i, 1]
        for i in range(len(prot))
        if prot.atom_mask[i, 1] > 0.5
    }


def paired_ca_rmsd(prb: Protein, ref: Protein) -> Optional[float]:
    """Kabsch CA-RMSD over residues present (with CA) in BOTH
    structures, paired by (chain, residue number)."""
    pm, rm = _ca_map(prb), _ca_map(ref)
    keys = [k for k in pm if k in rm]
    if len(keys) < 3:
        return None
    x = np.stack([pm[k] for k in keys])
    y = np.stack([rm[k] for k in keys])
    return kabsch_rmsd(x, y)


def paired_lddt(prb: Protein, ref: Protein) -> Optional[float]:
    """CA-lDDT over residues paired by (chain, residue number)."""
    pm, rm = _ca_map(prb), _ca_map(ref)
    keys = sorted(k for k in pm if k in rm)
    if len(keys) < 4:
        return None
    return ca_lddt(
        np.stack([pm[k] for k in keys]),
        np.stack([rm[k] for k in keys]),
        residue_numbers=np.array([k[1] for k in keys]),
        chain_indices=np.array([k[0] for k in keys]),
    )


def paired_recovery(
    designs: Sequence[Protein],
    ref: Protein,
    masked: Sequence[int] = (),
) -> Optional[float]:
    """Mean residue-identity recovery vs a reference STRUCTURE, paired
    by (chain, residue number); ``masked`` restricts to those design
    positions (0-based array indices)."""
    ref_aa = {
        (int(ref.chain_index[i]), int(ref.residue_index[i])):
            int(ref.aatype[i])
        for i in range(len(ref))
    }
    masked_set = set(masked)
    scores = []
    for p in designs:
        hits = total = 0
        for i in range(len(p)):
            if masked_set and i not in masked_set:
                continue
            key = (int(p.chain_index[i]), int(p.residue_index[i]))
            if key not in ref_aa:
                continue
            total += 1
            hits += int(p.aatype[i]) == ref_aa[key]
        if total:
            scores.append(hits / total)
    return float(np.mean(scores)) if scores else None


def _mean(vals: Sequence[float]) -> Optional[float]:
    return round(float(np.mean(vals)), 4) if len(vals) else None


def score_group(
    models: List[Protein],
    ref: Optional[Protein],
    ref_seq: Optional[str],
    masked: Sequence[int],
    ligands: Optional[Dict[int, np.ndarray]] = None,
) -> dict:
    """All metrics for one group of sampled structures."""
    designs = [protein_to_sequence(p) for p in models]
    if ref is None:
        ref_struct, ref_kind = models[0], "first_sample"
        scored = models[1:]
    else:
        ref_struct, ref_kind = ref, "provided"
        scored = models
    rmsds = [paired_ca_rmsd(p, ref_struct) for p in scored]
    lddts = [paired_lddt(p, ref_struct) for p in scored]
    row = {
        "num_models": len(models),
        "reference": ref_kind,
        "tm": [round(s, 4) for s in tm_scores(scored, ref_struct)],
        "ca_rmsd": [round(r, 3) for r in rmsds if r is not None],
        "lddt": [round(v, 4) for v in lddts if v is not None],
        "diversity": round(sequence_diversity(designs), 4),
    }
    row["tm_mean"] = _mean(row["tm"])
    row["ca_rmsd_mean"] = _mean(row["ca_rmsd"])
    row["lddt_mean"] = _mean(row["lddt"])
    if ref_seq is not None:
        # a reference FASTA defines sequence positions directly
        row["recovery"] = round(sequence_recovery(designs, ref_seq), 4)
        if masked:
            row["recovery_masked"] = round(
                sequence_recovery(designs, ref_seq, masked_only=masked), 4
            )
    elif ref is not None:
        # recovery vs the reference STRUCTURE's residues, paired by
        # (chain, residue number) — robust to gaps in experimental PDBs
        rec = paired_recovery(models, ref)
        if rec is not None:
            row["recovery"] = round(rec, 4)
        if masked:
            rec_m = paired_recovery(models, ref, masked=masked)
            if rec_m is not None:
                row["recovery_masked"] = round(rec_m, 4)
    if ligands:
        # interface stats pair each model with ITS OWN ligand record
        # (the CLIs rigid-align protein+ligand together per sample)
        stats = [
            ligand_interface_stats(
                p.atom_pos[p.atom_mask[:, 1] > 0.5, 1], ligands[i]
            )
            for i, p in enumerate(models) if i in ligands
        ]
        if stats:
            row["lig_contacts_mean"] = round(
                float(np.mean([s["contacts"] for s in stats])), 2
            )
            row["lig_clashes_mean"] = round(
                float(np.mean([s["clashes"] for s in stats])), 2
            )
            row["lig_min_dist_mean"] = round(
                float(np.mean([s["min_dist"] for s in stats])), 3
            )
    return row


def score_sequence_group(
    designs: List[str], ref_seq: Optional[str], masked: Sequence[int]
) -> dict:
    """Sequence-only metrics (batch sequence CLI outputs)."""
    row: dict = {
        "num_models": len(designs),
        "diversity": round(sequence_diversity(designs), 4),
    }
    if ref_seq is not None:
        row["recovery"] = round(sequence_recovery(designs, ref_seq), 4)
        if masked:
            row["recovery_masked"] = round(
                sequence_recovery(designs, ref_seq, masked_only=masked), 4
            )
    return row


def aggregate(groups: Dict[str, dict]) -> dict:
    """Mean of each numeric per-group metric over the groups that
    report it."""
    agg: dict = {"num_groups": len(groups)}
    for metric in (
        "tm_mean", "ca_rmsd_mean", "lddt_mean", "recovery", "recovery_masked",
        "diversity", "lig_contacts_mean", "lig_clashes_mean",
        "lig_min_dist_mean",
    ):
        vals = [
            g[metric] for g in groups.values()
            if g.get(metric) is not None
        ]
        if vals:
            agg[metric] = round(float(np.mean(vals)), 4)
    return agg


def write_csv(path: Path, groups: Dict[str, dict]) -> None:
    import csv

    cols = [
        "name", "num_models", "reference", "tm_mean", "ca_rmsd_mean",
        "lddt_mean", "recovery", "recovery_masked", "diversity",
        "lig_contacts_mean", "lig_clashes_mean", "lig_min_dist_mean",
    ]
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=cols, extrasaction="ignore")
        writer.writeheader()
        for name, row in groups.items():
            out = {
                c: ("" if row.get(c) is None else row.get(c))
                for c in cols
            }
            out["name"] = name
            writer.writerow(out)


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("-i", "--input_dir", type=Path, required=True,
                        help="a generate/predict_batch_* output directory")
    parser.add_argument("-r", "--ref_path", type=Path,
                        help="reference PDB applied to every group")
    parser.add_argument("--ref_dir", type=Path,
                        help="directory of per-group <name>.pdb references")
    parser.add_argument("--ref_fasta", type=Path,
                        help="true sequences (headers matching group "
                             "names) for recovery metrics")
    parser.add_argument("-o", "--output", type=Path,
                        help="write the JSON report here "
                             "(default: <input_dir>/evaluation.json)")
    parser.add_argument("--csv", type=Path,
                        help="also write a per-group CSV table")
    args = parser.parse_args(argv)

    ref_seqs: Dict[str, str] = {}
    if args.ref_fasta is not None:
        ref_seqs = dict(read_fasta(args.ref_fasta))

    struct_groups = discover_structure_groups(args.input_dir)
    seq_groups = discover_sequence_groups(args.input_dir)
    masked = read_masked_positions(args.input_dir)
    if not struct_groups and not seq_groups:
        parser.error(
            f"no sample_protein*.pdb or sample_sequences.fasta found "
            f"under {args.input_dir}"
        )

    def ref_seq_for(name: str) -> Optional[str]:
        if name in ref_seqs:
            return ref_seqs[name]
        if name == "sample" and len(ref_seqs) == 1:
            return next(iter(ref_seqs.values()))
        return None

    ref_protein = (
        protein_from_pdb_file(args.ref_path)
        if args.ref_path is not None else None
    )
    lig_groups = discover_ligand_groups(args.input_dir)
    groups: Dict[str, dict] = {}
    for name, models in struct_groups.items():
        ref = resolve_reference(name, ref_protein, args.ref_dir)
        groups[name] = score_group(
            models, ref, ref_seq_for(name), masked.get(name, ()),
            ligands=lig_groups.get(name),
        )
    for name, designs in seq_groups.items():
        if name in groups:  # structure run already covers this input
            continue
        groups[name] = score_sequence_group(
            designs, ref_seq_for(name), masked.get(name, ())
        )

    report = {"groups": groups, "aggregate": aggregate(groups)}
    out_path = args.output or (args.input_dir / "evaluation.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2)
    if args.csv is not None:
        write_csv(args.csv, groups)

    agg = report["aggregate"]
    print(f"evaluated {agg['num_groups']} group(s) -> {out_path}")
    for metric in (
        "tm_mean", "ca_rmsd_mean", "lddt_mean", "recovery", "recovery_masked",
        "diversity", "lig_contacts_mean", "lig_clashes_mean",
        "lig_min_dist_mean",
    ):
        if metric in agg:
            print(f"  {metric}: {agg[metric]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
