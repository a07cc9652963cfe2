# Copied from protein_redesign_tpu/utils/metrics.py so the port imports nothing of the JAX package.
"""Evaluation metrics for redesign quality.

The reference paper evaluates sequence diversity, structural preservation,
and ligand binding affinity but ships no metric code (SURVEY.md §6).
This module provides the first two families (binding affinity requires an
external docking tool and stays out of scope):

- sequence recovery / identity between designs and the input
- pairwise sequence diversity across samples
- CA RMSD after Kabsch superposition (numpy) and TM-score via the
  in-repo aligner (utils/tmalign.py)
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..chem.protein import Protein


def sequence_identity(a: str, b: str) -> float:
    """Fraction identical over aligned (equal-length) positions."""
    n = min(len(a), len(b))
    if n == 0:
        return 0.0
    return sum(1 for x, y in zip(a[:n], b[:n]) if x == y) / n


def sequence_recovery(
    designs: Sequence[str], reference: str, masked_only: Sequence[int] = ()
) -> float:
    """Mean identity vs the reference sequence; optionally restricted to
    the masked positions (the redesign targets)."""
    scores = []
    for d in designs:
        if masked_only:
            n = min(len(d), len(reference))
            pos = [i for i in masked_only if i < n]
            if not pos:
                continue
            scores.append(
                sum(1 for i in pos if d[i] == reference[i]) / len(pos)
            )
        else:
            scores.append(sequence_identity(d, reference))
    return float(np.mean(scores)) if scores else 0.0


def sequence_diversity(designs: Sequence[str]) -> float:
    """Mean pairwise (1 - identity) across the design set."""
    if len(designs) < 2:
        return 0.0
    vals = []
    for i in range(len(designs)):
        for j in range(i + 1, len(designs)):
            vals.append(1.0 - sequence_identity(designs[i], designs[j]))
    return float(np.mean(vals))


def kabsch_rmsd(x: np.ndarray, y: np.ndarray) -> float:
    """CA RMSD after optimal rigid superposition (proper rotation)."""
    assert x.shape == y.shape and x.shape[-1] == 3
    xc = x - x.mean(axis=0)
    yc = y - y.mean(axis=0)
    C = xc.T @ yc
    U, S, Vt = np.linalg.svd(C)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    aligned = xc @ R.T
    return float(np.sqrt(np.mean(np.sum((aligned - yc) ** 2, axis=-1))))


def ca_rmsd(prb: Protein, ref: Protein) -> float:
    """RMSD over the common CA prefix."""
    n = min(len(prb), len(ref))
    x = prb.atom_pos[:n, 1]
    y = ref.atom_pos[:n, 1]
    return kabsch_rmsd(x, y)


def tm_scores(
    samples: Sequence[Protein], ref: Protein
) -> List[float]:
    """Mirror-aware TM-scores of each sample vs the reference."""
    from .tmalign import best_tmalign

    return [best_tmalign(p, ref)[0] for p in samples]


def ligand_interface_stats(
    protein_ca: np.ndarray,
    ligand_pos: np.ndarray,
    contact_cutoff: float = 6.0,
    clash_cutoff: float = 2.0,
) -> dict:
    """Protein-ligand interface sanity stats over a generated pose.

    The reference paper's third evaluation axis is ligand binding
    affinity (`README.md:201`), which needs an external docking tool;
    this is the dependency-free surrogate: how the generated CA trace
    packs against the generated ligand pose. CA-only geometry (sampled
    structures carry no side chains), hence the lenient cutoffs:

    - ``contacts``: number of residues with CA within ``contact_cutoff``
      of any ligand heavy atom (binding-site size)
    - ``clashes``: CA-atom pairs closer than ``clash_cutoff`` (physical
      impossibility count)
    - ``min_dist``: closest CA-ligand approach in Angstroms
    """
    assert protein_ca.shape[-1] == 3 and ligand_pos.shape[-1] == 3
    if len(protein_ca) == 0 or len(ligand_pos) == 0:
        return {"contacts": 0, "clashes": 0, "min_dist": float("inf")}
    d = np.linalg.norm(
        protein_ca[:, None] - ligand_pos[None, :], axis=-1
    )
    return {
        "contacts": int((d.min(axis=1) < contact_cutoff).sum()),
        "clashes": int((d < clash_cutoff).sum()),
        "min_dist": float(d.min()),
    }


def ca_lddt(
    prb_ca: np.ndarray,
    ref_ca: np.ndarray,
    inclusion_radius: float = 15.0,
    thresholds: Sequence[float] = (0.5, 1.0, 2.0, 4.0),
    min_seq_sep: int = 2,
    residue_numbers: np.ndarray = None,
    chain_indices: np.ndarray = None,
) -> float:
    """CA-lDDT: superposition-free local-distance difference test
    (Mariani et al. 2013) over paired CA coordinates.

    For every residue pair within ``inclusion_radius`` in the REFERENCE
    and sequence separation >= ``min_seq_sep``, scores the fraction of
    distances preserved within each threshold; returns the mean over
    the four standard thresholds. Complements the global TM-score /
    Kabsch RMSD in `tm_scores`/`kabsch_rmsd`: insensitive to domain
    motion, sensitive to local geometry.

    ``residue_numbers``/``chain_indices`` (optional, same length) give
    the true sequence separation when the pairing has gaps (evaluation
    vs an experimental PDB with unresolved loops); inter-chain pairs
    are always included, as in the lDDT definition. Default: positional
    indices, one chain.
    """
    assert prb_ca.shape == ref_ca.shape and prb_ca.shape[-1] == 3
    n = len(ref_ca)
    if n < min_seq_sep + 1:
        return 0.0
    if residue_numbers is None:
        residue_numbers = np.arange(n)
    d_ref = np.linalg.norm(ref_ca[:, None] - ref_ca[None, :], axis=-1)
    d_prb = np.linalg.norm(prb_ca[:, None] - prb_ca[None, :], axis=-1)
    sep = np.abs(
        residue_numbers[:, None] - residue_numbers[None, :]
    ).astype(np.int64)
    if chain_indices is not None:
        sep = np.where(
            chain_indices[:, None] != chain_indices[None, :],
            min_seq_sep, sep,
        )
    pairs = (d_ref < inclusion_radius) & (sep >= min_seq_sep)
    if not pairs.any():
        return 0.0
    diff = np.abs(d_prb - d_ref)[pairs]
    return float(
        np.mean([(diff < t).mean() for t in thresholds])
    )
