"""Shared inference plumbing for the port's generation CLI.

``update_pos``, ``update_seq``, ``parse_ligand_arg``, ``load_protein_arg``
and ``softmax_np`` are copied from ``protein_redesign_tpu/cli/common.py``
(:54-57, :59-73, :83-121, :124-130, :199-204), whose module imports jax.
``add_esm_args`` and ``add_sampler_args`` (:207-323) are copied with the same
flags; ``check_supported_args`` rejects the values outside the ported
slice. ``SamplingRunner`` is a plain runner: complexes are grouped by padding
bucket, collated, and sampled batch by batch with the DDPM sampler.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from argparse import BooleanOptionalAction
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from protein_redesign_tpu.chem.mol import Molecule, mol_from_file, mol_from_smiles, update_mol_positions
from protein_redesign_tpu.chem.protein import (
    RESIDUE_TYPES,
    Protein,
    protein_from_pdb_file,
    protein_from_sequence,
)
from protein_redesign_tpu.config import DataConfig
from protein_redesign_tpu.data.collate import collate_fn, numeric_batch, pick_bucket
from protein_redesign_tpu.data.featurize import ligand_to_data, protein_to_data

from ..models.prdiff import ProteinReDiffNet, sample

RESIDUE_TYPES_NEW = ["X"] + RESIDUE_TYPES


def softmax_np(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def update_pos(
    protein: Protein, ligand: Molecule, pos: np.ndarray
) -> Tuple[Protein, Molecule]:
    """Write sampled complex coordinates back: ligand atoms occupy the
    complex-axis prefix, the CA-only protein follows."""
    n_lig = ligand.num_atoms()
    atom_pos = np.zeros_like(protein.atom_pos)
    atom_pos[:, 1] = pos[n_lig: n_lig + len(protein.aatype)]
    atom_mask = np.zeros_like(protein.atom_mask)
    atom_mask[:, 1] = 1.0
    protein = dataclasses.replace(protein, atom_pos=atom_pos, atom_mask=atom_mask)
    ligand = update_mol_positions(ligand, pos[:n_lig])
    return protein, ligand


def update_seq(protein: Protein, proba: np.ndarray) -> Protein:
    """Replace the protein's sequence by the argmax decode; stripped terminal
    X also trims the coordinates, interior X keeps the input residue."""
    tokens = np.argmax(softmax_np(np.asarray(proba)), axis=-1)
    seq = "".join(RESIDUE_TYPES_NEW[i] for i in tokens)
    n_res = len(protein.aatype)
    res_seq = seq[len(seq) - n_res:] if n_res else ""
    stripped = res_seq.lstrip("X")
    res_lo = n_res - len(stripped)
    stripped = stripped.rstrip("X")
    res_hi = res_lo + len(stripped)
    if len(stripped) == 0:
        res_lo, res_hi = 0, n_res
        stripped = res_seq or "X" * n_res
    aatype = np.array(
        [
            RESIDUE_TYPES.index(s) if s in RESIDUE_TYPES
            else max(int(protein.aatype[res_lo + i]), 0)
            for i, s in enumerate(stripped)
        ],
        dtype=np.int64,
    )
    return dataclasses.replace(
        protein,
        chain_index=protein.chain_index[res_lo:res_hi],
        residue_index=protein.residue_index[res_lo:res_hi],
        aatype=aatype,
        atom_pos=protein.atom_pos[res_lo:res_hi],
        atom_mask=protein.atom_mask[res_lo:res_hi],
    )


def parse_ligand_arg(ligand: str) -> Molecule:
    """.sdf/.mol2 path, SMILES string, or '*' dummy."""
    if ligand.endswith(".sdf") or ligand.endswith(".mol2"):
        return mol_from_file(ligand)
    mol = mol_from_smiles(ligand)
    return update_mol_positions(mol, np.zeros((mol.num_atoms(), 3)))


def load_protein_arg(protein: str) -> Protein:
    """PDB path or sequence string with X masks."""
    if protein.endswith(".pdb"):
        return protein_from_pdb_file(protein)
    return protein_from_sequence(protein)


def complex_data(protein: Protein, ligand: Molecule, residue_esm: np.ndarray) -> Dict:
    """One featurized complex: ligand atoms first, then the residues."""
    return {**ligand_to_data(ligand), **protein_to_data(protein, residue_esm=residue_esm)}


def add_esm_args(parser) -> None:
    parser.add_argument("--esm_model", default="facebook/esm2_t33_650M_UR50D",
                        help="HF model id or local path of the ESM-2 checkpoint")
    parser.add_argument("--esm_backend", choices=["torch", "jax"], default="torch",
                        help="the port runs ESM-2 with HF torch only")
    parser.add_argument("--require_esm", action="store_true",
                        help="error out instead of using zero ESM embeddings "
                             "when weights are unavailable")


# The JAX CLI's flags for what the port does not take over yet: the ddim
# samplers, segmented sampling, the TPU plan's kernel switches and the data
# loader's workers. They parse, so a JAX command line reads the same, and
# check_supported_args raises on any value given.
_UNPORTED_FLAGS = {
    "ddim_steps": (int, "the ddim samplers are not ported"),
    "eta": (float, "the ddim samplers are not ported"),
    "window": (int, "ddim_parallel is not ported"),
    "ptol": (float, "ddim_parallel is not ported"),
    "coarse_init": (int, "ddim_parallel is not ported"),
    "sample_segments": (int, "segmented sampling is not ported"),
    "pallas_auto_min_n": (int, "the port's attention plan has no size gates"),
    "num_workers": (int, "the port collates in the sampling process"),
}
_UNPORTED_SWITCHES = {
    "use_pallas": "the port's attention always takes its CUDA kernels on a GPU",
    "use_pallas_trimul": "the fused triangle-multiplication kernel is not ported yet",
    "use_pallas_transition": "the fused transition kernel is not ported yet",
    "use_pallas_outer": "the fused OuterLinear kernel is not ported yet",
    "use_pallas_fused_gated": "the fused gated-attention kernel is not ported yet",
    "use_pallas_bwd": "training is not ported yet",
    "trimul_dmajor": "the channel-major triangle-multiplication layout is not ported",
}


def add_sampler_args(parser) -> None:
    """The JAX CLI's sampler flags; values outside the ported slice are
    rejected by ``check_supported_args``."""
    parser.add_argument("--sampler", type=str, default="ddpm",
                        choices=("ddpm", "ddim", "ddim_parallel"))
    parser.add_argument("--seq_reverse", type=str, default="reference",
                        choices=("reference", "ancestral"))
    parser.add_argument("--reveal_schedule", type=str, default="linear",
                        choices=("linear", "cosine"))
    parser.add_argument("--reveal_temperature", type=float, default=0.0)
    parser.add_argument("--reveal_conf_noise", type=float, default=0.0)
    parser.add_argument("--attn_chunk", type=int, default=0)
    for flag, (kind, why) in _UNPORTED_FLAGS.items():
        parser.add_argument(f"--{flag}", type=kind, default=None, help=f"not ported: {why}")
    for flag, why in _UNPORTED_SWITCHES.items():
        parser.add_argument(f"--{flag}", action="store_true", help=f"not ported: {why}")
    parser.add_argument("--sample_guard", action=BooleanOptionalAction, default=None)
    parser.add_argument("--outer_factored", action=BooleanOptionalAction, default=None)
    parser.add_argument("--pair_stream_bf16", action=BooleanOptionalAction, default=None)


def check_supported_args(args) -> None:
    """NotImplementedError for flags outside the ported slice."""
    unsupported = [
        (args.sampler != "ddpm", f"--sampler {args.sampler}: only ddpm is ported"),
        (args.esm_backend != "torch", "--esm_backend jax: the port runs no jax"),
        (getattr(args, "save_trajectory", 0) != 0, "--save_trajectory: not ported yet"),
        (getattr(args, "num_devices", 1) > 1, "--num_devices > 1: not ported yet"),
    ]
    unsupported += [(getattr(args, f, None) is not None, f"--{f}: {why}")
                    for f, (_, why) in _UNPORTED_FLAGS.items()]
    unsupported += [(getattr(args, f), f"--{f}: {why}") for f, why in _UNPORTED_SWITCHES.items()]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(what)


def sampler_cfg_overrides(args) -> Dict:
    """ModelConfig overrides from the sampler flags (`cli/common.py:326-353`);
    the config check raises on the ones outside the slice."""
    overrides = dict(
        seq_reverse=args.seq_reverse,
        reveal_schedule=args.reveal_schedule,
        reveal_temperature=args.reveal_temperature,
        reveal_conf_noise=args.reveal_conf_noise,
        attn_chunk=args.attn_chunk,
    )
    for flag in ("outer_factored", "sample_guard", "pair_stream_bf16"):
        if getattr(args, flag, None) is not None:
            overrides[flag] = bool(getattr(args, flag))
    return overrides


def apply_serving_defaults(cfg, args):
    """pair_stream_bf16 on for wide-head (head_dim >= 64) inference unless
    the flag was given (`cli/common.py:356-375`)."""
    if (
        getattr(args, "pair_stream_bf16", None) is None
        and cfg.head_dim >= 64
        and not cfg.pair_stream_bf16
    ):
        cfg = cfg.replace(pair_stream_bf16=True)
    return cfg


class SamplingRunner:
    """Groups complexes by padding bucket and samples each group with the
    DDPM sampler on ``device``, drawing from one seeded generator."""

    def __init__(self, net: ProteinReDiffNet, device: torch.device, batch_size: int = 1,
                 mask_prob: Optional[float] = None):
        self.net = net
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.mask_prob = net.cfg.mask_prob if mask_prob is None else mask_prob
        self.buckets = tuple(DataConfig().buckets)
        self.timings: List[Tuple[int, int, int, float]] = []
        self._warned_nonfinite = False

    def collate(self, group: Sequence[Dict]) -> Tuple[int, Dict[str, torch.Tensor]]:
        """(bucket, padded batch on the device) for featurized complexes."""
        bucket = pick_bucket(
            max(d["num_atoms"] + d["num_residues"] for d in group), self.buckets
        )
        batch = {}
        for k, v in numeric_batch(collate_fn(group, buckets=(bucket,))).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            batch[k] = (t.float() if t.is_floating_point() else t).to(self.device)
        return bucket, batch

    def run(self, datas: Sequence[Dict], seed: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Per input (positions [n, 3] Å, seq logits [n, 21]), trimmed to
        each complex's node count. Appends (bucket, rows, steps, seconds)
        per sampled batch to ``self.timings``."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        sizes = [d["num_atoms"] + d["num_residues"] for d in datas]
        order = sorted(range(len(datas)), key=lambda i: pick_bucket(sizes[i], self.buckets))
        results: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [None] * len(datas)
        for start in range(0, len(order), self.batch_size):
            idxs = order[start: start + self.batch_size]
            bucket, batch = self.collate([datas[i] for i in idxs])
            began = time.perf_counter()
            pos, logits = sample(self.net, batch, self.mask_prob, generator)
            pos, logits = pos.cpu().numpy(), logits.cpu().numpy()  # waits for the device
            self.timings.append(
                (bucket, len(idxs), self.net.cfg.num_steps, time.perf_counter() - began)
            )
            if not self._warned_nonfinite and not (
                np.isfinite(pos).all() and np.isfinite(logits).all()
            ):
                self._warned_nonfinite = True
                warnings.warn("sampler returned non-finite positions/logits", RuntimeWarning)
            for row, i in enumerate(idxs):
                results[i] = (pos[row, : sizes[i]], logits[row, : sizes[i]])
        return results  # type: ignore[return-value]
