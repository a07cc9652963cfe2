# Copied from protein_redesign_tpu/utils/esm.py so the port imports nothing of the JAX
# package; its "jax" backend runs the port's own ESM-2 encoder (models/esm2.py) on
# ``device`` where the original's runs the JAX one, and both backends run on ``device``.
"""Pluggable ESM-2 embedder (host-side, never inside the TPU graph).

The reference loads esm2_t33_650M_UR50D via torch.hub at four call sites
(`preprocess_pdbbind.py:34`, `generate.py:41`, `scripts/*:42`,
`model.py:221`) and runs it on CUDA. The TPU framework's policy
(SURVEY.md §7.1): ESM embeddings are a *host-side featurizer* —
precomputed, cached next to the complex tensors, and looked up at batch
time. This module provides:

- ``esm_tokens(sequence)``: ESM-2 alphabet token ids (mask=32, pad=1 —
  the ids the reference's masking writes, `mask_utils.py:94-95`).
- ``ESMEmbedder``: computes 1280-dim residue embeddings with the
  HuggingFace ``transformers`` ESM-2 port, or the package's own encoder,
  when the HF weights are available locally, else returns zeros
  (offline-safe; generation quality degrades gracefully — the model was
  also trained with fully-masked ESM rows).
"""

from __future__ import annotations

import itertools
import os
import warnings
from typing import List, Optional

import numpy as np

from ..chem.protein import Protein, RESIDUE_TYPES

# ESM-2 alphabet (fair-esm Alphabet.from_architecture("ESM-1b"), shared by
# ESM-2): index = token id.
ESM_ALPHABET: List[str] = [
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N",
    "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
    "<null_1>", "<mask>",
]
ESM_TOKEN_INDEX = {tok: i for i, tok in enumerate(ESM_ALPHABET)}
assert ESM_TOKEN_INDEX["<mask>"] == 32 and ESM_TOKEN_INDEX["<pad>"] == 1

RESIDUE_TYPES_MASK = RESIDUE_TYPES + ["<mask>"]  # aatype -1 -> "<mask>"

DEFAULT_MODEL_NAME = "facebook/esm2_t33_650M_UR50D"
ESM_DIM = 1280


def esm_tokens(sequence: str) -> np.ndarray:
    """Per-residue ESM token ids (no cls/eos — residue-aligned)."""
    return np.array(
        [ESM_TOKEN_INDEX.get(s, ESM_TOKEN_INDEX["<unk>"]) for s in sequence],
        dtype=np.int64,
    )


class ESMEmbedder:
    """Frozen ESM-2 650M residue embedder with graceful offline fallback.

    The model runs on ``device`` (the CLIs' ``--device``). ``esm_dim``
    sizes the zero-fallback (models trained with a different esm_dim — e.g.
    tiny test configs — still get matching features)."""

    def __init__(self, model_name: str = DEFAULT_MODEL_NAME,
                 device: str = "cpu", esm_dim: int = ESM_DIM,
                 require: bool = False, backend: str = "torch"):
        """``require=True`` turns the silent zero-fallback into a hard
        error — for production serving where unconditioned designs
        masquerading as conditioned ones are unacceptable.

        ``backend``: "torch" runs the HF transformers port; "jax" (the JAX
        CLIs' name) runs the package's own ESM-2 encoder
        (`models/esm2.py`) on the same HF weights."""
        self.model_name = model_name
        self.device = device
        self.esm_dim = esm_dim
        self.require = require
        self.backend = backend
        self._model = None
        self._tokenizer = None
        self._encoder = None
        self._available: Optional[bool] = None

    @property
    def available(self) -> bool:
        if self._available is None:
            self._available = self._try_load()
        return self._available

    def _try_load(self) -> bool:
        if os.environ.get("PRD_DISABLE_ESM"):
            if self.require:
                raise RuntimeError(
                    "--require_esm set but PRD_DISABLE_ESM is in the "
                    "environment; unset one of them."
                )
            return False
        try:
            if self.backend == "jax":
                from ..models.esm2 import load_esm2

                self._encoder = load_esm2(self.model_name, device=self.device)
                if self._encoder is None:
                    raise FileNotFoundError(
                        f"no local HF weights for {self.model_name}"
                    )
                return True
            import torch  # noqa: F401
            from transformers import AutoTokenizer, EsmModel

            try:
                self._tokenizer = AutoTokenizer.from_pretrained(
                    self.model_name, local_files_only=True
                )
                self._model = EsmModel.from_pretrained(
                    self.model_name, local_files_only=True
                ).eval().to(self.device)
            except Exception as e:
                # Any HF load failure (missing repo, malformed local path
                # -> HFValidationError, offline hub) = weights unavailable.
                raise OSError(
                    f"cannot load HF ESM weights '{self.model_name}': {e}"
                ) from e
            return True
        except (OSError, ImportError) as e:  # offline / missing weights only
            # Anything else (e.g. the unsupported-architecture ValueError
            # from load_esm2, a missing encoder key) PROPAGATES: weights
            # were present but wrong, which must not silently degrade to
            # the zero-embedding fallback.
            if self.require:
                raise RuntimeError(
                    f"--require_esm set but ESM-2 weights are unavailable "
                    f"({type(e).__name__}: {e}). Precompute embeddings on a "
                    "connected host or drop --require_esm."
                ) from e
            warnings.warn(
                f"ESM-2 weights unavailable ({type(e).__name__}); residue_esm "
                "features fall back to zeros. Precompute embeddings on a "
                "connected host and populate the complex cache for full "
                "fidelity."
            )
            return False

    def embed_chain(self, sequence: str) -> np.ndarray:
        """[len(sequence), 1280] final-layer representations."""
        if not self.available:
            return np.zeros((len(sequence), self.esm_dim), dtype=np.float32)
        if self.backend == "jax":
            return self.embed_chain_masked(sequence)
        import torch

        inputs = self._tokenizer(sequence, return_tensors="pt").to(self.device)
        with torch.inference_mode():
            out = self._model(**inputs)
        reps = out.last_hidden_state[0, 1: len(sequence) + 1]
        return reps.float().cpu().numpy()

    def embed_protein(self, protein: Protein) -> np.ndarray:
        """Per-chain embedding, concatenated in residue order — matches the
        reference's ``compute_residue_esm`` (`generate.py:40-62`), including
        '<mask>' for aatype -1 (X)."""
        chunks = []
        for chain, _ in itertools.groupby(protein.chain_index):
            seq = "".join(
                RESIDUE_TYPES_MASK[aa]
                for aa in protein.aatype[protein.chain_index == chain]
            )
            chunks.append(self.embed_chain_masked(seq))
        residue_esm = np.concatenate(chunks, axis=0)
        assert residue_esm.shape[0] == len(protein.aatype)
        return residue_esm

    def embed_chain_masked(self, sequence_with_mask: str) -> np.ndarray:
        """Like embed_chain but the sequence may contain '<mask>' entries
        (already expanded in RESIDUE_TYPES_MASK join: each aa is one char
        except the literal '<mask>' token)."""
        if not self.available:
            n = _masked_len(sequence_with_mask)
            return np.zeros((n, self.esm_dim), dtype=np.float32)
        # Tokenize manually so '<mask>' stays one token.
        toks = _split_masked(sequence_with_mask)
        ids = [ESM_TOKEN_INDEX["<cls>"]] + [
            ESM_TOKEN_INDEX.get(t, ESM_TOKEN_INDEX["<unk>"]) for t in toks
        ] + [ESM_TOKEN_INDEX["<eos>"]]
        if self.backend == "jax":
            return self._encoder(np.asarray(ids))[1: len(toks) + 1]
        import torch

        inputs = torch.tensor([ids], device=self.device)
        with torch.inference_mode():
            out = self._model(input_ids=inputs)
        reps = out.last_hidden_state[0, 1: len(toks) + 1]
        return reps.float().cpu().numpy()


def _split_masked(seq: str) -> List[str]:
    toks: List[str] = []
    i = 0
    while i < len(seq):
        if seq.startswith("<mask>", i):
            toks.append("<mask>")
            i += 6
        else:
            toks.append(seq[i])
            i += 1
    return toks


def _masked_len(seq: str) -> int:
    return len(_split_masked(seq))
