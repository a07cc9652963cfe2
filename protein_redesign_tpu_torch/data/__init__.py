# Copied from protein_redesign_tpu/data/__init__.py so the port imports nothing of the JAX package.
"""L1: featurization, static-shape collation, datasets, host pipeline."""

from .featurize import ligand_to_data, protein_to_data
from .collate import collate_fn, pick_bucket
from .dataset import (
    InferenceDataset,
    PDBDataset,
    RepeatDataset,
    load_split_ids,
    save_complex_cache,
    load_complex_cache,
)
