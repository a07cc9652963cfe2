"""PyTorch/CUDA port of ProteinReDiff-TPU for NVIDIA Hopper.

The JAX package ``protein_redesign_tpu`` stays the reference; this package
mirrors its module names (``ops/``, ``models/``, ``utils/``, ``cli/``) and adds
``kernels/``, the hand-written CUDA kernels and their nvcc/ctypes loader.
The framework-free modules it needs (config, chem, featurization,
collation, dataset, pipeline, weight conversion, ESM, TM-align, the metrics
logger, FLOP accounting) are its own copies under the same relative names,
each saying at its top which file it came from: this package imports torch,
never jax and nothing of ``protein_redesign_tpu``.
"""

__version__ = "0.1.0"

# The JAX package's top-level API under the same names, lazily (PEP 562):
# `import protein_redesign_tpu_torch` imports no torch, so host-side users
# (the chem tooling) pay nothing for it.
_EXPORTS = {
    "ModelConfig": ("protein_redesign_tpu_torch.config", "ModelConfig"),
    "DataConfig": ("protein_redesign_tpu_torch.config", "DataConfig"),
    "TrainConfig": ("protein_redesign_tpu_torch.config", "TrainConfig"),
    "ProteinReDiffModel": ("protein_redesign_tpu_torch.models.prdiff", "ProteinReDiffModel"),
    "ProteinReDiffNet": ("protein_redesign_tpu_torch.models.prdiff", "ProteinReDiffNet"),
    "DiffusionSchedule": ("protein_redesign_tpu_torch.models.diffusion", "DiffusionSchedule"),
    "Protein": ("protein_redesign_tpu_torch.chem.protein", "Protein"),
    "Molecule": ("protein_redesign_tpu_torch.chem.mol", "Molecule"),
    "ESMEmbedder": ("protein_redesign_tpu_torch.utils.esm", "ESMEmbedder"),
    "SamplingRunner": ("protein_redesign_tpu_torch.cli.common", "SamplingRunner"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(module), attr)
