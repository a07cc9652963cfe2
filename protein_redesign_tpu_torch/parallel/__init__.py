"""Devices, meshes and training steps of the port: data parallelism over
ranks or replicas (``mesh``), FSDP on the model axis (``fsdp``), and the
train and eval steps (``train_step``).

The JAX package's ``batch_sharding``, ``param_sharding`` and ``replicated``
are not ported: they return ``jax.sharding`` objects, and the port places
rows and shards through ``parallel.mesh`` (``shard_batch``, ``RowShard``,
``ReplicatedNet``) and ``parallel.fsdp``.

The exports are lazy (PEP 562): ``models.denoiser`` imports ``mesh``, and
``train_step`` imports the models.
"""

_EXPORTS = {
    "make_mesh": "mesh",
    "TrainState": "train_step",
    "make_train_state": "train_step",
    "make_train_step": "train_step",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
