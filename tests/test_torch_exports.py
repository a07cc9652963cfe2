"""The port's import surface matches the JAX package's: every name that a
JAX ``__init__.py`` exports (its ``from .x import ...`` names, and the
top-level ``_EXPORTS`` table that it resolves lazily) resolves in the port's
package of the same relative name, and every public member of JAX's
``ProteinReDiffModel`` has a member of the same name on the port's, save
the names listed in NOT_PORTED with their reasons. ``import
protein_redesign_tpu_torch`` stays light: it imports no torch, as the JAX
package's imports no jax.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
JAX_PACKAGE = REPO / "protein_redesign_tpu"

NOT_PORTED = {
    "parallel.batch_sharding": "returns a jax.sharding object; the port places rows through "
                               "parallel.mesh (shard_batch, RowShard, ReplicatedNet)",
    "parallel.param_sharding": "returns a jax.sharding object; the port shards parameters "
                               "through parallel.fsdp",
    "parallel.replicated": "returns a jax.sharding object; a replicated tensor is a plain tensor "
                           "on each rank",
    "ProteinReDiffModel.sample_segment": "serves --sample_segments, a workaround for tunneled "
                                         "TPU workers that the port does not take",
    "ProteinReDiffModel.sample_ddim_segment": "the same, for DDIM",
}


def _exports(init: Path):
    """Names a JAX ``__init__.py`` exports: module-level ``from . import``
    names and the keys of an ``_EXPORTS`` dict."""
    names = []
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            names += [alias.asname or alias.name for alias in node.names]
        elif (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
              and any(isinstance(t, ast.Name) and t.id == "_EXPORTS" for t in node.targets)):
            names += [k.value for k in node.value.keys]
    return names


INITS = sorted(JAX_PACKAGE.rglob("__init__.py"))
EXPORTED = [(str(init.parent.relative_to(JAX_PACKAGE)), name)
            for init in INITS for name in _exports(init)]


def test_every_jax_init_is_parsed():
    subpackages = {sub for sub, _ in EXPORTED}
    assert {".", "chem", "data", "models", "ops", "parallel"} <= subpackages
    assert len(EXPORTED) > 60


@pytest.mark.parametrize("subpackage,name", EXPORTED)
def test_exported_name_resolves_in_the_port(subpackage, name):
    where = name if subpackage == "." else f"{subpackage}.{name}"
    module = "protein_redesign_tpu_torch" + ("" if subpackage == "." else f".{subpackage}")
    if where in NOT_PORTED:
        assert not hasattr(importlib.import_module(module), name), f"{where} is ported now"
        return
    assert getattr(importlib.import_module(module), name) is not None


def test_facade_members_match_jax():
    from protein_redesign_tpu.models.prdiff import ProteinReDiffModel as JaxModel
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffModel

    port = ProteinReDiffModel(ModelConfig(single_dim=8, pair_dim=4, head_dim=4, num_heads=1,
                                          num_blocks=1, esm_dim=4, time_dim=4, dist_dim=4),
                              device="cpu")
    public = [n for n in dir(JaxModel) if not n.startswith("_")]
    assert "sample_ddim" in public and "inference_extra_mask" in public
    for name in public:
        if f"ProteinReDiffModel.{name}" in NOT_PORTED:
            assert not hasattr(port, name)
        else:
            assert hasattr(port, name), name


def test_top_level_import_leaves_torch_out():
    code = ("import sys, protein_redesign_tpu_torch as p; "
            "assert p.__all__ and 'ProteinReDiffModel' in p.__all__; "
            "print(sorted(m for m in ('torch', 'jax', 'protein_redesign_tpu') "
            "if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"
