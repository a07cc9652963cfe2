"""The port stands alone: no module of ``protein_redesign_tpu_torch`` and not
``chip_smoke.py`` imports the JAX package ``protein_redesign_tpu`` (or jax,
or flax), and the port's copies of the JAX package's framework-free modules
agree with their originals:

- the verbatim copies are the original text under a one-line header,
  save that they cite the reference repository by its own paths
  (``ProteinReDiff/mol.py``) where the originals give a checkout's
  absolute path;
- ``utils/flops.py`` keeps the original's analytic count and MFU (MFU's
  default peak aside) and replaces only ``compiled_flops``, XLA's count;
- ModelConfig, DataConfig and TrainConfig have the same fields and defaults;
- ``ligand_to_data``, ``protein_to_data`` and ``collate_fn`` give the same
  arrays on two complexes;
- a mol pickle written by the JAX package loads into the port's classes;
- a reference Lightning checkpoint loads to the same weights through the
  port's copy of the converter as through the JAX package's.

The subprocess checks that a run imports none of them are in
``test_torch_generate.py`` and ``test_torch_train_cli.py``.
"""

import ast
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import protein_redesign_tpu.config as jax_config  # noqa: E402
import protein_redesign_tpu_torch.config as port_config  # noqa: E402
from protein_redesign_tpu.chem.mol import mol_from_smiles as jax_mol_from_smiles  # noqa: E402
from protein_redesign_tpu.chem.mol import update_mol_positions as jax_update  # noqa: E402
from protein_redesign_tpu.chem.protein import protein_from_sequence as jax_protein  # noqa: E402
from protein_redesign_tpu.data.collate import collate_fn as jax_collate  # noqa: E402
from protein_redesign_tpu.data.collate import numeric_batch as jax_numeric  # noqa: E402
from protein_redesign_tpu.data.dataset import save_complex_cache as jax_save  # noqa: E402
from protein_redesign_tpu.data.featurize import ligand_to_data as jax_ligand  # noqa: E402
from protein_redesign_tpu.data.featurize import protein_to_data as jax_protein_data  # noqa: E402
from protein_redesign_tpu.utils.convert import load_reference_checkpoint  # noqa: E402
from protein_redesign_tpu_torch.chem.mol import mol_from_smiles, update_mol_positions  # noqa: E402
from protein_redesign_tpu_torch.chem.protein import protein_from_sequence  # noqa: E402
from protein_redesign_tpu_torch.data.collate import collate_fn, numeric_batch  # noqa: E402
from protein_redesign_tpu_torch.data.dataset import load_complex_cache  # noqa: E402
from protein_redesign_tpu_torch.data.featurize import ligand_to_data, protein_to_data  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "protein_redesign_tpu_torch"
FILES = sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"]
FORBIDDEN = ("protein_redesign_tpu", "jax", "flax")
VERBATIM = [
    "config.py", "chem/__init__.py", "chem/elements.py", "chem/mol.py", "chem/protein.py",
    "chem/smiles.py", "chem/features.py", "data/__init__.py", "data/featurize.py",
    "data/collate.py", "data/pipeline.py", "utils/tmalign.py", "utils/convert.py",
    "utils/metrics.py", "cli/evaluate.py",
]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("relpath", FILES)
def test_imports_nothing_of_the_jax_package(relpath):
    bad = [m for m in _imported_modules(REPO / relpath)
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert not bad, f"{relpath} imports {bad}"


def test_the_multi_device_modules_are_checked():
    """``parallel/mesh.py`` and the entry point of the ranks that
    ``--num_devices`` spawns (``cli.train._spawned_rank``, which a spawned
    child imports by module) are among the files checked above; the train
    CLI's tests check the ranks' ``sys.modules`` at run time."""
    from protein_redesign_tpu_torch.cli import train

    assert "protein_redesign_tpu_torch/parallel/mesh.py" in FILES
    entry = Path(train._spawned_rank.__code__.co_filename).resolve().relative_to(REPO)
    assert str(entry) in FILES and train._spawned_rank.__module__ == train.__name__


@pytest.mark.parametrize("relpath", VERBATIM)
def test_verbatim_copies_match_their_originals(relpath):
    header, body = (PORT / relpath).read_text().split("\n", 1)
    assert header.startswith(f"# Copied from protein_redesign_tpu/{relpath}")
    original = (REPO / "protein_redesign_tpu" / relpath).read_text()
    assert body == re.sub(r"/[\w/]*/ProteinReDiff/", "ProteinReDiff/", original)


def _top_level(path: Path) -> dict:
    """A module's top-level functions and assignments by name, as AST dumps."""
    nodes = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef):
            nodes[node.name] = node
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            nodes[node.targets[0].id] = node
    return nodes


def test_flops_copy_changes_only_compiled_flops():
    relpath = "utils/flops.py"
    assert (PORT / relpath).read_text().startswith(f"# Copied from protein_redesign_tpu/{relpath}")
    ours, theirs = _top_level(PORT / relpath), _top_level(REPO / "protein_redesign_tpu" / relpath)
    assert "compiled_flops" not in ours and "counted_flops" in ours
    for name in ("denoiser_forward_flops", "PEAK_FLOPS_V5E"):
        assert ast.dump(ours[name]) == ast.dump(theirs[name]), name
    mfu, original = ours["mfu"], theirs["mfu"]
    assert ast.unparse(mfu.args.defaults[0]) == "PEAK_FLOPS['bfloat16']"
    mfu.args.defaults, original.args.defaults = [], []
    assert ast.dump(mfu) == ast.dump(original)


@pytest.mark.parametrize("name", ["ModelConfig", "DataConfig", "TrainConfig"])
def test_config_fields_and_defaults_match(name):
    ours, theirs = getattr(port_config, name), getattr(jax_config, name)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


def _complexes(mol_from, update, protein_from, ligand_data, protein_data):
    rng = np.random.RandomState(0)
    datas = []
    for sequence, smiles in (("GMASKLLEVAKRLG", "CC(=O)Oc1ccccc1C(=O)O"),
                             ("MNIFEMLRIDEGXLRLKIY", "c1ccncc1CN")):
        mol = mol_from(smiles)
        mol = update(mol, rng.randn(mol.num_atoms(), 3).astype(np.float32))
        esm = rng.randn(len(sequence), 8).astype(np.float32)
        datas.append({**ligand_data(mol), **protein_data(protein_from(sequence), residue_esm=esm)})
    return datas


def test_featurize_and_collate_match():
    ours = _complexes(mol_from_smiles, update_mol_positions, protein_from_sequence,
                      ligand_to_data, protein_to_data)
    theirs = _complexes(jax_mol_from_smiles, jax_update, jax_protein, jax_ligand,
                        jax_protein_data)
    for a, b in zip(ours, theirs):
        arrays = sorted(k for k, v in b.items() if isinstance(v, (np.ndarray, int)))
        assert arrays == sorted(k for k, v in a.items() if isinstance(v, (np.ndarray, int)))
        for k in arrays:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    batch, ref = numeric_batch(collate_fn(ours, buckets=(32, 64))), jax_numeric(
        jax_collate(theirs, buckets=(32, 64)))
    assert sorted(batch) == sorted(ref) and batch["residue_mask"].shape == (2, 32)
    for k in ref:
        np.testing.assert_array_equal(batch[k], ref[k], err_msg=k)


def test_jax_mol_pickle_loads_into_the_port_classes(tmp_path):
    mol = jax_mol_from_smiles("CC(=O)Oc1ccccc1C(=O)O")
    mol = jax_update(mol, np.arange(3 * mol.num_atoms(), dtype=np.float32).reshape(-1, 3))
    jax_save(tmp_path, "x1", {**jax_ligand(mol), "ligand_mol": mol})
    data = load_complex_cache(tmp_path, "x1", with_mols=True)
    got = data["ligand_mol"]
    assert type(got).__module__ == "protein_redesign_tpu_torch.chem.mol"
    assert type(got.atoms[0]).__module__ == "protein_redesign_tpu_torch.chem.mol"
    assert got.num_atoms() == mol.num_atoms()
    np.testing.assert_array_equal(got.positions, mol.positions)


def test_reference_checkpoint_loads_like_the_jax_converter(tmp_path):
    from test_torch_net import CFG

    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
    from protein_redesign_tpu_torch.utils.weights import load_checkpoint, state_dict_from_jax

    torch.manual_seed(0)
    sd = ProteinReDiffNet(CFG).state_dict()
    frozen = {"embed_beta.0.weight", "embed_dist.0.center"}
    shadow = [v + 0.5 for k, v in sd.items() if k not in frozen]
    hparams = {f.name: getattr(CFG, f.name) for f in dataclasses.fields(CFG)}
    path = tmp_path / "reference.ckpt"
    torch.save({"state_dict": sd, "hyper_parameters": hparams,
                "ema_state_dict": {"shadow_params": shadow}}, path)
    got, cfg = load_checkpoint(path)
    params, ema, jax_cfg = load_reference_checkpoint(str(path))
    want = state_dict_from_jax(ema, jax_cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)
