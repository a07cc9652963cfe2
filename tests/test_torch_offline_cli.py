"""The port's offline CLIs on the CPU, mirroring the JAX package's tests:

- ``export_params`` (``tests/test_train_cli.py:87``): a tiny train run's
  best step exported with its EMA weights (or ``--raw_weights``, or a given
  ``--step``), loaded as the sampling CLIs load it, with a per-load
  override;
- ``convert_checkpoint`` (``tests/test_convert_cli.py:39-55``): a synthetic
  reference Lightning checkpoint converted to the same weights as the JAX
  converter gives (EMA, and with ``--no-use_ema`` the trained ones), then
  sampled by the generate CLI from the export;
- ``evaluate`` (``tests/test_evaluate.py``): the port's copy writes the
  same JSON report as the JAX CLI on the same output directories (single
  complex with a reference, the batch layout with masked recovery, the
  sequence-only layout);
- ``preprocess_pdbbind`` (``tests/test_preprocess_cli.py``) with
  ``--device cpu``: the same complex cache as the JAX CLI's, a second run
  skipping what exists, and with ``--esm_backend jax`` on a tiny HF ESM-2
  directory the same embeddings as the JAX CLI's with its JAX encoder;
- ``ops/graph.py`` against the JAX helpers;
- a fresh process running all four CLIs imports none of jax, flax and the
  JAX package (checked in a subprocess, because this suite's conftest
  imports jax).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_convert_cli import make_lightning_ckpt  # noqa: E402
from test_evaluate import mutate, seq_helix  # noqa: E402
from test_preprocess_cli import pdbbind_layout  # noqa: E402,F401
from test_torch_esm2 import write_tiny_esm  # noqa: E402
from test_torch_generate import TINY  # noqa: E402
from test_torch_train_cli import GENERATE, TINY_FLAGS  # noqa: E402
from test_train_cli import mini_data  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]


def _train(data_dir, save_dir):
    from protein_redesign_tpu_torch.cli.train import main

    main(["--save_dir", str(save_dir), "--data_dir", str(data_dir), *TINY_FLAGS,
          "--max_steps", "3", "--val_every_steps", "2"])
    return save_dir / "checkpoints"


def _assert_same_weights(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)


def test_export_params_cli(mini_data, tmp_path, capsys):  # noqa: F811
    from protein_redesign_tpu_torch.cli.export_params import main as export
    from protein_redesign_tpu_torch.utils.checkpoint import step_dir
    from protein_redesign_tpu_torch.utils.weights import load_checkpoint

    ckpts = _train(mini_data, tmp_path / "run")
    best = step_dir(ckpts, prefer="best")
    out = tmp_path / "export"
    export([str(ckpts), str(out)])
    assert f"exported step {best.name} (EMA weights) -> {out}" in capsys.readouterr().out
    sd, cfg = load_checkpoint(out, num_steps=7)
    assert cfg.num_steps == 7 and cfg.single_dim == 16  # per-load override on the export
    _assert_same_weights(sd, torch.load(best / "ema.pt", weights_only=True))
    # the checkpoint directory and its export load to the same weights
    _assert_same_weights(sd, load_checkpoint(ckpts)[0])
    export([str(ckpts), str(tmp_path / "raw"), "--step", "3", "--raw_weights"])
    assert "exported step 3 (raw weights)" in capsys.readouterr().out
    _assert_same_weights(load_checkpoint(tmp_path / "raw")[0],
                         torch.load(ckpts / "3" / "params.pt", weights_only=True))
    with pytest.raises(FileNotFoundError):
        export([str(ckpts), str(tmp_path / "none"), "--step", "99"])


@pytest.mark.parametrize("use_ema", [True, False])
def test_convert_cli_matches_jax_converter_and_generates(tmp_path, capsys, use_ema):
    from protein_redesign_tpu.utils.convert import load_reference_checkpoint
    from protein_redesign_tpu_torch.cli.convert_checkpoint import main as convert
    from protein_redesign_tpu_torch.cli.generate import main as generate
    from protein_redesign_tpu_torch.utils.weights import load_checkpoint, state_dict_from_jax

    ckpt = tmp_path / "ref.ckpt"
    make_lightning_ckpt(ckpt)
    out = tmp_path / "export"
    convert([str(ckpt), str(out)] + ([] if use_ema else ["--no-use_ema"]))
    which = "EMA" if use_ema else "raw"
    assert f"({which} weights) -> {out}" in capsys.readouterr().out
    assert (out / "config.json").exists()
    params, ema, cfg = load_reference_checkpoint(str(ckpt))
    got, got_cfg = load_checkpoint(out)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(cfg)
    _assert_same_weights(got, state_dict_from_jax(ema if use_ema else params, cfg))

    gen_out = tmp_path / "gen"
    generate(["-c", str(out), "-o", str(gen_out), "-p", "ACDEFGHIKL", "-l", "CCO", "-n", "1",
              "--num_steps", "2", "--device", "cpu"])
    assert (gen_out / "sample_protein.pdb").exists()


def _layout_single(tmp_path):
    from protein_redesign_tpu.chem.protein import protein_to_pdb_file, proteins_to_pdb_file

    out_dir = tmp_path / "out"
    out_dir.mkdir()
    proteins_to_pdb_file([seq_helix(noise=0.3, seed=s) for s in (1, 2, 3)],
                         out_dir / "sample_protein.pdb")
    protein_to_pdb_file(seq_helix(), tmp_path / "ref.pdb")
    return out_dir, ["-r", str(tmp_path / "ref.pdb")]


def _layout_batch(tmp_path):
    from protein_redesign_tpu.chem.protein import protein_to_pdb_file, write_fasta

    out_dir, refs = tmp_path / "out", tmp_path / "refs"
    out_dir.mkdir()
    refs.mkdir()
    seqs = {"alpha": "ACDEFGHIKLMNPQRSTVWYACDEFGHIKLMNPQRSTVWY",
            "beta": "GGGGGACDEFGHIKLMNPQRSTVWYACDEFGHIKLMNPQ"}
    for name, seq in seqs.items():
        protein_to_pdb_file(seq_helix(seq), refs / f"{name}.pdb")
        for i in range(2):
            protein_to_pdb_file(seq_helix(mutate(seq, [3 + i, 7]), seed=10 + i, noise=0.4),
                                out_dir / f"sample_protein_{name}_model_{i}.pdb")
    write_fasta([(f"{n}_sample_{i}", mutate(s, [3, 7], "X")) for n, s in seqs.items()
                 for i in range(2)], out_dir / "masked_sequences.fasta")
    return out_dir, ["--ref_dir", str(refs)]


def _layout_sequences(tmp_path):
    from protein_redesign_tpu.chem.protein import write_fasta

    out_dir = tmp_path / "out"
    out_dir.mkdir()
    seq = "ACDEFGHIKLMNPQRSTVWY"
    write_fasta([("p_sample_0", seq), ("p_sample_1", mutate(seq, [0, 1, 2]))],
                out_dir / "sample_sequences.fasta")
    write_fasta([("p", seq)], tmp_path / "ref.fasta")
    return out_dir, ["--ref_fasta", str(tmp_path / "ref.fasta")]


@pytest.mark.parametrize("layout", [_layout_single, _layout_batch, _layout_sequences],
                         ids=["single", "batch", "sequences"])
def test_evaluate_report_matches_jax(tmp_path, layout):
    from protein_redesign_tpu.cli.evaluate import main as jax_evaluate
    from protein_redesign_tpu_torch.cli.evaluate import main as evaluate

    out_dir, refs = layout(tmp_path)
    evaluate(["-i", str(out_dir), *refs, "-o", str(tmp_path / "port.json"),
              "--csv", str(tmp_path / "port.csv")])
    jax_evaluate(["-i", str(out_dir), *refs, "-o", str(tmp_path / "jax.json"),
                  "--csv", str(tmp_path / "jax.csv")])
    report = json.loads((tmp_path / "port.json").read_text())
    assert report == json.loads((tmp_path / "jax.json").read_text())
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    assert report["groups"]


def test_preprocess_cli_matches_jax(pdbbind_layout, capsys):  # noqa: F811
    from protein_redesign_tpu.cli.preprocess_pdbbind import main as jax_preprocess
    from protein_redesign_tpu_torch.cli.preprocess_pdbbind import main as preprocess
    from protein_redesign_tpu_torch.data.dataset import PDBDataset, load_complex_cache

    data_dir, ids = pdbbind_layout
    common = ["--data_dir", str(data_dir), "--pdbbind_dir", str(data_dir / "PDBbind_processed"),
              "--esm_model", "/nonexistent/esm"]
    preprocess([*common, "--device", "cpu", "--limit", "2"])
    assert "preprocessed 2 complexes (0 failed)" in capsys.readouterr().out
    jax_preprocess([*common, "--cache_dir", str(data_dir / "jax_cache")])
    ds = PDBDataset(data_dir / "PDB_processed_cache", ids)
    for i, pdb_id in enumerate(ids):
        d = ds[i]
        assert d["num_atoms"] == 13 and d["num_residues"] == 8 + 4 * i
        assert d["residue_esm"].shape == (d["num_residues"], 1280)
        ours = load_complex_cache(data_dir / "PDB_processed_cache", pdb_id)
        theirs = load_complex_cache(data_dir / "jax_cache", pdb_id)
        assert sorted(ours) == sorted(theirs)
        for k, v in theirs.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(ours[k], v, err_msg=k)
    preprocess([*common, "--device", "cpu"])
    assert "preprocessed 0 complexes (0 failed)" in capsys.readouterr().out
    # --esm_backend jax: the package's own encoder on a tiny HF ESM-2 directory
    esm = ["--esm_model", str(write_tiny_esm(data_dir / "esm_tiny")), "--esm_backend", "jax",
           "--require_esm", "--limit", "1"]
    preprocess([*common, *esm, "--device", "cpu", "--cache_dir", str(data_dir / "esm_port")])
    assert "preprocessed 1 complexes (0 failed)" in capsys.readouterr().out
    jax_preprocess([*common, *esm, "--cache_dir", str(data_dir / "esm_jax")])
    ours = load_complex_cache(data_dir / "esm_port", ids[0])
    theirs = load_complex_cache(data_dir / "esm_jax", ids[0])
    assert ours["residue_esm"].shape == (8, 48) and np.abs(ours["residue_esm"]).max() > 0
    np.testing.assert_allclose(ours["residue_esm"], theirs["residue_esm"], atol=2e-5, rtol=2e-5)


def test_graph_helpers_match_jax():
    from protein_redesign_tpu.ops import graph as JG
    from protein_redesign_tpu_torch.ops import graph as G

    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3).astype(np.float32)
    d = np.abs(rng.randn(2, 5)).astype(np.float32) * 10
    mask = (rng.rand(2, 5) > 0.3).astype(np.float32)
    tx, td = torch.from_numpy(x), torch.from_numpy(d)
    np.testing.assert_allclose(G.norm(tx).numpy(), np.asarray(JG.norm(jnp.asarray(x))),
                               rtol=1e-6)
    np.testing.assert_allclose(G.norm(tx, axis=1, keepdims=True).numpy(),
                               np.asarray(JG.norm(jnp.asarray(x), axis=1, keepdims=True)),
                               rtol=1e-6)
    np.testing.assert_allclose(G.rbf(td).numpy(), np.asarray(JG.rbf(jnp.asarray(d))),
                               atol=1e-6, rtol=1e-5)
    got = G.flatten_graph(tx, torch.from_numpy(mask))
    want = JG.flatten_graph(jnp.asarray(x), jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(G.unflatten_graph(got[0], 2).numpy(), x)


SCRIPT = r"""
import json, sys
from protein_redesign_tpu_torch.cli import (
    convert_checkpoint, evaluate, export_params, preprocess_pdbbind)
runs = json.loads(sys.argv[1])
export_params.main(runs["export"])
convert_checkpoint.main(runs["convert"])
evaluate.main(runs["evaluate"])
preprocess_pdbbind.main(runs["preprocess"])
loaded = sorted(m for m in ("jax", "flax", "protein_redesign_tpu") if m in sys.modules)
print("FRAMEWORKS", loaded)
"""


def test_offline_clis_never_import_jax(pdbbind_layout, tmp_path):  # noqa: F811
    from protein_redesign_tpu_torch.cli.generate import main as generate
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
    from protein_redesign_tpu_torch.parallel.train_step import make_train_state
    from protein_redesign_tpu_torch.utils.checkpoint import CheckpointManager
    from protein_redesign_tpu_torch.utils.weights import save_checkpoint

    data_dir, _ = pdbbind_layout
    torch.manual_seed(0)
    state = make_train_state(ProteinReDiffNet(TINY))
    state.step = 1
    CheckpointManager(tmp_path / "ckpts").save(state, val_loss=1.0)
    make_lightning_ckpt(tmp_path / "ref.ckpt")
    save_checkpoint(tmp_path / "tiny", state.net.state_dict(), TINY)
    generate(["-c", str(tmp_path / "tiny"), "-o", str(tmp_path / "gen"), *GENERATE])
    runs = {
        "export": [str(tmp_path / "ckpts"), str(tmp_path / "export")],
        "convert": [str(tmp_path / "ref.ckpt"), str(tmp_path / "converted")],
        "evaluate": ["-i", str(tmp_path / "gen")],
        "preprocess": ["--data_dir", str(data_dir), "--pdbbind_dir",
                       str(data_dir / "PDBbind_processed"), "--esm_model", "/nonexistent/esm",
                       "--device", "cpu"],
    }
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    proc = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(runs)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FRAMEWORKS []" in proc.stdout, proc.stdout[-2000:]
    assert "preprocessed 2 complexes (0 failed)" in proc.stdout
    assert (tmp_path / "export" / "model.pt").exists()
    assert (tmp_path / "converted" / "model.pt").exists()
    assert (tmp_path / "gen" / "evaluation.json").exists()
