"""The port's batch design CLIs (``cli/predict_batch_sequence.py`` and
``cli/predict_batch_structure.py``) at tiny width on the CPU, as
``tests/test_cli.py`` drives the JAX package's: the files they write, the
FASTA parse (wrapped records, CRLF endings, names) and its mask,
reproducible from the seed, the same as the JAX package's helpers give; on
a self-conditioned absorbing checkpoint every position of every sample is a
real residue; and a fresh process that runs both never
imports jax, flax or the JAX package (a subprocess, because this suite's
conftest imports jax).
"""

import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_generate import TINY  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SEQ = "ACDEFGHIKLMNPQRSTVWY"


def _checkpoint(path, cfg=TINY):
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
    from protein_redesign_tpu_torch.utils.weights import save_checkpoint

    torch.manual_seed(0)
    net = ProteinReDiffNet(cfg)
    with torch.no_grad():  # the zero-initialised output layers would hide the sequence head
        for p in net.parameters():
            p.add_(0.1 * torch.randn_like(p))
    save_checkpoint(path, net.state_dict(), cfg)
    return path


@pytest.fixture
def no_esm(monkeypatch):
    monkeypatch.setenv("PRD_DISABLE_ESM", "1")
    for name in ("USE_TF", "USE_FLAX"):  # main() sets these; keep them test-local
        monkeypatch.setenv(name, "0")


def _read_fasta(path):
    lines = Path(path).read_text().splitlines()
    return list(zip(lines[::2], lines[1::2]))


def test_sequence_batch(tmp_path, no_esm):
    from protein_redesign_tpu_torch.cli.predict_batch_sequence import main

    fasta = tmp_path / "in.fasta"
    fasta.write_text(f">prot one\n{SEQ}\n>prot2\n{SEQ[:12]}\n")
    smiles = tmp_path / "in.smiles"
    smiles.write_text("CCO\nc1ccccc1\n")
    out = tmp_path / "seqout"
    argv = ["-c", str(_checkpoint(tmp_path / "ckpt")), "-o", str(out), "-p", str(fasta),
            "-l", str(smiles), "-n", "2", "--num_steps", "2", "--mask_prob", "0.2",
            "--seed", "0", "--device", "cpu", "--accelerator", "tpu", "--num_workers", "4"]
    main(argv)
    masked = _read_fasta(out / "masked_sequences.fasta")
    assert [name for name, _ in masked] == [">prot_one_sample_0", ">prot2_sample_1"]
    assert [seq.count("X") for _, seq in masked] == [4, 2]
    sample = _read_fasta(out / "sample_sequences.fasta")
    assert [name for name, _ in sample] == [">prot_one_sample_0", ">prot_one_sample_1",
                                           ">prot2_sample_0", ">prot2_sample_1"]
    assert all(seq and set(seq) <= set(SEQ + "X") for _, seq in sample)
    again = tmp_path / "again"
    main([*argv[:3], str(again), *argv[4:]])
    assert (again / "masked_sequences.fasta").read_text() == \
        (out / "masked_sequences.fasta").read_text()


def test_structure_batch(tmp_path, no_esm):
    from protein_redesign_tpu_torch.cli.predict_batch_structure import main

    fasta = tmp_path / "in.fasta"
    fasta.write_text(f">a\n{SEQ}\n>b\n{SEQ[5:15]}\n")
    out = tmp_path / "strout"
    main(["-c", str(_checkpoint(tmp_path / "ckpt")), "-o", str(out), "-p", str(fasta),
          "-n", "2", "--num_steps", "2", "--mask_prob", "0.0", "--seed", "0",
          "--device", "cpu", "--sampler", "ddim", "--ddim_steps", "2"])
    for name, length in (("a", 20), ("b", 10)):
        for i in range(2):
            pdb = (out / f"sample_protein_{name}_model_{i}.pdb").read_text()
            assert sum(line.startswith("ATOM") for line in pdb.splitlines()) == length
            assert (out / f"sample_ligand_{name}_model_{i}.sdf").read_text().count("$$$$") == 1
        scores = [float(s) for s in (out / f"sample_tmscores_{name}.txt").read_text().split()]
        assert len(scores) == 2 and all(0.0 <= s <= 1.0 for s in scores)
    assert (out / "masked_sequences.fasta").read_text().count(">") == 2


def test_absorbing_self_cond_designs_every_position(tmp_path, no_esm):
    """On a self-conditioned absorbing checkpoint, with a user X run and
    half of the residues masked (in the FASTA, then by the sampler's own
    inference mask, as the JAX CLI does): every sample is the input length
    and every position a real residue."""
    from protein_redesign_tpu_torch.cli.predict_batch_sequence import main

    cfg = TINY.replace(seq_process="absorbing", self_cond=True)
    fasta = tmp_path / "in.fasta"
    inputs = {"x_run": "MNIFEXXXXDEGLRLKIYKD", "other": SEQ}
    fasta.write_text("".join(f">{k}\n{v}\n" for k, v in inputs.items()))
    out = tmp_path / "design"
    main(["-c", str(_checkpoint(tmp_path / "ckpt", cfg)), "-o", str(out), "-p", str(fasta),
          "-n", "2", "--num_steps", "4", "--mask_prob", "0.5", "--seed", "1", "--device", "cpu",
          "--reveal_schedule", "cosine", "--reveal_conf_noise", "0.5"])
    masked = dict(_read_fasta(out / "masked_sequences.fasta"))
    sample = _read_fasta(out / "sample_sequences.fasta")
    for header, seq in sample:
        name = header[1:].rsplit("_sample_", 1)[0]
        template = next(v for k, v in masked.items() if k[1:].startswith(name + "_sample_"))
        assert len(seq) == len(template) and "X" in template and "X" not in seq


def test_fasta_wrapped_crlf_and_seeded_mask(tmp_path):
    """Wrapped records are joined, CRLF endings stripped and spaces in names
    made underscores; the mask is reproducible from the seed and the JAX
    package's helper gives the same."""
    from protein_redesign_tpu.cli.common import (
        proteins_from_fasta_with_mask as jax_proteins_from_fasta_with_mask,
    )
    from protein_redesign_tpu_torch.cli.common import proteins_from_fasta_with_mask

    fasta = tmp_path / "wrapped.fasta"
    fasta.write_bytes(b">one two\r\nACDEFGHIKL\r\nMNPQRSTVWY\r\n>three\r\nACDE\r\n")
    proteins, names, seqs = proteins_from_fasta_with_mask(str(fasta))
    assert names == ["one_two", "three"]
    assert seqs == ["ACDEFGHIKLMNPQRSTVWY", "ACDE"]
    assert len(proteins) == 2 and len(proteins[0]) == 20
    _, _, s1 = proteins_from_fasta_with_mask(str(fasta), 0.3, rng=random.Random(7))
    _, _, s2 = proteins_from_fasta_with_mask(str(fasta), 0.3, rng=random.Random(7))
    _, _, s3 = jax_proteins_from_fasta_with_mask(str(fasta), 0.3, rng=random.Random(7))
    assert s1 == s2 == s3 and s1[0].count("X") == 6  # 20 residues * 0.3


def test_helpers_match_the_jax_package(tmp_path):
    import numpy as np

    from protein_redesign_tpu.cli import common as J
    from protein_redesign_tpu_torch.cli import common as C

    proba = np.random.RandomState(0).randn(12, 21)
    proba[:2, 0] = proba[-1, 0] = 50.0
    assert C.predict_seq(proba) == J.predict_seq(proba)
    smiles = tmp_path / "l.smiles"
    smiles.write_text("CCO |$;;$|\n\nc1ccccc1\n")
    for got, want in zip(C.parse_ligands(str(smiles)), J.parse_ligands(str(smiles))):
        assert got.num_atoms() == want.num_atoms()
        np.testing.assert_array_equal(got.positions, want.positions)
    assert C.mask_sequence_by_percent(SEQ, 0.25, random.Random(3)) == \
        J.mask_sequence_by_percent(SEQ, 0.25, random.Random(3))


def test_batch_cli_rejects_num_devices(tmp_path, monkeypatch):
    """More cards than are visible: the JAX CLI's ValueError, no fallback."""
    from protein_redesign_tpu_torch.cli.predict_batch_structure import main

    fasta = tmp_path / "in.fasta"
    fasta.write_text(f">a\n{SEQ}\n")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--num_devices 2 requested but only 1 CUDA devices"):
        main(["-c", str(_checkpoint(tmp_path / "ckpt")), "-o", str(tmp_path / "o"),
              "-p", str(fasta), "--num_devices", "2", "--device", "cuda"])


def test_batch_cli_on_two_cpu_replicas(tmp_path, no_esm):
    """``--num_gpus 2`` (the reference's name) with ``--device cpu``: the
    net replicated twice, the FASTA's sequences designed as on one device."""
    from protein_redesign_tpu_torch.cli.predict_batch_sequence import main

    fasta = tmp_path / "in.fasta"
    fasta.write_text(f">a\n{SEQ}\n>b\n{SEQ[5:15]}\n")
    ckpt = _checkpoint(tmp_path / "ckpt")
    for n in ("1", "2"):
        main(["-c", str(ckpt), "-o", str(tmp_path / n), "-p", str(fasta), "-n", "2",
              "--num_steps", "2", "--seed", "0", "--device", "cpu", "--batch_size", "2",
              "--num_gpus", n])
    one, two = ((tmp_path / n / "sample_sequences.fasta").read_text() for n in ("1", "2"))
    assert one.count(">") == 4 and one == two


SCRIPT = r"""
import sys
from protein_redesign_tpu_torch.cli.predict_batch_sequence import main as seqs
from protein_redesign_tpu_torch.cli.predict_batch_structure import main as structs
ckpt, fasta, out = sys.argv[1:4]
args = ["-c", ckpt, "-p", fasta, "-n", "1", "--num_steps", "2", "--seed", "0", "--device", "cpu"]
seqs(["-o", out + "/seq", *args])
structs(["-o", out + "/str", *args])
loaded = sorted(m for m in ("jax", "flax", "protein_redesign_tpu") if m in sys.modules)
print("FRAMEWORKS", loaded)
"""


def test_batch_clis_never_import_jax(tmp_path):
    fasta = tmp_path / "in.fasta"
    fasta.write_text(f">a\n{SEQ}\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PRD_DISABLE_ESM"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(_checkpoint(tmp_path / "ckpt")), str(fasta),
         str(tmp_path / "out")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FRAMEWORKS []" in proc.stdout, proc.stdout[-2000:]
    assert (tmp_path / "out" / "seq" / "sample_sequences.fasta").exists()
    assert (tmp_path / "out" / "str" / "sample_tmscores_a.txt").exists()
