"""The port's generate CLI at tiny width on the CPU: it writes the three
output files (and, with ``--save_trajectory``, the DDIM frames), and a fresh process that imports every port module and runs
it never imports jax, flax or the JAX package ``protein_redesign_tpu``
(checked in a subprocess, because this suite's conftest imports jax)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from protein_redesign_tpu_torch.config import ModelConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
TINY = ModelConfig(
    esm_dim=16, time_dim=8, dist_dim=8, single_dim=16, pair_dim=8,
    head_dim=4, num_heads=2, num_blocks=1, num_steps=4, dtype="float32", remat=False,
)
ARGS = ["-p", "GMASKLLEVAKRLG", "-l", "CC(=O)Oc1ccccc1C(=O)O", "-n", "2",
        "--num_steps", "4", "--device", "cpu", "--seed", "3"]


def _checkpoint(path):
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
    from protein_redesign_tpu_torch.utils.weights import save_checkpoint

    torch.manual_seed(0)
    save_checkpoint(path, ProteinReDiffNet(TINY).state_dict(), TINY)


def test_generate_writes_outputs(tmp_path, monkeypatch):
    from protein_redesign_tpu_torch.cli.generate import main

    monkeypatch.setenv("PRD_DISABLE_ESM", "1")
    for name in ("USE_TF", "USE_FLAX"):  # main() sets these; keep them test-local
        monkeypatch.setenv(name, "0")
    _checkpoint(tmp_path / "ckpt")
    out = tmp_path / "out"
    main(["-c", str(tmp_path / "ckpt"), "-o", str(out), *ARGS])
    pdb = (out / "sample_protein.pdb").read_text()
    assert pdb.count("MODEL") >= 2
    coords = np.array([[float(line[30:38]), float(line[38:46]), float(line[46:54])]
                       for line in pdb.splitlines() if line.startswith("ATOM")])
    assert len(coords) and np.isfinite(coords).all()
    assert (out / "sample_ligand.sdf").read_text().count("$$$$") == 2
    scores = [float(x) for x in (out / "sample_tmscores.txt").read_text().split()]
    assert len(scores) == 2 and all(0.0 <= s <= 1.0 for s in scores)


def test_generate_ddim_with_trajectories(tmp_path, monkeypatch, capsys):
    """--sampler ddim with --save_trajectory K and --fast_softmax: K frames
    per sample in sample_trajectory_<i>.pdb and seconds per DDIM step."""
    from protein_redesign_tpu_torch.cli.generate import main

    monkeypatch.setenv("PRD_DISABLE_ESM", "1")
    for name in ("USE_TF", "USE_FLAX"):
        monkeypatch.setenv(name, "0")
    _checkpoint(tmp_path / "ckpt")
    out = tmp_path / "out"
    main(["-c", str(tmp_path / "ckpt"), "-o", str(out), *ARGS, "--sampler", "ddim",
          "--ddim_steps", "2", "--save_trajectory", "2", "--fast_softmax"])
    for i in range(2):
        assert (out / f"sample_trajectory_{i}.pdb").read_text().count("MODEL") == 2
    assert (out / "sample_protein.pdb").read_text().count("MODEL") == 2
    assert "2 ddim steps" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--sample_segments", "2"], ["--sample_segments", "0"]])
def test_generate_rejects_what_is_not_ported(tmp_path, flag):
    from protein_redesign_tpu_torch.cli.generate import main

    _checkpoint(tmp_path / "ckpt")
    with pytest.raises(NotImplementedError):
        main(["-c", str(tmp_path / "ckpt"), "-o", str(tmp_path / "out"), *ARGS, *flag])


def test_generate_on_two_cpu_replicas(tmp_path, monkeypatch, capsys):
    """``--num_devices 2`` on the CPU: the net replicated twice, the batch of
    2 split 1 + 1, the same samples as on one device at the seed."""
    from protein_redesign_tpu_torch.cli.generate import main

    monkeypatch.setenv("PRD_DISABLE_ESM", "1")
    _checkpoint(tmp_path / "ckpt")
    for n, out in (("1", "one"), ("2", "two")):
        main(["-c", str(tmp_path / "ckpt"), "-o", str(tmp_path / out), *ARGS,
              "--batch_size", "2", "--num_devices", n])
    assert "sampled 2 at bucket" in capsys.readouterr().out
    one, two = ((tmp_path / d / "sample_protein.pdb").read_text() for d in ("one", "two"))
    assert one.count("MODEL") == 2 and two.count("MODEL") == 2

    def coords(pdb):  # PDB columns 31-54, written to 1e-3 Å
        return np.array([[float(ln[30 + 8 * i:38 + 8 * i]) for i in range(3)]
                         for ln in pdb.splitlines() if ln.startswith("ATOM")])

    np.testing.assert_allclose(coords(two), coords(one), atol=2e-3)


def test_generate_num_devices_needs_the_cards(tmp_path, monkeypatch):
    """More cards asked for than visible: JAX's ValueError, no fallback."""
    from protein_redesign_tpu_torch.cli.generate import main

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="--num_devices 2 requested but only 1 CUDA devices "
                                         "are visible"):
        main(["-c", str(tmp_path / "ckpt"), "-o", str(tmp_path / "out"), *ARGS[:-4],
              "--device", "cuda", "--num_devices", "2"])


@pytest.mark.parametrize("flag,field,value", [
    (["--use_pallas"], "use_pallas", True),
    (["--pallas_auto_min_n", "16"], "pallas_auto_min_n", 16),
    (["--trimul_dmajor"], "trimul_dmajor", True),
    (["--num_workers", "2"], None, None),
    (["--esm_backend", "jax", "--require_esm"], None, None),
], ids=["use_pallas", "pallas_auto_min_n", "trimul_dmajor", "num_workers", "esm_backend_jax"])
def test_generate_takes_the_jax_flags(tmp_path, monkeypatch, flag, field, value):
    """The JAX CLI's flags run with its meaning: the switches set their
    config fields, ``--num_workers`` is accepted and ignored, and
    ``--esm_backend jax`` embeds with the package's own encoder (a tiny HF
    ESM-2 directory of the net's esm_dim; ``--require_esm`` fails without
    its weights)."""
    from test_torch_esm2 import write_tiny_esm

    from protein_redesign_tpu_torch.cli.generate import main

    for name in ("USE_TF", "USE_FLAX"):
        monkeypatch.setenv(name, "0")
    if "--esm_backend" in flag:
        monkeypatch.delenv("PRD_DISABLE_ESM", raising=False)
        flag = [*flag, "--esm_model", str(write_tiny_esm(tmp_path / "esm", hidden=TINY.esm_dim))]
    else:
        monkeypatch.setenv("PRD_DISABLE_ESM", "1")
    _checkpoint(tmp_path / "ckpt")
    out = tmp_path / "out"
    runner = main(["-c", str(tmp_path / "ckpt"), "-o", str(out), *ARGS, *flag])
    if field is not None:
        assert getattr(runner.net.cfg, field) == value
    scores = [float(x) for x in (out / "sample_tmscores.txt").read_text().split()]
    assert len(scores) == 2 and all(0.0 <= s <= 1.0 for s in scores)


SCRIPT = r"""
import importlib, pkgutil, sys
import protein_redesign_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
import torch
from protein_redesign_tpu_torch.config import ModelConfig
from protein_redesign_tpu_torch.cli.generate import main
from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
from protein_redesign_tpu_torch.utils.weights import save_checkpoint
cfg = ModelConfig(**{cfg})
save_checkpoint(sys.argv[1], ProteinReDiffNet(cfg).state_dict(), cfg)
main(["-c", sys.argv[1], "-o", sys.argv[2], *{args}])
loaded = sorted(m for m in ("jax", "flax", "protein_redesign_tpu") if m in sys.modules)
print("FRAMEWORKS", loaded)
"""


def test_port_never_imports_jax(tmp_path):
    import dataclasses

    script = SCRIPT.format(cfg=dataclasses.asdict(TINY), args=ARGS)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.pop("PRD_DISABLE_ESM", None)
    proc = subprocess.run(
        [sys.executable, "-c", script, str(tmp_path / "ckpt"), str(tmp_path / "out")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FRAMEWORKS []" in proc.stdout, proc.stdout[-2000:]
    assert (tmp_path / "out" / "sample_tmscores.txt").exists()
