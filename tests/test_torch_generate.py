"""The port's generate CLI at tiny width on the CPU: it writes the three
output files, and a fresh process that imports every port module and runs
it never imports jax or flax (checked in a subprocess, because this suite's
conftest imports jax)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from protein_redesign_tpu.config import ModelConfig  # noqa: E402

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


@pytest.mark.parametrize("flag", [["--sampler", "ddim"], ["--fast_softmax"],
                                  ["--seq_reverse", "ancestral"], ["--use_pallas_trimul"],
                                  ["--ddim_steps", "50"], ["--use_pallas"],
                                  ["--pallas_auto_min_n", "384"], ["--num_workers", "2"]])
def test_generate_rejects_what_is_not_ported(tmp_path, flag):
    from protein_redesign_tpu_torch.cli.generate import main

    _checkpoint(tmp_path / "ckpt")
    with pytest.raises(NotImplementedError):
        main(["-c", str(tmp_path / "ckpt"), "-o", str(tmp_path / "out"), *ARGS, *flag])


SCRIPT = r"""
import importlib, pkgutil, sys
import protein_redesign_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
import torch
from protein_redesign_tpu.config import ModelConfig
from protein_redesign_tpu_torch.cli.generate import main
from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
from protein_redesign_tpu_torch.utils.weights import save_checkpoint
cfg = ModelConfig(**{cfg})
save_checkpoint(sys.argv[1], ProteinReDiffNet(cfg).state_dict(), cfg)
main(["-c", sys.argv[1], "-o", sys.argv[2], *{args}])
loaded = sorted(m for m in ("jax", "flax") if m in sys.modules)
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
