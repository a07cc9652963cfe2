"""The port's train CLI at tiny width on the CPU, on the mini dataset of
``tests/test_train_cli.py``: it trains with accumulation, validates, writes
metrics and checkpoints, resumes with step continuity, checkpoints on
SIGTERM, keeps the top-k checkpoints by val_loss, and the port's generate
CLI samples from what it wrote (EMA weights of the best step). A fresh
process that trains, resumes and generates never imports jax or flax
(checked in a subprocess, because this suite's conftest imports jax)."""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_generate import TINY  # noqa: E402
from test_train_cli import mini_data  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
TINY_FLAGS = [
    "--batch_size", "2", "--buckets", "16,24",
    "--esm_dim", "16", "--time_dim", "8", "--dist_dim", "8",
    "--single_dim", "16", "--pair_dim", "8", "--head_dim", "4",
    "--num_heads", "2", "--num_blocks", "1", "--num_steps", "4",
    "--dtype", "float32", "--warmup_steps", "2", "--log_every_steps", "1",
    "--device", "cpu",
]
GENERATE = ["-p", "GMASKLLEVAKRLG", "-l", "CC(=O)Oc1ccccc1C(=O)O", "-n", "1",
            "--num_steps", "4", "--device", "cpu"]


def _metrics(save_dir):
    return [json.loads(line) for line in (save_dir / "metrics.jsonl").read_text().splitlines()]


def test_train_resume_and_generate(mini_data, tmp_path, monkeypatch):  # noqa: F811
    from protein_redesign_tpu_torch.cli.generate import main as generate
    from protein_redesign_tpu_torch.cli.train import main
    from protein_redesign_tpu_torch.utils.checkpoint import read_state, step_dir
    from protein_redesign_tpu_torch.utils.weights import load_checkpoint

    save_dir = tmp_path / "run"
    argv = ["--save_dir", str(save_dir), "--data_dir", str(mini_data), *TINY_FLAGS,
            "--accumulate_grad_batches", "2", "--val_every_steps", "2"]
    state = main([*argv, "--max_steps", "3"])
    assert state.step == 3
    metrics = _metrics(save_dir)
    losses = [m["train_loss"] for m in metrics if "train_loss" in m]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert all(m["bucket"] == 16 for m in metrics if "bucket" in m)
    assert [m["step"] for m in metrics if "val_loss" in m] == [2, 3]
    ckpts = save_dir / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == ["2", "3"]
    for name in ("config.json", "params.pt", "ema.pt", "optimizer.pt", "state.json"):
        assert (ckpts / "3" / name).exists()

    state = main([*argv, "--max_steps", "4", "--trained_ckpt", str(ckpts)])
    assert state.step == 4 and read_state(ckpts / "4")["ema_updates"] == 4
    assert 4 in [m["step"] for m in _metrics(save_dir) if "train_loss" in m]

    # the generate CLI takes the checkpoint directory: EMA weights of the best step
    sd, cfg = load_checkpoint(ckpts, num_steps=4)
    best = step_dir(ckpts, prefer="best")
    ema = torch.load(best / "ema.pt", weights_only=True)
    assert cfg.num_steps == 4 and cfg.single_dim == 16
    for k, v in ema.items():
        torch.testing.assert_close(sd[k], v, atol=0, rtol=0)
    monkeypatch.setenv("PRD_DISABLE_ESM", "1")
    for name in ("USE_TF", "USE_FLAX"):  # main() sets these; keep them test-local
        monkeypatch.setenv(name, "0")
    out = tmp_path / "out"
    generate(["-c", str(ckpts), "-o", str(out), *GENERATE])
    assert (out / "sample_protein.pdb").read_text().count("ATOM") > 0


def test_sigterm_checkpoints_without_validation(mini_data, tmp_path, monkeypatch):  # noqa: F811
    from protein_redesign_tpu_torch.cli.train import main
    from protein_redesign_tpu_torch.parallel import train_step as T
    from protein_redesign_tpu_torch.utils.checkpoint import read_state

    make = T.make_train_step

    def make_signalling(train_cfg):
        step = make(train_cfg)

        def signalling(state, *args, **kwargs):
            out = step(state, *args, **kwargs)
            if state.step == 2:
                signal.raise_signal(signal.SIGTERM)
            return out

        return signalling

    monkeypatch.setattr(T, "make_train_step", make_signalling)
    save_dir = tmp_path / "run"
    previous = signal.getsignal(signal.SIGTERM)
    try:
        state = main(["--save_dir", str(save_dir), "--data_dir", str(mini_data), *TINY_FLAGS,
                      "--max_steps", "100", "--val_every_steps", "0"])
    finally:
        signal.signal(signal.SIGTERM, previous)
        signal.signal(signal.SIGINT, signal.default_int_handler)
    assert state.step == 2
    assert read_state(save_dir / "checkpoints" / "2") == {
        "step": 2, "ema_updates": 2, "val_loss": None}


def test_checkpoint_retention_keeps_top_k_and_latest(tmp_path):
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
    from protein_redesign_tpu_torch.parallel.train_step import make_train_state
    from protein_redesign_tpu_torch.utils.checkpoint import CheckpointManager, step_dir

    state = make_train_state(ProteinReDiffNet(TINY))
    manager = CheckpointManager(tmp_path, top_k=2)
    for step, val_loss in ((1, 5.0), (2, 3.0), (3, None), (4, 4.0), (5, 6.0), (6, 7.0)):
        state.step = step
        manager.save(state, val_loss)
    # the two best (2, 4), the one without a val_loss (3), the latest (6)
    assert manager.steps() == [2, 3, 4, 6]
    assert step_dir(tmp_path, prefer="best").name == "2"
    assert step_dir(tmp_path).name == "6"


@pytest.mark.parametrize("flag", [
    ["--cache_device_batches"], ["--device_cache_gb", "1"], ["--num_devices", "2"],
    ["--mesh_shape", "2,1"], ["--profile"], ["--use_pallas"], ["--no-use_pallas_bwd"],
    ["--trimul_dmajor"], ["--fast_softmax"], ["--seq_process", "absorbing"],
])
def test_train_rejects_what_is_not_ported(mini_data, tmp_path, flag):  # noqa: F811
    from protein_redesign_tpu_torch.cli.train import main

    with pytest.raises(NotImplementedError):
        main(["--save_dir", str(tmp_path / "run"), "--data_dir", str(mini_data), *TINY_FLAGS,
              "--max_steps", "1", *flag])


def test_wire_compression_is_documented_as_without_effect(capsys):
    from protein_redesign_tpu_torch.cli.train import main

    with pytest.raises(SystemExit):
        main(["--help"])
    assert "no effect" in " ".join(capsys.readouterr().out.split())


SCRIPT = r"""
import sys
from protein_redesign_tpu_torch.cli.generate import main as generate
from protein_redesign_tpu_torch.cli.train import main as train
data, run = sys.argv[1], sys.argv[2]
argv = ["--save_dir", run, "--data_dir", data, *{flags}, "--val_every_steps", "0"]
train([*argv, "--max_steps", "1"])
train([*argv, "--max_steps", "2", "--trained_ckpt", run + "/checkpoints"])
generate(["-c", run + "/checkpoints", "-o", run + "/out", *{generate}])
loaded = sorted(m for m in ("jax", "flax") if m in sys.modules)
print("FRAMEWORKS", loaded)
"""


def test_train_never_imports_jax(mini_data, tmp_path):  # noqa: F811
    script = SCRIPT.format(flags=TINY_FLAGS, generate=GENERATE)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PRD_DISABLE_ESM"] = "1"
    proc = subprocess.run(
        [sys.executable, "-c", script, str(mini_data), str(tmp_path / "run")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FRAMEWORKS []" in proc.stdout, proc.stdout[-2000:]
    assert (tmp_path / "run" / "checkpoints" / "2" / "ema.pt").exists()
