"""The port's serve CLI (``protein_redesign_tpu_torch/cli/serve.py``) at tiny
width on the CPU, with the cases of the JAX package's ``tests/test_serve.py``
that apply to it: the JSONL round trip with error isolation, request-dir
sanitising and uniquifying (the helpers are verbatim copies of the JAX
module's), the ``num_samples``/``max_samples``/``max_nodes``
guards before any device work, ``--warmup_buckets``, a trajectory request,
the DDIM sampler with ``--fast_softmax`` (K1 fast), TCP mode, and a fresh
process that never imports jax, flax or ``protein_redesign_tpu``."""

import dataclasses
import json
import os
import queue
import socket
import subprocess
import sys
import threading

import pytest

torch = pytest.importorskip("torch")

from test_torch_generate import REPO, TINY  # noqa: E402

from protein_redesign_tpu_torch.cli import common  # noqa: E402
from protein_redesign_tpu_torch.cli import serve as S  # noqa: E402
from protein_redesign_tpu_torch.ops import attention as A  # noqa: E402

REQ = {"protein": "ACDEFGHIKL", "ligand": "CCO", "num_samples": 1}


@pytest.fixture
def ckpt(tmp_path, monkeypatch):
    """A tiny checkpoint trained the way K1 fast is served: use_pallas_bwd off."""
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
    from protein_redesign_tpu_torch.utils.weights import save_checkpoint

    monkeypatch.setenv("PRD_DISABLE_ESM", "1")
    for name in ("USE_TF", "USE_FLAX"):  # main() sets these; keep them test-local
        monkeypatch.setenv(name, "0")
    cfg = TINY.replace(use_pallas_bwd=False)
    torch.manual_seed(0)
    save_checkpoint(tmp_path / "ckpt", ProteinReDiffNet(cfg).state_dict(), cfg)
    return tmp_path / "ckpt"


def _serve(ckpt, tmp_path, requests, *flags):
    reqs, out = tmp_path / "reqs.jsonl", tmp_path / "results.jsonl"
    reqs.write_text("".join(r if isinstance(r, str) else json.dumps(r) + "\n" for r in requests))
    S.main(["-c", str(ckpt), "-o", str(tmp_path / "srv"), "--device", "cpu",
            "--input", str(reqs), "--output", str(out), *flags])
    return [json.loads(line) for line in out.read_text().splitlines()]


def test_serve_jsonl_roundtrip(ckpt, tmp_path):
    lines = _serve(ckpt, tmp_path, [
        {**REQ, "id": "a", "num_samples": 2, "seed": 1},
        {"id": "bad", "protein": "ACDE#@!", "ligand": "CCO"},
        # same bucket, another mask_prob
        {**REQ, "id": "c", "seed": 2, "mask_prob": 0.9},
        # a malformed line that starts like JSON: the error path must not raise
        '{"id": "broken", not json\n',
    ], "--num_steps", "2")
    assert [line["id"] for line in lines] == ["a", "bad", "c", "?"]
    ok, bad, ok2, broken = lines
    assert set(ok) == {"id", "sequences", "tmscores", "pdb_files", "sdf_files"}
    assert len(ok["sequences"]) == len(ok["tmscores"]) == 2
    assert all(0.0 <= s <= 1.0 for s in ok["tmscores"])
    for p in ok["pdb_files"]:
        assert open(p).read().startswith("ATOM")
    for p in ok["sdf_files"]:
        assert open(p).read().count("$$$$") == 1
    assert "error" in bad and "error" in broken
    assert len(ok2["sequences"]) == 1


def test_request_dir_never_escapes_output_dir(tmp_path):
    for evil in ("../../../etc", "/tmp/evil_abs", "a/../../b", "..", ""):
        d = S._claim_request_dir(tmp_path, evil)
        assert d.is_dir()
        assert d.parent == tmp_path, (evil, d)


@pytest.mark.parametrize("name", ["_safe_dir_name", "_claim_request_dir"])
def test_copied_helpers_match_the_jax_originals(name):
    import inspect

    from protein_redesign_tpu.cli import serve as jax_serve

    assert inspect.getsource(getattr(S, name)) == inspect.getsource(getattr(jax_serve, name))


def test_request_dir_uniquified_across_restarts(tmp_path, monkeypatch):
    (tmp_path / "job1").mkdir()  # left by a previous server process
    monkeypatch.setattr(S, "_claimed_counts", {})  # a fresh process
    assert S._claim_request_dir(tmp_path, "job1").name == "job1_2"
    assert S._claim_request_dir(tmp_path, "job1").name == "job1_3"


@pytest.mark.parametrize("req,limits,word", [
    ({**REQ, "num_samples": 0}, {}, "num_samples"),
    ({**REQ, "num_samples": 1_000_000_000}, {"max_samples": 64}, "max_samples"),
    # 10 residues + 3 ligand atoms = 13 nodes
    (REQ, {"max_nodes": 8}, "max_nodes"),
])
def test_guards_refuse_before_any_device_work(tmp_path, req, limits, word):
    """runner=None and embedder=None: a guard that fired late would crash
    on them with another error."""
    result = S.handle_line(json.dumps({**req, "id": "r"}), runner=None, embedder=None,
                           output_dir=tmp_path, default_mask_prob=0.3, **limits)
    assert result["id"] == "r" and word in result["error"]
    # at the ceiling the guard lets the request through (to fail on runner=None)
    fits = {**req, "num_samples": limits.get("max_samples", 1)}
    through = S.handle_line(json.dumps(fits), runner=None, embedder=None, output_dir=tmp_path,
                            default_mask_prob=0.3, **{**limits, "max_nodes": 13})
    assert word not in through["error"]


def _tiny_runner(**kw):
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet

    torch.manual_seed(0)
    return common.SamplingRunner(ProteinReDiffNet(TINY).eval(), "cpu", mask_prob=0.5, **kw)


def test_warmup_rejects_off_rung_bucket():
    runner = _tiny_runner(buckets=(16,))
    for bucket in (12, 2048):
        with pytest.raises(SystemExit, match="not ladder rungs"):
            S.warmup_runner(runner, [bucket], esm_dim=TINY.esm_dim)


def test_warm_buckets_restrict_runner_ladder(ckpt, tmp_path, monkeypatch):
    """A request smaller than the lowest warmed rung pads up to it instead
    of running an unwarmed smaller bucket; the warmed rung was sampled once
    at startup, padded to the batch size."""
    made = []
    real = common.SamplingRunner

    def spy(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(common, "SamplingRunner", spy)
    (line,) = _serve(ckpt, tmp_path, [{**REQ, "id": "small", "protein": "ACDEFGHI"}],
                     "--num_steps", "2", "--warmup_buckets", "32", "--batch_size", "2")
    assert line["id"] == "small" and "error" not in line
    (runner,) = made
    assert runner.buckets == (32,)
    assert [(b, rows) for b, rows, _, _ in runner.timings] == [(32, 2), (32, 2)]


def test_serve_trajectory_request(ckpt, tmp_path):
    (resp,) = _serve(ckpt, tmp_path, [{**REQ, "id": "t", "seed": 1, "trajectory": 2}],
                     "--num_steps", "4")
    (traj,) = resp["trajectory_files"]
    assert open(traj).read().count("MODEL") == 2
    (bad,) = _serve(ckpt, tmp_path, [{**REQ, "id": "u", "trajectory": 3}], "--num_steps", "4")
    assert "divisor" in bad["error"]


def test_serve_ddim_fast_softmax(ckpt, tmp_path, monkeypatch):
    """--sampler ddim with --fast_softmax on a use_pallas_bwd-false
    checkpoint, served with --pallas_auto_min_n 16 so that the attention
    plan takes Pallas at the request's bucket: every DDIM step's triangle
    attentions take K1 fast. At the default pallas_auto_min_n (384, which
    the flag sets whatever the checkpoint holds, as in the JAX CLI) the plan
    takes XLA there, and the f32 model computes its attentions as without
    the flag."""
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
    from protein_redesign_tpu_torch.utils.weights import save_checkpoint

    calls = []
    real = A.rows_attention_fast_reference
    monkeypatch.setattr(A, "rows_attention_fast_reference",
                        lambda *a: calls.append(1) or real(*a))
    flags = ("--num_steps", "8", "--sampler", "ddim", "--ddim_steps", "2", "--eta", "1.0",
             "--fast_softmax")
    (resp,) = _serve(ckpt, tmp_path, [{**REQ, "id": "x", "seed": 5}], *flags)
    assert len(resp["sequences"]) == 1 and "error" not in resp
    assert not calls
    cfg = TINY.replace(use_pallas_bwd=False, pallas_auto_min_n=16)
    torch.manual_seed(0)
    save_checkpoint(tmp_path / "pallas", ProteinReDiffNet(cfg).state_dict(), cfg)
    (resp,) = _serve(tmp_path / "pallas", tmp_path, [{**REQ, "id": "y", "seed": 5}], *flags)
    assert len(resp["sequences"]) == 1 and "error" not in resp
    assert not calls  # the flag's default, not the checkpoint's 16
    (resp,) = _serve(tmp_path / "pallas", tmp_path, [{**REQ, "id": "d", "seed": 5}], *flags,
                     "--pallas_auto_min_n", "16")
    assert len(resp["sequences"]) == 1 and "error" not in resp
    assert len(calls) == 2 * 2 * TINY.num_blocks  # steps x triangle attentions


def test_serve_tcp_mode(tmp_path, monkeypatch):
    from protein_redesign_tpu_torch.utils.esm import ESMEmbedder

    monkeypatch.setenv("PRD_DISABLE_ESM", "1")
    runner = _tiny_runner(buckets=(16,))
    port_q = queue.Queue()
    t = threading.Thread(
        target=S.serve_tcp, args=(0, runner, ESMEmbedder(esm_dim=TINY.esm_dim),
                                  tmp_path / "srv", 0.5),
        kwargs={"max_requests": 2, "ready_cb": port_q.put}, daemon=True,
    )
    t.start()
    port = port_q.get(timeout=60)
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        f = s.makefile("rw")
        f.write(json.dumps({**REQ, "id": "t1", "protein": "ACDEFGHI", "ligand": "CC"}) + "\n")
        f.flush()
        r1 = json.loads(f.readline())
        f.write('{"id": "oops", not json\n')
        f.flush()
        r2 = json.loads(f.readline())
    t.join(timeout=60)
    assert not t.is_alive()  # max_requests shut the server down
    assert r1["id"] == "t1" and len(r1["sequences"]) == 1
    assert open(r1["pdb_files"][0]).read().startswith("ATOM")
    assert "error" in r2


SCRIPT = r"""
import json, sys
import torch
from protein_redesign_tpu_torch.config import ModelConfig
from protein_redesign_tpu_torch.cli.serve import main
from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet
from protein_redesign_tpu_torch.utils.weights import save_checkpoint
cfg = ModelConfig(**{cfg})
save_checkpoint(sys.argv[1], ProteinReDiffNet(cfg).state_dict(), cfg)
open(sys.argv[3], "w").write(json.dumps({req}) + "\n")
main(["-c", sys.argv[1], "-o", sys.argv[2], "--input", sys.argv[3], "--output", sys.argv[4],
      "--num_steps", "2", "--device", "cpu"])
loaded = sorted(m for m in ("jax", "flax", "protein_redesign_tpu") if m in sys.modules)
print("FRAMEWORKS", loaded)
"""


def test_serve_never_imports_jax(tmp_path):
    script = SCRIPT.format(cfg=dataclasses.asdict(TINY), req=REQ)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PRD_DISABLE_ESM"] = "1"
    out = tmp_path / "results.jsonl"
    proc = subprocess.run(
        [sys.executable, "-c", script, str(tmp_path / "ckpt"), str(tmp_path / "srv"),
         str(tmp_path / "reqs.jsonl"), str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FRAMEWORKS []" in proc.stdout, proc.stdout[-2000:]
    (resp,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(resp["sequences"]) == 1
