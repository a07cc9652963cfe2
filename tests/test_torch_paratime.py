"""The port's parallel-in-time DDIM sampler (``models/paratime.py``) against
``protein_redesign_tpu.models.paratime.sample_ddim_parallel`` on the CPU, at
the tiny width of ``test_torch_net.py`` (2 blocks, bucket 16) under the XLA
attention plan on both sides, mirroring ``tests/test_paratime.py`` save its
mesh tests:

- positions (Å) and sequence logits in float32 at 1e-4 against the JAX
  sampler with the same draws (``SamplerNoise`` holds JAX's mask scores,
  initial coordinates and sequence), at tol 0, at tol > 0 and with
  ``coarse_init``;
- ``iterations`` and ``nfe`` equal to JAX's: exactly at tol 0; at tol > 0
  after asserting that every error the port's loop compared with tol^2
  clears it by a relative margin of 1e-2, so that a rounding difference
  between the packages cannot flip a window;
- tol 0 against the port's sequential ``sample_ddim`` at 5e-4 (the JAX
  test's bound), with and without the warm start;
- the absorbing variant: JAX's reveal margins asserted along the sequential
  absorbing DDIM first (``test_torch_absorbing.jax_absorbing_run``), then
  the commitments exactly, against JAX's Picard sampler and the port's
  sequential sampler;
- every rejection with JAX's message, and the runner's argument checks.

Torch runs on one thread here: MKL's dynamic threading can change a GEMM's
summation split from call to call under load, and tol 0 converges only
where the same input gives the same bits.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_absorbing import ABS_CFG, jax_absorbing_run  # noqa: E402
from test_torch_net import CFG, make_batch, perturbed_params  # noqa: E402
from test_torch_selfcond import design_params, port_net  # noqa: E402
from test_torch_seq_reverse import sampler_draws  # noqa: E402

from protein_redesign_tpu.models.paratime import sample_ddim_parallel as jax_parallel  # noqa: E402
from protein_redesign_tpu.models.prdiff import ProteinReDiffModel  # noqa: E402
from protein_redesign_tpu_torch.models import paratime as PT  # noqa: E402
from protein_redesign_tpu_torch.models import prdiff as P  # noqa: E402

PAR_CFG = CFG.replace(use_pallas=False, num_steps=16)
S, W, MASK_PROB, SEED = 8, 4, 0.5, 5
KEY = jax.random.PRNGKey(11)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    params = perturbed_params(PAR_CFG, seed=SEED, scale=0.1)
    batch = make_batch(B=2, seed=SEED)
    return params, batch, port_net(PAR_CFG, params)


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_run(cfg, params, batch, **kw):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pos, logits, stats = jax_parallel(ProteinReDiffModel(cfg), params, jb, KEY, ddim_steps=S,
                                      window=W, mask_prob=MASK_PROB, **kw)
    return np.asarray(pos), np.asarray(logits), {k: int(v) for k, v in stats.items()}


def _port_run(cfg, net, batch, tol, coarse_init=0):
    B, N = batch["residue_mask"].shape
    noise = sampler_draws(KEY, B, N, S, cfg, "ddim")
    return PT.sample_ddim_parallel(net, _tb(batch), S, W, tol, MASK_PROB, noise=noise,
                                   coarse_init=coarse_init)


@pytest.mark.parametrize("tol,coarse_init", [(0.0, 0), (0.0, 2), (1e-3, 0), (3e-2, 2)])
def test_matches_jax(setup, monkeypatch, tol, coarse_init):
    params, batch, net = setup
    compared = []
    errors = PT._Window.errors

    def spy(self, *args):
        err = errors(self, *args)
        compared.append(err.clone())
        return err

    monkeypatch.setattr(PT._Window, "errors", spy)
    pos, logits, stats = _port_run(PAR_CFG, net, batch, tol, coarse_init)
    j_pos, j_logits, j_stats = _jax_run(PAR_CFG, params, batch, tol=tol, coarse_init=coarse_init)
    if tol > 0:
        tol2 = np.float32(tol) ** 2
        for err in compared:
            rel = np.abs(err.numpy() - tol2) / tol2
            assert rel.min() > 1e-2, ("an error within 1% of tol^2", err, tol2)
    assert stats == j_stats
    assert len(compared) == stats["iterations"]
    np.testing.assert_allclose(pos.numpy(), j_pos, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), j_logits, atol=1e-4, rtol=1e-4)
    if tol > 0:  # a looser tolerance takes fewer sweeps than the exact run
        assert stats["iterations"] < 2 * S


@pytest.mark.parametrize("coarse_init", [0, 2])
def test_tol_zero_is_the_sequential_trajectory(setup, coarse_init):
    """Same draws, tol 0: the sequential DDIM trajectory within 5e-4; at
    most 2S + 2 sweeps, at least S evaluations (plus the coarse ones)."""
    _, batch, net = setup
    B, N = batch["residue_mask"].shape
    noise = sampler_draws(KEY, B, N, S, PAR_CFG, "ddim")
    seq_pos, seq_logits = P.sample_ddim(net, _tb(batch), S, 0.0, MASK_PROB, noise=noise)
    pos, logits, stats = _port_run(PAR_CFG, net, batch, 0.0, coarse_init)
    np.testing.assert_allclose(pos.numpy(), seq_pos.numpy(), atol=5e-4)
    np.testing.assert_allclose(logits.numpy(), seq_logits.numpy(), atol=5e-4)
    assert stats["iterations"] <= 2 * S + 2
    assert stats["nfe"] >= S + coarse_init
    rm = batch["residue_mask"]
    assert np.all(logits.numpy()[rm == 0] == 0.0)


def test_generator_draws_match_sample_ddim(setup):
    """Without injected noise the sampler draws sample_ddim's mask scores
    and initial state from the generator."""
    _, batch, net = setup
    gen = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    seq_pos, _ = P.sample_ddim(net, _tb(batch), S, 0.0, MASK_PROB, gen())
    pos, _, _ = PT.sample_ddim_parallel(net, _tb(batch), S, W, 0.0, MASK_PROB, gen())
    np.testing.assert_allclose(pos.numpy(), seq_pos.numpy(), atol=5e-4)


def test_absorbing_matches_jax():
    """Deterministic reveal at tol 0: the sequential absorbing DDIM's
    decisions clear JAX's margins; then the commitments equal JAX's Picard
    sampler's and the port's sequential sampler's exactly."""
    cfg = ABS_CFG.replace(use_pallas=False, num_steps=16)
    batch = make_batch(B=2, seed=34)
    params = design_params(cfg, seed=34, scale=0.1, seq_gain=4.0)
    jax_absorbing_run(cfg, params, batch, KEY, MASK_PROB, S)  # asserts the margins
    net = port_net(cfg, params)
    pos, logits, stats = _port_run(cfg, net, batch, 0.0)
    j_pos, j_logits, j_stats = _jax_run(cfg, params, batch, tol=0.0)
    np.testing.assert_array_equal(logits.numpy(), j_logits)
    np.testing.assert_allclose(pos.numpy(), j_pos, atol=1e-4, rtol=1e-4)
    assert stats == j_stats and stats["iterations"] <= 2 * S + 2
    B, N = batch["residue_mask"].shape
    seq_pos, seq_logits = P.sample_ddim(net, _tb(batch), S, 0.0, MASK_PROB,
                                        noise=sampler_draws(KEY, B, N, S, cfg, "ddim"))
    np.testing.assert_array_equal(logits.numpy(), seq_logits.numpy())
    np.testing.assert_allclose(pos.numpy(), seq_pos.numpy(), atol=5e-4)


REJECTIONS = {
    "window": (dict(), dict(window=0), ValueError),
    "ddim_steps": (dict(), dict(ddim_steps=0), ValueError),
    "ancestral": (dict(seq_reverse="ancestral"), dict(), NotImplementedError),
    "self_cond": (dict(self_cond=True), dict(), NotImplementedError),
    "stochastic_reveal": (dict(seq_process="absorbing", reveal_temperature=0.5), dict(),
                          NotImplementedError),
    "absorbing_coarse_init": (dict(seq_process="absorbing"), dict(coarse_init=2),
                              NotImplementedError),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_rejections_carry_jax_messages(case):
    fields, kw, kind = REJECTIONS[case]
    cfg = PAR_CFG.replace(**fields)
    args = {"ddim_steps": 4, "window": 2, **kw}
    with pytest.raises(kind) as jax_err:
        jax_parallel(ProteinReDiffModel(cfg), {}, {}, KEY, **args)
    torch.manual_seed(0)
    with pytest.raises(kind) as port_err:
        PT.sample_ddim_parallel(P.ProteinReDiffNet(cfg), _tb(make_batch(B=1)), **args)
    assert str(port_err.value) == str(jax_err.value)


def _runner(cfg, **kw):
    from protein_redesign_tpu_torch.cli.common import SamplingRunner

    torch.manual_seed(0)
    return SamplingRunner(P.ProteinReDiffNet(cfg).eval(), "cpu", mask_prob=0.5, buckets=(16,),
                          sampler="ddim_parallel", ddim_steps=4, **kw)


@pytest.mark.parametrize("fields,kw,match", [
    (dict(), dict(eta=0.5), "eta"),
    (dict(seq_reverse="ancestral"), dict(), "ancestral"),
    (dict(seq_process="absorbing", reveal_conf_noise=0.5), dict(), "deterministic reveal"),
    (dict(seq_process="absorbing"), dict(coarse_init=2), "coarse_init"),
])
def test_runner_argument_checks(fields, kw, match):
    with pytest.raises(ValueError, match=match):
        _runner(PAR_CFG.replace(**fields), **kw)


def test_runner_samples_and_records_stats():
    """The runner's ddim_parallel path: finite samples trimmed to each
    complex, one stats entry per batch, and no trajectory frames."""
    from test_torch_ddim import _runner_inputs

    from protein_redesign_tpu_torch.config import ModelConfig

    tiny = ModelConfig(esm_dim=16, time_dim=8, dist_dim=8, single_dim=16, pair_dim=8,
                       head_dim=4, num_heads=2, num_blocks=1, num_steps=8, dtype="float32",
                       remat=False)
    runner = _runner(tiny, batch_size=2, window=3, ptol=0.0, coarse_init=2)
    out = runner.run(_runner_inputs(3), seed=1)
    assert len(out) == 3 and all(p.shape == (10, 3) and np.isfinite(p).all() for p, _ in out)
    assert len(runner.picard_stats) == 2 and runner.step_count() == 4
    assert all(1 <= s["iterations"] <= 10 and s["nfe"] >= 4 + 2 for s in runner.picard_stats)
    with pytest.raises(ValueError, match="trajectory"):
        runner.run(_runner_inputs(1), seed=1, trajectory=2)


def test_generate_cli_runs_ddim_parallel(tmp_path, capsys):
    from test_torch_generate import ARGS, _checkpoint

    from protein_redesign_tpu_torch.cli.generate import main

    _checkpoint(tmp_path / "ckpt")
    runner = main(["-c", str(tmp_path / "ckpt"), "-o", str(tmp_path / "out"), *ARGS,
                   "--sampler", "ddim_parallel", "--ddim_steps", "3", "--window", "2",
                   "--ptol", "0", "--coarse_init", "1"])
    assert (tmp_path / "out" / "sample_protein.pdb").read_text().count("MODEL") == 2
    out = capsys.readouterr().out
    assert len(runner.picard_stats) == 2  # two samples, one a batch
    for stats in runner.picard_stats:
        assert f"{stats['iterations']} Picard sweeps, {stats['nfe']} evaluations" in out


@pytest.mark.parametrize("cli", ["serve", "predict_batch_sequence"])
def test_serve_and_batch_clis_run_ddim_parallel(monkeypatch, tmp_path, cli):
    import json

    from test_torch_generate import _checkpoint

    monkeypatch.setenv("PRD_DISABLE_ESM", "1")
    _checkpoint(tmp_path / "ckpt")
    picard = ["--sampler", "ddim_parallel", "--ddim_steps", "3", "--window", "2", "--ptol", "0",
              "--num_steps", "4", "--device", "cpu"]
    if cli == "serve":
        from protein_redesign_tpu_torch.cli.serve import main

        (tmp_path / "reqs.jsonl").write_text(json.dumps(
            {"id": "a", "protein": "ACDEFGHIKL", "ligand": "CCO", "num_samples": 2}) + "\n")
        runner = main(["-c", str(tmp_path / "ckpt"), "-o", str(tmp_path / "srv"), "--input",
                       str(tmp_path / "reqs.jsonl"), "--output", str(tmp_path / "res.jsonl"),
                       *picard])
        (line,) = [json.loads(x) for x in (tmp_path / "res.jsonl").read_text().splitlines()]
        assert "error" not in line and len(line["sequences"]) == 2
        assert runner.picard_stats
    else:
        from protein_redesign_tpu_torch.cli.predict_batch_sequence import main

        (tmp_path / "in.fasta").write_text(">p\nACDEFGHIKL\n")
        main(["-c", str(tmp_path / "ckpt"), "-o", str(tmp_path / "out"), "-p",
              str(tmp_path / "in.fasta"), "-n", "2", "--seed", "0", *picard])
        assert (tmp_path / "out" / "sample_sequences.fasta").read_text().count(">") == 2
