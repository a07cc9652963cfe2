"""Query-chunked attention (``ops/chunked_attention.py``) against the JAX
package's ``chunked_attention`` on the CPU, mirroring
``tests/test_long_context.py``:

- float32 at 1e-5 for chunks of 4, 8 and 16, with mask and bias; bf16 with
  ``fast`` against JAX's ``fast_softmax`` chunks at the port's fast
  tolerance (1e-2 of max |out|, ``test_torch_plan.py``), and closer to it
  than to the f32-logit function, so an ignored flag fails;
- the triangle layout: a bias shared across rows reaches every chunk
  sliced on the query axis and never broadcast to the rows;
- chunk = N is the unchunked plain route (``attention_reference`` on the
  row-flattened inputs);
- gradients of q, k, v and the bias against JAX's at 1e-5, the chunks
  checkpointed;
- invalid chunks raise ``ValueError`` with JAX's message;
- the tiny net's forward with ``attn_chunk`` against the JAX net's (f32 at
  1e-4; bf16 ``fast_softmax`` within 2e-2 relative norm);
- a spy: the plan's chunk (128 at N = 768 in training) reaches every
  attention, and none below 768; ``--attn_chunk`` reaches them through the
  generate, serve and train CLIs.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_net import CFG, make_batch, perturbed_params  # noqa: E402
from test_train_cli import mini_data  # noqa: E402,F401

from protein_redesign_tpu.models.prdiff import ProteinReDiffModel  # noqa: E402
from protein_redesign_tpu.ops.chunked_attention import chunked_attention as jax_chunked  # noqa: E402
from protein_redesign_tpu_torch.models import layers as L  # noqa: E402
from protein_redesign_tpu_torch.models import prdiff as P  # noqa: E402
from protein_redesign_tpu_torch.ops import attention as A  # noqa: E402
from protein_redesign_tpu_torch.ops import chunked_attention as CA  # noqa: E402
from protein_redesign_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402


def _inputs(shape, seed, mask_shape=None, bias_shape=None):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    mask = None if mask_shape is None else (rng.rand(*mask_shape) > 0.3).astype(np.float32)
    bias = None if bias_shape is None else rng.randn(*bias_shape).astype(np.float32)
    return q, k, v, mask, bias


def _port(arrays, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(dtype) for a in arrays]


def _jax(arrays, dtype=jnp.float32):
    return [None if a is None else jnp.asarray(a, dtype) for a in arrays]


def _flat_plain(q, k, v, mask, bias, scale):
    """``attention_reference`` on the inputs row-flattened as
    ``attention_core`` flattens them."""
    lead, (N, H, C) = q.shape[:-3], q.shape[-3:]
    R = int(np.prod(lead))
    flat = [x.reshape(R, N, H, C) for x in (q, k, v)]
    maskf = None if mask is None else torch.broadcast_to(mask, lead + (N,)).reshape(R, N)
    biasf = None if bias is None else torch.broadcast_to(bias, lead + (H, N, N)).reshape(
        R, H, N, N)
    return A.attention_reference(*flat, maskf, biasf, scale).reshape(q.shape)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_matches_jax(chunk):
    arrays = _inputs((2, 16, 3, 5), 0, (2, 16), (2, 3, 16, 16))
    got = CA.chunked_attention(*_port(arrays), 0.7, chunk)
    want = jax_chunked(*_jax(arrays), 0.7, chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_mask,with_bias", [(True, True), (True, False), (False, True)])
def test_fast_bf16_matches_jax(with_mask, with_bias):
    arrays = _inputs((2, 16, 2, 8), 1, (2, 16) if with_mask else None,
                     (2, 2, 16, 16) if with_bias else None)
    arrays = [None if a is None else a * 3.0 for a in arrays]  # spread the logits
    q, k, v, mask, bias = _port(arrays, torch.bfloat16)
    mask = None if mask is None else mask.float()
    got = CA.chunked_attention(q, k, v, mask, bias, 0.25, 8, fast=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    jq, jk, jv, _, jb = _jax(arrays, jnp.bfloat16)
    jm = None if arrays[3] is None else jnp.asarray(arrays[3])

    def jax_run(fast):
        out = jax_chunked(jq, jk, jv, jm, jb, 0.25, 8, fast_softmax=fast)
        return np.asarray(out.astype(jnp.float32))

    want, slow = jax_run(True), jax_run(False)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    assert np.abs(got - want).mean() * 2 <= np.abs(got - slow).mean()
    # the same function as the unchunked bf16-logit attention, chunk by chunk
    flat = [x.reshape(2, 16, 2, 8) for x in (q, k, v)]
    whole = A.attention_reference_fast(*flat, mask, bias, 0.25)
    np.testing.assert_array_equal(got, whole.float().numpy())


def test_triangle_layout_bias_sliced_not_row_broadcast(monkeypatch):
    B, R, N, H, C, chunk = 1, 6, 8, 2, 4, 4
    arrays = _inputs((B, R, N, H, C), 2, (B, R, N), (B, 1, H, N, N))
    seen = []
    body = CA.attention_reference

    def spy(qc, k, v, mask, bc, scale):
        seen.append(tuple(bc.shape))
        return body(qc, k, v, mask, bc, scale)

    monkeypatch.setattr(CA, "attention_reference", spy)
    got = CA.chunked_attention(*_port(arrays), 0.5, chunk)
    assert seen == [(B, 1, H, chunk, N)] * (N // chunk)
    want = jax_chunked(*_jax(arrays), 0.5, chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), _flat_plain(*_port(arrays), 0.5).numpy(),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("with_mask,with_bias", [(True, True), (False, False)])
def test_full_chunk_is_the_unchunked_plain_route(with_mask, with_bias):
    arrays = _inputs((12, 2, 4), 3, (12,) if with_mask else None,
                     (2, 12, 12) if with_bias else None)
    q, k, v, mask, bias = _port(arrays)
    got = CA.chunked_attention(q, k, v, mask, bias, 1.0, 12)
    want = A.attention_reference(q[None], k[None], v[None],
                                 None if mask is None else mask[None],
                                 None if bias is None else bias[None], 1.0)[0]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_gradients_match_jax():
    arrays = _inputs((1, 8, 2, 4), 4, (1, 8), (1, 2, 8, 8))
    q, k, v, mask, bias = _port(arrays)
    for t in (q, k, v, bias):
        t.requires_grad_()
    loss = torch.sum(CA.chunked_attention(q, k, v, mask, bias, 0.5, 4) ** 2)
    got = torch.autograd.grad(loss, (q, k, v, bias))
    jq, jk, jv, jm, jb = _jax(arrays)
    want = jax.grad(lambda q, k, v, b: jnp.sum(jax_chunked(q, k, v, jm, b, 0.5, 4) ** 2),
                    argnums=(0, 1, 2, 3))(jq, jk, jv, jb)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_invalid_chunk_raises():
    q = torch.zeros(4, 2, 3)
    for chunk in (3, 8, 0):  # does not divide 4; past N; empty
        with pytest.raises(ValueError, match="attn_chunk"):
            CA.chunked_attention(q, q, q, None, None, 1.0, chunk)
        with pytest.raises(ValueError) as jax_err:
            jax_chunked(jnp.zeros((4, 2, 3)), jnp.zeros((4, 2, 3)), jnp.zeros((4, 2, 3)), None,
                        None, 1.0, chunk)
        with pytest.raises(ValueError) as port_err:
            CA.chunked_attention(q, q, q, None, None, 1.0, chunk)
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_net_forward_with_attn_chunk_matches_jax(dtype):
    """The tiny 2-block net at bucket 16 with attn_chunk 8 (fast_softmax in
    bf16): every attention chunked on both sides."""
    cfg = CFG.replace(use_pallas=False, attn_chunk=8, dtype=dtype,
                      fast_softmax=dtype == "bfloat16")
    batch = make_batch(B=2, seed=6)
    params = perturbed_params(cfg, seed=6)
    rng = np.random.RandomState(16)
    B, N = batch["residue_mask"].shape
    z, seq_t = rng.randn(B, N, 3).astype(np.float32), rng.randn(B, N, 21).astype(np.float32)
    mask, t = batch["atom_mask"] + batch["residue_mask"], rng.randint(0, cfg.num_steps, (B,))
    want = jax.jit(ProteinReDiffModel(cfg).apply)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(z),
        jnp.asarray(seq_t), jnp.asarray(mask), jnp.asarray(t, jnp.int32))
    net = P.ProteinReDiffNet(cfg)
    net.load_state_dict(state_dict_from_jax(params, cfg))
    with torch.no_grad():
        got = net({k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(z),
                  torch.from_numpy(seq_t), torch.from_numpy(mask), torch.from_numpy(t))
    for g, w in zip(got, want):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert np.isfinite(g).all()
        if dtype == "bfloat16":
            assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w)
        else:
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_decision_is_the_routes(monkeypatch, plain, dtype):
    """``chunks_queries`` on a CUDA-routed call (``_on_cpu`` patched False)
    holds exactly where ``gated_attention_core`` runs a plain version: over
    its whole branch table (fast, the plan, kernel_bwd, with and without a
    mask and a bias), inside and outside ``plain_route()``. Spies stand in
    for every route, so nothing launches."""
    import contextlib

    routes = []

    def spy(name):
        def run(q, *args):
            routes.append(name)
            return torch.zeros_like(q)
        return run

    class PlainVjp:
        apply = staticmethod(spy("plain vjp"))

    monkeypatch.setattr(A, "_on_cpu", lambda t: False)
    monkeypatch.setattr(A, "attention_reference", spy("plain"))
    monkeypatch.setattr(A, "attention_reference_fast", spy("plain fast"))
    monkeypatch.setattr(A, "_RowsAttentionPlainVjp", PlainVjp)
    monkeypatch.setattr(A, "fused_attention", spy("kernel"))
    q = torch.zeros(2, 8, 2, 4, dtype=dtype)
    cases = 0
    with A.plain_route() if plain else contextlib.nullcontext():
        for mask in (torch.ones(2, 8), None):
            for bias in (torch.zeros(2, 2, 8, 8), None):
                for fast in (False, True):
                    for use_pallas in (False, True):
                        for kernel_bwd in (False, True):
                            routes.clear()
                            A.gated_attention_core(q, q, q, mask, bias, 1.0, fast, kernel_bwd,
                                                   use_pallas)
                            (route,) = routes
                            holds = route in ("plain", "plain fast") or (
                                route == "plain vjp" and plain)
                            assert A.chunks_queries(q, mask, bias, fast, use_pallas) == holds, (
                                mask is not None, bias is not None, fast, use_pallas, kernel_bwd)
                            cases += 1
    assert cases == 32


@pytest.mark.parametrize("bucket,chunk", [(768, 128), (512, 0)])
def test_plan_chunk_reaches_the_attentions(monkeypatch, bucket, chunk):
    """Training without the kernel backward at N = 768, the plan chunks
    queries by 128 (the JAX plan):
    the spy sees that chunk in all 3 x blocks + 1 attentions on the CPU's
    plain route; at 512 none. The spy returns zeros, so the forward stays
    cheap."""
    from protein_redesign_tpu_torch.config import ModelConfig
    from protein_redesign_tpu_torch.models.denoiser import resolve_attention_plan

    cfg = ModelConfig(esm_dim=8, time_dim=8, dist_dim=8, single_dim=8, pair_dim=8, head_dim=4,
                      num_heads=2, num_blocks=1, num_steps=4, dtype="float32", remat=False,
                      training_mode=True, use_pallas_bwd=False)
    assert resolve_attention_plan(cfg, bucket) == (False, chunk)
    calls = []

    def spy(q, k, v, mask, bias, scale, attn_chunk, fast=False):
        assert A.chunks_queries(q, mask, bias, fast, False)
        calls.append(attn_chunk)
        return torch.zeros_like(q)

    monkeypatch.setattr(L, "chunked_attention", spy)
    torch.manual_seed(0)
    net = P.ProteinReDiffNet(cfg)
    b = make_batch(B=1, n_atoms=4, n_res=bucket - 20, bucket=bucket, seed=7)
    b["residue_esm"] = b["residue_esm"][..., :8]
    with torch.no_grad():
        net({k: torch.from_numpy(v) for k, v in b.items()}, torch.zeros(1, bucket, 3),
            torch.zeros(1, bucket, 21), torch.from_numpy(b["atom_mask"] + b["residue_mask"]),
            torch.zeros(1, dtype=torch.long))
    assert calls == ([chunk] * (3 * cfg.num_blocks + 1) if chunk else [])


@pytest.mark.parametrize("cli", ["generate", "serve", "train"])
def test_clis_take_attn_chunk(monkeypatch, tmp_path, cli, request):
    """``--attn_chunk 8`` reaches every attention through each CLI (a spy
    that computes the real chunks)."""
    from test_torch_generate import ARGS, TINY, _checkpoint

    calls = []
    real = L.chunked_attention

    def spy(*args):
        calls.append(args[6])
        return real(*args)

    monkeypatch.setattr(L, "chunked_attention", spy)
    monkeypatch.setenv("PRD_DISABLE_ESM", "1")
    if cli == "train":
        from test_torch_train_cli import TINY_FLAGS

        from protein_redesign_tpu_torch.cli.train import main

        data = request.getfixturevalue("mini_data")
        main(["--save_dir", str(tmp_path / "run"), "--data_dir", str(data), *TINY_FLAGS,
              "--max_steps", "1", "--attn_chunk", "8"])
    elif cli == "generate":
        from protein_redesign_tpu_torch.cli.generate import main

        _checkpoint(tmp_path / "ckpt")
        main(["-c", str(tmp_path / "ckpt"), "-o", str(tmp_path / "out"), *ARGS,
              "--attn_chunk", "8"])
    else:
        from protein_redesign_tpu_torch.cli.serve import main

        _checkpoint(tmp_path / "ckpt")
        (tmp_path / "reqs.jsonl").write_text(json.dumps(
            {"id": "a", "protein": "ACDEFGHIKL", "ligand": "CCO", "num_samples": 1}) + "\n")
        main(["-c", str(tmp_path / "ckpt"), "-o", str(tmp_path / "srv"), "--device", "cpu",
              "--num_steps", "2", "--input", str(tmp_path / "reqs.jsonl"), "--output",
              str(tmp_path / "res.jsonl"), "--attn_chunk", "8"])
        assert "error" not in json.loads((tmp_path / "res.jsonl").read_text())
    assert calls and set(calls) == {8}
    if cli != "train":  # a training step recomputes the blocks' attentions (remat)
        assert len(calls) % (3 * TINY.num_blocks + 1) == 0
