"""The port's ESM-2 encoder (``protein_redesign_tpu_torch/models/esm2.py``)
against the JAX package's (``protein_redesign_tpu/models/esm2.py``) and HF
``transformers.EsmModel``, on tiny random models (hidden 48, 2 layers, 4
heads), inputs from a numpy seed:

- ``ESM2`` against ``esm2_forward`` on ``esm2_random_params`` (every leaf
  perturbed, so no zero bias or unit LayerNorm hides a wrong mapping)
  carried across by ``esm2_state_dict_from_jax``: a padded batch with
  ``<mask>`` tokens, a mask-heavy sequence and ``token_dropout=False``, f32
  at atol/rtol 2e-5 and bf16 within 2e-2 relative norm;
- against a perturbed tiny HF model through the mask-aware chain of
  ``tests/test_esm2.py`` (fair-esm's padding semantics), f32 2e-5;
- padding changes nothing: the unbucketed ``ESM2Encoder`` against JAX's
  bucket-64 ``JaxESM2``, and the port padded against unpadded;
- HF state dicts load by name (contact head, pooler and rotary buffers
  dropped; a missing encoder key raises), ESM-1b-style configs are refused;
- ``ESMEmbedder(backend="jax")`` from a tiny HF directory against the JAX
  package's ``ESMEmbedder(backend="jax")`` on the same directory, and its
  fallbacks;
- the generate, serve and batch CLIs build their embedder on ``--device``
  with ``--esm_backend``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")

import jax  # noqa: E402
from test_esm2 import hf_reference_forward, tiny_hf_model  # noqa: E402

from protein_redesign_tpu.models.esm2 import ESM2Config as JaxConfig  # noqa: E402
from protein_redesign_tpu.models.esm2 import JaxESM2, esm2_forward, esm2_random_params  # noqa: E402
from protein_redesign_tpu_torch.models import esm2 as E  # noqa: E402

TOL = dict(atol=2e-5, rtol=2e-5)
TINY = dict(hidden_size=48, num_layers=2, num_heads=4, intermediate_size=96)


def perturbed_params(cfg: JaxConfig, seed: int = 0):
    params = esm2_random_params(jax.random.PRNGKey(seed), cfg, scale=0.1)
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a)).astype(np.float32),
        params)


def port_model(params, cfg: JaxConfig) -> E.ESM2:
    model = E.ESM2(E.ESM2Config(**dataclasses.asdict(cfg)))
    model.load_state_dict(E.esm2_state_dict_from_jax(params))
    return model.eval()


def port_forward(model, ids, mask) -> np.ndarray:
    with torch.inference_mode():
        return model(torch.from_numpy(np.asarray(ids, np.int64)),
                     torch.from_numpy(np.asarray(mask, np.int64))).numpy()


def padded_batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(4, 29, size=(3, 17))
    ids[:, 0] = 0   # <cls>
    ids[0, 5] = ids[1, 9] = ids[2, 2] = ids[2, 3] = 32  # <mask> tokens
    mask = np.ones_like(ids)
    mask[1, 12:] = 0
    ids[1, 12:] = 1  # pad
    return ids, mask, {}


def mask_heavy():
    ids = np.full((1, 9), 32)
    ids[0, 0], ids[0, -1] = 0, 2
    return ids, np.ones_like(ids), {}


def no_token_dropout():
    ids, mask, _ = padded_batch()
    return ids, mask, dict(token_dropout=False)


CASES = {"padded": padded_batch, "mask_heavy": mask_heavy, "no_token_dropout": no_token_dropout}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(case):
    ids, mask, overrides = CASES[case]()
    cfg = JaxConfig(**TINY, **overrides)
    params = perturbed_params(cfg, seed=len(case))
    ref = np.asarray(esm2_forward(params, cfg, ids.astype(np.int32), mask.astype(np.int32)))
    np.testing.assert_allclose(port_forward(port_model(params, cfg), ids, mask), ref, **TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_bf16_matches_jax(case):
    """bf16 matmul operands on both sides, f32 LayerNorm, softmax and sums:
    the two round the products' outputs and bias adds at different points,
    so they agree to bf16 noise."""
    ids, mask, overrides = CASES[case]()
    cfg = JaxConfig(**TINY, **overrides, dtype="bfloat16")
    params = perturbed_params(cfg, seed=len(case))
    ref = np.asarray(esm2_forward(params, cfg, ids.astype(np.int32), mask.astype(np.int32)))
    model = port_model(params, cfg)
    assert model.encoder.layer[0].attention.self.query.weight.dtype == torch.bfloat16
    out = port_forward(model, ids, mask)
    assert out.dtype == np.float32
    real = mask.astype(bool)
    assert np.linalg.norm(out[real] - ref[real]) / np.linalg.norm(ref[real]) < 2e-2


def _perturbed_hf(seed: int = 0, **overrides):
    model, hf_cfg = tiny_hf_model(seed=seed, **overrides)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model, hf_cfg


@pytest.mark.parametrize("case", ["padded", "no_token_dropout"])
def test_forward_matches_hf(case):
    ids, mask, overrides = CASES[case]()
    model, hf_cfg = _perturbed_hf(seed=3, **overrides)
    ref = hf_reference_forward(model, ids, mask)
    port = E.ESM2(E.esm2_config_from_hf(hf_cfg))
    port.load_state_dict(E.encoder_state_dict(model.state_dict()))
    out = port_forward(port.eval(), ids, mask)
    real = mask.astype(bool)  # HF's pad rows are not zeroed through the encoder
    np.testing.assert_allclose(out[real], ref[real], **TOL)


def test_padding_has_no_effect():
    cfg = JaxConfig(**TINY)
    params = perturbed_params(cfg, seed=7)
    ids = np.random.RandomState(2).randint(4, 29, size=21)
    ids[4] = 32
    model = port_model(params, cfg)
    out = E.ESM2Encoder(model)(ids)
    assert out.shape == (21, cfg.hidden_size) and out.dtype == np.float32
    np.testing.assert_allclose(out, JaxESM2(params, cfg, bucket=64)(ids.astype(np.int32)), **TOL)
    padded = np.concatenate([ids, np.ones(11, np.int64)])[None]
    pad_mask = (np.arange(32) < 21)[None].astype(np.int64)
    np.testing.assert_allclose(port_forward(model, padded, pad_mask)[0, :21], out, **TOL)


def test_hf_state_dict_loads_by_name():
    model, hf_cfg = tiny_hf_model(seed=1)
    sd = model.state_dict()
    assert any(k.startswith("contact_head.") for k in sd)
    assert any(k.endswith("rotary_embeddings.inv_freq") for k in sd)
    port = E.ESM2(E.esm2_config_from_hf(hf_cfg))
    port.load_state_dict(E.encoder_state_dict(sd))  # strict: every encoder key, no other
    missing = E.encoder_state_dict(sd)
    del missing["encoder.layer.1.output.dense.bias"]
    with pytest.raises(RuntimeError, match="encoder.layer.1.output.dense.bias"):
        port.load_state_dict(missing)


@pytest.mark.parametrize("overrides", [dict(position_embedding_type="absolute"),
                                       dict(emb_layer_norm_before=True)],
                         ids=["absolute", "emb_layer_norm_before"])
def test_esm1b_style_config_rejected(overrides):
    from transformers import EsmConfig

    cfg = EsmConfig(vocab_size=33, hidden_size=48, num_hidden_layers=1, num_attention_heads=4,
                    intermediate_size=96, **{"position_embedding_type": "rotary", **overrides})
    with pytest.raises(ValueError, match="ESM-2 checkpoints only"):
        E.esm2_config_from_hf(cfg)


def write_tiny_esm(path, hidden: int = 48, seed: int = 9, **overrides):
    """A tiny random ESM-2 in the HF layout, as a checkpoint directory with
    a tokenizer of the ESM alphabet."""
    from transformers import EsmTokenizer

    from protein_redesign_tpu_torch.utils.esm import ESM_ALPHABET

    model, _ = _perturbed_hf(seed=seed, hidden_size=hidden, intermediate_size=2 * hidden,
                             **overrides)
    model.save_pretrained(path)
    (path / "vocab.txt").write_text("\n".join(ESM_ALPHABET) + "\n")
    EsmTokenizer(str(path / "vocab.txt")).save_pretrained(path)
    return path


def test_embedder_jax_backend_matches_the_jax_package(tmp_path):
    from protein_redesign_tpu.chem.protein import protein_from_sequence
    from protein_redesign_tpu.utils.esm import ESMEmbedder as JaxEmbedder
    from protein_redesign_tpu_torch.utils.esm import ESMEmbedder, _masked_len

    model_dir = str(write_tiny_esm(tmp_path / "esm_tiny"))
    ours = ESMEmbedder(model_name=model_dir, esm_dim=48, backend="jax", device="cpu")
    theirs = JaxEmbedder(model_name=model_dir, esm_dim=48, backend="jax")
    assert ours.available and theirs.available
    assert ours._encoder.device == torch.device("cpu")
    for seq in ("MKT<mask>LVA", "<mask><mask>GKL"):
        got = ours.embed_chain_masked(seq)
        assert got.shape == (_masked_len(seq), 48)
        np.testing.assert_allclose(got, theirs.embed_chain_masked(seq), **TOL)
    np.testing.assert_allclose(ours.embed_chain("MKTLVA"), theirs.embed_chain("MKTLVA"), **TOL)
    protein = protein_from_sequence("GMASKLXLEVAK")
    np.testing.assert_allclose(ours.embed_protein(protein), theirs.embed_protein(protein), **TOL)


def test_embedder_backends_agree(tmp_path):
    """The HF route (its tokenizer for ``embed_chain``, ids for
    ``embed_chain_masked``) and the package's own encoder, both on the
    embedder's device, give the same features."""
    from protein_redesign_tpu_torch.utils.esm import ESMEmbedder

    model_dir = str(write_tiny_esm(tmp_path / "esm_tiny", seed=4))
    hf, own = (ESMEmbedder(model_name=model_dir, esm_dim=48, backend=b, device="cpu")
               for b in ("torch", "jax"))
    assert hf.available and own.available
    np.testing.assert_allclose(hf.embed_chain("MKTLVAGH"), own.embed_chain("MKTLVAGH"), **TOL)
    np.testing.assert_allclose(hf.embed_chain_masked("MK<mask>TLV"),
                               own.embed_chain_masked("MK<mask>TLV"), **TOL)


def test_embedder_jax_backend_fallbacks(tmp_path, monkeypatch):
    """PRD_DISABLE_ESM gives zeros (``--require_esm`` raises on it); a
    wrong architecture propagates instead of turning into zeros."""
    from protein_redesign_tpu_torch.utils.esm import ESMEmbedder

    model_dir = str(write_tiny_esm(tmp_path / "esm1b", position_embedding_type="absolute"))
    with pytest.raises(ValueError, match="ESM-2 checkpoints only"):
        ESMEmbedder(model_name=model_dir, esm_dim=48, backend="jax").available
    monkeypatch.setenv("PRD_DISABLE_ESM", "1")
    zeros = ESMEmbedder(model_name=model_dir, esm_dim=48, backend="jax")
    assert not zeros.available
    assert not zeros.embed_chain_masked("MK<mask>").any()
    with pytest.raises(RuntimeError, match="PRD_DISABLE_ESM"):
        ESMEmbedder(model_name=model_dir, backend="jax", require=True).available


class _Built(Exception):
    pass


def _cli_argv(cli, tmp_path):
    from test_torch_generate import TINY as NET, _checkpoint

    _checkpoint(tmp_path / "ckpt")
    common = ["-c", str(tmp_path / "ckpt"), "-o", str(tmp_path / "out"), "--num_steps", "2"]
    if cli == "generate":
        return [*common, "-p", "GMASKLLEVAKRLG", "-l", "CCO", "-n", "1"], NET
    if cli == "serve":
        return common, NET
    fasta = tmp_path / "in.fasta"
    fasta.write_text(">a\nGMASKLLEVAKRLG\n")
    return [*common, "-p", str(fasta)], NET


@pytest.mark.parametrize("cli", ["generate", "serve", "predict_batch_sequence",
                                 "predict_batch_structure"])
@pytest.mark.parametrize("backend", ["torch", "jax"])
def test_cli_builds_its_embedder_on_the_device(cli, backend, tmp_path, monkeypatch):
    """The embedder gets ``--device`` and ``--esm_backend`` (the meta device
    here, so that the CLI's default device and the embedder's cannot pass
    for each other; the recorder stops the run when it is built)."""
    import importlib

    from protein_redesign_tpu_torch.utils import esm

    built = {}

    def record(**kw):
        built.update(kw)
        raise _Built

    monkeypatch.setattr(esm, "ESMEmbedder", record)
    argv, net_cfg = _cli_argv(cli, tmp_path)
    main = importlib.import_module(f"protein_redesign_tpu_torch.cli.{cli}").main
    with pytest.raises(_Built):
        main([*argv, "--device", "meta", "--esm_backend", backend])
    assert built["device"] == "meta" and built["backend"] == backend
    assert built["esm_dim"] == net_cfg.esm_dim
