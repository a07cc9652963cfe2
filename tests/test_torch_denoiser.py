"""The port's denoiser modules against ``protein_redesign_tpu/models/denoiser.py``
with perturbed weights (every parameter gets seeded noise, so no
zero-initialised layer hides a fault). The JAX side runs its Pallas
attention kernels in interpret mode. Tolerance 1e-4 in float32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_layers import TRANSITION, flax_to_torch, perturbed_init  # noqa: E402

from protein_redesign_tpu.config import ModelConfig  # noqa: E402
from protein_redesign_tpu.models import denoiser as J  # noqa: E402
from protein_redesign_tpu_torch.models import denoiser as T  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
B, N, S, P, H, C = 2, 12, 16, 8, 2, 4
CFG = ModelConfig(
    single_dim=S, pair_dim=P, head_dim=C, num_heads=H, num_blocks=2, esm_dim=8,
    time_dim=8, dist_dim=8, dtype="float32", remat=False, use_pallas=True,
)
SPA = {"z_norm": "linear_z.0", "linear_z": "linear_z.1",
       **{f"linear_{n}": f"mha.linear_{n}" for n in "qkvgo"}}
BLOCK = {**TRANSITION, "attn_bias_proj": "attn_bias.1"}
DENOISER = {**SPA, **BLOCK, "spa_attn": "SPAAttnBlock",
            **{f"folding_blocks_{i}": f"folding_blocks.{i}" for i in range(CFG.num_blocks)}}


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    single = rng.randn(B, N, S).astype(np.float32)
    pair = rng.randn(B, N, N, P).astype(np.float32)
    mask = np.ones((B, N), np.float32)
    mask[0, 9:] = 0.0
    mask[1, 7:] = 0.0
    return single, pair, mask


def _check(jmod, tmod, rename, jargs, targs, seed=0, tol=TOL):
    params = perturbed_init(jmod, *map(jnp.asarray, jargs), seed=seed)
    ref = jmod.apply({"params": params}, *map(jnp.asarray, jargs))
    tmod.load_state_dict(flax_to_torch(params, rename))
    with torch.no_grad():
        out = tmod(*(torch.from_numpy(a) for a in targs))
    if not isinstance(out, tuple):
        out, ref = (out,), (ref,)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **tol)


def test_sp_attention():
    single, pair, mask = _inputs()
    _check(J.SPAttention(S, P, H, use_pallas=True), T.SPAttention(S, P, H), SPA,
           (single, pair, mask), (single, pair, mask))


@pytest.mark.parametrize("factored", [False, True], ids=["plain", "factored"])
def test_outer_product_update(factored):
    single, _, mask = _inputs(1)
    _check(J.OuterProductUpdate(P, S // 4, factored=factored),
           T.OuterProductUpdate(S, P, S // 4, factored=factored), {},
           (single, mask), (single, mask))


@pytest.mark.parametrize("factored", [False, True], ids=["plain", "factored"])
def test_outer_linear(factored):
    single, _, _ = _inputs(2)
    _check(J.OuterLinear(P, factored=factored), T.OuterLinear(S, P, factored=factored), {},
           (single,), (single,))


@pytest.mark.parametrize("mode", ["outgoing", "incoming"])
def test_triangle_multiplication(mode):
    _, pair, mask = _inputs(3)
    mask_2d = mask[:, :, None] * mask[:, None, :]
    _check(J.TriangleMultiplication(mode), T.TriangleMultiplication(P, mode), {},
           (pair, mask_2d), (pair, mask_2d))


@pytest.mark.parametrize("mode", ["outgoing", "incoming"])
def test_triangle_multiplication_dmajor(mode):
    """``dmajor`` (``--trimul_dmajor``): the channel-major contraction."""
    _, pair, mask = _inputs(3)
    mask_2d = mask[:, :, None] * mask[:, None, :]
    _check(J.TriangleMultiplication(mode, dmajor=True),
           T.TriangleMultiplication(P, mode, dmajor=True), {}, (pair, mask_2d), (pair, mask_2d),
           tol=dict(atol=1e-5, rtol=1e-5))


@pytest.mark.parametrize("mode", ["starting", "ending"])
def test_triangle_attention(mode):
    _, pair, mask = _inputs(4)
    mask_2d = mask[:, :, None] * mask[:, None, :]
    _check(J.TriangleAttention(C, H, mode, use_pallas=True), T.TriangleAttention(P, C, H, mode),
           {}, (pair, mask_2d), (pair, mask_2d))


def test_folding_block():
    single, pair, mask = _inputs(5)
    jmod = J.FoldingBlock(S, P, C, H, CFG.transition_factor, use_pallas=True,
                          outer_factored=CFG.outer_factored)
    _check(jmod, T.FoldingBlock(CFG, torch.float32), BLOCK,
           (single, pair, mask), (single, pair, mask))


def test_denoiser():
    single, pair, mask = _inputs(6)
    _check(J.Denoiser(CFG), T.Denoiser(CFG), DENOISER,
           (single, pair, mask), (single, pair, mask))


def test_denoiser_trimul_dmajor():
    """The 2-block trunk with ``trimul_dmajor``: both triangle
    multiplications of every block contract channel-major, at 1e-5."""
    single, pair, mask = _inputs(9)
    cfg = CFG.replace(trimul_dmajor=True)
    mod = T.Denoiser(cfg)
    trimuls = [m for m in mod.modules() if isinstance(m, T.TriangleMultiplication)]
    assert len(trimuls) == 2 * cfg.num_blocks and all(m.dmajor for m in trimuls)
    _check(J.Denoiser(cfg), mod, DENOISER, (single, pair, mask), (single, pair, mask),
           tol=dict(atol=1e-5, rtol=1e-5))


def test_denoiser_bf16():
    """The bf16 dtype flow (casts, f32 promotions of the pair stream, f32
    logits) against JAX's. The two round at different points (fused
    bias adds, sigmoid, LayerNorm statistics), so they agree to bf16
    noise: the JAX bf16 Denoiser is itself ~1% (relative norm) from its
    f32 one here; tolerance 2e-2 relative norm."""
    single, pair, mask = _inputs(8)
    cfg = CFG.replace(dtype="bfloat16", use_pallas=False)  # kernels: test_denoiser
    jargs = tuple(map(jnp.asarray, (single, pair, mask)))
    params = perturbed_init(J.Denoiser(cfg.replace(dtype="float32")), *jargs, seed=8)
    ref = J.Denoiser(cfg).apply({"params": params}, *jargs)
    mod = T.Denoiser(cfg)
    mod.load_state_dict(flax_to_torch(params, DENOISER))
    with torch.no_grad():
        out = mod(*(torch.from_numpy(a) for a in (single, pair, mask)))
    for o, r in zip(out, ref):
        assert o.dtype == torch.bfloat16
        o, r = o.float().numpy(), np.asarray(r, np.float32)
        assert np.linalg.norm(o - r) / np.linalg.norm(r) < 2e-2


def test_denoiser_routes_every_attention_to_the_kernel_wrappers(monkeypatch):
    """Per forward: 2 rows-kernel calls per block (triangle attention), one
    tiled-kernel call per block (single attention) plus one (SPAttention);
    ``plain_route()`` bypasses both."""
    from protein_redesign_tpu_torch.ops import attention as A

    calls = {"rows": 0, "tiled": 0}
    rows, tiled = A.rows_attention, A.tiled_attention

    def count(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(A, "rows_attention", count("rows", rows))
    monkeypatch.setattr(A, "tiled_attention", count("tiled", tiled))
    single, pair, mask = (torch.from_numpy(a) for a in _inputs(7))
    mod = T.Denoiser(CFG)
    with torch.no_grad():
        kernel_route = mod(single, pair, mask)
        assert calls == {"rows": 2 * CFG.num_blocks, "tiled": CFG.num_blocks + 1}
        with A.plain_route():
            plain = mod(single, pair, mask)
        assert calls == {"rows": 2 * CFG.num_blocks, "tiled": CFG.num_blocks + 1}
    for a, b in zip(kernel_route, plain):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
