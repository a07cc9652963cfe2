"""The fused-kernel configuration (``use_pallas_{trimul,transition,outer,
fused_gated}``) of the port against the JAX package on the CPU.

- Each plain version (``ops.transition``, ``ops.outer``, ``ops.trimul``,
  ``ops.attention.fused_gated_reference``) against its Pallas kernel in
  interpret mode and its reference math: 1e-5 in float32; in bfloat16 the
  port's plain version against the JAX reference math in bfloat16 at 3e-2
  relative norm (the two round at different places: the port as the kernel
  does, with f32 sums and biases, the JAX reference in bf16 throughout).
- The gradients of each autograd entry point against ``jax.grad`` through
  the JAX ``custom_vjp``: 1e-4 in float32.
- A 2-block net with the four switches against the JAX ``ProteinReDiffModel``
  with the same switches and ``use_pallas=True`` (so the JAX side engages
  its fused gated attention at tiny N): forward 1e-4, the loss's parameter
  gradients as ``test_torch_loss.py`` holds them.
- The parameter tree does not change with the switches; the generate and
  train CLIs run with them, and a checkpoint's switches survive a generate
  run that does not name them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_generate import ARGS, TINY  # noqa: E402
from test_torch_loss import jax_train_draws, key_for_policy  # noqa: E402
from test_torch_net import CFG, _flat, make_batch, perturbed_params  # noqa: E402
from test_torch_train_cli import TINY_FLAGS, mini_data  # noqa: E402,F401

from protein_redesign_tpu.models.prdiff import ProteinReDiffModel  # noqa: E402
from protein_redesign_tpu.ops import pallas_attention as JA  # noqa: E402
from protein_redesign_tpu.ops import pallas_outer as JO  # noqa: E402
from protein_redesign_tpu.ops import pallas_transition as JT  # noqa: E402
from protein_redesign_tpu.ops import pallas_trimul as JM  # noqa: E402
from protein_redesign_tpu.utils.convert import convert_state_dict  # noqa: E402
from protein_redesign_tpu_torch.models import prdiff as P  # noqa: E402
from protein_redesign_tpu_torch.ops import attention as A  # noqa: E402
from protein_redesign_tpu_torch.ops import outer as O  # noqa: E402
from protein_redesign_tpu_torch.ops import transition as T  # noqa: E402
from protein_redesign_tpu_torch.ops import trimul as M  # noqa: E402
from protein_redesign_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_REL = 3e-2
SWITCHES = dict(use_pallas_trimul=True, use_pallas_transition=True, use_pallas_outer=True,
                use_pallas_fused_gated=True)
FUSED_CFG = CFG.replace(**SWITCHES)


def _rng(seed):
    return np.random.RandomState(seed)


def _w(rng, out_dim, in_dim, scale=None):
    """A torch-layout [out, in] weight as f32 numpy."""
    scale = in_dim ** -0.5 if scale is None else scale
    return (rng.randn(out_dim, in_dim) * scale).astype(np.float32)


def _b(rng, n):
    return (0.3 * rng.randn(n)).astype(np.float32)


def _t(*arrays, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(a).to(dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [None if a is None else jnp.asarray(a, dtype) for a in arrays]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _mask(rng, B, N, masked_rows=0):
    mask = (rng.rand(B, N) > 0.2).astype(np.float32)
    mask2d = mask[:, :, None] * mask[:, None, :]
    mask2d[0, :masked_rows] = 0.0  # fully masked rows
    return mask2d


# K10 -------------------------------------------------------------------------


def _transition_case(with_b2, seed=0, M=24, D=16, Hd=64, Dout=16):
    rng = _rng(seed)
    x = (rng.randn(2, M // 2, D) * 2 + 0.5).astype(np.float32)
    return x, _w(rng, Hd, D), _b(rng, Hd), _w(rng, Dout, Hd), _b(rng, Dout) if with_b2 else None


@pytest.mark.parametrize("with_b2", [True, False], ids=["b2", "no_b2"])
def test_transition_matches_pallas(with_b2):
    x, w1, b1, w2, b2 = _transition_case(with_b2)
    got = T.transition(*_t(x, w1, b1, w2, b2)).numpy()
    jx, jw1, jb1, jw2, jb2 = _j(x, w1.T, b1, w2.T, b2)
    np.testing.assert_allclose(got, JT._fused_transition_impl(jx, jw1, jb1, jw2, jb2, True), **TOL)
    np.testing.assert_allclose(got, JT._reference_impl(jx, jw1, jb1, jw2, jb2), **TOL)


def test_transition_matches_pallas_at_single_dim_768():
    """single_fc at single_dim 768 (4 x 768 hidden), past the whole-row tile
    of transition.cu: the plain version against the Pallas kernel."""
    x, w1, b1, w2, b2 = _transition_case(True, seed=4, M=6, D=768, Hd=3072, Dout=768)
    got = T.transition(*_t(x, w1, b1, w2, b2)).numpy()
    jx, jw1, jb1, jw2, jb2 = _j(x, w1.T, b1, w2.T, b2)
    np.testing.assert_allclose(got, JT._fused_transition_impl(jx, jw1, jb1, jw2, jb2, True), **TOL)


def test_transition_bf16_near_reference():
    x, w1, b1, w2, b2 = _transition_case(True, seed=1)
    got = T.transition(*_t(x, dtype=torch.bfloat16), *_t(w1, b1, w2, b2))
    want = JT._reference_impl(*_j(x, dtype=jnp.bfloat16), *_j(w1.T, b1, w2.T, b2))
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), want.astype(jnp.float32)) < BF16_REL


# K11 -------------------------------------------------------------------------


def _outer_case(seed=0, B=2, N=12, S=16, D=8):
    rng = _rng(seed)
    x = (rng.randn(B, N, S) * 2 + 0.5).astype(np.float32)
    return x, _w(rng, D, 2 * S), _b(rng, D)


def test_outer_matches_pallas():
    x, w, b = _outer_case()
    got = O.outer(*_t(x, w, b)).numpy()
    jx, jw, jb = _j(x, w.T, b)
    np.testing.assert_allclose(got, JO._fused_outer_impl(jx, jw, jb, True), **TOL)
    np.testing.assert_allclose(got, JO._reference_impl(jx, jw, jb), **TOL)


def test_outer_bf16_near_reference():
    x, w, b = _outer_case(seed=1)
    got = O.outer(*_t(x, dtype=torch.bfloat16), *_t(w, b))
    want = JO._reference_impl(*_j(x, dtype=jnp.bfloat16), *_j(w.T, b))
    assert _rel(got.float(), want.astype(jnp.float32)) < BF16_REL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_outer_matches_pallas_at_paper_width(dtype):
    """K11 at the paper's single width 512 and pair width 64, the shape its
    tensor-core body takes on the main path, with a small B and N: in f32
    against the Pallas kernel in interpret mode (1e-5), in bf16 within
    BF16_REL of the JAX reference in bf16."""
    x, w, b = _outer_case(seed=2, B=2, N=10, S=512, D=64)
    jx, jw, jb = _j(x, w.T, b)
    if dtype == torch.float32:
        got = O.outer(*_t(x, w, b)).numpy()
        np.testing.assert_allclose(got, JO._fused_outer_impl(jx, jw, jb, True), **TOL)
    else:
        got = O.outer(*_t(x, dtype=torch.bfloat16), *_t(w, b))
        want = JO._reference_impl(*_j(x, dtype=jnp.bfloat16), jw, jb)
        assert got.shape == (2, 10, 10, 64)
        assert _rel(got.float(), want.astype(jnp.float32)) < BF16_REL


# K9 --------------------------------------------------------------------------


def _trimul_case(seed=0, B=2, N=16, D=8):
    rng = _rng(seed)
    pair = (rng.randn(B, N, N, D) * 2 + 0.5).astype(np.float32)
    ws = [_w(rng, 2 * D, D), _b(rng, 2 * D), _w(rng, 2 * D, D), _b(rng, 2 * D),
          _w(rng, D, D), _b(rng, D), _w(rng, D, D), _b(rng, D)]
    return pair, _mask(rng, B, N), ws


def _jax_trimul_params(ws):
    names = ("ab_gate", "ab_proj", "out_gate", "out_proj")
    params = {}
    for i, name in enumerate(names):
        params[f"{name}_kernel"] = jnp.asarray(ws[2 * i].T)
        params[f"{name}_bias"] = jnp.asarray(ws[2 * i + 1])
    return params


@pytest.mark.parametrize("mode", M.MODES)
def test_trimul_matches_pallas_over_several_tiles(mode):
    # N = 128: the Pallas kernel's 64-wide i, j and k tiles, 2 of each
    pair, mask2d, ws = _trimul_case(B=1, N=128)
    got = M.trimul(*_t(pair, mask2d, *ws), mode).numpy()
    jp, jm = _j(pair, mask2d)
    params = _jax_trimul_params(ws)
    np.testing.assert_allclose(got, JM.fused_triangle_multiply(jp, jm, params, mode, True), **TOL)
    np.testing.assert_allclose(got, JM._reference_impl(jp, jm, params, mode), **TOL)


@pytest.mark.parametrize("mode", M.MODES)
def test_trimul_bf16_near_reference(mode):
    pair, mask2d, ws = _trimul_case(seed=1)
    got = M.trimul(*_t(pair, dtype=torch.bfloat16), *_t(mask2d, *ws), mode)
    want = JM._reference_impl(*_j(pair, mask2d, dtype=jnp.bfloat16), _jax_trimul_params(ws), mode)
    assert _rel(got.float(), want.astype(jnp.float32)) < BF16_REL


# K8 --------------------------------------------------------------------------


def _gated_case(seed=0, B=2, N=12, D=8, H=2, C=4):
    rng = _rng(seed)
    x = (rng.randn(B, N, N, D) * 2 + 0.5).astype(np.float32)
    ws = [_w(rng, H * C, D) for _ in range(4)] + [_b(rng, H * C), _w(rng, D, H * C), _b(rng, D)]
    return x, _mask(rng, B, N, masked_rows=3), ws, H


def _jax_gated(x, mask2d, ws, H, fn):
    """The JAX function on the rows of x [B, N, N, D], weights in the flax layout."""
    B, N, _, D = x.shape
    wq, wk, wv, wg, bg, wo, bo = ws
    args = _j(wq.T, wk.T, wv.T, wg.T, bg, wo.T, bo)
    return np.asarray(fn(jnp.asarray(x.reshape(B * N, N, D)), jnp.asarray(mask2d.reshape(B * N, N)),
                         *args, H)).reshape(x.shape)


@pytest.mark.parametrize("view", ["starting", "ending"])
def test_fused_gated_matches_pallas(view):
    x, mask2d, ws, H = _gated_case()
    tx, tm = _t(x, mask2d)
    if view == "ending":  # the transposed view, as TriangleAttention hands it in
        tx, tm = tx.transpose(-2, -3), tm.transpose(-1, -2)
        x, mask2d = np.swapaxes(x, 1, 2).copy(), np.swapaxes(mask2d, 1, 2).copy()
    got = A.fused_gated(tx, tm, *_t(*ws), H).numpy()
    pallas = _jax_gated(x, mask2d, ws, H,
                        lambda *a: JA._fused_gated_impl(*a, True))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, _jax_gated(x, mask2d, ws, H, JA._fused_gated_reference), **TOL)


@pytest.mark.parametrize("view", ["starting", "ending"])
@pytest.mark.parametrize("H,C", [(1, 64), (4, 64)], ids=["h64x1", "h64x4"])
def test_fused_gated_matches_pallas_at_h64_layouts(view, H, C):
    """The h64 head layouts K8's tensor-core body takes (C = 64, one head or
    four), with fully masked rows, against the Pallas kernel."""
    x, mask2d, ws, _ = _gated_case(seed=5, N=10, D=16, H=H, C=C)
    tx, tm = _t(x, mask2d)
    if view == "ending":
        tx, tm = tx.transpose(-2, -3), tm.transpose(-1, -2)
        x, mask2d = np.swapaxes(x, 1, 2).copy(), np.swapaxes(mask2d, 1, 2).copy()
    got = A.fused_gated(tx, tm, *_t(*ws), H).numpy()
    pallas = _jax_gated(x, mask2d, ws, H, lambda *a: JA._fused_gated_impl(*a, True))
    np.testing.assert_allclose(got, pallas, **TOL)


def test_fused_gated_fully_masked_rows_attend_uniformly():
    x, mask2d, ws, H = _gated_case(seed=2)
    wq, wk, wv, wg, bg, wo, bo = _t(*ws)
    tx, tm = _t(x, mask2d)
    got = A.fused_gated(tx, tm, wq, wk, wv, wg, bg, wo, bo, H)
    # rows (b = 0, i < 3) mask every key: each query averages v over all keys
    xl = A.layer_norm_f32(tx[0, :3])
    v = (xl @ wv.t()).reshape(3, -1, H, wv.shape[0] // H).mean(1, keepdim=True)
    gate = torch.sigmoid(xl @ wg.t() + bg)
    want = (gate * v.reshape(3, 1, -1)) @ wo.t() + bo
    torch.testing.assert_close(got[0, :3], want, **TOL)


def test_fused_gated_bf16_near_reference():
    x, mask2d, ws, H = _gated_case(seed=1)
    got = A.fused_gated(*_t(x, dtype=torch.bfloat16), *_t(mask2d, *ws), H)
    B, N, _, D = x.shape
    wq, wk, wv, wg, bg, wo, bo = _j(ws[0].T, ws[1].T, ws[2].T, ws[3].T, ws[4], ws[5].T, ws[6])
    want = JA._fused_gated_reference(jnp.asarray(x.reshape(B * N, N, D), jnp.bfloat16),
                                     jnp.asarray(mask2d.reshape(B * N, N)),
                                     wq, wk, wv, wg, bg, wo, bo, H)
    assert _rel(got.float().reshape(B * N, N, D), want.astype(jnp.float32)) < BF16_REL


# gradients of the autograd entry points -------------------------------------


def _grad_case(name):
    """(port entry point, JAX custom_vjp function, numpy inputs, which
    inputs are torch-layout weights that the JAX side takes transposed,
    which inputs take a gradient: all but the masks)."""
    if name == "transition":
        x, w1, b1, w2, b2 = _transition_case(True, seed=3)
        return (T.fused_transition, lambda *a: JT.fused_transition(*a, True),
                [x, w1, b1, w2, b2], [False, True, False, True, False], [True] * 5)
    if name == "outer":
        x, w, b = _outer_case(seed=3)
        return (O.fused_outer_linear, lambda *a: JO.fused_outer_linear(*a, True),
                [x, w, b], [False, True, False], [True] * 3)
    if name == "trimul":
        pair, mask2d, ws = _trimul_case(seed=3)

        def jax_fn(p, m, *w):
            params = {}
            for i, layer in enumerate(("ab_gate", "ab_proj", "out_gate", "out_proj")):
                params[f"{layer}_kernel"], params[f"{layer}_bias"] = w[2 * i], w[2 * i + 1]
            return JM.triangle_multiply(p, m, params, "incoming")

        return (lambda p, m, *w: M.triangle_multiply(p, m, *w, "incoming"), jax_fn,
                [pair, mask2d, *ws], [False, False] + [True, False] * 4, [True, False] + [True] * 8)
    x, mask2d, ws, H = _gated_case(seed=3)
    B, N, _, D = x.shape
    return (lambda xx, mm, *w: A.fused_gated_rows_attention(xx, mm, *w, H),
            lambda xx, mm, *w: JA.fused_gated_rows_attention(xx, mm, *w, H, True),
            [x.reshape(B * N, N, D), mask2d.reshape(B * N, N), *ws],
            [False, False, True, True, True, True, False, True, False], [True, False] + [True] * 7)


@pytest.mark.parametrize("name", ["transition", "outer", "trimul", "fused_gated"])
def test_autograd_matches_jax_custom_vjp(name):
    port_fn, jax_fn, inputs, transposed, needs_grad = _grad_case(name)
    port_in = [torch.from_numpy(a).requires_grad_(g) for a, g in zip(inputs, needs_grad)]
    out = port_fn(*port_in)
    dout = _rng(9).randn(*out.shape).astype(np.float32)
    out.backward(torch.from_numpy(dout))
    jax_in = [jnp.asarray(a.T if t else a) for a, t in zip(inputs, transposed)]
    _, vjp = jax.vjp(jax_fn, *jax_in)
    j_grads = vjp(jnp.asarray(dout))
    for i, g in enumerate(needs_grad):
        if g:
            want = np.asarray(j_grads[i])
            np.testing.assert_allclose(port_in[i].grad.numpy(), want.T if transposed[i] else want,
                                       err_msg=f"input {i}", **GRAD_TOL)


# the net ---------------------------------------------------------------------


def test_fused_switches_keep_the_parameter_tree():
    batch = {k: jnp.asarray(v) for k, v in make_batch(B=1, seed=0).items()}
    shapes = [jax.eval_shape(ProteinReDiffModel(cfg).init_params, jax.random.PRNGKey(0), batch)
              for cfg in (CFG, FUSED_CFG)]
    assert shapes[0] == shapes[1]
    params = perturbed_params(FUSED_CFG, seed=4)
    sd = state_dict_from_jax(params, FUSED_CFG)
    net = P.ProteinReDiffNet(FUSED_CFG)
    net.load_state_dict(sd, strict=True)
    back = _flat(convert_state_dict({k: v.numpy() for k, v in net.state_dict().items()},
                                    FUSED_CFG))
    orig = _flat(params)
    assert back.keys() == orig.keys()
    for k in orig:
        np.testing.assert_array_equal(back[k], orig[k])


def test_net_with_fused_switches_matches_jax():
    batch = make_batch(B=2, seed=6)
    params = perturbed_params(FUSED_CFG, seed=6)
    rng = _rng(16)
    B, N = batch["residue_mask"].shape
    z = rng.randn(B, N, 3).astype(np.float32)
    seq_t = rng.randn(B, N, 21).astype(np.float32)
    mask = batch["atom_mask"] + batch["residue_mask"]
    t = rng.randint(0, FUSED_CFG.num_steps, (B,))
    j_noise, j_seq = ProteinReDiffModel(FUSED_CFG).apply(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(z),
        jnp.asarray(seq_t), jnp.asarray(mask), jnp.asarray(t, jnp.int32),
    )
    net = P.ProteinReDiffNet(FUSED_CFG)
    net.load_state_dict(state_dict_from_jax(params, FUSED_CFG))
    with torch.no_grad():
        noise, seq = net({k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(z),
                         torch.from_numpy(seq_t), torch.from_numpy(mask), torch.from_numpy(t))
    np.testing.assert_allclose(noise.numpy(), np.asarray(j_noise), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(seq.numpy(), np.asarray(j_seq), atol=1e-4, rtol=1e-4)


def test_loss_grads_with_fused_switches_match_jax():
    cfg = FUSED_CFG.replace(mask_prob=0.6, training_mode=True, remat=True)
    batch = make_batch(B=2, seed=7)
    params = perturbed_params(cfg, seed=7)
    key = key_for_policy("random")
    model = ProteinReDiffModel(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def mean_loss(p):
        per = model.loss(p, jb, key, training=True, reduction="none")[0]
        return per.mean(), per

    (_, j_per), j_grads = jax.jit(jax.value_and_grad(mean_loss, has_aux=True))(params)
    net = P.ProteinReDiffNet(cfg)
    net.load_state_dict(state_dict_from_jax(params, cfg))
    B, N = batch["residue_mask"].shape
    noise = jax_train_draws(key, B, N, cfg)
    per, _ = P.loss(net, {k: torch.from_numpy(v) for k, v in batch.items()}, reduction="none",
                    noise=noise)
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(j_per), atol=1e-4, rtol=1e-4)
    per.mean().backward()
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_grads), cfg)
    names = [name for name, _ in net.named_parameters()]
    total = np.sqrt(sum(np.sum(ref[name].numpy() ** 2) for name in names))
    for name, p in net.named_parameters():
        b = ref[name].numpy()
        err = np.linalg.norm(p.grad.numpy() - b)
        assert err <= 1e-4 * max(np.linalg.norm(b), 1e-3 * total), name


# the CLIs --------------------------------------------------------------------


def _count_fused_calls(monkeypatch):
    """Count calls of the four wrappers the autograd entry points dispatch to."""
    counts = {}
    for module, name in ((A, "fused_gated"), (M, "trimul"), (T, "transition"), (O, "outer")):
        real = getattr(module, name)

        def counted(*args, _real=real, _name=name):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*args)

        monkeypatch.setattr(module, name, counted)
    return counts


def _fused_checkpoint(path, cfg):
    from protein_redesign_tpu_torch.utils.weights import save_checkpoint

    torch.manual_seed(0)
    save_checkpoint(path, P.ProteinReDiffNet(cfg).state_dict(), cfg)


@pytest.mark.parametrize("where", ["flags", "checkpoint"])
def test_generate_runs_the_fused_configuration(tmp_path, monkeypatch, where):
    from protein_redesign_tpu_torch.cli.generate import main

    monkeypatch.setenv("PRD_DISABLE_ESM", "1")
    for name in ("USE_TF", "USE_FLAX"):
        monkeypatch.setenv(name, "0")
    counts = _count_fused_calls(monkeypatch)
    flags = [f"--{k}" for k in SWITCHES] if where == "flags" else []
    _fused_checkpoint(tmp_path / "ckpt", TINY if where == "flags" else TINY.replace(**SWITCHES))
    out = tmp_path / "out"
    main(["-c", str(tmp_path / "ckpt"), "-o", str(out), *ARGS, *flags])
    assert (out / "sample_ligand.sdf").read_text().count("$$$$") == 2
    # 4 steps x 2 batches of 1, 1 block: 2 of K8, K9 and K10 and 1 of K11 per forward
    assert counts == {"fused_gated": 16, "trimul": 16, "transition": 16, "outer": 8}


def test_kernel_switches_override_the_checkpoint_only_when_given():
    from argparse import ArgumentParser

    from protein_redesign_tpu_torch.cli.common import add_sampler_args, sampler_cfg_overrides

    parser = ArgumentParser()
    add_sampler_args(parser)
    assert not set(SWITCHES) & set(sampler_cfg_overrides(parser.parse_args([])))
    given = sampler_cfg_overrides(parser.parse_args(["--use_pallas_outer", "--use_pallas_bwd"]))
    assert given["use_pallas_outer"] is True and given["use_pallas_bwd"] is True
    assert "use_pallas_trimul" not in given


def test_generate_accepts_use_pallas_bwd_as_a_no_op(tmp_path, monkeypatch):
    from protein_redesign_tpu_torch.cli.generate import main

    monkeypatch.setenv("PRD_DISABLE_ESM", "1")
    for name in ("USE_TF", "USE_FLAX"):
        monkeypatch.setenv(name, "0")
    _fused_checkpoint(tmp_path / "ckpt", TINY)
    out = tmp_path / "out"
    main(["-c", str(tmp_path / "ckpt"), "-o", str(out), *ARGS, "--use_pallas_bwd"])
    assert (out / "sample_tmscores.txt").read_text().split()


def test_train_cli_runs_the_fused_configuration(mini_data, tmp_path, monkeypatch):  # noqa: F811
    from protein_redesign_tpu_torch.cli.train import main
    from protein_redesign_tpu_torch.utils.checkpoint import read_config

    counts = _count_fused_calls(monkeypatch)
    save_dir = tmp_path / "run"
    state = main(["--save_dir", str(save_dir), "--data_dir", str(mini_data), *TINY_FLAGS,
                  *[f"--{k}" for k in SWITCHES], "--val_every_steps", "0", "--max_steps", "2"])
    assert state.step == 2
    cfg = read_config(save_dir / "checkpoints" / "2")
    assert all(getattr(cfg, k) for k in SWITCHES)
    # remat recomputes each block in the backward: every wrapper ran more
    # than once per training forward
    assert set(counts) == {"fused_gated", "trimul", "transition", "outer"}
    assert counts["outer"] > 2
