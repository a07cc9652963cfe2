"""The port's ``ProteinReDiffModel`` facade and the two geometry helpers it
completes, on the CPU at tiny widths:

- each facade method equals the free function it wraps, bit for bit;
- ``inference_extra_mask`` equals the masks that ``sample``, ``sample_ddim``
  and ``paratime.sample_ddim_parallel`` draw first from an identically
  seeded generator;
- with weights carried across by ``state_dict_from_jax`` and the JAX draws
  redone from its keys (as ``test_torch_sampler.py`` and
  ``test_torch_loss.py`` do), the facade's ``sample`` and ``loss`` match
  JAX's ``ProteinReDiffModel`` within 1e-4 (float32; XLA attention on the
  JAX side, whose Pallas kernels ``test_torch_net.py`` already holds);
- ``nearest_bin`` and ``pseudo_beta`` match JAX's: the bin indices exactly
  (a tie takes the lower bin), the virtual C-beta to 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_loss import LOSS_CFG, jax_train_draws  # noqa: E402
from test_torch_net import CFG, make_batch, perturbed_params  # noqa: E402
from test_torch_sampler import MASK_PROB, jax_draws  # noqa: E402

from protein_redesign_tpu.models.prdiff import ProteinReDiffModel as JaxModel  # noqa: E402
from protein_redesign_tpu.ops import geometry as jax_geometry  # noqa: E402
from protein_redesign_tpu_torch.models import paratime  # noqa: E402
from protein_redesign_tpu_torch.models import prdiff as P  # noqa: E402
from protein_redesign_tpu_torch.ops import geometry  # noqa: E402
from protein_redesign_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

XLA_CFG = CFG.replace(use_pallas=False)
ONE_BLOCK = dict(num_blocks=1)  # the JAX comparisons: one block keeps its compiles short


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: at these sizes the test suite's parallel workers
    would otherwise oversubscribe the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(B=2, seed=3):
    return {k: torch.from_numpy(v) for k, v in make_batch(B=B, seed=seed).items()}


def _model(cfg=XLA_CFG, seed=0):
    model = P.ProteinReDiffModel(cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(seed))
    return model


def _equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def g(seed):
    return torch.Generator().manual_seed(seed)


def test_holds_cfg_net_and_schedule_on_its_device():
    model = _model()
    assert model.cfg is XLA_CFG and model.device == torch.device("cpu")
    assert isinstance(model.net, P.ProteinReDiffNet)
    assert model.schedule is P.schedule_on(XLA_CFG.num_steps, XLA_CFG.diffusion_schedule, "cpu")


def test_init_params_is_seeded_and_load_params_takes_both_formats():
    a, b, c = _model(seed=1), _model(seed=1), _model(seed=2)
    _equal(a.net.state_dict(), b.net.state_dict())
    assert not torch.equal(a.net.state_dict()["seq_mlp.1.weight"],
                           c.net.state_dict()["seq_mlp.1.weight"])
    c.load_params(a.net.state_dict())
    _equal(c.net.state_dict(), a.net.state_dict())
    params = perturbed_params(XLA_CFG, seed=4)
    c.load_params(params)
    _equal(c.net.state_dict(), state_dict_from_jax(params, XLA_CFG))


def test_methods_equal_the_free_functions():
    model = _model(cfg=XLA_CFG.replace(mask_prob=0.5))
    cfg, net, sched = model.cfg, model.net, model.schedule
    batch = _batch()
    prep = model.prepare_batch(batch, g(1))
    _equal(prep, P.prepare_batch(batch, cfg.mask_prob, None, g(1), cfg.training_mode))
    _equal(model.prepare_batch(batch, g(1), training=True, mask_prob=0.6),
           P.prepare_batch(batch, 0.6, None, g(1), True))
    x, mask = prep["x"], prep["residue_and_atom_mask"]
    B, N = mask.shape
    t = torch.tensor([1, 3])
    nz, ns = torch.randn(B, N, 3, generator=g(2)), torch.randn(B, N, 21, generator=g(3))
    _equal(model.q(x, prep["residue_one_hot"], t, nz, ns, prep),
           P.q_sample(sched, x, prep["residue_one_hot"], t, nz, ns, prep))
    z_t, seq_t = model.q(x, prep["residue_one_hot"], t, nz, ns, prep)[:2]
    with torch.no_grad():
        _equal(model.apply(prep, z_t, seq_t, mask, t), net(prep, z_t, seq_t, mask, t))
        given = P.TrainNoise(noise_z=nz, noise_seq=ns)
        _equal(model.diffusion_loss(prep, x, mask, t, noise=given),
               P.diffusion_loss(net, sched, prep, x, mask, t, nz, ns))
        drawn = g(4)
        nz, ns = torch.randn(B, N, 3, generator=drawn), torch.randn(B, N, 21, generator=drawn)
        _equal(model.diffusion_loss(prep, x, mask, t, g(4)),
               P.diffusion_loss(net, sched, prep, x, mask, t, nz, ns))
        _equal(model.loss(batch, g(5), reduction="none"), P.loss(net, batch, "none", None, g(5)))
    _equal(model.sample(batch, g(6)), P.sample(net, batch, None, g(6)))
    _equal(model.sample_ddim(batch, g(7), ddim_steps=2, eta=1.0),
           P.sample_ddim(net, batch, 2, 1.0, None, g(7)))
    init = model.sample_init(batch, g(8), mask_prob=0.7)
    _equal(init, P.sample_init(cfg, batch, 0.7, g(8)))
    _equal(model.sample_finish(*init), P.sample_finish(cfg, *init))


def test_inference_extra_mask_is_the_samplers_first_draw(monkeypatch):
    cfg = XLA_CFG.replace(mask_prob=0.5)
    model = _model(cfg)
    batch = _batch()
    drawn = []

    def spy(*args, **kwargs):
        out = prepare(*args, **kwargs)
        drawn.append((out["residue_extra_mask"], out["residue_inv_extra_mask"]))
        return out

    prepare = P.prepare_batch
    monkeypatch.setattr(P, "prepare_batch", spy)
    model.sample(batch, g(11))
    model.sample_ddim(batch, g(11), ddim_steps=2)
    paratime.sample_ddim_parallel(model.net, batch, ddim_steps=2, window=2, generator=g(11))
    want = model.inference_extra_mask(batch["residue_mask"], generator=g(11))
    assert 0 < float(want[1].sum()) < float(batch["residue_mask"].sum())
    assert len(drawn) == 3
    for masks in drawn:
        _equal(masks, want)
    other = model.inference_extra_mask(batch["residue_mask"], 0.2, g(11))
    assert float(other[1].sum()) < float(want[1].sum())


def test_sample_matches_jax():
    cfg = XLA_CFG.replace(**ONE_BLOCK)
    batch = make_batch(B=2, seed=3)
    params = perturbed_params(cfg, seed=3, scale=0.1)
    key = jax.random.PRNGKey(7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_pos, j_logits = jax.jit(lambda p: JaxModel(cfg).sample(p, dict(jb), key,
                                                           mask_prob=MASK_PROB))(params)

    model = P.ProteinReDiffModel(cfg, device="cpu")
    model.load_params(params)
    B, N = batch["residue_mask"].shape
    noise = jax_draws(key, B, N, cfg.num_steps)
    pos, logits = model.sample(_batch(seed=3), mask_prob=MASK_PROB, noise=noise)
    np.testing.assert_allclose(pos.numpy(), np.asarray(j_pos), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=1e-4, rtol=1e-4)


def test_loss_matches_jax():
    cfg = LOSS_CFG.replace(**ONE_BLOCK)
    batch = make_batch(B=2, seed=5)
    params = perturbed_params(cfg, seed=5)
    key = jax.random.PRNGKey(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_per = jax.jit(lambda p: JaxModel(cfg).loss(p, jb, key, training=True,
                                                 reduction="none")[0])(params)

    model = P.ProteinReDiffModel(cfg, device="cpu")
    model.load_params(params)
    B, N = batch["residue_mask"].shape
    noise = jax_train_draws(key, B, N, cfg)
    with torch.no_grad():
        per, _ = model.loss(_batch(seed=5), reduction="none", noise=noise)
        mean, metrics = model.loss(_batch(seed=5), noise=noise)
    np.testing.assert_allclose(per.numpy(), np.asarray(j_per), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(mean, per.mean())
    assert metrics["loss"] is mean


@pytest.mark.parametrize("bins,lo,hi", [(2, 0.0, 1.0), (4, 0.0, 1.0), (64, 2.0, 22.0),
                                        (39, 3.25, 50.75)])
def test_nearest_bin_matches_jax(bins, lo, hi):
    rng = np.random.RandomState(bins)
    x = rng.uniform(lo - 1.0, hi + 1.0, (3, 50)).astype(np.float32)
    if bins in (2, 4):  # exact midpoints between exact centres: ties take the lower bin
        x[0, :3] = [0.5, 0.25, 0.75] if bins == 4 else [0.5, 0.5, 0.5]
    got = geometry.nearest_bin(torch.from_numpy(x), bins, lo, hi).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_geometry.nearest_bin(jnp.asarray(x), bins,
                                                                           lo, hi)))
    if bins == 4:
        np.testing.assert_array_equal(got[0, :3], [1, 0, 2])
    if bins == 2:
        np.testing.assert_array_equal(got[0, :3], [0, 0, 0])


def test_pseudo_beta_matches_jax():
    rng = np.random.RandomState(0)
    pos = rng.randn(2, 7, 37, 3).astype(np.float32) * 2.0
    mask = (rng.rand(2, 7, 37) > 0.2).astype(np.float32)
    cb, cb_mask = geometry.pseudo_beta(torch.from_numpy(pos), torch.from_numpy(mask))
    j_cb, j_mask = jax_geometry.pseudo_beta(jnp.asarray(pos), jnp.asarray(mask))
    np.testing.assert_allclose(cb.numpy(), np.asarray(j_cb), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(cb_mask.numpy(), np.asarray(j_mask))
    assert 0 < cb_mask.sum() < cb_mask.numel()
