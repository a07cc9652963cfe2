"""``seq_process="absorbing"`` in the port against the JAX package (Pallas
attention in interpret mode) at the tiny ``CFG`` of ``test_torch_net.py``:

- the absorbing loss per sample and its parameter gradients (the gate of
  ``test_torch_loss.py``), and the loss config checks;
- the DDPM sampler (T = 4) under every reveal control (linear, cosine,
  temperature, confidence noise) and the DDIM sampler at 1 step (eta 0) and
  4 steps (eta 1): positions in float32 at 1e-4, the reveal's commitments (mask and
  class) exactly. Before comparing, the JAX run asserts at every step that
  the top-two margin of the identity choice and the score gap at the
  commitment cutoff exceed 1e-3 (and, for the cosine schedule, that the
  commitment target is not within 1e-4 of an integer), so a near tie fails
  loudly instead of passing by luck;
- the JAX package's properties (`tests/test_absorbing.py`): every
  designable position is committed to a real class, user-``X`` positions
  included, and known residues are kept.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_loss import LOSS_CFG, key_for_policy  # noqa: E402
from test_torch_net import CFG, make_batch  # noqa: E402
from test_torch_selfcond import design_params, port_net, train_draws  # noqa: E402
from test_torch_seq_reverse import MASK_PROB, sampler_draws  # noqa: E402

from protein_redesign_tpu.models.prdiff import ProteinReDiffModel, ddim_tau_grid  # noqa: E402
from protein_redesign_tpu_torch.models import prdiff as P  # noqa: E402

ABS_CFG = CFG.replace(seq_process="absorbing")
MARGIN = 1e-3


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def check_reveal_margins(cfg, seq_pred, comm_mask, inv2, t_reveal, g_cls, g_conf):
    """The JAX step's decisions are well-posed: the identity's top-two gap,
    and the score gap at each row's commitment cutoff, exceed MARGIN."""
    seq_pred, comm_mask, inv2 = (np.asarray(a, np.float64) for a in (seq_pred, comm_mask, inv2))
    real = seq_pred[..., 1:]
    choice = real / cfg.reveal_temperature + np.asarray(g_cls) if cfg.reveal_temperature > 0 \
        else real
    cand = (inv2 > 0.5) & (comm_mask < 0.5)
    top2 = np.sort(choice, axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0])[cand].min(initial=np.inf) > MARGIN, "identity near tie"
    probs = np.exp(seq_pred - seq_pred.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    conf = np.take_along_axis(probs, np.argmax(choice, -1)[..., None] + 1, -1)[..., 0]
    score = -np.log(conf + 1e-9)
    frac = 1.0 - np.float32(t_reveal) / np.float32(cfg.num_steps)
    if cfg.reveal_schedule == "cosine":
        frac = 1.0 - np.cos(0.5 * np.pi * frac)
        target = inv2.sum(-1) * frac
        assert t_reveal == 0 or (np.abs(target - np.round(target)) > 1e-4).all(), target
    if cfg.reveal_conf_noise > 0:
        score = score - cfg.reveal_conf_noise * (t_reveal / cfg.num_steps) * np.asarray(g_conf)
    n_new = np.maximum(np.floor(inv2.sum(-1) * np.float32(frac)) - comm_mask.sum(-1), 0)
    for row in range(seq_pred.shape[0]):
        s = np.sort(score[row][cand[row]])
        k = int(n_new[row])
        if 0 < k < len(s):
            assert s[k] - s[k - 1] > MARGIN, ("rank near tie", row, s)


_APPLY = {}


def _net_apply(cfg):
    """The jitted JAX net for ``cfg``, one per net configuration (the reveal
    controls do not change the net)."""
    key = cfg.replace(reveal_schedule="linear", reveal_temperature=0.0, reveal_conf_noise=0.0)
    if key not in _APPLY:
        _APPLY[key] = jax.jit(ProteinReDiffModel(key).apply)
    return _APPLY[key]


def jax_absorbing_run(cfg, params, batch, key, mask_prob, ddim_steps=None, eta=0.0):
    """ProteinReDiffModel's absorbing sampler as sample_init, its jitted step
    function once per step and sample_finish (the pieces ``sample`` and
    ``sample_ddim`` compose), checking the reveal margins before each step
    on the net's output for that step's input."""
    model = ProteinReDiffModel(cfg)
    b, carry = model.sample_init(params, {k: jnp.asarray(v) for k, v in batch.items()}, key,
                                 mask_prob)
    seq_known, inv2 = model._absorbing_known_and_designable(b)
    mask = b["residue_and_atom_mask"]
    B = mask.shape[0]
    k_scan = jax.random.split(key, 4)[3]
    if ddim_steps is None:
        steps = cfg.num_steps
        step = model._absorbing_step_fn(params, b)
        taus = np.arange(steps - 1, -1, -1)
        inputs = [(jnp.int32(t), t) for t in taus]
    else:
        steps = ddim_steps
        step = model._ddim_absorbing_step_fn(params, b, eta)
        taus, prevs = (np.asarray(a) for a in ddim_tau_grid(cfg.num_steps, ddim_steps))
        inputs = [((jnp.int32(t), jnp.int32(p)), 0 if p < 0 else t) for t, p in zip(taus, prevs)]
    keys = jax.random.split(k_scan, steps)
    step, apply = jax.jit(step), _net_apply(cfg)
    for i, ((args, t_reveal), k) in enumerate(zip(inputs, keys)):
        z_sc, flag = carry[3:5] if cfg.self_cond else (None, None)
        _, seq_pred = apply(params, b, carry[0], seq_known + carry[2], mask,
                            jnp.full((B,), int(taus[i]), jnp.int32), z_sc, flag)
        _, kc, kg = jax.random.split(k, 3)
        check_reveal_margins(cfg, seq_pred, carry[1], inv2, int(t_reveal),
                             jax.random.gumbel(kc, (B, mask.shape[1], 20)),
                             jax.random.gumbel(kg, (B, mask.shape[1])))
        step_in = (*args, k) if isinstance(args, tuple) else (args, k)
        carry, _ = step(carry, step_in)
    return model.sample_finish(b, carry)


def port_run(cfg, net, batch, key, mask_prob, ddim_steps=None, eta=0.0):
    B, N = batch["residue_mask"].shape
    if ddim_steps is None:
        noise = sampler_draws(key, B, N, cfg.num_steps, cfg)
        return P.sample(net, _tb(batch), mask_prob, noise=noise)
    noise = sampler_draws(key, B, N, ddim_steps, cfg, "ddim")
    return P.sample_ddim(net, _tb(batch), ddim_steps, eta, mask_prob, noise=noise)


def assert_committed(batch, logits, mask_prob_inv):
    """Every designable residue (the inference mask's and every class-0
    one) decodes to a real class, and every known residue to its own."""
    logits = np.asarray(logits)
    res = batch["residue_mask"] > 0.5
    labels = batch["residue_type"]
    designable = res & ((mask_prob_inv > 0.5) | (labels == 0))
    pred = np.argmax(logits, -1)
    assert (pred[designable] > 0).all(), "an absorbed row reached the output"
    known = res & ~designable
    np.testing.assert_array_equal(pred[known], labels[known])
    np.testing.assert_array_equal(np.abs(logits[res]).max(-1), np.ones(res.sum()))


def test_absorbing_loss_and_grads_match_jax():
    from test_torch_selfcond import loss_matches_jax

    cfg = LOSS_CFG.replace(seq_process="absorbing")
    loss_matches_jax(cfg, key_for_policy("random"), seed=31)


def test_loss_config_checks():
    net = port_net(ABS_CFG, design_params(ABS_CFG))
    tb = _tb(make_batch(B=2))
    noise = train_draws(jax.random.PRNGKey(0), 2, 16, ABS_CFG)
    base, _ = P.loss(net, tb, noise=noise)
    net.cfg = ABS_CFG.replace(loss_mode="per_position")
    with pytest.warns(UserWarning, match="no effect under"):
        pp, _ = P.loss(net, tb, noise=noise)
    assert float(pp) == float(base)
    net.cfg = ABS_CFG.replace(seq_process="bogus")
    with pytest.raises(ValueError, match="seq_process"):
        P.loss(net, tb, noise=noise)


REVEALS = {
    "linear": {},
    "cosine": dict(reveal_schedule="cosine"),
    "temperature": dict(reveal_temperature=0.7),
    "conf_noise": dict(reveal_conf_noise=1.5),
}


@pytest.mark.parametrize("reveal", sorted(REVEALS))
def test_absorbing_ddpm_matches_jax(reveal):
    cfg = ABS_CFG.replace(**REVEALS[reveal])
    batch = make_batch(B=2, seed=32)
    params = design_params(cfg, seed=32, scale=0.1, seq_gain=4.0)
    key = jax.random.PRNGKey(33)
    j_pos, j_logits = jax_absorbing_run(cfg, params, batch, key, MASK_PROB)
    pos, logits = port_run(cfg, port_net(cfg, params), batch, key, MASK_PROB)
    np.testing.assert_array_equal(logits.numpy(), np.asarray(j_logits))
    np.testing.assert_allclose(pos.numpy(), np.asarray(j_pos), atol=1e-4, rtol=1e-4)
    prepared = P.prepare_batch(_tb(batch), MASK_PROB, sampler_draws(key, 2, 16, 1, cfg).mask_scores)
    assert_committed(batch, logits, prepared["residue_inv_extra_mask"].numpy())


@pytest.mark.parametrize("steps,eta", [(1, 0.0), (4, 1.0)])
def test_absorbing_ddim_matches_jax(steps, eta):
    """A one-step grid has no tau = 0 entry and still commits everything."""
    cfg = ABS_CFG.replace(num_steps=12)
    batch = make_batch(B=2, seed=34)
    params = design_params(cfg, seed=34, scale=0.1, seq_gain=4.0)
    key = jax.random.PRNGKey(35)
    j_pos, j_logits = jax_absorbing_run(cfg, params, batch, key, MASK_PROB, steps, eta)
    pos, logits = port_run(cfg, port_net(cfg, params), batch, key, MASK_PROB, steps, eta)
    np.testing.assert_array_equal(logits.numpy(), np.asarray(j_logits))
    np.testing.assert_allclose(pos.numpy(), np.asarray(j_pos), atol=1e-4, rtol=1e-4)
    prepared = P.prepare_batch(_tb(batch), MASK_PROB, sampler_draws(key, 2, 16, 1, cfg).mask_scores)
    assert_committed(batch, logits, prepared["residue_inv_extra_mask"].numpy())


@pytest.mark.parametrize("ddim", [False, True])
def test_user_x_positions_always_designed(ddim):
    """Residues of class 0 (a user's X) are designed even where the random
    inference mask skips them (mask_prob 0): never echoed as X."""
    batch = make_batch(B=2, seed=36)
    batch["residue_type"][:, 7:10] = 0
    net = port_net(ABS_CFG, design_params(ABS_CFG, seed=36, scale=0.1))
    gen = torch.Generator().manual_seed(3)
    if ddim:
        _, logits = P.sample_ddim(net, _tb(batch), 2, 0.0, 0.0, gen)
    else:
        _, logits = P.sample(net, _tb(batch), 0.0, gen)
    assert (np.argmax(logits.numpy()[:, 7:10], -1) > 0).all()
    assert_committed(batch, logits, np.zeros(batch["residue_mask"].shape, np.float32))


def test_reveal_temperature_varies_identities():
    """At a high temperature the committed class of a masked position
    varies across seeds (argmax would not)."""
    cfg = ABS_CFG.replace(reveal_temperature=5.0)
    net = port_net(cfg, design_params(cfg, seed=37, scale=0.1))
    tb = _tb(make_batch(B=2, seed=37))
    preds = [np.argmax(P.sample(net, tb, 1.0, torch.Generator().manual_seed(s))[1].numpy(), -1)
             for s in range(4)]
    stacked = np.stack(preds)[:, :, 5:14]
    assert (stacked.max(0) != stacked.min(0)).any()


def test_invalid_reveal_schedule_raises():
    net = port_net(ABS_CFG, design_params(ABS_CFG))
    net.cfg = ABS_CFG.replace(reveal_schedule="bogus")
    with pytest.raises(ValueError, match="reveal_schedule"):
        P.sample(net, _tb(make_batch(B=1)), MASK_PROB)
