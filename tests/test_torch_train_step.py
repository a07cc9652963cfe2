"""Three optimizer steps of the port's trainer against the JAX package's,
started from one state: the JAX ``TrainState`` (perturbed weights, an EMA
copy, Adam moments and counters part-way through warmup) is carried onto
the port by ``train_state_from_jax``. Two micro-batches per step, the clip
by global norm active, and the port's remat on (the JAX side runs without
it, which changes no number and compiles faster). Every draw of each micro-batch's loss comes
from the JAX step's keys (``test_torch_loss.jax_train_draws``).

Nonzero starting moments keep Adam's update away from m / sqrt(v) of a
gradient that is zero in exact arithmetic (a bias added to every logit of a
softmax), where rounding noise in either framework sets the sign.

Tolerances (float32): loss and grad_norm 1e-5 relative; parameters, EMA and
Adam's first moment 1e-5 absolute plus 1e-4 relative, the second moment
1e-4 relative (float32 sums in another order through 2 x 3 backward passes).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from test_torch_loss import LOSS_CFG, jax_train_draws  # noqa: E402
from test_torch_net import make_batch, perturbed_params  # noqa: E402

from protein_redesign_tpu.config import TrainConfig  # noqa: E402
from protein_redesign_tpu.models.prdiff import ProteinReDiffModel  # noqa: E402
from protein_redesign_tpu.parallel.train_step import (  # noqa: E402
    TrainState,
    make_optimizer,
    make_train_step as jax_train_step,
)
from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet  # noqa: E402
from protein_redesign_tpu_torch.parallel.train_step import (  # noqa: E402
    lr_at,
    make_train_state,
    make_train_step,
)
from protein_redesign_tpu_torch.utils.weights import (  # noqa: E402
    state_dict_from_jax,
    train_state_from_jax,
)

CFG = LOSS_CFG.replace(remat=True, warmup_steps=6, learning_rate=1e-3, ema_decay=0.99)
TRAIN_CFG = TrainConfig(accumulate_grad_batches=2, gradient_clip_norm=1.0)
START = 2  # steps already taken: mid-warmup


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _start_state():
    """A JAX TrainState at step START with perturbed weights and moments."""
    rng = np.random.RandomState(9)
    params = jax.tree_util.tree_map(jnp.asarray, perturbed_params(CFG, seed=7))
    noisy = lambda scale, f=lambda x: x: jax.tree_util.tree_map(  # noqa: E731
        lambda p: jnp.asarray(f(scale * rng.randn(*p.shape)), jnp.float32), params)
    clip, adam, sched = make_optimizer(CFG, TRAIN_CFG).init(params)
    adam = adam._replace(count=jnp.int32(START), mu=noisy(1e-2), nu=noisy(1e-2, np.square))
    return TrainState(
        step=jnp.int32(START), params=params,
        opt_state=(clip, adam, sched._replace(count=jnp.int32(START))),
        ema_params=jax.tree_util.tree_map(lambda p: p * 0.9, params),
        ema_updates=jnp.int32(START),
    )


def _adam(opt_state):
    return next(s for s in opt_state if isinstance(s, optax.ScaleByAdamState))


def test_three_accumulated_steps_match_jax():
    micro = [make_batch(B=2, seed=s) for s in (11, 12)]
    batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
    model = ProteinReDiffModel(CFG.replace(remat=False))  # remat changes no number
    j_state = _start_state()
    adam = _adam(j_state.opt_state)

    net = ProteinReDiffNet(CFG)
    state = make_train_state(net)
    train_state_from_jax(state, {
        "params": _tree(j_state.params), "ema_params": _tree(j_state.ema_params),
        "mu": _tree(adam.mu), "nu": _tree(adam.nu), "count": int(adam.count),
        "step": int(j_state.step), "ema_updates": int(j_state.ema_updates),
    })
    assert state.step == START and lr_at(0, CFG, TRAIN_CFG) == pytest.approx(1e-3 / 6)

    j_step = jax.jit(jax_train_step(model, TRAIN_CFG))
    step = make_train_step(TRAIN_CFG)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tmicro = [{k: torch.from_numpy(v) for k, v in m.items()} for m in micro]
    B, N = micro[0]["residue_mask"].shape
    for i in range(3):
        key = jax.random.PRNGKey(100 + i)
        j_state, j_metrics = j_step(j_state, jb, key)
        noises = [jax_train_draws(k, B, N, CFG) for k in jax.random.split(key, 2)]
        metrics = step(state, tmicro, noises)
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[name]), float(j_metrics[name]), rtol=1e-5,
                                       err_msg=f"step {i} {name}")
        assert float(j_metrics["grad_norm"]) > TRAIN_CFG.gradient_clip_norm  # the clip acts

    assert state.step == int(j_state.step) == START + 3
    assert state.ema_updates == int(j_state.ema_updates)
    adam = _adam(j_state.opt_state)
    expected = {
        "params": state_dict_from_jax(_tree(j_state.params), CFG),
        "ema": state_dict_from_jax(_tree(j_state.ema_params), CFG),
        "mu": state_dict_from_jax(_tree(adam.mu), CFG),
        "nu": state_dict_from_jax(_tree(adam.nu), CFG),
    }
    for name, p in net.named_parameters():
        opt = state.optimizer.state[p]
        assert int(opt["step"]) == int(adam.count)
        got = {"params": p, "ema": dict(state.ema.named_parameters())[name],
               "mu": opt["exp_avg"], "nu": opt["exp_avg_sq"]}
        for what, tensor in got.items():
            atol = 0.0 if what == "nu" else 1e-5
            np.testing.assert_allclose(tensor.detach().numpy(), expected[what][name].numpy(),
                                       atol=atol, rtol=1e-4, err_msg=f"{what} {name}")
