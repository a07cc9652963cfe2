"""Parallel-in-time DDIM sampling: sliding-window Picard iteration (port of
``protein_redesign_tpu/models/paratime.py``, single device).

With ``a_i = alphas_cumprod[tau_i]``, ``y_i = z_i / sqrt(a_i)`` and
``gamma_i = sqrt((1 - a_i) / a_i)``, the deterministic (eta = 0) DDIM
coordinate update is the explicit sum

    y_{i+1} = y_i + (gamma_{i+1} - gamma_i) * eps(z_i, seq_i, tau_i),

and the sequence follows the reference's recurrence
``seq_{i+1} = softmax(seq_pred_i) * 2 - 1``. A window of W candidate
states is evaluated by one ``ProteinReDiffNet`` call at batch W * B (the
window folded into the batch, t holding each member's tau); the trajectory
is rebuilt by a cumulative sum of drift increments from the converged
start, and the window slides past every point whose masked mean-square
change in z- and sequence-space is at most tol^2. The entry right after
the window start is recomputed from a converged state, so it is exact after
at most two visits: tol = 0 terminates and gives the sequential DDIM
trajectory, up to the reordering of its arithmetic. The loop runs on the
host and reads one integer from the device per sweep, the leading run of
converged points; it stops at the JAX package's cap of 2S + 2 sweeps and
then returns its stats as they are.

The draws are ``sample_ddim``'s: ``sample_init`` with the same generator or
``SamplerNoise`` (``mask_scores``, ``z0``, ``s0``); Picard draws nothing
per step. The JAX ``mesh`` argument (the window sharded over devices) is
the net itself here: given a ``parallel.mesh.ReplicatedNet``, each sweep's
call at W * B window-major rows is split in contiguous blocks over its
replicas, so a window that is a multiple of the replicas splits by window
member (a warning otherwise, as JAX's ``_window_sharding``).
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..ops.geometry import nanometre_to_angstrom
from .diffusion import get_betas
from .prdiff import (
    Batch,
    ProteinReDiffNet,
    SamplerNoise,
    StepNoise,
    absorbing_known_and_designable,
    ddim_taus,
    reveal_update,
    sample_init,
)

Stats = Dict[str, int]


def ddim_time_tables(cfg: ModelConfig, S: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side numpy tables of both Picard samplers
    (``_ddim_time_tables``, `paratime.py:49-66`): (taus [S], a [S + 1] f64
    with the x0 endpoint's 1 appended, gamma [S + 1] f32), from the
    schedule's own numpy source; the f32 round trip gives the stored
    ``alphas_cumprod`` values exactly."""
    taus = ddim_taus(cfg.num_steps, S)
    acp = np.cumprod(1.0 - get_betas(cfg.num_steps, cfg.diffusion_schedule)).astype(np.float32)
    a = np.concatenate([acp[taus], [1.0]]).astype(np.float64)
    gamma = np.sqrt((1.0 - a) / a).astype(np.float32)
    return taus, a, gamma


def check_picard_config(cfg: ModelConfig, window: int, ddim_steps: int,
                        coarse_init: int = 0) -> None:
    """The JAX sampler's rejections, in its order and wording
    (`paratime.py:126-177`)."""
    if int(window) < 1:
        raise ValueError(
            f"window must be >= 1, got {window} (an empty Picard window "
            "evaluates nothing and would return the init noise)"
        )
    if int(ddim_steps) < 1:
        raise ValueError(f"ddim_steps must be >= 1, got {ddim_steps}")
    if cfg.seq_reverse != "reference":
        raise NotImplementedError(
            "ddim_parallel implements the reference sequence recurrence; "
            "seq_reverse='ancestral' is only available on the sequential "
            "samplers (model.sample / model.sample_ddim)"
        )
    if cfg.self_cond:
        raise NotImplementedError(
            "ddim_parallel cannot run with self_cond: self-conditioning "
            "threads the previous step's x0-hat through the scan carry, "
            "which makes each step's denoiser input depend on the "
            "sequential predecessor — the Picard window's step map must "
            "be a function of (z_t, t) alone. Sample self-conditioned "
            "checkpoints with model.sample / model.sample_ddim"
        )
    if cfg.seq_process == "absorbing":
        if cfg.reveal_temperature > 0.0 or cfg.reveal_conf_noise > 0.0:
            raise NotImplementedError(
                "ddim_parallel with seq_process='absorbing' requires the "
                "deterministic reveal (reveal_temperature=0, "
                "reveal_conf_noise=0): the Picard fixed point is only "
                "well-defined for a deterministic step map"
            )
        if coarse_init > 0:
            raise NotImplementedError(
                "coarse_init warm starts are implemented for the gaussian "
                "sequence channel (extending a coarse commitment "
                "trajectory to fine indices has no exact analogue)"
            )


def warn_uneven_window(net, W: int) -> None:
    """JAX's warning (`paratime.py:68-85`) when a replicated net's data axis
    does not divide the window."""
    d = len(getattr(net, "devices", ()))
    if d > 1 and W % d:
        warnings.warn(
            f"ddim_parallel window={W} is not a multiple of the mesh data axis ({d}); the "
            f"window shards unevenly and per-sweep latency matches the next multiple "
            f"({-(-W // d) * d}) — pick window as a multiple of the chip count.")


class _Window:
    """The pieces both Picard loops share: the time tables on the device,
    the prepared batch expanded once to the window's W * B rows, one net
    call per sweep, and the convergence test."""

    def __init__(self, net: ProteinReDiffNet, batch: Batch, S: int, W: int, tol: float):
        cfg = net.cfg
        warn_uneven_window(net, W)
        self.net, self.S, self.W = net, S, W
        x = batch["x"]
        self.B = x.shape[0]
        device = x.device
        self.taus_np, a_np, gamma_np = ddim_time_tables(cfg, S)
        self.gamma_np = gamma_np
        self.taus = torch.as_tensor(self.taus_np, dtype=torch.long, device=device)
        gamma = torch.as_tensor(gamma_np, device=device)
        self.dgamma = gamma[1:] - gamma[:-1]                                          # [S]
        self.sqrt_a = torch.as_tensor(np.sqrt(a_np), dtype=torch.float32, device=device)  # [S+1]
        self.mask = batch["residue_and_atom_mask"]
        self.residue_mask = batch["residue_mask"]
        self.mask_sum = torch.clamp(self.mask.sum(), min=1.0)
        self.rmask_sum = torch.clamp(self.residue_mask.sum(), min=1.0)
        self.tol2 = torch.tensor(tol, dtype=torch.float32, device=device) ** 2
        rows = lambda v: v.repeat((W,) + (1,) * (v.dim() - 1))  # noqa: E731  window-major
        self.batch_w = {k: rows(v) if torch.is_tensor(v) and v.dim() and v.shape[0] == self.B
                        else v for k, v in batch.items()}
        self.mask_w = rows(self.mask)

    def indices(self, s: int) -> Tuple[np.ndarray, np.ndarray, torch.Tensor, torch.Tensor]:
        """(window indices, valid, indices clipped to S - 1 on the device,
        valid as floats [W, 1, 1, 1] on the device) of the sweep from s."""
        idx = s + np.arange(self.W)
        valid = idx <= self.S - 1
        idx_c = torch.as_tensor(np.minimum(idx, self.S - 1), device=self.mask.device)
        vmaskf = torch.as_tensor(valid.astype(np.float32), device=self.mask.device)
        return idx, valid, idx_c, vmaskf[:, None, None, None]

    def evaluate(self, zs: torch.Tensor, seqs: torch.Tensor,
                 idx_c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One net call at batch W * B: member w at tau[idx_c[w]]."""
        W, B = self.W, self.B
        t = self.taus[idx_c].repeat_interleave(B)
        eps, seqp = self.net(self.batch_w, zs.flatten(0, 1), seqs.flatten(0, 1), self.mask_w, t)
        return eps.reshape((W, B) + eps.shape[1:]), seqp.reshape((W, B) + seqp.shape[1:])

    def y_rebuild(self, y_start: torch.Tensor, eps: torch.Tensor, idx_c: torch.Tensor,
                  vmaskf: torch.Tensor) -> torch.Tensor:
        """y at indices s+1 .. s+W: cumulative drift from the converged y[s]."""
        inc = self.dgamma[idx_c][:, None, None, None] * eps * vmaskf
        return y_start[None] + torch.cumsum(inc, dim=0)

    def errors(self, idx: np.ndarray, y_new, y_old, s_new, s_old) -> torch.Tensor:
        """[W] the masked mean-square change of each window position, the
        larger of the z-space one and the sequence channel's."""
        sa_next = self.sqrt_a[torch.as_tensor(np.minimum(idx + 1, self.S),
                                              device=y_new.device)][:, None, None, None]
        dz2 = torch.square(sa_next * (y_new - y_old))
        err_z = torch.sum(self.mask[None, ..., None] * dz2, dim=(1, 2, 3)) / (3.0 * self.mask_sum)
        ds2 = torch.square(s_new - s_old)
        err_s = torch.sum(self.residue_mask[None, ..., None] * ds2,
                          dim=(1, 2, 3)) / (21.0 * self.rmask_sum)
        return torch.maximum(err_z, err_s)

    def converged_run(self, valid: np.ndarray, err: torch.Tensor) -> int:
        """The leading run of window positions whose error is at most tol^2;
        past-the-end positions count as converged. One device read."""
        ok = torch.where(torch.as_tensor(valid, device=err.device), err <= self.tol2, True)
        return int(torch.cumprod(ok.int(), dim=0).sum())

    def cap(self) -> int:
        # 2S sweeps suffice (each index is exact after <= 2 visits); the cap
        # is a safety net against fp-degenerate tol settings
        return 2 * self.S + 2


@torch.inference_mode()
def sample_ddim_parallel(
    net: ProteinReDiffNet,
    batch: Batch,
    ddim_steps: int = 50,
    window: int = 8,
    tol: float = 1e-3,
    mask_prob: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    noise: Optional[SamplerNoise] = None,
    coarse_init: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, Stats]:
    """Deterministic DDIM sampling with window-parallel Picard iteration
    (``sample_ddim_parallel``, `paratime.py:88-342`): the contract of
    ``sample_ddim(..., eta=0)`` with the same draws, so as ``tol`` -> 0 the
    same trajectory. Returns (positions [B, N, 3] in Å, residue-masked
    sequence logits [B, N, 21], stats) with ``iterations`` (Picard sweeps)
    and ``nfe`` (denoiser evaluations per batch row; the sequential
    sampler's is ``ddim_steps``).

    ``coarse_init`` > 0 warm-starts the iteration from a
    ``coarse_init``-step sequential DDIM solve on a sub-grid of the fine
    trajectory, extended to fine indices by gamma-linear extrapolation of
    each segment's drift; the fixed point is unchanged."""
    cfg = net.cfg
    check_picard_config(cfg, window, ddim_steps, coarse_init)
    S, W = int(ddim_steps), int(window)
    mask_prob = cfg.mask_prob if mask_prob is None else mask_prob
    batch, carry = sample_init(cfg, batch, mask_prob, generator, noise)
    if cfg.seq_process == "absorbing":
        return _sample_absorbing_parallel(net, batch, carry, S, W, tol)
    z0, s0 = carry[0], carry[1]
    win = _Window(net, batch, S, W, tol)
    B = win.B
    SP = S + W
    y0 = z0 / win.sqrt_a[0]
    if coarse_init > 0:
        C = min(int(coarse_init), S)
        # the sub-grid of fine indices 0 = c_0 < ... < c_C = S
        cpts = np.unique(np.round(np.linspace(0, S, C + 1)).astype(np.int32))
        C = len(cpts) - 1
        seg_dg_np = win.gamma_np[cpts[1:]] - win.gamma_np[cpts[:-1]]
        seg_dg = torch.as_tensor(seg_dg_np, device=z0.device)
        y, sq = y0, s0
        eps_c, sq_c = [], []
        for j in range(C):
            i0 = int(cpts[j])
            t = win.taus[i0].repeat(B)
            eps, seqp = net(batch, win.sqrt_a[i0] * y, sq, win.mask, t)
            eps_c.append(eps)
            sq_c.append(sq)
            y = y + seg_dg[j] * eps
            sq = torch.softmax(seqp, dim=-1) * 2.0 - 1.0
        eps_c, sq_c = torch.stack(eps_c), torch.stack(sq_c)
        # fine index i lives in segment seg(i) and follows that segment's
        # (constant-eps) drift from its start: exact at every coarse point
        fine = np.arange(SP + 1)
        seg = np.clip(np.searchsorted(cpts, np.minimum(fine, S), side="right") - 1, 0, C - 1)
        gmi = torch.as_tensor(win.gamma_np[np.minimum(fine, S)] - win.gamma_np[cpts[seg]],
                              device=z0.device)
        y_starts = torch.cat([y0[None], y0[None] + torch.cumsum(
            seg_dg[:, None, None, None] * eps_c, dim=0)[:-1]], dim=0)           # [C, B, N, 3]
        seg_t = torch.as_tensor(seg, device=z0.device)
        y_buf = y_starts[seg_t] + gmi[:, None, None, None] * eps_c[seg_t]
        seq_buf = sq_c[seg_t]
        nfe = C
    else:
        y_buf = y0[None].repeat((SP + 1, 1, 1, 1))
        seq_buf = s0[None].repeat((SP + 1, 1, 1, 1))
        nfe = 0
    # the raw seq_pred of the evaluation feeding each index (the reference
    # returns the last raw prediction, `model.py:421-422`)
    logit_buf = torch.zeros_like(seq_buf)

    # NOTE: the window scaffolding is mirrored in _sample_absorbing_parallel
    # (only the sequence channel differs); keep the two loops in lockstep
    s, iters = 0, 0
    while s < S and iters < win.cap():
        idx, valid, idx_c, vmaskf = win.indices(s)
        ys, seqs = y_buf[idx_c], seq_buf[idx_c]
        zs = win.sqrt_a[idx_c][:, None, None, None] * ys
        eps, seqp = win.evaluate(zs, seqs, idx_c)
        y_new = win.y_rebuild(y_buf[s], eps, idx_c, vmaskf)
        nxt = torch.as_tensor(np.minimum(idx + 1, SP), device=z0.device)
        seq_new = torch.where(vmaskf > 0, torch.softmax(seqp, dim=-1) * 2.0 - 1.0, seq_buf[nxt])
        logit_new = torch.where(vmaskf > 0, seqp, logit_buf[nxt])
        h = win.converged_run(valid, win.errors(idx, y_new, y_buf[s + 1:s + 1 + W], seq_new,
                                                seq_buf[s + 1:s + 1 + W]))
        y_buf[s + 1:s + 1 + W] = y_new
        seq_buf[s + 1:s + 1 + W] = seq_new
        logit_buf[s + 1:s + 1 + W] = logit_new
        s = min(s + h, S)
        iters += 1
        nfe += int(valid.sum())
    pos = nanometre_to_angstrom(y_buf[S])  # sqrt_a[S] == 1
    return pos, win.residue_mask[..., None] * logit_buf[S], {"iterations": iters, "nfe": nfe}


def _sample_absorbing_parallel(net: ProteinReDiffNet, batch: Batch, carry, S: int, W: int,
                               tol: float) -> Tuple[torch.Tensor, torch.Tensor, Stats]:
    """Picard iteration for ``seq_process="absorbing"``
    (``_sample_absorbing_parallel``, `paratime.py:345-508`). The coordinates
    take the Gaussian path's y-space drift. The commitments at index i + 1
    are a deterministic function of (logits_i, commitments_i) under the
    deterministic reveal, so each sweep re-derives the window's commitment
    trajectory with W calls of ``reveal_update`` from the exact state at
    the window start (no net call); invalid (past-the-end) positions hold
    their carry. Convergence joins the z-space change with the committed
    one-hots' change."""
    cfg = net.cfg
    win = _Window(net, batch, S, W, tol)
    z0 = carry[0]
    seq_known, inv2 = absorbing_known_and_designable(batch)
    # reveal target times: each index's tau, except the last, which reveals
    # at t = 0 whatever the grid (it must commit every remaining position)
    t_reveal = win.taus_np.copy()
    t_reveal[-1] = 0
    SP = S + W
    y_buf = (z0 / win.sqrt_a[0])[None].repeat((SP + 1, 1, 1, 1))
    cm_buf = torch.zeros((SP + 1,) + inv2.shape, device=z0.device)
    co_buf = torch.zeros((SP + 1,) + seq_known.shape, device=z0.device)
    no_draws = StepNoise(z=None)  # the deterministic reveal takes no draws

    s, iters, nfe = 0, 0, 0
    while s < S and iters < win.cap():
        idx, valid, idx_c, vmaskf = win.indices(s)
        ys, cos = y_buf[idx_c], co_buf[idx_c]
        zs = win.sqrt_a[idx_c][:, None, None, None] * ys
        eps, logits = win.evaluate(zs, seq_known[None] + cos, idx_c)
        y_new = win.y_rebuild(y_buf[s], eps, idx_c, vmaskf)
        cm, co = cm_buf[s], co_buf[s]
        cm_new, co_new = [], []
        for w in range(W):
            if valid[w]:
                cm, co = reveal_update(cfg, logits[w], cm, co, inv2,
                                       int(t_reveal[min(idx[w], S - 1)]), no_draws)
            cm_new.append(cm)
            co_new.append(co)
        cm_new, co_new = torch.stack(cm_new), torch.stack(co_new)
        h = win.converged_run(valid, win.errors(idx, y_new, y_buf[s + 1:s + 1 + W], co_new,
                                                co_buf[s + 1:s + 1 + W]))
        y_buf[s + 1:s + 1 + W] = y_new
        cm_buf[s + 1:s + 1 + W] = cm_new
        co_buf[s + 1:s + 1 + W] = co_new
        s = min(s + h, S)
        iters += 1
        nfe += int(valid.sum())
    pos = nanometre_to_angstrom(y_buf[S])  # sqrt_a[S] == 1
    logits_out = win.residue_mask[..., None] * (seq_known + co_buf[S])
    return pos, logits_out, {"iterations": iters, "nfe": nfe}
