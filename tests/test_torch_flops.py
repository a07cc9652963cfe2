"""The port's FLOP accounting (``utils/flops.py``) against the JAX
package's: the analytic denoiser count and MFU are the same functions, and
the analytic count lands within 15% of torch's own count of the port's
forward at paper widths (the tolerance with which JAX's
``test_analytic_matches_xla_at_paper_dims`` holds XLA's count)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from __graft_entry__ import _make_batch  # noqa: E402
from protein_redesign_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from protein_redesign_tpu.utils import flops as jax_flops  # noqa: E402
from protein_redesign_tpu_torch.config import ModelConfig  # noqa: E402
from protein_redesign_tpu_torch.utils import flops  # noqa: E402

WIDTHS = [dict(single_dim=512, pair_dim=64, num_blocks=12),
          dict(single_dim=64, pair_dim=16, num_blocks=1, head_dim=8, num_heads=2),
          dict(single_dim=768, pair_dim=128, num_blocks=4, head_dim=64, num_heads=1,
               transition_factor=2)]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: at these sizes the test suite's parallel workers
    would otherwise oversubscribe the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("widths", WIDTHS)
@pytest.mark.parametrize("n", [16, 192, 2048])
def test_analytic_count_and_mfu_equal_jax(widths, n):
    ours = flops.denoiser_forward_flops(ModelConfig(**widths), 2, n)
    assert ours == jax_flops.denoiser_forward_flops(JaxConfig(**widths), 2, n)
    peak = flops.PEAK_FLOPS["float32"]
    assert flops.mfu(ours, 0.25, peak) == jax_flops.mfu(ours, 0.25, peak)


def test_mfu_defaults_to_the_h100_bf16_peak():
    assert flops.mfu(989e12 / 10, 1.0) == pytest.approx(0.10)
    assert flops.mfu(1.0, 0.0) == float("inf")


def test_analytic_scales_with_n_cubed():
    """The O(N^3) triangle terms dominate at paper scale: doubling N
    from 512 must multiply the count by more than 4 and at most 8."""
    cfg = ModelConfig(single_dim=512, pair_dim=64, num_blocks=4, num_steps=8)
    f1 = flops.denoiser_forward_flops(cfg, 1, 512)
    f2 = flops.denoiser_forward_flops(cfg, 1, 1024)
    assert 4.0 < f2 / f1 <= 8.0


def test_batch_linear():
    cfg = ModelConfig(single_dim=64, pair_dim=16, num_blocks=1, num_steps=8)
    assert flops.denoiser_forward_flops(cfg, 4, 128) == pytest.approx(
        4 * flops.denoiser_forward_flops(cfg, 1, 128))


def test_analytic_within_15_percent_of_the_counted_forward():
    """Paper widths (512/64, h16x4), 2 blocks, bucket 128, on the CPU (the
    plain versions, which the counter sees)."""
    from protein_redesign_tpu_torch.models.prdiff import ProteinReDiffNet

    cfg = ModelConfig(single_dim=512, pair_dim=64, num_blocks=2, num_steps=8, esm_dim=320,
                      dtype="float32")
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in _make_batch(32, 96, 128, esm_dim=cfg.esm_dim).items()}
    torch.manual_seed(0)
    net = ProteinReDiffNet(cfg).eval()
    B, N = batch["residue_mask"].shape
    mask = batch["atom_mask"] + batch["residue_mask"]
    z = torch.randn(B, N, 3)
    seq = torch.zeros(B, N, 21)
    t = torch.zeros(B, dtype=torch.long)
    with torch.inference_mode():
        counted = flops.counted_flops(lambda: net(batch, z, seq, mask, t))
    analytic = flops.denoiser_forward_flops(cfg, batch=B, n=N)
    assert counted > 0
    assert analytic == pytest.approx(counted, rel=0.15), (analytic, counted)
