"""ln_project.cuh's LN + projection block (K8's and K9's projections) as
far as the CPU can hold it: its shared memory at every width it takes, and
the wide block's LayerNorm statistics (two passes over 64-column chunks,
merged by Chan's update) against the plain LayerNorm. The kernels
themselves run on the card (tests/test_torch_kernels_cuda.py, ``-k "fused
or trimul"``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from protein_redesign_tpu_torch.ops import attention as A  # noqa: E402
from protein_redesign_tpu_torch.ops.transition import MAX_SMEM  # noqa: E402

DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@DTYPES
@pytest.mark.parametrize("D", range(8, 513, 8))
def test_ln_project_block_fits_shared_memory(D, dtype):
    """Every multiple of 8 up to 512 fits a block's shared memory: the
    narrow block up to 128, the wide block (A tile alone resident) past
    it."""
    assert A.ln_project_smem_bytes(D, dtype) <= MAX_SMEM


@pytest.mark.parametrize("D,dtype,size", [
    (128, torch.bfloat16, 87_296), (128, torch.float32, 140_544),
    (136, torch.bfloat16, 64_512), (512, torch.bfloat16, 111_616),
    (512, torch.float32, 177_152)])
def test_ln_project_smem_at_the_edges(D, dtype, size):
    """The sizes ln_project.cuh states: the narrow block at 128 (raw f32
    rows, two whole-D weight slices), the wide block from 136 (two blocks a
    SM in bf16 at 512, one in f32)."""
    assert A.ln_project_smem_bytes(D, dtype) == size


@pytest.mark.parametrize("D,dtype,block", [
    (64, torch.bfloat16, "narrow"), (96, torch.bfloat16, "narrow"),
    (112, torch.bfloat16, "narrow"), (116, torch.bfloat16, "wide"),
    (128, torch.bfloat16, "wide"), (136, torch.bfloat16, "wide"), (36, torch.float32, "narrow"),
    (64, torch.float32, "narrow"), (68, torch.float32, "wide"), (128, torch.float32, "wide"),
    (512, torch.float32, "wide")])
def test_split_projection_takes_the_block_with_more_blocks_a_sm(D, dtype, block):
    """K8's split route projects on the wide block past 128 and where the
    narrow block's shared memory leaves fewer blocks a SM (f32 at 128: one
    against two), else on the narrow block (the paper width, 64, in both
    dtypes)."""
    assert A.split_projection_block(D, dtype) == block
    if D <= A.LNP_MAX_D:
        narrow, wide = (A.lnp_blocks_per_sm(A.ln_project_smem_bytes(D, dtype, w)) for w in (False, True))
        assert (wide > narrow) is (block == "wide")


def _chunked_layer_norm(x: np.ndarray, chunk: int = 64) -> np.ndarray:
    """ln_project_wide's LayerNorm in f32: each 64-column chunk's own mean
    and sum of squares about it (a warp's two sums), merged into the row's
    running (mean, M2) by Chan's update, then rsqrt(M2 / D + 1e-5)."""
    f = np.float32
    D = x.shape[-1]
    mean = m2 = None
    for d0 in range(0, D, chunk):
        v = x[..., d0:d0 + chunk]
        dn = v.shape[-1]
        mc = (v.sum(-1, dtype=f) / f(dn)).astype(f)
        q = ((v - mc[..., None]) ** 2).sum(-1, dtype=f)
        if d0 == 0:
            mean, m2 = mc, q
        else:
            n, delta = f(d0 + dn), (mc - mean).astype(f)
            mean = (mean + delta * (f(dn) / n)).astype(f)
            m2 = (m2 + (q + delta * delta * (f(d0) * (f(dn) / n)))).astype(f)
    rstd = (1.0 / np.sqrt(m2 / f(D) + f(1e-5))).astype(f)
    return ((x - mean[..., None]) * rstd[..., None]).astype(f)


@pytest.mark.parametrize("D", [136, 192, 260, 512])
def test_wide_block_layer_norm_statistics(D):
    """The chunked statistics agree with the plain LayerNorm (f32) within
    1e-5 at rows whose mean is 8 times their spread, a last chunk shorter
    than 64 included (D = 136, 260): no sum of squares about zero cancels."""
    rng = np.random.RandomState(D)
    x = (rng.randn(64, D) + 8.0).astype(np.float32)
    x[5] = 0.0  # a padded row: LN of zeros is zero
    got = _chunked_layer_norm(x)
    want = A.layer_norm_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert not got[5].any()
