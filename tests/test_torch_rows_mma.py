"""The tensor-core bodies of K1, K2, K3, K5, K6 and K7 and the route past
the kernels' bounds, on the CPU (no card needed).

- The body choice (``ops.attention.takes_mma`` for bf16, ``takes_tf32x3``
  for K1, K2, K3, K5, K6 and K7 in f32) as a pure function of the kernel's
  name, dtype and head width; K1's and K2's bound (``attention_fits``)
  accepts every shape it accepted before their f32 bodies came.
- K3's tensor-core body streams keys in tiles of 64, where the JAX K3 takes
  chunks of 256: the plain online softmax (``_kchunk_forward_block``) at 64
  keys a tile against the JAX ``_rows_attention_kchunk_grid_cn`` (Pallas in
  interpret mode, chunk 256) in bf16, within 2e-2 of max |out| (one flip of
  a bf16 rounding of p).
- Each bound predicate at its edge: accepted at the bound, refused past it.
- The routes that read them never take a plain version on CUDA tensors: a
  shape within a widened bound (f32 heads up to 1024) reaches the kernel, a
  backward past K7's bound raises before the forward launches (the device
  check patched, the launch recorded), and on the CPU every width takes the
  plain version (1e-5 in f32). A fused configuration with pair width 72
  (past the old bound of K8, K9 and K11) runs all four fused wrappers and
  matches the JAX package with the same switches at the f32 net tolerance of
  ``tests/test_torch_fused.py`` (1e-4).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_fused import FUSED_CFG, _count_fused_calls  # noqa: E402
from test_torch_net import make_batch, perturbed_params  # noqa: E402

import protein_redesign_tpu.ops.pallas_attention as pa  # noqa: E402
from protein_redesign_tpu.models.prdiff import ProteinReDiffModel  # noqa: E402
from protein_redesign_tpu_torch.models import prdiff as P  # noqa: E402
from protein_redesign_tpu_torch.ops import attention as A  # noqa: E402
from protein_redesign_tpu_torch.ops import outer as O  # noqa: E402
from protein_redesign_tpu_torch.ops import transition as T  # noqa: E402
from protein_redesign_tpu_torch.ops import trimul as M  # noqa: E402
from protein_redesign_tpu_torch.utils.weights import state_dict_from_jax  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32


# the body choice ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["rows_attention", "rows_attention_kchunk"])
@pytest.mark.parametrize("C,dtype,mma", [
    (8, BF16, True), (16, BF16, True), (64, BF16, True), (1168, BF16, True),
    (1176, BF16, False), (12, BF16, False), (4, BF16, False), (16, F32, False),
    (64, F32, False),
])
def test_k1_and_k3_body_choice(name, C, dtype, mma):
    """bf16 with C a multiple of 8 up to the shared-memory bound: the bf16
    tensor-core body; otherwise not (f32 K3 is ``takes_tf32x3``'s)."""
    assert A.takes_mma(name, dtype, C) is mma
    queries = A.kchunk_queries(C) if name == "rows_attention_kchunk" else 64
    assert (A.mma_smem_bytes(C, queries) <= A.MMA_SMEM_BYTES) is (C <= 1168)


@pytest.mark.parametrize("C,queries", [(8, 128), (128, 128), (136, 64), (1168, 64)])
def test_k3_query_tile_by_head_width(C, queries):
    """K3's tensor-core body: 128 queries per block up to C = 128, 64 above
    (128 would not fit shared memory at the widest heads)."""
    assert A.kchunk_queries(C) == queries
    assert A.mma_smem_bytes(1168, 128) > A.MMA_SMEM_BYTES


def _body(name, dtype, C):
    if A.takes_mma(name, dtype, C):
        return "bf16 mma"
    return "3xtf32" if A.takes_tf32x3(name, dtype, C) else "cuda cores"


@pytest.mark.parametrize("name,dtype,C,body", [
    # K5 and K7 in bf16: the tensor cores at C a multiple of 8
    *[(name, BF16, C, "bf16 mma") for name in ("rows_attention_kchunk_stats", "rows_attention_bwd")
      for C in (8, 16, 64, 128)],
    ("rows_attention_kchunk_stats", BF16, 12, "cuda cores"),
    ("rows_attention_bwd", BF16, 12, "cuda cores"),
    # K7 in f32: 3xTF32 at C a multiple of 8, else the CUDA cores
    *[("rows_attention_bwd", F32, C, "3xtf32") for C in (8, 16, 64, 128)],
    ("rows_attention_bwd", F32, 12, "cuda cores"),
    # K3 and K5 in f32: 3xTF32 at C a multiple of 8, else the CUDA cores
    *[(name, F32, C, "3xtf32") for name in ("rows_attention_kchunk", "rows_attention_kchunk_stats")
      for C in (8, 16, 64, 128)],
    ("rows_attention_kchunk", F32, 12, "cuda cores"),
    ("rows_attention_kchunk_stats", F32, 20, "cuda cores"),
    # K6: the bf16 tensor cores and 3xTF32 at C a multiple of 8, else the CUDA cores
    *[("rows_attention_kchunk_bwd", dtype, C, "bf16 mma" if dtype == BF16 else "3xtf32")
      for dtype in (BF16, F32) for C in (8, 16, 64, 128)],
    *[("rows_attention_kchunk_bwd", dtype, 12, "cuda cores") for dtype in (BF16, F32)],
])
def test_k5_k6_k7_keep_their_cuda_core_body(name, dtype, C, body):
    """Which body K5, K6 and K7 (and K3 in f32) take at C a multiple of 8:
    K5, K6 and K7 the bf16 tensor cores (attention_mma.cu,
    attention_bwd_mma.cu), K3, K5, K6 and K7 in f32 the 3xTF32 bodies
    (attention_tf32.cu, attention_bwd_tf32.cu); every other width keeps its
    CUDA-core body."""
    assert _body(name, dtype, C) == body


@pytest.mark.parametrize("name", ["rows_attention", "tiled_attention", "rows_attention_fast"])
@pytest.mark.parametrize("C", [8, 12, 16, 64, 128, 512, 768, 1024, 1028])
def test_k1_k2_f32_body_choice_and_bound(name, C):
    """K1, K1 fast and K2 in f32: the 3xTF32 body at C a multiple of 8, K1
    and K1 fast up to 128 (their accumulators hold the whole head), K2 up to
    1024 (its wide body streams the head); C = 12 and every other width keep
    the CUDA-core body, whose bound, C <= 1024 a multiple of 4,
    attention_fits keeps."""
    tf32 = C % 8 == 0 and C <= {"tiled_attention": 1024}.get(name, 128)
    assert A.takes_tf32x3(name, F32, C) is tf32
    assert A.takes_tensor_cores(name, F32, C) is tf32
    assert _body(name, F32, C) == ("3xtf32" if tf32 else "cuda cores")
    assert A.attention_fits(name, 2, 16, 4, C, F32) is (C <= 1024)
    if tf32 and name == "tiled_attention":
        assert A.tiled_tf32x3_smem_bytes(C) <= A.MMA_SMEM_BYTES


def test_k1_k2_bound_accepts_every_shape_it_accepted_before():
    """attention_fits before the f32 bodies came (grid, and the bf16
    tensor-core body or the CUDA-core body's width) accepts nothing that it
    refuses now, over every width up to 1200 in both dtypes."""
    for name in ("rows_attention", "tiled_attention", "rows_attention_fast"):
        for dtype in (F32, BF16):
            for C in range(1, 1201):
                before = A.grid_fits(2, 16, 4) and (A.takes_mma(name, dtype, C)
                                                    or A.width_fits(C, A.MAX_HEAD_DIM))
                assert not before or A.attention_fits(name, 2, 16, 4, C, dtype), (name, dtype, C)


# K3's key tile -----------------------------------------------------------------


def test_k3_key_tile_of_64_matches_jax_chunk_of_256():
    R, N, H, C, scale = 4, 256, 2, 16, 0.25
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(R, N, H, C).astype(np.float32) for _ in range(3))
    mask = (rng.rand(R, N) > 0.3).astype(np.float32)
    mask[2] = 0.0  # a fully masked row
    tq, tk, tv = (torch.from_numpy(x).to(BF16) for x in (q, k, v))
    out, _, _ = A._kchunk_forward_block(tq, tk, tv, torch.from_numpy(mask),
                                        A.weak_scalar(scale, BF16), 64)
    jq, jk, jv = (jnp.swapaxes(jnp.asarray(x, jnp.bfloat16), 1, 2) for x in (q, k, v))
    want = pa._rows_attention_kchunk_grid_cn(jq * scale, jk, jv, jnp.asarray(mask), 256,
                                             pa._kchunk_rb(R), True)
    want = np.asarray(jnp.swapaxes(want, 1, 2), np.float32)
    got = out.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    np.testing.assert_allclose(got[2], np.broadcast_to(tv[2].float().numpy().mean(0), got[2].shape),
                               atol=2e-2, rtol=2e-2)


# the bound predicates ----------------------------------------------------------


@pytest.mark.parametrize("fits,args,ok", [
    # K1 and K2: the CUDA-core body's C <= 1024 (f32), the tensor-core body's
    # shared memory (bf16, multiples of 8)
    (A.attention_fits, ("rows_attention", 2, 16, 4, 1024, F32), True),
    (A.attention_fits, ("rows_attention", 2, 16, 4, 1028, F32), False),
    (A.attention_fits, ("tiled_attention", 2, 16, 1, 768, F32), True),
    (A.attention_fits, ("tiled_attention", 2, 16, 1, 516, BF16), True),
    (A.attention_fits, ("tiled_attention", 2, 16, 4, 1168, BF16), True),
    (A.attention_fits, ("tiled_attention", 2, 16, 4, 1176, BF16), False),
    (A.attention_fits, ("rows_attention", 2, 16, A.MAX_HEADS, 16, F32), True),
    (A.attention_fits, ("rows_attention", 2, 16, A.MAX_HEADS + 1, 16, F32), False),
    (A.attention_fits, ("rows_attention", A.MAX_BLOCKS, 16, 4, 16, F32), True),
    (A.attention_fits, ("rows_attention", A.MAX_BLOCKS, 17, 4, 16, F32), False),
    # K7: C <= 128
    (A.bwd_fits, (2, 16, 4, 128, BF16), True),
    (A.bwd_fits, (2, 16, 4, 132, BF16), False),
    # K3: the tensor-core body in bf16; K3 in f32, K5 and K6: C <= 128
    (A.kchunk_fits, ("rows_attention_kchunk", 2, 16, 4, 1168, BF16), True),
    (A.kchunk_fits, ("rows_attention_kchunk", 2, 16, 4, 132, F32), False),
    (A.kchunk_fits, ("rows_attention_kchunk_stats", 2, 16, 4, 128, BF16), True),
    (A.kchunk_fits, ("rows_attention_kchunk_stats", 2, 16, 4, 1176, BF16), False),
    # K8: D <= 128; the tensor-core body C a multiple of 8 up to 128 with
    # H C <= 512, the CUDA-core body C = 4 mod 8 up to 32 with H C <= 128
    (A.fused_gated_fits, (4, 16, 128, 4, 32, BF16), True),
    (A.fused_gated_fits, (4, 16, 132, 4, 16, BF16), False),
    (A.fused_gated_fits, (4, 16, 64, 2, 36, BF16), False),
    (A.fused_gated_fits, (4, 16, 64, 5, 32, BF16), True),
    # K9: D a multiple of 8 up to 128
    (M.trimul_fits, (2, 16, 128, BF16), True),
    (M.trimul_fits, (2, 16, 136, BF16), False),
    (M.trimul_fits, (2, 16, 124, BF16), False),
    # K10: any D (the whole-row tile up to 670, the streamed one past it);
    # outputs wider than 64 split the hidden width over grid.y's 65535 chunks
    (T.transition_fits, (100, 670, 256, 670, F32), True),
    (T.transition_fits, (100, 671, 256, 671, F32), True),
    # K11: D a multiple of 4 up to 128
    (O.outer_fits, (2, 16, 128, BF16), True),
    (O.outer_fits, (2, 16, 132, BF16), False),
    # K5 on the bf16 tensor cores: K3's shared memory
    (A.kchunk_fits, ("rows_attention_kchunk_stats", 2, 16, 4, 1168, BF16), True),
    # K7: the tensor-core body in bf16 at multiples of 8 up to 128, the
    # CUDA-core body at multiples of 4 (and in f32)
    (A.takes_mma, ("rows_attention_bwd", BF16, 128), True),
    (A.takes_mma, ("rows_attention_bwd", BF16, 136), False),
    (A.bwd_fits, (2, 16, 4, 124, BF16), True),
    (A.bwd_fits, (2, 16, 4, 128, F32), True),
    (A.bwd_fits, (2, 16, 4, 132, F32), False),
    # K3 and K5 in f32: 3xTF32 at multiples of 8 up to 128
    (A.takes_tf32x3, ("rows_attention_kchunk", F32, 128), True),
    (A.takes_tf32x3, ("rows_attention_kchunk_stats", F32, 136), False),
    (A.takes_tf32x3, ("rows_attention_kchunk", F32, 124), False),
    (A.takes_tf32x3, ("rows_attention_kchunk", BF16, 16), False),
    (A.takes_tf32x3, ("rows_attention_kchunk_bwd", F32, 12), False),
    (A.kchunk_fits, ("rows_attention_kchunk", 2, 16, 4, 124, F32), True),
    # K6 and K7 (the f32 body too) at the edges: the tensor-core bodies at
    # multiples of 8 up to 128, the CUDA-core ones at multiples of 4 up to
    # 128; the bounds accept what they accepted before the f32 bodies came
    *[(fn, (name, dtype, C), ok)
      for name in ("rows_attention_kchunk_bwd", "rows_attention_bwd")
      for C, bf16_ok, f32_ok in ((4, False, False), (8, True, True), (124, False, False),
                                 (128, True, True), (136, False, False))
      for fn, dtype, ok in ((A.takes_mma, BF16, bf16_ok), (A.takes_mma, F32, False),
                            (A.takes_tf32x3, F32, f32_ok), (A.takes_tf32x3, BF16, False))],
    *[(A.kchunk_fits, ("rows_attention_kchunk_bwd", 2, 16, 4, C, dtype), C <= 128)
      for C in (4, 8, 124, 128, 136) for dtype in (BF16, F32)],
    *[(A.bwd_fits, (2, 16, 4, C, dtype), C <= 128)
      for C in (4, 8, 124, 128, 136) for dtype in (BF16, F32)],
    # K8's tensor-core body: C a multiple of 8 up to 128 with H C <= 512 (the
    # h64 layouts), past them the CUDA-core body's C = 4 mod 8 up to 32
    *[(A.fused_gated_fits, (4, 16, D, H, C, dtype), ok)
      for D, H, C, ok in ((64, 1, 64, True), (128, 4, 64, True), (128, 4, 128, True),
                          (64, 1, 136, False), (64, 5, 128, False), (64, 65, 8, False),
                          (64, 9, 12, True), (64, 11, 12, False), (20, 4, 16, True),
                          (136, 1, 64, False))
      for dtype in (BF16, F32)],
    (A.fused_gated_takes_tensor_cores, (64, 4, 16), True),
    (A.fused_gated_takes_tensor_cores, (64, 9, 12), False),
    (A.fused_gated_takes_tensor_cores, (64, 4, 128), True),
    # K9: B N^2 within one projection block per 64 positions
    (M.trimul_fits, (1, 300_000, 64, BF16), True),
    (M.trimul_fits, (1, 400_000, 64, BF16), False),
    (M.trimul_takes_tensor_cores, (72,), True),
    # K1 fast in f32: 3xTF32 at multiples of 8 up to 128 (K1's range), bf16
    # never; its bound unchanged at the edges
    *[(A.takes_tf32x3, ("rows_attention_fast", dtype, C), dtype == F32 and C in (8, 128))
      for C in (4, 8, 124, 128, 136) for dtype in (BF16, F32)],
    *[(A.attention_fits, ("rows_attention_fast", 2, 16, 4, C, dtype), C <= 1024)
      for C in (4, 8, 124, 128, 136, 1024, 1028) for dtype in (BF16, F32)],
    # K10's tensor-core body: D, Hd and Dout multiples of 8 in bf16, 4 in f32
    *[(T.transition_takes_tensor_cores, (D, 4 * D, D, dtype), ok)
      for D, dtype, ok in ((8, BF16, True), (4, BF16, False), (12, BF16, False),
                           (128, BF16, True), (136, BF16, True), (4, F32, True),
                           (6, F32, False), (12, F32, True), (128, F32, True),
                           (136, F32, True), (768, F32, True))],
    (T.transition_takes_tensor_cores, (64, 260, 64, BF16), False),
    (T.transition_takes_tensor_cores, (64, 260, 64, F32), True),
    (T.transition_takes_tensor_cores, (64, 258, 64, F32), False),
    (T.transition_takes_tensor_cores, (64, 256, 68, BF16), False),
    (T.transition_takes_tensor_cores, (64, 256, 64, torch.float16), False),
    # K10 past the whole-row tile, and the split output's grid.y
    (T.transition_fits, (100, 768, 3072, 768, BF16), True),
    (T.transition_fits, (100, 64, T.MAX_SPLIT_HIDDEN, 128, F32), True),
    (T.transition_fits, (100, 64, T.MAX_SPLIT_HIDDEN + 1, 128, F32), False),
    (T.transition_fits, (100, 64, T.MAX_SPLIT_HIDDEN + 1, 64, F32), True),
])
def test_bound_predicate_edges(fits, args, ok):
    assert fits(*args) is ok


@pytest.mark.parametrize("D,Hd,Dout,dtype,layout", [
    (64, 256, 64, BF16, "resident"), (64, 256, 64, F32, "resident"),  # pair_fc
    (128, 512, 128, BF16, "streamed"), (128, 512, 128, F32, "streamed"),  # pair width 128
    (512, 2048, 512, BF16, "split"), (512, 2048, 512, F32, "split"),  # single_fc
    (768, 3072, 768, BF16, "split"), (768, 3072, 768, F32, "split"),
    (136, 544, 136, BF16, "split"),  # Dout past the rows layout's 128
    (704, 96, 40, F32, "split"),  # the rows layout's A tile past shared memory
    (64, 64 * 65536, 136, F32, None), (64, 64 * 65535, 136, F32, "split"),
    (64, 64 * 65535, 128, F32, "split"),  # b1 past the streamed layout's shared memory
    (1536, 512, 1536, F32, None),  # the split layout's x tile past shared memory
])
def test_transition_layout_by_shape(D, Hd, Dout, dtype, layout):
    """K10's tensor-core layout (transition_mma.cu's layout_of) at the main
    path's shapes and past them: pair_fc keeps W1 and W2 resident in shared
    memory in both dtypes, pair width 128 streams them, outputs past 128 (and
    rows whose tiles pass shared memory) split the hidden width, up to
    grid.y's 65535 chunks (where transition_fits stops too) and while the
    split block's x tile fits; past that the CUDA-core body takes the
    shape."""
    assert T.transition_layout(D, Hd, Dout, dtype) == layout
    assert T.transition_takes_tensor_cores(D, Hd, Dout, dtype) is (layout is not None)
    warps = T.TC_RESIDENT_WARPS
    resident = min(T.tc_rows_smem_bytes(D, Hd, Dout, dtype, w) for w in (warps, warps // 2))
    assert (resident <= T.MAX_SMEM) is (layout == "resident")
    if layout == "streamed":
        assert T.tc_chunks_smem_bytes(D, Hd, Dout, dtype) <= T.MAX_SMEM
    if layout is None and Hd <= T.MAX_SPLIT_HIDDEN:
        assert T.transition_fits(100, D, Hd, Dout, dtype)


def test_transition_bound_accepts_what_it_accepted_before():
    """transition_fits reads no body: every shape of a sweep that it
    accepted before the tensor-core body came (any D with smem_bytes(D)
    within MAX_SMEM, Hd up to MAX_SPLIT_HIDDEN past 64 outputs) it accepts
    now, whichever body takes it."""
    for D in (1, 4, 8, 64, 128, 670, 671, 768, 4096):
        for Hd in (1, 64, 256, T.MAX_SPLIT_HIDDEN, T.MAX_SPLIT_HIDDEN + 1):
            for Dout in (1, 64, 65, 128, 768):
                for dtype in (BF16, F32):
                    before = (T.smem_bytes(D) <= T.MAX_SMEM
                              and (Dout <= T.SPLIT_OUT_DIM or Hd <= T.MAX_SPLIT_HIDDEN))
                    assert T.transition_fits(100, D, Hd, Dout, dtype) is before


# the routes --------------------------------------------------------------------


def _qkv(R, N, H, C, seed=0, requires_grad=False):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(R, N, H, C, generator=g).requires_grad_(requires_grad)
               for _ in range(3))
    mask = (torch.rand(R, N, generator=g) > 0.2).float()
    return q, k, v, mask


@pytest.fixture
def as_if_on_cuda(monkeypatch):
    """The routes as they run on CUDA tensors: ``_on_cpu`` answers False and
    ``_launch`` (K1, K1 fast, K2) records the kernel it was asked for and
    returns the plain version's output, so no card is needed."""
    launched = []

    def launch(name, q, k, v, mask, bias, scale, mma=None):
        launched.append((name, q.shape[-1]))
        if name == "rows_attention_fast":
            return A.rows_attention_fast_reference(q, k, v, mask, scale)
        return A.attention_reference(q, k, v, mask, bias, scale)

    monkeypatch.setattr(A, "_on_cpu", lambda t: False)
    monkeypatch.setattr(A, "_launch", launch)
    return launched


@pytest.mark.parametrize("C", [768, 1024])
def test_wide_f32_heads_reach_the_kernel(as_if_on_cuda, C):
    """f32 SPAttention at single_dim 768 or 1024: K2's CUDA-core body takes
    it, so the route launches K2 (and K1 for a triangle attention that wide)
    and takes no plain version."""
    q, k, v, mask = _qkv(2, 6, 1, C)
    bias = torch.randn(2, 1, 6, 6, generator=torch.Generator().manual_seed(1))
    out = A.tiled_attention(q, k, v, None, bias, C ** -0.5)
    A.rows_attention(q, k, v, mask, C ** -0.5)
    assert as_if_on_cuda == [("tiled_attention", C), ("rows_attention", C)]
    torch.testing.assert_close(out, A.attention_reference(q, k, v, None, bias, C ** -0.5),
                               atol=1e-5, rtol=1e-5)


def test_rows_attention_raises_before_launch_past_k7(as_if_on_cuda):
    """Below the switch K7 takes C <= 128: a gradient at C = 136 raises
    before K1 launches; without a gradient K1 takes the shape."""
    q, k, v, mask = _qkv(2, 8, 1, 136, requires_grad=True)
    with pytest.raises(ValueError, match="K7"):
        A.rows_attention(q, k, v, mask, 0.1)
    assert as_if_on_cuda == []
    with torch.no_grad():
        A.rows_attention(q, k, v, mask, 0.1)
    assert as_if_on_cuda == [("rows_attention", 136)]


@pytest.mark.parametrize("fast", [False, True], ids=["k1", "k1_fast"])
def test_plain_vjp_route_launches_past_the_old_bound(as_if_on_cuda, fast):
    """With use_pallas_bwd off, K1 and K1 fast at C = 520 (past the old
    512) launch their kernel."""
    q, k, v, mask = _qkv(2, 10, 1, 520)
    out = A.gated_attention_core(q, k, v, mask, None, 0.1, fast=fast, kernel_bwd=False)
    name = "rows_attention_fast" if fast else "rows_attention"
    assert as_if_on_cuda == [(name, 520)]
    want = (A.rows_attention_fast_reference(q, k, v, mask, 0.1) if fast
            else A.attention_reference(q, k, v, mask, None, 0.1))
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("C,grad", [(1028, False), (136, True)])
def test_cpu_tensors_take_the_plain_version_at_any_width(C, grad):
    """On the CPU the wrappers take their plain versions whatever the bound:
    K2 past 1024, and a triangle attention with a gradient past K7's 128."""
    A.reset_launch_counts()
    q, k, v, mask = _qkv(2, 6, 1, C, requires_grad=grad)
    bias = torch.randn(2, 1, 6, 6, generator=torch.Generator().manual_seed(2))
    out = A.tiled_attention(q, k, v, mask, bias, 0.1) + A.rows_attention(q, k, v, mask, 0.1)
    want = (A.attention_reference(q, k, v, mask, bias, 0.1)
            + A.attention_reference(q, k, v, mask, None, 0.1))
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    if grad:
        out.sum().backward()
        assert torch.isfinite(q.grad).all()
    assert not any(A.LAUNCHES.values())


def test_fused_configuration_at_pair_width_72_matches_jax(monkeypatch):
    """The four switches at pair width 72 (past the old bound of K8, K9 and
    K11, 64): every fused wrapper runs, once per module call. The forward
    against the JAX model with the same switches (its Pallas kernels in
    interpret mode, which take any width)."""
    cfg = FUSED_CFG.replace(pair_dim=72)
    calls = _count_fused_calls(monkeypatch)
    batch = make_batch(B=2, seed=8)
    params = perturbed_params(cfg, seed=8)
    rng = np.random.RandomState(18)
    B, N = batch["residue_mask"].shape
    z = rng.randn(B, N, 3).astype(np.float32)
    seq_t = rng.randn(B, N, 21).astype(np.float32)
    mask = batch["atom_mask"] + batch["residue_mask"]
    t = rng.randint(0, cfg.num_steps, (B,))
    j_noise, j_seq = ProteinReDiffModel(cfg).apply(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(z),
        jnp.asarray(seq_t), jnp.asarray(mask), jnp.asarray(t, jnp.int32),
    )
    net = P.ProteinReDiffNet(cfg)
    net.load_state_dict(state_dict_from_jax(params, cfg))
    with torch.no_grad():
        noise, seq = net({k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(z),
                         torch.from_numpy(seq_t), torch.from_numpy(mask), torch.from_numpy(t))
    blocks = cfg.num_blocks
    assert calls == {"fused_gated": 2 * blocks, "trimul": 2 * blocks,
                     "transition": 2 * blocks, "outer": blocks}
    np.testing.assert_allclose(noise.numpy(), np.asarray(j_noise), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(seq.numpy(), np.asarray(j_seq), atol=1e-4, rtol=1e-4)
