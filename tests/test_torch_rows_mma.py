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
from test_torch_fused import FUSED_CFG, _count_fused_calls, _gated_case, _jax_gated, _t  # noqa: E402
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
    (1176, BF16, False), (12, BF16, True), (4, BF16, True), (16, F32, False),
    (64, F32, False), (1164, BF16, True), (1172, BF16, False), (6, BF16, False),
])
def test_k1_and_k3_body_choice(name, C, dtype, mma):
    """bf16 with C a multiple of 4 up to the shared-memory bound: the bf16
    tensor-core body (C = 4 mod 8 padded as C + 4); otherwise not (f32 K3 is
    ``takes_tf32x3``'s)."""
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
    ("rows_attention_kchunk_stats", BF16, 12, "bf16 mma"),
    ("rows_attention_bwd", BF16, 12, "cuda cores"),
    # K7 in f32: 3xTF32 at C a multiple of 8, else the CUDA cores
    *[("rows_attention_bwd", F32, C, "3xtf32") for C in (8, 16, 64, 128)],
    ("rows_attention_bwd", F32, 12, "cuda cores"),
    # K3 and K5 in f32: 3xTF32 at C a multiple of 4
    *[(name, F32, C, "3xtf32") for name in ("rows_attention_kchunk", "rows_attention_kchunk_stats")
      for C in (8, 16, 64, 128)],
    ("rows_attention_kchunk", F32, 12, "3xtf32"),
    ("rows_attention_kchunk_stats", F32, 20, "3xtf32"),
    # past 128: K3 and K5 in f32 and K6 and K7 in both dtypes on their wide
    # tensor-core bodies (attention_tf32.cuh, attention_bwd_wide.cuh); C = 4
    # mod 8 K3 and K5 on them too, K7 on the CUDA cores
    *[(name, F32, C, "3xtf32") for name in ("rows_attention_kchunk", "rows_attention_kchunk_stats",
                                            "rows_attention_bwd") for C in (256, 1024)],
    *[("rows_attention_bwd", BF16, C, "bf16 mma") for C in (256, 1024)],
    *[("rows_attention_kchunk_bwd", dtype, C, "bf16 mma" if dtype == BF16 else "3xtf32")
      for dtype in (BF16, F32) for C in (256, 1024)],
    ("rows_attention_kchunk", F32, 132, "3xtf32"),
    ("rows_attention_bwd", F32, 132, "cuda cores"),
    # K6: the bf16 tensor cores and 3xTF32 at C a multiple of 8, else the CUDA cores
    *[("rows_attention_kchunk_bwd", dtype, C, "bf16 mma" if dtype == BF16 else "3xtf32")
      for dtype in (BF16, F32) for C in (8, 16, 64, 128)],
    *[("rows_attention_kchunk_bwd", dtype, 12, "cuda cores") for dtype in (BF16, F32)],
])
def test_k5_k6_k7_keep_their_cuda_core_body(name, dtype, C, body):
    """Which body K5, K6 and K7 (and K3 in f32) take at C a multiple of 8:
    K5, K6 and K7 the bf16 tensor cores (attention_mma.cu,
    attention_bwd_mma.cu; K6 and K7 past 128 their wide body), K3, K5, K6
    and K7 in f32 the 3xTF32 bodies (attention_tf32.cu,
    attention_bwd_tf32.cu; past 128 the wide ones); at C = 4 mod 8 K3 and
    K5 keep their tensor-core bodies and K6 and K7 their CUDA-core ones."""
    assert _body(name, dtype, C) == body


@pytest.mark.parametrize("name", ["rows_attention", "tiled_attention", "rows_attention_fast"])
@pytest.mark.parametrize("C", [8, 12, 16, 64, 128, 512, 768, 1024, 1028])
def test_k1_k2_f32_body_choice_and_bound(name, C):
    """K1, K1 fast and K2 in f32: the 3xTF32 body at C a multiple of 8 up to
    1024, for K1 and K1 fast of 4 (past 128 the wide bodies, which stream
    the head in 128-channel chunks); K2 at C = 12 and every other width
    keep the CUDA-core body, whose bound, C <= 1024 a multiple of 4,
    attention_fits keeps."""
    tf32 = C % (8 if name == "tiled_attention" else 4) == 0 and C <= 1024
    assert A.takes_tf32x3(name, F32, C) is tf32
    assert A.takes_tensor_cores(name, F32, C) is tf32
    assert _body(name, F32, C) == ("3xtf32" if tf32 else "cuda cores")
    assert A.attention_fits(name, 2, 16, 4, C, F32) is (C <= 1024)
    if tf32 and name == "tiled_attention":
        assert A.tiled_tf32x3_smem_bytes(C) <= A.MMA_SMEM_BYTES
    if tf32 and C > 128:  # K1 on K3's wide body, K1 fast on its own
        assert A.kchunk_wide_tf32x3_smem_bytes(C) <= A.MMA_SMEM_BYTES
        assert A.fast_wide_tf32x3_smem_bytes(C, 0, store=False) <= A.MMA_SMEM_BYTES


@pytest.mark.parametrize("C,stored_up_to", [(136, 576), (512, 576), (520, 1856), (1024, 1856)])
def test_k1_fast_wide_body_stores_its_logits_where_they_fit(C, stored_up_to):
    """K1 fast's f32 body past 128 keeps the rounded logits in shared memory
    (2 bytes a query and key, 64 queries a block up to C = 512, 32 above)
    up to the last N whose block fits MMA_SMEM_BYTES, and recomputes them
    past it; its shared memory without them does not depend on N."""
    def stores(N):  # the kernel's own switch in attention_fast_wide_tf32.cu's launch()
        return A.fast_wide_tf32x3_smem_bytes(C, N, store=True) <= A.MMA_SMEM_BYTES

    assert stores(stored_up_to)
    assert not stores(stored_up_to + 64)
    assert stores(stored_up_to + 1) is False
    assert (A.fast_wide_tf32x3_smem_bytes(C, 100_000, store=False)
            == A.fast_wide_tf32x3_smem_bytes(C, 0, store=False) <= A.MMA_SMEM_BYTES)


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
    # K7: C <= 1024
    (A.bwd_fits, (2, 16, 4, 1024, BF16), True),
    (A.bwd_fits, (2, 16, 4, 1028, BF16), False),
    # K3: the tensor-core body in bf16; K3 in f32, K5 and K6: C <= 1024
    (A.kchunk_fits, ("rows_attention_kchunk", 2, 16, 4, 1168, BF16), True),
    (A.kchunk_fits, ("rows_attention_kchunk", 2, 16, 4, 1028, F32), False),
    (A.kchunk_fits, ("rows_attention_kchunk_stats", 2, 16, 4, 128, BF16), True),
    (A.kchunk_fits, ("rows_attention_kchunk_stats", 2, 16, 4, 1176, BF16), False),
    # K8: the JAX kernel's reach, D <= 512, C a multiple of 4 up to 1024,
    # H C <= 4096 (the tensor-core body, the CUDA-core body or the split route)
    (A.fused_gated_fits, (4, 16, 128, 4, 32, BF16), True),
    (A.fused_gated_fits, (4, 16, 512, 4, 16, BF16), True),
    (A.fused_gated_fits, (4, 16, 64, 2, 36, BF16), True),
    (A.fused_gated_fits, (4, 16, 64, 5, 32, BF16), True),
    (A.fused_gated_fits, (4, 16, 513, 4, 16, BF16), False),
    (A.fused_gated_fits, (4, 16, 64, 1, 1024, F32), True),
    (A.fused_gated_fits, (4, 16, 64, 1, 1028, F32), False),
    (A.fused_gated_fits, (4, 16, 64, 1024, 4, BF16), True),
    (A.fused_gated_fits, (4, 16, 64, 1025, 4, BF16), False),
    (A.fused_gated_fits, (4, 16, 64, 2, 34, BF16), False),
    # K9: any D up to 512
    (M.trimul_fits, (2, 16, 512, BF16), True),
    (M.trimul_fits, (2, 16, 513, BF16), False),
    (M.trimul_fits, (2, 16, 124, BF16), True),
    # K10: any D (the whole-row tile up to 670, the streamed one past it);
    # outputs wider than 64 split the hidden width over grid.y's 65535 chunks
    (T.transition_fits, (100, 670, 256, 670, F32), True),
    (T.transition_fits, (100, 671, 256, 671, F32), True),
    # K11: any D up to 512
    (O.outer_fits, (2, 16, 512, BF16), True),
    (O.outer_fits, (2, 16, 513, BF16), False),
    *[(O.outer_fits, (2, 16, D, dtype), D <= 512) for D in (4, 8, 124) for dtype in (BF16, F32)],
    # K11's tensor-core body: D a multiple of 8 up to 128 and S a multiple of
    # one 16-byte piece (8 in bf16, 4 in f32), not of the MMA's k-step;
    # D = 4 mod 8 takes the CUDA-core body, which outer_fits still admits
    *[(O.outer_takes_tensor_cores, (512, D, dtype), D in (8, 128))
      for D in (4, 8, 124, 128, 132) for dtype in (BF16, F32)],
    *[(O.outer_takes_tensor_cores, (S, 64, dtype), ok)
      for S, dtype, ok in ((16, BF16, True), (8, BF16, True), (40, BF16, True),
                           (12, BF16, False), (4, BF16, False), (16, F32, True),
                           (12, F32, True), (4, F32, True), (6, F32, False), (2, F32, False))],
    (O.outer_takes_tensor_cores, (512, 64, torch.float16), False),
    # K5 on the bf16 tensor cores: K3's shared memory
    (A.kchunk_fits, ("rows_attention_kchunk_stats", 2, 16, 4, 1168, BF16), True),
    # K7: the tensor-core bodies in bf16 at multiples of 8 up to 1024 (the
    # wide body past 128), the CUDA-core body at C = 4 mod 8 (and in f32)
    (A.takes_mma, ("rows_attention_bwd", BF16, 128), True),
    (A.takes_mma, ("rows_attention_bwd", BF16, 136), True),
    (A.takes_mma, ("rows_attention_bwd", BF16, 132), False),
    (A.takes_mma, ("rows_attention_bwd", BF16, 1032), False),
    (A.bwd_fits, (2, 16, 4, 124, BF16), True),
    (A.bwd_fits, (2, 16, 4, 128, F32), True),
    (A.bwd_fits, (2, 16, 4, 1028, F32), False),
    # K3 and K5 in f32: 3xTF32 at multiples of 8 up to 1024 (the wide body
    # past 128)
    (A.takes_tf32x3, ("rows_attention_kchunk", F32, 128), True),
    (A.takes_tf32x3, ("rows_attention_kchunk_stats", F32, 136), True),
    (A.takes_tf32x3, ("rows_attention_kchunk_stats", F32, 1024), True),
    (A.takes_tf32x3, ("rows_attention_kchunk_stats", F32, 1032), False),
    (A.takes_tf32x3, ("rows_attention_kchunk", F32, 124), True),
    (A.takes_tf32x3, ("rows_attention_kchunk", BF16, 16), False),
    (A.takes_tf32x3, ("rows_attention_kchunk_bwd", F32, 12), False),
    (A.kchunk_fits, ("rows_attention_kchunk", 2, 16, 4, 124, F32), True),
    # K6 and K7 (the f32 body too) at the edges: the tensor-core bodies at
    # multiples of 8 up to 1024 (the wide bodies past 128), the CUDA-core
    # ones at C = 4 mod 8 up to 1024
    *[(fn, (name, dtype, C), ok)
      for name in ("rows_attention_kchunk_bwd", "rows_attention_bwd")
      for C, tc in ((4, False), (8, True), (124, False), (128, True), (132, False),
                    (136, True), (1024, True))
      for fn, dtype, ok in ((A.takes_mma, BF16, tc), (A.takes_mma, F32, False),
                            (A.takes_tf32x3, F32, tc), (A.takes_tf32x3, BF16, False))],
    *[(A.kchunk_fits, ("rows_attention_kchunk_bwd", 2, 16, 4, C, dtype), C <= 1024)
      for C in (4, 8, 124, 128, 136) for dtype in (BF16, F32)],
    *[(A.bwd_fits, (2, 16, 4, C, dtype), C <= 1024)
      for C in (4, 8, 124, 128, 136) for dtype in (BF16, F32)],
    # K8: the tensor-core body at C a multiple of 8 up to 128 with H C <= 512
    # (the h64 layouts) and D up to 512, the CUDA-core body at C = 4 mod 8 up
    # to 32 with H C <= 128 and D <= 128, the split route past them
    *[(A.fused_gated_fits, (4, 16, D, H, C, dtype), ok)
      for D, H, C, ok in ((64, 1, 64, True), (128, 4, 64, True), (128, 4, 128, True),
                          (64, 1, 136, True), (64, 5, 128, True), (64, 65, 8, True),
                          (64, 9, 12, True), (64, 11, 12, True), (20, 4, 16, True),
                          (136, 1, 64, True))
      for dtype in (BF16, F32)],
    (A.fused_gated_takes_tensor_cores, (64, 4, 16), True),
    (A.fused_gated_takes_tensor_cores, (64, 9, 12), False),
    (A.fused_gated_takes_tensor_cores, (64, 4, 128), True),

    # K9: B N^2 within one projection block per 64 positions
    (M.trimul_fits, (1, 300_000, 64, BF16), True),
    (M.trimul_fits, (1, 400_000, 64, BF16), False),
    (M.trimul_takes_tensor_cores, (72,), True),
    # past 128 on ln_project.cuh's wide block: every multiple of 8 up to 512
    *[(M.trimul_takes_tensor_cores, (D,), ok) for D, ok in ((36, False), (136, True), (192, True),
                                                            (508, False), (512, True),
                                                            (520, False))],
    # K1 fast in f32: 3xTF32 at multiples of 4 up to 1024 (its wide body past
    # 128), bf16 never; its bound at the edges: 1024 in f32, in bf16 the
    # tensor-core tiles' 1168 (C = 4 mod 8 past 1024 too since it takes them)
    *[(A.takes_tf32x3, ("rows_attention_fast", dtype, C), dtype == F32)
      for C in (4, 8, 124, 128, 136) for dtype in (BF16, F32)],
    *[(A.attention_fits, ("rows_attention_fast", 2, 16, 4, C, dtype),
       C <= 1024 or (dtype == BF16 and C <= 1168))
      for C in (4, 8, 124, 128, 136, 1024, 1028, 1164, 1172) for dtype in (BF16, F32)],
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


@pytest.mark.parametrize("D,H,C,body", [
    (64, 4, 16, "tensor cores"), (192, 4, 16, "tensor cores"), (512, 1, 128, "tensor cores"),
    (136, 4, 16, "tensor cores"), (36, 4, 16, "tensor cores"),
    (64, 5, 128, "split"), (64, 1, 136, "split"), (64, 2, 36, "split"), (136, 4, 12, "split"),
    (64, 1, 1024, "split"), (512, 1024, 4, "split"), (64, 4, 36, "split"), (36, 1, 36, "split"),
    (512, 2, 132, "split"), (128, 8, 128, "split"), (64, 9, 12, "cuda cores"),
    (128, 2, 28, "cuda cores"), (513, 4, 16, None), (64, 1, 1028, None), (64, 1025, 4, None),
])
def test_k8_route_by_shape(D, H, C, body):
    """K8's route: the tensor-core body (C a multiple of 8 up to 128, H C up
    to 512, D up to 512: past 128 its projection on ln_project.cuh's wide
    block), the CUDA-core body (C = 4 mod 8 up to 32, H C up to 128, D up to
    128), the split route over the rest of the JAX kernel's reach (on the
    tensor cores at every D: H C = 4 mod 8 and D = 4 mod 8 included), none
    past it."""
    assert A.fused_gated_body(D, H, C) == body
    assert A.fused_gated_fits(4, 16, D, H, C, BF16) is (body is not None)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("D", [1, 36, 128, 136, 192, 508, 512, 513])
def test_k9_k11_take_any_pair_width_up_to_512(D, dtype):
    """K9 and K11 take every pair width from 1 to 512, the JAX kernels'
    reach at these sizes: K9 every multiple of 8 on its tensor-core body
    (past 128 on ln_project.cuh's wide block), every other width on its wide
    body; K11 multiples of 8 up to 128 on its tensor-core body, every other
    width on its CUDA-core one; 513 raises."""
    assert M.trimul_fits(2, 16, D, dtype) is (D <= 512)
    assert O.outer_fits(2, 16, D, dtype) is (D <= 512)
    assert M.trimul_body(D) == ("tensor cores" if D % 8 == 0 and D <= 512 else "wide")
    assert O.outer_takes_tensor_cores(512, D, dtype) is (D == 128)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("C", [128, 132, 256, 1024, 1028])
def test_k3_k5_k6_k7_take_head_widths_up_to_1024(C, dtype):
    """K6 and K7 in both dtypes, and K3 and K5 in f32, take every multiple
    of 4 up to MAX_HEAD_DIM, as K1 and K2 do: on their tensor-core bodies at
    every multiple of 8 up to 1024 (the wide bodies past 128), and K6 and K7
    on the CUDA-core bodies at C = 4 mod 8, where K3 and K5 keep theirs."""
    ok = C <= A.MAX_HEAD_DIM
    wide_ok = ok and C % 8 == 0
    assert A.bwd_fits(2, 16, 4, C, dtype) is ok
    assert A.kchunk_fits("rows_attention_kchunk_bwd", 2, 16, 4, C, dtype) is ok
    assert A.takes_tensor_cores("rows_attention_bwd", dtype, C) is wide_ok
    assert A.takes_tensor_cores("rows_attention_kchunk_bwd", dtype, C) is wide_ok
    if dtype == F32:
        for name in ("rows_attention_kchunk", "rows_attention_kchunk_stats"):
            assert A.kchunk_fits(name, 2, 16, 4, C, dtype) is ok
            assert _body(name, dtype, C) == ("3xtf32" if ok else "cuda cores")


# head widths C = 4 mod 8 -------------------------------------------------------

NARROW_WIDTHS = (4, 12, 36, 124, 132, 1020)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("C", NARROW_WIDTHS)
@pytest.mark.parametrize("name", A.MMA_BODIES)
def test_tensor_cores_at_head_widths_4_mod_8(name, C, dtype):
    """K1, K1 fast, K3 and K5 take C = 4 mod 8 on their tensor-core bodies in
    both dtypes, up to 1020 (bf16 attention_mma.cu's 8-byte staging, f32
    attention_tf32.cu and the wide bodies past 128); K2, K6 and K7 keep
    their CUDA-core bodies there, and every bound still admits the shape."""
    narrow = name in A.NARROW_BODIES
    assert A.tc_width(name, C) is narrow
    assert A.takes_mma(name, dtype, C) is (narrow and dtype == BF16)
    assert A.takes_tf32x3(name, dtype, C) is (narrow and dtype == F32)
    assert A.takes_tensor_cores(name, dtype, C) is narrow
    if name in A.BACKWARDS:
        assert A.kchunk_fits(name, 2, 16, 4, C, dtype) and A.bwd_fits(2, 16, 4, C, dtype)
    elif name in A.KCHUNK_FORWARDS:
        assert A.kchunk_fits(name, 2, 16, 4, C, dtype)
    else:
        assert A.attention_fits(name, 2, 16, 4, C, dtype)


@pytest.mark.parametrize("C", NARROW_WIDTHS)
def test_shared_memory_at_head_widths_4_mod_8(C):
    """A head of C = 4 mod 8 pads in shared memory as C + 4 does: in bf16 to
    CP = C rounded up to 16, in f32 to 8 NT channels up to 128 and past it to
    128-channel chunks; so each body's shared memory, and K3's and the wide
    bodies' queries a block, are C + 4's, and the padded width covers C."""
    cp = -(-C // 16) * 16
    assert C < cp <= C + 12 and cp == -(-(C + 4) // 16) * 16
    for queries in (64, 128):
        assert A.mma_smem_bytes(C, queries) == A.mma_smem_bytes(C + 4, queries)
    assert A.kchunk_queries(C) == A.kchunk_queries(C + 4)
    if C <= A.MAX_TC_HEAD_DIM:
        nt = A._padded_tiles(C)
        assert 8 * nt >= C and nt == A._padded_tiles(C + 4)
        for queries in (64, 128):
            assert A.tf32x3_smem_bytes(C, queries) == A.tf32x3_smem_bytes(C + 4, queries)
    else:
        assert A.wide_queries(C) == A.wide_queries(C + 4)
        assert A.kchunk_wide_tf32x3_smem_bytes(C) == A.kchunk_wide_tf32x3_smem_bytes(C + 4)
        for N, store in ((192, True), (1024, True), (1024, False)):
            assert (A.fast_wide_tf32x3_smem_bytes(C, N, store)
                    == A.fast_wide_tf32x3_smem_bytes(C + 4, N, store))


def test_shared_memory_at_head_width_36():
    """The bytes of attention_mma.cu's smem_bytes at C = 36 (CP = 48, 64-key
    tiles, a 64-channel V slice): 2 (TQ + 128) 56 + 4 64 72 for 64 queries
    (K1) and 128 (K3, K5); attention_tf32.cu's rows_tf32x3_smem at CP = 64
    (32-key tiles): 4 (TQ + 128) 68."""
    assert A.mma_smem_bytes(36, 64) == 2 * (192 * 56 + 2 * 64 * 72) == 39_936
    assert A.mma_smem_bytes(36, A.kchunk_queries(36)) == 2 * (256 * 56 + 2 * 64 * 72) == 47_104
    assert A.tf32x3_smem_bytes(36, 128) == 4 * (256 * 68) == 69_632


def _narrow_inputs(C, jdt, R=3, N=24, H=2, seed=0):
    """q, k, v rounded to ``jdt`` (numpy f32) with |logits| ~ 4, mask [R, N]
    with row 1 fully masked."""
    rng = np.random.RandomState(seed)
    q, k = ((16.0 / C) ** 0.5 * 2.0 * rng.randn(R, N, H, C).astype(np.float32) for _ in range(2))
    v = rng.randn(R, N, H, C).astype(np.float32)
    mask = (rng.rand(R, N) > 0.3).astype(np.float32)
    mask[1] = 0.0
    q, k, v = (np.array(jnp.asarray(x, jdt).astype(jnp.float32)) for x in (q, k, v))
    return q, k, v, mask


NARROW_DTYPES = {"f32": (jnp.float32, F32, 1e-5), "bf16": (jnp.bfloat16, BF16, 2e-2)}


@pytest.mark.parametrize("dtype", sorted(NARROW_DTYPES))
@pytest.mark.parametrize("fast", [False, True], ids=["k1", "k1_fast"])
@pytest.mark.parametrize("C", [12, 36])
def test_k1_plain_matches_jax_at_head_widths_4_mod_8(one_thread, C, fast, dtype):
    """K1 and K1 fast at C = 12 and 36: the port's CPU route (its plain
    version, which the card's kernels are held to) against the JAX
    ``_rows_attention_impl`` (Pallas in interpret mode), the fully masked
    row at the mean of v; K1 within 1e-5 (f32) or 2e-2 (bf16) of max|out|,
    K1 fast within 1e-2 (its bf16 softmax, as test_torch_fast_softmax)."""
    jdt, tdt, tol = NARROW_DTYPES[dtype]
    q, k, v, mask = _narrow_inputs(C, jdt, seed=C)
    scale = C ** -0.5
    t = lambda x: jnp.swapaxes(jnp.asarray(x, jdt), 1, 2)  # noqa: E731
    want = pa._rows_attention_impl(t(q) * jnp.asarray(scale, jdt), t(k), t(v), jnp.asarray(mask),
                                   True, fast=fast)
    want = np.asarray(jnp.swapaxes(want, 1, 2).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    fn = A.rows_attention_fast if fast else A.rows_attention
    before = dict(A.LAUNCHES)
    got = fn(tq, tk, tv, torch.from_numpy(mask), scale)
    assert A.LAUNCHES == before and got.dtype == tdt
    got = got.float().numpy()
    assert np.isfinite(got).all()
    tol = 1e-2 if fast else tol
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(0), got[1].shape),
                               atol=tol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dtype", sorted(NARROW_DTYPES))
@pytest.mark.parametrize("stats", [False, True], ids=["k3", "k5"])
@pytest.mark.parametrize("C", [12, 36])
def test_k3_k5_plain_matches_jax_at_head_widths_4_mod_8(one_thread, monkeypatch, C, stats, dtype):
    """K3 and K5 at C = 12 and 36 in the K-chunk regime (the switch lowered
    to N = 16 and the chunk to 8 on both sides, as tests/test_torch_kchunk.py
    lowers them): the port's plain K3 and K5 (the CPU route) against the JAX
    ``_rows_attention_kchunk_grid_cn`` and ``_rows_attention_fwd_stats_impl``
    (Pallas in interpret mode), out within 1e-5 (f32) or 2e-2 (bf16) of
    max|out|; K5's m and log s within 1e-5, the fully masked row's m the
    fill and its log s log N."""
    for mod in (A, pa):
        monkeypatch.setattr(mod, "ROWS_KCHUNK_MIN_N", 16)
        monkeypatch.setattr(mod, "ROWS_KCHUNK_MIN_N_F32", 16)
    monkeypatch.setattr(A, "KCHUNK", 8)
    monkeypatch.setattr(pa, "_KCHUNK_TARGET", 8)
    jdt, tdt, tol = NARROW_DTYPES[dtype]
    q, k, v, mask = _narrow_inputs(C, jdt, R=2, N=24, seed=40 + C)
    R, N = mask.shape
    scale = C ** -0.5
    t = lambda x: jnp.swapaxes(jnp.asarray(x, jdt), 1, 2)  # noqa: E731
    jq, jk, jv, jm = t(q) * jnp.asarray(scale, jdt), t(k), t(v), jnp.asarray(mask)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    before = dict(A.LAUNCHES)
    if stats:
        j_out, j_m, j_logs = pa._rows_attention_fwd_stats_impl(jq, jk, jv, jm, True)
        out, m, logs = A.rows_attention_kchunk_stats(tq, tk, tv, torch.from_numpy(mask), scale)
    else:
        j_out = pa._rows_attention_kchunk_grid_cn(jq, jk, jv, jm, 8, pa._kchunk_rb(R), True)
        out = A.rows_attention_kchunk(tq, tk, tv, torch.from_numpy(mask), scale)
    assert A.LAUNCHES == before
    want = np.asarray(jnp.swapaxes(j_out, 1, 2).astype(jnp.float32))
    got = out.float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())
    if stats:
        np.testing.assert_allclose(m.numpy(), np.asarray(j_m), rtol=1e-5,
                                   atol=1e-5 * max(1.0, float(m.abs().max())))
        np.testing.assert_allclose(logs.numpy(), np.asarray(j_logs), atol=1e-5, rtol=1e-5)
        assert (m[1] == A.NEG_INF).all()
        np.testing.assert_allclose(logs[1].numpy(), np.log(float(N)), rtol=1e-6)


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
    """Below the switch K7 takes C <= 1024 in bf16 (its CUDA-core body past
    128): a gradient at C = 1032 raises before K1 launches; without a
    gradient K1's bf16 tensor-core body takes the shape."""
    q, k, v, mask = (t.to(BF16) if t.dtype == F32 and t.dim() == 4 else t
                     for t in _qkv(2, 8, 1, 1032))
    q.requires_grad_(True)
    assert A.attention_fits("rows_attention", 2, 8, 1, 1032, BF16)
    with pytest.raises(ValueError, match="K7"):
        A.rows_attention(q, k, v, mask, 0.1)
    assert as_if_on_cuda == []
    with torch.no_grad():
        A.rows_attention(q, k, v, mask, 0.1)
    assert as_if_on_cuda == [("rows_attention", 1032)]


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


@pytest.mark.parametrize("C,grad", [(1028, False), (136, True), (1028, True)])
def test_cpu_tensors_take_the_plain_version_at_any_width(C, grad):
    """On the CPU the wrappers take their plain versions whatever the bound:
    K2 past 1024, and a triangle attention with a gradient past K7's 1024."""
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


def test_fused_gated_at_pair_width_192_reaches_the_launcher(as_if_on_cuda, monkeypatch):
    """K8 at pair width 192 (past the old bound of 128) on CUDA tensors
    reaches its launcher, which the route's bound admits (the tensor-core
    body), and takes no plain version; the launcher's stand-in returns the
    plain version's output."""
    launched = []

    def launch(x, mask, *ws):
        D, (HC, H) = x.shape[-1], (ws[0].shape[0], ws[-1])
        R, N = x.shape[0] * x.shape[1], x.shape[2]
        assert A.fused_gated_fits(R, N, D, H, HC // H, x.dtype)
        launched.append((D, H, HC // H, A.fused_gated_body(D, H, HC // H)))
        return A.fused_gated_reference(x, mask, *ws)

    monkeypatch.setattr(A, "_launch_fused_gated", launch)
    x, mask, ws, H = _gated_case(seed=3, N=6, D=192, H=4, C=16)
    got = A.fused_gated_rows_attention(*_t(x, mask), *_t(*ws), H)
    assert launched == [(192, 4, 16, "tensor cores")]
    want = A.fused_gated_reference(*_t(x, mask), *_t(*ws), H)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("D,H,C", [(192, 4, 16), (64, 1, 256), (64, 4, 36), (128, 8, 128)],
                         ids=["d192", "c256", "c36", "hc1024"])
def test_fused_gated_plain_matches_jax_past_the_old_bound(D, H, C):
    """K8's plain version at the widths the JAX kernel takes past the old
    bound (pair width 192; one head of 256; C = 36, not a multiple of 8, past
    32; H C = 1024) against the JAX ``_fused_gated_impl`` (Pallas in
    interpret mode), f32, 1e-5, N = 8 with fully masked rows."""
    x, mask2d, ws, _ = _gated_case(seed=11, N=8, D=D, H=H, C=C)
    got = A.fused_gated(*_t(x, mask2d), *_t(*ws), H).numpy()
    pallas = _jax_gated(x, mask2d, ws, H, lambda *a: pa._fused_gated_impl(*a, True))
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=1e-5)


def test_fused_configuration_at_pair_width_192_matches_jax(monkeypatch):
    """Pair width 192 (past the old bound of K8, 128) with the four
    switches, against the JAX kernels in interpret mode."""
    assert A.fused_gated_body(192, FUSED_CFG.num_heads, FUSED_CFG.head_dim) == "tensor cores"
    _fused_forward_matches_jax(monkeypatch, 192)


def test_fused_configuration_at_pair_width_72_matches_jax(monkeypatch):
    """The four switches at pair width 72 (past the old bound of K8, K9 and
    K11, 64): every fused wrapper runs, once per module call. The forward
    against the JAX model with the same switches (its Pallas kernels in
    interpret mode, which take any width)."""
    _fused_forward_matches_jax(monkeypatch, 72)


def test_fused_configuration_at_pair_width_36_matches_jax(monkeypatch):
    """Pair width 36 (not a multiple of 8: K9's wide body and K11's CUDA-core
    one on the card) with the four switches, through the plain route here,
    against the JAX kernels in interpret mode."""
    assert M.trimul_body(36) == "wide" and M.trimul_fits(2, 32, 36, F32)
    _fused_forward_matches_jax(monkeypatch, 36)


def _fused_forward_matches_jax(monkeypatch, pair_dim):
    cfg = FUSED_CFG.replace(pair_dim=pair_dim)
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
