// Hand-written Hopper (sm_90a) tensor-core body of the rows attention in
// float32, for head widths that are a multiple of 4 up to 128:
//
//   rows_attention_tf32x3_kernel
//       <- _rows_attention_impl / _make_rowhead_kernel (K1: triangle
//          attention, key mask, no bias, below the K-chunk switch)
//   rows_attention_kchunk_tf32x3_kernel<STATS = false>
//       <- _make_rowhead_kchunk_grid_cn_kernel (K3, and K4 and the fori
//          variant, which differ only in TPU layout)
//   rows_attention_kchunk_tf32x3_kernel<STATS = true>
//       <- _make_rowhead_kchunk_grid_cn_stats_kernel (K5: the training
//          forward, which also writes the row max m and log s, kept split)
//
//   rows_attention_fast_tf32x3_kernel
//       <- _rows_attention_impl with fast=True (K1 fast: the softmax
//          rounded as bf16, cfg.fast_softmax; serving an f32 checkpoint)
//
//   (Past C = 128: K3 and K5 attention_kchunk_wide_tf32.cu, K1
//   attention_rows_wide_tf32.cu, K1 fast attention_fast_wide_tf32.cu.)
//
// of protein_redesign_tpu/ops/pallas_attention.py. It replaces, for those
// widths, the CUDA-core bodies of attention.cu (K1, K1 fast) and
// attention_kchunk.cu (K3, K5), kept callable to time them beside this
// one. A head of C = 4 mod 8 needs no path of its own in f32: a row of C
// floats is a multiple of 16 bytes, stage_f32 copies 4 channels a piece and
// zero-fills the pieces past C up to CP, and the sums over the padded
// channels add exact zeros (K1 fast's near-midpoint chain, dot_smem, stops
// at channel C - 1).
//
// The function is K3's and K5's f32 plain version (_kchunk_forward_block):
// f32 logits of the pre-scaled q (q * scale in f32), -2^15 at masked keys,
// -inf past N, a running max from -inf, p = exp(l - m') in f32 summed into
// s, acc = acc exp(m - m') + p V with p left in f32 (the reference's
// p.astype(v.dtype) is a no-op in f32), out = acc / s at the end; K5 writes
// m and log s, f32 [R, H, N]. A fully masked row gets m = -2^15, uniform p
// and the mean of v; its stats are m = -2^15 and log s = log N. In f32 that
// is also K1's function: the Pallas K1 (and attention_reference) takes the
// softmax in two passes and rounds P to the input type, a no-op in f32, so
// the two differ only in the order of f32 sums, well inside 1e-5. So K1 runs
// the same body (rows_tf32x3_body, attention_tf32.cuh) under its own kernel
// name, which a profile tells apart.
//
// What bounds it on the card. f32 products on the CUDA cores run at 67
// TFLOP/s, and one TF32 product keeps only three decimal digits, which
// breaks the 1e-5 parity. So every product runs on the tensor cores in
// 3xTF32 (mma.sync m16n8k8, mma.cuh): each operand split into a TF32 big
// and small part, three products with f32 sums, within about 2^-21 of the
// f32 product, under the f32 summation-order noise the 1e-5 gates admit.
// This is the method of CUTLASS's OpMultiplyAddFastF32, which PyTorch's
// f32 memory-efficient attention uses. The best it can do is 495 / 3 = 165
// TFLOP/s. At head width 16 the products are two mma depth steps, and the
// exponential (16 per SM and clock) and the splits set the pace, as for the
// bf16 bodies.
//
// Layout of the work, as K3's bf16 body (attention_mma.cu): a block of 128
// queries (8 warps of 16 rows) staged once, pre-scaled, as f32; 64-key tiles
// (32 from CP = 32 on) of K and V staged by cp.async, double-buffered; the
// tile's mask by ballot; one step of online softmax per tile in registers.
// K1 runs below the switch, at buckets from 64 up, where 128 queries a block
// would pad a third of the slots at N = 192 and half at N = 64: it takes 64
// queries (4 warps) where that pads fewer slots (rows_tf32x3_warps), else
// 128. The f32 fragment reads, the staging and P.V with P taken from the S
// accumulators as they lie (each 8-key n-tile's keys renumbered, no
// shuffle) are attention_tf32.cuh's, which K2's (attention_tiled_tf32.cu)
// and K6's and K7's f32 bodies (attention_bwd_tf32.cu) share.
//
// K1 fast keeps rows_attention_fast_reference's function point by point, as
// its bf16 body (attention_mma.cu) does: l = bf16(q k) after the fill; m =
// max l; e = bf16(exp(bf16(l - m))); s = bf16(sum of e in f32); p = bf16(e
// / s); P.V in f32. Rounding each term against the final max takes three
// passes over the keys (the max, the sum, P.V). The TPU kernel keeps a whole
// [TQ, N] logits block in VMEM; here a block of 64 queries keeps its rows'
// rounded logits in shared memory, two bf16 a 32-bit word in the
// accumulators' fragment order (each thread reads back only what it wrote:
// N 128 bytes a block, 48 KB at N = 384), so S = Q K^T runs once: pass 1
// turns the stored logits into e in place and pass 2 streams V alone
// (STORE; where the words do not fit, past N ~ 1680 at C = 16 and ~ 1280 at
// C = 128, every pass recomputes
// the logits from K instead). The logits are 3xTF32; a logit that lies
// within kNearF32 2^-24 |q| |k| of a bf16 rounding midpoint is recomputed
// as the CUDA-core body and the plain version sum it, one f32 FMA chain over
// the channels in order (dot_smem), so that the order of the sums does not
// move its rounding. 3xTF32 drops the small x small terms and sums in
// another order; both errors scale with sum |q_c k_c| <= |q| |k|, not with
// the logit, and in the CPU emulation (tests/test_torch_tf32x3.py) they
// move a logit by at most 4.0 2^-24 |q| |k| at C = 16 to 128 and logits of
// any scale, so 32 holds an 8x margin (1% of the logits at C = 16 fall
// inside it). The norms: each query row's once, each key's once per key
// tile by its warp (the warp's own copy, so no block barrier). P is a bf16 value, exact
// in TF32, so P.V needs two TF32 products (p v_big + p v_small), not three:
// p's small part is 0, and the two give the three's bits (the emulation
// checks it). What can still differ from the plain version is the f32 sum
// of e, so it is held to 2e-2.
//
// Layout: q, k, v are [R, N, H, C] f32 with the head dimension contiguous,
// the other strides given in elements, every row 16-byte aligned (C and the
// strides multiples of 4, checked by the wrapper); mask is contiguous f32
// [R, N]; out is contiguous [R, N, H, C]; m and log s contiguous [R, H, N].
// Heads are padded in shared memory with zeros to CP = 8 NT channels (8,
// 16, 32, 64 or 128). Shared memory: 4 (TQ + 4 BK) (CP + 4) bytes, 30 KB at C = 16 and
// 132 KB at C = 128 with TQ = 128; K1 fast with STORE 4 (64 + 2 BK)
// (CP + 4) bytes plus 128 N (64.5 KB at C = 16, N = 384). The entry points
// return cudaGetLastError() after their launch.

#include "attention_tf32.cuh"

namespace {

constexpr int kF32Warps = 8;  // K3 and K5: 128 queries a block

template <bool STATS, int NT>
__global__ void __launch_bounds__(kF32Warps * 32, kF32MinBlocks<kF32Warps, NT>)
    rows_attention_kchunk_tf32x3_kernel(const F32Args a) {
  rows_tf32x3_body<STATS, false, true, kF32Warps, NT>(a);
}

template <int WARPS, int NT>
__global__ void __launch_bounds__(WARPS * 32, kF32MinBlocks<WARPS, NT>)
    rows_attention_tf32x3_kernel(const F32Args a) {
  rows_tf32x3_body<false, false, true, WARPS, NT>(a);
}

// K1's warps a block at N keys: 4 (64 queries) where 128 would pad more
// query slots, else 8.
int rows_tf32x3_warps(int N) { return (N + 127) / 128 * 128 > (N + 63) / 64 * 64 ? 4 : 8; }

// K1 (ROWS), K3 or K5 (STATS) at the padded width of NT n-tiles.
template <bool ROWS, bool STATS, int NT>
cudaError_t launch(const F32Args& a, cudaStream_t stream) {
  if constexpr (ROWS) {
    if (rows_tf32x3_warps(a.N) == 4)
      return launch_f32(rows_attention_tf32x3_kernel<4, NT>, 4 * 32, 64,
                        rows_tf32x3_smem<4, NT, false>(), a, stream);
    return launch_f32(rows_attention_tf32x3_kernel<8, NT>, 8 * 32, 128,
                      rows_tf32x3_smem<8, NT, false>(), a, stream);
  } else {
    return launch_f32(rows_attention_kchunk_tf32x3_kernel<STATS, NT>, kF32Warps * 32,
                      16 * kF32Warps, rows_tf32x3_smem<kF32Warps, NT, false>(), a, stream);
  }
}

template <bool ROWS, bool STATS>
cudaError_t dispatch_width(const F32Args& a, cudaStream_t stream) {
  if (a.C <= 8) return launch<ROWS, STATS, 1>(a, stream);
  if (a.C <= 16) return launch<ROWS, STATS, 2>(a, stream);
  if (a.C <= 32) return launch<ROWS, STATS, 4>(a, stream);
  if (a.C <= 64) return launch<ROWS, STATS, 8>(a, stream);
  return launch<ROWS, STATS, 16>(a, stream);
}

// kNearF32 2^-24 |x| for a row of C floats in shared memory.
__device__ __forceinline__ float window_scale(const float* row, int C) {
  return kNearF32 * 0x1p-24f * sqrtf(dot_smem(row, row, C));
}

// The window scales of a staged key tile's BK keys into the warp's own
// array (each lane its keys), for fast_logits to read after a __syncwarp.
template <int BK>
__device__ __forceinline__ void key_scales(const float* k_t, int ld, int C, int lane,
                                           float* nk_w) {
#pragma unroll
  for (int j = lane; j < BK; j += 32) nk_w[j] = sqrtf(dot_smem(k_t + j * ld, k_t + j * ld, C));
  __syncwarp();
}

// K1 fast's logits of a staged key tile for the warp's 16 rows: S = Q K^T in
// 3xTF32; -2^15 at masked keys, -inf past N; a logit of a live row within
// the window (kq_a, kq_b: the rows' window scales; nk_w the keys' norms)
// recomputed by dot_smem (one at a time, through one copy of the chain,
// selected back into its register); each rounded to bf16.
template <int NS, int CP>
__device__ __forceinline__ void fast_logits(const float* q_w, const float* k_t, int ld, int C,
                                            const TileMask<8 * NS>& tm, float* nk_w, float kq_a,
                                            float kq_b, int lane, float (&s)[NS][4]) {
  key_scales<8 * NS>(k_t, ld, C, lane, nk_w);
  logits_tf32<NS, CP>(q_w, k_t, ld, lane, s);
  unsigned near = 0;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float l = s[n][e];
      if (!tm.in_range(n, e)) {
        l = neg_inf();
      } else if (!tm.kept(n, e)) {
        l = kMaskFill;
      } else if (near_bf16_midpoint_f32(
                     l, (e < 2 ? kq_a : kq_b) * nk_w[n * 8 + (lane & 3) * 2 + (e & 1)])) {
        near |= 1u << (4 * n + e);
      }
      s[n][e] = l;
    }
  }
  while (near) {
    const int i = __ffs(near) - 1;
    near &= near - 1;
    const int n = i >> 2, e = i & 3;
    const float l = dot_smem(q_w + ((lane >> 2) + 8 * (e >> 1)) * ld,
                             k_t + (n * 8 + (lane & 3) * 2 + (e & 1)) * ld, C);
#pragma unroll
    for (int j = 0; j < 4 * NS; ++j)
      if (j == i) s[j >> 2][j & 3] = l;
  }
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = bf16_round(s[n][e]);
}

// e = bf16(exp(bf16(l - m))) of rounded logits in place, summed into the
// thread's partial row sums.
template <int NS>
__device__ __forceinline__ void fast_exp(float (&s)[NS][4], float m_a, float m_b, float& s_a,
                                         float& s_b) {
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = bf16_round(expf(bf16_round(s[n][e] - (e < 2 ? m_a : m_b))));
      (e < 2 ? s_a : s_b) += s[n][e];
    }
  }
}

// A tile's four bf16 values a thread holds per n-tile as two 32-bit words
// (row g: keys 2t, 2t + 1; row g + 8: the same), in shared memory at
// w[(2n + j) 32] (the lane's own column: conflict-free).
template <int NS>
__device__ __forceinline__ void put_words(unsigned* w, const float (&s)[NS][4]) {
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    w[(2 * n) * 32] = pack_bf16(s[n][0], s[n][1]);
    w[(2 * n + 1) * 32] = pack_bf16(s[n][2], s[n][3]);
  }
}

template <int NS>
__device__ __forceinline__ void get_words(const unsigned* w, float (&s)[NS][4]) {
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const unsigned x = w[(2 * n) * 32], y = w[(2 * n + 1) * 32];
    s[n][0] = __uint_as_float(x << 16);
    s[n][1] = __uint_as_float(x & 0xffff0000u);
    s[n][2] = __uint_as_float(y << 16);
    s[n][3] = __uint_as_float(y & 0xffff0000u);
  }
}

// acc += P X for P of bf16 values (exact in TF32, so its small part is 0):
// pv_tf32's products without the a_small b_big one, which adds exact zeros,
// into a fresh fragment in the same order: the same bits from two products.
template <int NS, int NT>
__device__ __forceinline__ void pv_tf32x2(const float (&p)[NS][4], const float* x_t, int ld,
                                          int lane, float (&acc)[NT][4]) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {
    const unsigned a[4] = {__float_as_uint(p[kk][0]), __float_as_uint(p[kk][2]),
                           __float_as_uint(p[kk][1]), __float_as_uint(p[kk][3])};
    const float* x_row = x_t + (kk * 8 + 2 * t4) * ld + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      unsigned bb0, bs0, bb1, bs1;
      split_tf32(x_row[n * 8], bb0, bs0);
      split_tf32(x_row[ld + n * 8], bb1, bs1);
      float t[4] = {0.f, 0.f, 0.f, 0.f};
      mma_tf32_1688(t, a, bs0, bs1);
      mma_tf32_1688(t, a, bb0, bb1);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += t[i];
    }
  }
}

constexpr int kFastWarps = 4;  // K1 fast: 64 queries a block

// Shared memory of K1 fast's f32 body at N keys: the block's queries, two
// key tiles (K's in pass 0, V's in pass 2) and each warp's key norms, plus
// the stored logits (STORE: N padded to the key tile, 128 bytes a key);
// without STORE two K and two V tiles.
template <int NT>
size_t fast_tf32x3_smem(int N, bool store) {
  constexpr int TQ = 16 * kFastWarps, BK = kF32Keys<NT>, LD = 8 * NT + 4;
  const size_t keys = (size_t)(N + BK - 1) / BK * BK;
  return sizeof(float) * ((TQ + (store ? 2 : 4) * BK) * LD + kFastWarps * BK) +
         (store ? keys * 128 : 0);
}

// Whether the logits are kept (a block of that size fits on an SM).
bool fast_stores_logits(size_t smem) { return smem <= 227 * 1024; }

template <bool STORE, int NT>
__global__ void __launch_bounds__(kFastWarps * 32, kF32MinBlocks<kFastWarps, NT>)
    rows_attention_fast_tf32x3_kernel(const F32Args a) {
  constexpr int TQ = 16 * kFastWarps, BK = kF32Keys<NT>, NS = BK / 8, CP = 8 * NT, LD = CP + 4;
  extern __shared__ __align__(16) float smem_f[];
  float* q_s = smem_f;                        // [TQ][LD], pre-scaled
  float* k_s = q_s + TQ * LD;                 // [2][BK][LD]
  float* v_s = STORE ? k_s : k_s + 2 * BK * LD;  // [2][BK][LD]
  float* nk_s = v_s + 2 * BK * LD;                // [kFastWarps][BK]: key norms
  unsigned* lg_s = reinterpret_cast<unsigned*>(nk_s + kFastWarps * BK);  // STORE
  const int N = a.N, C = a.C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Block b = block_of<TQ>(N, CP);
  const float* k_base = a.k + b.r * a.ks.r + b.h * a.ks.h;
  const float* v_base = a.v + b.r * a.vs.r + b.h * a.vs.h;
  const float* mask_row = a.mask + (long long)b.r * N;
  const int tiles = (N + BK - 1) / BK;
  const float* q_w = q_s + warp * 16 * LD;
  const int row_a = b.q0 + warp * 16 + (lane >> 2);
  float* nk_w = nk_s + warp * BK;
  unsigned* lg_w = lg_s + warp * tiles * NS * 64 + lane;  // this thread's words
  // the rows' window scales once q is in (the first tile's barrier); a row
  // past N keeps -inf, so that nothing of it is recomputed
  float kq_a = neg_inf(), kq_b = neg_inf();

  stage_q_f32(a.q + b.r * a.qs.r + b.h * a.qs.h, a.qs.n, b.q0, TQ, N, C, CP, LD, a.scale, q_s);
  float m_a = neg_inf(), m_b = neg_inf(), s_a = 0.f, s_b = 0.f;
  // pass 0: the rounded logits' row max (STORE: the logits kept)
  stage_f32(k_base, a.ks.n, 0, BK, N, C, CP, LD, k_s);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles)
      stage_f32(k_base, a.ks.n, (t + 1) * BK, BK, N, C, CP, LD, k_s + (buf ^ 1) * BK * LD);
    cp_async_commit();
    const TileMask<BK> tm = tile_mask<BK>(mask_row, t * BK, N, lane);
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
      if (row_a < N) kq_a = window_scale(q_w + (lane >> 2) * LD, C);
      if (row_a + 8 < N) kq_b = window_scale(q_w + ((lane >> 2) + 8) * LD, C);
    }
    float s[NS][4];
    fast_logits<NS, CP>(q_w, k_s + buf * BK * LD, LD, C, tm, nk_w, kq_a, kq_b, lane, s);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      m_a = fmaxf(m_a, fmaxf(s[n][0], s[n][1]));
      m_b = fmaxf(m_b, fmaxf(s[n][2], s[n][3]));
    }
    if (STORE) put_words<NS>(lg_w + t * NS * 64, s);
    __syncthreads();  // the next tile's loads overwrite this buffer
  }
  m_a = quad_max(m_a);
  m_b = quad_max(m_b);

  // pass 1: s = bf16(sum of e) (STORE: e kept in place of the logits)
  if (STORE) {
    for (int t = 0; t < tiles; ++t) {
      float s[NS][4];
      get_words<NS>(lg_w + t * NS * 64, s);
      fast_exp<NS>(s, m_a, m_b, s_a, s_b);
      put_words<NS>(lg_w + t * NS * 64, s);
    }
  } else {
    stage_f32(k_base, a.ks.n, 0, BK, N, C, CP, LD, k_s);
    cp_async_commit();
    for (int t = 0; t < tiles; ++t) {
      const int buf = t & 1;
      if (t + 1 < tiles)
        stage_f32(k_base, a.ks.n, (t + 1) * BK, BK, N, C, CP, LD, k_s + (buf ^ 1) * BK * LD);
      cp_async_commit();
      const TileMask<BK> tm = tile_mask<BK>(mask_row, t * BK, N, lane);
      cp_async_wait<1>();
      __syncthreads();
      float s[NS][4];
      fast_logits<NS, CP>(q_w, k_s + buf * BK * LD, LD, C, tm, nk_w, kq_a, kq_b, lane, s);
      fast_exp<NS>(s, m_a, m_b, s_a, s_b);
      __syncthreads();
    }
  }
  s_a = bf16_round(quad_sum(s_a));
  s_b = bf16_round(quad_sum(s_b));

  // pass 2: p = bf16(e / s), acc += P V
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  if (!STORE) stage_f32(k_base, a.ks.n, 0, BK, N, C, CP, LD, k_s);
  stage_f32(v_base, a.vs.n, 0, BK, N, C, CP, LD, v_s);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      if (!STORE)
        stage_f32(k_base, a.ks.n, (t + 1) * BK, BK, N, C, CP, LD, k_s + (buf ^ 1) * BK * LD);
      stage_f32(v_base, a.vs.n, (t + 1) * BK, BK, N, C, CP, LD, v_s + (buf ^ 1) * BK * LD);
    }
    cp_async_commit();
    TileMask<BK> tm;
    if (!STORE) tm = tile_mask<BK>(mask_row, t * BK, N, lane);
    cp_async_wait<1>();
    __syncthreads();
    float s[NS][4];
    if (STORE) {
      get_words<NS>(lg_w + t * NS * 64, s);
    } else {
      float unused_a = 0.f, unused_b = 0.f;
      fast_logits<NS, CP>(q_w, k_s + buf * BK * LD, LD, C, tm, nk_w, kq_a, kq_b, lane, s);
      fast_exp<NS>(s, m_a, m_b, unused_a, unused_b);
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = bf16_round(__fdiv_rn(s[n][0], s_a));
      s[n][1] = bf16_round(__fdiv_rn(s[n][1], s_a));
      s[n][2] = bf16_round(__fdiv_rn(s[n][2], s_b));
      s[n][3] = bf16_round(__fdiv_rn(s[n][3], s_b));
    }
    pv_tf32x2<NS, NT>(s, v_s + buf * BK * LD, LD, lane, acc);
    __syncthreads();  // the next tile's loads overwrite this buffer
  }
  store_tile_f32<NT>(a.out, N, a.H, C, b, row_a, acc, 1.f, 1.f, lane);
}

template <int NT>
cudaError_t launch_fast(const F32Args& a, cudaStream_t stream) {
  const size_t stored = fast_tf32x3_smem<NT>(a.N, true);
  if (fast_stores_logits(stored))
    return launch_f32(rows_attention_fast_tf32x3_kernel<true, NT>, kFastWarps * 32,
                      16 * kFastWarps, stored, a, stream);
  return launch_f32(rows_attention_fast_tf32x3_kernel<false, NT>, kFastWarps * 32,
                    16 * kFastWarps, fast_tf32x3_smem<NT>(a.N, false), a, stream);
}

F32Args rows_args(const void* q, const void* k, const void* v, const void* mask, void* out,
                  void* m, void* logs, int R, int N, int H, int C, float scale, long long q_sr,
                  long long q_sn, long long q_sh, long long k_sr, long long k_sn, long long k_sh,
                  long long v_sr, long long v_sn, long long v_sh) {
  return F32Args{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<const float*>(mask), nullptr,
                 static_cast<float*>(out), static_cast<float*>(m), static_cast<float*>(logs),
                 R, N, H, C, scale, {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh}, {v_sr, v_sn, v_sh},
                 false};
}

}  // namespace

extern "C" {

// K1 in f32 on the tensor cores (3xTF32): masked attention without bias
// below the K-chunk switch, by K3's one pass of online softmax. C a multiple
// of 8 up to 128.
int prd_rows_attention_tf32x3(const void* q, const void* k, const void* v, const void* mask,
                              void* out, int R, int N, int H, int C, float scale, long long q_sr,
                              long long q_sn, long long q_sh, long long k_sr, long long k_sn,
                              long long k_sh, long long v_sr, long long v_sn, long long v_sh,
                              void* stream) {
  const F32Args a = rows_args(q, k, v, mask, out, nullptr, nullptr, R, N, H, C, scale, q_sr,
                              q_sn, q_sh, k_sr, k_sn, k_sh, v_sr, v_sn, v_sh);
  if (!f32_operands_ok(a, 4) || C > 128 || mask == nullptr) return (int)cudaErrorInvalidValue;
  return (int)dispatch_width<true, false>(a, static_cast<cudaStream_t>(stream));
}

// K1 fast in f32 on the tensor cores (3xTF32 logits, P.V in two TF32
// products): masked attention without bias, the softmax rounded as bf16.
// C a multiple of 4 up to 128.
int prd_rows_attention_fast_tf32x3(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, int R, int N, int H, int C,
                                   float scale, long long q_sr, long long q_sn, long long q_sh,
                                   long long k_sr, long long k_sn, long long k_sh, long long v_sr,
                                   long long v_sn, long long v_sh, void* stream) {
  const F32Args a = rows_args(q, k, v, mask, out, nullptr, nullptr, R, N, H, C, scale, q_sr,
                              q_sn, q_sh, k_sr, k_sn, k_sh, v_sr, v_sn, v_sh);
  if (!f32_operands_ok(a, 4) || C > 128 || mask == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 8) return (int)launch_fast<1>(a, s);
  if (C <= 16) return (int)launch_fast<2>(a, s);
  if (C <= 32) return (int)launch_fast<4>(a, s);
  if (C <= 64) return (int)launch_fast<8>(a, s);
  return (int)launch_fast<16>(a, s);
}

// K3 (m and logs null) or K5 (both given) in f32 on the tensor cores
// (3xTF32): masked attention without bias by online softmax over key tiles.
// C a multiple of 4 up to 128 (past it attention_kchunk_wide_tf32.cu).
int prd_rows_attention_kchunk_tf32x3(const void* q, const void* k, const void* v,
                                     const void* mask, void* out, void* m, void* logs, int R,
                                     int N, int H, int C, float scale, long long q_sr,
                                     long long q_sn, long long q_sh, long long k_sr,
                                     long long k_sn, long long k_sh, long long v_sr,
                                     long long v_sn, long long v_sh, void* stream) {
  const F32Args a = rows_args(q, k, v, mask, out, m, logs, R, N, H, C, scale, q_sr, q_sn, q_sh,
                              k_sr, k_sn, k_sh, v_sr, v_sn, v_sh);
  if (!f32_operands_ok(a, 4) || C > 128 || mask == nullptr || (m == nullptr) != (logs == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(m != nullptr ? dispatch_width<false, true>(a, s)
                            : dispatch_width<false, false>(a, s));
}

}  // extern "C"
