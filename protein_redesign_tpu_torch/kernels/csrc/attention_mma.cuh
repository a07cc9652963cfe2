// The tensor-core building blocks that the bf16 attention kernels share
// (attention_mma.cu: K1, K1 fast, K2, K3 and K5; attention_bwd_mma.cu: K6
// and K7): the launch arguments, the staging of query and key tiles, the two
// products of a flash pass (S = Q K^T and O += P V, 16 rows a warp), the
// quad reductions over a row's four lanes, the block's position, the output
// store, the online-softmax pass over every key tile (rows_pass), the
// backward's row stats and the entry points' alignment check. The f32
// bodies (attention_tf32.cuh) take the dtype-free parts: the block, the tile
// mask, the online-softmax step, the row stats and the alignment check.
// Included by .cu files only; everything is file-local.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kTQ = 16 * kWarps;  // queries per block: 16 rows per warp

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const float* mask;
  const bf16* bias;
  bf16* out;
  int R, N, H, C;
  float scale;
  Strides qs, ks, vs;
};

// The block's TQ-query tile into shared memory, multiplied by the scale and
// rounded to bf16 (the pre-scaled q), rows past N and channels past C zero.
// NARROW (K1, K1 fast, K3 and K5 at C = 4 mod 8): the rows start on 8
// bytes, so 8-byte pieces of 4 channels (C a multiple of 4: a piece is
// wholly inside C or wholly past it); else 16-byte pieces of 8.
template <int TQ = kTQ, bool NARROW = false>
__device__ __forceinline__ void stage_q(const Args& a, const bf16* q_base, int q0, int CP, int ld,
                                        bf16* q_s) {
  if constexpr (NARROW) {
    const int chunks = CP / 4;
    for (int e = threadIdx.x; e < TQ * chunks; e += blockDim.x) {
      const int i = e / chunks;
      const int c = (e - i * chunks) * 4;
      const int qi = q0 + i;
      uint2 raw = make_uint2(0u, 0u);
      if (qi < a.N && c < a.C) {
        raw = *reinterpret_cast<const uint2*>(q_base + (long long)qi * a.qs.n + c);
        bf16* x = reinterpret_cast<bf16*>(&raw);
#pragma unroll
        for (int t = 0; t < 4; ++t) x[t] = __float2bfloat16_rn(__bfloat162float(x[t]) * a.scale);
      }
      *reinterpret_cast<uint2*>(q_s + i * ld + c) = raw;
    }
    return;
  }
  const int chunks = CP / 8;
  for (int e = threadIdx.x; e < TQ * chunks; e += blockDim.x) {
    const int i = e / chunks;
    const int c = (e - i * chunks) * 8;
    const int qi = q0 + i;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (qi < a.N && c < a.C) {
      raw = *reinterpret_cast<const uint4*>(q_base + (long long)qi * a.qs.n + c);
      bf16* x = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int t = 0; t < 8; ++t) x[t] = __float2bfloat16_rn(__bfloat162float(x[t]) * a.scale);
    }
    *reinterpret_cast<uint4*>(q_s + i * ld + c) = raw;
  }
}

// Rows [k0, k0 + rows) and channels [c0, c0 + width) of one head of K or V
// into shared memory by cp.async (row stride ld); rows past N and channels
// past C are zero-filled. NARROW: 8-byte pieces, as stage_q's, and only
// those inside C (channels [C - c0, width) of the tile stay as zero_tail
// left them), each thread stepping through its pieces without a division.
template <bool NARROW = false>
__device__ __forceinline__ void stage_keys(const bf16* base, long long stride_n, int k0, int rows,
                                           int N, int C, int c0, int width, int ld, bf16* dst) {
  if constexpr (NARROW) {
    const int chunks = min(width, C - c0) / 4;  // c0 < C: a slice holds a channel below C
    const int dj = blockDim.x / chunks, dc = blockDim.x - dj * chunks;
    int j = threadIdx.x / chunks, cc = threadIdx.x - j * chunks;
    while (j < rows) {
      const int key = k0 + j;
      const bool ok = key < N;
      cp_async8(dst + j * ld + 4 * cc, ok ? base + (long long)key * stride_n + c0 + 4 * cc : base,
                ok);
      j += dj;
      cc += dc;
      if (cc >= chunks) {
        cc -= chunks;
        ++j;
      }
    }
    return;
  }
  const int chunks = width / 8;
  for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
    const int j = e / chunks;
    const int cc = (e - j * chunks) * 8;
    const int key = k0 + j;
    const bool ok = key < N && c0 + cc < C;
    cp_async16(dst + j * ld + cc, ok ? base + (long long)key * stride_n + c0 + cc : base, ok);
  }
}

// Zeros in channels [from, width) of ``rows`` rows of a staged tile (row
// stride ld; from and width multiples of 4): a NARROW kernel's K and V
// buffers past C once, before its first copies, which never write there.
__device__ __forceinline__ void zero_tail(bf16* tile, int rows, int from, int width, int ld) {
  const int pieces = (width - from) / 4;
  for (int e = threadIdx.x; e < rows * pieces; e += blockDim.x) {
    const int j = e / pieces;
    *reinterpret_cast<uint2*>(tile + j * ld + from + 4 * (e - j * pieces)) = make_uint2(0u, 0u);
  }
}

// S = Q K^T for the warp's 16 query rows (q_w, row stride ld) against the BK
// keys of a staged tile (k_t, row stride ld), over CP channels.
template <int NS>
__device__ __forceinline__ void logits_mma(const bf16* q_w, const bf16* k_t, int ld, int CP,
                                           int lane, float (&s)[NS][4]) {
#pragma unroll
  for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  for (int kc = 0; kc < CP; kc += 16) {
    unsigned a[4];
    load_a_frag(a, q_w, ld, kc, lane);
#pragma unroll
    for (int np = 0; np < NS / 2; ++np) {
      unsigned b[4];
      load_bt_frags(b, k_t, ld, np * 16, kc, lane);
      mma_bf16_16816(s[2 * np], a, b[0], b[1]);
      mma_bf16_16816(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc += P V for the warp's 16 rows: P in the S fragments (already final
// bf16 values or rounded here), V the staged tile's channel slice (row
// stride ld), NT n-tiles of 8 channels.
template <int NS, int NT>
__device__ __forceinline__ void pv_mma(const float (&p)[NS][4], const bf16* v_t, int ld, int lane,
                                       float (&acc)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) {
    const unsigned a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int cp = 0; cp < NT / 2; ++cp) {
      unsigned b[4];
      load_b_frags(b, v_t, ld, kk * 16, cp * 16, lane);
      mma_bf16_16816(acc[2 * cp], a, b[0], b[1]);
      mma_bf16_16816(acc[2 * cp + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// The block's position: grid.x walks (row r, query tile) with the tiles of a
// row adjacent (rows bounded by grid.x's 2^31 - 1 blocks), grid.y the head,
// grid.z the output channel slice.
struct Block {
  int r, q0, h, cs0;
};

template <int TQ = kTQ>
__device__ __forceinline__ Block block_of(int N, int CS) {
  const int tiles = (N + TQ - 1) / TQ;
  Block b;
  b.r = blockIdx.x / tiles;
  b.q0 = (blockIdx.x - b.r * tiles) * TQ;
  b.h = blockIdx.y;
  b.cs0 = blockIdx.z * CS;
  return b;
}

// The warp's output rows (g and g + 8 of its 16) of a contiguous [R, N, H, C]
// bf16 tensor from the accumulators, each divided by its row's divisor.
template <int NT>
__device__ __forceinline__ void store_tile(bf16* out, int N, int H, int C, const Block& b,
                                           int row_a, const float (&acc)[NT][4], float div_a,
                                           float div_b, int lane) {
  const int tig = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = b.cs0 + n * 8 + tig * 2;
    if (c >= C) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + 8 * half;
      if (row >= N) continue;
      const float d = half ? div_b : div_a;
      bf16* dst = out + (((long long)b.r * N + row) * H + b.h) * C + c;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(acc[n][2 * half] / d, acc[n][2 * half + 1] / d);
    }
  }
}

// The same into a.out (1 as the divisor for K1 fast).
template <int NT>
__device__ __forceinline__ void store_out(const Args& a, const Block& b, int row_a,
                                          const float (&acc)[NT][4], float div_a, float div_b,
                                          int lane) {
  store_tile<NT>(a.out, a.N, a.H, a.C, b, row_a, acc, div_a, div_b, lane);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU in one instruction (-inf gives 0, denormals flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The passes of K1 and K3 over every key tile (rows_pass): ONLINE is K3's
// one pass (running max, rescaled sum and P.V); STATS K1's first (the row
// max and sum, no V); NORMALIZED K1's second (p = exp(l - m) / s and P.V).
enum RowsMode { kOnline = 0, kStats = 1, kNormalized = 2 };

// A thread's two rows (g and g + 8 of its warp's 16: _a and _b): running
// max, its partial sum over the thread's key columns, the P.V accumulator.
template <int NT>
struct RowsState {
  float m_a, m_b, s_a, s_b;
  float acc[NT][4];
};

template <int NT>
__device__ __forceinline__ void init_rows(RowsState<NT>& st) {
  st.m_a = st.m_b = neg_inf();
  st.s_a = st.s_b = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) st.acc[n][0] = st.acc[n][1] = st.acc[n][2] = st.acc[n][3] = 0.f;
}

// The mask bits of the key tile [k0, k0 + BK) for this thread's key columns:
// one ballot per 32 keys and warp (bit j: key k0 + j is kept; live: k0 + j <
// N), shifted so that bit (n % 4) * 8 + e is the thread's column e of n-tile
// n; dense: every key of the tile is kept.
template <int BK>
struct TileMask {
  static constexpr int W = (BK + 31) / 32;
  unsigned keep[W], live[W];
  bool dense;

  __device__ __forceinline__ bool kept(int n, int e) const {
    return (keep[n >> 2] >> ((n & 3) * 8 + (e & 1))) & 1u;
  }
  __device__ __forceinline__ bool in_range(int n, int e) const {
    return (live[n >> 2] >> ((n & 3) * 8 + (e & 1))) & 1u;
  }
};

template <int BK>
__device__ __forceinline__ TileMask<BK> tile_mask(const float* mask_row, int k0, int N, int lane) {
  TileMask<BK> tm;
  tm.dense = true;
  const int shift = 2 * (lane & 3);  // this thread's first key column in each 8-key n-tile
#pragma unroll
  for (int w = 0; w < TileMask<BK>::W; ++w) {
    const int j = 32 * w + lane;
    const bool in = j < BK && k0 + j < N;
    tm.keep[w] = __ballot_sync(kFull, in && mask_row[k0 + j] >= 0.5f);
    tm.live[w] = __ballot_sync(kFull, in);
    const unsigned full = BK - 32 * w >= 32 ? kFull : (1u << (BK - 32 * w)) - 1u;
    tm.dense = tm.dense && tm.keep[w] == full;
    tm.keep[w] >>= shift;
    tm.live[w] >>= shift;
  }
  return tm;
}

// The logits of a tile after the fill: -2^15 at masked keys, -inf past N
// (weight 0). A tile whose keys are all kept skips it.
template <int NS, int BK>
__device__ __forceinline__ void apply_fill(float (&s)[NS][4], const TileMask<BK>& tm) {
  if (tm.dense) return;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (!tm.kept(n, e)) s[n][e] = tm.in_range(n, e) ? kMaskFill : neg_inf();
  }
}

// One step of online softmax over a tile's logits: the new running max, the
// sum (and with RESCALE the P.V accumulator) rescaled by exp(m - m'), and
// nm = -m' log2 e for the exponentials. The tile holds a key below N, so the
// new max is finite and the first step's rescale is exp(-inf) = 0.
template <bool RESCALE, int NS, int NT>
__device__ __forceinline__ void online_step(const float (&s)[NS][4], RowsState<NT>& st,
                                            float& nm_a, float& nm_b) {
  float mx_a = st.m_a, mx_b = st.m_b;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
    mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
  }
  mx_a = quad_max(mx_a);
  mx_b = quad_max(mx_b);
  const float alpha_a = exp2_approx((st.m_a - mx_a) * kLog2e);
  const float alpha_b = exp2_approx((st.m_b - mx_b) * kLog2e);
  st.m_a = mx_a;
  st.m_b = mx_b;
  nm_a = -mx_a * kLog2e;
  nm_b = -mx_b * kLog2e;
  st.s_a *= alpha_a;
  st.s_b *= alpha_b;
  if (RESCALE) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      st.acc[n][0] *= alpha_a;
      st.acc[n][1] *= alpha_a;
      st.acc[n][2] *= alpha_b;
      st.acc[n][3] *= alpha_b;
    }
  }
}

// p = exp(l - m) in place, as exp2 of l log2(e) - m log2(e): one FFMA and
// one SFU op per logit (FlashAttention-2's form). SUM adds p into the
// thread's partial row sums.
template <bool SUM, int NS, int NT>
__device__ __forceinline__ void exp_rows(float (&s)[NS][4], RowsState<NT>& st, float nm_a,
                                         float nm_b) {
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    s[n][0] = exp2_approx(fmaf(s[n][0], kLog2e, nm_a));
    s[n][1] = exp2_approx(fmaf(s[n][1], kLog2e, nm_a));
    s[n][2] = exp2_approx(fmaf(s[n][2], kLog2e, nm_b));
    s[n][3] = exp2_approx(fmaf(s[n][3], kLog2e, nm_b));
    if (SUM) {
      st.s_a += s[n][0] + s[n][1];
      st.s_b += s[n][2] + s[n][3];
    }
  }
}

// One pass of triangle attention (no bias) over the key tiles of the
// block's (row, head), K and V tiles double-buffered by cp.async; the tile's
// mask bits are read while the copies land. NARROW: C = 4 mod 8 (stage_keys).
template <int MODE, int BK, int NT, bool NARROW = false>
__device__ __forceinline__ void rows_pass(const Args& a, const Block& b, const bf16* q_w,
                                          bf16* k_s, bf16* v_s, int CP, RowsState<NT>& st,
                                          int lane) {
  constexpr int NS = BK / 8, CS = 8 * NT, VS = CS + 8;
  constexpr bool PV = MODE != kStats;
  const int N = a.N, C = a.C, QS = CP + 8;
  const bf16* k_base = a.k + b.r * a.ks.r + b.h * a.ks.h;
  const bf16* v_base = a.v + b.r * a.vs.r + b.h * a.vs.h;
  const float* mask_row = a.mask + (long long)b.r * N;
  const int tiles = (N + BK - 1) / BK;
  // NORMALIZED: the final max (scaled by log2 e, negated) and 1 / sum
  float nm_a = -st.m_a * kLog2e, nm_b = -st.m_b * kLog2e;
  const float inv_a = MODE == kNormalized ? 1.f / st.s_a : 1.f;
  const float inv_b = MODE == kNormalized ? 1.f / st.s_b : 1.f;
  stage_keys<NARROW>(k_base, a.ks.n, 0, BK, N, C, 0, CP, QS, k_s);
  if (PV) stage_keys<NARROW>(v_base, a.vs.n, 0, BK, N, C, b.cs0, CS, VS, v_s);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      stage_keys<NARROW>(k_base, a.ks.n, (t + 1) * BK, BK, N, C, 0, CP, QS,
                         k_s + (buf ^ 1) * BK * QS);
      if (PV)
        stage_keys<NARROW>(v_base, a.vs.n, (t + 1) * BK, BK, N, C, b.cs0, CS, VS,
                           v_s + (buf ^ 1) * BK * VS);
    }
    cp_async_commit();
    const TileMask<BK> tm = tile_mask<BK>(mask_row, t * BK, N, lane);
    cp_async_wait<1>();
    __syncthreads();

    float s[NS][4];
    logits_mma<NS>(q_w, k_s + buf * BK * QS, QS, CP, lane, s);
    apply_fill<NS, BK>(s, tm);
    if (MODE != kNormalized) online_step<MODE == kOnline, NS, NT>(s, st, nm_a, nm_b);
    exp_rows<MODE != kNormalized, NS, NT>(s, st, nm_a, nm_b);
    if (MODE == kNormalized) {  // the normalised probabilities, rounded to bf16 by pv_mma
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][0] *= inv_a;
        s[n][1] *= inv_a;
        s[n][2] *= inv_b;
        s[n][3] *= inv_b;
      }
    }
    if (PV) pv_mma<NS, NT>(s, v_s + buf * BK * VS, VS, lane, st.acc);
    __syncthreads();  // the next tile's loads overwrite this buffer
  }
}

// Whether an operand starts on 16 bytes (cp.async, 16-byte loads), or on
// ``bytes``.
bool aligned_to(const void* p, unsigned bytes) {
  return (reinterpret_cast<unsigned long long>(p) & (bytes - 1)) == 0;
}
bool aligned16(const void* p) { return aligned_to(p, 16); }

// The softmax stats of one query as the backward kernels stage them: nm =
// -m log2 e and the normaliser inv, so that p = exp2(l log2 e + nm) inv in
// one FFMA, one SFU op and one multiply; delta. K7's dq kernel computes m
// and s (inv = 1 / s). K6 takes K5's m and log s kept split (inv = exp(-log
// s)): a fully masked row has m = -2^15 and log s = log N, and the folded m +
// log s would round to f32's spacing of 2^-9 near -2^15 (P off by up to
// 0.1%), while l log2 e + nm is exactly 0 at l = m = -2^15 (a power of two
// times log2 e is exact). Past N: -inf, 0 and 0, so that p is exactly 0.
struct RowStats {
  float nm, inv, delta;
};

template <bool LOG_S>
__device__ __forceinline__ RowStats load_stats(const float* m, const float* s, const float* delta,
                                               long long i, bool live) {
  if (!live) return {neg_inf(), 0.f, 0.f};
  return {-m[i] * kLog2e, LOG_S ? expf(-s[i]) : 1.f / s[i], delta[i]};
}

}  // namespace
