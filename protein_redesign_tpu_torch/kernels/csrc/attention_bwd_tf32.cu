// Hand-written Hopper (sm_90a) tensor-core body of the rows attention flash
// backward in float32, for head widths that are a multiple of 8 up to 128:
//
//   rows_attention_bwd_dq_tf32x3_kernel,    <- _rows_attention_bwd_impl /
//   rows_attention_bwd_dkdv_tf32x3_kernel      _make_rowhead_bwd_kernel (K7)
//   rows_attention_kchunk_bwd_dq_tf32x3_kernel,    <- _kchunk_grid_cn_grads_call /
//   rows_attention_kchunk_bwd_dkdv_tf32x3_kernel      _make_rowhead_kchunk_grid_cn_
//                                                     bwd_kernel (K6)
//
// of protein_redesign_tpu/ops/pallas_attention.py. It replaces, for those
// widths, the CUDA-core bodies of attention_bwd.cu (K7) and
// attention_kchunk_bwd.cu (K6), kept for C = 4 mod 8 and callable
// (ops.attention.attention_body) to time them beside this one.
//
// The functions are the f32 plain versions' (rows_attention_bwd_reference,
// rows_attention_kchunk_bwd_reference), where nothing is rounded: per (row,
// head), qt = q * scale in f32, logits l = qt k^T with -2^15 at masked keys,
//   K7: P = softmax(l), delta = rowsum(dP o P), both computed here;
//   K6: P = exp((l - m) - log s) from K5's split stats m and log s, delta =
//       rowsum(dO o O) given by the caller (attention_kchunk_bwd.cu's header);
// dv = P^T dO, dP = dO v^T, dS = P o (dP - delta) set to 0 at masked keys,
// dqt = dS k and dk = dS^T qt, outputs in f32. The two deltas are equal in
// exact arithmetic only; each kernel reads the one its plain version takes
// (STATS_IN selects K6's). The wrapper scales dqt by the scale.
//
// What bounds it on the card. K6 takes seven products per logit (S and dP
// in each kernel, dqt, dv and dk) and two exponentials (one in each
// kernel); K7's stats and delta passes add three products and two
// exponentials. One TF32 product keeps three decimal digits, which breaks
// the 1e-5 parity, and f32 FMAs on the CUDA cores give 67 TFLOP/s. So every
// product runs on the tensor cores in 3xTF32 (mma_3xtf32, mma.cuh; the
// fragments, the staging and P X from the accumulators as they lie are
// attention_tf32.cuh's, shared with K3's and K5's f32 body): at most 495 / 3
// = 165 TFLOP/s. By count the products set the pace: seven 3xTF32 products,
// 21 mma.sync m16n8k8 and the operand splits, against two exponentials a
// logit.
//
// The layout is the bf16 body's (attention_bwd_mma.cu), in f32:
//   dq kernel: a block of 64 queries (4 warps of 16 rows), qt and dO staged
//     once; passes over key tiles of K and V, cp.async double-buffered, with
//     the tile's mask by ballot. K7: (1) m and s online, (2) S and dP, P
//     normalised, delta summed per row, (3) S, P and dP again, dS straight
//     from the accumulators into dqt += dS K; it writes m, s and delta to a
//     [3, R, H, N] f32 scratch. K6: pass (3) only, with -m log2 e and exp(-log
//     s) staged apart (load_stats, attention_mma.cuh: a fully masked row's
//     logit l = m = -2^15 then gives an exponent of exactly 0, where the
//     folded m + log s would round by up to 2^-10).
//   dk/dv kernel: a block of 64 keys, K and V staged once; one pass over
//     query tiles of qt, dO and the queries' stats, transposed (the warp's
//     rows are keys): S^T = K qt^T, dP^T = V dO^T, P^T with the stats read
//     per column, dS^T zero on the rows of masked keys, dv += P^T dO and dk
//     += dS^T qt. No fragment needs a transpose. Queries past N are staged
//     with -m log2 e = -inf and a normaliser of 0: their P^T is exactly 0.
// A fully masked row has P uniform over its keys below N: it reaches dv,
// while its dS, and with it its dqt and its keys' dk, is exactly 0.
//
// Layout: q, k, v and dO are [R, N, H, C] f32 with the head dimension
// contiguous, the other strides given in elements, every row 16-byte aligned
// (C and the strides multiples of 4, checked by the entry points); mask is
// contiguous f32 [R, N]; m, log s and delta contiguous f32 [R, H, N]; dq, dk,
// dv contiguous [R, N, H, C]. Heads are padded in shared memory to CP = 8 NT
// channels (8, 16, 32, 64 or 128), rows CP + 4 floats long. Shared memory: 4
// (128 + 4 B) (CP + 4) bytes with B = 64 up to CP = 16 and 32 above, plus 24
// B for the dk/dv kernel's stats: 31 KB at C = 16, 133 KB at C = 128. Offsets
// are 64-bit. The entry points return cudaGetLastError() after their
// launches.

#include "attention_tf32.cuh"

namespace {

struct BwdF32Args {
  const float* q;
  const float* k;
  const float* v;
  const float* mask;
  const float* g;  // dO
  float* dq;
  float* dk;
  float* dv;
  // read by the dk/dv kernel (and K6's dq kernel), [R, H, N] each: K7's m,
  // s and delta, the rows of its scratch that its dq kernel writes, or K6's
  // m, log s and delta, read only
  float* m;
  float* s;
  float* delta;
  int R, N, H, C;
  float scale;
  Strides qs, ks, vs, gs;
};

// Keys (dq kernel) or queries (dk/dv kernel) per streamed tile: 64 up to CP
// = 16, 32 above, where the accumulators and the split operands take more
// registers.
template <int NT>
constexpr int kBwdF32Tile = NT <= 2 ? 64 : 32;

// Blocks of 4 warps that must fit on an SM at once, which caps registers:
// 128 up to CP = 16 (16 warps a SM), 168 at CP = 32, 255 above.
template <int NT>
constexpr int kBwdF32MinBlocks = NT <= 2 ? 4 : (NT <= 4 ? 3 : 2);

enum DqPass { kPassStats = 0, kPassDelta = 1, kPassGrad = 2 };

// One pass of the dq kernel over every key tile of the block's (row, head),
// K and V tiles double-buffered by cp.async: kPassStats the row max and sum
// online (into st; no V), kPassDelta delta += P o dP (the thread's partial
// sums), kPassGrad dS and dqt += dS K with the rows' final delta. nm and inv
// are this thread's two rows' -m log2 e and normaliser (_a, _b).
template <int PASS, int BK, int NT>
__device__ __forceinline__ void dq_pass(const BwdF32Args& a, const Block& b, const float* q_w,
                                        const float* g_w, float* k_s, float* v_s,
                                        RowsState<1>& st, float nm_a, float nm_b, float inv_a,
                                        float inv_b, float& delta_a, float& delta_b,
                                        float (&acc)[NT][4], int lane) {
  constexpr int NS = BK / 8, CP = 8 * NT, LD = CP + 4;
  constexpr bool PV = PASS != kPassStats;
  const int N = a.N, C = a.C;
  const float* k_base = a.k + b.r * a.ks.r + b.h * a.ks.h;
  const float* v_base = a.v + b.r * a.vs.r + b.h * a.vs.h;
  const float* mask_row = a.mask + (long long)b.r * N;
  const int tiles = (N + BK - 1) / BK;
  float snm_a = 0.f, snm_b = 0.f;  // kPassStats: the running max's -m log2 e
  stage_f32(k_base, a.ks.n, 0, BK, N, C, CP, LD, k_s);
  if (PV) stage_f32(v_base, a.vs.n, 0, BK, N, C, CP, LD, v_s);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      stage_f32(k_base, a.ks.n, (t + 1) * BK, BK, N, C, CP, LD, k_s + (buf ^ 1) * BK * LD);
      if (PV)
        stage_f32(v_base, a.vs.n, (t + 1) * BK, BK, N, C, CP, LD, v_s + (buf ^ 1) * BK * LD);
    }
    cp_async_commit();
    const TileMask<BK> tm = tile_mask<BK>(mask_row, t * BK, N, lane);
    cp_async_wait<1>();
    __syncthreads();

    const float* k_t = k_s + buf * BK * LD;
    float s[NS][4];
    logits_tf32<NS, CP>(q_w, k_t, LD, lane, s);  // S = qt K^T
    apply_fill<NS, BK>(s, tm);
    if (PASS == kPassStats) {
      online_step<false, NS, 1>(s, st, snm_a, snm_b);
      exp_rows<true, NS, 1>(s, st, snm_a, snm_b);
    } else {
      float dp[NS][4];
      logits_tf32<NS, CP>(g_w, v_s + buf * BK * LD, LD, lane, dp);  // dP = dO V^T
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2_approx(fmaf(s[n][e], kLog2e, e < 2 ? nm_a : nm_b)) *
                          (e < 2 ? inv_a : inv_b);
          if (PASS == kPassDelta) {
            if (e < 2)
              delta_a = fmaf(p, dp[n][e], delta_a);
            else
              delta_b = fmaf(p, dp[n][e], delta_b);
          } else {  // dS, zero at masked keys (and past N, where p is 0)
            s[n][e] = (tm.dense || tm.kept(n, e))
                          ? p * (dp[n][e] - (e < 2 ? delta_a : delta_b))
                          : 0.f;
          }
        }
      }
      if (PASS == kPassGrad) pv_tf32<NS, NT>(s, k_t, LD, lane, acc);  // dqt += dS K
    }
    __syncthreads();  // the next tile's loads overwrite this buffer
  }
}

// The dq kernel: a block of 64 queries of one (row, head). STATS_IN (K6):
// the rows' stats from a.m, a.s (log s) and a.delta, pass 3 only.
template <int NT, bool STATS_IN>
__device__ __forceinline__ void dq_kernel(const BwdF32Args& a) {
  constexpr int BK = kBwdF32Tile<NT>, CP = 8 * NT, LD = CP + 4;
  extern __shared__ __align__(16) float smem_f[];
  float* q_s = smem_f;             // [kTQ][LD] qt
  float* g_s = q_s + kTQ * LD;     // [kTQ][LD] dO
  float* k_s = g_s + kTQ * LD;     // [2][BK][LD]
  float* v_s = k_s + 2 * BK * LD;  // [2][BK][LD]
  const int N = a.N, C = a.C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Block b = block_of(N, CP);
  stage_q_f32(a.q + b.r * a.qs.r + b.h * a.qs.h, a.qs.n, b.q0, kTQ, N, C, CP, LD, a.scale, q_s);
  // dO joins the first pass's first copy group
  stage_f32(a.g + b.r * a.gs.r + b.h * a.gs.h, a.gs.n, b.q0, kTQ, N, C, CP, LD, g_s);
  const float* q_w = q_s + warp * 16 * LD;
  const float* g_w = g_s + warp * 16 * LD;
  const int row_a = b.q0 + warp * 16 + (lane >> 2);
  const long long base = ((long long)b.r * a.H + b.h) * N;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  RowsState<1> st;
  init_rows(st);
  if (STATS_IN) {
    const RowStats ra = load_stats<true>(a.m, a.s, a.delta, base + row_a, row_a < N);
    const RowStats rb = load_stats<true>(a.m, a.s, a.delta, base + row_a + 8, row_a + 8 < N);
    float d_a = ra.delta, d_b = rb.delta;
    dq_pass<kPassGrad, BK, NT>(a, b, q_w, g_w, k_s, v_s, st, ra.nm, rb.nm, ra.inv, rb.inv, d_a,
                               d_b, acc, lane);
    store_tile_f32<NT>(a.dq, N, a.H, C, b, row_a, acc, 1.f, 1.f, lane);
    return;
  }

  float d_a = 0.f, d_b = 0.f;
  dq_pass<kPassStats, BK, NT>(a, b, q_w, g_w, k_s, v_s, st, 0.f, 0.f, 1.f, 1.f, d_a, d_b, acc,
                              lane);
  const float s_a = quad_sum(st.s_a), s_b = quad_sum(st.s_b);
  const float inv_a = 1.f / s_a, inv_b = 1.f / s_b;
  const float nm_a = -st.m_a * kLog2e, nm_b = -st.m_b * kLog2e;
  dq_pass<kPassDelta, BK, NT>(a, b, q_w, g_w, k_s, v_s, st, nm_a, nm_b, inv_a, inv_b, d_a, d_b,
                              acc, lane);
  d_a = quad_sum(d_a);
  d_b = quad_sum(d_b);
  dq_pass<kPassGrad, BK, NT>(a, b, q_w, g_w, k_s, v_s, st, nm_a, nm_b, inv_a, inv_b, d_a, d_b,
                             acc, lane);

  store_tile_f32<NT>(a.dq, N, a.H, C, b, row_a, acc, 1.f, 1.f, lane);
  if ((lane & 3) == 0) {  // one lane per row
    const float m[2] = {st.m_a, st.m_b}, s[2] = {s_a, s_b}, d[2] = {d_a, d_b};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + 8 * half;
      if (row >= N) continue;
      a.m[base + row] = m[half];
      a.s[base + row] = s[half];
      a.delta[base + row] = d[half];
    }
  }
}

// The dk/dv kernel: a block of 64 keys of one (row, head); each query's
// stats from a.m, a.s (STATS_IN: log s) and a.delta.
template <int NT, bool STATS_IN>
__device__ __forceinline__ void dkdv_kernel(const BwdF32Args& a) {
  constexpr int BQ = kBwdF32Tile<NT>, NS = BQ / 8, CP = 8 * NT, LD = CP + 4;
  extern __shared__ __align__(16) float smem_f[];
  float* k_s = smem_f;              // [kTQ][LD] the block's keys
  float* v_s = k_s + kTQ * LD;      // [kTQ][LD]
  float* q_s = v_s + kTQ * LD;      // [2][BQ][LD] qt
  float* g_s = q_s + 2 * BQ * LD;   // [2][BQ][LD] dO
  float* st_s = g_s + 2 * BQ * LD;  // [2][3][BQ]: nm, inv, delta
  const int N = a.N, C = a.C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Block b = block_of(N, CP);  // b.q0: the block's first key
  const float* q_base = a.q + b.r * a.qs.r + b.h * a.qs.h;
  const float* g_base = a.g + b.r * a.gs.r + b.h * a.gs.h;
  const long long base = ((long long)b.r * a.H + b.h) * N;
  stage_f32(a.k + b.r * a.ks.r + b.h * a.ks.h, a.ks.n, b.q0, kTQ, N, C, CP, LD, k_s);
  stage_f32(a.v + b.r * a.vs.r + b.h * a.vs.h, a.vs.n, b.q0, kTQ, N, C, CP, LD, v_s);
  stage_f32(q_base, a.qs.n, 0, BQ, N, C, CP, LD, q_s);
  stage_f32(g_base, a.gs.n, 0, BQ, N, C, CP, LD, g_s);
  cp_async_commit();
  // this thread's keys (rows g and g + 8 of its warp's 16); past N as masked
  const int row_a = b.q0 + warp * 16 + (lane >> 2);
  const float* mask_row = a.mask + (long long)b.r * N;
  const bool masked_a = row_a >= N || mask_row[row_a] < 0.5f;
  const bool masked_b = row_a + 8 >= N || mask_row[row_a + 8] < 0.5f;
  const bool stager = threadIdx.x < BQ;  // thread i stages the stats of query i of each tile
  RowStats cur{};
  if (stager) cur = load_stats<STATS_IN>(a.m, a.s, a.delta, base + threadIdx.x, threadIdx.x < N);

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  }
  const int tiles = (N + BQ - 1) / BQ;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1, i0 = t * BQ;
    RowStats next = cur;
    if (t + 1 < tiles) {
      stage_f32(q_base, a.qs.n, i0 + BQ, BQ, N, C, CP, LD, q_s + (buf ^ 1) * BQ * LD);
      stage_f32(g_base, a.gs.n, i0 + BQ, BQ, N, C, CP, LD, g_s + (buf ^ 1) * BQ * LD);
      if (stager) {
        const int i = i0 + BQ + threadIdx.x;
        next = load_stats<STATS_IN>(a.m, a.s, a.delta, base + i, i < N);
      }
    }
    cp_async_commit();
    float* st = st_s + buf * 3 * BQ;
    if (stager) {
      st[threadIdx.x] = cur.nm;
      st[BQ + threadIdx.x] = cur.inv;
      st[2 * BQ + threadIdx.x] = cur.delta;
    }
    cp_async_wait<1>();
    float* q_t = q_s + buf * BQ * LD;
    scale_staged_f32(q_t, i0, BQ, N, C, CP, LD, a.scale);  // qt, this thread's own copies
    __syncthreads();

    const float* g_t = g_s + buf * BQ * LD;
    float s[NS][4], dp[NS][4];
    logits_tf32<NS, CP>(k_s + warp * 16 * LD, q_t, LD, lane, s);   // S^T: rows keys
    logits_tf32<NS, CP>(v_s + warp * 16 * LD, g_t, LD, lane, dp);  // dP^T
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int i = n * 8 + 2 * (lane & 3);  // this thread's two query columns
      const float2 nm = *reinterpret_cast<const float2*>(st + i);
      const float2 inv = *reinterpret_cast<const float2*>(st + BQ + i);
      const float2 dl = *reinterpret_cast<const float2*>(st + 2 * BQ + i);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool masked = e < 2 ? masked_a : masked_b;
        const float l = masked ? kMaskFill : s[n][e];
        const float p = exp2_approx(fmaf(l, kLog2e, (e & 1) ? nm.y : nm.x)) *
                        ((e & 1) ? inv.y : inv.x);
        dp[n][e] = masked ? 0.f : p * (dp[n][e] - ((e & 1) ? dl.y : dl.x));
        s[n][e] = p;
      }
    }
    pv_tf32<NS, NT>(s, g_t, LD, lane, dv);   // dv += P^T dO
    pv_tf32<NS, NT>(dp, q_t, LD, lane, dk);  // dk += dS^T qt
    __syncthreads();  // the next tile's loads overwrite this buffer
    cur = next;
  }
  store_tile_f32<NT>(a.dk, N, a.H, C, b, row_a, dk, 1.f, 1.f, lane);
  store_tile_f32<NT>(a.dv, N, a.H, C, b, row_a, dv, 1.f, 1.f, lane);
}

template <int NT>
__global__ void __launch_bounds__(kWarps * 32, kBwdF32MinBlocks<NT>)
    rows_attention_bwd_dq_tf32x3_kernel(const BwdF32Args a) {
  dq_kernel<NT, false>(a);
}

template <int NT>
__global__ void __launch_bounds__(kWarps * 32, kBwdF32MinBlocks<NT>)
    rows_attention_bwd_dkdv_tf32x3_kernel(const BwdF32Args a) {
  dkdv_kernel<NT, false>(a);
}

template <int NT>
__global__ void __launch_bounds__(kWarps * 32, kBwdF32MinBlocks<NT>)
    rows_attention_kchunk_bwd_dq_tf32x3_kernel(const BwdF32Args a) {
  dq_kernel<NT, true>(a);
}

template <int NT>
__global__ void __launch_bounds__(kWarps * 32, kBwdF32MinBlocks<NT>)
    rows_attention_kchunk_bwd_dkdv_tf32x3_kernel(const BwdF32Args a) {
  dkdv_kernel<NT, true>(a);
}

// Shared memory of the two kernels: 2 x 64 rows staged once and two
// buffers of two streamed tiles, plus the dk/dv kernel's column stats.
template <int NT>
constexpr size_t dq_smem() {
  return sizeof(float) * (size_t)(2 * kTQ + 4 * kBwdF32Tile<NT>) * (8 * NT + 4);
}

template <int NT>
constexpr size_t dkdv_smem() {
  return dq_smem<NT>() + sizeof(float) * 6 * kBwdF32Tile<NT>;
}

template <typename Kernel>
cudaError_t launch_one(Kernel kern, size_t smem, const BwdF32Args& a, unsigned blocks,
                       cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(blocks, a.H), kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NT, bool STATS_IN>
cudaError_t launch(const BwdF32Args& a, cudaStream_t stream) {
  const long long blocks = (long long)((a.N + kTQ - 1) / kTQ) * a.R;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t e =
      launch_one(STATS_IN ? rows_attention_kchunk_bwd_dq_tf32x3_kernel<NT>
                          : rows_attention_bwd_dq_tf32x3_kernel<NT>,
                 dq_smem<NT>(), a, (unsigned)blocks, stream);
  if (e != cudaSuccess) return e;
  return launch_one(STATS_IN ? rows_attention_kchunk_bwd_dkdv_tf32x3_kernel<NT>
                             : rows_attention_bwd_dkdv_tf32x3_kernel<NT>,
                    dkdv_smem<NT>(), a, (unsigned)blocks, stream);
}

template <bool STATS_IN>
cudaError_t dispatch_width(const BwdF32Args& a, cudaStream_t stream) {
  const bool ok = a.R > 0 && a.N > 0 && a.H > 0 && a.H <= 65535 && a.C > 0 && a.C <= 128 &&
                  a.C % 8 == 0 && strides4(a.qs) && strides4(a.ks) && strides4(a.vs) &&
                  strides4(a.gs) && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
                  aligned16(a.g) && a.mask != nullptr && a.m != nullptr && a.s != nullptr &&
                  a.delta != nullptr;
  if (!ok) return cudaErrorInvalidValue;
  if (a.C <= 8) return launch<1, STATS_IN>(a, stream);
  if (a.C <= 16) return launch<2, STATS_IN>(a, stream);
  if (a.C <= 32) return launch<4, STATS_IN>(a, stream);
  if (a.C <= 64) return launch<8, STATS_IN>(a, stream);
  return launch<16, STATS_IN>(a, stream);
}

}  // namespace

extern "C" {

// K7 in f32 on the tensor cores (3xTF32): dqt (w.r.t. the pre-scaled q), dk
// and dv of rows attention, C a multiple of 8 up to 128. stats is
// caller-allocated f32 scratch of 3 * R * H * N values.
int prd_rows_attention_bwd_tf32x3(const void* q, const void* k, const void* v, const void* mask,
                                  const void* dout, void* dq, void* dk, void* dv, void* stats,
                                  int R, int N, int H, int C, float scale, long long q_sr,
                                  long long q_sn, long long q_sh, long long k_sr, long long k_sn,
                                  long long k_sh, long long v_sr, long long v_sn, long long v_sh,
                                  long long g_sr, long long g_sn, long long g_sh, void* stream) {
  float* st = static_cast<float*>(stats);
  const long long rhn = (long long)R * H * N;
  const BwdF32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<const float*>(mask),
                     static_cast<const float*>(dout), static_cast<float*>(dq),
                     static_cast<float*>(dk), static_cast<float*>(dv), st,
                     st == nullptr ? nullptr : st + rhn, st == nullptr ? nullptr : st + 2 * rhn,
                     R, N, H, C, scale, {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh},
                     {v_sr, v_sn, v_sh}, {g_sr, g_sn, g_sh}};
  return (int)dispatch_width<false>(a, static_cast<cudaStream_t>(stream));
}

// K6 in f32 on the tensor cores (3xTF32): dqt (w.r.t. the pre-scaled q), dk
// and dv of the K-chunked rows attention from K5's m and log s and the
// caller's delta = rowsum(dO o O), all f32 [R, H, N]; C a multiple of 8 up
// to 128.
int prd_rows_attention_kchunk_bwd_tf32x3(const void* q, const void* k, const void* v,
                                         const void* mask, const void* dout, const void* m,
                                         const void* logs, const void* delta, void* dq, void* dk,
                                         void* dv, int R, int N, int H, int C, float scale,
                                         long long q_sr, long long q_sn, long long q_sh,
                                         long long k_sr, long long k_sn, long long k_sh,
                                         long long v_sr, long long v_sn, long long v_sh,
                                         long long g_sr, long long g_sn, long long g_sh,
                                         void* stream) {
  const BwdF32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<const float*>(mask),
                     static_cast<const float*>(dout), static_cast<float*>(dq),
                     static_cast<float*>(dk), static_cast<float*>(dv),
                     static_cast<float*>(const_cast<void*>(m)),
                     static_cast<float*>(const_cast<void*>(logs)),
                     static_cast<float*>(const_cast<void*>(delta)), R, N, H, C, scale,
                     {q_sr, q_sn, q_sh},
                     {k_sr, k_sn, k_sh}, {v_sr, v_sn, v_sh}, {g_sr, g_sn, g_sh}};
  return (int)dispatch_width<true>(a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
