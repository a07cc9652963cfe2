// Hand-written Hopper (sm_90a) tensor-core body of the rows attention flash
// backward, for bf16 inputs with a head width that is a multiple of 8 up to
// 128. It replaces, for those inputs, the CUDA-core kernels of
// attention_bwd.cu and attention_kchunk_bwd.cu (kept there for other head
// widths; f32 takes attention_bwd_tf32.cu):
//
//   rows_attention_bwd_dq_mma_kernel,   <- _rows_attention_bwd_impl /
//   rows_attention_bwd_dkdv_mma_kernel     _make_rowhead_bwd_kernel (K7)
//   rows_attention_kchunk_bwd_dq_mma_kernel,   <- _kchunk_grid_cn_grads_call /
//   rows_attention_kchunk_bwd_dkdv_mma_kernel     _make_rowhead_kchunk_grid_cn_
//                                                 bwd_kernel (K6)
//
// of protein_redesign_tpu/ops/pallas_attention.py. K6 computes K7's third
// dq pass and its dk/dv pass with the stats given (STATS_IN, below). The
// function is K7's
// (attention_bwd.cu's header, rows_attention_bwd_reference): per (row, head),
// qt = q * scale rounded to bf16, logits with -2^15 at masked keys, P =
// softmax in f32, dv = bf16(P)^T dO, dP = dO V^T, delta = rowsum(dP o P),
// dS = P o (dP - delta) set to 0 at masked keys and rounded to bf16 once,
// dqt = dS K and dk = dS^T qt, f32 sums, outputs in bf16. The wrapper scales
// dqt by the rounded scale.
//
// What bounds it on the card. At the training path's shapes (head width 16,
// N = 192 or 384) every product is one or two mma depth steps, so the
// per-logit elementwise work and the latency of each tile set the pace, as
// for K1's forward (attention_mma.cu). Every product runs on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 sums) from tiles in shared memory:
//
//   rows_attention_bwd_dq_mma_kernel: a block of 64 queries (4 warps of 16
//     rows), qt and dO staged once; three passes over 64-key tiles of K and V
//     (32 for C > 64), cp.async double-buffered: (1) the row max m and sum s
//     online (rows_pass<kStats>, K1's first pass); (2) S = qt K^T and dP = dO
//     V^T, both by logits_mma (dO in q's place, V in K's), P normalised,
//     delta summed per row; (3) S, P and dP again, dS packed to bf16 straight
//     into the A fragment of dqt += dS K (pv_mma with K in V's place). Writes
//     m, s and delta to the [3, R, H, N] f32 scratch.
//   rows_attention_bwd_dkdv_mma_kernel: a block of 64 keys (4 warps of 16),
//     K and V staged once; one pass over 64-query tiles (32 for C > 64) of
//     qt and dO with those queries' -m log2 e, 1 / s and delta. It computes
//     transposed, the warp's rows being keys: S^T = K qt^T and dP^T = V dO^T
//     by logits_mma, P^T = exp(S^T - m_col) / s_col with the stats read per
//     column, dS^T = P^T o (dP^T - delta_col), zero on the rows of masked
//     keys; dv += bf16(P^T) dO and dk += bf16(dS^T) qt by pv_mma. So no
//     fragment ever needs a transpose. Queries past N are staged with -m
//     log2 e = -inf and 1 / s = 0, which makes their P^T exactly 0: they add
//     nothing to dk or dv.
//
// K6 (STATS_IN) takes the stats from outside: K5's row max m and log s,
// kept split, and the caller's delta = rowsum(dO o O), f32 [R, H, N] each
// (attention_kchunk_bwd.cu's header). Its dq kernel skips passes 1 and 2
// and runs pass 3 once with -m log2 e and exp(-log s) (load_stats,
// attention_mma.cuh), writing no scratch; its dk/dv kernel reads the same
// three tensors. So K6 takes one exponential per logit in each kernel, two
// in all, where K7 takes four. A fully masked row has m = -2^15 and log s =
// log N: its P is uniform, exactly, as in K7.
//
// The two kernels compute each logit in transposed operand order (q K^T
// against K q^T), so unlike attention_bwd.cu's kernels they need not agree
// bit for bit on P: the dk/dv kernel takes m and s from the scratch, and
// its P^T differs from the dq kernel's P by f32 summation order, far inside
// the bf16 gate (2e-2). A fully masked row has all logits -2^15, so m =
// -2^15 and P uniform over the keys below N: it reaches dv, while its dS
// (and with it its dqt and its keys' dk) is zero.
//
// Layout: q, k, v and dO are [R, N, H, C] bf16 with the head dimension
// contiguous, the other strides given in elements, every row 16-byte
// aligned (C and the strides multiples of 8, checked by the wrapper); mask
// is contiguous f32 [R, N]; dq, dk, dv are contiguous [R, N, H, C]. Heads
// are padded in shared memory to CP = 8 NT channels (16, 32, 64 or 128);
// the rows are CP + 8 bf16 long against bank conflicts. Shared memory: 2
// (128 + 4 BK) (CP + 8) bytes, plus 24 BK for the dk/dv kernel's stats; at C
// = 128 about 70 KB. The entry point returns cudaGetLastError() after its
// launches.

#include "attention_mma.cuh"

namespace {

// The backward's operands: q, k, v, the mask, the shapes, scale and strides
// in a (a.out unused), dO and its strides, the gradients and the stats that
// the dk/dv kernel (and K6's dq kernel) reads, [R, H, N] each: K7's m, s and
// delta, the rows of its scratch that its dq kernel writes, or K6's m, log s
// and delta, read only.
struct BwdArgs {
  Args a;
  const bf16* g;
  Strides gs;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* m;
  float* s;
  float* delta;
};

// Keys (dq kernel) or queries (dk/dv kernel) per streamed tile: 64, or 32
// for the widest heads, whose accumulators take more registers.
template <int NT>
constexpr int kBwdTile = NT <= 8 ? 64 : 32;

// Blocks of 4 warps that must fit on an SM at once, which caps registers:
// S and dP of a 64-wide tile are 64 f32 a thread, plus the accumulators (128
// registers at CP = 16, 168 up to CP = 64; no spills).
template <int NT>
constexpr int kBwdMinBlocks = NT <= 2 ? 4 : (NT <= 8 ? 3 : 2);

// Passes 2 (DQ false: delta) and 3 (DQ true: dqt += dS K) of the dq kernel
// over every key tile, with the row stats -m log2 e and the normaliser of
// this thread's two rows (_a, _b). delta_a, delta_b are the thread's partial
// sums (pass 2) or the rows' final delta (pass 3).
template <bool DQ, int BK, int NT>
__device__ __forceinline__ void dq_pass(const BwdArgs& ba, const Block& b, const bf16* q_w,
                                        const bf16* g_w, bf16* k_s, bf16* v_s, float nm_a,
                                        float nm_b, float inv_a, float inv_b, float& delta_a,
                                        float& delta_b, float (&acc)[NT][4], int lane) {
  constexpr int NS = BK / 8, CP = 8 * NT, QS = CP + 8;
  const Args& a = ba.a;
  const int N = a.N, C = a.C;
  const bf16* k_base = a.k + b.r * a.ks.r + b.h * a.ks.h;
  const bf16* v_base = a.v + b.r * a.vs.r + b.h * a.vs.h;
  const float* mask_row = a.mask + (long long)b.r * N;
  const int tiles = (N + BK - 1) / BK;
  stage_keys(k_base, a.ks.n, 0, BK, N, C, 0, CP, QS, k_s);
  stage_keys(v_base, a.vs.n, 0, BK, N, C, 0, CP, QS, v_s);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      stage_keys(k_base, a.ks.n, (t + 1) * BK, BK, N, C, 0, CP, QS, k_s + (buf ^ 1) * BK * QS);
      stage_keys(v_base, a.vs.n, (t + 1) * BK, BK, N, C, 0, CP, QS, v_s + (buf ^ 1) * BK * QS);
    }
    cp_async_commit();
    const TileMask<BK> tm = tile_mask<BK>(mask_row, t * BK, N, lane);
    cp_async_wait<1>();
    __syncthreads();

    const bf16* k_t = k_s + buf * BK * QS;
    float s[NS][4], dp[NS][4];
    logits_mma<NS>(q_w, k_t, QS, CP, lane, s);
    logits_mma<NS>(g_w, v_s + buf * BK * QS, QS, CP, lane, dp);
    apply_fill<NS, BK>(s, tm);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(fmaf(s[n][e], kLog2e, e < 2 ? nm_a : nm_b)) *
                        (e < 2 ? inv_a : inv_b);
        if (!DQ) {
          if (e < 2)
            delta_a = fmaf(p, dp[n][e], delta_a);
          else
            delta_b = fmaf(p, dp[n][e], delta_b);
        } else {  // dS, zero at masked keys (and past N, where p is 0)
          s[n][e] = (tm.dense || tm.kept(n, e)) ? p * (dp[n][e] - (e < 2 ? delta_a : delta_b))
                                                : 0.f;
        }
      }
    }
    if (DQ) pv_mma<NS, NT>(s, k_t, QS, lane, acc);  // dS rounded to bf16 here
    __syncthreads();  // the next tile's loads overwrite this buffer
  }
}

// The dq kernel: a block of 64 queries of one (row, head). STATS_IN (K6):
// the rows' stats from ba.m, ba.s (log s) and ba.delta, pass 3 only.
template <int NT, bool STATS_IN>
__device__ __forceinline__ void dq_kernel(const BwdArgs& ba) {
  constexpr int BK = kBwdTile<NT>, CP = 8 * NT, QS = CP + 8;
  const Args& a = ba.a;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kTQ][QS] qt
  bf16* g_s = q_s + kTQ * QS;                      // [kTQ][QS] dO
  bf16* k_s = g_s + kTQ * QS;                      // [2][BK][QS]
  bf16* v_s = k_s + 2 * BK * QS;                   // [2][BK][QS]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Block b = block_of(a.N, CP);
  stage_q(a, a.q + b.r * a.qs.r + b.h * a.qs.h, b.q0, CP, QS, q_s);
  // dO joins the first pass's first copy group
  stage_keys(ba.g + b.r * ba.gs.r + b.h * ba.gs.h, ba.gs.n, b.q0, kTQ, a.N, a.C, 0, CP, QS, g_s);
  const bf16* q_w = q_s + warp * 16 * QS;
  const bf16* g_w = g_s + warp * 16 * QS;
  const int row_a = b.q0 + warp * 16 + (lane >> 2);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  if (STATS_IN) {
    const long long base = ((long long)b.r * a.H + b.h) * a.N;
    const RowStats ra = load_stats<true>(ba.m, ba.s, ba.delta, base + row_a, row_a < a.N);
    const RowStats rb = load_stats<true>(ba.m, ba.s, ba.delta, base + row_a + 8, row_a + 8 < a.N);
    float d_a = ra.delta, d_b = rb.delta;
    dq_pass<true, BK, NT>(ba, b, q_w, g_w, k_s, v_s, ra.nm, rb.nm, ra.inv, rb.inv, d_a, d_b, acc,
                          lane);
    store_tile<NT>(ba.dq, a.N, a.H, a.C, b, row_a, acc, 1.f, 1.f, lane);
    return;
  }

  RowsState<2> st;  // pass 1 takes no V: its accumulators stay unused
  init_rows(st);
  rows_pass<kStats, BK, 2>(a, b, q_w, k_s, v_s, CP, st, lane);
  const float s_a = quad_sum(st.s_a), s_b = quad_sum(st.s_b);
  const float inv_a = 1.f / s_a, inv_b = 1.f / s_b;
  const float nm_a = -st.m_a * kLog2e, nm_b = -st.m_b * kLog2e;

  float d_a = 0.f, d_b = 0.f;
  dq_pass<false, BK, NT>(ba, b, q_w, g_w, k_s, v_s, nm_a, nm_b, inv_a, inv_b, d_a, d_b, acc, lane);
  d_a = quad_sum(d_a);
  d_b = quad_sum(d_b);
  dq_pass<true, BK, NT>(ba, b, q_w, g_w, k_s, v_s, nm_a, nm_b, inv_a, inv_b, d_a, d_b, acc, lane);

  store_tile<NT>(ba.dq, a.N, a.H, a.C, b, row_a, acc, 1.f, 1.f, lane);
  if ((lane & 3) == 0) {  // one lane per row
    const long long base = ((long long)b.r * a.H + b.h) * a.N;
    const float m[2] = {st.m_a, st.m_b}, s[2] = {s_a, s_b}, d[2] = {d_a, d_b};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_a + 8 * half;
      if (row >= a.N) continue;
      ba.m[base + row] = m[half];
      ba.s[base + row] = s[half];
      ba.delta[base + row] = d[half];
    }
  }
}

// The dk/dv kernel: a block of 64 keys of one (row, head); each query's
// stats from ba.m, ba.s (STATS_IN: log s) and ba.delta.
template <int NT, bool STATS_IN>
__device__ __forceinline__ void dkdv_kernel(const BwdArgs& ba) {
  constexpr int BQ = kBwdTile<NT>, NS = BQ / 8, CP = 8 * NT, QS = CP + 8, chunks = CP / 8;
  const Args& a = ba.a;
  const int N = a.N, C = a.C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kTQ][QS] the block's keys
  bf16* v_s = k_s + kTQ * QS;                      // [kTQ][QS]
  bf16* q_s = v_s + kTQ * QS;                      // [2][BQ][QS] qt
  bf16* g_s = q_s + 2 * BQ * QS;                   // [2][BQ][QS] dO
  float* st_s = reinterpret_cast<float*>(g_s + 2 * BQ * QS);  // [2][3][BQ]: nm, inv, delta

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Block b = block_of(N, CP);  // b.q0: the block's first key
  const bf16* q_base = a.q + b.r * a.qs.r + b.h * a.qs.h;
  const bf16* g_base = ba.g + b.r * ba.gs.r + b.h * ba.gs.h;
  const long long base = ((long long)b.r * a.H + b.h) * N;
  stage_keys(a.k + b.r * a.ks.r + b.h * a.ks.h, a.ks.n, b.q0, kTQ, N, C, 0, CP, QS, k_s);
  stage_keys(a.v + b.r * a.vs.r + b.h * a.vs.h, a.vs.n, b.q0, kTQ, N, C, 0, CP, QS, v_s);
  stage_keys(q_base, a.qs.n, 0, BQ, N, C, 0, CP, QS, q_s);
  stage_keys(g_base, ba.gs.n, 0, BQ, N, C, 0, CP, QS, g_s);
  cp_async_commit();
  // this thread's keys (rows g and g + 8 of its warp's 16); past N as masked
  const int row_a = b.q0 + warp * 16 + (lane >> 2);
  const float* mask_row = a.mask + (long long)b.r * N;
  const bool masked_a = row_a >= N || mask_row[row_a] < 0.5f;
  const bool masked_b = row_a + 8 >= N || mask_row[row_a + 8] < 0.5f;
  const bool stager = threadIdx.x < BQ;  // thread i stages the stats of query i of each tile
  RowStats cur{};
  if (stager) cur = load_stats<STATS_IN>(ba.m, ba.s, ba.delta, base + threadIdx.x, threadIdx.x < N);

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
      stage_keys(q_base, a.qs.n, i0 + BQ, BQ, N, C, 0, CP, QS, q_s + (buf ^ 1) * BQ * QS);
      stage_keys(g_base, ba.gs.n, i0 + BQ, BQ, N, C, 0, CP, QS, g_s + (buf ^ 1) * BQ * QS);
      if (stager) {
        const int i = i0 + BQ + threadIdx.x;
        next = load_stats<STATS_IN>(ba.m, ba.s, ba.delta, base + i, i < N);
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
    // qt: this thread's own copies of the tile, scaled and rounded in place
    bf16* q_t = q_s + buf * BQ * QS;
    for (int e = threadIdx.x; e < BQ * chunks; e += blockDim.x) {
      const int j = e / chunks;
      const int c = (e - j * chunks) * 8;
      if (i0 + j >= N || c >= C) continue;
      bf16* x = q_t + j * QS + c;
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = __float2bfloat16_rn(__bfloat162float(x[u]) * a.scale);
    }
    __syncthreads();

    const bf16* g_t = g_s + buf * BQ * QS;
    float s[NS][4], dp[NS][4];
    logits_mma<NS>(k_s + warp * 16 * QS, q_t, QS, CP, lane, s);   // S^T: rows keys
    logits_mma<NS>(v_s + warp * 16 * QS, g_t, QS, CP, lane, dp);  // dP^T
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
    pv_mma<NS, NT>(s, g_t, QS, lane, dv);   // dv += bf16(P^T) dO
    pv_mma<NS, NT>(dp, q_t, QS, lane, dk);  // dk += bf16(dS^T) qt
    __syncthreads();  // the next tile's loads overwrite this buffer
    cur = next;
  }
  store_tile<NT>(ba.dk, N, a.H, C, b, row_a, dk, 1.f, 1.f, lane);
  store_tile<NT>(ba.dv, N, a.H, C, b, row_a, dv, 1.f, 1.f, lane);
}

template <int NT>
__global__ void __launch_bounds__(kWarps * 32, kBwdMinBlocks<NT>)
    rows_attention_bwd_dq_mma_kernel(const BwdArgs ba) {
  dq_kernel<NT, false>(ba);
}

template <int NT>
__global__ void __launch_bounds__(kWarps * 32, kBwdMinBlocks<NT>)
    rows_attention_bwd_dkdv_mma_kernel(const BwdArgs ba) {
  dkdv_kernel<NT, false>(ba);
}

template <int NT>
__global__ void __launch_bounds__(kWarps * 32, kBwdMinBlocks<NT>)
    rows_attention_kchunk_bwd_dq_mma_kernel(const BwdArgs ba) {
  dq_kernel<NT, true>(ba);
}

template <int NT>
__global__ void __launch_bounds__(kWarps * 32, kBwdMinBlocks<NT>)
    rows_attention_kchunk_bwd_dkdv_mma_kernel(const BwdArgs ba) {
  dkdv_kernel<NT, true>(ba);
}

// Shared memory of the two kernels: 2 x 64 rows staged once and two
// buffers of two streamed tiles, plus the dk/dv kernel's column stats.
template <int NT>
constexpr size_t dq_smem() {
  return sizeof(bf16) * (size_t)(2 * kTQ + 4 * kBwdTile<NT>) * (8 * NT + 8);
}

template <int NT>
constexpr size_t dkdv_smem() {
  return dq_smem<NT>() + sizeof(float) * 6 * kBwdTile<NT>;
}

template <typename Kernel>
cudaError_t launch_one(Kernel kern, size_t smem, const BwdArgs& ba, unsigned blocks,
                       cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(blocks, ba.a.H), kWarps * 32, smem, stream>>>(ba);
  return cudaGetLastError();
}

template <int NT, bool STATS_IN>
cudaError_t launch(const BwdArgs& ba, cudaStream_t stream) {
  const long long blocks = (long long)((ba.a.N + kTQ - 1) / kTQ) * ba.a.R;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const cudaError_t e = launch_one(
      STATS_IN ? rows_attention_kchunk_bwd_dq_mma_kernel<NT> : rows_attention_bwd_dq_mma_kernel<NT>,
      dq_smem<NT>(), ba, (unsigned)blocks, stream);
  if (e != cudaSuccess) return e;
  return launch_one(STATS_IN ? rows_attention_kchunk_bwd_dkdv_mma_kernel<NT>
                             : rows_attention_bwd_dkdv_mma_kernel<NT>,
                    dkdv_smem<NT>(), ba, (unsigned)blocks, stream);
}

bool strides8(const Strides& s) { return s.r % 8 == 0 && s.n % 8 == 0 && s.h % 8 == 0; }

template <bool STATS_IN>
cudaError_t dispatch_width(const BwdArgs& ba, cudaStream_t stream) {
  const Args& a = ba.a;
  const bool ok = a.R > 0 && a.N > 0 && a.H > 0 && a.H <= 65535 && a.C > 0 && a.C <= 128 &&
                  a.C % 8 == 0 && strides8(a.qs) && strides8(a.ks) && strides8(a.vs) &&
                  strides8(ba.gs) && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
                  aligned16(ba.g) && a.mask != nullptr && ba.m != nullptr && ba.s != nullptr &&
                  ba.delta != nullptr;
  if (!ok) return cudaErrorInvalidValue;
  if (a.C <= 16) return launch<2, STATS_IN>(ba, stream);
  if (a.C <= 32) return launch<4, STATS_IN>(ba, stream);
  if (a.C <= 64) return launch<8, STATS_IN>(ba, stream);
  return launch<16, STATS_IN>(ba, stream);
}

}  // namespace

extern "C" {

// K7 on the tensor cores (bf16): dqt (w.r.t. the pre-scaled q), dk and dv of
// rows attention, C a multiple of 8 up to 128. stats is caller-allocated f32
// scratch of 3 * R * H * N values.
int prd_rows_attention_bwd_mma(const void* q, const void* k, const void* v, const void* mask,
                               const void* dout, void* dq, void* dk, void* dv, void* stats, int R,
                               int N, int H, int C, float scale, long long q_sr, long long q_sn,
                               long long q_sh, long long k_sr, long long k_sn, long long k_sh,
                               long long v_sr, long long v_sn, long long v_sh, long long g_sr,
                               long long g_sn, long long g_sh, void* stream) {
  float* st = static_cast<float*>(stats);
  const long long rhn = (long long)R * H * N;
  const BwdArgs ba{{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<const float*>(mask), nullptr,
                    nullptr, R, N, H, C, scale, {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh},
                    {v_sr, v_sn, v_sh}},
                   static_cast<const bf16*>(dout), {g_sr, g_sn, g_sh},
                   static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                   st, st == nullptr ? nullptr : st + rhn,
                   st == nullptr ? nullptr : st + 2 * rhn};
  return (int)dispatch_width<false>(ba, static_cast<cudaStream_t>(stream));
}

// K6 on the tensor cores (bf16): dqt (w.r.t. the pre-scaled q), dk and dv of
// the K-chunked rows attention from K5's m and log s and the caller's delta
// = rowsum(dO o O), all f32 [R, H, N]; C a multiple of 8 up to 128.
int prd_rows_attention_kchunk_bwd_mma(const void* q, const void* k, const void* v,
                                      const void* mask, const void* dout, const void* m,
                                      const void* logs, const void* delta, void* dq, void* dk,
                                      void* dv, int R, int N, int H, int C, float scale,
                                      long long q_sr, long long q_sn, long long q_sh,
                                      long long k_sr, long long k_sn, long long k_sh,
                                      long long v_sr, long long v_sn, long long v_sh,
                                      long long g_sr, long long g_sn, long long g_sh,
                                      void* stream) {
  const BwdArgs ba{{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v), static_cast<const float*>(mask), nullptr,
                    nullptr, R, N, H, C, scale, {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh},
                    {v_sr, v_sn, v_sh}},
                   static_cast<const bf16*>(dout), {g_sr, g_sn, g_sh},
                   static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                   static_cast<float*>(const_cast<void*>(m)),
                   static_cast<float*>(const_cast<void*>(logs)),
                   static_cast<float*>(const_cast<void*>(delta))};
  return (int)dispatch_width<true>(ba, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
