// Hand-written Hopper (sm_90a) backward of the K-chunked rows attention, fed
// by the forward's softmax stats.
//
// Replaces the Pallas TPU kernel of protein_redesign_tpu/ops/pallas_attention.py
//
//   rows_attention_kchunk_bwd  <- _make_rowhead_kchunk_grid_cn_bwd_kernel (K6,
//                                 via _kchunk_grid_cn_grads_call)
//
// Per (row r, head h), with qt = q * scale rounded to the input type, the
// key mask filled with -2^15, the forward's split stats m and log s and
// delta_i = sum_c dO_ic O_ic (f32, computed by the caller from the forward's
// output, as _rows_attention_bwd_stats_impl does):
//   P   = exp((l - m) - log s)                  f32, l = qt k^T in f32
//   dS  = P o (dP - delta),  dP = dO v^T        zero at masked keys
//   dv  = round_v(P)^T dO
//   dqt = round_q(dS) k,   dk = round_q(dS)^T qt
// with f32 sums and outputs in the input type. dqt is the gradient with
// respect to the pre-scaled q; the caller multiplies it by the scale. There
// is no max/sum pass and no delta pass: the stats come in. A fully masked
// row has m = -2^15 and log s = log N, so its P is exactly uniform and feeds
// dv, while its dS, and with it its share of dq and dk, is zero.
//
// The Pallas kernel carries dq across its sequential key-chunk grid axis;
// CUDA blocks run in no order and cannot carry a sum, and atomics would make
// the result depend on the order. So it is two kernels, neither with a
// cross-block sum:
//   rows_attention_kchunk_dq_kernel: one block per (row, tile of queries,
//     head), each warp 4 queries, looping over 32-key tiles of K and V;
//   rows_attention_kchunk_dkdv_kernel: one block per (row, tile of keys,
//     head), each warp 4 keys, looping over 32-query tiles of qt, dO, m,
//     log s and delta.
// In both a lane takes one key (or one query) of the tile and computes its
// logit and dP against the warp's 4 rows with dot_smem, the same order in
// both kernels, so P agrees bit for bit between them; the products into dq,
// dk and dv run with the lanes on the head channels and each dS or P
// broadcast by a shuffle. Shared memory is O((TQ + 64) C): no bound on N.
// CUDA cores in f32. This body serves C = 4 mod 8; multiples of 8 take the
// tensor-core bodies (attention_bwd_{mma,tf32}.cu up to 128,
// attention_kchunk_bwd_wide_{mma,tf32}.cu past it), and this one stays
// callable to time it beside them.
//
// Head widths run to 1024 (CPL = C / 32 values a lane and row). Past 512 the
// two staged tiles would not fit beside the block's rows, so (SHARE) a
// block takes 8 rows and one tile buffer: K (or qt) is staged for the
// logits, then V (or dO) into the same buffer for dP and, in the dk/dv
// kernel, dv's sums, then K (qt) again for the dS products. Each
// accumulator sums the same terms in the same order as without SHARE; the
// [4, CPL] accumulators spill at that width.
//
// Layout: q, k, v and dO are [R, N, H, C] with the head dimension
// contiguous and the other strides given in elements; mask is contiguous f32
// [R, N]; m, log s and delta are contiguous f32 [R, H, N]; dq, dk, dv are
// contiguous [R, N, H, C]. Offsets are 64-bit. The entry point returns
// cudaGetLastError() after its launches.

#include "common.cuh"

namespace {

constexpr int kTile = 32;  // keys (dq kernel) or queries (dk/dv kernel) per staged tile
constexpr int kRPW = 4;    // queries (dq kernel) or keys (dk/dv kernel) per warp

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;
  const void* g;  // dO
  const float* m;
  const float* logs;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int R, N, H, C;
  float scale;
  Strides qs, ks, vs, gs;
};

// Stores a warp's 4 rows of [4][CPL] channel accumulators (lane + 32 t) into
// the contiguous [R, N, H, C] output at rows first .. first + 3.
template <typename T, int CPL>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const float (&acc)[kRPW][CPL],
                                           int r, int first, int N, int H, int h, int C,
                                           int lane) {
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    const int row = first + rr;
    if (row >= N) continue;
    T* dst = out + (((long long)r * N + row) * H + h) * C;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = lane + 32 * t;
      if (c < C) dst[c] = Io<T>::cast(acc[rr][t]);
    }
  }
}

template <typename T, int CPL, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32) rows_attention_kchunk_dq_kernel(const Args a) {
  constexpr int TQ = NWARPS * kRPW;
  constexpr bool SHARE = CPL > 16;
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, C = a.C, H = a.H;
  const int stride = C + 4;  // padded K/V rows: conflict-free float4 reads by lane
  float* q_s = smem;                                // [TQ][C]
  float* g_s = q_s + TQ * C;                        // [TQ][C]
  float* k_s = g_s + TQ * C;                        // [kTile][C + 4]
  float* v_s = SHARE ? k_s : k_s + kTile * stride;  // [kTile][C + 4]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles = (N + TQ - 1) / TQ;
  const int r = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - r * tiles) * TQ;
  const int h = blockIdx.y;
  const T* k_base = static_cast<const T*>(a.k) + r * a.ks.r + h * a.ks.h;
  const T* v_base = static_cast<const T*>(a.v) + r * a.vs.r + h * a.vs.h;
  const float* mask_row = a.mask + (long long)r * N;

  stage_rows<T, true>(static_cast<const T*>(a.q) + r * a.qs.r + h * a.qs.h, a.qs.n, q0, TQ, N, C,
                      a.scale, q_s, C);
  stage_rows<T, false>(static_cast<const T*>(a.g) + r * a.gs.r + h * a.gs.h, a.gs.n, q0, TQ, N, C,
                       1.f, g_s, C);

  const int row0 = warp * kRPW;
  float m[kRPW], logs[kRPW], delta[kRPW], acc[kRPW][CPL];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    const int qi = q0 + row0 + rr;
    const long long idx = ((long long)r * H + h) * N + qi;
    const bool ok = qi < N;
    m[rr] = ok ? a.m[idx] : 0.f;
    logs[rr] = ok ? a.logs[idx] : 0.f;
    delta[rr] = ok ? a.delta[idx] : 0.f;
#pragma unroll
    for (int t = 0; t < CPL; ++t) acc[rr][t] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    stage_rows<T, false>(k_base, a.ks.n, k0, kTile, N, C, 1.f, k_s, stride);
    if constexpr (!SHARE) stage_rows<T, false>(v_base, a.vs.n, k0, kTile, N, C, 1.f, v_s, stride);
    __syncthreads();
    const int j = k0 + lane;
    const bool keep = j < N && mask_row[j] >= 0.5f;  // dS is zero at masked keys
    float p[kRPW], ds[kRPW];
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      p[rr] = 0.f;
      if (keep) {
        const float l = dot_smem(q_s + (row0 + rr) * C, k_s + lane * stride, C);
        p[rr] = expf((l - m[rr]) - logs[rr]);
      }
    }
    if constexpr (SHARE) {
      __syncthreads();  // every warp's logits have read K's tile
      stage_rows<T, false>(v_base, a.vs.n, k0, kTile, N, C, 1.f, v_s, stride);
      __syncthreads();
    }
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      ds[rr] = 0.f;
      if (keep) {
        const float dp = dot_smem(g_s + (row0 + rr) * C, v_s + lane * stride, C);
        ds[rr] = Io<T>::round(p[rr] * (dp - delta[rr]));
      }
    }
    if constexpr (SHARE) {
      __syncthreads();  // every warp's dP has read V's tile
      stage_rows<T, false>(k_base, a.ks.n, k0, kTile, N, C, 1.f, k_s, stride);
      __syncthreads();
    }
    const int nk = min(kTile, N - k0);
    for (int jj = 0; jj < nk; ++jj) {
      const float* k_row = k_s + jj * stride;
      float kv[CPL];
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        const int c = lane + 32 * t;
        kv[t] = c < C ? k_row[c] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr) {
        const float d = __shfl_sync(kFull, ds[rr], jj);
#pragma unroll
        for (int t = 0; t < CPL; ++t) acc[rr][t] = fmaf(d, kv[t], acc[rr][t]);
      }
    }
  }
  store_rows<T, CPL>(static_cast<T*>(a.dq), acc, r, q0 + row0, N, H, h, C, lane);
}

template <typename T, int CPL, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32) rows_attention_kchunk_dkdv_kernel(const Args a) {
  constexpr int TK = NWARPS * kRPW;
  constexpr bool SHARE = CPL > 16;
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, C = a.C, H = a.H;
  const int stride = C + 4;  // padded q/dO rows: conflict-free float4 reads by lane
  float* k_s = smem;                                // [TK][C]
  float* v_s = k_s + TK * C;                        // [TK][C]
  float* q_s = v_s + TK * C;                        // [kTile][C + 4]
  float* g_s = SHARE ? q_s : q_s + kTile * stride;  // [kTile][C + 4]
  float* m_s = g_s + kTile * stride;   // [kTile]
  float* logs_s = m_s + kTile;         // [kTile]
  float* delta_s = logs_s + kTile;     // [kTile]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles = (N + TK - 1) / TK;
  const int r = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - r * tiles) * TK;
  const int h = blockIdx.y;
  const T* q_base = static_cast<const T*>(a.q) + r * a.qs.r + h * a.qs.h;
  const T* g_base = static_cast<const T*>(a.g) + r * a.gs.r + h * a.gs.h;
  const long long stats_row = ((long long)r * H + h) * N;

  stage_rows<T, false>(static_cast<const T*>(a.k) + r * a.ks.r + h * a.ks.h, a.ks.n, j0, TK, N,
                       C, 1.f, k_s, C);
  stage_rows<T, false>(static_cast<const T*>(a.v) + r * a.vs.r + h * a.vs.h, a.vs.n, j0, TK, N,
                       C, 1.f, v_s, C);

  const int row0 = warp * kRPW;
  bool masked[kRPW], keep[kRPW];
  float dk[kRPW][CPL], dv[kRPW][CPL];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    const int j = j0 + row0 + rr;
    masked[rr] = j >= N || a.mask[(long long)r * N + j] < 0.5f;
    keep[rr] = !masked[rr];
#pragma unroll
    for (int t = 0; t < CPL; ++t) dk[rr][t] = dv[rr][t] = 0.f;
  }

  for (int i0 = 0; i0 < N; i0 += kTile) {
    __syncthreads();
    stage_rows<T, true>(q_base, a.qs.n, i0, kTile, N, C, a.scale, q_s, stride);
    if constexpr (!SHARE) stage_rows<T, false>(g_base, a.gs.n, i0, kTile, N, C, 1.f, g_s, stride);
    if (threadIdx.x < kTile) {
      const int qi = i0 + threadIdx.x;
      const bool ok = qi < N;
      m_s[threadIdx.x] = ok ? a.m[stats_row + qi] : 0.f;
      logs_s[threadIdx.x] = ok ? a.logs[stats_row + qi] : 0.f;
      delta_s[threadIdx.x] = ok ? a.delta[stats_row + qi] : 0.f;
    }
    __syncthreads();
    const bool live = i0 + lane < N;
    const float* q_row = q_s + lane * stride;
    const float* g_row = g_s + lane * stride;
    float p[kRPW], pv[kRPW], ds[kRPW];
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      p[rr] = pv[rr] = ds[rr] = 0.f;
      if (!live) continue;
      const float l = masked[rr] ? kMaskFill : dot_smem(q_row, k_s + (row0 + rr) * C, C);
      p[rr] = expf((l - m_s[lane]) - logs_s[lane]);
      pv[rr] = Io<T>::round(p[rr]);
    }
    if constexpr (SHARE) {
      __syncthreads();  // every warp's logits have read qt's tile
      stage_rows<T, false>(g_base, a.gs.n, i0, kTile, N, C, 1.f, g_s, stride);
      __syncthreads();
    }
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      if (live && keep[rr]) {
        const float dp = dot_smem(g_row, v_s + (row0 + rr) * C, C);
        ds[rr] = Io<T>::round(p[rr] * (dp - delta_s[lane]));
      }
    }
    const int ni = min(kTile, N - i0);
    if constexpr (SHARE) {
      sum_tile<kRPW, CPL>(dv, pv, g_s, stride, ni, C, lane);
      __syncthreads();  // every warp's sums have read dO's tile
      stage_rows<T, true>(q_base, a.qs.n, i0, kTile, N, C, a.scale, q_s, stride);
      __syncthreads();
      sum_tile<kRPW, CPL>(dk, ds, q_s, stride, ni, C, lane);
      continue;
    }
    for (int ii = 0; ii < ni; ++ii) {
      float qv[CPL], gv[CPL];
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        const int c = lane + 32 * t;
        qv[t] = c < C ? q_s[ii * stride + c] : 0.f;
        gv[t] = c < C ? g_s[ii * stride + c] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr) {
        const float p = __shfl_sync(kFull, pv[rr], ii);
        const float d = __shfl_sync(kFull, ds[rr], ii);
#pragma unroll
        for (int t = 0; t < CPL; ++t) {
          dv[rr][t] = fmaf(p, gv[t], dv[rr][t]);
          dk[rr][t] = fmaf(d, qv[t], dk[rr][t]);
        }
      }
    }
  }
  store_rows<T, CPL>(static_cast<T*>(a.dk), dk, r, j0 + row0, N, H, h, C, lane);
  store_rows<T, CPL>(static_cast<T*>(a.dv), dv, r, j0 + row0, N, H, h, C, lane);
}

template <typename Kernel>
cudaError_t launch_one(Kernel kern, int rows_per_block, size_t smem, int threads, const Args& a,
                       cudaStream_t stream) {
  const long long blocks = (long long)((a.N + rows_per_block - 1) / rows_per_block) * a.R;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((unsigned)blocks, a.H), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int CPL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int NWARPS = CPL <= 2 ? 8 : (CPL > 16 ? 2 : 4);
  constexpr int ROWS = NWARPS * kRPW;
  constexpr int TILES = CPL > 16 ? 1 : 2;  // SHARE: one tile buffer
  const size_t smem =
      sizeof(float) * (size_t)(2 * ROWS * a.C + TILES * kTile * (a.C + 4) + 3 * kTile);
  const cudaError_t e = launch_one(rows_attention_kchunk_dq_kernel<T, CPL, NWARPS>, ROWS, smem,
                                   NWARPS * 32, a, stream);
  if (e != cudaSuccess) return e;
  return launch_one(rows_attention_kchunk_dkdv_kernel<T, CPL, NWARPS>, ROWS, smem, NWARPS * 32, a,
                    stream);
}

template <typename T>
cudaError_t dispatch_width(const Args& a, cudaStream_t stream) {
  if (a.C <= 32) return launch<T, 1>(a, stream);
  if (a.C <= 64) return launch<T, 2>(a, stream);
  if (a.C <= 128) return launch<T, 4>(a, stream);
  if (a.C <= 256) return launch<T, 8>(a, stream);
  if (a.C <= 512) return launch<T, 16>(a, stream);
  return launch<T, 32>(a, stream);
}

}  // namespace

extern "C" {

// K6: dq (w.r.t. the pre-scaled q), dk and dv of the K-chunked rows attention
// from the forward's stats m, log s and the caller's delta, all f32 [R, H, N].
// Takes C a multiple of 4 up to 1024.
int prd_rows_attention_kchunk_bwd(const void* q, const void* k, const void* v, const void* mask,
                                  const void* dout, const void* m, const void* logs,
                                  const void* delta, void* dq, void* dk, void* dv, int dtype,
                                  int R, int N, int H, int C, float scale, long long q_sr,
                                  long long q_sn, long long q_sh, long long k_sr, long long k_sn,
                                  long long k_sh, long long v_sr, long long v_sn, long long v_sh,
                                  long long g_sr, long long g_sn, long long g_sh, void* stream) {
  const Args a{q, k, v, static_cast<const float*>(mask), dout, static_cast<const float*>(m),
               static_cast<const float*>(logs), static_cast<const float*>(delta), dq, dk, dv,
               R, N, H, C, scale,
               {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh}, {v_sr, v_sn, v_sh}, {g_sr, g_sn, g_sh}};
  const bool ok = (dtype == 0 || dtype == 1) && R > 0 && N > 0 && H > 0 && H <= 65535 && C > 0 &&
                  C <= 1024 && C % 4 == 0 && mask != nullptr && m != nullptr && logs != nullptr &&
                  delta != nullptr;
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_width<float>(a, s);
  return (int)dispatch_width<__nv_bfloat16>(a, s);
}

}  // extern "C"
