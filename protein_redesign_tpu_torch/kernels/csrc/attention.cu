// Hand-written Hopper (sm_90a) kernels for the denoiser's attention family.
//
// Replaces two Pallas TPU kernels of protein_redesign_tpu/ops/pallas_attention.py:
//
//   rows_attention_kernel   <- _rows_attention_impl / _make_rowhead_kernel
//                              (triangle attention: key mask, no bias)
//   tiled_attention_kernel  <- _tiled_attention_impl / _attn_kernel and
//                              _attn_kernel_nomask (single attention and
//                              SPAttention: additive [R,H,N,N] bias, key mask
//                              optional)
//
// Both compute, per (row r, head h), softmax(q k^T + bias, masked) v with q
// already multiplied by the softmax scale in the input type, masked keys
// filled with -2^15 (so a fully masked row gives uniform weights, the mean of
// v), logits in f32, probabilities rounded to the input type before the P.V
// product (`probs.astype(v.dtype)`), f32 accumulation and the output cast to
// the input type.
//
// What bounds them on the card. The TPU kernels keep a whole [TQ, N] logits
// block in VMEM; an SM has at most 227 KB of shared memory, so a [TQ, N]
// block does not fit across the bucket ladder (N = 64..2048) and head widths
// (C = 16 for triangle and single attention, C = single_dim = 512 for
// SPAttention). These kernels stream keys through shared memory in tiles of
// 32 and recompute the logits in a second pass instead:
//   pass 1: running row max and sum of exp over all key tiles;
//   pass 2: p = exp(l - m) / s, rounded to the input type, times V.
// Shared memory is O(TQ*C + 32*C) whatever N is, so there is no bound on N;
// C is bounded at 512 by the per-thread accumulator (C/32 values per lane
// and query row). The products run on the CUDA cores in f32, so the kernels
// are bound by issue rate (shared-memory loads and FMAs), not by HBM bytes:
// each (row, head) slice of K and V is a few KB and stays in L2 across its
// q-tiles. Tensor cores (wgmma), TMA and a single-pass online softmax are
// left for later work.
//
// Layout: q, k, v are [R, N, H, C] with the head dimension contiguous and the
// other strides given in elements; mask is contiguous f32 [R, N]; bias is
// contiguous [R, H, N, N] in the input type; out is contiguous [R, N, H, C].
// Each entry point returns cudaGetLastError() after its launch.

#include "common.cuh"

namespace {

constexpr int kTK = 32;                 // keys per tile: one key per lane
constexpr int kRPW = 4;                 // query rows per warp

// kTK rows of one head's K or V into shared memory as f32, rows past N zeroed.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ base, long long stride_n,
                                          float* dst, int dst_stride, int k0, int N, int C) {
  for (int e = threadIdx.x; e < kTK * C; e += blockDim.x) {
    const int j = e / C;
    const int c = e - j * C;
    const int key = k0 + j;
    dst[j * dst_stride + c] = key < N ? Io<T>::load(base + key * stride_n + c) : 0.f;
  }
}

// Logits of this warp's kRPW query rows against the lane's key, bias added and
// the key mask applied as the reference does (bias first, then the fill).
template <typename T, bool HAS_MASK, bool HAS_BIAS>
__device__ __forceinline__ void row_logits(const float* q_rows, const float* k_row, int C,
                                           const float* __restrict__ mask_row,
                                           const T* __restrict__ bias_head, int qi0, int j,
                                           int N, float (&l)[kRPW]) {
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) l[rr] = 0.f;
  for (int c = 0; c < C; c += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(k_row + c);
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      const float4 qv = *reinterpret_cast<const float4*>(q_rows + rr * C + c);
      float acc = l[rr];
      acc = fmaf(qv.x, kv.x, acc);
      acc = fmaf(qv.y, kv.y, acc);
      acc = fmaf(qv.z, kv.z, acc);
      acc = fmaf(qv.w, kv.w, acc);
      l[rr] = acc;
    }
  }
  if (HAS_BIAS) {
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      const int qi = qi0 + rr;
      if (qi < N) l[rr] += Io<T>::load(bias_head + (long long)qi * N + j);
    }
  }
  if (HAS_MASK) {
    if (mask_row[j] < 0.5f) {
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr) l[rr] = kMaskFill;
    }
  }
}

// One block: NWARPS * kRPW query rows of one (row, head). CPL = head-dim
// values per lane in the P.V accumulator (C <= 32 * CPL).
template <typename T, int CPL, int NWARPS, bool HAS_MASK, bool HAS_BIAS>
__device__ __forceinline__ void attention_body(const T* __restrict__ q, const T* __restrict__ k,
                                               const T* __restrict__ v,
                                               const float* __restrict__ mask,
                                               const T* __restrict__ bias, T* __restrict__ out,
                                               int N, int H, int C, float scale, Strides qs,
                                               Strides ks, Strides vs) {
  constexpr int TQ = NWARPS * kRPW;
  extern __shared__ __align__(16) float smem[];
  const int k_stride = C + 4;  // padded K rows: conflict-free float4 reads by lane
  float* q_s = smem;                   // [TQ][C]
  float* k_s = q_s + TQ * C;           // [kTK][C + 4]
  float* v_s = k_s + kTK * k_stride;   // [kTK][C]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // grid.x walks (row, q-tile) with the q-tiles of a row adjacent, so the
  // row count is bounded by grid.x's 2^31 - 1 blocks, not by grid.z's 65535.
  const int tiles = (N + TQ - 1) / TQ;
  const int r = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - r * tiles) * TQ;
  const int h = blockIdx.y;
  const T* q_base = q + r * qs.r + h * qs.h;
  const T* k_base = k + r * ks.r + h * ks.h;
  const T* v_base = v + r * vs.r + h * vs.h;
  const float* mask_row = HAS_MASK ? mask + (long long)r * N : nullptr;
  const T* bias_head = HAS_BIAS ? bias + ((long long)r * H + h) * N * N : nullptr;

  // q tile, scaled in the input type as `q * scale` is upstream.
  for (int e = threadIdx.x; e < TQ * C; e += blockDim.x) {
    const int i = e / C;
    const int c = e - i * C;
    const int qi = q0 + i;
    q_s[e] = qi < N ? Io<T>::round(Io<T>::load(q_base + qi * qs.n + c) * scale) : 0.f;
  }

  const int row0 = warp * kRPW;
  const int qi0 = q0 + row0;
  const float* q_rows = q_s + row0 * C;
  const float* k_row = k_s + lane * k_stride;

  // Pass 1: per-lane running max and sum over the lane's keys.
  float m[kRPW], s[kRPW];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    m[rr] = neg_inf();
    s[rr] = 0.f;
  }
  for (int k0 = 0; k0 < N; k0 += kTK) {
    __syncthreads();
    load_tile(k_base, ks.n, k_s, k_stride, k0, N, C);
    __syncthreads();
    const int j = k0 + lane;
    if (j < N) {
      float l[kRPW];
      row_logits<T, HAS_MASK, HAS_BIAS>(q_rows, k_row, C, mask_row, bias_head, qi0, j, N, l);
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr) {
        if (l[rr] > m[rr]) {
          s[rr] = s[rr] * expf(m[rr] - l[rr]) + 1.f;
          m[rr] = l[rr];
        } else {
          s[rr] += expf(l[rr] - m[rr]);
        }
      }
    }
  }
  // Combine the lanes: every lane ends with the row's max and sum.
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(kFull, m[rr], off);
      const float so = __shfl_xor_sync(kFull, s[rr], off);
      const float mn = fmaxf(m[rr], mo);
      const float a = m[rr] == neg_inf() ? 0.f : s[rr] * expf(m[rr] - mn);
      const float b = mo == neg_inf() ? 0.f : so * expf(mo - mn);
      m[rr] = mn;
      s[rr] = a + b;
    }
  }

  // Pass 2: recompute the logits, normalise, accumulate P.V in f32.
  float acc[kRPW][CPL];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr)
#pragma unroll
    for (int t = 0; t < CPL; ++t) acc[rr][t] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kTK) {
    __syncthreads();
    load_tile(k_base, ks.n, k_s, k_stride, k0, N, C);
    load_tile(v_base, vs.n, v_s, C, k0, N, C);
    __syncthreads();
    const int j = k0 + lane;
    float p[kRPW];
    if (j < N) {
      row_logits<T, HAS_MASK, HAS_BIAS>(q_rows, k_row, C, mask_row, bias_head, qi0, j, N, p);
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr) p[rr] = Io<T>::round(expf(p[rr] - m[rr]) / s[rr]);
    } else {
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr) p[rr] = 0.f;
    }
    const int nk = min(kTK, N - k0);
    for (int jj = 0; jj < nk; ++jj) {
      const float* v_row = v_s + jj * C;
      float vv[CPL];
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        const int c = lane + 32 * t;
        vv[t] = c < C ? v_row[c] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr) {
        const float pj = __shfl_sync(kFull, p[rr], jj);
#pragma unroll
        for (int t = 0; t < CPL; ++t) acc[rr][t] = fmaf(pj, vv[t], acc[rr][t]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    const int qi = qi0 + rr;
    if (qi >= N) continue;
    T* out_row = out + (((long long)r * N + qi) * H + h) * C;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = lane + 32 * t;
      if (c < C) out_row[c] = Io<T>::cast(acc[rr][t]);
    }
  }
}

template <typename T, int CPL, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32)
    rows_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ mask,
                          T* __restrict__ out, int N, int H, int C, float scale, Strides qs,
                          Strides ks, Strides vs) {
  attention_body<T, CPL, NWARPS, true, false>(q, k, v, mask, nullptr, out, N, H, C, scale, qs, ks,
                                              vs);
}

template <typename T, int CPL, int NWARPS, bool HAS_MASK, bool HAS_BIAS>
__global__ void __launch_bounds__(NWARPS * 32)
    tiled_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const float* __restrict__ mask,
                           const T* __restrict__ bias, T* __restrict__ out, int N, int H, int C,
                           float scale, Strides qs, Strides ks, Strides vs) {
  attention_body<T, CPL, NWARPS, HAS_MASK, HAS_BIAS>(q, k, v, mask, bias, out, N, H, C, scale, qs,
                                                     ks, vs);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* mask;
  const void* bias;
  void* out;
  int R, N, H, C;
  float scale;
  Strides qs, ks, vs;
  cudaStream_t stream;
};

template <typename T, int CPL, bool ROWS, bool HAS_MASK, bool HAS_BIAS>
cudaError_t launch(const Args& a) {
  constexpr int NWARPS = CPL <= 2 ? 8 : 4;
  constexpr int TQ = NWARPS * kRPW;
  const size_t smem = sizeof(float) * (size_t)(TQ * a.C + kTK * (a.C + 4) + kTK * a.C);
  const long long blocks = (long long)((a.N + TQ - 1) / TQ) * a.R;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, a.H);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const float* mask = static_cast<const float*>(a.mask);
  T* out = static_cast<T*>(a.out);
  if constexpr (ROWS) {
    auto kern = rows_attention_kernel<T, CPL, NWARPS>;
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    kern<<<grid, NWARPS * 32, smem, a.stream>>>(q, k, v, mask, out, a.N, a.H, a.C, a.scale, a.qs,
                                               a.ks, a.vs);
  } else {
    auto kern = tiled_attention_kernel<T, CPL, NWARPS, HAS_MASK, HAS_BIAS>;
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    kern<<<grid, NWARPS * 32, smem, a.stream>>>(q, k, v, mask, static_cast<const T*>(a.bias),
                                               out, a.N, a.H, a.C, a.scale, a.qs, a.ks, a.vs);
  }
  return cudaGetLastError();
}

template <typename T, bool ROWS, bool HAS_MASK, bool HAS_BIAS>
cudaError_t dispatch_width(const Args& a) {
  if (a.C <= 32) return launch<T, 1, ROWS, HAS_MASK, HAS_BIAS>(a);
  if (a.C <= 64) return launch<T, 2, ROWS, HAS_MASK, HAS_BIAS>(a);
  if (a.C <= 128) return launch<T, 4, ROWS, HAS_MASK, HAS_BIAS>(a);
  if (a.C <= 256) return launch<T, 8, ROWS, HAS_MASK, HAS_BIAS>(a);
  return launch<T, 16, ROWS, HAS_MASK, HAS_BIAS>(a);
}

template <bool ROWS, bool HAS_MASK, bool HAS_BIAS>
cudaError_t dispatch_type(int dtype, const Args& a) {
  if (dtype == 0) return dispatch_width<float, ROWS, HAS_MASK, HAS_BIAS>(a);
  return dispatch_width<__nv_bfloat16, ROWS, HAS_MASK, HAS_BIAS>(a);
}

bool valid(int dtype, const Args& a) {
  return (dtype == 0 || dtype == 1) && a.R > 0 && a.N > 0 && a.H > 0 && a.H <= 65535 &&
         a.C > 0 && a.C <= 512 && a.C % 4 == 0;
}

}  // namespace

extern "C" {

// K1: masked attention without bias (triangle attention).
int prd_rows_attention(const void* q, const void* k, const void* v, const void* mask, void* out,
                       int dtype, int R, int N, int H, int C, float scale, long long q_sr,
                       long long q_sn, long long q_sh, long long k_sr, long long k_sn,
                       long long k_sh, long long v_sr, long long v_sn, long long v_sh,
                       void* stream) {
  const Args a{q, k, v, mask, nullptr, out, R, N, H, C, scale,
               {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh}, {v_sr, v_sn, v_sh},
               static_cast<cudaStream_t>(stream)};
  if (!valid(dtype, a) || mask == nullptr) return (int)cudaErrorInvalidValue;
  return (int)dispatch_type<true, true, false>(dtype, a);
}

// K2: attention with an additive bias and an optional key mask (single
// attention, SPAttention).
int prd_tiled_attention(const void* q, const void* k, const void* v, const void* mask,
                        const void* bias, void* out, int dtype, int R, int N, int H, int C,
                        float scale, long long q_sr, long long q_sn, long long q_sh,
                        long long k_sr, long long k_sn, long long k_sh, long long v_sr,
                        long long v_sn, long long v_sh, void* stream) {
  const Args a{q, k, v, mask, bias, out, R, N, H, C, scale,
               {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh}, {v_sr, v_sn, v_sh},
               static_cast<cudaStream_t>(stream)};
  // masked attention without a bias is K1's
  if (!valid(dtype, a) || bias == nullptr) return (int)cudaErrorInvalidValue;
  if (mask != nullptr) return (int)dispatch_type<false, true, true>(dtype, a);
  return (int)dispatch_type<false, false, true>(dtype, a);
}

const char* prd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
