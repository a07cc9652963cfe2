// Helpers shared by the attention kernels (attention.cu, attention_bwd.cu,
// attention_kchunk.cu, attention_kchunk_bwd.cu) and the fused kernels
// (fused_gated.cu, trimul.cu, transition.cu, outer.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kMaskFill = -32768.0f;  // -2^15, the reference's padding fill
constexpr unsigned kFull = 0xffffffffu;

// Element strides of an [R, N, H, C] operand (the head dimension is contiguous).
struct Strides {
  long long r, n, h;
};

// Loads in f32, rounding to the input type, and the output cast.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float cast(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 cast(float x) {
    return __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Rows [t0, t0 + rows) of one (row, head) slice of an [R, N, H, C] operand
// into shared memory as f32, row stride dst_stride, rows past N zeroed. SCALE
// multiplies by scale and rounds to the input type (the pre-scaled q).
template <typename T, bool SCALE>
__device__ __forceinline__ void stage_rows(const T* __restrict__ base, long long stride_n, int t0,
                                           int rows, int N, int C, float scale, float* dst,
                                           int dst_stride) {
  for (int e = threadIdx.x; e < rows * C; e += blockDim.x) {
    const int j = e / C;
    const int c = e - j * C;
    const int t = t0 + j;
    float x = 0.f;
    if (t < N) {
      x = Io<T>::load(base + t * stride_n + c);
      if (SCALE) x = Io<T>::round(x * scale);
    }
    dst[j * dst_stride + c] = x;
  }
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// The warp's LayerNorm (no affine, eps 1e-5, f32 statistics) of one D-wide
// row in device memory, rounded to T, written as a column of a transposed tile
// in shared memory: dst[d * ld]. A dead row (live false, warp-uniform) writes
// zeros. The fused kernels' projection tiles (transition.cu, trimul.cu,
// fused_gated.cu) keep the normed rows transposed, so that tile_4x4 reads
// four rows with one 16-byte load.
template <typename T>
__device__ __forceinline__ void layer_norm_to_column(const T* row, bool live, int D, float* dst,
                                                     int ld) {
  const int lane = threadIdx.x & 31;
  if (!live) {
    for (int d = lane; d < D; d += 32) dst[d * ld] = 0.f;
    return;
  }
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += Io<T>::load(row + d);
  const float mu = warp_sum(s) / (float)D;
  float sq = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float t = Io<T>::load(row + d) - mu;
    sq = fmaf(t, t, sq);
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)D + 1e-5f);
  for (int d = lane; d < D; d += 32) dst[d * ld] = Io<T>::round((Io<T>::load(row + d) - mu) * rstd);
}

// acc[i][j] += sum_k A[k * lda + i] * B[k * ldb + j] over k < K for a 4 x 4
// register tile, A and B in shared memory at 16-byte aligned addresses (lda
// and ldb multiples of 4): 16 FMAs per two 16-byte loads.
__device__ __forceinline__ void tile_4x4(float (&acc)[4][4], const float* A, int lda,
                                         const float* B, int ldb, int K) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(A + k * lda);
    const float4 b = *reinterpret_cast<const float4*>(B + k * ldb);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[rr][t] += w[rr] of tile row ii (broadcast from lane ii) * tile[ii][lane +
// 32 t] over the tile's first n rows, in row order: the wide backward bodies'
// sums into a warp's RPW rows of head channels.
template <int RPW, int CPL>
__device__ __forceinline__ void sum_tile(float (&acc)[RPW][CPL], const float (&w)[RPW],
                                         const float* tile, int stride, int n, int C, int lane) {
  for (int ii = 0; ii < n; ++ii) {
    float xv[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = lane + 32 * t;
      xv[t] = c < C ? tile[ii * stride + c] : 0.f;
    }
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const float x = __shfl_sync(kFull, w[rr], ii);
#pragma unroll
      for (int t = 0; t < CPL; ++t) acc[rr][t] = fmaf(x, xv[t], acc[rr][t]);
    }
  }
}

// sum_c a[c] * b[c] in one fixed order, both in 16-byte aligned shared memory
// (C a multiple of 4): every kernel that recomputes a logit gets the same bits.
__device__ __forceinline__ float dot_smem(const float* a, const float* b, int C) {
  float acc = 0.f;
  for (int c = 0; c < C; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + c);
    const float4 y = *reinterpret_cast<const float4*>(b + c);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

}  // namespace
