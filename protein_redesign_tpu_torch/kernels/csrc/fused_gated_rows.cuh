// K8's LN + projection as ln_project.cuh's blocks see it: the loader of the
// rows x [R1, R2, N, D] through their strides (the "ending" attention's
// transposed view needs no copy) and the epilogue into the scratch (q
// scaled and rounded, k, v in T; the gate's sigmoid in f32), shared by
// fused_gated_mma.cu (the block up to D = 128) and fused_gated_wide.cu (the
// wide block past it). Layouts as fused_gated_mma.cu states them; H C a
// multiple of 4.
#pragma once

#include "ln_project.cuh"

namespace {

// The block's loader: 64 positions of x [R1, R2, N, D] read through strides.
template <typename T>
struct StridedRows {
  const T* x;
  int R2, N, D;
  long long s1, s2, sn;

  bool vec;  // x and its strides on 16 bytes, D a multiple of 16 bytes (strided_rows)

  // One 64-bit division a block (R N positions, R < 2^31).
  __device__ __forceinline__ void operator()(float* raw, int ld, long long p0, int rows, int d0,
                                             int dn) const {
    const long long row0 = p0 / N;
    const int n0 = (int)(p0 - row0 * N);
    lnp_load_rows<T>(raw, ld, dn, rows, vec, [&](int p) {
      int n = n0 + p, row = (int)row0;
      if (n >= N) {
        row += n / N;
        n -= (n / N) * N;
      }
      const int r1 = row / R2;
      return x + r1 * s1 + (long long)(row - r1 * R2) * s2 + (long long)n * sn + d0;
    });
  }
};

// The loader of x [R1, R2, N, D] with element strides (s1, s2, sn), 16-byte
// loads where x, D and the strides allow them.
template <typename T>
__device__ __forceinline__ StridedRows<T> strided_rows(const T* x, int R2, int N, int D,
                                                       long long s1, long long s2, long long sn) {
  constexpr int kChunk = 16 / sizeof(T);
  const bool vec = D % kChunk == 0 && (reinterpret_cast<unsigned long long>(x) & 15u) == 0 &&
                   s1 % kChunk == 0 && s2 % kChunk == 0 && sn % kChunk == 0;
  return StridedRows<T>{x, R2, N, D, s1, s2, sn, vec};
}

// The block's epilogue: q (scaled in f32, then rounded), k, v into
// qkv [3, positions, H C] in T, the gate's sigmoid into gate [positions, H C];
// where H C % 8 == 0 a thread takes 8 columns of a position at a time (an
// 8-column chunk lies in one of q, k, v and gate), 16- or 32-byte stores
// along rows; else (the split route's H C = 4 mod 8) element by element,
// consecutive threads along a row.
template <typename T>
struct QkvGate {
  T* qkv;
  float* gate;
  const float* bg;
  int HC;
  float scale;
  long long positions;

  __device__ __forceinline__ void operator()(const float* tile, long long p0, int rows,
                                             int c0) const {
    if (HC % 8 != 0) {
      for (int i = threadIdx.x; i < kLnpRows * kLnpCols; i += kLnpThreads) {
        const int p = i / kLnpCols, c = i - p * kLnpCols, col = c0 + c;
        if (p >= rows || col >= 4 * HC) continue;
        const float v = tile[p * kLnpLdT + c];
        const long long pos = p0 + p;
        const int which = col / HC;  // 0 q, 1 k, 2 v, 3 gate
        const int hc = col - which * HC;
        if (which == 3)
          gate[pos * HC + hc] = sigmoid_f(v + bg[hc]);
        else
          qkv[(which * positions + pos) * HC + hc] = Io<T>::cast(which == 0 ? v * scale : v);
      }
      return;
    }
    constexpr int kItems = kLnpRows * (kLnpCols / 8) / kLnpThreads;
    float v[kItems][8], b[kItems][8];  // the loads before any store
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x + kLnpThreads * k;
      const int p = i >> 3, col = c0 + (i & 7) * 8;
      load8(tile + p * kLnpLdT + (i & 7) * 8, v[k]);
#pragma unroll
      for (int j = 0; j < 8; ++j) b[k][j] = col >= 3 * HC && col < 4 * HC ? bg[col - 3 * HC + j] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x + kLnpThreads * k;
      const int p = i >> 3, col = c0 + (i & 7) * 8;
      if (p >= rows || col >= 4 * HC) continue;
      const long long pos = p0 + p;
      const int which = col / HC;  // 0 q, 1 k, 2 v, 3 gate
      const int c = col - which * HC;
      float o[8];
      if (which == 3) {
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = sigmoid_f(v[k][j] + b[k][j]);
        store8(gate + pos * HC + c, o);
      } else {
        const float s = which == 0 ? scale : 1.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) o[j] = v[k][j] * s;
        store8(qkv + (which * positions + pos) * HC + c, o);
      }
    }
  }
};

}  // namespace
