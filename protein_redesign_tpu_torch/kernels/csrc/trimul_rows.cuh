// K9's LN + projection stages as ln_project.cuh's blocks see them: the
// kernels' arguments, the loaders (the pair's rows; the channel-major
// product) and the epilogues (gated a and b into the contraction's scratch
// and the out gate; gate * (sum + bop) out), shared by trimul_mma.cu (the
// block up to D = 128) and trimul_wide_mma.cu (the wide block past it).
// Layouts as trimul_mma.cu states them; D a multiple of 8.
#pragma once

#include "ln_project.cuh"

namespace {

struct TmArgs {
  const void* pair;
  const float* mask;
  const void* w_in;
  const float* b_in;
  const void* wop_t;
  const float* bop;
  void* a_t;
  void* b_t;
  float* gate;
  float* prod;
  void* out;
  int B, N, D;
};

// The block's loader: 64 positions of the contiguous pair [positions, D].
template <typename T>
struct PairRows {
  const T* x;
  int D;

  __device__ __forceinline__ void operator()(float* raw, int ld, long long p0, int rows, int d0,
                                             int dn) const {
    // D % 8 == 0 (and d0, dn with it): 16-byte rows where x is 16-byte aligned
    const bool vec = (reinterpret_cast<unsigned long long>(x) & 15u) == 0;
    lnp_load_rows<T>(raw, ld, dn, rows, vec, [&](int p) { return x + (p0 + p) * D + d0; });
  }
};

// The block's epilogue of the projection. a and b (the gate's 8 columns and
// the projection's 8 of the same channels, in turn) into [B, D, N, NP]: a
// thread a position, so that a warp's stores run along y; the out gate into
// [positions, D]: a thread 8 columns of a position, 32-byte stores along rows.
template <typename T>
struct GatedPair {
  const float* b_in;
  const float* mask;
  T* a_t;
  T* b_t;
  float* gate;
  int N, NP, D;

  __device__ __forceinline__ void operator()(const float* tile, long long p0, int rows,
                                             int c0) const {
    constexpr int kGroups = kLnpThreads / kLnpRows;  // threads a position
    const int p = threadIdx.x % kLnpRows;
    if (c0 < 4 * D && p < rows) {
      const long long pos = p0 + p;
      // pos = (bb, x, y) of the [B, N, N] pair grid; B N < 2^32 within trimul_fits
      const long long bx = pos / N;
      const int y = (int)(pos - bx * N);
      const unsigned bb = (unsigned)bx / (unsigned)N;
      const int x = (int)((unsigned)bx - bb * (unsigned)N);
      const float m = mask[pos];
      for (int j = threadIdx.x / kLnpRows; j < kLnpCols / 16; j += kGroups) {
        const int col = c0 + 16 * j;  // gate columns [col, col + 8), projection [col + 8, col + 16)
        if (col >= 4 * D) break;
        float bias[16], v[16];  // the loads before any store
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          bias[e] = b_in[col + e];
          v[e] = tile[p * kLnpLdT + 16 * j + e];
        }
        const int ch = (col >> 4) * 8;  // of the 2D a | b channels
        T* dst = ch < D ? a_t : b_t;
        const int c = ch < D ? ch : ch - D;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          T* row = dst + (((long long)bb * D + c + e) * N + x) * NP;
          row[y] = Io<T>::cast(sigmoid_f(v[e] + bias[e]) * (v[8 + e] + bias[8 + e]) * m);
          if (y == N - 1)
            for (int yy = N; yy < NP; ++yy) row[yy] = Io<T>::cast(0.f);
        }
      }
    }
    if (c0 + kLnpCols <= 4 * D) return;
    for (int i = threadIdx.x; i < kLnpRows * (kLnpCols / 8); i += kLnpThreads) {
      const int col = c0 + (i & 7) * 8;
      if ((i >> 3) >= rows || col < 4 * D || col >= 5 * D) continue;  // D % 8 == 0: whole chunks
      float o[8];
      load8(tile + (i >> 3) * kLnpLdT + (i & 7) * 8, o);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = sigmoid_f(o[e] + b_in[col + e]);
      store8(gate + (p0 + (i >> 3)) * D + col - 4 * D, o);
    }
  }
};

// The block's loader for the out kernel: 64 positions of the channel-major
// f32 product [B, D, N, N], read along the positions.
struct ProductRows {
  const float* prod;
  int N, D;

  // A thread a position (one 64-bit division), its group of threads along
  // d, 16 loads in flight before their stores.
  __device__ __forceinline__ void operator()(float* raw, int ld, long long p0, int rows, int d0,
                                             int dn) const {
    constexpr int kStep = kLnpThreads / kLnpRows, kBatch = 16;
    const long long nn = (long long)N * N;
    const int p = threadIdx.x % kLnpRows;
    const long long pos = p0 + p;
    const long long bb = pos / nn;
    const float* src = prod + (bb * D + d0) * nn + (pos - bb * nn);
    for (int e0 = threadIdx.x / kLnpRows; e0 < dn; e0 += kStep * kBatch) {
      float v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        v[i] = p < rows && e0 + kStep * i < dn ? src[(e0 + kStep * i) * nn] : 0.f;
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (e0 + kStep * i < dn) raw[p * ld + e0 + kStep * i] = v[i];
    }
  }
};

// The block's epilogue of the out kernel: out = gate * (acc + bop) in T, a
// thread 8 columns of a position, 16- or 32-byte stores along rows.
template <typename T>
struct GatedOut {
  const float* gate;
  const float* bop;
  T* out;
  int D;

  __device__ __forceinline__ void operator()(const float* tile, long long p0, int rows,
                                             int c0) const {
    constexpr int kItems = kLnpRows * (kLnpCols / 8) / kLnpThreads;
    float v[kItems][8], g[kItems][8];  // the loads before any store
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x + kLnpThreads * k;
      const int p = i >> 3, col = c0 + (i & 7) * 8;
      const bool ok = p < rows && col < D;  // D % 8 == 0: the whole chunk
#pragma unroll
      for (int e = 0; e < 8; ++e) g[k][e] = 0.f;
      if (ok) load8(gate + (p0 + p) * D + col, g[k]);
      load8(tile + p * kLnpLdT + (i & 7) * 8, v[k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[k][e] += ok ? bop[col + e] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x + kLnpThreads * k;
      const int p = i >> 3, col = c0 + (i & 7) * 8;
      if (p >= rows || col >= D) continue;
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = g[k][e] * v[k][e];
      store8(out + (p0 + p) * D + col, o);
    }
  }
};

}  // namespace
