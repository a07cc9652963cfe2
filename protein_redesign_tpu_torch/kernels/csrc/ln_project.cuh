// LayerNorm + projection on the tensor cores: the block that the fused
// kernels' LN -> Linear stages share (fused_gated_mma.cu and
// fused_gated_wide.cu: K8's q, k, v and gate projection; trimul_mma.cu and
// trimul_wide_mma.cu: K9's gated a, b and out-gate projection and its
// out-projection of the normed product). transition_mma.cu (K10) takes its
// operand traits (LnpOperand) and unpack16; fused_gated_wide.cu's gate +
// out-projection takes its weight staging and product (lnw_stage_w,
// lnp_product).
//
// One block of kLnpThreads threads (4 warps) takes kLnpRows = 64 positions:
//   0. the first two 64-column slices of the weight W [D, Wc] (T, row-major)
//      start streaming into shared memory by cp.async at once: W does not
//      depend on the input, so its copies overlap steps 1 and 2;
//   1. the kernel's loader functor stages the 64 input rows as f32 into
//      shared memory ([64][D + 1], zero past the last position), reading the
//      input in whatever layout is coalesced for it (lnp_load_rows for rows
//      contiguous along d, 16-byte loads where they are aligned; the kernel's
//      own for a channel-major product);
//   2. a warp a row, four rows at once, takes LayerNorm (no affine, eps
//      1e-5, f32 statistics, the fused kernels' _ln), rounds x^ to the
//      operand type T and writes it into the A tile [64][DP + pad], zero past
//      D (DP: D rounded up to the MMA's depth, 16 in bf16 and 8 in f32), so
//      that D need not be a multiple of it;
//   3. for each slice, double-buffered: each warp multiplies its 16 rows of
//      the A tile by the slice on the tensor cores (bf16: mma.sync m16n8k16
//      from ldmatrix fragments; f32: 3xTF32 m16n8k8, a fresh fragment per
//      product, as mma.cuh's mma_3xtf32) and puts its [16, 64] f32 sums into
//      the block's output tile [64][kLnpLdT] in shared memory (the raw rows'
//      space), which the kernel's epilogue functor then reads in whatever
//      order makes its stores coalesced (16-byte pieces of a row, or runs
//      along the positions of a channel-major output).
// LN is computed once per position, whatever the output width. Stores
// straight from the MMA accumulators would scatter each warp store over 8
// rows, 16 bytes each; the tile lets every epilogue write whole rows (or
// runs of positions), as the loaders read them.
//
// That block (ln_project) takes D up to kLnpMaxD = 128: past it the raw f32
// rows, the A tile and two whole-D weight slices outgrow shared memory
// (about 131 + 66 + 147 KB at D = 512 in bf16). The wide block
// (ln_project_wide, D up to kLnwMaxD = 512, the JAX kernels' reach) keeps
// only the A tile resident:
//   - LayerNorm in two passes over the rows, kLnwChunk = 64 columns at a
//     time through a raw f32 chunk [64][65] (the loader reads columns [d0,
//     d0 + dn) of the rows): the first takes each row's mean and M2 chunk by
//     chunk (the chunk's own mean and sum of squares about it, merged by
//     Chan's update, so no sum of squares cancels) into shared memory past
//     the chunk, the second reads the rows again (mostly from L2),
//     normalises and writes x^ in T into the A tile;
//   - W streams in K slices of kLnwK rows (128 bytes of a column: 64 rows in
//     bf16, 32 in f32) x 64 columns through a ring of kLnwBufs = 3 buffers by
//     cp.async, two K slices ahead, one barrier a K slice; each 64-column
//     slice of the output sums its K slices in order in the warps'
//     accumulators, then goes through the output tile to the epilogue as in
//     the narrow block. Shared memory lnw_smem_bytes: 111,616 bytes at D =
//     512 in bf16 (two blocks a SM), 177,152 in f32 (one).
//
// Loader: void operator()(float* raw, int ld, long long p0, int rows, int d0,
// int dn) const, fills raw[p * ld + d] for p < 64, d < dn with column d0 + d
// of position p0 + p (zeros for p >= rows); the narrow block asks for (0, D),
// the wide one for chunks of 64 (d0 a multiple of 64).
// Epilogue: void operator()(const float* tile, long long p0, int rows, int c0)
// const: tile[p * kLnpLdT + c] is the product at position p0 + p and column
// c0 + c (c < 64); positions at or past p0 + rows and columns at or past Wc
// are padding. Loaders and epilogues issue their global loads before their
// stores (a load after a store to memory that may alias waits for it).
//
// Requirements: D <= kLnpMaxD (ln_project) or kLnwMaxD (ln_project_wide); Wc
// a multiple of 8 (bf16) or 4 (f32), so a 16-byte copy of a weight row never
// straddles its end; w 16-byte aligned.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kLnpThreads = 128;
// Blocks a SM that the kernels built on the block keep resident, which caps
// their registers at 128: the block's phases are latency-bound, and its
// shared memory (45 KB at D = 64 in bf16) fits five.
constexpr int kLnpMinBlocks = 4;
constexpr int kLnpRows = 64;
constexpr int kLnpCols = 64;
constexpr int kLnpMaxD = 128;
constexpr int kLnwMaxD = 512;
constexpr int kLnwChunk = 64;  // LN columns of the wide block's raw chunk
constexpr int kLnwBufs = 3;    // the wide block's ring of weight K slices
constexpr int kLnpLdW = kLnpCols + 8;  // weight slice row stride (bf16 and f32: conflict-free)
constexpr int kLnpLdT = kLnpCols + 4;  // output tile row stride (f32, 16-byte rows)

// The operand type's MMA depth and the A tile's row padding: bf16 rows of
// DP + 8 (an odd number of 16-byte units: conflict-free ldmatrix); f32 rows
// of DP + 4 (= 4 mod 8: conflict-free fragment reads).
template <typename T>
struct LnpOperand;
template <>
struct LnpOperand<__nv_bfloat16> {
  static constexpr int kDepth = 16, kPad = 8, kChunk = 8;
};
template <>
struct LnpOperand<float> {
  static constexpr int kDepth = 8, kPad = 4, kChunk = 4;
};

template <typename T>
__host__ __device__ constexpr int lnp_depth_pad(int D) {
  return (D + LnpOperand<T>::kDepth - 1) / LnpOperand<T>::kDepth * LnpOperand<T>::kDepth;
}

// Shared memory of one block: the A tile, two weight slices, and the raw f32
// rows (before the slices) or the output tile (during them).
template <typename T>
__host__ __device__ constexpr size_t lnp_smem_bytes(int D) {
  const int DP = lnp_depth_pad<T>(D);
  const size_t a = sizeof(T) * (size_t)kLnpRows * (DP + LnpOperand<T>::kPad);
  const size_t w = sizeof(T) * 2 * (size_t)DP * kLnpLdW;
  const size_t raw = sizeof(float) * (size_t)kLnpRows * (D + 1);
  const size_t tile = sizeof(float) * (size_t)kLnpRows * kLnpLdT;
  return a + w + (raw > tile ? raw : tile);
}

// 16 bytes of T as f32.
__device__ __forceinline__ void unpack16(const uint4& v, float (&out)[8]) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(e[j]);
}

__device__ __forceinline__ void unpack16(const uint4& v, float (&out)[4]) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
}

// 8 consecutive f32 values at a 16-byte aligned address, and 8 values of T
// stored at one (16 or 32 bytes).
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 u;
  unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) w[j] = pack_bf16(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// A loader's body for rows contiguous along d: row p (< rows) starts at
// src(p). vec: every row starts on 16 bytes and D is a multiple of a 16-byte
// chunk, so each lane reads 16 bytes at a time over its warp's 16 rows, up
// to four loads a lane in flight; else a warp a row, four rows' element
// loads in flight. Loads before stores in both.
template <typename T, class RowStart>
__device__ __forceinline__ void lnp_load_rows(float* raw, int ld, int D, int rows, bool vec,
                                              const RowStart& src) {
  constexpr int kWarpsL = kLnpThreads / 32, kRowsW = kLnpRows / kWarpsL;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (vec) {
    constexpr int kChunk = 16 / sizeof(T), kBatch = 4;
    const int cpr = D / kChunk;  // chunks a row
    const int items = kRowsW * cpr;
    for (int i0 = lane; i0 < items; i0 += 32 * kBatch) {
      uint4 v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = i0 + 32 * k;
        const int r = i / cpr;
        const int p = warp + kWarpsL * r;
        v[k] = make_uint4(0u, 0u, 0u, 0u);
        if (i < items && p < rows)
          v[k] = *reinterpret_cast<const uint4*>(src(p) + (i - r * cpr) * kChunk);
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int i = i0 + 32 * k;
        if (i >= items) continue;
        const int r = i / cpr;
        float f[kChunk];
        unpack16(v[k], f);
        float* dst = raw + (warp + kWarpsL * r) * ld + (i - r * cpr) * kChunk;
#pragma unroll
        for (int j = 0; j < kChunk; ++j) dst[j] = f[j];
      }
    }
    return;
  }
  constexpr int kBatch = 4, kV = kLnpMaxD / 32;
  for (int p0 = warp; p0 < kLnpRows; p0 += kWarpsL * kBatch) {
    float v[kBatch][kV];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int p = p0 + r * kWarpsL;
      const T* row = p < rows ? src(p) : nullptr;
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int d = lane + 32 * i;
        v[r][i] = row != nullptr && d < D ? Io<T>::load(row + d) : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r)
#pragma unroll
      for (int i = 0; i < kV; ++i)
        if (lane + 32 * i < D) raw[(p0 + r * kWarpsL) * ld + lane + 32 * i] = v[r][i];
  }
}

// Weight columns [c0, c0 + 64) of rows [0, DP) into a slice by cp.async,
// zero past D and past Wc.
template <typename T>
__device__ __forceinline__ void lnp_stage_w(const T* __restrict__ w, int D, int DP, int Wc, int c0,
                                            T* dst) {
  constexpr int kChunk = LnpOperand<T>::kChunk;
  constexpr int kPerRow = kLnpCols / kChunk;
  for (int e = threadIdx.x; e < DP * kPerRow; e += kLnpThreads) {
    const int d = e / kPerRow;
    const int c = (e - d * kPerRow) * kChunk;
    const bool ok = d < D && c0 + c < Wc;
    cp_async16(dst + d * kLnpLdW + c, ok ? w + (long long)d * Wc + c0 + c : w, ok);
  }
}

// acc += (the warp's 16 rows of A) x (the slice) over DP.
__device__ __forceinline__ void lnp_product(const __nv_bfloat16* a_w, int lda,
                                            const __nv_bfloat16* w_s, int DP, int lane,
                                            float (&acc)[8][4]) {
  for (int kc = 0; kc < DP; kc += 16) {
    unsigned a[4];
    load_a_frag(a, a_w, lda, kc, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      load_b_frags(b, w_s, kLnpLdW, kc, np * 16, lane);
      mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// f32: mma.cuh's mma_3xtf32 for each n-tile (its three products into a fresh
// fragment, small terms first, then added to the sum), the three products
// interleaved over the 8 n-tiles, so that none waits on the one before it
// (asm volatile keeps the order as written; one n-tile after the other, each
// product stalled on its predecessor's result). Each n-tile's sums are
// mma_3xtf32's, in its order: the same bits.
__device__ __forceinline__ void lnp_product(const float* a_w, int lda, const float* w_s, int DP,
                                            int lane, float (&acc)[8][4]) {
  const int g = lane >> 2, t4 = lane & 3;
  for (int kc = 0; kc < DP; kc += 8) {
    unsigned ab[4], as[4];
    split_tf32(a_w[g * lda + kc + t4], ab[0], as[0]);
    split_tf32(a_w[(g + 8) * lda + kc + t4], ab[1], as[1]);
    split_tf32(a_w[g * lda + kc + t4 + 4], ab[2], as[2]);
    split_tf32(a_w[(g + 8) * lda + kc + t4 + 4], ab[3], as[3]);
    const float* w0 = w_s + (kc + t4) * kLnpLdW + g;
    unsigned bb[8][2], bs[8][2];
    float t[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      split_tf32(w0[n * 8], bb[n][0], bs[n][0]);
      split_tf32(w0[4 * kLnpLdW + n * 8], bb[n][1], bs[n][1]);
      t[n][0] = t[n][1] = t[n][2] = t[n][3] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) mma_tf32_1688(t[n], as, bb[n][0], bb[n][1]);
#pragma unroll
    for (int n = 0; n < 8; ++n) mma_tf32_1688(t[n], ab, bs[n][0], bs[n][1]);
#pragma unroll
    for (int n = 0; n < 8; ++n) mma_tf32_1688(t[n], ab, bb[n][0], bb[n][1]);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += t[n][i];
  }
}

// The block: positions [p0, p0 + rows), rows <= 64, of width D through
// LN and x^ W (W [D, Wc] in T), each 64-column slice handed to epi.
template <typename T, class Load, class Epi>
__device__ __forceinline__ void ln_project(const Load& load, const T* __restrict__ w, int D,
                                           int Wc, long long p0, int rows, const Epi& epi,
                                           unsigned char* smem) {
  const int DP = lnp_depth_pad<T>(D);
  const int lda = DP + LnpOperand<T>::kPad;
  T* a_s = reinterpret_cast<T*>(smem);  // [64][lda]
  T* w_s = a_s + kLnpRows * lda;        // [2][DP][kLnpLdW] (16-byte aligned: lda, DP even)
  float* raw = reinterpret_cast<float*>(w_s + 2 * DP * kLnpLdW);  // [64][D + 1], then:
  float* tile = raw;                                               // [64][kLnpLdT]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slices = (Wc + kLnpCols - 1) / kLnpCols;
  const int wbuf = DP * kLnpLdW;

  lnp_stage_w(w, D, DP, Wc, 0, w_s);
  cp_async_commit();
  if (slices > 1) lnp_stage_w(w, D, DP, Wc, kLnpCols, w_s + wbuf);
  cp_async_commit();
  load(raw, D + 1, p0, rows, 0, D);
  __syncthreads();
  // LN, a warp a row, four rows at once (their reductions interleave): D <=
  // 128, so four values a lane
  constexpr int kV = kLnpMaxD / 32, kRows = 4, kWarpsL = kLnpThreads / 32;
  for (int q0 = warp; q0 < kLnpRows; q0 += kWarpsL * kRows) {
    float v[kRows][kV], mu[kRows], rstd[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float* row = raw + (q0 + r * kWarpsL) * (D + 1);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int d = lane + 32 * i;
        v[r][i] = d < D ? row[d] : 0.f;
        s += v[r][i];
      }
      mu[r] = s;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) mu[r] = warp_sum(mu[r]) / (float)D;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const float t = lane + 32 * i < D ? v[r][i] - mu[r] : 0.f;
        sq = fmaf(t, t, sq);
      }
      rstd[r] = sq;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) rstd[r] = rsqrtf(warp_sum(rstd[r]) / (float)D + 1e-5f);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      T* dst = a_s + (q0 + r * kWarpsL) * lda;
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int d = lane + 32 * i;
        if (d < DP) dst[d] = Io<T>::cast(d < D ? (v[r][i] - mu[r]) * rstd[r] : 0.f);
      }
    }
  }

  const T* a_w = a_s + warp * 16 * lda;
  const int g = lane >> 2, t4 = lane & 3;
  for (int sl = 0; sl < slices; ++sl) {
    const int buf = sl & 1;
    if (sl > 0) {  // slice sl + 1 into the buffer that slice sl - 1 used
      if (sl + 1 < slices) lnp_stage_w(w, D, DP, Wc, (sl + 1) * kLnpCols, w_s + (buf ^ 1) * wbuf);
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();  // the slice (the first time, the A tile too) is in; the tile is free
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    lnp_product(a_w, lda, w_s + buf * wbuf, DP, lane, acc);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(tile + (warp * 16 + g + 8 * half) * kLnpLdT + n * 8 + 2 * t4) =
            make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    __syncthreads();  // the tile is whole; every warp is done with this slice's buffer
    epi(tile, p0, rows, sl * kLnpCols);
  }
}

// Weight rows of the wide block's K slices: 128 bytes of a column (64 in
// bf16, 32 in f32; a multiple of either MMA's depth).
template <typename T>
constexpr int kLnwK = 128 / (int)sizeof(T);

// Shared memory of one wide block: the A tile, the ring of weight K slices,
// and the raw f32 chunk (during LN) or the output tile (during the slices).
template <typename T>
__host__ __device__ constexpr size_t lnw_smem_bytes(int D) {
  const int DP = lnp_depth_pad<T>(D);
  const size_t a = sizeof(T) * (size_t)kLnpRows * (DP + LnpOperand<T>::kPad);
  const size_t w = sizeof(T) * (size_t)kLnwBufs * kLnwK<T> * kLnpLdW;
  const size_t raw = sizeof(float) * (size_t)kLnpRows * (kLnwChunk + 1);
  const size_t tile = sizeof(float) * (size_t)kLnpRows * kLnpLdT;
  return a + w + (raw > tile ? raw : tile);
}

// Weight rows [k0, k0 + kLnwK) and columns [c0, c0 + 64) of W [D, Wc] into a
// K slice [kLnwK][kLnpLdW] by cp.async, zero past D and past Wc.
template <typename T>
__device__ __forceinline__ void lnw_stage_w(const T* __restrict__ w, int D, int Wc, int k0, int c0,
                                            T* dst) {
  constexpr int kChunk = LnpOperand<T>::kChunk;
  constexpr int kPerRow = kLnpCols / kChunk;
  for (int e = threadIdx.x; e < kLnwK<T> * kPerRow; e += kLnpThreads) {
    const int d = e / kPerRow;
    const int c = (e - d * kPerRow) * kChunk;
    const bool ok = k0 + d < D && c0 + c < Wc;
    cp_async16(dst + d * kLnpLdW + c, ok ? w + (long long)(k0 + d) * Wc + c0 + c : w, ok);
  }
}

// The wide block: positions [p0, p0 + rows), rows <= 64, of width D (128 <
// D <= kLnwMaxD) through LN and x^ W (W [D, Wc] in T), each 64-column slice
// handed to epi.
template <typename T, class Load, class Epi>
__device__ __forceinline__ void ln_project_wide(const Load& load, const T* __restrict__ w, int D,
                                                int Wc, long long p0, int rows, const Epi& epi,
                                                unsigned char* smem) {
  constexpr int KS = kLnwK<T>, kWarpsL = kLnpThreads / 32, kRowsW = kLnpRows / kWarpsL;
  constexpr int ldr = kLnwChunk + 1, wbuf = KS * kLnpLdW;
  const int DP = lnp_depth_pad<T>(D);
  const int lda = DP + LnpOperand<T>::kPad;
  T* a_s = reinterpret_cast<T*>(smem);  // [64][lda]
  T* w_s = a_s + kLnpRows * lda;        // [kLnwBufs][KS][kLnpLdW] (16-byte aligned)
  float* raw = reinterpret_cast<float*>(w_s + kLnwBufs * wbuf);  // [64][ldr], then:
  float* tile = raw;                                               // [64][kLnpLdT]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ks = (DP + KS - 1) / KS;  // K slices a 64-column slice
  const int total = (Wc + kLnpCols - 1) / kLnpCols * ks;
  // K slice t (column slice t / ks, rows (t % ks) KS) into ring buffer t % 3;
  // a group committed whether or not there is one, so that the waits count
  auto stage = [&](int t) {
    if (t < total)
      lnw_stage_w(w, D, Wc, (t % ks) * KS, (t / ks) * kLnpCols, w_s + (t % kLnwBufs) * wbuf);
    cp_async_commit();
  };
  stage(0);
  stage(1);

  // LN, first pass: each row's mean and M2 (a warp a row: rows warp + 4 r),
  // kept in stats [64][2] past the raw chunk (the output tile's region holds
  // both), so that no register holds them across the passes
  float* stats = raw + kLnpRows * ldr;
  static_assert(kLnpRows * ldr + 2 * kLnpRows <= kLnpRows * kLnpLdT, "stats past the raw chunk");
  for (int d0 = 0; d0 < D; d0 += kLnwChunk) {
    const int dn = min(kLnwChunk, D - d0);
    __syncthreads();  // the previous chunk's reads (and its stats) are done
    load(raw, ldr, p0, rows, d0, dn);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kRowsW; ++r) {
      const int q0 = warp + kWarpsL * r;
      const float* row = raw + q0 * ldr;
      const float v0 = lane < dn ? row[lane] : 0.f;
      const float v1 = lane + 32 < dn ? row[lane + 32] : 0.f;
      const float mc = warp_sum(v0 + v1) / (float)dn;
      const float t0 = lane < dn ? v0 - mc : 0.f;
      const float t1 = lane + 32 < dn ? v1 - mc : 0.f;
      float q = warp_sum(fmaf(t0, t0, t1 * t1)), mean = mc;
      if (d0 > 0) {  // Chan: merge (d0, mean, M2) with (dn, mc, q)
        const float n = (float)(d0 + dn), delta = mc - stats[2 * q0];
        mean = fmaf(delta, (float)dn / n, stats[2 * q0]);
        q = stats[2 * q0 + 1] + fmaf(delta * delta, (float)d0 * ((float)dn / n), q);
      }
      __syncwarp();  // every lane has read the row's stats before any writes them
      stats[2 * q0] = mean;  // every lane writes the same values
      stats[2 * q0 + 1] = q;
    }
  }
  // second pass: x^ rounded to T into the A tile
  for (int d0 = 0; d0 < D; d0 += kLnwChunk) {
    const int dn = min(kLnwChunk, D - d0);
    __syncthreads();
    load(raw, ldr, p0, rows, d0, dn);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kRowsW; ++r) {
      const int q0 = warp + kWarpsL * r;
      const float* row = raw + q0 * ldr;
      const float mean = stats[2 * q0], rstd = rsqrtf(stats[2 * q0 + 1] / (float)D + 1e-5f);
      T* dst = a_s + q0 * lda + d0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int d = lane + 32 * i;
        if (d < dn) dst[d] = Io<T>::cast((row[d] - mean) * rstd);
      }
    }
  }
  for (int e = threadIdx.x; e < kLnpRows * (DP - D); e += kLnpThreads) {  // zero past D
    const int p = e / (DP - D);
    a_s[p * lda + D + (e - p * (DP - D))] = Io<T>::cast(0.f);
  }

  const T* a_w = a_s + warp * 16 * lda;
  const int g = lane >> 2, t4 = lane & 3;
  for (int sl = 0, t = 0; sl < total / ks; ++sl) {
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int kt = 0; kt < ks; ++kt, ++t) {
      cp_async_wait<1>();
      __syncthreads();  // K slice t is in (the first time, the A tile too); every warp is done
                        // with K slice t - 1, whose buffer K slice t + 2 takes
      stage(t + 2);
      lnp_product(a_w + kt * KS, lda, w_s + (t % kLnwBufs) * wbuf, min(KS, DP - kt * KS), lane,
                  acc);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<float2*>(tile + (warp * 16 + g + 8 * half) * kLnpLdT + n * 8 + 2 * t4) =
            make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    __syncthreads();  // the tile is whole (the next slice writes it after a barrier)
    epi(tile, p0, rows, sl * kLnpCols);
  }
}

}  // namespace
