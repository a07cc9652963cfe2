// The f32 tensor-core building blocks that the 3xTF32 attention kernels
// share (attention_tf32.cu: K3 and K5; attention_bwd_tf32.cu: K6 and K7):
// the staging of f32 tiles, the two products of a flash pass with every
// product in 3xTF32 (S = A B^T and O += P X, 16 rows a warp), the output
// store and the entry points' stride check. Included by .cu files only;
// everything is file-local.
//
// There is no ldmatrix for 32-bit elements, so fragments are read from
// shared memory element by element; rows are CP + 4 floats long (CP = 8 NT
// channels), which makes every fragment read conflict-free (CP + 4 = 4 mod
// 8). O += P X takes P from the S accumulators as they lie: the accumulator
// of an 8-column n-tile holds columns 2t and 2t + 1 in lane t of each quad,
// where the m16n8k8 A fragment wants columns t and t + 4. A product sums
// over its depth in any order, so P X numbers the columns of each n-tile so
// that its k slot t is column 2t and slot t + 4 column 2t + 1; the B
// fragment reads X's rows in the same order (rows 2t and 2t + 1, also
// conflict-free at this row length). No shuffle and no round trip through
// shared memory. Each product goes through mma_3xtf32 (mma.cuh) into a
// fresh fragment, added to its sum in f32.
#pragma once

#include "attention_mma.cuh"

namespace {

// Rows [r0, r0 + rows) of one head of a [R, N, H, C] f32 operand into shared
// memory by cp.async, row stride ld, CP channels; rows past N and channels
// past C are zero-filled.
__device__ __forceinline__ void stage_f32(const float* base, long long stride_n, int r0, int rows,
                                          int N, int C, int CP, int ld, float* dst) {
  const int chunks = CP / 4;
  for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
    const int j = e / chunks;
    const int c = (e - j * chunks) * 4;
    const bool ok = r0 + j < N && c < C;
    cp_async16(dst + j * ld + c, ok ? base + (long long)(r0 + j) * stride_n + c : base, ok);
  }
}

// The same rows loaded directly and multiplied by scale in f32 (the
// pre-scaled q).
__device__ __forceinline__ void stage_q_f32(const float* base, long long stride_n, int r0, int rows,
                                            int N, int C, int CP, int ld, float scale,
                                            float* dst) {
  const int chunks = CP / 4;
  for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
    const int i = e / chunks;
    const int c = (e - i * chunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + i < N && c < C) {
      x = *reinterpret_cast<const float4*>(base + (long long)(r0 + i) * stride_n + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + i * ld + c) = x;
  }
}

// A tile that stage_f32 put in shared memory, multiplied by scale in place
// by the same threads that copied each 16 bytes: call it after this thread's
// cp_async_wait and before the block's barrier.
__device__ __forceinline__ void scale_staged_f32(float* tile, int r0, int rows, int N, int C,
                                                 int CP, int ld, float scale) {
  const int chunks = CP / 4;
  for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
    const int j = e / chunks;
    const int c = (e - j * chunks) * 4;
    if (r0 + j >= N || c >= C) continue;
    float4* x = reinterpret_cast<float4*>(tile + j * ld + c);
    float4 y = *x;
    y.x *= scale;
    y.y *= scale;
    y.z *= scale;
    y.w *= scale;
    *x = y;
  }
}

// S = A B^T for the warp's 16 rows of A (a_w, row stride ld) against the
// 8 NS rows of a staged tile B (b_t, row stride ld), over CP channels.
template <int NS, int CP>
__device__ __forceinline__ void logits_tf32(const float* a_w, const float* b_t, int ld, int lane,
                                            float (&s)[NS][4]) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < CP; kc += 8) {
    unsigned ab[4], as[4];
    split_tf32(a_w[g * ld + kc + t4], ab[0], as[0]);
    split_tf32(a_w[(g + 8) * ld + kc + t4], ab[1], as[1]);
    split_tf32(a_w[g * ld + kc + t4 + 4], ab[2], as[2]);
    split_tf32(a_w[(g + 8) * ld + kc + t4 + 4], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float* b_row = b_t + (n * 8 + g) * ld + kc + t4;
      unsigned bb0, bs0, bb1, bs1;
      split_tf32(b_row[0], bb0, bs0);
      split_tf32(b_row[4], bb1, bs1);
      mma_3xtf32(s[n], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// acc += P X for the warp's 16 rows: P in the accumulators of NS 8-column
// n-tiles (k slot t of n-tile kk is row kk 8 + 2t of X, slot t + 4 row kk 8
// + 2t + 1), X a staged tile (row stride ld) of NT 8-channel n-tiles.
template <int NS, int NT>
__device__ __forceinline__ void pv_tf32(const float (&p)[NS][4], const float* x_t, int ld,
                                        int lane, float (&acc)[NT][4]) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {
    unsigned ab[4], as[4];
    split_tf32(p[kk][0], ab[0], as[0]);
    split_tf32(p[kk][2], ab[1], as[1]);
    split_tf32(p[kk][1], ab[2], as[2]);
    split_tf32(p[kk][3], ab[3], as[3]);
    const float* x_row = x_t + (kk * 8 + 2 * t4) * ld + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      unsigned bb0, bs0, bb1, bs1;
      split_tf32(x_row[n * 8], bb0, bs0);
      split_tf32(x_row[ld + n * 8], bb1, bs1);
      mma_3xtf32(acc[n], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// The warp's output rows (g and g + 8 of its 16) of a contiguous [R, N, H, C]
// f32 tensor from the accumulators, each divided by its row's divisor.
template <int NT>
__device__ __forceinline__ void store_tile_f32(float* out, int N, int H, int C, const Block& b,
                                               int row_a, const float (&acc)[NT][4], float div_a,
                                               float div_b, int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t4;
    if (c >= C) continue;
    if (row_a < N)
      *reinterpret_cast<float2*>(out + (((long long)b.r * N + row_a) * H + b.h) * C + c) =
          make_float2(acc[n][0] / div_a, acc[n][1] / div_a);
    if (row_a + 8 < N)
      *reinterpret_cast<float2*>(out + (((long long)b.r * N + row_a + 8) * H + b.h) * C + c) =
          make_float2(acc[n][2] / div_b, acc[n][3] / div_b);
  }
}

// Every row of an f32 operand on 16 bytes (cp.async, float4 loads).
bool strides4(const Strides& s) { return s.r % 4 == 0 && s.n % 4 == 0 && s.h % 4 == 0; }

}  // namespace
