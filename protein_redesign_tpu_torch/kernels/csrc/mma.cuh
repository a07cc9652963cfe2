// Tensor-core building blocks for the sm_90a kernels (attention_mma.cu,
// attention_bwd_mma.cu, attention_tf32.cu, fused_gated_mma.cu,
// trimul_mma.cu, transition_mma.cu and ln_project.cuh): cp.async staging, ldmatrix
// fragment loads, mma.sync m16n8k16 with bf16 operands and f32 accumulators,
// and mma.sync m16n8k8 in 3xTF32 for f32 operands, in inline PTX.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, for lane
// l of a warp with g = l / 4 and t = l % 4 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"):
//   A (16 x 16, row-major), 4 registers of two bf16 each:
//     a0 = A[g][2t..2t+1]   a1 = A[g+8][2t..2t+1]
//     a2 = A[g][2t+8..]     a3 = A[g+8][2t+8..]
//   B (16 x 8, k x n), 2 registers: b0 = B[2t..2t+1][g], b1 = B[2t+8..][g]
//   C, D (16 x 8, f32), 4 registers: c0, c1 = C[g][2t], C[g][2t+1];
//     c2, c3 = C[g+8][2t], C[g+8][2t+1]
// So the D fragments of two neighbouring n-tiles of a product S = Q K^T are,
// packed to bf16 pairs, the A fragment of P for the product P V over those
// 16 keys (flash attention's register reuse).
//
// ldmatrix.x4 loads four 8 x 8 b16 matrices from shared memory, lane l giving
// the address of row l % 8 of matrix l / 8 (16 bytes each, 16-byte aligned);
// lane l receives row g, elements 2t and 2t + 1 of each matrix, or with .trans
// the transposed element pair (rows 2t and 2t + 1 of column g).
#pragma once

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory into shared memory without passing through
// registers; with ok false nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// 8 bytes the same way (cp.async.ca: the .cg form moves 16 bytes only), for
// bf16 heads of width C = 4 mod 8, whose rows start on 8 bytes.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most PENDING of this thread's committed groups are in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// d += A B on the tensor cores: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                               unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 and packed, lo in the low half (the lower column).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The A fragment of rows [0, 16) and columns [k0, k0 + 16) of a row-major
// bf16 tile in shared memory with row stride ld (elements).
__device__ __forceinline__ void load_a_frag(unsigned (&a)[4], const __nv_bfloat16* tile, int ld,
                                            int k0, int lane) {
  ldmatrix_x4(a, tile + (lane & 15) * ld + k0 + (lane >> 4) * 8);
}

// The A fragment of rows [m0, m0 + 16) and columns [k0, k0 + 16) of A stored
// transposed, as a row-major bf16 tile [k][m] with row stride ld (ldmatrix
// .trans: lane l addresses row k0 + l % 8 + 8 (l / 16) at column m0 + 8 ((l /
// 8) % 2), so that matrices 0..3 are a0..a3).
__device__ __forceinline__ void load_a_frag_trans(unsigned (&a)[4], const __nv_bfloat16* tile,
                                                  int ld, int k0, int m0, int lane) {
  ldmatrix_x4_trans(a, tile + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * ld + m0 +
                           ((lane >> 3) & 1) * 8);
}

// B fragments of S = A X^T for two n-tiles: X rows [n0, n0 + 16) (keys) and
// columns [k0, k0 + 16) of a row-major bf16 tile with row stride ld. b[0], b[1]
// serve n-tile n0, b[2], b[3] n-tile n0 + 8.
__device__ __forceinline__ void load_bt_frags(unsigned (&b)[4], const __nv_bfloat16* tile, int ld,
                                              int n0, int k0, int lane) {
  ldmatrix_x4(b, tile + (n0 + ((lane >> 4) << 3) + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// The B fragment of S = A X^T for one n-tile: X rows [n0, n0 + 8) and
// columns [k0, k0 + 16) (ldmatrix.x2: lanes 0-15 give the addresses).
__device__ __forceinline__ void load_bt_frag(unsigned (&b)[2], const __nv_bfloat16* tile, int ld,
                                             int n0, int k0, int lane) {
  ldmatrix_x2(b, tile + (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8);
}

// B fragments of O = P X for two n-tiles: X rows [k0, k0 + 16) (keys) and
// columns [n0, n0 + 16) of a row-major bf16 tile with row stride ld. b[0], b[1]
// serve columns n0..n0 + 7, b[2], b[3] columns n0 + 8..n0 + 15.
__device__ __forceinline__ void load_b_frags(unsigned (&b)[4], const __nv_bfloat16* tile, int ld,
                                             int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 + (lane >> 4) * 8);
}

// f32 products on the tensor cores in 3xTF32 (attention_tf32.cu). Fragments
// of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 for lane l, g = l / 4,
// t = l % 4 (PTX ISA, "Matrix Fragments for mma.m16n8k8"), one 32-bit element
// a register, no ldmatrix for them:
//   A (16 x 8): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8 x 8, k x n): b0 = B[t][g], b1 = B[t+4][g]
//   C, D (16 x 8, f32): as for m16n8k16.
// An f32 x splits into x = big + small with big = tf32(x) and small =
// tf32(x - big) (round to nearest, ties away), x - big exact in f32; the
// product a b is taken as a_small b_big + a_big b_small + a_big b_big with
// f32 sums, small terms first, dropping a_small b_small: within about 2^-21
// of |a b|, where one TF32 product of the rounded operands misses by 2^-10.

__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += A B on the tensor cores: tf32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                              unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A B in 3xTF32, A and B given split (big, small). The three products
// go into a fresh fragment, which is then added to d in f32 (round to
// nearest): the tensor cores' own f32 sums truncate, so a long sum kept in
// one fragment (a P.V accumulator over a thousand keys) would drift toward
// zero by an ulp a step.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const unsigned (&a_big)[4],
                                           const unsigned (&a_small)[4], unsigned b_big0,
                                           unsigned b_big1, unsigned b_small0,
                                           unsigned b_small1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32_1688(t, a_small, b_big0, b_big1);
  mma_tf32_1688(t, a_big, b_small0, b_small1);
  mma_tf32_1688(t, a_big, b_big0, b_big1);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

}  // namespace
