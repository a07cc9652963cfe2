// The f32 tensor-core building blocks that the 3xTF32 attention kernels
// share (attention_tf32.cu: K1, K3 and K5; attention_tiled_tf32.cu: K2;
// attention_bwd_tf32.cu: K6 and K7): the staging of f32 tiles and of a bias
// tile, the two products of a flash pass with every product in 3xTF32 (S =
// A B^T and O += P X, 16 rows a warp), the output store, the entry points'
// stride check, and the one-pass forward body (rows_tf32x3_body) that K1,
// K3, K5 and K2 at narrow heads run. Included by .cu files only; everything
// is file-local.
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
// shared memory. The renumbering is P X's alone: S's accumulator s[n][e]
// holds the column (key) n 8 + 2t + (e & 1) of row g + 8 (e >> 1), which is
// where a bias and a mask are applied. Each product goes through mma_3xtf32
// (mma.cuh) into a fresh fragment, added to its sum in f32.
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

// 4 bytes from device memory into shared memory (cp.async.ca: the 16-byte
// form needs 16-byte aligned rows); with ok false the 4 bytes are zeroed.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// Rows [q0, q0 + rows) and columns [k0, k0 + cols) of one head's [N, N] f32
// bias into shared memory by cp.async, row stride ld (cols a multiple of
// 4); entries past N are zero-filled. vec: every bias row starts on 16 bytes
// (N a multiple of 4 and an aligned base), so 16-byte copies, else 4-byte.
__device__ __forceinline__ void stage_bias(const float* head, int N, int q0, int rows, int k0,
                                           int cols, int ld, bool vec, float* dst) {
  if (vec) {
    const int chunks = cols / 4;
    for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
      const int i = e / chunks;
      const int c = (e - i * chunks) * 4;
      const bool ok = q0 + i < N && k0 + c < N;  // N and k0 multiples of 4: all 4 or none
      cp_async16(dst + i * ld + c, ok ? head + (long long)(q0 + i) * N + k0 + c : head, ok);
    }
    return;
  }
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int i = e / cols;
    const int c = e - i * cols;
    const bool ok = q0 + i < N && k0 + c < N;
    cp_async4(dst + i * ld + c, ok ? head + (long long)(q0 + i) * N + k0 + c : head, ok);
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
// 8 NS rows of a staged tile B (b_t, row stride ld), over CP channels;
// ACCUMULATE: S += A B^T (a sum streamed over channel chunks).
template <int NS, int CP, bool ACCUMULATE = false>
__device__ __forceinline__ void logits_tf32(const float* a_w, const float* b_t, int ld, int lane,
                                            float (&s)[NS][4]) {
  const int g = lane >> 2, t4 = lane & 3;
  if (!ACCUMULATE) {
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  }
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

// S += the bias at the keys the accumulators hold: row g (g + 8) of the
// warp's 16 in a staged [rows][ld] bias tile (b_w at the warp's first row),
// column n 8 + 2t + (e & 1), read as float2 (ld = 8 mod 32: conflict-free).
template <int NS>
__device__ __forceinline__ void add_bias(float (&s)[NS][4], const float* b_w, int ld, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const float2 x = *reinterpret_cast<const float2*>(b_w + g * ld + n * 8 + 2 * t4);
    const float2 y = *reinterpret_cast<const float2*>(b_w + (g + 8) * ld + n * 8 + 2 * t4);
    s[n][0] += x.x;
    s[n][1] += x.y;
    s[n][2] += y.x;
    s[n][3] += y.y;
  }
}

// The key tile [k0, k0 + BK) without a mask: every key below N kept, as
// tile_mask's bits (attention_mma.cuh).
template <int BK>
__device__ __forceinline__ TileMask<BK> tile_live(int k0, int N, int lane) {
  TileMask<BK> tm;
  tm.dense = k0 + BK <= N;
  const int shift = 2 * (lane & 3);
#pragma unroll
  for (int w = 0; w < TileMask<BK>::W; ++w) {
    const int j = 32 * w + lane;
    tm.live[w] = __ballot_sync(kFull, j < BK && k0 + j < N) >> shift;
    tm.keep[w] = tm.live[w];
  }
  return tm;
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

// Launch arguments of the f32 forward bodies: K1, K3 and K5 (no bias; K5
// writes m and log s), K2 (bias, mask optional). bias16: every row of the
// bias starts on 16 bytes.
struct F32Args {
  const float* q;
  const float* k;
  const float* v;
  const float* mask;
  const float* bias;
  float* out;
  float* m;
  float* logs;
  int R, N, H, C;
  float scale;
  Strides qs, ks, vs;
  bool bias16;
};

// Keys per tile of the one-pass body: 64, or 32 from CP = 32 on, where the
// accumulators and the split operands take more registers.
template <int NT>
constexpr int kF32Keys = NT <= 2 ? 64 : 32;

// Blocks of WARPS warps that must fit on an SM at once, which caps registers
// at 128 up to CP = 32 (16 warps a SM; the split operands and each product's
// fresh fragment spill at 80) and leaves wider heads at 8 warps a SM.
template <int WARPS, int NT>
constexpr int kF32MinBlocks = (NT <= 4 ? 16 : 8) / WARPS;

// Shared memory of the one-pass body: 16 WARPS queries and two buffers of
// BK keys of K and V, CP + 4 floats a row; with BIAS two [16 WARPS][BK + 8]
// bias tiles.
template <int WARPS, int NT, bool BIAS>
constexpr size_t rows_tf32x3_smem() {
  constexpr int TQ = 16 * WARPS, BK = kF32Keys<NT>;
  return sizeof(float) * ((size_t)(TQ + 4 * BK) * (8 * NT + 4) + (BIAS ? 2 * TQ * (BK + 8) : 0));
}

// One pass of online softmax over every key tile of the block's (row, head)
// (K1, K3, K5 and K2 at C <= 128): a block of 16 WARPS queries staged once,
// pre-scaled, as f32; BK-key tiles of K and V (and with BIAS the [TQ, BK]
// bias tile) staged by cp.async, double-buffered; the tile's mask by ballot
// (HAS_MASK; else only the keys past N drop out); per tile S = Q K^T, plus
// the bias, the -2^15 fill at masked keys (after the bias, as the reference
// does), -inf past N, one step of online softmax in registers, acc += P V;
// out = acc / s. STATS: K5's m and log s, one lane a row.
template <bool STATS, bool BIAS, bool HAS_MASK, int WARPS, int NT>
__device__ __forceinline__ void rows_tf32x3_body(const F32Args& a) {
  constexpr int TQ = 16 * WARPS, BK = kF32Keys<NT>, NS = BK / 8, CP = 8 * NT, LD = CP + 4;
  constexpr int LDB = BK + 8;
  extern __shared__ __align__(16) float smem_f[];
  float* q_s = smem_f;           // [TQ][LD], pre-scaled
  float* k_s = q_s + TQ * LD;    // [2][BK][LD]
  float* v_s = k_s + 2 * BK * LD;  // [2][BK][LD]
  float* b_s = v_s + 2 * BK * LD;  // BIAS: [2][TQ][LDB]
  const int N = a.N, C = a.C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const Block b = block_of<TQ>(N, CP);
  const float* q_base = a.q + b.r * a.qs.r + b.h * a.qs.h;
  const float* k_base = a.k + b.r * a.ks.r + b.h * a.ks.h;
  const float* v_base = a.v + b.r * a.vs.r + b.h * a.vs.h;
  const float* mask_row = HAS_MASK ? a.mask + (long long)b.r * N : nullptr;
  const float* bias_head = BIAS ? a.bias + ((long long)b.r * a.H + b.h) * N * N : nullptr;

  stage_q_f32(q_base, a.qs.n, b.q0, TQ, N, C, CP, LD, a.scale, q_s);
  const int tiles = (N + BK - 1) / BK;
  stage_f32(k_base, a.ks.n, 0, BK, N, C, CP, LD, k_s);
  stage_f32(v_base, a.vs.n, 0, BK, N, C, CP, LD, v_s);
  if (BIAS) stage_bias(bias_head, N, b.q0, TQ, 0, BK, LDB, a.bias16, b_s);
  cp_async_commit();

  const float* q_w = q_s + warp * 16 * LD;
  RowsState<NT> st;
  init_rows(st);
  float nm_a = 0.f, nm_b = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      stage_f32(k_base, a.ks.n, (t + 1) * BK, BK, N, C, CP, LD, k_s + (buf ^ 1) * BK * LD);
      stage_f32(v_base, a.vs.n, (t + 1) * BK, BK, N, C, CP, LD, v_s + (buf ^ 1) * BK * LD);
      if (BIAS)
        stage_bias(bias_head, N, b.q0, TQ, (t + 1) * BK, BK, LDB, a.bias16,
                   b_s + (buf ^ 1) * TQ * LDB);
    }
    cp_async_commit();
    const TileMask<BK> tm =
        HAS_MASK ? tile_mask<BK>(mask_row, t * BK, N, lane) : tile_live<BK>(t * BK, N, lane);
    cp_async_wait<1>();
    __syncthreads();

    float s[NS][4];
    logits_tf32<NS, CP>(q_w, k_s + buf * BK * LD, LD, lane, s);  // S = Q K^T
    if (BIAS) add_bias<NS>(s, b_s + buf * TQ * LDB + warp * 16 * LDB, LDB, lane);
    apply_fill<NS, BK>(s, tm);
    online_step<true, NS, NT>(s, st, nm_a, nm_b);
    exp_rows<true, NS, NT>(s, st, nm_a, nm_b);
    pv_tf32<NS, NT>(s, v_s + buf * BK * LD, LD, lane, st.acc);  // acc += P V
    __syncthreads();  // the next tile's loads overwrite this buffer
  }

  const float s_a = quad_sum(st.s_a), s_b = quad_sum(st.s_b);
  const int row_a = b.q0 + warp * 16 + g;
  store_tile_f32<NT>(a.out, N, a.H, C, b, row_a, st.acc, s_a, s_b, lane);
  if (STATS && t4 == 0) {  // one lane per row
    const long long base = ((long long)b.r * a.H + b.h) * N;
    if (row_a < N) {
      a.m[base + row_a] = st.m_a;
      a.logs[base + row_a] = logf(s_a);
    }
    if (row_a + 8 < N) {
      a.m[base + row_a + 8] = st.m_b;
      a.logs[base + row_a + 8] = logf(s_b);
    }
  }
}

// One launch of a forward kernel over blocks of ``queries`` queries: grid.x
// walks (row, query tile), grid.y the head.
template <typename Kernel>
cudaError_t launch_f32(Kernel kern, int threads, int queries, size_t smem, const F32Args& a,
                       cudaStream_t stream) {
  const long long blocks = (long long)((a.N + queries - 1) / queries) * a.R;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((unsigned)blocks, a.H), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The operands every f32 forward entry point takes: [R, N, H, C] with C a
// multiple of ``multiple`` (8; 4 for K1, K1 fast, K3 and K5, whose tiles are
// staged in 16-byte pieces of 4 channels and zero-filled past C to CP = 8
// NT, or in the wide bodies past each 128-channel chunk's C - c0, so a
// 4 mod 8 tail is padded with exact zeros) and 16-byte aligned rows, H
// within grid.y.
bool f32_operands_ok(const F32Args& a, int multiple = 8) {
  return a.R > 0 && a.N > 0 && a.H > 0 && a.H <= 65535 && a.C > 0 && a.C % multiple == 0 &&
         strides4(a.qs) && strides4(a.ks) && strides4(a.vs) && aligned16(a.q) &&
         aligned16(a.k) && aligned16(a.v);
}

// The wide body (C > 128, a multiple of 8 up to 1024; K1, K3 and K5 a
// multiple of 4, the last chunk zero-padded by stage_f32): one pass of online
// softmax in which each (query tile, key tile) logit is computed once,
// streaming the Q K^T contraction over C in 128-channel chunks as a GEMM's
// K loop (attention_tiled_tf32.cu's header describes it in full). K2 runs it
// with its bias; K3 and K5 without (attention_tf32.cu), K5 also writing m
// and log s. A block of 16 RB queries (RB = 2 row blocks; K3 and K5 take 4
// up to C = 512, which halves the K and V tiles read from L2 per query)
// and 8 warps; warp w owns output n-tiles 2w and 2w + 1 of every
// 128-channel chunk, all 16 RB rows, in registers across the key tiles
// (NC 8 RB floats a thread); S, the bias and P's two TF32 parts go through
// shared memory, where a row pass (128 / RB threads a row) takes the
// softmax step.
constexpr int kWideWarps = 8;
constexpr int kWideTQ = 32;                 // K2's queries a block: two row blocks of 16
constexpr int kWideBK = 64;                 // keys a tile
constexpr int kWideKC = 128;                // channels a chunk: two n-tiles a warp
constexpr int kWideLdQK = kWideKC + 4;      // Q and K rows (4 mod 32: conflict-free A, B^T reads)
constexpr int kWideLdV = kWideKC + 8;       // V rows (8 mod 32: conflict-free B reads)
constexpr int kWideLdS = kWideBK + 4;       // bias, logits and P rows

// Floats of a stage buffer: TQ queries and 64 keys of a chunk (>= 64 V rows).
__host__ __device__ constexpr int wide_stage(int TQ) { return (TQ + kWideBK) * kWideLdQK; }

// Row blocks of 16 queries a block of the wide bodies without the bias (K1,
// K1 fast, K3, K5) over NC chunks: 4 up to NC = 4 (C <= 512), where the
// output's accumulators are 32 NC floats a thread, 2 above; 64 queries a
// block halve the K and V tiles read from L2 per query against 32.
template <int NC>
constexpr int kWideRB = NC <= 4 ? 4 : 2;

template <bool BIAS, int RB = 2>
constexpr size_t wide_tf32x3_smem() {
  constexpr int TQ = 16 * RB;
  return sizeof(float) *
         (2 * (size_t)wide_stage(TQ) + (BIAS ? 4 : 3) * (size_t)TQ * kWideLdS + 2 * TQ);
}

// The wide body over NC channel chunks of 128 (C <= 128 NC), launched with
// kWideWarps warps over blocks of 16 RB queries (grid.x (row, query tile),
// grid.y the head): K2 with BIAS, K3 and K5 (STATS: m and log s) without.
// Launch bounds are the kernel's: 1 block of 8 warps a SM.
template <bool BIAS, bool HAS_MASK, bool STATS, int NC, int RB = 2>
__device__ __forceinline__ void wide_tf32x3_body(const F32Args& a) {
  constexpr int TQ = 16 * RB, BK = kWideBK, KC = kWideKC, LS = kWideLdS;
  constexpr int STAGE = wide_stage(TQ);
  constexpr int TPR = kWideWarps * 32 / TQ, G = BK / (4 * TPR);  // the row pass
  // a tile's bias is staged by the copies issued at its previous tile's
  // last V chunk, after every thread has passed the first one's barrier
  static_assert(NC >= 2, "the wide body takes C > 128");
  static_assert(RB == 2 || RB == 4, "two or four row blocks");
  extern __shared__ __align__(16) float smem_f[];
  float* stage_s = smem_f;                   // [2][STAGE]
  float* bias_s = stage_s + 2 * STAGE;       // BIAS: [TQ][LS], the tile's bias
  float* s_s = bias_s + (BIAS ? TQ * LS : 0);  // [TQ][LS], the tile's logits
  unsigned* p_hi = reinterpret_cast<unsigned*>(s_s + TQ * LS);  // [TQ][LS], P's TF32 big part
  unsigned* p_lo = p_hi + TQ * LS;                               // and small part
  float* alpha_s = reinterpret_cast<float*>(p_lo + TQ * LS);     // [TQ], exp(m - m')
  float* l_s = alpha_s + TQ;                                     // [TQ], the final sums

  const int N = a.N, C = a.C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const Block b = block_of<TQ>(N, 0);
  const float* q_base = a.q + b.r * a.qs.r + b.h * a.qs.h;
  const float* k_base = a.k + b.r * a.ks.r + b.h * a.ks.h;
  const float* v_base = a.v + b.r * a.vs.r + b.h * a.vs.h;
  const float* bias_head = BIAS ? a.bias + ((long long)b.r * a.H + b.h) * N * N : nullptr;
  const float* mask_row = HAS_MASK ? a.mask + (long long)b.r * N : nullptr;
  const int tiles = (N + BK - 1) / BK;
  const int stages = tiles * 2 * NC;

  // Stage s of key tile t = s / (2 NC), j = s % (2 NC): j < NC chunk j of Q
  // and K (with the tile's bias at j = 0), else chunk j - NC of V.
  auto issue = [&](int s) {
    float* buf = stage_s + (s & 1) * STAGE;
    const int t = s / (2 * NC), j = s - t * 2 * NC;
    if (j < NC) {
      const int c0 = j * KC;
      stage_f32(q_base + c0, a.qs.n, b.q0, TQ, N, C - c0, KC, kWideLdQK, buf);
      stage_f32(k_base + c0, a.ks.n, t * BK, BK, N, C - c0, KC, kWideLdQK,
                buf + TQ * kWideLdQK);
      if (BIAS && j == 0) stage_bias(bias_head, N, b.q0, TQ, t * BK, BK, LS, a.bias16, bias_s);
    } else {
      const int c0 = (j - NC) * KC;
      stage_f32(v_base + c0, a.vs.n, t * BK, BK, N, C - c0, KC, kWideLdV, buf);
    }
  };
  // The start of stage s: its copies landed (and q scaled) for the block,
  // the next stage's in flight.
  auto begin = [&](int s, bool q_chunk, int c0) -> float* {
    if (s + 1 < stages) issue(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    float* buf = stage_s + (s & 1) * STAGE;
    if (q_chunk && a.scale != 1.f)  // the pre-scaled q, by the threads that copied it
      scale_staged_f32(buf, b.q0, TQ, N, C - c0, KC, kWideLdQK, a.scale);
    __syncthreads();
    return buf;
  };

  float acc[NC][2][RB][4];  // chunk, n-tile (2 warp, 2 warp + 1), row block, fragment
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int rb = 0; rb < RB; ++rb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][n][rb][e] = 0.f;
  const int row = tid / TPR, part = tid % TPR;  // the row pass: TPR threads a row
  float m_run = neg_inf(), l_run = 0.f;

  issue(0);
  cp_async_commit();  // stage 0 a group of its own: begin(0) waits for it
  int s = 0;
  for (int t = 0; t < tiles; ++t) {
    // S = Q K^T over the chunks of C: this warp's row block w % RB and 8 RB
    // keys from (w / RB) 8 RB
    float sacc[RB][4];
#pragma unroll
    for (int n = 0; n < RB; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll 1
    for (int j = 0; j < NC; ++j, ++s) {
      const float* buf = begin(s, true, j * KC);
      logits_tf32<RB, KC, true>(buf + (warp % RB) * 16 * kWideLdQK,
                                buf + (TQ + (warp / RB) * RB * 8) * kWideLdQK, kWideLdQK, lane,
                                sacc);
      __syncthreads();  // the stage after next overwrites this buffer
    }
    {
      const int r0 = (warp % RB) * 16 + g, c0 = (warp / RB) * RB * 8 + 2 * t4;
#pragma unroll
      for (int n = 0; n < RB; ++n) {
        *reinterpret_cast<float2*>(s_s + r0 * LS + c0 + n * 8) = make_float2(sacc[n][0], sacc[n][1]);
        *reinterpret_cast<float2*>(s_s + (r0 + 8) * LS + c0 + n * 8) =
            make_float2(sacc[n][2], sacc[n][3]);
      }
    }
    __syncthreads();
    {
      // the row pass: keys (h TPR + part) 4 + [0, 4) of the tile for h < G,
      // plus the bias, then the fill; past N -inf (weight 0)
      const int k0 = t * BK;
      float l[4 * G];
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const int col = (h * TPR + part) * 4;
        const float4 x = *reinterpret_cast<const float4*>(s_s + row * LS + col);
        l[4 * h] = x.x;
        l[4 * h + 1] = x.y;
        l[4 * h + 2] = x.z;
        l[4 * h + 3] = x.w;
        if constexpr (BIAS) {
          const float4 y = *reinterpret_cast<const float4*>(bias_s + row * LS + col);
          l[4 * h] += y.x;
          l[4 * h + 1] += y.y;
          l[4 * h + 2] += y.z;
          l[4 * h + 3] += y.w;
        }
      }
      float mx = neg_inf();
#pragma unroll
      for (int i = 0; i < 4 * G; ++i) {
        const int key = k0 + ((i >> 2) * TPR + part) * 4 + (i & 3);
        if (key >= N)
          l[i] = neg_inf();
        else if (HAS_MASK && mask_row[key] < 0.5f)
          l[i] = kMaskFill;
        mx = fmaxf(mx, l[i]);
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      // the tile holds a key below N, so the new max is finite and the
      // first tile's rescale is exp(-inf) = 0
      const float m_new = fmaxf(m_run, mx);
      const float alpha = exp2_approx((m_run - m_new) * kLog2e);
      const float nm = -m_new * kLog2e;
      float sum = 0.f;
      unsigned hi[4 * G], lo[4 * G];
#pragma unroll
      for (int i = 0; i < 4 * G; ++i) {
        const float p = exp2_approx(fmaf(l[i], kLog2e, nm));
        sum += p;
        split_tf32(p, hi[i], lo[i]);
      }
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const int at = row * LS + (h * TPR + part) * 4;
        *reinterpret_cast<uint4*>(p_hi + at) = make_uint4(hi[4 * h], hi[4 * h + 1],
                                                          hi[4 * h + 2], hi[4 * h + 3]);
        *reinterpret_cast<uint4*>(p_lo + at) = make_uint4(lo[4 * h], lo[4 * h + 1],
                                                          lo[4 * h + 2], lo[4 * h + 3]);
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) sum += __shfl_xor_sync(kFull, sum, off);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (part == 0) alpha_s[row] = alpha;
    }
    // acc = acc exp(m - m') + P V, chunk by chunk of V's channels
#pragma unroll
    for (int c = 0; c < NC; ++c, ++s) {
      const float* v_t = begin(s, false, 0);
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        const float al_a = alpha_s[rb * 16 + g], al_b = alpha_s[rb * 16 + g + 8];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          acc[c][n][rb][0] *= al_a;
          acc[c][n][rb][1] *= al_a;
          acc[c][n][rb][2] *= al_b;
          acc[c][n][rb][3] *= al_b;
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        unsigned bb[2][2], bs[2][2];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float* v_col = v_t + (kk * 8 + t4) * kWideLdV + (2 * warp + n) * 8 + g;
          split_tf32(v_col[0], bb[n][0], bs[n][0]);
          split_tf32(v_col[4 * kWideLdV], bb[n][1], bs[n][1]);
        }
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          const int at = (rb * 16 + g) * LS + kk * 8 + t4;
          const unsigned ah[4] = {p_hi[at], p_hi[at + 8 * LS], p_hi[at + 4], p_hi[at + 8 * LS + 4]};
          const unsigned al[4] = {p_lo[at], p_lo[at + 8 * LS], p_lo[at + 4], p_lo[at + 8 * LS + 4]};
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma_3xtf32(acc[c][n][rb], ah, al, bb[n][0], bb[n][1], bs[n][0], bs[n][1]);
        }
      }
      __syncthreads();  // the stage after next overwrites this buffer
    }
  }

  if (part == 0) {
    l_s[row] = l_run;
    if (STATS && b.q0 + row < N) {  // K5: one thread a row
      const long long at = ((long long)b.r * a.H + b.h) * N + b.q0 + row;
      a.m[at] = m_run;
      a.logs[at] = logf(l_run);
    }
  }
  __syncthreads();
#pragma unroll
  for (int rb = 0; rb < RB; ++rb) {
    const int row_a = b.q0 + rb * 16 + g;
    const float div_a = l_s[rb * 16 + g], div_b = l_s[rb * 16 + g + 8];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int ch = c * KC + (2 * warp + n) * 8 + 2 * t4;
        if (ch >= C) continue;
        if (row_a < N)
          *reinterpret_cast<float2*>(a.out + (((long long)b.r * N + row_a) * a.H + b.h) * C + ch) =
              make_float2(acc[c][n][rb][0] / div_a, acc[c][n][rb][1] / div_a);
        if (row_a + 8 < N)
          *reinterpret_cast<float2*>(a.out +
                                     (((long long)b.r * N + row_a + 8) * a.H + b.h) * C + ch) =
              make_float2(acc[c][n][rb][2] / div_b, acc[c][n][rb][3] / div_b);
      }
    }
  }
}

// K1 fast's rounding points (attention_tf32.cu and, past C = 128,
// attention_fast_wide_tf32.cu): x rounded to bf16 and back.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// K1 fast's recompute window, in units of 2^-24 |q| |k| (the logit's f32
// error scale), and whether x lies within w of a midpoint between two bf16
// values: its low 16 bits' distance from 0x8000 times its ulp.
constexpr float kNearF32 = 32.f;
__device__ __forceinline__ bool near_bf16_midpoint_f32(float x, float w) {
  const unsigned u = __float_as_uint(x);
  const float ulp = __uint_as_float((unsigned)max((int)((u >> 23) & 0xffu) - 23, 0) << 23);
  return (float)abs((int)(u & 0xffffu) - 0x8000) * ulp <= w;
}

}  // namespace
