// The wide tensor-core bodies of K7, the rows attention flash backward, and
// of K6, its K-chunk regime's backward from K5's stats, for head widths C
// that are a multiple of 8 in (128, 1024]: one body for both dtypes and both
// kernels, bf16 on mma.sync m16n8k16 (K7 attention_bwd_wide_mma.cu, K6
// attention_kchunk_bwd_wide_mma.cu) and f32 in 3xTF32 (K7
// attention_bwd_wide_tf32.cu, K6 attention_kchunk_bwd_wide_tf32.cu), which
// instantiate it under their own kernel names, each a source of its own so
// that nvcc builds them beside the narrow bodies (attention_bwd_mma.cu,
// attention_bwd_tf32.cu). The narrow bodies (C <= 128) keep a whole head of
// each operand in a warp's fragments; past 128 a warp cannot hold 16 rows of
// a head's gradient, and the CUDA-core bodies (attention_bwd.cu,
// attention_kchunk_bwd.cu) they replace spill at 8 channels a lane.
//
// The function is the narrow bodies' (rows_attention_bwd_reference): per
// (row, head), qt = q * scale rounded to T, logits with -2^15 at masked keys,
// P = softmax in f32, dv = round_T(P)^T dO, dP = dO V^T, delta = rowsum(dP o
// P), dS = P o (dP - delta), zero at masked keys, rounded to T once, dqt = dS
// K and dk = dS^T qt, f32 sums, outputs in T. K6 (STATS_IN) takes P =
// exp((l - m) - log s) from K5's split stats and delta = rowsum(dO o O)
// from the caller (rows_attention_kchunk_bwd_reference), read only. Two
// kernels, as the narrow bodies:
//
//   dq kernel: a block of 32 queries (two row blocks of 16) and 8 warps.
//     Pass A over the key tiles of 64 computes S = qt K^T and dP = dO V^T
//     for the tile once each, streaming the contraction over C in chunks of
//     128 channels (a stage of Q and K, or of dO and V, a chunk each), and a
//     row pass (8 threads a row) takes the online softmax step with delta
//     carried beside the sum: u = u exp(m - m') + sum_j exp(l_j - m') dP_j,
//     so delta = u / s at the end; this folds the narrow body's delta pass
//     into its stats pass (one exponential a logit fewer, dP once fewer).
//     Pass B computes S and dP again, the row pass turns them into dS in
//     shared memory, and stages of K's chunks give dqt += dS K[:, chunk].
//     It writes m, s and delta to the [3, R, H, N] scratch, as the narrow
//     dq kernel does. K6's dq kernel skips pass A: each row's -m log2 e,
//     exp(-log s) and delta are read (load_stats: the two stats apart, so
//     that a fully masked row, l = m = -2^15, keeps an exponent of exactly
//     0), pass B runs alone and nothing is written to the stats.
//   dk/dv kernel: a block of TK keys (32 up to C = 512, 16 above), 8 warps,
//     over query tiles of 64, transposed as the narrow kernel (rows keys):
//     S^T = K qt^T and dP^T = V dO^T once per tile by the same chunk
//     stages, the row pass turns them into P^T and dS^T with the queries'
//     stats read per column (K6: m and log s apart, as the dq kernel; past
//     N: -inf and 0, so P^T is exactly 0), then
//     stages of dO's chunks give dv += P^T dO[:, chunk] and stages of qt's
//     give dk += dS^T qt[:, chunk].
// S, dP, P and dS go through shared memory: the rows of a tile span the
// warps (warp w computes row block w % RB and n-tiles RB (w / RB) + [0,
// RB) of the [16 RB, 64] tile), and the products read P and dS as A
// operands. Warp w owns output n-tiles 2w and 2w + 1 of every 128-channel
// chunk, all rows of the block, in registers across the tiles: 128
// accumulators a thread at most (dq: 32 rows; dk and dv: two outputs of 32
// rows, 16 past C = 512). Every stage is one cp.async double-buffered step, so
// the next stage's copies land while this one is multiplied; q is scaled
// (and in bf16 rounded) in shared memory by the threads that copied it.
//
// What bounds them: at C = 256, per logit 2 x 2 C operations for S and dP
// in each pass and kernel and 2 C for each of dqt, dv and dk, 9 x 2 C in
// all against the 5 x 2 C the plain function needs: the products, on the
// tensor cores, at bf16's 989 TFLOP/s or 3xTF32's 165 TFLOP/s. Q, K, V and
// dO are read again from L2 for each tile; device memory sees each operand
// about once.
#pragma once

#include "attention_tf32.cuh"

namespace {

constexpr int kWbWarps = 8;
constexpr int kWbBK = 64;      // keys a dq tile, queries a dk/dv tile
constexpr int kWbKC = 128;     // channels a chunk: two n-tiles a warp
constexpr int kWbLdT = kWbBK + 4;  // the f32 S and dP tiles' rows

template <typename T>
struct WideBwdArgs {
  const T* q;
  const T* k;
  const T* v;
  const float* mask;
  const T* g;  // dO
  T* dq;
  T* dk;
  T* dv;
  // K7: the [3, R, H, N] scratch its dq kernel writes (m, s, delta); K6:
  // K5's m and log s and the caller's delta, [R, H, N] each, read only
  float* m;
  float* s;
  float* delta;
  int R, N, H, C;
  float scale;
  Strides qs, ks, vs, gs;
};

// The dtype's staging, fragments and A-operand tiles.
template <typename T>
struct WideOps;

template <>
struct WideOps<float> {
  static constexpr int kLdS = kWbKC + 4;  // chunks read as S = A B^T operands (4 mod 32)
  static constexpr int kLdP = kWbKC + 8;  // chunks read as a product's B operand (8 mod 32)
  static constexpr int kLdA = kWbLdT;     // the P and dS tiles: TF32 big and small parts

  // An A-operand tile [rows][kLdA]: its two TF32 parts.
  struct Tile {
    unsigned* hi;
    unsigned* lo;
  };
  static __host__ __device__ constexpr size_t tile_bytes(int rows) {
    return 2 * sizeof(unsigned) * rows * kLdA;
  }
  static __device__ __forceinline__ Tile tile_at(unsigned char* p, int rows) {
    unsigned* hi = reinterpret_cast<unsigned*>(p);
    return {hi, hi + rows * kLdA};
  }

  static __device__ __forceinline__ void stage(const float* base, long long stride_n, int r0,
                                               int rows, int N, int C, int ld, float* dst) {
    stage_f32(base, stride_n, r0, rows, N, C, kWbKC, ld, dst);
  }
  static __device__ __forceinline__ void scale(float* tile, int r0, int rows, int N, int C,
                                               int ld, float s) {
    scale_staged_f32(tile, r0, rows, N, C, kWbKC, ld, s);
  }
  // S += A B^T over the chunk for the warp's 16 rows and NSW n-tiles
  template <int NSW>
  static __device__ __forceinline__ void logits(const float* a_w, const float* b_t, int lane,
                                                float (&s)[NSW][4]) {
    logits_tf32<NSW, kWbKC, true>(a_w, b_t, kLdS, lane, s);
  }
  static __device__ __forceinline__ void put4(const Tile& t, int at, const float (&x)[4]) {
    unsigned hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], hi[i], lo[i]);
    *reinterpret_cast<uint4*>(t.hi + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(t.lo + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  // acc[rb][n] += A[rb 16 + .., :64] X[:64, (2w + n) 8 + ..] for RB row blocks
  template <int RB>
  static __device__ __forceinline__ void product(const Tile& a, const float* x, int warp,
                                                 int lane, float (&acc)[RB][2][4]) {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int kk = 0; kk < kWbBK; kk += 8) {
      unsigned bb[2][2], bs[2][2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float* col = x + (kk + t4) * kLdP + (2 * warp + n) * 8 + g;
        split_tf32(col[0], bb[n][0], bs[n][0]);
        split_tf32(col[4 * kLdP], bb[n][1], bs[n][1]);
      }
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        const int at = (rb * 16 + g) * kLdA + kk + t4;
        const unsigned ah[4] = {a.hi[at], a.hi[at + 8 * kLdA], a.hi[at + 4],
                                a.hi[at + 8 * kLdA + 4]};
        const unsigned al[4] = {a.lo[at], a.lo[at + 8 * kLdA], a.lo[at + 4],
                                a.lo[at + 8 * kLdA + 4]};
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mma_3xtf32(acc[rb][n], ah, al, bb[n][0], bb[n][1], bs[n][0], bs[n][1]);
      }
    }
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct WideOps<bf16> {
  static constexpr int kLdS = kWbKC + 8;  // 17 16-byte units a row: conflict-free ldmatrix
  static constexpr int kLdP = kWbKC + 8;
  static constexpr int kLdA = kWbBK + 8;  // the P and dS tiles in bf16

  struct Tile {
    bf16* p;
  };
  static __host__ __device__ constexpr size_t tile_bytes(int rows) {
    return sizeof(bf16) * rows * kLdA;
  }
  static __device__ __forceinline__ Tile tile_at(unsigned char* p, int) {
    return {reinterpret_cast<bf16*>(p)};
  }

  static __device__ __forceinline__ void stage(const bf16* base, long long stride_n, int r0,
                                               int rows, int N, int C, int ld, bf16* dst) {
    stage_keys(base, stride_n, r0, rows, N, C, 0, kWbKC, ld, dst);
  }
  // q * scale rounded to bf16, on this thread's own copies (stage_keys' order)
  static __device__ __forceinline__ void scale(bf16* tile, int r0, int rows, int N, int C, int ld,
                                               float s) {
    constexpr int chunks = kWbKC / 8;
    for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
      const int j = e / chunks;
      const int c = (e - j * chunks) * 8;
      if (r0 + j >= N || c >= C) continue;
      bf16* x = tile + j * ld + c;
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = __float2bfloat16_rn(__bfloat162float(x[u]) * s);
    }
  }
  template <int NSW>
  static __device__ __forceinline__ void logits(const bf16* a_w, const bf16* b_t, int lane,
                                                float (&s)[NSW][4]) {
    static_assert(NSW == 1 || NSW % 2 == 0, "one n-tile a warp, or pairs");
#pragma unroll
    for (int kc = 0; kc < kWbKC; kc += 16) {
      unsigned a[4];
      load_a_frag(a, a_w, kLdS, kc, lane);
      if constexpr (NSW % 2 == 0) {
#pragma unroll
        for (int np = 0; np < NSW / 2; ++np) {
          unsigned b[4];
          load_bt_frags(b, b_t, kLdS, np * 16, kc, lane);
          mma_bf16_16816(s[2 * np], a, b[0], b[1]);
          mma_bf16_16816(s[2 * np + 1], a, b[2], b[3]);
        }
      } else {
        unsigned b[2];
        load_bt_frag(b, b_t, kLdS, 0, kc, lane);
        mma_bf16_16816(s[0], a, b[0], b[1]);
      }
    }
  }
  static __device__ __forceinline__ void put4(const Tile& t, int at, const float (&x)[4]) {
    *reinterpret_cast<uint2*>(t.p + at) = make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  }
  template <int RB>
  static __device__ __forceinline__ void product(const Tile& a, const bf16* x, int warp,
                                                 int lane, float (&acc)[RB][2][4]) {
#pragma unroll
    for (int kk = 0; kk < kWbBK; kk += 16) {
      unsigned b[4];
      load_b_frags(b, x, kLdP, kk, 16 * warp, lane);
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        unsigned af[4];
        load_a_frag(af, a.p + rb * 16 * kLdA, kLdA, kk, lane);
        mma_bf16_16816(acc[rb][0], af, b[0], b[1]);
        mma_bf16_16816(acc[rb][1], af, b[2], b[3]);
      }
    }
  }
  static __device__ __forceinline__ void store2(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// Elements of one stage buffer: a chunk of TA + 64 rows for S (or dP), or
// of 64 rows for a product.
template <typename T>
__host__ __device__ constexpr int wide_bwd_stage(int TA) {
  const int s = (TA + kWbBK) * WideOps<T>::kLdS, p = kWbBK * WideOps<T>::kLdP;
  return s > p ? s : p;
}

// Shared memory of the dq kernel (TA = 32 query rows) and of the dk/dv
// kernel (TA = TK key rows): two stage buffers, the f32 S and dP tiles, the
// A-operand tiles (dq: dS; dk/dv: P and dS), and the dk/dv kernel's query
// stats.
template <typename T>
constexpr size_t wide_bwd_smem(int TA, bool dkdv) {
  return sizeof(T) * 2 * (size_t)wide_bwd_stage<T>(TA) +
         sizeof(float) * 2 * (size_t)TA * kWbLdT + (dkdv ? 2 : 1) * WideOps<T>::tile_bytes(TA) +
         (dkdv ? sizeof(float) * 3 * kWbBK : 0);
}

// Row blocks of 16 of a dq block (queries: 2; 4 measured slower, 1.91
// against 1.84 ms in f32 at C = 256) and of a dk/dv block (keys: 2 up to NC
// = 4, 1 above, so that dk and dv take at most 128 accumulators a thread).
constexpr int kWbDqRB = 2;
template <int NC>
constexpr int kWbRB = NC <= 4 ? 2 : 1;

// The warp's [16, 8 NSW] pieces of a [16 RB, 64] tile's S (or dP) into the
// f32 tile s_t [16 RB][kWbLdT]: row block warp % RB, n-tiles RB (warp / RB) ..
template <int RB>
__device__ __forceinline__ void put_tile(const float (&s)[RB][4], float* s_t, int warp, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = (warp % RB) * 16 + g, c0 = (warp / RB) * RB * 8 + 2 * t4;
#pragma unroll
  for (int n = 0; n < RB; ++n) {
    *reinterpret_cast<float2*>(s_t + r0 * kWbLdT + c0 + n * 8) = make_float2(s[n][0], s[n][1]);
    *reinterpret_cast<float2*>(s_t + (r0 + 8) * kWbLdT + c0 + n * 8) =
        make_float2(s[n][2], s[n][3]);
  }
}

// The block's accumulators of one output, [NC][RB][2][4], into rows [r0, r0 +
// 16 RB) of a contiguous [R, N, H, C] tensor.
template <typename T, int NC, int RB>
__device__ __forceinline__ void store_wide(T* out, int N, int H, int C, const Block& b,
                                           const float (&acc)[NC][RB][2][4], int warp, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int ch = c * kWbKC + (2 * warp + n) * 8 + 2 * t4;
        if (ch >= C) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = b.q0 + rb * 16 + g + 8 * half;
          if (row < N)
            WideOps<T>::store2(out + (((long long)b.r * N + row) * H + b.h) * C + ch,
                               acc[c][rb][n][2 * half], acc[c][rb][n][2 * half + 1]);
        }
      }
}

// The stage pipeline of a kernel: stage s's copies are issued (issue(s)) one
// stage ahead; begin(s) waits for them, lets the copying threads scale q,
// and passes the block's barrier.
template <typename T>
struct WideStages {
  T* buf0;
  int elems;
  __device__ __forceinline__ T* buf(int s) const { return buf0 + (s & 1) * elems; }
};

// The dq kernel over NC chunks (C <= 128 NC): a block of 16 RB queries.
// STATS_IN (K6): the rows' stats read, pass B only.
template <typename T, int NC, bool STATS_IN = false>
__device__ __forceinline__ void wide_bwd_dq(const WideBwdArgs<T>& a) {
  using Ops = WideOps<T>;
  constexpr int RB = kWbDqRB, TQ = 16 * RB, BK = kWbBK, KC = kWbKC;
  constexpr int LS = Ops::kLdS, LP = Ops::kLdP;
  constexpr int ELEMS = wide_bwd_stage<T>(TQ);
  constexpr int TPR = kWbWarps * 32 / TQ, G = BK / (4 * TPR);  // the row pass
  static_assert(NC >= 2, "the wide body takes C > 128");
  extern __shared__ __align__(16) unsigned char smem_wb[];
  const WideStages<T> st{reinterpret_cast<T*>(smem_wb), ELEMS};
  float* s_s = reinterpret_cast<float*>(smem_wb + sizeof(T) * 2 * ELEMS);  // [TQ][kWbLdT]
  float* dp_s = s_s + TQ * kWbLdT;                                            // [TQ][kWbLdT]
  const typename Ops::Tile ds_t = Ops::tile_at(reinterpret_cast<unsigned char*>(dp_s + TQ * kWbLdT),
                                               TQ);

  const int N = a.N, C = a.C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Block b = block_of<TQ>(N, 0);
  const T* q_base = a.q + b.r * a.qs.r + b.h * a.qs.h;
  const T* k_base = a.k + b.r * a.ks.r + b.h * a.ks.h;
  const T* v_base = a.v + b.r * a.vs.r + b.h * a.vs.h;
  const T* g_base = a.g + b.r * a.gs.r + b.h * a.gs.h;
  const float* mask_row = a.mask + (long long)b.r * N;
  const long long base = ((long long)b.r * a.H + b.h) * N;
  const int tiles = (N + BK - 1) / BK;
  const int stages_a = STATS_IN ? 0 : tiles * 2 * NC, stages = stages_a + tiles * 3 * NC;

  // Stage s: pass A (s < stages_a) key tile t, j < NC chunk j of qt and K,
  // else chunk j - NC of dO and V; pass B the same, then j >= 2 NC chunk j
  // - 2 NC of K as a product's B operand.
  auto issue = [&](int s) {
    T* buf = st.buf(s);
    const int sb = s < stages_a ? s : s - stages_a, per = s < stages_a ? 2 * NC : 3 * NC;
    const int t = sb / per, j = sb - t * per;
    const int c0 = (j % NC) * KC;
    if (j < NC) {
      Ops::stage(q_base + c0, a.qs.n, b.q0, TQ, N, C - c0, LS, buf);
      Ops::stage(k_base + c0, a.ks.n, t * BK, BK, N, C - c0, LS, buf + TQ * LS);
    } else if (j < 2 * NC) {
      Ops::stage(g_base + c0, a.gs.n, b.q0, TQ, N, C - c0, LS, buf);
      Ops::stage(v_base + c0, a.vs.n, t * BK, BK, N, C - c0, LS, buf + TQ * LS);
    } else {
      Ops::stage(k_base + c0, a.ks.n, t * BK, BK, N, C - c0, LP, buf);
    }
  };
  auto begin = [&](int s, bool q_chunk, int c0) -> const T* {
    if (s + 1 < stages) issue(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    T* buf = st.buf(s);
    if (q_chunk) Ops::scale(buf, b.q0, TQ, N, C - c0, LS, a.scale);
    __syncthreads();
    return buf;
  };
  // S and dP of key tile t over the chunks into s_s and dp_s
  auto logits = [&](int& s) {
    float sacc[RB][4], dacc[RB][4];
#pragma unroll
    for (int n = 0; n < RB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = dacc[n][e] = 0.f;
    const int a_off = (warp % RB) * 16 * LS, b_off = (TQ + (warp / RB) * RB * 8) * LS;
#pragma unroll 1
    for (int j = 0; j < 2 * NC; ++j, ++s) {
      const T* buf = begin(s, j < NC, (j % NC) * KC);
      if (j < NC)
        Ops::template logits<RB>(buf + a_off, buf + b_off, lane, sacc);
      else
        Ops::template logits<RB>(buf + a_off, buf + b_off, lane, dacc);
      __syncthreads();  // the stage after next overwrites this buffer
    }
    put_tile<RB>(sacc, s_s, warp, lane);
    put_tile<RB>(dacc, dp_s, warp, lane);
    __syncthreads();
  };

  float acc[NC][RB][2][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][rb][n][e] = 0.f;
  const int row = tid / TPR, part = tid % TPR;  // the row pass: TPR threads a row
  float m_run = neg_inf(), l_run = 0.f, u_run = 0.f;
  // this thread's keys of a tile: (h TPR + part) 4 + [0, 4) for h < G
  auto row_values = [&](int k0, float (&l)[4 * G], float (&d)[4 * G], bool (&kept)[4 * G]) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const int col = (h * TPR + part) * 4;
      const float4 x = *reinterpret_cast<const float4*>(s_s + row * kWbLdT + col);
      const float4 y = *reinterpret_cast<const float4*>(dp_s + row * kWbLdT + col);
      l[4 * h] = x.x, l[4 * h + 1] = x.y, l[4 * h + 2] = x.z, l[4 * h + 3] = x.w;
      d[4 * h] = y.x, d[4 * h + 1] = y.y, d[4 * h + 2] = y.z, d[4 * h + 3] = y.w;
    }
#pragma unroll
    for (int i = 0; i < 4 * G; ++i) {
      const int key = k0 + ((i >> 2) * TPR + part) * 4 + (i & 3);
      kept[i] = key < N && mask_row[key] >= 0.5f;
      if (key >= N)
        l[i] = neg_inf();
      else if (!kept[i])
        l[i] = kMaskFill;
    }
  };

  issue(0);
  cp_async_commit();  // stage 0 a group of its own: begin(0) waits for it
  int s = 0;
  // pass A (K7): m and s online, u beside s
  for (int t = 0; t < (STATS_IN ? 0 : tiles); ++t) {
    logits(s);
    float l[4 * G], d[4 * G];
    bool kept[4 * G];
    row_values(t * BK, l, d, kept);
    float mx = neg_inf();
#pragma unroll
    for (int i = 0; i < 4 * G; ++i) mx = fmaxf(mx, l[i]);
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    // the tile holds a key below N: the new max is finite, the first
    // rescale exp(-inf) = 0
    const float m_new = fmaxf(m_run, mx);
    const float alpha = exp2_approx((m_run - m_new) * kLog2e);
    const float nm = -m_new * kLog2e;
    float sum = 0.f, u = 0.f;
#pragma unroll
    for (int i = 0; i < 4 * G; ++i) {
      const float p = exp2_approx(fmaf(l[i], kLog2e, nm));
      sum += p;
      u = fmaf(p, d[i], u);
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) {
      sum += __shfl_xor_sync(kFull, sum, off);
      u += __shfl_xor_sync(kFull, u, off);
    }
    l_run = l_run * alpha + sum;
    u_run = u_run * alpha + u;
    m_run = m_new;
  }
  float nm = -m_run * kLog2e, inv = 1.f / l_run, delta = u_run * inv;
  if constexpr (STATS_IN) {  // K6: K5's m and log s kept apart, the caller's delta
    const RowStats rs = load_stats<true>(a.m, a.s, a.delta, base + b.q0 + row, b.q0 + row < N);
    nm = rs.nm, inv = rs.inv, delta = rs.delta;
  }
  // pass B: dS, then dqt += dS K chunk by chunk
  for (int t = 0; t < tiles; ++t) {
    logits(s);
    float l[4 * G], d[4 * G];
    bool kept[4 * G];
    row_values(t * BK, l, d, kept);
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * h + e;
        const float p = exp2_approx(fmaf(l[i], kLog2e, nm)) * inv;
        ds[e] = kept[i] ? p * (d[i] - delta) : 0.f;
      }
      Ops::put4(ds_t, row * Ops::kLdA + (h * TPR + part) * 4, ds);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c, ++s) {
      const T* k_t = begin(s, false, 0);  // its barrier also publishes dS
      Ops::template product<RB>(ds_t, k_t, warp, lane, acc[c]);
      __syncthreads();  // the stage after next overwrites this buffer
    }
  }

  store_wide<T, NC, RB>(a.dq, N, a.H, C, b, acc, warp, lane);
  if (!STATS_IN && part == 0 && b.q0 + row < N) {  // K7: one thread a row
    const long long at = base + b.q0 + row;
    a.m[at] = m_run;
    a.s[at] = l_run;
    a.delta[at] = delta;
  }
}

// The dk/dv kernel over NC chunks: a block of 16 RB keys. STATS_IN (K6):
// the queries' second stat is log s.
template <typename T, int NC, bool STATS_IN = false>
__device__ __forceinline__ void wide_bwd_dkdv(const WideBwdArgs<T>& a) {
  using Ops = WideOps<T>;
  constexpr int RB = kWbRB<NC>, TK = 16 * RB, BQ = kWbBK, KC = kWbKC;
  constexpr int LS = Ops::kLdS, LP = Ops::kLdP, LA = Ops::kLdA;
  constexpr int ELEMS = wide_bwd_stage<T>(TK);
  constexpr int TPR = kWbWarps * 32 / TK, GROUPS = BQ / (4 * TPR);  // the row pass
  static_assert(NC >= 2, "the wide body takes C > 128");
  extern __shared__ __align__(16) unsigned char smem_wb[];
  const WideStages<T> st{reinterpret_cast<T*>(smem_wb), ELEMS};
  float* s_s = reinterpret_cast<float*>(smem_wb + sizeof(T) * 2 * ELEMS);  // [TK][kWbLdT]
  float* dp_s = s_s + TK * kWbLdT;
  unsigned char* tiles_at = reinterpret_cast<unsigned char*>(dp_s + TK * kWbLdT);
  const typename Ops::Tile p_t = Ops::tile_at(tiles_at, TK);
  const typename Ops::Tile ds_t = Ops::tile_at(tiles_at + Ops::tile_bytes(TK), TK);
  float* stat_s = reinterpret_cast<float*>(tiles_at + 2 * Ops::tile_bytes(TK));  // [3][BQ]

  const int N = a.N, C = a.C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Block b = block_of<TK>(N, 0);  // b.q0: the block's first key
  const T* q_base = a.q + b.r * a.qs.r + b.h * a.qs.h;
  const T* k_base = a.k + b.r * a.ks.r + b.h * a.ks.h;
  const T* v_base = a.v + b.r * a.vs.r + b.h * a.vs.h;
  const T* g_base = a.g + b.r * a.gs.r + b.h * a.gs.h;
  const long long base = ((long long)b.r * a.H + b.h) * N;
  const int tiles = (N + BQ - 1) / BQ;
  const int per = 4 * NC, stages = tiles * per;

  // Stage s of query tile t: j < NC chunk j of K and qt, j < 2 NC chunk j -
  // NC of V and dO (S^T and dP^T), j < 3 NC chunk j - 2 NC of dO, else of qt
  // (the B operands of dv and dk).
  auto issue = [&](int s) {
    T* buf = st.buf(s);
    const int t = s / per, j = s - t * per;
    const int c0 = (j % NC) * KC, i0 = t * BQ;
    if (j < NC) {
      Ops::stage(k_base + c0, a.ks.n, b.q0, TK, N, C - c0, LS, buf);
      Ops::stage(q_base + c0, a.qs.n, i0, BQ, N, C - c0, LS, buf + TK * LS);
    } else if (j < 2 * NC) {
      Ops::stage(v_base + c0, a.vs.n, b.q0, TK, N, C - c0, LS, buf);
      Ops::stage(g_base + c0, a.gs.n, i0, BQ, N, C - c0, LS, buf + TK * LS);
    } else if (j < 3 * NC) {
      Ops::stage(g_base + c0, a.gs.n, i0, BQ, N, C - c0, LP, buf);
    } else {
      Ops::stage(q_base + c0, a.qs.n, i0, BQ, N, C - c0, LP, buf);
    }
  };
  // qt at: the S stages (rows after the TK keys, row stride LS) and the dk
  // stages (row 0, row stride LP)
  auto begin = [&](int s) -> const T* {
    if (s + 1 < stages) issue(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    T* buf = st.buf(s);
    const int t = s / per, j = s - t * per;
    const int c0 = (j % NC) * KC;
    if (j < NC) Ops::scale(buf + TK * LS, t * BQ, BQ, N, C - c0, LS, a.scale);
    if (j >= 3 * NC) Ops::scale(buf, t * BQ, BQ, N, C - c0, LP, a.scale);
    __syncthreads();
    return buf;
  };

  float dk[NC][RB][2][4], dv[NC][RB][2][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int rb = 0; rb < RB; ++rb)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[c][rb][n][e] = dv[c][rb][n][e] = 0.f;
  const int row = tid / TPR, part = tid - row * TPR;
  const int key = b.q0 + row;
  const bool masked = key >= N || a.mask[(long long)b.r * N + key] < 0.5f;
  const int a_off = (warp % RB) * 16 * LS, b_off = (TK + (warp / RB) * RB * 8) * LS;

  issue(0);
  cp_async_commit();
  int s = 0;
  for (int t = 0; t < tiles; ++t) {
    // the tile's query stats: published by the first stage's barrier; the
    // previous tile's row pass read them before its product stages' barriers
    if (tid < BQ) {
      const int i = t * BQ + tid;
      const RowStats rs = load_stats<STATS_IN>(a.m, a.s, a.delta, base + i, i < N);
      stat_s[tid] = rs.nm;
      stat_s[BQ + tid] = rs.inv;
      stat_s[2 * BQ + tid] = rs.delta;
    }
    float sacc[RB][4], dacc[RB][4];
#pragma unroll
    for (int n = 0; n < RB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = dacc[n][e] = 0.f;
#pragma unroll 1
    for (int j = 0; j < 2 * NC; ++j, ++s) {
      const T* buf = begin(s);
      if (j < NC)
        Ops::template logits<RB>(buf + a_off, buf + b_off, lane, sacc);  // S^T: rows keys
      else
        Ops::template logits<RB>(buf + a_off, buf + b_off, lane, dacc);  // dP^T
      __syncthreads();
    }
    put_tile<RB>(sacc, s_s, warp, lane);
    put_tile<RB>(dacc, dp_s, warp, lane);
    __syncthreads();
    // the row pass: P^T and dS^T of this thread's 4 GROUPS query columns
#pragma unroll
    for (int gi = 0; gi < GROUPS; ++gi) {
      const int col = (gi * TPR + part) * 4;
      const float4 x = *reinterpret_cast<const float4*>(s_s + row * kWbLdT + col);
      const float4 y = *reinterpret_cast<const float4*>(dp_s + row * kWbLdT + col);
      const float sv[4] = {x.x, x.y, x.z, x.w}, dv4[4] = {y.x, y.y, y.z, y.w};
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = col + e;
        const float l = masked ? kMaskFill : sv[e];
        p[e] = exp2_approx(fmaf(l, kLog2e, stat_s[i])) * stat_s[BQ + i];
        ds[e] = masked ? 0.f : p[e] * (dv4[e] - stat_s[2 * BQ + i]);
      }
      Ops::put4(p_t, row * LA + col, p);
      Ops::put4(ds_t, row * LA + col, ds);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c, ++s) {
      const T* g_t = begin(s);  // its barrier also publishes P^T and dS^T
      Ops::template product<RB>(p_t, g_t, warp, lane, dv[c]);  // dv += P^T dO
      __syncthreads();
    }
#pragma unroll
    for (int c = 0; c < NC; ++c, ++s) {
      const T* q_t = begin(s);
      Ops::template product<RB>(ds_t, q_t, warp, lane, dk[c]);  // dk += dS^T qt
      __syncthreads();
    }
  }
  store_wide<T, NC, RB>(a.dk, N, a.H, C, b, dk, warp, lane);
  store_wide<T, NC, RB>(a.dv, N, a.H, C, b, dv, warp, lane);
}

// The operands both kernels take, K7's scratch or K6's read-only stats
// given (the entry points pass K6's const pointers through unchanged).
template <typename T>
bool wide_bwd_ok(const WideBwdArgs<T>& a) {
  constexpr long long v = 16 / sizeof(T);
  auto fits = [](const Strides& s) { return s.r % v == 0 && s.n % v == 0 && s.h % v == 0; };
  return a.R > 0 && a.N > 0 && a.H > 0 && a.H <= 65535 && a.C > 128 && a.C <= 1024 &&
         a.C % 8 == 0 && fits(a.qs) && fits(a.ks) && fits(a.vs) && fits(a.gs) &&
         aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.g) &&
         a.mask != nullptr && a.m != nullptr && a.s != nullptr && a.delta != nullptr;
}

// Launch the two kernels (DQ and DKDV, instantiated by the including file
// under its own names) over NC chunks: grid.x (row, TQ queries) and (row,
// TK keys), grid.y the head.
template <typename T, int NC, typename DqKernel, typename DkdvKernel>
cudaError_t launch_wide_bwd(DqKernel dq_kern, DkdvKernel dkdv_kern, const WideBwdArgs<T>& a,
                            cudaStream_t stream) {
  constexpr int TQ = 16 * kWbDqRB, TK = 16 * kWbRB<NC>;
  const long long dq_blocks = (long long)((a.N + TQ - 1) / TQ) * a.R;
  const long long dkdv_blocks = (long long)((a.N + TK - 1) / TK) * a.R;
  if (dkdv_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t dq_smem = wide_bwd_smem<T>(TQ, false), dkdv_smem = wide_bwd_smem<T>(TK, true);
  cudaError_t e = cudaFuncSetAttribute(dq_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)dq_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dkdv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkdv_smem);
  if (e != cudaSuccess) return e;
  dq_kern<<<dim3((unsigned)dq_blocks, a.H), kWbWarps * 32, dq_smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dkdv_kern<<<dim3((unsigned)dkdv_blocks, a.H), kWbWarps * 32, dkdv_smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
