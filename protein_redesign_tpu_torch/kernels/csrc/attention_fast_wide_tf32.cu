// Hand-written Hopper (sm_90a) tensor-core body of K1 fast, the rows
// attention with its softmax rounded as bf16 (cfg.fast_softmax; serving an
// f32 checkpoint), in float32 past head width 128, for C a multiple of 4 in
// (128, 1024]:
//
//   rows_attention_fast_wide_tf32x3_kernel<STORE, NC>
//       <- _rows_attention_impl with fast=True / _make_rowhead_kernel (K1 fast)
//
// of protein_redesign_tpu/ops/pallas_attention.py. It replaces, at those
// widths, the CUDA-core body of attention.cu (kept callable to time it
// beside this one), which spills at 8 channels a lane:
// 10.3 ms at R = 384, N = 192, C = 256, 22x SDPA.
//
// The function is rows_attention_fast_reference's, point by point, as the
// narrow f32 body's (attention_tf32.cu, C <= 128): l = bf16(q k) after the
// -2^15 fill; m = max l; e = bf16(exp(bf16(l - m))); s = bf16(sum of e in
// f32); p = bf16(e / s); P.V in f32. p is rounded after the division, so
// the division cannot be deferred to the end as online softmax defers it:
// the body takes three passes over the keys (the max, the sum, P.V).
//
// Layout of the work: the narrow fast body's design on the wide body's
// chunk stages (wide_tf32x3_body, attention_tf32.cuh). A block of 16 RB
// queries (64 up to C = 512, 32 above) and 8 warps. Pass 0 streams each key
// tile's Q K^T over C in 128-channel chunks through two cp.async stages,
// once per tile: warp w forms row block w % RB and 8 RB keys of the [16 RB,
// 64] tile in 3xTF32 accumulators, which it keeps. The same stages give the
// window scales: each key's norm per tile and each query's once, from the
// staged chunks. The logits are fixed up in the accumulators (-inf past N,
// -2^15 at masked keys), rounded to bf16 and, where they fit (STORE), kept
// in shared memory, two bf16 a 32-bit word in the accumulators' order (each
// thread reads back only what it wrote: 2 TQ bytes a key, 24 KB at TQ = 64,
// N = 192); pass 1 turns them into e in place and sums them; pass 2 divides,
// writes the tile's P to shared memory as f32 A operands and streams V's
// chunks, each warp holding 16 channels of every chunk of the output in
// registers, as the wide body does. Where the logits do not fit (past N ~
// 576 at C <= 512, ~ 1856 above), passes 1 and 2 recompute them from Q and
// K's chunks instead. Row max and sum span the 8 / RB warps of a row block:
// a quad reduction, then one through shared memory, summed in warp order.
//
// The near-midpoint recompute. The logits are 3xTF32; one within kNearF32
// 2^-24 |q| |k| of a bf16 rounding midpoint is recomputed as the CUDA-core
// body and the narrow body take it: one f32 FMA chain over the channels in
// order, of the pre-scaled q (q * scale in f32) and k. The wide body never
// holds a whole head in shared memory, so the chain reads the two rows from
// device memory (L2) in channel order. A chain is C dependent FMAs, so the
// warp spreads its window logits over its lanes, one chain a lane at a time
// (a job list in shared memory), where each thread taking its own would
// leave the warp waiting on its busiest lane: 0.84 against 0.74 ms at C =
// 256, N = 192, and 0.51 without any recompute (kernels.variants
// k1fastwide). The chains still take 0.22 ms of it; each reads its two rows
// whole (2 KB at C = 256), and loads batched ahead of the FMAs did not move
// it (PERF.md). The
// wide body's 3xTF32 logit sums each chunk's 8-deep steps into the same
// accumulator in channel order, the narrow body's order at CP = C, and in
// the CPU emulation (tests/test_torch_tf32x3.py) the distance to the plain
// f32 logit stays within kNearF32 / 4 such units at C = 256 and 1024 too.
// P is a bf16 value, exact in TF32, so P.V takes two TF32 products (p
// v_small + p v_big), which give the three's bits.
//
// Layout: q, k, v [R, N, H, C] f32, head dimension contiguous, the other
// strides given in elements, rows 16-byte aligned; mask contiguous f32 [R,
// N]; out contiguous [R, N, H, C]. Shared memory: fast_wide_smem (152 KB at
// TQ = 64 without the logits, 110 KB at TQ = 32), which
// ops.attention.fast_wide_tf32x3_smem_bytes mirrors. The entry point
// returns cudaGetLastError() after its launch.

#include "attention_tf32.cuh"

namespace {

// Near-midpoint logits a warp recomputes at a time: one a lane.
constexpr int kFastJobs = 32;

// Shared memory of a block of 16 RB queries at N keys: two stage buffers,
// the tile's P, the queries' windows, the tile's key norms, the row
// reductions and each warp's recompute jobs and their logits, 4 bytes each;
// with STORE each key tile's rounded logits, 2 bytes a (query, key), N
// padded to the key tile.
size_t fast_wide_smem(int RB, int N, bool store) {
  const int TQ = 16 * RB;
  const size_t keys = (size_t)(N + kWideBK - 1) / kWideBK * kWideBK;
  return sizeof(float) * (2 * (size_t)wide_stage(TQ) + (size_t)TQ * kWideLdS + TQ + kWideBK +
                          kWideWarps * 16 + 2 * kWideWarps * kFastJobs) +
         (store ? keys * 2 * TQ : 0);
}

// One logit as the CUDA-core body sums it: q * scale in f32, then one FMA
// chain over the C channels in order, the rows read from device memory.
__device__ __forceinline__ float chain_logit(const float* q_row, const float* k_row, int C,
                                             float scale) {
  float acc = 0.f;
  for (int c = 0; c < C; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(q_row + c);
    const float4 y = *reinterpret_cast<const float4*>(k_row + c);
    acc = fmaf(x.x * scale, y.x, acc);
    acc = fmaf(x.y * scale, y.y, acc);
    acc = fmaf(x.z * scale, y.z, acc);
    acc = fmaf(x.w * scale, y.w, acc);
  }
  return acc;
}

template <bool STORE, int NC>
__global__ void __launch_bounds__(kWideWarps * 32, 1)
    rows_attention_fast_wide_tf32x3_kernel(const F32Args a) {
  constexpr int RB = kWideRB<NC>, TQ = 16 * RB, BK = kWideBK, KC = kWideKC, LS = kWideLdS;
  constexpr int STAGE = wide_stage(TQ);
  static_assert(NC >= 2, "the wide body takes C > 128");
  extern __shared__ __align__(16) float smem_f[];
  float* stage_s = smem_f;             // [2][STAGE]
  float* p_s = stage_s + 2 * STAGE;    // [TQ][LS]: the tile's P (bf16 values, f32 A operands)
  float* wq_s = p_s + TQ * LS;         // [TQ]: kNearF32 2^-24 |q|, -inf past N
  float* nk_s = wq_s + TQ;             // [BK]: the tile's |k|
  float* red_s = nk_s + BK;            // [kWideWarps][16]: row max, then row sum
  unsigned* job_s = reinterpret_cast<unsigned*>(red_s + kWideWarps * 16);  // [warps][kFastJobs]
  float* res_s = reinterpret_cast<float*>(job_s + kWideWarps * kFastJobs);  // their logits
  unsigned* lg_s = reinterpret_cast<unsigned*>(res_s + kWideWarps * kFastJobs);  // STORE

  const int N = a.N, C = a.C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const Block b = block_of<TQ>(N, 0);
  const float* q_base = a.q + b.r * a.qs.r + b.h * a.qs.h;
  const float* k_base = a.k + b.r * a.ks.r + b.h * a.ks.h;
  const float* v_base = a.v + b.r * a.vs.r + b.h * a.vs.h;
  const float* mask_row = a.mask + (long long)b.r * N;
  const int tiles = (N + BK - 1) / BK;
  // stages: pass 0 a tile's NC chunks of Q and K; STORE pass 2 a tile's NC
  // chunks of V; else pass 1 as pass 0, and pass 2 a tile's Q and K chunks,
  // then its V chunks
  const int qk = tiles * NC;
  const int stages = STORE ? 2 * qk : 4 * qk;
  // this warp's piece of a tile's S: row block rb_w, keys key_w + [0, 8 RB);
  // accumulator e of n-tile n: row row_a + 8 (e >> 1), key key_w + 8 n + 2 t4
  // + (e & 1)
  const int rb_w = warp % RB, key_w = (warp / RB) * RB * 8;
  const int row_a = rb_w * 16 + g;
  unsigned* lg_w = lg_s + warp * tiles * 2 * RB * 32 + lane;  // this thread's words
  unsigned* job_w = job_s + warp * kFastJobs;
  float* res_w = res_s + warp * kFastJobs;

  auto issue = [&](int s) {
    float* buf = stage_s + (s & 1) * STAGE;
    int u = s, per = NC;
    bool v_chunk = false;
    if (STORE) {
      v_chunk = s >= qk;
      u = v_chunk ? s - qk : s;
    } else if (s < 2 * qk) {
      u = s < qk ? s : s - qk;
    } else {
      u = s - 2 * qk;
      per = 2 * NC;
    }
    const int t = u / per;
    int c = u - t * per;
    if (c >= NC) {
      v_chunk = true;
      c -= NC;
    }
    const int c0 = c * KC;
    if (v_chunk) {
      stage_f32(v_base + c0, a.vs.n, t * BK, BK, N, C - c0, KC, kWideLdV, buf);
    } else {
      stage_f32(q_base + c0, a.qs.n, b.q0, TQ, N, C - c0, KC, kWideLdQK, buf);
      stage_f32(k_base + c0, a.ks.n, t * BK, BK, N, C - c0, KC, kWideLdQK,
                buf + TQ * kWideLdQK);
    }
  };
  // The start of stage s: its copies landed (and q scaled) for the block,
  // the next stage's in flight.
  auto begin = [&](int s, bool q_chunk, int c0) -> const float* {
    if (s + 1 < stages) issue(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    float* buf = stage_s + (s & 1) * STAGE;
    if (q_chunk && a.scale != 1.f)  // the pre-scaled q, by the threads that copied it
      scale_staged_f32(buf, b.q0, TQ, N, C - c0, KC, kWideLdQK, a.scale);
    __syncthreads();
    return buf;
  };
  // S of key tile t over the chunks (stages s to s + NC) into sacc, each
  // key's |k| into nk_s (first: each query's window into wq_s too), four
  // threads a row, 32 channels of a chunk each; published by the last
  // chunk's barrier.
  auto logits = [&](int& s, int t, bool first, float (&sacc)[RB][4]) {
#pragma unroll
    for (int n = 0; n < RB; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
    float kk = 0.f, qq = 0.f;
#pragma unroll 1
    for (int j = 0; j < NC; ++j, ++s) {
      const float* buf = begin(s, true, j * KC);
      const float* k_row = buf + (TQ + (tid >> 2)) * kWideLdQK + (tid & 3) * 4;
      const float* q_row = buf + (tid >> 2) * kWideLdQK + (tid & 3) * 4;
#pragma unroll
      for (int i = 0; i < KC / 16; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(k_row + 16 * i);
        kk = fmaf(x.x, x.x, fmaf(x.y, x.y, fmaf(x.z, x.z, fmaf(x.w, x.w, kk))));
        if (first && tid < 4 * TQ) {
          const float4 y = *reinterpret_cast<const float4*>(q_row + 16 * i);
          qq = fmaf(y.x, y.x, fmaf(y.y, y.y, fmaf(y.z, y.z, fmaf(y.w, y.w, qq))));
        }
      }
      logits_tf32<RB, KC, true>(buf + rb_w * 16 * kWideLdQK, buf + (TQ + key_w) * kWideLdQK,
                                kWideLdQK, lane, sacc);
      if (j == NC - 1) {
        kk += __shfl_xor_sync(kFull, kk, 1);
        kk += __shfl_xor_sync(kFull, kk, 2);
        if ((tid & 3) == 0) nk_s[tid >> 2] = sqrtf(kk);
        if (first) {
          qq += __shfl_xor_sync(kFull, qq, 1);
          qq += __shfl_xor_sync(kFull, qq, 2);
          if ((tid & 3) == 0 && tid < 4 * TQ)
            wq_s[tid >> 2] = b.q0 + (tid >> 2) < N ? kNearF32 * 0x1p-24f * sqrtf(qq) : neg_inf();
        }
      }
      __syncthreads();  // the stage after next overwrites this buffer
    }
  };
  // K1 fast's rounded logits of key tile t in place: -inf past N, -2^15 at
  // masked keys, a kept logit within the window recomputed by chain_logit
  // (one at a time, selected back into its register), each rounded to bf16.
  auto round_logits = [&](int t, float (&sacc)[RB][4]) {
    unsigned near = 0;
#pragma unroll
    for (int n = 0; n < RB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = key_w + n * 8 + 2 * t4 + (e & 1), key = t * BK + j;
        float l = sacc[n][e];
        if (key >= N) {
          l = neg_inf();
        } else if (mask_row[key] < 0.5f) {
          l = kMaskFill;
        } else if (near_bf16_midpoint_f32(l, wq_s[row_a + 8 * (e >> 1)] * nk_s[j])) {
          near |= 1u << (4 * n + e);
        }
        sacc[n][e] = l;
      }
    }
    // the warp's window logits as a list of jobs (owner lane, accumulator),
    // numbered by a scan over the lanes and taken kFastJobs at a time, one
    // chain a lane, so that no lane runs more than its share of the chains
    const int count = __popc(near);
    int first = count;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(kFull, first, d);
      if (lane >= d) first += x;
    }
    const int total = __shfl_sync(kFull, first, 31);
    first -= count;  // this lane's first job
    for (int w0 = 0; w0 < total; w0 += kFastJobs) {
      unsigned m = near;
      for (int j = first; m; ++j, m &= m - 1)
        if (j >= w0 && j < w0 + kFastJobs) job_w[j - w0] = (unsigned)(lane << 4 | (__ffs(m) - 1));
      __syncwarp();
      if (w0 + lane < total) {
        const unsigned job = job_w[lane];
        const int owner = job >> 4, i = job & 15, n = i >> 2, e = i & 3;
        const int row = b.q0 + rb_w * 16 + (owner >> 2) + 8 * (e >> 1);
        const int key = t * BK + key_w + n * 8 + 2 * (owner & 3) + (e & 1);
        res_w[lane] = chain_logit(q_base + (long long)row * a.qs.n,
                                  k_base + (long long)key * a.ks.n, C, a.scale);
      }
      __syncwarp();
      m = near;
      for (int j = first; m; ++j, m &= m - 1) {
        if (j < w0 || j >= w0 + kFastJobs) continue;
        const int i = __ffs(m) - 1;
        const float l = res_w[j - w0];
#pragma unroll
        for (int jj = 0; jj < 4 * RB; ++jj)
          if (jj == i) sacc[jj >> 2][jj & 3] = l;
      }
      __syncwarp();  // the next window's jobs overwrite this one's
    }
#pragma unroll
    for (int n = 0; n < RB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = bf16_round(sacc[n][e]);
  };
  // e = bf16(exp(bf16(l - m))) in place, summed into the rows' partial sums
  auto exp_rows = [&](float (&x)[RB][4], float m_a, float m_b, float& s_a, float& s_b) {
#pragma unroll
    for (int n = 0; n < RB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[n][e] = bf16_round(expf(bf16_round(x[n][e] - (e < 2 ? m_a : m_b))));
        (e < 2 ? s_a : s_b) += x[n][e];
      }
    }
  };
  auto put_words = [&](int t, const float (&x)[RB][4]) {
#pragma unroll
    for (int n = 0; n < RB; ++n) {
      lg_w[(t * 2 * RB + 2 * n) * 32] = pack_bf16(x[n][0], x[n][1]);
      lg_w[(t * 2 * RB + 2 * n + 1) * 32] = pack_bf16(x[n][2], x[n][3]);
    }
  };
  auto get_words = [&](int t, float (&x)[RB][4]) {
#pragma unroll
    for (int n = 0; n < RB; ++n) {
      const unsigned u = lg_w[(t * 2 * RB + 2 * n) * 32], w = lg_w[(t * 2 * RB + 2 * n + 1) * 32];
      x[n][0] = __uint_as_float(u << 16);
      x[n][1] = __uint_as_float(u & 0xffff0000u);
      x[n][2] = __uint_as_float(w << 16);
      x[n][3] = __uint_as_float(w & 0xffff0000u);
    }
  };
  // the rows' values (rows row_a and row_a + 8 of the row block) reduced
  // over the row block's warps through red_s, in warp order; MAX or sum
  auto rows_reduce = [&](float& x_a, float& x_b, bool max) {
    if (t4 == 0) {
      red_s[warp * 16 + g] = x_a;
      red_s[warp * 16 + g + 8] = x_b;
    }
    __syncthreads();
    x_a = max ? neg_inf() : 0.f;
    x_b = x_a;
    for (int w = rb_w; w < kWideWarps; w += RB) {
      x_a = max ? fmaxf(x_a, red_s[w * 16 + g]) : x_a + red_s[w * 16 + g];
      x_b = max ? fmaxf(x_b, red_s[w * 16 + g + 8]) : x_b + red_s[w * 16 + g + 8];
    }
    __syncthreads();  // red_s is written again by the next reduction
  };

  issue(0);
  cp_async_commit();  // stage 0 a group of its own: begin(0) waits for it
  int s = 0;
  // pass 0: the rounded logits' row max (STORE: the logits kept)
  float m_a = neg_inf(), m_b = neg_inf();
  for (int t = 0; t < tiles; ++t) {
    float x[RB][4];
    logits(s, t, t == 0, x);
    round_logits(t, x);
#pragma unroll
    for (int n = 0; n < RB; ++n) {
      m_a = fmaxf(m_a, fmaxf(x[n][0], x[n][1]));
      m_b = fmaxf(m_b, fmaxf(x[n][2], x[n][3]));
    }
    if (STORE) put_words(t, x);
  }
  m_a = quad_max(m_a);
  m_b = quad_max(m_b);
  rows_reduce(m_a, m_b, true);

  // pass 1: s = bf16(sum of e) (STORE: e kept in place of the logits)
  float s_a = 0.f, s_b = 0.f;
  for (int t = 0; t < tiles; ++t) {
    float x[RB][4];
    if (STORE) {
      get_words(t, x);
    } else {
      logits(s, t, false, x);
      round_logits(t, x);
    }
    exp_rows(x, m_a, m_b, s_a, s_b);
    if (STORE) put_words(t, x);
  }
  s_a = quad_sum(s_a);
  s_b = quad_sum(s_b);
  rows_reduce(s_a, s_b, false);
  s_a = bf16_round(s_a);
  s_b = bf16_round(s_b);

  // pass 2: p = bf16(e / s) into p_s, acc += P V chunk by chunk of V
  float acc[NC][2][RB][4];  // chunk, n-tile (2 warp, 2 warp + 1), row block, fragment
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int rb = 0; rb < RB; ++rb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][n][rb][e] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    float x[RB][4];
    if (STORE) {
      get_words(t, x);
    } else {
      float unused_a = 0.f, unused_b = 0.f;
      logits(s, t, false, x);
      round_logits(t, x);
      exp_rows(x, m_a, m_b, unused_a, unused_b);
    }
    // the previous tile's last V stage's barrier: every warp is past its
    // reads of p_s
#pragma unroll
    for (int n = 0; n < RB; ++n) {
      const int col = key_w + n * 8 + 2 * t4;
      *reinterpret_cast<float2*>(p_s + row_a * LS + col) =
          make_float2(bf16_round(__fdiv_rn(x[n][0], s_a)), bf16_round(__fdiv_rn(x[n][1], s_a)));
      *reinterpret_cast<float2*>(p_s + (row_a + 8) * LS + col) =
          make_float2(bf16_round(__fdiv_rn(x[n][2], s_b)), bf16_round(__fdiv_rn(x[n][3], s_b)));
    }
#pragma unroll
    for (int c = 0; c < NC; ++c, ++s) {
      const float* v_t = begin(s, false, 0);  // its barrier also publishes P
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
          const unsigned ap[4] = {__float_as_uint(p_s[at]), __float_as_uint(p_s[at + 8 * LS]),
                                  __float_as_uint(p_s[at + 4]),
                                  __float_as_uint(p_s[at + 8 * LS + 4])};
#pragma unroll
          for (int n = 0; n < 2; ++n) {  // p v_small + p v_big into a fresh fragment
            float f[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32_1688(f, ap, bs[n][0], bs[n][1]);
            mma_tf32_1688(f, ap, bb[n][0], bb[n][1]);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[c][n][rb][i] += f[i];
          }
        }
      }
      __syncthreads();  // the stage after next overwrites this buffer
    }
  }

#pragma unroll
  for (int rb = 0; rb < RB; ++rb) {
    const int row = b.q0 + rb * 16 + g;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int ch = c * KC + (2 * warp + n) * 8 + 2 * t4;
        if (ch >= C) continue;
        if (row < N)
          *reinterpret_cast<float2*>(a.out + (((long long)b.r * N + row) * a.H + b.h) * C + ch) =
              make_float2(acc[c][n][rb][0], acc[c][n][rb][1]);
        if (row + 8 < N)
          *reinterpret_cast<float2*>(a.out + (((long long)b.r * N + row + 8) * a.H + b.h) * C +
                                     ch) = make_float2(acc[c][n][rb][2], acc[c][n][rb][3]);
      }
    }
  }
}

template <int NC>
cudaError_t launch(const F32Args& a, cudaStream_t stream) {
  constexpr int RB = kWideRB<NC>;
  const size_t stored = fast_wide_smem(RB, a.N, true);
  if (stored <= 227 * 1024)
    return launch_f32(rows_attention_fast_wide_tf32x3_kernel<true, NC>, kWideWarps * 32, 16 * RB,
                      stored, a, stream);
  return launch_f32(rows_attention_fast_wide_tf32x3_kernel<false, NC>, kWideWarps * 32, 16 * RB,
                    fast_wide_smem(RB, a.N, false), a, stream);
}

}  // namespace

extern "C" {

// K1 fast in f32 on the tensor cores (3xTF32 logits, P.V in two TF32
// products): masked attention without bias, the softmax rounded as bf16.
// C a multiple of 4 in (128, 1024].
int prd_rows_attention_fast_wide_tf32x3(const void* q, const void* k, const void* v,
                                        const void* mask, void* out, int R, int N, int H, int C,
                                        float scale, long long q_sr, long long q_sn,
                                        long long q_sh, long long k_sr, long long k_sn,
                                        long long k_sh, long long v_sr, long long v_sn,
                                        long long v_sh, void* stream) {
  const F32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(mask), nullptr,
                  static_cast<float*>(out), nullptr, nullptr, R, N, H, C, scale,
                  {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh}, {v_sr, v_sn, v_sh}, false};
  if (!f32_operands_ok(a, 4) || C <= 128 || C > 1024 || mask == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 256) return (int)launch<2>(a, s);
  if (C <= 512) return (int)launch<4>(a, s);
  if (C <= 768) return (int)launch<6>(a, s);
  return (int)launch<8>(a, s);
}

}  // extern "C"
