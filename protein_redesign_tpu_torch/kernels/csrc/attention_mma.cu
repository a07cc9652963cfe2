// Hand-written Hopper (sm_90a) tensor-core bodies of five attention kernels,
// for bf16 inputs with a head width that is a multiple of 8, and for K1, K1
// fast, K3 and K5 any multiple of 4. They replace, for those inputs, the
// CUDA-core bodies of attention.cu and attention_kchunk.cu (kept there for
// K2 at C = 4 mod 8 and callable to time them; in float32 these kernels take
// attention_tf32.cu and its wide siblings):
//
//   tiled_attention_mma_kernel    <- _tiled_attention_impl / _attn_kernel and
//                                    _attn_kernel_nomask (K2: single attention
//                                    and SPAttention, additive [R,H,N,N] bias,
//                                    key mask optional)
//   rows_attention_fast_mma_kernel <- _rows_attention_impl with fast=True
//                                    (K1 fast: triangle attention with the
//                                    softmax rounded as bf16, cfg.fast_softmax)
//   rows_attention_mma_kernel     <- _rows_attention_impl / _make_rowhead_kernel
//                                    (K1: triangle attention, key mask, no bias)
//   rows_attention_kchunk_mma_kernel <- _rows_attention_kchunk_grid_cn /
//     <STATS = false>                _make_rowhead_kchunk_grid_cn_kernel (K3: K1's
//                                    function by online softmax, N >= 2048)
//   rows_attention_kchunk_mma_kernel <- _kchunk_grid_cn_stats_call /
//     <STATS = true>                 _make_rowhead_kchunk_grid_cn_stats_kernel (K5:
//                                    K3 plus the row max m and log s, the
//                                    training forward)
//
// of protein_redesign_tpu/ops/pallas_attention.py. The building blocks they
// share with K7's tensor-core body (attention_bwd_mma.cu) are in
// attention_mma.cuh.
//
// What bounds them. At the main path's shapes the work is small matrix
// products (head width 16: one mma depth step) around a softmax, so the
// CUDA-core bodies were bound by issue rate: f32 FMAs from shared memory,
// ~0.5% of the card. Here every product runs on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 sums): a warp owns 16 query rows,
// its Q fragments are loaded by ldmatrix from a tile staged once, K and V
// tiles are staged by cp.async, double-buffered, and shared by the block's
// 4 warps (64 queries). What remains on the CUDA cores is the softmax's
// elementwise work (exp, the bf16 roundings of K1 fast, the division), which
// bounds K1 fast; K2 at head width 16 reads mostly its bias, which it reads
// once, straight into the logit fragments.
//
// K2 takes one pass of online softmax in f32 over 64-key tiles (32 or 16
// for wide heads): S = Q K^T by mma, plus the bias, the -2^15 fill at masked
// keys (after the bias, as the reference does), -inf past N; running max m
// and sum l per row; p = exp(S - m) rounded to bf16 in registers is P.V's A
// fragment. The reference rounds the normalised probabilities instead, so
// the two differ by bf16 roundings (held to 2e-2). A fully masked row has
// all logits -2^15 and gives the mean of v. Wide heads (SPAttention's C =
// single_dim = 512) are split over C: grid.z takes 64-channel slices of the
// output, each block recomputing the logits over the full C, so no block
// holds more than 64 output channels per row in registers.
//
// K1 fast keeps its function point by point (rows_attention_fast_reference):
// logits rounded to bf16 after the fill; m = the max of those; e =
// bf16(exp(bf16(l - m))); s = bf16(sum of e in f32); p = bf16(e / s); P.V in
// f32. Per-term rounding against the final max needs the final max, so it
// makes three passes over 32-key tiles (max; sum; p and P.V), each
// computing Q K^T by mma; the bf16 p enters the P.V mma exactly. The logits'
// f32 sums run in another order than the plain einsum's, so a logit that
// lies next to a bf16 rounding midpoint could round the other way, and with a
// logit of |l| ~ 8 one such flip moves p by 3%. So a logit within kNear f32
// ulps of a midpoint is recomputed as the CUDA-core body computed it, one
// f32 FMA chain over the channels in order (the plain einsum's f32 sums agree
// with it bit for bit at these widths); about 1 logit in 512 takes that path,
// one at a time through one copy of the chain, apart from the elementwise loop.
// What can still differ is the f32 sum of e, so the kernel is held to 2e-2
// and not to bit equality.
//
// K3 keeps the function of its plain version (_kchunk_forward_block): f32
// logits of the pre-scaled q, -2^15 at masked keys, -inf past N, a running
// max from -inf, p = exp(l - m') in f32 summed into s and rounded to bf16
// only for P.V, acc rescaled by exp(m - m'), out = acc / s at the end: K2's
// one pass without the bias. K1 keeps the Pallas body's (softmax of the f32
// logits, probs.astype(v.dtype), P.V in f32): pass 1 takes the row max and
// sum online, pass 2 recomputes the logits and rounds p = exp(l - m) / s to
// bf16 for P.V, the same normalised P that K7's backward recomputes. Both
// take exp as exp2(l log2 e - m log2 e), one FFMA and one SFU op per logit
// (f32 ulps from expf, before the bf16 rounding). At head width 16 the
// products are one mma depth step, so the per-logit elementwise work sets
// the pace: the exp (16 per SM and clock), then about five f32 operations;
// the key tile's mask is read once per warp by ballot, and a tile whose keys
// are all kept skips the fill. The passes are latency-bound, so the warps
// in flight set the pace: launch bounds cap the registers to fit 24 warps a
// SM (kRowsMinBlocks; uncapped, ~130 registers fit only 12, and the passes
// ran markedly slower). K3 takes 128 queries per block up to C = 128 (a (row,
// head)'s K and V are read from L2 once per query tile; on the H100 at
// N = 2048, C = 16 it ran 20.08 ms against 22.03 at 64), 64 above (shared
// memory). K5 is K3's body with STATS: at the end one lane a row writes m
// (the running max) and log s, f32 [R, H, N], kept split; its output is
// K3's bit for bit. A fully masked row gets m = -2^15 and log s = log N.
//
// Head widths C = 4 mod 8 (K1, K1 fast, K3, K5: the NARROW instantiations).
// A head of 36 bf16 is 72 bytes, so in an [R, N, H, C] tensor every other
// head and row starts on 8 bytes, not 16: those instantiations stage Q, K
// and V in 8-byte pieces of 4 channels (cp.async.ca with an 8-byte size and
// zero fill past N; 8-byte loads for the pre-scaled Q tile). A piece lies
// wholly inside C or wholly past it. The K and V buffers' channels past C
// are zeroed once a block (zero_tails) and never copied to: each tile
// copies only its pieces inside C, a thread stepping through them without
// a division, which keeps the extra copies of a latency-bound pass cheap.
// So the head is padded in shared memory to CP with exact zeros as at C a
// multiple of 8, and the shared tiles, the products and the stores are the
// same code. K1 fast's near-midpoint chain sums the C real channels in
// order and stops there (logit_chain). The multiple-of-8 instantiations
// (NARROW false) are the code they were.
//
// Layout: q, k, v are [R, N, H, C] bf16 with the head dimension contiguous,
// the other strides given in elements, every row 16-byte aligned (C and the
// strides multiples of 8), or at C = 4 mod 8 in K1, K1 fast, K3 and K5
// 8-byte aligned (the strides multiples of 4), checked by the wrapper and
// the entry points; mask is contiguous f32 [R, N]; bias contiguous bf16
// [R, H, N, N]; out contiguous [R, N, H, C].
// Shared memory: 2 (TQ + 2 BK) (CP + 8) + 4 BK (CS + 8) bytes, TQ the block's
// queries (64; K3 and K5 128 up to CP = 128, else 64), CP = C rounded up to
// 16, CS the 16..64-channel slice; at most 227 KB bounds C.
// Each entry point returns cudaGetLastError() after its launch.


#include "attention_mma.cuh"

namespace {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// True when x lies within kNear f32 ulps of a midpoint between two bf16
// values, where the order of an f32 sum can decide its bf16 rounding.
constexpr unsigned kNear = 64;
__device__ __forceinline__ bool near_bf16_midpoint(float x) {
  return (__float_as_uint(x) & 0xffffu) - (0x8000u - kNear) <= 2 * kNear;
}

// One logit as a chain of f32 FMAs over the C channels in order, from the
// staged rows (16-byte aligned): 8 channels per pair of 16-byte loads, and
// at C = 4 mod 8 (NARROW) the last 4 by a pair of 8-byte loads, so the
// chain stops at channel C - 1 and no padded zero enters it.
template <bool NARROW>
__device__ __forceinline__ float logit_chain(const bf16* q_row, const bf16* k_row, int C) {
  float acc = 0.f;
  const int c8 = NARROW ? C - 4 : C;
  for (int c = 0; c < c8; c += 8) {
    const uint4 qv = *reinterpret_cast<const uint4*>(q_row + c);
    const uint4 kv = *reinterpret_cast<const uint4*>(k_row + c);
    const bf16* qe = reinterpret_cast<const bf16*>(&qv);
    const bf16* ke = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
    for (int t = 0; t < 8; ++t) acc = fmaf(__bfloat162float(qe[t]), __bfloat162float(ke[t]), acc);
  }
  if (NARROW) {
    const uint2 qv = *reinterpret_cast<const uint2*>(q_row + c8);
    const uint2 kv = *reinterpret_cast<const uint2*>(k_row + c8);
    const bf16* qe = reinterpret_cast<const bf16*>(&qv);
    const bf16* ke = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
    for (int t = 0; t < 4; ++t) acc = fmaf(__bfloat162float(qe[t]), __bfloat162float(ke[t]), acc);
  }
  return acc;
}

// A NARROW kernel's K and V buffers (two tiles of BK rows each, CP and CS
// channels, rows CP + 8 and CS + 8 long) past C, zeroed once: the padded
// channels of every tile its passes stage.
template <int BK, int CS>
__device__ __forceinline__ void zero_tails(int C, const Block& b, int CP, bf16* k_s, bf16* v_s) {
  zero_tail(k_s, 2 * BK, C, CP, CP + 8);
  if (C - b.cs0 < CS) zero_tail(v_s, 2 * BK, C - b.cs0, CS, CS + 8);
}

template <bool HAS_MASK, int BK, int NT>
__global__ void __launch_bounds__(kWarps * 32) tiled_attention_mma_kernel(const Args a) {
  constexpr int NS = BK / 8;  // n-tiles of 8 keys in a key tile
  constexpr int CS = 8 * NT;  // output channels of the block's slice
  constexpr int VS = CS + 8;  // V tile row stride
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = a.N, C = a.C;
  const int CP = (C + 15) & ~15, QS = CP + 8;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kTQ][QS]
  bf16* k_s = q_s + kTQ * QS;                      // [2][BK][QS]
  bf16* v_s = k_s + 2 * BK * QS;                   // [2][BK][VS]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Block b = block_of(N, CS);
  const bf16* k_base = a.k + b.r * a.ks.r + b.h * a.ks.h;
  const bf16* v_base = a.v + b.r * a.vs.r + b.h * a.vs.h;
  const float* mask_row = HAS_MASK ? a.mask + (long long)b.r * N : nullptr;
  const bf16* bias_head = a.bias + ((long long)b.r * a.H + b.h) * N * N;

  stage_q(a, a.q + b.r * a.qs.r + b.h * a.qs.h, b.q0, CP, QS, q_s);
  const int tiles = (N + BK - 1) / BK;
  stage_keys(k_base, a.ks.n, 0, BK, N, C, 0, CP, QS, k_s);
  stage_keys(v_base, a.vs.n, 0, BK, N, C, b.cs0, CS, VS, v_s);
  cp_async_commit();

  const int row_a = b.q0 + warp * 16 + (lane >> 2);  // this thread's rows: row_a, row_a + 8
  const bf16* bias_a = bias_head + (long long)row_a * N;
  const bf16* bias_b = bias_a + 8LL * N;
  float m_a = neg_inf(), m_b = neg_inf(), l_a = 0.f, l_b = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      stage_keys(k_base, a.ks.n, (t + 1) * BK, BK, N, C, 0, CP, QS, k_s + (buf ^ 1) * BK * QS);
      stage_keys(v_base, a.vs.n, (t + 1) * BK, BK, N, C, b.cs0, CS, VS,
                 v_s + (buf ^ 1) * BK * VS);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[NS][4];
    logits_mma<NS>(q_s + warp * 16 * QS, k_s + buf * BK * QS, QS, CP, lane, s);
    // bias, then the fill at masked keys; keys past N drop out
    const int k0 = t * BK;
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + n * 8 + (lane & 3) * 2 + e;
        float la = neg_inf(), lb = neg_inf();
        if (j < N) {
          la = s[n][e] + (row_a < N ? __bfloat162float(bias_a[j]) : 0.f);
          lb = s[n][2 + e] + (row_a + 8 < N ? __bfloat162float(bias_b[j]) : 0.f);
          if (HAS_MASK && mask_row[j] < 0.5f) la = lb = kMaskFill;
        }
        s[n][e] = la;
        s[n][2 + e] = lb;
        mx_a = fmaxf(mx_a, la);
        mx_b = fmaxf(mx_b, lb);
      }
    }
    // one step of online softmax: the tile always holds key k0 < N, so the
    // new max is finite and the first step's rescale is exp(-inf) = 0
    mx_a = quad_max(mx_a);
    mx_b = quad_max(mx_b);
    const float alpha_a = expf(m_a - mx_a), alpha_b = expf(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    l_a *= alpha_a;
    l_b *= alpha_b;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha_a;
      acc[n][1] *= alpha_a;
      acc[n][2] *= alpha_b;
      acc[n][3] *= alpha_b;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = expf(s[n][0] - m_a);
      s[n][1] = expf(s[n][1] - m_a);
      s[n][2] = expf(s[n][2] - m_b);
      s[n][3] = expf(s[n][3] - m_b);
      l_a += s[n][0] + s[n][1];
      l_b += s[n][2] + s[n][3];
    }
    pv_mma<NS, NT>(s, v_s + buf * BK * VS, VS, lane, acc);
    __syncthreads();  // the next iteration's loads overwrite this buffer
  }
  store_out<NT>(a, b, row_a, acc, quad_sum(l_a), quad_sum(l_b), lane);
}

// K1 fast's per-row state across its passes, for this thread's two rows
// (g and g + 8 of the warp's 16: _a and _b).
template <int NT>
struct FastRows {
  float m_a, m_b, s_a, s_b;
  float acc[NT][4];
};

// One of K1 fast's passes over every key tile (PASS 0: the row max of the
// bf16 logits; 1: the sum of their rounded exp; 2: p and P.V), each its own
// instantiation, so a pass's unrolled loop holds only its own arithmetic.
// NARROW: C = 4 mod 8 (stage_keys, logit_chain).
template <int PASS, int BK, int NT, bool NARROW>
__device__ __forceinline__ void fast_pass(const Args& a, const Block& b, const bf16* q_w,
                                          bf16* k_s, bf16* v_s, int CP, FastRows<NT>& st,
                                          int lane) {
  constexpr int NS = BK / 8, CS = 8 * NT, VS = CS + 8;
  const int N = a.N, C = a.C, QS = CP + 8;
  const bf16* k_base = a.k + b.r * a.ks.r + b.h * a.ks.h;
  const bf16* v_base = a.v + b.r * a.vs.r + b.h * a.vs.h;
  const float* mask_row = a.mask + (long long)b.r * N;
  const int tiles = (N + BK - 1) / BK;
  stage_keys<NARROW>(k_base, a.ks.n, 0, BK, N, C, 0, CP, QS, k_s);
  if (PASS == 2) stage_keys<NARROW>(v_base, a.vs.n, 0, BK, N, C, b.cs0, CS, VS, v_s);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < tiles) {
      stage_keys<NARROW>(k_base, a.ks.n, (t + 1) * BK, BK, N, C, 0, CP, QS,
                         k_s + (buf ^ 1) * BK * QS);
      if (PASS == 2)
        stage_keys<NARROW>(v_base, a.vs.n, (t + 1) * BK, BK, N, C, b.cs0, CS, VS,
                           v_s + (buf ^ 1) * BK * VS);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* k_t = k_s + buf * BK * QS;
    float s[NS][4];
    logits_mma<NS>(q_w, k_t, QS, CP, lane, s);
    // this thread's key columns: their mask values, loaded together up front
    const int k0 = t * BK + (lane & 3) * 2;
    bool live[NS][2], keep[NS][2];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = k0 + n * 8 + e;
        live[n][e] = j < N;
        keep[n][e] = mask_row[min(j, N - 1)] >= 0.5f;
      }
    }
    // the logits after the fill, -inf past N (weight 0); a bit per logit
    // that lies next to a bf16 rounding midpoint
    unsigned near = 0;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float l = neg_inf();
        if (live[n][e & 1]) {
          l = kMaskFill;
          if (keep[n][e & 1]) {
            l = s[n][e];
            near |= (unsigned)near_bf16_midpoint(l) << (4 * n + e);
          }
        }
        s[n][e] = l;
      }
    }
    // rare: those logits again in the plain version's order, one at a time
    // through one copy of the chain, selected back into their registers
    while (near) {
      const int i = __ffs(near) - 1;
      near &= near - 1;
      const int n = i >> 2, e = i & 3;
      const float l = logit_chain<NARROW>(q_w + ((lane >> 2) + 8 * (e >> 1)) * QS,
                                          k_t + (n * 8 + (lane & 3) * 2 + (e & 1)) * QS, C);
#pragma unroll
      for (int j = 0; j < 4 * NS; ++j)
        if (j == i) s[j >> 2][j & 3] = l;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = bf16_round(s[n][e]);  // the logit rounded to bf16
        if (PASS == 0) {
          s[n][e] = l;
        } else {
          const float ex = bf16_round(expf(bf16_round(l - (e < 2 ? st.m_a : st.m_b))));
          s[n][e] = PASS == 1 ? ex : bf16_round(__fdiv_rn(ex, e < 2 ? st.s_a : st.s_b));
        }
      }
    }
    if (PASS == 0) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        st.m_a = fmaxf(st.m_a, fmaxf(s[n][0], s[n][1]));
        st.m_b = fmaxf(st.m_b, fmaxf(s[n][2], s[n][3]));
      }
    } else if (PASS == 1) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        st.s_a += s[n][0] + s[n][1];
        st.s_b += s[n][2] + s[n][3];
      }
    } else {
      pv_mma<NS, NT>(s, v_s + buf * BK * VS, VS, lane, st.acc);  // p is bf16: exact
    }
    __syncthreads();  // the next tile's loads overwrite this buffer
  }
}

template <int BK, int NT, bool NARROW>
__global__ void __launch_bounds__(kWarps * 32) rows_attention_fast_mma_kernel(const Args a) {
  constexpr int CS = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int CP = (a.C + 15) & ~15, QS = CP + 8;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kTQ * QS;
  bf16* v_s = k_s + 2 * BK * QS;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Block b = block_of(a.N, CS);
  stage_q<kTQ, NARROW>(a, a.q + b.r * a.qs.r + b.h * a.qs.h, b.q0, CP, QS, q_s);
  if constexpr (NARROW) zero_tails<BK, CS>(a.C, b, CP, k_s, v_s);
  const bf16* q_w = q_s + warp * 16 * QS;
  FastRows<NT> st;
  st.m_a = st.m_b = neg_inf();
  st.s_a = st.s_b = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) st.acc[n][0] = st.acc[n][1] = st.acc[n][2] = st.acc[n][3] = 0.f;

  fast_pass<0, BK, NT, NARROW>(a, b, q_w, k_s, v_s, CP, st, lane);
  st.m_a = quad_max(st.m_a);
  st.m_b = quad_max(st.m_b);
  fast_pass<1, BK, NT, NARROW>(a, b, q_w, k_s, v_s, CP, st, lane);
  st.s_a = bf16_round(quad_sum(st.s_a));
  st.s_b = bf16_round(quad_sum(st.s_b));
  fast_pass<2, BK, NT, NARROW>(a, b, q_w, k_s, v_s, CP, st, lane);
  store_out<NT>(a, b, b.q0 + warp * 16 + (lane >> 2), st.acc, 1.f, 1.f, lane);
}

// Blocks of K1 and K3 that must fit on an SM at once, which caps their
// registers: the passes are latency-bound (each 64-key tile waits on its
// copies, its ballots and the exp), so warps in flight set the pace. With
// 64-key tiles: 24 warps a SM (80 registers) for a 16-channel slice, 16
// (128 registers, no spills) for wider ones; shorter tiles (wide heads) are
// left uncapped.
template <int WARPS, int BK, int NT>
constexpr int kRowsMinBlocks = BK < 64 ? 1 : (NT <= 2 ? 24 : 16) / WARPS;

// K3 and K5 in bf16: one pass of online softmax; out = acc / s. WARPS warps
// of 16 queries share each staged K and V tile. STATS (K5) also writes the
// row max m and log s, f32 [R, H, N], kept split; the output is K3's bit for
// bit. NARROW: C = 4 mod 8 (stage_q, stage_keys).
template <bool STATS, int WARPS, int BK, int NT, bool NARROW>
__global__ void __launch_bounds__(WARPS * 32, kRowsMinBlocks<WARPS, BK, NT>)
    rows_attention_kchunk_mma_kernel(const Args a, float* __restrict__ m_out,
                                     float* __restrict__ logs_out) {
  constexpr int TQ = 16 * WARPS, CS = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int CP = (a.C + 15) & ~15, QS = CP + 8;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [TQ][QS]
  bf16* k_s = q_s + TQ * QS;                       // [2][BK][QS]
  bf16* v_s = k_s + 2 * BK * QS;                   // [2][BK][VS]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Block b = block_of<TQ>(a.N, CS);
  stage_q<TQ, NARROW>(a, a.q + b.r * a.qs.r + b.h * a.qs.h, b.q0, CP, QS, q_s);
  if constexpr (NARROW) zero_tails<BK, CS>(a.C, b, CP, k_s, v_s);
  RowsState<NT> st;
  init_rows(st);
  rows_pass<kOnline, BK, NT, NARROW>(a, b, q_s + warp * 16 * QS, k_s, v_s, CP, st, lane);
  const float s_a = quad_sum(st.s_a), s_b = quad_sum(st.s_b);
  const int row_a = b.q0 + warp * 16 + (lane >> 2);
  store_out<NT>(a, b, row_a, st.acc, s_a, s_b, lane);
  if (STATS && (lane & 3) == 0 && b.cs0 == 0) {  // one lane per row, one channel slice
    const long long base = ((long long)b.r * a.H + b.h) * a.N;
    if (row_a < a.N) {
      m_out[base + row_a] = st.m_a;
      logs_out[base + row_a] = logf(s_a);
    }
    if (row_a + 8 < a.N) {
      m_out[base + row_a + 8] = st.m_b;
      logs_out[base + row_a + 8] = logf(s_b);
    }
  }
}

// K1 in bf16: the row max and sum online (pass 1), then the normalised
// probabilities rounded to bf16 times V (pass 2), as the plain version
// rounds softmax(l) before P.V. NARROW: C = 4 mod 8.
template <int BK, int NT, bool NARROW>
__global__ void __launch_bounds__(kWarps * 32, kRowsMinBlocks<kWarps, BK, NT>)
    rows_attention_mma_kernel(const Args a) {
  constexpr int CS = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int CP = (a.C + 15) & ~15, QS = CP + 8;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kTQ * QS;
  bf16* v_s = k_s + 2 * BK * QS;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Block b = block_of(a.N, CS);
  stage_q<kTQ, NARROW>(a, a.q + b.r * a.qs.r + b.h * a.qs.h, b.q0, CP, QS, q_s);
  if constexpr (NARROW) zero_tails<BK, CS>(a.C, b, CP, k_s, v_s);
  const bf16* q_w = q_s + warp * 16 * QS;
  RowsState<NT> st;
  init_rows(st);
  rows_pass<kStats, BK, NT, NARROW>(a, b, q_w, k_s, v_s, CP, st, lane);
  st.s_a = quad_sum(st.s_a);
  st.s_b = quad_sum(st.s_b);
  rows_pass<kNormalized, BK, NT, NARROW>(a, b, q_w, k_s, v_s, CP, st, lane);
  store_out<NT>(a, b, b.q0 + warp * 16 + (lane >> 2), st.acc, 1.f, 1.f, lane);
}

// Keys per tile and 8-channel n-tiles per output slice, by the padded width:
// narrow heads take 64-key tiles and a slice as wide as the head; wide heads
// 64-channel slices and shorter key tiles, to stay within shared memory.
// K1 fast takes 32-key tiles at narrow heads too (launch_fast): its passes
// keep more values live per logit, and shorter tiles fit more blocks on an SM.
int key_tile(int CP) { return CP <= 128 ? 64 : (CP <= 512 ? 32 : 16); }
int slice_tiles(int CP) { return CP <= 16 ? 2 : (CP <= 32 ? 4 : 8); }

size_t smem_bytes(int C, int BK, int TQ = kTQ) {
  const int CP = (C + 15) & ~15;
  const int CS = 8 * slice_tiles(CP);
  return sizeof(bf16) * ((size_t)(TQ + 2 * BK) * (CP + 8) + 2 * (size_t)BK * (CS + 8));
}

constexpr size_t kMaxSmem = 227 * 1024;

// One launch of a kernel whose blocks hold WARPS warps of 16 queries each;
// ``extra`` follows the Args.
template <int WARPS = kWarps, typename Kernel, typename... Extra>
cudaError_t launch_kernel(Kernel kern, int BK, const Args& a, cudaStream_t stream,
                          Extra... extra) {
  constexpr int TQ = 16 * WARPS;
  const int CP = (a.C + 15) & ~15;
  const int CS = 8 * slice_tiles(CP);
  const long long blocks = (long long)((a.N + TQ - 1) / TQ) * a.R;
  const int slices = (a.C + CS - 1) / CS;
  if (blocks > 0x7fffffffLL || slices > 65535) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(a.C, BK, TQ);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((unsigned)blocks, a.H, slices), WARPS * 32, smem, stream>>>(a, extra...);
  return cudaGetLastError();
}

template <bool HAS_MASK>
cudaError_t launch_tiled(const Args& a, cudaStream_t stream) {
  const int CP = (a.C + 15) & ~15;
  if (CP <= 16) return launch_kernel(tiled_attention_mma_kernel<HAS_MASK, 64, 2>, 64, a, stream);
  if (CP <= 32) return launch_kernel(tiled_attention_mma_kernel<HAS_MASK, 64, 4>, 64, a, stream);
  if (CP <= 128) return launch_kernel(tiled_attention_mma_kernel<HAS_MASK, 64, 8>, 64, a, stream);
  if (CP <= 512) return launch_kernel(tiled_attention_mma_kernel<HAS_MASK, 32, 8>, 32, a, stream);
  return launch_kernel(tiled_attention_mma_kernel<HAS_MASK, 16, 8>, 16, a, stream);
}

template <bool NARROW>
cudaError_t launch_fast(const Args& a, cudaStream_t stream) {
  const int CP = (a.C + 15) & ~15;
  if (CP <= 16) return launch_kernel(rows_attention_fast_mma_kernel<32, 2, NARROW>, 32, a, stream);
  if (CP <= 32) return launch_kernel(rows_attention_fast_mma_kernel<32, 4, NARROW>, 32, a, stream);
  if (CP <= 512)
    return launch_kernel(rows_attention_fast_mma_kernel<32, 8, NARROW>, 32, a, stream);
  return launch_kernel(rows_attention_fast_mma_kernel<16, 8, NARROW>, 16, a, stream);
}

template <bool NARROW>
cudaError_t launch_rows(const Args& a, cudaStream_t stream) {
  const int CP = (a.C + 15) & ~15;
  if (CP <= 16) return launch_kernel(rows_attention_mma_kernel<64, 2, NARROW>, 64, a, stream);
  if (CP <= 32) return launch_kernel(rows_attention_mma_kernel<64, 4, NARROW>, 64, a, stream);
  if (CP <= 128) return launch_kernel(rows_attention_mma_kernel<64, 8, NARROW>, 64, a, stream);
  if (CP <= 512) return launch_kernel(rows_attention_mma_kernel<32, 8, NARROW>, 32, a, stream);
  return launch_kernel(rows_attention_mma_kernel<16, 8, NARROW>, 16, a, stream);
}

// K3 or K5 (STATS): 8 warps (128 queries) a block up to CP = 128, 4 above.
template <bool STATS, bool NARROW>
cudaError_t launch_kchunk(const Args& a, cudaStream_t stream, float* m, float* logs) {
  const int CP = (a.C + 15) & ~15;
  if (CP <= 16)
    return launch_kernel<8>(rows_attention_kchunk_mma_kernel<STATS, 8, 64, 2, NARROW>, 64, a,
                            stream, m, logs);
  if (CP <= 32)
    return launch_kernel<8>(rows_attention_kchunk_mma_kernel<STATS, 8, 64, 4, NARROW>, 64, a,
                            stream, m, logs);
  if (CP <= 128)
    return launch_kernel<8>(rows_attention_kchunk_mma_kernel<STATS, 8, 64, 8, NARROW>, 64, a,
                            stream, m, logs);
  if (CP <= 512)
    return launch_kernel<4>(rows_attention_kchunk_mma_kernel<STATS, 4, 32, 8, NARROW>, 32, a,
                            stream, m, logs);
  return launch_kernel<4>(rows_attention_kchunk_mma_kernel<STATS, 4, 16, 8, NARROW>, 16, a,
                          stream, m, logs);
}

// The operands a body takes: rows of q, k and v on 16 bytes (C and the
// strides multiples of 8, 16-byte aligned bases); with ``narrow`` (K1, K1
// fast, K3 and K5) also C = 4 mod 8 with rows on 8 bytes (strides multiples
// of 4, 8-byte aligned bases), which their NARROW instantiations stage.
bool valid(const Args& a, int TQ = kTQ, bool narrow = false) {
  const int piece = narrow && a.C % 8 == 4 ? 4 : 8;  // elements a staging copy moves
  const auto fits = [piece](const Strides& s) {
    return s.r % piece == 0 && s.n % piece == 0 && s.h % piece == 0;
  };
  const unsigned bytes = 2 * piece;
  return a.R > 0 && a.N > 0 && a.H > 0 && a.H <= 65535 && a.C > 0 && a.C % piece == 0 &&
         fits(a.qs) && fits(a.ks) && fits(a.vs) && aligned_to(a.q, bytes) &&
         aligned_to(a.k, bytes) && aligned_to(a.v, bytes) &&
         smem_bytes(a.C, key_tile((a.C + 15) & ~15), TQ) <= kMaxSmem;
}

}  // namespace

extern "C" {

// K2 on the tensor cores (bf16): attention with an additive bias and an
// optional key mask. C a multiple of 8 up to the shared-memory bound.
int prd_tiled_attention_mma(const void* q, const void* k, const void* v, const void* mask,
                            const void* bias, void* out, int R, int N, int H, int C, float scale,
                            long long q_sr, long long q_sn, long long q_sh, long long k_sr,
                            long long k_sn, long long k_sh, long long v_sr, long long v_sn,
                            long long v_sh, void* stream) {
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const float*>(mask),
               static_cast<const bf16*>(bias), static_cast<bf16*>(out), R, N, H, C, scale,
               {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh}, {v_sr, v_sn, v_sh}};
  if (!valid(a) || bias == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(mask != nullptr ? launch_tiled<true>(a, s) : launch_tiled<false>(a, s));
}

// K1 fast on the tensor cores (bf16): masked attention without bias, the
// softmax rounded as bf16. C a multiple of 4 up to the shared-memory bound.
int prd_rows_attention_fast_mma(const void* q, const void* k, const void* v, const void* mask,
                                void* out, int R, int N, int H, int C, float scale,
                                long long q_sr, long long q_sn, long long q_sh, long long k_sr,
                                long long k_sn, long long k_sh, long long v_sr, long long v_sn,
                                long long v_sh, void* stream) {
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const float*>(mask), nullptr,
               static_cast<bf16*>(out), R, N, H, C, scale,
               {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh}, {v_sr, v_sn, v_sh}};
  if (!valid(a, kTQ, true) || mask == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(C % 8 ? launch_fast<true>(a, s) : launch_fast<false>(a, s));
}

// K1 on the tensor cores (bf16): masked attention without bias, softmax in
// f32, the normalised probabilities rounded to bf16 for P.V. C a multiple
// of 4 up to the shared-memory bound.
int prd_rows_attention_mma(const void* q, const void* k, const void* v, const void* mask,
                           void* out, int R, int N, int H, int C, float scale, long long q_sr,
                           long long q_sn, long long q_sh, long long k_sr, long long k_sn,
                           long long k_sh, long long v_sr, long long v_sn, long long v_sh,
                           void* stream) {
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const float*>(mask), nullptr,
               static_cast<bf16*>(out), R, N, H, C, scale,
               {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh}, {v_sr, v_sn, v_sh}};
  if (!valid(a, kTQ, true) || mask == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(C % 8 ? launch_rows<true>(a, s) : launch_rows<false>(a, s));
}

// K3 (m and logs null) or K5 (both given) on the tensor cores (bf16): K1's
// function by one pass of online softmax over key tiles, K5 also writing the
// row max m and log s (f32 [R, H, N]); 128 queries per block up to C = 128
// (a (row, head)'s K and V are read from L2 once per query tile), 64 above it
// (shared memory). C a multiple of 4 up to the shared-memory bound.
int prd_rows_attention_kchunk_mma(const void* q, const void* k, const void* v, const void* mask,
                                  void* out, void* m, void* logs, int R, int N, int H, int C,
                                  float scale, long long q_sr, long long q_sn, long long q_sh,
                                  long long k_sr, long long k_sn, long long k_sh, long long v_sr,
                                  long long v_sn, long long v_sh, void* stream) {
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               static_cast<const bf16*>(v), static_cast<const float*>(mask), nullptr,
               static_cast<bf16*>(out), R, N, H, C, scale,
               {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh}, {v_sr, v_sn, v_sh}};
  const bool wide = ((C + 15) & ~15) > 128;
  if (!valid(a, wide ? 64 : 128, true) || mask == nullptr || (m == nullptr) != (logs == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(logs);
  if (m != nullptr)
    return (int)(C % 8 ? launch_kchunk<true, true>(a, s, mf, lf)
                       : launch_kchunk<true, false>(a, s, mf, lf));
  return (int)(C % 8 ? launch_kchunk<false, true>(a, s, mf, lf)
                     : launch_kchunk<false, false>(a, s, mf, lf));
}

}  // extern "C"
