// Hand-written Hopper (sm_90a) tensor-core bodies of the biased attention
// in float32, for head widths that are a multiple of 8 up to 1024:
//
//   tiled_attention_tf32x3_kernel<HAS_MASK, NT>        (C <= 128)
//   tiled_attention_wide_tf32x3_kernel<HAS_MASK, NC>   (128 < C <= 1024)
//       <- _tiled_attention_impl / _attn_kernel and _attn_kernel_nomask (K2:
//          single attention at C = 16 and SPAttention at C = single_dim,
//          additive [R, H, N, N] bias, key mask optional)
//
// of protein_redesign_tpu/ops/pallas_attention.py. They replace, for those
// widths, the CUDA-core body of attention.cu, kept for C = 4 mod 8 and
// callable to time it beside these.
//
// The function is K2's f32 plain version (attention_reference): per (row,
// head), logits l = (q * scale) k^T in f32, plus the bias in f32, then -2^15
// where mask < 0.5 (after the bias, as the reference does), softmax and P V
// with P left in f32 (the reference's probs.astype(v.dtype) is a no-op in
// f32), the output in f32. Both bodies take one pass of online softmax over
// 64-key tiles: a running max from -inf, p = exp(l - m') summed into s, acc
// rescaled by exp(m - m'), out = acc / s. A fully masked row has every logit
// -2^15 and gives the mean of v.
//
// What bounds them on the card. Every product runs on the tensor cores in
// 3xTF32 (mma_3xtf32, mma.cuh): three TF32 products of split operands,
// within about 2^-21 of the f32 product, at most 495 / 3 = 165 TFLOP/s; one
// TF32 product keeps three decimal digits, which breaks the 1e-5 parity,
// and f32 FMAs on the CUDA cores give 67 TFLOP/s. Each 8-deep step's three
// products go into a fresh fragment that is added to the sum in f32, so a
// logit over C = 1024 channels is a 128-step f32 sum, as the plain einsum's
// is a 1024-step one. At C = 16 the bias dominates the bytes (4 bytes per
// query, key and head against 64 bytes of q, k and v per query): it is read
// once, staged by cp.async a tile ahead. At C = 512 the products bound it.
//
// Narrow heads (C <= 128): the one-pass body of K1, K3 and K5
// (rows_tf32x3_body, attention_tf32.cuh) with the bias: 64 queries a block
// (4 warps of 16 rows; K2 has R = B rows, so short query tiles give more
// blocks), K and V tiles and the [64, BK] bias tile double-buffered by
// cp.async, S and P in registers. The bias is added at the key each S
// accumulator holds (n 8 + 2t + (e & 1)); only P.V renumbers keys.
//
// Wide heads (SPAttention, C = single_dim 512, 768 or 1024 in the wide
// configurations). A warp cannot hold 16 rows of a 512-wide output, nor a
// block its q tile in shared memory (64 rows at C = 1024 are 256 KB). The
// bf16 body splits the output over grid.z in 64-channel slices, each block
// recomputing all of Q K^T, 8x the logit products at C = 512. Here each
// (query tile, key tile) logit is computed once:
//   - a block takes 32 queries (2 row blocks of 16) and 8 warps; per key
//     tile of 64 keys it streams the contraction over C in 128-channel
//     chunks, as a GEMM's K loop: stage j holds chunk j of Q and K, and the
//     warps split the [32, 64] S tile (warp w: row block w & 1, keys (w >> 1)
//     16 + [0, 16)), accumulating over the chunks in registers;
//   - S goes to shared memory; a row pass (8 threads a row) adds the bias
//     tile (staged with chunk 0), applies the fill, takes the online-softmax
//     step and writes P split into its TF32 parts, and the rescale exp(m -
//     m') per row;
//   - then stage NC + c holds chunk c of V, and warp w owns output n-tiles
//     2w and 2w + 1 of every chunk (16 channels of each 128), all 32 rows,
//     in registers across the key tiles: acc = acc exp(m - m') + P V[:, chunk].
// Every stage is one cp.async double-buffered step, so the copies of the
// next chunk (or the next tile's first) land while this one is multiplied.
// Costs per (row, head): products 2 x 2 N^2 C operations in 3xTF32 (S once,
// P V once; the bf16 body's slices take 18 N^2 C at C = 512); device
// memory q, k, v, the bias and out once; from L2, Q once per key tile (N /
// 64 times) and K and V once per query tile (N / 32 times), 40 MB a head at
// N = C = 512. Shared memory: two stage buffers of (32 + 64) (128 + 4)
// floats, and the bias, logits and P's two parts, 32 (64 + 4) floats each:
// 133 KB whatever C is. Registers: the output accumulators, C / 8 a thread
// (128 at C = 1024), so one block of 8 warps a SM.
//
// Layout: q, k, v are [R, N, H, C] f32 with the head dimension contiguous,
// the other strides given in elements, every row 16-byte aligned (C and the
// strides multiples of 4, checked by the wrapper); mask is contiguous f32
// [R, N] or null; bias contiguous f32 [R, H, N, N], staged by 16-byte copies
// where N is a multiple of 4 and by 4-byte ones otherwise; out contiguous
// [R, N, H, C]. The entry point returns cudaGetLastError() after its launch.

#include "attention_tf32.cuh"

namespace {

constexpr int kTiledWarps = 4;  // the narrow body: 64 queries a block

template <bool HAS_MASK, int NT>
__global__ void __launch_bounds__(kTiledWarps * 32, kF32MinBlocks<kTiledWarps, NT>)
    tiled_attention_tf32x3_kernel(const F32Args a) {
  rows_tf32x3_body<false, true, HAS_MASK, kTiledWarps, NT>(a);
}

constexpr int kWideWarps = 8;
constexpr int kWideTQ = 32;                 // queries a block: two row blocks of 16
constexpr int kWideBK = 64;                 // keys a tile
constexpr int kWideKC = 128;                // channels a chunk: two n-tiles a warp
constexpr int kWideLdQK = kWideKC + 4;      // Q and K rows (4 mod 32: conflict-free A, B^T reads)
constexpr int kWideLdV = kWideKC + 8;       // V rows (8 mod 32: conflict-free B reads)
constexpr int kWideLdS = kWideBK + 4;       // bias, logits and P rows
constexpr int kWideStage = (kWideTQ + kWideBK) * kWideLdQK;  // floats a stage (>= 64 kWideLdV)

constexpr size_t wide_smem() {
  return sizeof(float) * (2 * (size_t)kWideStage + 4 * (size_t)kWideTQ * kWideLdS + 2 * kWideTQ);
}

// NC channel chunks of 128 (C <= 128 NC).
template <bool HAS_MASK, int NC>
__global__ void __launch_bounds__(kWideWarps * 32, 1)
    tiled_attention_wide_tf32x3_kernel(const F32Args a) {
  constexpr int TQ = kWideTQ, BK = kWideBK, KC = kWideKC, LS = kWideLdS;
  // a tile's bias is staged by the copies issued at its previous tile's
  // last V chunk, after every thread has passed the first one's barrier
  static_assert(NC >= 2, "the wide body takes C > 128");
  extern __shared__ __align__(16) float smem_f[];
  float* stage_s = smem_f;                   // [2][kWideStage]
  float* bias_s = stage_s + 2 * kWideStage;  // [TQ][LS], the tile's bias
  float* s_s = bias_s + TQ * LS;             // [TQ][LS], the tile's logits
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
  const float* bias_head = a.bias + ((long long)b.r * a.H + b.h) * N * N;
  const float* mask_row = HAS_MASK ? a.mask + (long long)b.r * N : nullptr;
  const int tiles = (N + BK - 1) / BK;
  const int stages = tiles * 2 * NC;

  // Stage s of key tile t = s / (2 NC), j = s % (2 NC): j < NC chunk j of Q
  // and K (with the tile's bias at j = 0), else chunk j - NC of V.
  auto issue = [&](int s) {
    float* buf = stage_s + (s & 1) * kWideStage;
    const int t = s / (2 * NC), j = s - t * 2 * NC;
    if (j < NC) {
      const int c0 = j * KC;
      stage_f32(q_base + c0, a.qs.n, b.q0, TQ, N, C - c0, KC, kWideLdQK, buf);
      stage_f32(k_base + c0, a.ks.n, t * BK, BK, N, C - c0, KC, kWideLdQK,
                buf + TQ * kWideLdQK);
      if (j == 0) stage_bias(bias_head, N, b.q0, TQ, t * BK, BK, LS, a.bias16, bias_s);
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
    float* buf = stage_s + (s & 1) * kWideStage;
    if (q_chunk && a.scale != 1.f)  // the pre-scaled q, by the threads that copied it
      scale_staged_f32(buf, b.q0, TQ, N, C - c0, KC, kWideLdQK, a.scale);
    __syncthreads();
    return buf;
  };

  float acc[NC][2][2][4];  // chunk, n-tile (2 warp, 2 warp + 1), row block, fragment
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int rb = 0; rb < 2; ++rb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][n][rb][e] = 0.f;
  const int row = tid >> 3, part = tid & 7;  // the row pass: 8 threads a row
  float m_run = neg_inf(), l_run = 0.f;

  issue(0);
  cp_async_commit();  // stage 0 a group of its own: begin(0) waits for it
  int s = 0;
  for (int t = 0; t < tiles; ++t) {
    // S = Q K^T over the chunks of C: this warp's row block and 16 keys
    float sacc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
#pragma unroll 1
    for (int j = 0; j < NC; ++j, ++s) {
      const float* buf = begin(s, true, j * KC);
      logits_tf32<2, KC, true>(buf + (warp & 1) * 16 * kWideLdQK,
                               buf + (TQ + (warp >> 1) * 16) * kWideLdQK, kWideLdQK, lane, sacc);
      __syncthreads();  // the stage after next overwrites this buffer
    }
    {
      const int r0 = (warp & 1) * 16 + g, c0 = (warp >> 1) * 16 + 2 * t4;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        *reinterpret_cast<float2*>(s_s + r0 * LS + c0 + n * 8) = make_float2(sacc[n][0], sacc[n][1]);
        *reinterpret_cast<float2*>(s_s + (r0 + 8) * LS + c0 + n * 8) =
            make_float2(sacc[n][2], sacc[n][3]);
      }
    }
    __syncthreads();
    {
      // the row pass: keys part 4 + [0, 4) and 32 + part 4 + [0, 4) of the
      // tile, plus the bias, then the fill; past N -inf (weight 0)
      const int k0 = t * BK;
      float l[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = h * 32 + part * 4;
        const float4 x = *reinterpret_cast<const float4*>(s_s + row * LS + col);
        const float4 y = *reinterpret_cast<const float4*>(bias_s + row * LS + col);
        l[4 * h] = x.x + y.x;
        l[4 * h + 1] = x.y + y.y;
        l[4 * h + 2] = x.z + y.z;
        l[4 * h + 3] = x.w + y.w;
      }
      float mx = neg_inf();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int key = k0 + (i >> 2) * 32 + part * 4 + (i & 3);
        if (key >= N)
          l[i] = neg_inf();
        else if (HAS_MASK && mask_row[key] < 0.5f)
          l[i] = kMaskFill;
        mx = fmaxf(mx, l[i]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      // the tile holds a key below N, so the new max is finite and the
      // first tile's rescale is exp(-inf) = 0
      const float m_new = fmaxf(m_run, mx);
      const float alpha = exp2_approx((m_run - m_new) * kLog2e);
      const float nm = -m_new * kLog2e;
      float sum = 0.f;
      unsigned hi[8], lo[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = exp2_approx(fmaf(l[i], kLog2e, nm));
        sum += p;
        split_tf32(p, hi[i], lo[i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = row * LS + h * 32 + part * 4;
        *reinterpret_cast<uint4*>(p_hi + at) = make_uint4(hi[4 * h], hi[4 * h + 1],
                                                          hi[4 * h + 2], hi[4 * h + 3]);
        *reinterpret_cast<uint4*>(p_lo + at) = make_uint4(lo[4 * h], lo[4 * h + 1],
                                                          lo[4 * h + 2], lo[4 * h + 3]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(kFull, sum, off);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      if (part == 0) alpha_s[row] = alpha;
    }
    // acc = acc exp(m - m') + P V, chunk by chunk of V's channels
#pragma unroll
    for (int c = 0; c < NC; ++c, ++s) {
      const float* v_t = begin(s, false, 0);
#pragma unroll
      for (int rb = 0; rb < 2; ++rb) {
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
        for (int rb = 0; rb < 2; ++rb) {
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

  if (part == 0) l_s[row] = l_run;
  __syncthreads();
#pragma unroll
  for (int rb = 0; rb < 2; ++rb) {
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

template <bool HAS_MASK, int NT>
cudaError_t launch_narrow(const F32Args& a, cudaStream_t stream) {
  return launch_f32(tiled_attention_tf32x3_kernel<HAS_MASK, NT>, kTiledWarps * 32,
                    16 * kTiledWarps, rows_tf32x3_smem<kTiledWarps, NT, true>(), a, stream);
}

template <bool HAS_MASK, int NC>
cudaError_t launch_wide(const F32Args& a, cudaStream_t stream) {
  return launch_f32(tiled_attention_wide_tf32x3_kernel<HAS_MASK, NC>, kWideWarps * 32, kWideTQ,
                    wide_smem(), a, stream);
}

template <bool HAS_MASK>
cudaError_t dispatch_width(const F32Args& a, cudaStream_t stream) {
  if (a.C <= 8) return launch_narrow<HAS_MASK, 1>(a, stream);
  if (a.C <= 16) return launch_narrow<HAS_MASK, 2>(a, stream);
  if (a.C <= 32) return launch_narrow<HAS_MASK, 4>(a, stream);
  if (a.C <= 64) return launch_narrow<HAS_MASK, 8>(a, stream);
  if (a.C <= 128) return launch_narrow<HAS_MASK, 16>(a, stream);
  if (a.C <= 256) return launch_wide<HAS_MASK, 2>(a, stream);
  if (a.C <= 512) return launch_wide<HAS_MASK, 4>(a, stream);
  if (a.C <= 768) return launch_wide<HAS_MASK, 6>(a, stream);
  return launch_wide<HAS_MASK, 8>(a, stream);
}

}  // namespace

extern "C" {

// K2 in f32 on the tensor cores (3xTF32): attention with an additive bias
// and an optional key mask. C a multiple of 8 up to 1024.
int prd_tiled_attention_tf32x3(const void* q, const void* k, const void* v, const void* mask,
                               const void* bias, void* out, int R, int N, int H, int C,
                               float scale, long long q_sr, long long q_sn, long long q_sh,
                               long long k_sr, long long k_sn, long long k_sh, long long v_sr,
                               long long v_sn, long long v_sh, void* stream) {
  const F32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(mask),
                  static_cast<const float*>(bias), static_cast<float*>(out), nullptr, nullptr,
                  R, N, H, C, scale, {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh}, {v_sr, v_sn, v_sh},
                  N % 4 == 0 && aligned16(bias)};
  if (!f32_operands_ok(a) || C > 1024 || bias == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(mask != nullptr ? dispatch_width<true>(a, s) : dispatch_width<false>(a, s));
}

}  // extern "C"
