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
// configurations; the body, wide_tf32x3_body in attention_tf32.cuh, is
// shared with K3 and K5 past 128, which run it without the bias). A warp
// cannot hold 16 rows of a 512-wide output, nor a
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

// NC channel chunks of 128 (C <= 128 NC): the wide body of attention_tf32.cuh
// with the bias.
template <bool HAS_MASK, int NC>
__global__ void __launch_bounds__(kWideWarps * 32, 1)
    tiled_attention_wide_tf32x3_kernel(const F32Args a) {
  wide_tf32x3_body<true, HAS_MASK, false, NC>(a);
}

template <bool HAS_MASK, int NT>
cudaError_t launch_narrow(const F32Args& a, cudaStream_t stream) {
  return launch_f32(tiled_attention_tf32x3_kernel<HAS_MASK, NT>, kTiledWarps * 32,
                    16 * kTiledWarps, rows_tf32x3_smem<kTiledWarps, NT, true>(), a, stream);
}

template <bool HAS_MASK, int NC>
cudaError_t launch_wide(const F32Args& a, cudaStream_t stream) {
  return launch_f32(tiled_attention_wide_tf32x3_kernel<HAS_MASK, NC>, kWideWarps * 32, kWideTQ,
                    wide_tf32x3_smem<true>(), a, stream);
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
