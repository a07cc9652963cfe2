// Hand-written Hopper (sm_90a) tensor-core body of K3 and K5 in float32 past
// head width 128, for C a multiple of 4 in (128, 1024]:
//
//   rows_attention_kchunk_wide_tf32x3_kernel<STATS = false, NC>
//       <- _rows_attention_kchunk_grid_cn / _make_rowhead_kchunk_grid_cn_kernel (K3)
//   rows_attention_kchunk_wide_tf32x3_kernel<STATS = true, NC>
//       <- _kchunk_grid_cn_stats_call / _make_rowhead_kchunk_grid_cn_stats_kernel (K5)
//
// of protein_redesign_tpu/ops/pallas_attention.py. It replaces, at those
// widths, the CUDA-core body of attention_kchunk.cu (kept callable to time
// it beside this one), which spills at 8 channels a
// lane: 6.75 ms at R = 384, N = 192, C = 256, 14x SDPA.
//
// The function is the narrow f32 body's (attention_tf32.cu): f32 logits of
// the pre-scaled q, -2^15 at masked keys, -inf past N, online softmax from
// -inf, p left in f32 for P.V, out = acc / s; K5 writes m and log s, f32
// [R, H, N]. The body is K2's wide one (attention_tf32.cuh,
// wide_tf32x3_body) without the bias: each (query tile, key tile) logit
// computed once, the Q K^T contraction streamed over C in 128-channel
// chunks through two cp.async stages, S and P's two TF32 parts in shared
// memory, a row pass for the softmax step, and each warp holding 16
// channels of every chunk of the output in registers across the key tiles.
// A block takes 64 queries (four row blocks) up to C = 512, where its
// accumulators are 32 NC floats a thread, and 32 above: twice the queries
// halve the K and V tiles read from L2 per query (0.633 -> 0.579 ms at C =
// 256, R = 384, N = 192). Every product is 3xTF32 (mma_3xtf32), so it holds
// the narrow body's 1e-5 gates. What bounds it on the card: the splits of
// every fragment element on each use and one block of 8 warps a SM (187 KB
// of shared memory up to C = 512), which leaves the stages' barriers
// exposed; 1.2-1.4x SDPA at C = 256 (PERF.md).
//
// Layout: q, k, v [R, N, H, C] f32, head dimension contiguous, the other
// strides given in elements, rows 16-byte aligned; mask contiguous f32 [R,
// N]; out contiguous [R, N, H, C]; m and log s contiguous [R, H, N]. The
// entry point returns cudaGetLastError() after its launch.

#include "attention_tf32.cuh"

namespace {

template <bool STATS, int NC>
__global__ void __launch_bounds__(kWideWarps * 32, 1)
    rows_attention_kchunk_wide_tf32x3_kernel(const F32Args a) {
  wide_tf32x3_body<false, true, STATS, NC, kWideRB<NC>>(a);
}

template <bool STATS, int NC>
cudaError_t launch(const F32Args& a, cudaStream_t stream) {
  constexpr int RB = kWideRB<NC>;
  return launch_f32(rows_attention_kchunk_wide_tf32x3_kernel<STATS, NC>, kWideWarps * 32, 16 * RB,
                    wide_tf32x3_smem<false, RB>(), a, stream);
}

template <bool STATS>
cudaError_t dispatch_width(const F32Args& a, cudaStream_t stream) {
  if (a.C <= 256) return launch<STATS, 2>(a, stream);
  if (a.C <= 512) return launch<STATS, 4>(a, stream);
  if (a.C <= 768) return launch<STATS, 6>(a, stream);
  return launch<STATS, 8>(a, stream);
}

}  // namespace

extern "C" {

// K3 (m and logs null) or K5 (both given) in f32 on the tensor cores
// (3xTF32), C a multiple of 4 in (128, 1024].
int prd_rows_attention_kchunk_wide_tf32x3(const void* q, const void* k, const void* v,
                                          const void* mask, void* out, void* m, void* logs,
                                          int R, int N, int H, int C, float scale,
                                          long long q_sr, long long q_sn, long long q_sh,
                                          long long k_sr, long long k_sn, long long k_sh,
                                          long long v_sr, long long v_sn, long long v_sh,
                                          void* stream) {
  const F32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(mask), nullptr,
                  static_cast<float*>(out), static_cast<float*>(m), static_cast<float*>(logs),
                  R, N, H, C, scale, {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh}, {v_sr, v_sn, v_sh},
                  false};
  if (!f32_operands_ok(a, 4) || C <= 128 || C > 1024 || mask == nullptr ||
      (m == nullptr) != (logs == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(m != nullptr ? dispatch_width<true>(a, s) : dispatch_width<false>(a, s));
}

}  // extern "C"
