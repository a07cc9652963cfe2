// Hand-written Hopper (sm_90a) tensor-core body of K1, the rows attention
// (key mask, no bias), in float32 past head width 128, for C a multiple of
// 4 in (128, 1024]:
//
//   rows_attention_wide_tf32x3_kernel<NC>
//       <- _rows_attention_impl / _make_rowhead_kernel (K1)
//
// of protein_redesign_tpu/ops/pallas_attention.py. It replaces, at those
// widths, the CUDA-core body of attention.cu (kept callable to time it
// beside this one), which spills at 8 channels a lane:
// 8.5 ms at R = 384, N = 192, C = 256, 18x SDPA.
//
// In f32 K1's function is K3's (attention_tf32.cu's header: the two-pass
// softmax rounds P to the input type, a no-op in f32, so the two differ
// only in the order of f32 sums), so this is K3's wide body
// (attention_kchunk_wide_tf32.cu; wide_tf32x3_body in attention_tf32.cuh)
// under K1's own kernel name, which a profile tells apart: each (query
// tile, key tile) logit computed once, the Q K^T contraction streamed over
// C in 128-channel chunks through two cp.async stages, S and P's two TF32
// parts in shared memory, a row pass for the softmax step, each warp
// holding 16 channels of every chunk of the output in registers; 64
// queries a block up to C = 512, 32 above. Every product is 3xTF32. A
// fully masked row has every logit at -2^15: uniform P, the mean of v.
//
// Layout: q, k, v [R, N, H, C] f32, head dimension contiguous, the other
// strides given in elements, rows 16-byte aligned; mask contiguous f32 [R,
// N]; out contiguous [R, N, H, C]. The entry point returns
// cudaGetLastError() after its launch.

#include "attention_tf32.cuh"

namespace {

template <int NC>
__global__ void __launch_bounds__(kWideWarps * 32, 1)
    rows_attention_wide_tf32x3_kernel(const F32Args a) {
  wide_tf32x3_body<false, true, false, NC, kWideRB<NC>>(a);
}

template <int NC>
cudaError_t launch(const F32Args& a, cudaStream_t stream) {
  constexpr int RB = kWideRB<NC>;
  return launch_f32(rows_attention_wide_tf32x3_kernel<NC>, kWideWarps * 32, 16 * RB,
                    wide_tf32x3_smem<false, RB>(), a, stream);
}

}  // namespace

extern "C" {

// K1 in f32 on the tensor cores (3xTF32), C a multiple of 4 in (128, 1024].
int prd_rows_attention_wide_tf32x3(const void* q, const void* k, const void* v, const void* mask,
                                   void* out, int R, int N, int H, int C, float scale,
                                   long long q_sr, long long q_sn, long long q_sh, long long k_sr,
                                   long long k_sn, long long k_sh, long long v_sr, long long v_sn,
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
