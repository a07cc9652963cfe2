// Hand-written Hopper (sm_90a) tensor-core body of K6, the K-chunk regime's
// flash backward from K5's stats, in bf16 (mma.sync
// m16n8k16) past head width 128, for C a multiple of 8 in (128, 1024]:
//
//   rows_attention_kchunk_bwd_dq_wide_mma_kernel<NC>,    <- _kchunk_grid_cn_grads_call /
//   rows_attention_kchunk_bwd_dkdv_wide_mma_kernel<NC>      _make_rowhead_kchunk_grid_cn_
//                                                       bwd_kernel (K6)
//
// of protein_redesign_tpu/ops/pallas_attention.py: K7's wide body
// (attention_bwd_wide.cuh, whose header has the function, the design and
// what bounds it) with STATS_IN, over NC chunks of 128 channels. Its dq
// kernel skips K7's stats pass and reads K5's m and log s, kept apart, and
// the caller's delta = rowsum(dO o O); its dk/dv kernel reads the same
// stats. It replaces, at those widths, attention_kchunk_bwd.cu's CUDA-core
// kernels (kept for C = 4 mod 8 and callable to time them beside these),
// which spill at 8 channels a lane (14.9 ms at R = 384, N = 192, C = 256,
// 9.7x SDPA). The entry point takes attention_bwd_mma.cu's K6 arguments and
// returns cudaGetLastError() after its launches.

#include "attention_bwd_wide.cuh"

namespace {

template <int NC>
__global__ void __launch_bounds__(kWbWarps * 32, 1)
    rows_attention_kchunk_bwd_dq_wide_mma_kernel(const WideBwdArgs<bf16> a) {
  wide_bwd_dq<bf16, NC, true>(a);
}

template <int NC>
__global__ void __launch_bounds__(kWbWarps * 32, 1)
    rows_attention_kchunk_bwd_dkdv_wide_mma_kernel(const WideBwdArgs<bf16> a) {
  wide_bwd_dkdv<bf16, NC, true>(a);
}

template <int NC>
cudaError_t launch(const WideBwdArgs<bf16>& a, cudaStream_t stream) {
  return launch_wide_bwd<bf16, NC>(rows_attention_kchunk_bwd_dq_wide_mma_kernel<NC>,
                                  rows_attention_kchunk_bwd_dkdv_wide_mma_kernel<NC>, a, stream);
}

}  // namespace

extern "C" {

// K6 on the tensor cores: dqt (w.r.t. the pre-scaled q), dk and dv of the
// K-chunked rows attention from K5's m and log s and the caller's delta =
// rowsum(dO o O), all f32 [R, H, N] and read only; C a multiple of 8 in
// (128, 1024].
int prd_rows_attention_kchunk_bwd_wide_mma(const void* q, const void* k, const void* v,
                                  const void* mask, const void* dout, const void* m,
                                  const void* logs, const void* delta, void* dq, void* dk,
                                  void* dv, int R, int N, int H, int C, float scale,
                                  long long q_sr, long long q_sn, long long q_sh, long long k_sr,
                                  long long k_sn, long long k_sh, long long v_sr, long long v_sn,
                                  long long v_sh, long long g_sr, long long g_sn, long long g_sh,
                                  void* stream) {
  const WideBwdArgs<bf16> a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), static_cast<const float*>(mask),
                          static_cast<const bf16*>(dout), static_cast<bf16*>(dq),
                          static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                          static_cast<float*>(const_cast<void*>(m)),
                          static_cast<float*>(const_cast<void*>(logs)),
                          static_cast<float*>(const_cast<void*>(delta)), R, N, H, C, scale,
                          {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh}, {v_sr, v_sn, v_sh},
                          {g_sr, g_sn, g_sh}};
  if (!wide_bwd_ok(a)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 256) return (int)launch<2>(a, s);
  if (C <= 512) return (int)launch<4>(a, s);
  if (C <= 768) return (int)launch<6>(a, s);
  return (int)launch<8>(a, s);
}

}  // extern "C"
