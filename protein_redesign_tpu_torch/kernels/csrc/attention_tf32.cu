// Hand-written Hopper (sm_90a) tensor-core body of the rows attention in
// float32, for head widths that are a multiple of 8 up to 128:
//
//   rows_attention_tf32x3_kernel
//       <- _rows_attention_impl / _make_rowhead_kernel (K1: triangle
//          attention, key mask, no bias, below the K-chunk switch)
//   rows_attention_kchunk_tf32x3_kernel<STATS = false>
//       <- _make_rowhead_kchunk_grid_cn_kernel (K3, and K4 and the fori
//          variant, which differ only in TPU layout)
//   rows_attention_kchunk_tf32x3_kernel<STATS = true>
//       <- _make_rowhead_kchunk_grid_cn_stats_kernel (K5: the training
//          forward, which also writes the row max m and log s, kept split)
//
// of protein_redesign_tpu/ops/pallas_attention.py. It replaces, for those
// widths, the CUDA-core bodies of attention.cu (K1) and attention_kchunk.cu
// (K3, K5), kept for C = 4 mod 8 and callable to time them beside this one.
//
// The function is K3's and K5's f32 plain version (_kchunk_forward_block):
// f32 logits of the pre-scaled q (q * scale in f32), -2^15 at masked keys,
// -inf past N, a running max from -inf, p = exp(l - m') in f32 summed into
// s, acc = acc exp(m - m') + p V with p left in f32 (the reference's
// p.astype(v.dtype) is a no-op in f32), out = acc / s at the end; K5 writes
// m and log s, f32 [R, H, N]. A fully masked row gets m = -2^15, uniform p
// and the mean of v; its stats are m = -2^15 and log s = log N. In f32 that
// is also K1's function: the Pallas K1 (and attention_reference) takes the
// softmax in two passes and rounds P to the input type, a no-op in f32, so
// the two differ only in the order of f32 sums, well inside 1e-5. So K1 runs
// the same body (rows_tf32x3_body, attention_tf32.cuh) under its own kernel
// name, which a profile tells apart.
//
// What bounds it on the card. f32 products on the CUDA cores run at 67
// TFLOP/s, and one TF32 product keeps only three decimal digits, which
// breaks the 1e-5 parity. So every product runs on the tensor cores in
// 3xTF32 (mma.sync m16n8k8, mma.cuh): each operand split into a TF32 big
// and small part, three products with f32 sums, within about 2^-21 of the
// f32 product, under the f32 summation-order noise the 1e-5 gates admit.
// This is the method of CUTLASS's OpMultiplyAddFastF32, which PyTorch's
// f32 memory-efficient attention uses. The best it can do is 495 / 3 = 165
// TFLOP/s. At head width 16 the products are two mma depth steps, and the
// exponential (16 per SM and clock) and the splits set the pace, as for the
// bf16 bodies.
//
// Layout of the work, as K3's bf16 body (attention_mma.cu): a block of 128
// queries (8 warps of 16 rows) staged once, pre-scaled, as f32; 64-key tiles
// (32 from CP = 32 on) of K and V staged by cp.async, double-buffered; the
// tile's mask by ballot; one step of online softmax per tile in registers.
// K1 runs below the switch, at buckets from 64 up, where 128 queries a block
// would pad a third of the slots at N = 192 and half at N = 64: it takes 64
// queries (4 warps) where that pads fewer slots (rows_tf32x3_warps), else
// 128. The f32 fragment reads, the staging and P.V with P taken from the S
// accumulators as they lie (each 8-key n-tile's keys renumbered, no
// shuffle) are attention_tf32.cuh's, which K2's (attention_tiled_tf32.cu)
// and K6's and K7's f32 bodies (attention_bwd_tf32.cu) share.
//
// Layout: q, k, v are [R, N, H, C] f32 with the head dimension contiguous,
// the other strides given in elements, every row 16-byte aligned (C and the
// strides multiples of 4, checked by the wrapper); mask is contiguous f32
// [R, N]; out is contiguous [R, N, H, C]; m and log s contiguous [R, H, N].
// Heads are padded in shared memory to CP = 8 NT channels (8, 16, 32, 64 or
// 128). Shared memory: 4 (TQ + 4 BK) (CP + 4) bytes, 30 KB at C = 16 and
// 132 KB at C = 128 with TQ = 128. The entry points return
// cudaGetLastError() after their launch.

#include "attention_tf32.cuh"

namespace {

constexpr int kF32Warps = 8;  // K3 and K5: 128 queries a block

template <bool STATS, int NT>
__global__ void __launch_bounds__(kF32Warps * 32, kF32MinBlocks<kF32Warps, NT>)
    rows_attention_kchunk_tf32x3_kernel(const F32Args a) {
  rows_tf32x3_body<STATS, false, true, kF32Warps, NT>(a);
}

template <int WARPS, int NT>
__global__ void __launch_bounds__(WARPS * 32, kF32MinBlocks<WARPS, NT>)
    rows_attention_tf32x3_kernel(const F32Args a) {
  rows_tf32x3_body<false, false, true, WARPS, NT>(a);
}

// K1's warps a block at N keys: 4 (64 queries) where 128 would pad more
// query slots, else 8.
int rows_tf32x3_warps(int N) { return (N + 127) / 128 * 128 > (N + 63) / 64 * 64 ? 4 : 8; }

// K1 (ROWS), K3 or K5 (STATS) at the padded width of NT n-tiles.
template <bool ROWS, bool STATS, int NT>
cudaError_t launch(const F32Args& a, cudaStream_t stream) {
  if constexpr (ROWS) {
    if (rows_tf32x3_warps(a.N) == 4)
      return launch_f32(rows_attention_tf32x3_kernel<4, NT>, 4 * 32, 64,
                        rows_tf32x3_smem<4, NT, false>(), a, stream);
    return launch_f32(rows_attention_tf32x3_kernel<8, NT>, 8 * 32, 128,
                      rows_tf32x3_smem<8, NT, false>(), a, stream);
  } else {
    return launch_f32(rows_attention_kchunk_tf32x3_kernel<STATS, NT>, kF32Warps * 32,
                      16 * kF32Warps, rows_tf32x3_smem<kF32Warps, NT, false>(), a, stream);
  }
}

template <bool ROWS, bool STATS>
cudaError_t dispatch_width(const F32Args& a, cudaStream_t stream) {
  if (a.C <= 8) return launch<ROWS, STATS, 1>(a, stream);
  if (a.C <= 16) return launch<ROWS, STATS, 2>(a, stream);
  if (a.C <= 32) return launch<ROWS, STATS, 4>(a, stream);
  if (a.C <= 64) return launch<ROWS, STATS, 8>(a, stream);
  return launch<ROWS, STATS, 16>(a, stream);
}

F32Args rows_args(const void* q, const void* k, const void* v, const void* mask, void* out,
                  void* m, void* logs, int R, int N, int H, int C, float scale, long long q_sr,
                  long long q_sn, long long q_sh, long long k_sr, long long k_sn, long long k_sh,
                  long long v_sr, long long v_sn, long long v_sh) {
  return F32Args{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<const float*>(mask), nullptr,
                 static_cast<float*>(out), static_cast<float*>(m), static_cast<float*>(logs),
                 R, N, H, C, scale, {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh}, {v_sr, v_sn, v_sh},
                 false};
}

}  // namespace

extern "C" {

// K1 in f32 on the tensor cores (3xTF32): masked attention without bias
// below the K-chunk switch, by K3's one pass of online softmax. C a multiple
// of 8 up to 128.
int prd_rows_attention_tf32x3(const void* q, const void* k, const void* v, const void* mask,
                              void* out, int R, int N, int H, int C, float scale, long long q_sr,
                              long long q_sn, long long q_sh, long long k_sr, long long k_sn,
                              long long k_sh, long long v_sr, long long v_sn, long long v_sh,
                              void* stream) {
  const F32Args a = rows_args(q, k, v, mask, out, nullptr, nullptr, R, N, H, C, scale, q_sr,
                              q_sn, q_sh, k_sr, k_sn, k_sh, v_sr, v_sn, v_sh);
  if (!f32_operands_ok(a) || C > 128 || mask == nullptr) return (int)cudaErrorInvalidValue;
  return (int)dispatch_width<true, false>(a, static_cast<cudaStream_t>(stream));
}

// K3 (m and logs null) or K5 (both given) in f32 on the tensor cores
// (3xTF32): masked attention without bias by online softmax over key tiles.
// C a multiple of 8 up to 128.
int prd_rows_attention_kchunk_tf32x3(const void* q, const void* k, const void* v,
                                     const void* mask, void* out, void* m, void* logs, int R,
                                     int N, int H, int C, float scale, long long q_sr,
                                     long long q_sn, long long q_sh, long long k_sr,
                                     long long k_sn, long long k_sh, long long v_sr,
                                     long long v_sn, long long v_sh, void* stream) {
  const F32Args a = rows_args(q, k, v, mask, out, m, logs, R, N, H, C, scale, q_sr, q_sn, q_sh,
                              k_sr, k_sn, k_sh, v_sr, v_sn, v_sh);
  if (!f32_operands_ok(a) || C > 128 || mask == nullptr || (m == nullptr) != (logs == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(m != nullptr ? dispatch_width<false, true>(a, s)
                            : dispatch_width<false, false>(a, s));
}

}  // extern "C"
