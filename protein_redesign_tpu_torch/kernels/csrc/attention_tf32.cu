// Hand-written Hopper (sm_90a) tensor-core body of the K-chunked rows
// attention in float32, for head widths that are a multiple of 8 up to 128:
//
//   rows_attention_kchunk_tf32x3_kernel<STATS = false>
//       <- _make_rowhead_kchunk_grid_cn_kernel (K3, and K4 and the fori
//          variant, which differ only in TPU layout)
//   rows_attention_kchunk_tf32x3_kernel<STATS = true>
//       <- _make_rowhead_kchunk_grid_cn_stats_kernel (K5: the training
//          forward, which also writes the row max m and log s, kept split)
//
// of protein_redesign_tpu/ops/pallas_attention.py. It replaces, for those
// widths, the CUDA-core body of attention_kchunk.cu (kept for C = 4 mod 8).
//
// The function is K3's and K5's f32 plain version (_kchunk_forward_block):
// f32 logits of the pre-scaled q (q * scale in f32), -2^15 at masked keys,
// -inf past N, a running max from -inf, p = exp(l - m') in f32 summed into
// s, acc = acc exp(m - m') + p V with p left in f32 (the reference's
// p.astype(v.dtype) is a no-op in f32), out = acc / s at the end; K5 writes
// m and log s, f32 [R, H, N]. A fully masked row gets m = -2^15, uniform p
// and the mean of v; its stats are m = -2^15 and log s = log N.
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
// The f32 fragment reads, the staging and P.V with P taken from the S
// accumulators as they lie (each 8-key n-tile's keys renumbered, no shuffle)
// are attention_tf32.cuh's, which K6's and K7's f32 body
// (attention_bwd_tf32.cu) shares.
//
// Layout: q, k, v are [R, N, H, C] f32 with the head dimension contiguous,
// the other strides given in elements, every row 16-byte aligned (C and the
// strides multiples of 4, checked by the wrapper); mask is contiguous f32
// [R, N]; out is contiguous [R, N, H, C]; m and log s contiguous [R, H, N].
// Heads are padded in shared memory to CP = 8 NT channels (8, 16, 32, 64 or
// 128). Shared memory: 4 (128 + 4 BK) (CP + 4) bytes, 30 KB at C = 16 and
// 132 KB at C = 128. The entry point returns cudaGetLastError() after its
// launch.

#include "attention_tf32.cuh"

namespace {

struct F32Args {
  const float* q;
  const float* k;
  const float* v;
  const float* mask;
  float* out;
  float* m;
  float* logs;
  int R, N, H, C;
  float scale;
  Strides qs, ks, vs;
};

constexpr int kF32Warps = 8, kF32TQ = 16 * kF32Warps;

// Keys per tile: 64, or 32 from CP = 32 on, where the accumulators and the
// split operands take more registers.
template <int NT>
constexpr int kF32Keys = NT <= 2 ? 64 : 32;

// Blocks of 8 warps that must fit on an SM at once, which caps registers at
// 128 up to CP = 32 (16 warps a SM; the split operands and each product's
// fresh fragment spill at 80) and leaves wider heads uncapped.
template <int NT>
constexpr int kF32MinBlocks = NT <= 4 ? 2 : 1;

template <bool STATS, int NT>
__global__ void __launch_bounds__(kF32Warps * 32, kF32MinBlocks<NT>)
    rows_attention_kchunk_tf32x3_kernel(const F32Args a) {
  constexpr int BK = kF32Keys<NT>, NS = BK / 8, CP = 8 * NT, LD = CP + 4;
  extern __shared__ __align__(16) float smem_f[];
  float* q_s = smem_f;               // [kF32TQ][LD], pre-scaled
  float* k_s = q_s + kF32TQ * LD;    // [2][BK][LD]
  float* v_s = k_s + 2 * BK * LD;    // [2][BK][LD]
  const int N = a.N, C = a.C;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const Block b = block_of<kF32TQ>(N, CP);
  const float* q_base = a.q + b.r * a.qs.r + b.h * a.qs.h;
  const float* k_base = a.k + b.r * a.ks.r + b.h * a.ks.h;
  const float* v_base = a.v + b.r * a.vs.r + b.h * a.vs.h;
  const float* mask_row = a.mask + (long long)b.r * N;

  stage_q_f32(q_base, a.qs.n, b.q0, kF32TQ, N, C, CP, LD, a.scale, q_s);
  const int tiles = (N + BK - 1) / BK;
  stage_f32(k_base, a.ks.n, 0, BK, N, C, CP, LD, k_s);
  stage_f32(v_base, a.vs.n, 0, BK, N, C, CP, LD, v_s);
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
    }
    cp_async_commit();
    const TileMask<BK> tm = tile_mask<BK>(mask_row, t * BK, N, lane);
    cp_async_wait<1>();
    __syncthreads();

    const float* k_t = k_s + buf * BK * LD;
    const float* v_t = v_s + buf * BK * LD;
    float s[NS][4];
    logits_tf32<NS, CP>(q_w, k_t, LD, lane, s);  // S = Q K^T
    apply_fill<NS, BK>(s, tm);
    online_step<true, NS, NT>(s, st, nm_a, nm_b);
    exp_rows<true, NS, NT>(s, st, nm_a, nm_b);
    pv_tf32<NS, NT>(s, v_t, LD, lane, st.acc);  // acc += P V
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

template <int NT>
constexpr size_t tf32x3_smem() {
  return sizeof(float) * (size_t)(kF32TQ + 4 * kF32Keys<NT>) * (8 * NT + 4);
}

template <bool STATS, int NT>
cudaError_t launch(const F32Args& a, cudaStream_t stream) {
  const long long blocks = (long long)((a.N + kF32TQ - 1) / kF32TQ) * a.R;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  constexpr size_t smem = tf32x3_smem<NT>();
  auto kern = rows_attention_kchunk_tf32x3_kernel<STATS, NT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((unsigned)blocks, a.H), kF32Warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool STATS>
cudaError_t dispatch_width(const F32Args& a, cudaStream_t stream) {
  if (a.C <= 8) return launch<STATS, 1>(a, stream);
  if (a.C <= 16) return launch<STATS, 2>(a, stream);
  if (a.C <= 32) return launch<STATS, 4>(a, stream);
  if (a.C <= 64) return launch<STATS, 8>(a, stream);
  return launch<STATS, 16>(a, stream);
}

}  // namespace

extern "C" {

// K3 (m and logs null) or K5 (both given) in f32 on the tensor cores
// (3xTF32): masked attention without bias by online softmax over key tiles.
// C a multiple of 8 up to 128.
int prd_rows_attention_kchunk_tf32x3(const void* q, const void* k, const void* v,
                                     const void* mask, void* out, void* m, void* logs, int R,
                                     int N, int H, int C, float scale, long long q_sr,
                                     long long q_sn, long long q_sh, long long k_sr,
                                     long long k_sn, long long k_sh, long long v_sr,
                                     long long v_sn, long long v_sh, void* stream) {
  const F32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(mask),
                  static_cast<float*>(out), static_cast<float*>(m), static_cast<float*>(logs),
                  R, N, H, C, scale, {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh}, {v_sr, v_sn, v_sh}};
  const bool ok = R > 0 && N > 0 && H > 0 && H <= 65535 && C > 0 && C <= 128 && C % 8 == 0 &&
                  strides4(a.qs) && strides4(a.ks) && strides4(a.vs) && aligned16(q) &&
                  aligned16(k) && aligned16(v) && mask != nullptr &&
                  (m == nullptr) == (logs == nullptr);
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(m != nullptr ? dispatch_width<true>(a, s) : dispatch_width<false>(a, s));
}

}  // extern "C"
