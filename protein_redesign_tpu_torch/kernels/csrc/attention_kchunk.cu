// Hand-written Hopper (sm_90a) K-chunked rows attention: one pass of online
// softmax over key tiles, optionally emitting the row softmax stats. This is
// the CUDA-core body of K3 and K5, for head widths that are not a multiple of
// 8 (C = 4 mod 8) in both dtypes; at multiples of 8 bf16 takes
// rows_attention_kchunk_mma_kernel (attention_mma.cu) and f32
// rows_attention_kchunk_tf32x3_kernel (attention_tf32.cu). It stays callable
// (ops.attention.attention_body) to time it beside them.
//
// Replaces these Pallas TPU kernels of protein_redesign_tpu/ops/pallas_attention.py:
//
//   STATS = false  <- _make_rowhead_kchunk_grid_cn_kernel (K3, via
//                     _rows_attention_kchunk_grid_cn), and the same function in
//                     the NC layout (_make_rowhead_kchunk_grid_kernel, K4) and as
//                     a fori loop (_make_rowhead_kchunk_kernel): they differ only
//                     in TPU layout, and this kernel reads [R, N, H, C] through
//                     its strides, so one kernel ports all three;
//   STATS = true   <- _make_rowhead_kchunk_grid_cn_stats_kernel (K5, via
//                     _kchunk_grid_cn_stats_call): the training forward, which
//                     also writes the row max m and log s, kept split.
//
// Per (row r, head h) and query i, with qt = q * scale rounded to the input
// type and masked keys filled with -2^15, over key tiles of 32:
//   m'  = max(m, max_j l_ij)                 running max, from -inf
//   p   = exp(l_ij - m')                      f32
//   s   = s * exp(m - m') + sum_j p           f32
//   acc = acc * exp(m - m') + round(p) v_j    p rounded to v's type, f32 sums
// and out = acc / s at the end, in the input type. The first rescale is
// exp(-inf) = 0; m' is finite from the first tile on (masked logits are
// -2^15, not -inf), so two -infs are never subtracted. A fully masked row
// gets m = -2^15, uniform p and the mean of v, as the reference's softmax
// gives; its stats are m = -2^15 and log s = log N. The stats stay split
// because at m = -2^15 one f32 ulp is 4e-3: a fused m + log s would round
// log s and the backward's uniform P with it.
//
// Layout of the work: one block per (row, tile of TQ queries, head); each
// warp owns 4 queries. Key and V tiles are staged in shared memory as f32;
// a lane computes the logits of its key against the warp's 4 queries, the
// warp reduces the tile max, and the P.V product runs with the lanes on the
// head channels, each key's p broadcast by a shuffle. Running max, sums and
// the [4, C] accumulator stay in registers; shared memory is O((TQ + 64) C),
// so there is no bound on N. Head widths run to 1024 (CPL = C / 32 values a
// lane, as K1's CUDA-core body); past 512 V is staged into K's buffer after
// the tile's logits (SHARE_KV), so a block's shared memory stays within the
// card's 227 KB (197 KB at C = 1024), and the [4, CPL] accumulators spill
// there. No CN transpose: the TPU kernel transposed to
// [R, H, C, N] to avoid lane padding, which this card does not have. The
// products run on the CUDA cores in f32, bound by the instruction rate of
// the shuffles and FMAs (not by bytes); the tensor-core bodies replace it
// wherever an mma operand row fits the head.
//
// Layout: q, k, v are [R, N, H, C] with the head dimension contiguous and
// the other strides given in elements; mask is contiguous f32 [R, N]; out is
// contiguous [R, N, H, C]; m and log s are contiguous f32 [R, H, N]. Offsets
// are 64-bit (one operand at bucket 2048, B = 4 holds 2^30 elements). The
// entry point returns cudaGetLastError() after its launch.

#include "common.cuh"

namespace {

constexpr int kTK = 32;  // keys per tile: one key per lane
constexpr int kRPW = 4;  // queries per warp

template <typename T, int CPL, int NWARPS, bool STATS>
__global__ void __launch_bounds__(NWARPS * 32)
    rows_attention_kchunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const float* __restrict__ mask,
                                 T* __restrict__ out, float* __restrict__ m_out,
                                 float* __restrict__ logs_out, int N, int H, int C, float scale,
                                 Strides qs, Strides ks, Strides vs) {
  constexpr int TQ = NWARPS * kRPW;
  constexpr bool SHARE_KV = CPL > 16;
  extern __shared__ __align__(16) float smem[];
  const int k_stride = C + 4;  // padded K rows: conflict-free float4 reads by lane
  float* q_s = smem;                                     // [TQ][C]
  float* k_s = q_s + TQ * C;                             // [kTK][C + 4]
  float* v_s = SHARE_KV ? k_s : k_s + kTK * k_stride;  // [kTK][C]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles = (N + TQ - 1) / TQ;
  const int r = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - r * tiles) * TQ;
  const int h = blockIdx.y;
  const T* k_base = k + r * ks.r + h * ks.h;
  const T* v_base = v + r * vs.r + h * vs.h;
  const float* mask_row = mask + (long long)r * N;

  stage_rows<T, true>(q + r * qs.r + h * qs.h, qs.n, q0, TQ, N, C, scale, q_s, C);

  const int row0 = warp * kRPW;
  const float* q_rows = q_s + row0 * C;
  const float* k_row = k_s + lane * k_stride;

  float m[kRPW], s[kRPW], acc[kRPW][CPL];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    m[rr] = neg_inf();
    s[rr] = 0.f;  // this lane's keys only; summed over the warp at the end
#pragma unroll
    for (int t = 0; t < CPL; ++t) acc[rr][t] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kTK) {
    __syncthreads();
    stage_rows<T, false>(k_base, ks.n, k0, kTK, N, C, 1.f, k_s, k_stride);
    if constexpr (!SHARE_KV) stage_rows<T, false>(v_base, vs.n, k0, kTK, N, C, 1.f, v_s, C);
    __syncthreads();
    const int j = k0 + lane;
    const bool live = j < N;
    const bool masked = live && mask_row[j] < 0.5f;
    float p[kRPW];
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      float l = neg_inf();
      if (live) l = masked ? kMaskFill : dot_smem(q_rows + rr * C, k_row, C);
      const float m_new = fmaxf(m[rr], warp_max(l));
      const float alpha = expf(m[rr] - m_new);
      const float e = live ? expf(l - m_new) : 0.f;
      s[rr] = fmaf(s[rr], alpha, e);
      p[rr] = Io<T>::round(e);
      m[rr] = m_new;
#pragma unroll
      for (int t = 0; t < CPL; ++t) acc[rr][t] *= alpha;
    }
    if constexpr (SHARE_KV) {
      __syncthreads();  // every warp's logits have read K's tile
      stage_rows<T, false>(v_base, vs.n, k0, kTK, N, C, 1.f, v_s, C);
      __syncthreads();
    }
    const int nk = min(kTK, N - k0);
    for (int jj = 0; jj < nk; ++jj) {
      const float* v_row = v_s + jj * C;
      float vv[CPL];
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        const int c = lane + 32 * t;
        vv[t] = c < C ? v_row[c] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr) {
        const float pj = __shfl_sync(kFull, p[rr], jj);
#pragma unroll
        for (int t = 0; t < CPL; ++t) acc[rr][t] = fmaf(pj, vv[t], acc[rr][t]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    const float total = warp_sum(s[rr]);
    const int qi = q0 + row0 + rr;
    if (qi >= N) continue;
    T* out_row = out + (((long long)r * N + qi) * H + h) * C;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = lane + 32 * t;
      if (c < C) out_row[c] = Io<T>::cast(acc[rr][t] / total);
    }
    if (STATS && lane == 0) {
      const long long idx = ((long long)r * H + h) * N + qi;
      m_out[idx] = m[rr];
      logs_out[idx] = logf(total);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;
  void* out;
  float* m;
  float* logs;
  int R, N, H, C;
  float scale;
  Strides qs, ks, vs;
  cudaStream_t stream;
};

template <typename T, int CPL, bool STATS>
cudaError_t launch(const Args& a) {
  constexpr int NWARPS = CPL <= 2 ? 8 : 4;
  constexpr int TQ = NWARPS * kRPW;
  const size_t smem =
      sizeof(float) * (size_t)(TQ * a.C + kTK * (a.C + 4) + (CPL > 16 ? 0 : kTK * a.C));
  const long long blocks = (long long)((a.N + TQ - 1) / TQ) * a.R;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kern = rows_attention_kchunk_kernel<T, CPL, NWARPS, STATS>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((unsigned)blocks, a.H), NWARPS * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.mask,
      static_cast<T*>(a.out), a.m, a.logs, a.N, a.H, a.C, a.scale, a.qs, a.ks, a.vs);
  return cudaGetLastError();
}

template <typename T, bool STATS>
cudaError_t dispatch_width(const Args& a) {
  if (a.C <= 32) return launch<T, 1, STATS>(a);
  if (a.C <= 64) return launch<T, 2, STATS>(a);
  if (a.C <= 128) return launch<T, 4, STATS>(a);
  if (a.C <= 256) return launch<T, 8, STATS>(a);
  if (a.C <= 512) return launch<T, 16, STATS>(a);
  return launch<T, 32, STATS>(a);
}

template <bool STATS>
cudaError_t dispatch_type(int dtype, const Args& a) {
  if (dtype == 0) return dispatch_width<float, STATS>(a);
  return dispatch_width<__nv_bfloat16, STATS>(a);
}

}  // namespace

extern "C" {

// K3 (m and logs null) or K5 (both given): masked attention without bias by
// online softmax over key tiles. Takes C a multiple of 4 up to 1024.
int prd_rows_attention_kchunk(const void* q, const void* k, const void* v, const void* mask,
                              void* out, void* m, void* logs, int dtype, int R, int N, int H,
                              int C, float scale, long long q_sr, long long q_sn, long long q_sh,
                              long long k_sr, long long k_sn, long long k_sh, long long v_sr,
                              long long v_sn, long long v_sh, void* stream) {
  const Args a{q, k, v, static_cast<const float*>(mask), out, static_cast<float*>(m),
               static_cast<float*>(logs), R, N, H, C, scale,
               {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh}, {v_sr, v_sn, v_sh},
               static_cast<cudaStream_t>(stream)};
  const bool ok = (dtype == 0 || dtype == 1) && R > 0 && N > 0 && H > 0 && H <= 65535 && C > 0 &&
                  C <= 1024 && C % 4 == 0 && mask != nullptr && (m == nullptr) == (logs == nullptr);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (m != nullptr) return (int)dispatch_type<true>(dtype, a);
  return (int)dispatch_type<false>(dtype, a);
}

}  // extern "C"
