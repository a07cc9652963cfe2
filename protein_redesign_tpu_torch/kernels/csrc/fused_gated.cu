// Hand-written Hopper (sm_90a) fused gated rows attention: the whole no-bias
// GatedAttention of a triangle attention in one entry point.
//
// Replaces the Pallas TPU kernel K8 of protein_redesign_tpu/ops/pallas_attention.py,
// _fused_gated_impl (:1164) -> _make_fused_gated_kernel (:1064), behind the
// switch use_pallas_fused_gated: both triangle attentions of every FoldingBlock
// at N < 2048. Per row r of pair rows x [R, N, D]:
//
//   x^ = LN(x) rounded to T
//   q = round(x^ Wq / sqrt(C)), k = round(x^ Wk), v = round(x^ Wv)   per head
//   g = sigmoid(x^ Wg + bg)                                           f32
//   o = softmax(q k^T, keys masked with -2^15) v                      f32 softmax
//   out = sum_h round(g_h * o_h) Wo_h + bo                            in T
//
// (T = float: f32 throughout, as the Pallas kernel in interpret mode.)
//
// What bounds it: at bucket 192, B = 2 (R = 384, N = 192, D = 64, H = 4,
// C = 16) 6.6 GFLOP (4 R H N^2 C + 10 R N D H C) against ~9.4 MB of rows in
// and out in bf16, so the operations, here on the CUDA cores in f32 (tensor
// cores are later work). The fusion keeps the LN copy, the probabilities and
// the gated heads out of device memory; q, k, v and the gate pass through
// scratch once, because every query tile of a row reads all of its keys.
//
// Two kernels, launched back to back by one entry point:
// 1. fused_gated_project_kernel, one block per 64 row positions: x read
//    through its strides as [R1, R2, N, D] (the "ending" attention's
//    transposed view [B, j, i, D] needs no copy), LN into a transposed tile
//    in shared memory (a warp per row), then, for each slice of 64 w_in
//    columns, K slices of 128 of its rows staged beside it in turn (a whole
//    [D, 4 H C] w_in would not fit at D = 128; one K slice up to D = 128)
//    and 4 x 4 register tiles (4 positions x 4 columns) give
//    q (scaled in f32, then rounded), k, v (rounded) and the f32 gate, into
//    contiguous scratch [3, R, N, H C] and [R, N, H C].
// 2. fused_gated_attention_kernel, one block per (row, 32 queries): for each
//    head, online softmax over key tiles of 32 (as attention_kchunk.cu: a lane
//    per key for the logits, the running max from -inf, p rounded to T for
//    P.V, the lanes on the head channels for P.V); then the gated head output
//    round(g * o / s) is broadcast channel by channel and its out-projection
//    (W_o in shared memory, the lanes on the output channels, two a lane up
//    to D = 64, four up to 128) added into registers, summed over heads. A
//    fully masked row gets uniform probabilities, as K1 and the reference
//    softmax give.
//
// Layout: x [R1, R2, N, D] with D contiguous and element strides (s1, s2, sn);
// mask contiguous f32 [R, N] (R = R1 R2); w_in [D, 4 H C] in T
// (q | k | v | gate columns); bg [H C] f32; wo_t [H C, D] in T; bo [D] f32;
// out contiguous [R, N, D]. Takes D up to 128 (AlphaFold2's pair width), C
// a multiple of 4 up to 32 and H C up to 128. The entry point returns cudaGetLastError().
//
// K8 runs this body at C = 4 mod 8 (ops.attention.fused_gated_body "cuda
// cores"), and at every shape it takes where
// ops.attention.fused_gated_takes_tensor_cores is patched to False, to time
// it beside the tensor-core body (fused_gated_mma.cu). The split route
// (fused_gated_body "split") takes the shapes past both bodies on the
// tensor cores (fused_gated_mma.cu's and fused_gated_wide.cu's projection
// and gate + out-projection around K3's bodies).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTP = 64;    // row positions per projection block
constexpr int kLdP = kTP + 4;  // row stride of its transposed LN tile
constexpr int kTK = 32;    // keys per tile: one key per lane
constexpr int kRPW = 4;    // queries per warp
constexpr int kTQ = (kThreads / 32) * kRPW;  // queries per block
constexpr int kWC = 64;    // w_in columns per staged slice
constexpr int kWK = 128;   // w_in rows (input channels) per staged K slice
constexpr int kMaxD = 128;  // four output channels per lane

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_gated_project_kernel(const T* __restrict__ x, const T* __restrict__ w_in,
                               const float* __restrict__ bg, T* __restrict__ qkv,
                               float* __restrict__ gate, int R2, int N, int D, int HC, float scale,
                               long long s1, long long s2, long long sn, long long positions) {
  extern __shared__ __align__(16) float smem[];
  const int W = 4 * HC;
  float* xsT = smem;           // [D][kLdP]: the tile's LN rows, transposed
  float* ws = xsT + D * kLdP;  // [kWK][kWC]: a K slice of a slice of w_in's columns
  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * kTP;
  const int rows = (int)min((long long)kTP, positions - p0);
  for (int r = tid >> 5; r < kTP; r += kThreads / 32) {
    const long long pos = p0 + r;
    const long long row = pos / N;
    const long long r1 = row / R2;
    const T* src = x + r1 * s1 + (row - r1 * R2) * s2 + (pos - row * N) * sn;
    layer_norm_to_column<T>(src, r < rows, D, xsT + r, kLdP);
  }
  // a unit is 4 positions x 4 columns of [q | k | v | gate], over slices of
  // kWC columns, each summed over K slices of kWK rows of w_in (one slice up
  // to D = 128; the order of the sums is the same for every D). Every unit
  // of a slice is held by its thread across the K slices: kTP / 4 x kWC / 4
  // units, one a thread.
  static_assert((kTP / 4) * (kWC / 4) == kThreads, "a unit a thread");
  const int pg = tid % (kTP / 4), cl = (tid / (kTP / 4)) * 4;
  for (int s0 = 0; s0 < W; s0 += kWC) {
    const int width = min(kWC, W - s0);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < D; k0 += kWK) {
      const int kn = min(kWK, D - k0);
      __syncthreads();  // the LN tile is in; the previous slice's reads are done
      for (int e = tid; e < kn * width; e += kThreads) {
        const int d = e / width, c = e - d * width;
        ws[d * kWC + c] = Io<T>::load(w_in + (long long)(k0 + d) * W + s0 + c);
      }
      __syncthreads();
      if (cl < width) tile_4x4(acc, xsT + k0 * kLdP + pg * 4, kLdP, ws + cl, kWC, kn);
    }
    if (cl < width) {
      const int c0 = s0 + cl;
      const int which = c0 / HC;  // 0 q, 1 k, 2 v, 3 gate (HC is a multiple of 4)
      const int col = c0 - which * HC;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (pg * 4 + i >= rows) continue;
        const long long pos = p0 + pg * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (which == 3) {
            gate[pos * HC + col + j] = sigmoid_f(acc[i][j] + bg[col + j]);
          } else {
            const float v = which == 0 ? acc[i][j] * scale : acc[i][j];
            qkv[((long long)which * positions + pos) * HC + col + j] = Io<T>::cast(v);
          }
        }
      }
    }
  }
}

// DL output channels per lane (D <= 32 DL): wo_s rows are 32 DL wide.
template <typename T, int DL>
__global__ void __launch_bounds__(kThreads)
    fused_gated_attention_kernel(const T* __restrict__ qkv, const float* __restrict__ gate,
                                 const float* __restrict__ mask, const T* __restrict__ wo_t,
                                 const float* __restrict__ bo, T* __restrict__ out, int N, int D,
                                 int H, int C, long long positions) {
  extern __shared__ __align__(16) float smem[];
  const int HC = H * C;
  constexpr int DW = 32 * DL;
  const int k_stride = C + 4;  // padded K rows: conflict-free float4 reads by lane
  float* wo_s = smem;                  // [HC][DW], zero past D
  float* q_s = wo_s + HC * DW;         // [kTQ][C]
  float* k_s = q_s + kTQ * C;          // [kTK][C + 4]
  float* v_s = k_s + kTK * k_stride;   // [kTK][C]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles = (N + kTQ - 1) / kTQ;
  const int r = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - r * tiles) * kTQ;
  const long long row_base = (long long)r * N * HC;
  const float* mask_row = mask + (long long)r * N;
  const int row0 = warp * kRPW;

  for (int e = threadIdx.x; e < HC * DW; e += kThreads) {
    const int hc = e / DW, d = e - hc * DW;
    wo_s[e] = d < D ? Io<T>::load(wo_t + (long long)hc * D + d) : 0.f;
  }

  float o_acc[kRPW][DL];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr)
#pragma unroll
    for (int t = 0; t < DL; ++t) o_acc[rr][t] = 0.f;

  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the previous head's reads are done (and W_o is in)
    stage_rows<T, false>(qkv + row_base + h * C, HC, q0, kTQ, N, C, 1.f, q_s, C);
    const T* k_base = qkv + positions * HC + row_base + h * C;
    const T* v_base = qkv + 2 * positions * HC + row_base + h * C;
    const float* q_rows = q_s + row0 * C;
    const float* k_row = k_s + lane * k_stride;

    float m[kRPW], s[kRPW], acc[kRPW];
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      m[rr] = neg_inf();
      s[rr] = 0.f;  // this lane's keys only; summed over the warp at the end
      acc[rr] = 0.f;
    }
    for (int k0 = 0; k0 < N; k0 += kTK) {
      __syncthreads();
      stage_rows<T, false>(k_base, HC, k0, kTK, N, C, 1.f, k_s, k_stride);
      stage_rows<T, false>(v_base, HC, k0, kTK, N, C, 1.f, v_s, C);
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
        acc[rr] *= alpha;
      }
      const int nk = min(kTK, N - k0);
      for (int jj = 0; jj < nk; ++jj) {
        const float vv = lane < C ? v_s[jj * C + lane] : 0.f;
#pragma unroll
        for (int rr = 0; rr < kRPW; ++rr) acc[rr] = fmaf(__shfl_sync(kFull, p[rr], jj), vv, acc[rr]);
      }
    }
    // this head's gated output, then its out-projection into o_acc
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      const float total = warp_sum(s[rr]);
      const int qi = q0 + row0 + rr;
      float go = 0.f;
      if (qi < N && lane < C) {
        const float g = gate[((long long)r * N + qi) * HC + h * C + lane];
        go = Io<T>::round(g * (acc[rr] / total));
      }
      const float* wo_h = wo_s + h * C * DW;
      for (int c = 0; c < C; ++c) {
        const float gc = __shfl_sync(kFull, go, c);
#pragma unroll
        for (int t = 0; t < DL; ++t)
          o_acc[rr][t] = fmaf(gc, wo_h[c * DW + lane + 32 * t], o_acc[rr][t]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    const int qi = q0 + row0 + rr;
    if (qi >= N) continue;
    T* out_row = out + ((long long)r * N + qi) * D;
#pragma unroll
    for (int t = 0; t < DL; ++t) {
      const int d = lane + 32 * t;
      if (d < D) out_row[d] = Io<T>::cast(o_acc[rr][t] + bo[d]);
    }
  }
}

// The projection kernel's shared memory: the LN tile and one K slice.
size_t proj_smem_bytes(int D) {
  return sizeof(float) * ((size_t)D * kLdP + (size_t)(D < kWK ? D : kWK) * kWC);
}

template <typename T>
cudaError_t launch_project(const T* x, const T* w_in, const float* bg, T* qkv, float* gate,
                           int R2, int N, int D, int HC, float scale, long long s1, long long s2,
                           long long sn, long long positions, cudaStream_t stream) {
  const long long blocks = (positions + kTP - 1) / kTP;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = proj_smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_gated_project_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  fused_gated_project_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, w_in, bg, qkv, gate, R2, N, D, HC, scale, s1, s2, sn, positions);
  return cudaGetLastError();
}

struct Args {
  const void* x;
  const float* mask;
  const void* w_in;
  const float* bg;
  const void* wo_t;
  const float* bo;
  void* qkv;
  float* gate;
  void* out;
  int R1, R2, N, D, H, C;
  float scale;
  long long s1, s2, sn;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch(const Args& a) {
  const int HC = a.H * a.C;
  const long long R = (long long)a.R1 * a.R2;
  const long long positions = R * a.N;
  const long long attn_blocks = R * ((a.N + kTQ - 1) / kTQ);
  if (attn_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e = launch_project<T>(static_cast<const T*>(a.x), static_cast<const T*>(a.w_in),
                                    a.bg, static_cast<T*>(a.qkv), a.gate, a.R2, a.N, a.D, HC,
                                    a.scale, a.s1, a.s2, a.sn, positions, a.stream);
  if (e != cudaSuccess) return e;
  const int DL = a.D > 64 ? 4 : 2;
  const size_t smem =
      sizeof(float) * ((size_t)HC * 32 * DL + kTQ * a.C + kTK * (a.C + 4) + kTK * a.C);
  auto kern = DL == 4 ? fused_gated_attention_kernel<T, 4> : fused_gated_attention_kernel<T, 2>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<(unsigned)attn_blocks, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.qkv), a.gate, a.mask, static_cast<const T*>(a.wo_t), a.bo,
      static_cast<T*>(a.out), a.N, a.D, a.H, a.C, positions);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K8 on rows x [R1, R2, N, D]. Takes D up to 128, C a multiple of 4 up to 32
// and H C up to 128.
int prd_fused_gated(const void* x, const void* mask, const void* w_in, const void* bg,
                    const void* wo_t, const void* bo, void* qkv, void* gate, void* out, int dtype,
                    int R1, int R2, int N, int D, int H, int C, float scale, long long s1,
                    long long s2, long long sn, void* stream) {
  const bool ok = (dtype == 0 || dtype == 1) && R1 > 0 && R2 > 0 && N > 0 && D > 0 &&
                  D <= kMaxD && H > 0 && C > 0 && C <= 32 && C % 4 == 0 && H * C <= 128 &&
                  mask != nullptr;
  if (!ok) return (int)cudaErrorInvalidValue;
  const Args a{x, static_cast<const float*>(mask), w_in, static_cast<const float*>(bg), wo_t,
               static_cast<const float*>(bo), qkv, static_cast<float*>(gate), out,
               R1, R2, N, D, H, C, scale, s1, s2, sn, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch<float>(a);
  return (int)launch<__nv_bfloat16>(a);
}

}  // extern "C"
