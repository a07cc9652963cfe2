// Hand-written Hopper (sm_90a) fused triangle multiplication, outgoing and incoming.
//
// Replaces the Pallas TPU kernel K9 of protein_redesign_tpu/ops/pallas_trimul.py,
// fused_triangle_multiply (:145) -> _trimul_kernel (:76), behind the switch
// use_pallas_trimul: both triangle multiplications of every FoldingBlock.
//
//   x = LN(pair);  a, b = sigmoid(x Wg + bg) * (x Wp + bp) * mask   (rounded to T)
//   outgoing: p[i, j, d] = sum_k a[i, k, d] b[j, k, d]
//   incoming: p[i, j, d] = sum_k a[k, i, d] b[k, j, d]
//   out = sigmoid(x Wog + bog) * (round(LN_d(p)) Wop + bop)            (in T)
//
// Statistics, the contraction, sums, biases and gates in f32; x, a, b, the
// normed product and the weights rounded to T (T = float: f32 throughout, the
// Pallas kernel in interpret mode).
//
// What bounds it: at bucket 192, B = 2, D = 64: 1.8 GFLOP of contraction
// (2 B N^3 D) and 3.6 of projections against ~19 MB of pair and output in
// bf16, so the operations, on the CUDA cores in f32 here (tensor cores are
// later work). The design keeps the f32 [N, N, D] product, its normed copy and
// the gated [N, N, 2D] activations' second pass out of device memory.
//
// Two kernels, launched back to back by one entry point:
// 1. trimul_project_kernel, one block per 64 pair positions: LN into a
//    transposed tile in shared memory (a warp per row), then, for each slice
//    of 64 channels, that slice's w_in columns staged beside it (a whole
//    [D, 5D] w_in would not fit at D = 128) and 4 x 4 register tiles (4
//    positions x 4 channels, 16 FMAs per two 16-byte shared loads) give a,
//    b and the out gate. a and b go to
//    channel-major scratch [B, D, N(k), N(i or j)]: for outgoing a[i, k] is
//    written at [d][k][i], for incoming a[k, i] at [d][k][i], so the main
//    kernel reads both modes the same way, the i (j) axis contiguous. The
//    out gate goes to f32 scratch [B, N, N, D]. Unlike the TPU grid, which
//    recomputes LN and the projections for every k tile, each is computed
//    once.
// 2. trimul_main_kernel, one block per (b, 16 i, 16 j): over slabs of 8 k the
//    block stages a[d][k][i-tile] and b[d][k][j-tile] for all D channels in
//    shared memory; warp w owns channels [w D/8, (w+1) D/8) and a lane a
//    2 i x 4 j register tile of each, 8 products per channel and k from two
//    shared-memory loads. The [D, 16, 16] f32 sum stays in registers; the
//    epilogue moves it to shared memory, and a warp per (i, j) takes LN over
//    d, the out-projection (W_op in shared memory) and the gate, and writes
//    the output row.
//
// Layout: pair contiguous [B, N, N, D] in T; mask contiguous f32 [B, N, N];
// w_in [D, 5D] in T = [gate_a | gate_b | proj_a | proj_b | out_gate] columns;
// b_in [5D] f32; wop_t [D, D] in T; bop [D] f32; scratch a_t, b_t
// [B, D, N, N] in T and gate [B, N, N, D] f32; out contiguous [B, N, N, D].
// Takes D a multiple of 8 up to 128 (AlphaFold2's pair width; the main
// kernel's [D, 16, 16] sum is D / 8 x 8 registers a lane). The entry point
// returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTP = 64;  // pair positions per projection block
constexpr int kLdP = kTP + 4;  // row stride of its transposed LN tile
constexpr int kT = 16;   // output tile kT x kT
constexpr int kTK = 8;   // k per staged slab
constexpr int kCW = 64;  // channels per staged slice of w_in columns
constexpr int kMaxD = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    trimul_project_kernel(const T* __restrict__ pair, const float* __restrict__ mask,
                          const T* __restrict__ w_in, const float* __restrict__ b_in,
                          T* __restrict__ a_t, T* __restrict__ b_t, float* __restrict__ gate,
                          int mode, int N, int D, long long positions) {
  extern __shared__ __align__(16) float smem[];
  const int W = 5 * D;
  constexpr int kLdW = 2 * kCW;
  float* xsT = smem;           // [D][kLdP]: the tile's LN rows, transposed
  float* ws = xsT + D * kLdP;  // [D][2 kCW]: a slice's gate and projection columns
  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * kTP;
  const int rows = (int)min((long long)kTP, positions - p0);
  for (int r = tid >> 5; r < kTP; r += kThreads / 32)
    layer_norm_to_column<T>(pair + (p0 + r) * D, r < rows, D, xsT + r, kLdP);

  // a and b: a unit is 4 positions x 4 channels of [a | b], two tiles (gate,
  // projection), over slices of kCW channels
  for (int s0 = 0; s0 < 2 * D; s0 += kCW) {
    const int width = min(kCW, 2 * D - s0);
    __syncthreads();  // the LN tile is in; the previous slice's reads are done
    for (int e = tid; e < D * width; e += kThreads) {
      const int d = e / width, c = e - d * width;
      ws[d * kLdW + c] = Io<T>::load(w_in + (long long)d * W + s0 + c);
      ws[d * kLdW + kCW + c] = Io<T>::load(w_in + (long long)d * W + 2 * D + s0 + c);
    }
    __syncthreads();
    const int ab_units = (kTP / 4) * (width / 4);
    for (int u = tid; u < ab_units; u += kThreads) {
      const int pg = u % (kTP / 4), cl = (u / (kTP / 4)) * 4, c0 = s0 + cl;
      float g[4][4], pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = pr[i][j] = 0.f;
      tile_4x4(g, xsT + pg * 4, kLdP, ws + cl, kLdW, D);
      tile_4x4(pr, xsT + pg * 4, kLdP, ws + kCW + cl, kLdW, D);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (pg * 4 + i >= rows) continue;
        const long long pos = p0 + pg * 4 + i;
        // pos = (bb, x, y) of the [B, N, N] pair grid
        const long long bx = pos / N;
        const int y = (int)(pos - bx * N);
        const long long bb = bx / N;
        const int x = (int)(bx - bb * N);
        const int k = mode == 0 ? y : x;
        const int ii = mode == 0 ? x : y;
        const float m = mask[pos];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + j;
          const float v = sigmoid_f(g[i][j] + b_in[c]) * (pr[i][j] + b_in[2 * D + c]) * m;
          T* dst = c < D ? a_t : b_t;
          const int ch = c < D ? c : c - D;
          dst[((bb * D + ch) * N + k) * N + ii] = Io<T>::cast(v);
        }
      }
    }
  }
  // the out gate: 4 positions x 4 channels per unit, over slices of kCW channels
  for (int s0 = 0; s0 < D; s0 += kCW) {
    const int width = min(kCW, D - s0);
    __syncthreads();
    for (int e = tid; e < D * width; e += kThreads) {
      const int d = e / width, c = e - d * width;
      ws[d * kLdW + c] = Io<T>::load(w_in + (long long)d * W + 4 * D + s0 + c);
    }
    __syncthreads();
    const int og_units = (kTP / 4) * (width / 4);
    for (int u = tid; u < og_units; u += kThreads) {
      const int pg = u % (kTP / 4), cl = (u / (kTP / 4)) * 4, c0 = s0 + cl;
      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
      tile_4x4(g, xsT + pg * 4, kLdP, ws + cl, kLdW, D);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (pg * 4 + i >= rows) continue;
        float* dst = gate + (p0 + pg * 4 + i) * D + c0;
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[j] = sigmoid_f(g[i][j] + b_in[4 * D + c0 + j]);
      }
    }
  }
}

template <typename T, int DPW>
__global__ void __launch_bounds__(kThreads)
    trimul_main_kernel(const T* __restrict__ a_t, const T* __restrict__ b_t,
                       const float* __restrict__ gate, const T* __restrict__ wop_t,
                       const float* __restrict__ bop, T* __restrict__ out, int N) {
  constexpr int D = DPW * 8;
  constexpr int kSlab = D * kTK * kT;
  constexpr int kRow = D + 1;  // padded product rows of the epilogue
  constexpr int kRegion = 2 * kSlab > kT * kT * kRow ? 2 * kSlab : kT * kT * kRow;
  extern __shared__ __align__(16) float smem[];
  float* as = smem;          // [D][kTK][kT]: a[d][k][i-tile]
  float* bs = smem + kSlab;  // [D][kTK][kT]: b[d][k][j-tile]
  float* ps = smem;          // epilogue: [kT * kT][kRow] products, over the slabs
  float* wops = smem + kRegion;  // epilogue: [D][D] out-projection

  const int b = blockIdx.z, i0 = blockIdx.y * kT, j0 = blockIdx.x * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ig = lane >> 2, jg = lane & 3;  // rows ig*2 + {0,1}, columns jg*4 + {0..3}
  const long long plane = (long long)N * N;
  const T* ab = a_t + (long long)b * D * plane;
  const T* bb = b_t + (long long)b * D * plane;

  float acc[DPW][2][4];
#pragma unroll
  for (int dd = 0; dd < DPW; ++dd)
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[dd][a][c] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kTK) {
    __syncthreads();  // the previous slab's reads are done
    for (int e = threadIdx.x; e < kSlab; e += kThreads) {
      const int t = e % kT;
      const int rest = e / kT;
      const int kk = rest % kTK;
      const int d = rest / kTK;
      const int k = k0 + kk;
      const long long row = d * plane + (long long)k * N;
      as[e] = k < N && i0 + t < N ? Io<T>::load(ab + row + i0 + t) : 0.f;
      bs[e] = k < N && j0 + t < N ? Io<T>::load(bb + row + j0 + t) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < DPW; ++dd) {
      const int d = warp * DPW + dd;
#pragma unroll
      for (int kk = 0; kk < kTK; ++kk) {
        const float2 av = *reinterpret_cast<const float2*>(as + (d * kTK + kk) * kT + ig * 2);
        const float4 bv = *reinterpret_cast<const float4*>(bs + (d * kTK + kk) * kT + jg * 4);
        const float a2[2] = {av.x, av.y};
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[dd][a][c] = fmaf(a2[a], b4[c], acc[dd][a][c]);
      }
    }
  }
  __syncthreads();  // the slabs are free

#pragma unroll
  for (int dd = 0; dd < DPW; ++dd)
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ps[((ig * 2 + a) * kT + jg * 4 + c) * kRow + warp * DPW + dd] = acc[dd][a][c];
  for (int e = threadIdx.x; e < D * D; e += kThreads) wops[e] = Io<T>::load(wop_t + e);
  __syncthreads();

  // a warp per output position: LN over d, out-projection, gate
  for (int p = warp; p < kT * kT; p += kThreads / 32) {
    const int i = i0 + p / kT, j = j0 + p % kT;
    if (i >= N || j >= N) continue;  // warp-uniform
    float* row = ps + p * kRow;
    constexpr int kV = (D + 31) / 32;  // channels lane + 32 v per lane
    float t[kV];
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      t[v] = lane + 32 * v < D ? row[lane + 32 * v] : 0.f;
      sum += t[v];
    }
    const float mu = warp_sum(sum) / (float)D;
    float sq = 0.f;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      t[v] = lane + 32 * v < D ? t[v] - mu : 0.f;
      sq += t[v] * t[v];
    }
    const float rstd = rsqrtf(warp_sum(sq) / (float)D + 1e-5f);
    __syncwarp();
#pragma unroll
    for (int v = 0; v < kV; ++v)
      if (lane + 32 * v < D) row[lane + 32 * v] = Io<T>::round(t[v] * rstd);
    __syncwarp();
    const long long pos = ((long long)b * N + i) * N + j;
    for (int e = lane; e < D; e += 32) {
      float core = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) core = fmaf(row[d], wops[d * D + e], core);
      out[pos * D + e] = Io<T>::cast(gate[pos * D + e] * (core + bop[e]));
    }
  }
}

struct Args {
  const void* pair;
  const float* mask;
  const void* w_in;
  const float* b_in;
  const void* wop_t;
  const float* bop;
  void* a_t;
  void* b_t;
  float* gate;
  void* out;
  int mode, B, N, D;
  cudaStream_t stream;
};

template <typename T, int DPW>
cudaError_t launch_main(const Args& a) {
  constexpr int D = DPW * 8;
  constexpr int kSlab = D * kTK * kT;
  constexpr int kRegion = 2 * kSlab > kT * kT * (D + 1) ? 2 * kSlab : kT * kT * (D + 1);
  const size_t smem = sizeof(float) * (size_t)(kRegion + D * D);
  auto kern = trimul_main_kernel<T, DPW>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int tiles = (a.N + kT - 1) / kT;
  kern<<<dim3(tiles, tiles, a.B), kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.a_t), static_cast<const T*>(a.b_t), a.gate,
      static_cast<const T*>(a.wop_t), a.bop, static_cast<T*>(a.out), a.N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a) {
  const long long positions = (long long)a.B * a.N * a.N;
  const long long blocks = (positions + kTP - 1) / kTP;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)a.D * (kLdP + 2 * kCW);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trimul_project_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  trimul_project_kernel<T><<<(unsigned)blocks, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.pair), a.mask, static_cast<const T*>(a.w_in), a.b_in,
      static_cast<T*>(a.a_t), static_cast<T*>(a.b_t), a.gate, a.mode, a.N, a.D, positions);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  switch (a.D / 8) {
    case 1: return launch_main<T, 1>(a);
    case 2: return launch_main<T, 2>(a);
    case 3: return launch_main<T, 3>(a);
    case 4: return launch_main<T, 4>(a);
    case 5: return launch_main<T, 5>(a);
    case 6: return launch_main<T, 6>(a);
    case 7: return launch_main<T, 7>(a);
    case 8: return launch_main<T, 8>(a);
    case 9: return launch_main<T, 9>(a);
    case 10: return launch_main<T, 10>(a);
    case 11: return launch_main<T, 11>(a);
    case 12: return launch_main<T, 12>(a);
    case 13: return launch_main<T, 13>(a);
    case 14: return launch_main<T, 14>(a);
    case 15: return launch_main<T, 15>(a);
    default: return launch_main<T, 16>(a);
  }
}

}  // namespace

extern "C" {

// K9: mode 0 outgoing, 1 incoming. Takes D a multiple of 8 up to 128, B up
// to 65535 and N up to 65535 * 16.
int prd_trimul(const void* pair, const void* mask, const void* w_in, const void* b_in,
               const void* wop_t, const void* bop, void* a_t, void* b_t, void* gate, void* out,
               int dtype, int mode, int B, int N, int D, void* stream) {
  const bool ok = (dtype == 0 || dtype == 1) && (mode == 0 || mode == 1) && B > 0 &&
                  B <= 65535 && N > 0 && (N + kT - 1) / kT <= 65535 && D > 0 && D <= kMaxD &&
                  D % 8 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  const Args a{pair, static_cast<const float*>(mask), w_in, static_cast<const float*>(b_in),
               wop_t, static_cast<const float*>(bop), a_t, b_t, static_cast<float*>(gate), out,
               mode, B, N, D, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch<float>(a);
  return (int)launch<__nv_bfloat16>(a);
}

}  // extern "C"
