// Hand-written Hopper (sm_90a) fused OuterLinear:
//   out[b, i, j, :] = (xl_i * xl_j) . W1 + u_i + (bias - u_j)
//
// Replaces the Pallas TPU kernel K11 of protein_redesign_tpu/ops/pallas_outer.py,
// _fused_outer_impl (:72) -> _make_kernel (:55), behind the switch
// use_pallas_outer: FoldingBlock's pair update from the single representation,
// Linear(cat[x_i * x_j, x_i - x_j]) split as W = [W1; W2] with u = LN(x) W2.
// As in the JAX package, the LayerNorm and u ([B, N, D], f32) are computed
// outside the kernel (ops/outer.py); the kernel computes the O(N^2 S D)
// product and the sums, and the [B, N, N, 2S] concat features of the unfused
// route never exist.
//
// Per (b, i, j, d): the products xl_i[s] * xl_j[s] rounded to T (as the TPU
// kernel rounds them to its compute type), times W1[s, d] (T), summed in f32
// over s, then + u_i[d] + (bias[d] - u_j[d]) in f32, the output in T.
//
// What bounds it: 2 B N^2 S D operations (4.8 GFLOP at bucket 192, B = 2,
// S = 512, D = 64) against one write of the [B, N, N, D] output, so the
// operations. They run on the CUDA cores in f32 (tensor cores are later work).
//
// Layout of the work: one block of 256 threads per (b, i, tile of 64 j, slice
// of output channels). Over chunks of 32 s, the block stages the chunk's
// products P[s][j] (rounded) and its W1[s][slice] in shared memory; each
// thread keeps a 4 j x 4 d register tile per group of 64 output channels
// (one group up to D = 64, two up to 128, as AlphaFold2's pair width) and
// adds 16 products per s and group from two 16-byte shared-memory loads.
// Up to D = 128 the slice is the whole width; wider pairs take slices of 128
// channels, each a block of its own that forms the chunk's products again
// (the products cost N^2 S against the N^2 S D of the sums), so the
// registers and shared memory stay those of D = 128 at any D.
//
// Layout: xl contiguous [B, N, S] in T; u contiguous [B, N, D] f32; w1t
// [S, D] in T; bias [D] f32; out contiguous [B, N, N, D] in T. Takes D from
// 1 to 512 (channels past D are zero-weighted in shared memory and never
// stored). The entry point returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTJ = 64;  // j per block: 16 groups of 4
constexpr int kKS = 32;  // s per staged chunk
constexpr int kGroup = 64;  // output channels per group: 16 threads of 4
constexpr int kSlice = 2 * kGroup;  // output channels per block past D = 128
constexpr int kMaxD = 512;

// NG groups of 64 output channels per block; block x walks (j tile, channel
// slice), the slice starting at channel d0 (D <= d0 + 64 NG).
template <typename T, int NG>
__global__ void __launch_bounds__(kThreads)
    outer_kernel(const T* __restrict__ xl, const float* __restrict__ u,
                 const T* __restrict__ w1t, const float* __restrict__ bias, T* __restrict__ out,
                 int N, int S, int D, int slices) {
  constexpr int DW = NG * kGroup;
  __shared__ __align__(16) float ps[kKS][kTJ];  // round(xl_i[s] * xl_j[s])
  __shared__ __align__(16) float ws[kKS][DW];   // W1 rows, zero past D
  __shared__ float xi[kKS];

  const int jt = blockIdx.x / slices;
  const int b = blockIdx.z, i = blockIdx.y, j0 = jt * kTJ;
  const int d0 = (blockIdx.x - jt * slices) * DW;
  const int tid = threadIdx.x;
  const int jg = tid >> 4, dg = tid & 15;
  const T* xb = xl + (long long)b * N * S;

  float acc[NG][4][4];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[g][a][c] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kKS) {
    __syncthreads();  // the previous chunk's reads are done
    if (tid < kKS) xi[tid] = s0 + tid < S ? Io<T>::load(xb + (long long)i * S + s0 + tid) : 0.f;
    for (int e = tid; e < kKS * DW; e += kThreads) {
      const int s = e / DW, d = e - s * DW;
      ws[s][d] = s0 + s < S && d0 + d < D ? Io<T>::load(w1t + (long long)(s0 + s) * D + d0 + d)
                                          : 0.f;
    }
    __syncthreads();  // xi is in
    for (int e = tid; e < kKS * kTJ; e += kThreads) {
      const int s = e / kTJ, jj = e - s * kTJ;
      const int j = j0 + jj;
      float p = 0.f;
      if (j < N && s0 + s < S) p = Io<T>::round(xi[s] * Io<T>::load(xb + (long long)j * S + s0 + s));
      ps[s][jj] = p;
    }
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < kKS; ++s) {
      const float4 pv = *reinterpret_cast<const float4*>(&ps[s][jg * 4]);
      const float p4[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 wv = *reinterpret_cast<const float4*>(&ws[s][g * kGroup + dg * 4]);
        const float w4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[g][a][c] = fmaf(p4[a], w4[c], acc[g][a][c]);
      }
    }
  }

  const float* ub = u + (long long)b * N * D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + jg * 4 + a;
    if (j >= N) continue;
    T* o = out + (((long long)b * N + i) * N + j) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = d0 + g * kGroup + dg * 4 + c;
        if (d < D)
          o[d] = Io<T>::cast((acc[g][a][c] + ub[(long long)i * D + d]) +
                             (bias[d] - ub[(long long)j * D + d]));
      }
  }
}

template <typename T>
cudaError_t launch(const void* xl, const float* u, const void* w1t, const float* bias, void* out,
                   int B, int N, int S, int D, cudaStream_t stream) {
  const int slices = (D + kSlice - 1) / kSlice;
  const dim3 grid((N + kTJ - 1) / kTJ * slices, N, B);
  auto kern = D > kGroup ? outer_kernel<T, 2> : outer_kernel<T, 1>;
  kern<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(xl), u, static_cast<const T*>(w1t),
                                      bias, static_cast<T*>(out), N, S, D, slices);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K11's product and sums. Takes D from 1 to 512 and B, N up to 65535.
int prd_outer(const void* xl, const void* u, const void* w1t, const void* bias, void* out,
              int dtype, int B, int N, int S, int D, void* stream) {
  const bool ok = (dtype == 0 || dtype == 1) && B > 0 && B <= 65535 && N > 0 && N <= 65535 &&
                  S > 0 && D > 0 && D <= kMaxD;
  if (!ok) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto uf = static_cast<const float*>(u);
  const auto bf = static_cast<const float*>(bias);
  if (dtype == 0) return (int)launch<float>(xl, uf, w1t, bf, out, B, N, S, D, s);
  return (int)launch<__nv_bfloat16>(xl, uf, w1t, bf, out, B, N, S, D, s);
}

}  // extern "C"
