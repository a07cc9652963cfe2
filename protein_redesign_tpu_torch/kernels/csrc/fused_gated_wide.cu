// Hand-written Hopper (sm_90a) kernels of K8, the fused gated rows
// attention, on the tensor cores (mma.sync in bf16, 3xTF32 in f32) where
// fused_gated_mma.cu's blocks stop:
//   fused_gated_project_mma_wide_kernel: the LN + projection past pair width
//     128, on ln_project.cuh's wide block (fused_gated_mma.cu's loader and
//     epilogue, fused_gated_rows.cuh): x^ = LN(x) in T, [64, D] x [D, 4 H C]
//     into the scratch q (scaled), k, v in T and the gate's sigmoid in f32;
//   fused_gated_out_mma_kernel: the split route's gate and out-projection,
//     out = round(g o) W_o + bo in T, o the heads' attention output [R N, H
//     C] in T (K3's bodies' output over the scratch) and g the gate.
//
// Replaces, with fused_gated_mma.cu, the Pallas TPU kernel K8 of
// protein_redesign_tpu/ops/pallas_attention.py, _fused_gated_impl (:1164) ->
// _make_fused_gated_kernel (:1064): the first kernel wherever D > 128, the
// second on the split route (ops.attention.fused_gated_body "split": the
// shapes past both bodies' tiles, up to the JAX kernel's reach of D 512, C
// 1024, H C 4096).
//
// What bounds them: at (D, H, C) = (128, 8, 128), bucket 192, B = 2 (R N =
// 73,728 positions), the out-projection is 19.3 GFLOP (2 R N H C D), about
// 20 us on the tensor cores in bf16, against 453 MB of g (f32) and o (bf16)
// read once (135 us at 3.35 TB/s): the bytes, which the block reads once
// per 64 output columns (a second column tile of the same positions runs
// next to the first: linear block order, columns fastest, so its reads
// come from L2). The projection past 128: as fused_gated_mma.cu's, the
// operations.
//
// fused_gated_out_mma_kernel: a block of 4 warps takes 64 positions x 64
// output columns, each warp 16 positions, K = H C in slices of 128 bytes a
// row (64 channels in bf16, 32 in f32), double-buffered: the W_o slice
// [K, 64] (wo_t [H C, Dw], Dw = D rounded up to 8 by the wrapper, zero
// columns past D) by cp.async, the A slice round(g o) [64, K] formed by the
// threads (4 channels a load of g and of o, the next slice's loads in
// flight during this slice's product) and stored as T; the product is
// ln_project.cuh's (lnp_product); out = sum + bo in T straight from the
// accumulators (the output is an eighth of the bytes read). Rounding as the
// split route's CUDA-core kernel had it: o arrives rounded to T, round(g o)
// formed in f32 and rounded to T, f32 sums.
//
// The entry points return cudaGetLastError().

#include "fused_gated_rows.cuh"

namespace {

using bf16 = __nv_bfloat16;

__host__ __device__ inline bool aligned_to(const void* p, unsigned bytes) {
  return (reinterpret_cast<unsigned long long>(p) & (bytes - 1)) == 0;
}

struct FgwArgs {
  const void* x;
  const void* w_in;
  const float* bg;
  void* qkv;
  float* gate;
  int R2, N, D, HC;
  float scale;
  long long s1, s2, sn, positions;
};

template <typename T>
__global__ void __launch_bounds__(kLnpThreads, kLnpMinBlocks)
    fused_gated_project_mma_wide_kernel(const FgwArgs a) {
  extern __shared__ __align__(16) unsigned char smem_fw[];
  const long long p0 = (long long)blockIdx.x * kLnpRows;
  const int rows = (int)min((long long)kLnpRows, a.positions - p0);
  const StridedRows<T> load =
      strided_rows(static_cast<const T*>(a.x), a.R2, a.N, a.D, a.s1, a.s2, a.sn);
  const QkvGate<T> epi{static_cast<T*>(a.qkv), a.gate, a.bg, a.HC, a.scale, a.positions};
  ln_project_wide<T>(load, static_cast<const T*>(a.w_in), a.D, 4 * a.HC, p0, rows, epi, smem_fw);
}

template <typename T>
cudaError_t launch_project(const FgwArgs& a, cudaStream_t stream) {
  const long long blocks = (a.positions + kLnpRows - 1) / kLnpRows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = lnw_smem_bytes<T>(a.D);
  const cudaError_t e = cudaFuncSetAttribute(fused_gated_project_mma_wide_kernel<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
  if (e != cudaSuccess) return e;
  fused_gated_project_mma_wide_kernel<T><<<(unsigned)blocks, kLnpThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

struct GoArgs {
  const void* o;
  const float* gate;
  const void* wo_t;
  const float* bo;
  void* out;
  long long positions;
  int D, Dw, HC;
};

// The A slice's row stride: bf16 72 (144 bytes, an odd number of 16-byte
// units: conflict-free ldmatrix), f32 36 (= 4 mod 8: conflict-free fragment
// reads).
template <typename T>
constexpr int kGoLd = kLnwK<T> + LnpOperand<T>::kPad;

// Four consecutive values of o as loaded (8 bytes of bf16, 16 of f32: the
// next slice's loads in flight hold no more registers than they must), and
// as f32.
template <typename T>
struct Quad {
  using type = float4;
};
template <>
struct Quad<bf16> {
  using type = uint2;
};

__device__ __forceinline__ uint2 load4(const bf16* p) { return *reinterpret_cast<const uint2*>(p); }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 to_f32(uint2 u) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float4 to_f32(float4 v) { return v; }

// Four values rounded to T into shared memory.
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// Blocks a SM of the out kernel, which caps its registers: 128 in f32, 168 in
// bf16, where the next slice's g and o in flight (48 registers) and the
// accumulators (32) would spill under 128. Shared memory (36 KB) is not the
// bound.
template <typename T>
constexpr int kGoMinBlocks = sizeof(T) == 2 ? 3 : kLnpMinBlocks;

template <typename T>
__global__ void __launch_bounds__(kLnpThreads, kGoMinBlocks<T>)
    fused_gated_out_mma_kernel(const GoArgs a) {
  constexpr int KS = kLnwK<T>, LD = kGoLd<T>, kDepth = LnpOperand<T>::kDepth;
  constexpr int kQuads = KS / 4;                              // 4-channel groups a row of a slice
  constexpr int kFill = kLnpRows * kQuads / kLnpThreads;      // groups a thread
  __shared__ __align__(16) T a_s[2][kLnpRows * LD];           // round(g o) slices
  __shared__ __align__(16) T w_s[2][KS * kLnpLdW];            // W_o slices
  const int col_tiles = (a.Dw + kLnpCols - 1) / kLnpCols;
  const long long tile = blockIdx.x / col_tiles;
  const int c0 = (int)(blockIdx.x - tile * col_tiles) * kLnpCols;
  const long long p0 = tile * kLnpRows;
  const int rows = (int)min((long long)kLnpRows, a.positions - p0);
  const int HC = a.HC;
  const int slices = ((HC + kDepth - 1) / kDepth * kDepth + KS - 1) / KS;
  const T* o = static_cast<const T*>(a.o);
  const T* wo = static_cast<const T*>(a.wo_t);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float4 gv[kFill];
  typename Quad<T>::type ov[kFill];
  // the loads of slice k0's g and o (zero past the rows and past H C)
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kFill; ++j) {
      const int i = threadIdx.x + kLnpThreads * j;
      const int p = i / kQuads, k = k0 + (i - p * kQuads) * 4;  // H C % 4 == 0: whole groups
      const bool ok = p < rows && k < HC;
      const long long at = (p0 + p) * HC + k;
      gv[j] = ok ? *reinterpret_cast<const float4*>(a.gate + at) : make_float4(0.f, 0.f, 0.f, 0.f);
      ov[j] = ok ? load4(o + at) : typename Quad<T>::type{};
    }
  };
  // round(g o) in T into an A slice
  auto put = [&](T* dst) {
#pragma unroll
    for (int j = 0; j < kFill; ++j) {
      const int i = threadIdx.x + kLnpThreads * j;
      const int p = i / kQuads, kk = (i - p * kQuads) * 4;
      const float4 v = to_f32(ov[j]);
      store4(dst + p * LD + kk,
             make_float4(gv[j].x * v.x, gv[j].y * v.y, gv[j].z * v.z, gv[j].w * v.w));
    }
  };

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  lnw_stage_w(wo, HC, a.Dw, 0, c0, w_s[0]);
  cp_async_commit();
  fetch(0);
  put(a_s[0]);
  const int depth = (HC + kDepth - 1) / kDepth * kDepth;
  for (int t = 0; t < slices; ++t) {
    const int buf = t & 1;
    cp_async_wait<0>();
    __syncthreads();  // slice t's W and A are in; every warp is done with slice t - 1's buffers
    const bool next = t + 1 < slices;
    if (next) {
      lnw_stage_w(wo, HC, a.Dw, (t + 1) * KS, c0, w_s[buf ^ 1]);
      cp_async_commit();
      fetch((t + 1) * KS);
    }
    lnp_product(a_s[buf] + warp * 16 * LD, LD, w_s[buf], min(KS, depth - t * KS), lane, acc);
    if (next) put(a_s[buf ^ 1]);
  }

  T* out = static_cast<T*>(a.out);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = warp * 16 + g + 8 * (e >> 1);
      const int col = c0 + n * 8 + 2 * t4 + (e & 1);
      if (p < rows && col < a.D) out[(p0 + p) * a.D + col] = Io<T>::cast(acc[n][e] + a.bo[col]);
    }
  }
}

template <typename T>
cudaError_t launch_out(const GoArgs& a, cudaStream_t stream) {
  const long long blocks =
      (a.positions + kLnpRows - 1) / kLnpRows * ((a.Dw + kLnpCols - 1) / kLnpCols);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fused_gated_out_mma_kernel<T><<<(unsigned)blocks, kLnpThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K8's LN + projection on the wide block (fused_gated_mma.cu's project():
// past D = 128, and on the split route where the narrow block's shared
// memory leaves fewer blocks a SM): x [R1, R2, N, D] through its strides
// into qkv [3, R1 R2 N, H C] (q scaled) in T and gate [R1 R2 N, H C] f32;
// dtype 0 f32 (3xTF32), 1 bf16. Takes D up to 512 and H C a multiple of 4.
int prd_fused_gated_project_wide(const void* x, const void* w_in, const void* bg, void* qkv,
                                 void* gate, int dtype, int R1, int R2, int N, int D, int HC,
                                 float scale, long long s1, long long s2, long long sn,
                                 void* stream) {
  const bool ok = (dtype == 0 || dtype == 1) && R1 > 0 && R2 > 0 && N > 0 && D > 0 &&
                  D <= kLnwMaxD && HC > 0 && HC % 4 == 0 && aligned_to(w_in, 16) &&
                  aligned_to(qkv, 16) && aligned_to(gate, 16);
  if (!ok) return (int)cudaErrorInvalidValue;
  const FgwArgs a{x, w_in, static_cast<const float*>(bg), qkv, static_cast<float*>(gate), R2, N,
                  D, HC, scale, s1, s2, sn, (long long)R1 * R2 * N};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_project<float>(a, s);
  return (int)launch_project<bf16>(a, s);
}

// The split route's gate and out-projection on the tensor cores: out
// [positions, D] = round(g o) W_o + bo in T, o [positions, H C] in T, gate
// [positions, H C] f32, wo_t [H C, Dw] in T (columns past D zero), bo [D]
// f32; dtype 0 f32 (3xTF32), 1 bf16. Takes H C a multiple of 4 and Dw a
// multiple of 8 with D <= Dw <= D + 7.
int prd_fused_gated_out_mma(const void* o, const void* gate, const void* wo_t, const void* bo,
                            void* out, int dtype, long long positions, int D, int Dw, int HC,
                            void* stream) {
  const bool ok = (dtype == 0 || dtype == 1) && positions > 0 && D > 0 && Dw >= D &&
                  Dw < D + 8 && Dw % 8 == 0 && HC > 0 && HC % 4 == 0 &&
                  aligned_to(o, dtype == 1 ? 8 : 16) && aligned_to(gate, 16) &&
                  aligned_to(wo_t, 16);
  if (!ok) return (int)cudaErrorInvalidValue;
  const GoArgs a{o, static_cast<const float*>(gate), wo_t, static_cast<const float*>(bo), out,
                 positions, D, Dw, HC};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_out<float>(a, s);
  return (int)launch_out<bf16>(a, s);
}

}  // extern "C"
