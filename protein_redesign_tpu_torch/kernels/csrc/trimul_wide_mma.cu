// Hand-written Hopper (sm_90a) fused triangle multiplication past pair width
// 128: K9's two LN + projection stages on ln_project.cuh's wide block (the
// tensor cores: mma.sync in bf16, 3xTF32 in f32), for D a multiple of 8 from
// 136 to 512.
//
// Replaces, with trimul_mma.cu, the Pallas TPU kernel K9 of
// protein_redesign_tpu/ops/pallas_trimul.py, fused_triangle_multiply (:145) ->
// _trimul_kernel (:76), at the pair widths past trimul_mma.cu's block (the
// JAX kernel takes any width its VMEM holds). trimul_mma.cu's entry point
// runs these two kernels around its contraction, which D never enters:
//   trimul_project_mma_wide_kernel: LN of 64 pair positions, x^ rounded to
//     T, [64, D] x [D, 5 D] (w_in in trimul_mma.cu's interleaved order) into
//     the contraction's scratch and the out gate;
//   trimul_out_mma_wide_kernel: LN of 64 positions of the channel-major f32
//     product, round(x^) W_op^T + bop, times the out gate, in T.
// Loaders and epilogues are trimul_mma.cu's (trimul_rows.cuh); what changes
// is the block: the A tile alone stays resident, LN takes two passes over
// the rows in 64-column chunks, W streams in K slices of 128 bytes a column.
//
// What bounds it: at bucket 192, B = 2, D = 192, 32.6 GFLOP of projections
// (2 B N^2 D 6 D) and 5.4 of contraction, about 38 us on the tensor cores
// in bf16, against ~57 MB of pair in and out (~17 us at 3.35 TB/s): the
// operations, which trimul_mma.cu's CUDA-core wide body does in f32 FMAs.
//
// The entry point returns cudaGetLastError().

#include "trimul_rows.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kLnpThreads, kLnpMinBlocks)
    trimul_project_mma_wide_kernel(const TmArgs a) {
  extern __shared__ __align__(16) unsigned char smem_tw[];
  const long long positions = (long long)a.B * a.N * a.N;
  const long long p0 = (long long)blockIdx.x * kLnpRows;
  const int rows = (int)min((long long)kLnpRows, positions - p0);
  const PairRows<T> load{static_cast<const T*>(a.pair), a.D};
  const GatedPair<T> epi{a.b_in, a.mask, static_cast<T*>(a.a_t), static_cast<T*>(a.b_t), a.gate,
                         a.N, (a.N + 7) & ~7, a.D};
  ln_project_wide<T>(load, static_cast<const T*>(a.w_in), a.D, 5 * a.D, p0, rows, epi, smem_tw);
}

template <typename T>
__global__ void __launch_bounds__(kLnpThreads, kLnpMinBlocks)
    trimul_out_mma_wide_kernel(const TmArgs a) {
  extern __shared__ __align__(16) unsigned char smem_tw[];
  const long long positions = (long long)a.B * a.N * a.N;
  const long long p0 = (long long)blockIdx.x * kLnpRows;
  const int rows = (int)min((long long)kLnpRows, positions - p0);
  const ProductRows load{a.prod, a.N, a.D};
  const GatedOut<T> epi{a.gate, a.bop, static_cast<T*>(a.out), a.D};
  ln_project_wide<T>(load, static_cast<const T*>(a.wop_t), a.D, a.D, p0, rows, epi, smem_tw);
}

template <typename T>
cudaError_t launch(const TmArgs& a, bool out, cudaStream_t stream) {
  const long long blocks = ((long long)a.B * a.N * a.N + kLnpRows - 1) / kLnpRows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto kern = out ? trimul_out_mma_wide_kernel<T> : trimul_project_mma_wide_kernel<T>;
  const size_t smem = lnw_smem_bytes<T>(a.D);
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)blocks, kLnpThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One of K9's wide LN + projection stages (stage 0 the projection, 1 the
// out-projection) for trimul_mma.cu's entry point: args a TmArgs
// (trimul_rows.cuh), dtype 0 f32 (3xTF32), 1 bf16. Takes D a multiple of 8
// from 136 to 512.
int prd_trimul_mma_wide_stage(const void* args, int stage, int dtype, void* stream) {
  const TmArgs& a = *static_cast<const TmArgs*>(args);
  if (!(a.D > kLnpMaxD && a.D <= kLnwMaxD && a.D % 8 == 0 && (stage == 0 || stage == 1) &&
        (dtype == 0 || dtype == 1)))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, stage == 1, s);
  return (int)launch<__nv_bfloat16>(a, stage == 1, s);
}

}  // extern "C"
