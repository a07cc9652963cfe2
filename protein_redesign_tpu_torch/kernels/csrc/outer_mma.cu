// Hand-written Hopper (sm_90a) tensor-core body of the fused OuterLinear,
// in both dtypes:
//
//   out[b, i, j, :] = round_T(xl_i * xl_j) . W1 + u_i + (bias - u_j)
//
// Replaces the Pallas TPU kernel K11 of protein_redesign_tpu/ops/pallas_outer.py,
// _fused_outer_impl (:72) -> _make_kernel (:55), behind the switch
// use_pallas_outer, for pair widths D that are multiples of 8 up to 128
// (outer.cu, the CUDA-core body, stays for D = 4 mod 8 and callable to time
// it beside this one). As in the JAX package, the LayerNorm and u = LN(x) W2
// ([B, N, D], f32) are computed outside the kernel (ops/outer.py).
//
// Per (b, i, j, d), as outer_reference: the products xl_i[s] * xl_j[s]
// rounded to T, times W1[d, s] rounded to T, summed in f32 over s, then
// (acc + u_i[d]) + (bias[d] - u_j[d]) in f32, the output rounded to T.
//
// What bounds it: 2 B N^2 S D operations (4.8 GFLOP at bucket 192, B = 2,
// S = 512, D = 64) against one write of the [B, N, N, D] output (9.4 MB in
// bf16): about 500 operations a byte, past the card's ~295, so the tensor
// cores. For a fixed (b, i) the output tile is a GEMM, A_i W1^T with
// A_i[j, s] = round_T(xl_i[s] xl_j[s]): M = the j's, K = S, N = D. W1 and
// the xl_j rows do not depend on i, so a warp loads its xl_j fragment and
// W1's fragments once per k-step and runs them against TI rows i at once.
//
// Layout of the work: a block of kWarpsJ x kWarpsI = 2 x 4 warps owns one
// task, a tile of 32 rows j and 4 TI rows i of one complex b; warp (wj, wi)
// owns 16 rows j and TI rows i, with f32 accumulators for each of its TI
// rows (TI = 2, 4 in f32 up to D = 64: at most 128 accumulators a thread;
// bf16 at 2 fits two blocks on an SM). The n-tiles run to 64 or 128 channels (ND = 8 or 16), W1's rows
// past D zero. S streams through shared memory in chunks of 64 by cp.async,
// two or three in flight: the xl_j tile [32][64], W1's chunk [DP][64] and the
// task's xl_i rows, all in T. W1 keeps the Linear's layout: row d of the
// [D, 2S] weight holds W1[d, :] in its first S columns, contiguous along the
// product's depth, the B operand's layout for ldmatrix without .trans (an f32
// model's weight is read in place, row stride 2S). A block takes one task,
// and W1's chunks stream through the ring with the rows.

// Products formed in registers. bf16: the xl_j A fragment of m16n8k16
// (ldmatrix) times the pairs (xl_i[k], xl_i[k + 1]) of its columns by
// __hmul2, which rounds to nearest as the plain version's bf16 product does
// (a product of two bf16 numbers is exact in f32), so the tensor cores see
// the plain version's bits; W1's B fragments (ldmatrix, two n-tiles a load)
// serve the TI rows i. f32: 3xTF32 (mma.cuh's mma_3xtf32, a fresh
// fragment per product: the tensor cores' f32 sums truncate) on m16n8k8
// with the k slots renumbered (slot t is column 2t, slot t + 4 column 2t +
// 1), so that the xl_j, xl_i and W1 values of a fragment are 8-byte pairs;
// the product p = xl_i xl_j is formed in f32 and split, W1 split as read.
// The split keeps 22 of p's 24 bits, so a one-hot W1 gives p within 2^-22
// of itself (bf16: exactly).
//
// Epilogue: the task's u_i and u_j rows and the bias land in shared memory
// by cp.async behind its last chunk's products; per row i and group of 64
// channels, each warp adds u_i, then (bias - u_j), to its sums in f32 in the
// accumulators' layout, rounds to T into its own tile, and writes whole
// output rows in 16-byte pieces (16-byte scattered stores straight from the
// accumulators ran slower than the math in the fused gated attention).
//
// Layout: xl contiguous [B, N, S] in T; u contiguous [B, N, D] f32; w1 in
// T, row d at w1 + d * ldw, S values (the Linear's [D, 2S] weight: ldw =
// 2S); bias [D] f32; out contiguous [B, N, N, D] in T. S and ldw multiples
// of 8 in bf16 and 4 in f32 (one 16-byte piece; the last chunk of 64 is
// zero-padded), D a multiple of 8 up to 128; xl, u, w1, bias and out start
// on 16 bytes. The entry point returns cudaGetLastError().

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kKC = 64;             // s per staged chunk
constexpr int kLd = kKC + 8;        // xl_j and W1 chunk row stride (elements)
constexpr int kLdE = 64 + 8;        // epilogue tile row stride (T)
constexpr int kMaxD = 128;
constexpr int kWarpsJ = 2;          // warps along j: 32 rows j a task
constexpr int kWarpsI = 4;          // warps along i: 4 TI rows i a task
// Chunks in flight: three, two for f32 past D = 64 (shared memory).
__host__ __device__ constexpr int ring_depth(int bytes, int ND) {
  return bytes == 4 && ND > 8 ? 2 : 3;
}
constexpr size_t kMaxSmem = 232448;  // bytes a block can use on the H100

// TI, the rows i a warp keeps accumulators for, by element size and n-tiles
// of 8 channels.
__host__ __device__ constexpr int rows_i(int bytes, int ND) {
  return bytes == 2 || ND > 8 ? 2 : 4;
}

// kLd and kLdE: bf16 rows of 144 bytes (an odd number of 16-byte units:
// conflict-free ldmatrix, and 4-byte fragment writes 4 words apart a row);
// f32 rows of 72 floats (8 mod 32: conflict-free 8-byte fragment reads and
// writes). The u rows: DP + 8 floats (8 mod 32).
template <typename T, int ND>
struct Cfg {
  static constexpr int TI = rows_i(sizeof(T), ND), kRing = ring_depth(sizeof(T), ND);
  static constexpr int kWarps = kWarpsJ * kWarpsI, kThreads = 32 * kWarps;
  static constexpr int JT = 16 * kWarpsJ, TIB = TI * kWarpsI, DP = 8 * ND, kLdU = DP + 8;
  static constexpr int kPiece = 16 / sizeof(T);  // T elements in 16 bytes
};

// Shared memory: the W1, xl_j and xl_i rings, the task's u rows (TIB rows
// i, JT rows j, then the bias; f32) and the warps' epilogue tiles
// ([16][kLdE] in T).
template <typename T, int ND>
__host__ __device__ constexpr size_t smem_bytes() {
  using C = Cfg<T, ND>;
  return (size_t)C::kRing * (C::DP * kLd + C::JT * kLd + C::TIB * kKC) * sizeof(T) +
         (size_t)(C::TIB + C::JT + 1) * C::kLdU * sizeof(float) +
         (size_t)C::kWarps * 16 * kLdE * sizeof(T);
}

struct OArgs {
  const void* xl;
  const float* u;
  const void* w1;
  const float* bias;
  void* out;
  long long ldw;
  int B, N, S, D;
};

__device__ __forceinline__ unsigned hmul2(unsigned a, unsigned b) {
  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                   *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const unsigned*>(&r);
}

// One k-step of 16 (bf16) over a chunk: the warp's 16 rows j against W1's
// ND n-tiles (zero rows past D) for its TI rows i. xt: the warp's xl_j rows
// (row stride kLd); wt: W1's chunk [DP][kLd]; xit: the warp's xl_i rows
// [TI][kKC]. Every fragment is loaded before the first product.
template <int ND, int TI>
__device__ __forceinline__ void step_bf16(float (&acc)[TI][ND][4], const bf16* xt, const bf16* wt,
                                          const bf16* xit, int kk, int lane) {
  const int t = lane & 3;
  unsigned a[4], x[TI][2], w[ND / 2][4], p[TI][4];
  load_a_frag(a, xt, kLd, kk, lane);
#pragma unroll
  for (int ii = 0; ii < TI; ++ii) {
    x[ii][0] = *reinterpret_cast<const unsigned*>(xit + ii * kKC + kk + 2 * t);
    x[ii][1] = *reinterpret_cast<const unsigned*>(xit + ii * kKC + kk + 8 + 2 * t);
  }
#pragma unroll
  for (int n = 0; n < ND / 2; ++n) load_bt_frags(w[n], wt, kLd, n * 16, kk, lane);
#pragma unroll
  for (int ii = 0; ii < TI; ++ii) {
    p[ii][0] = hmul2(a[0], x[ii][0]);
    p[ii][1] = hmul2(a[1], x[ii][0]);
    p[ii][2] = hmul2(a[2], x[ii][1]);
    p[ii][3] = hmul2(a[3], x[ii][1]);
  }
#pragma unroll
  for (int n = 0; n < ND / 2; ++n)
#pragma unroll
    for (int ii = 0; ii < TI; ++ii) {
      mma_bf16_16816(acc[ii][2 * n], p[ii], w[n][0], w[n][1]);
      mma_bf16_16816(acc[ii][2 * n + 1], p[ii], w[n][2], w[n][3]);
    }
}

// One k-step of 8 (f32, 3xTF32), slot t <-> column 2t, slot t + 4 <-> 2t + 1.
template <int ND, int TI>
__device__ __forceinline__ void step_f32(float (&acc)[TI][ND][4], const float* xt, const float* wt,
                                         const float* xit, int kk, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float2 xa = *reinterpret_cast<const float2*>(xt + g * kLd + kk + 2 * t);
  const float2 xb = *reinterpret_cast<const float2*>(xt + (g + 8) * kLd + kk + 2 * t);
  unsigned ab[TI][4], as[TI][4];
#pragma unroll
  for (int ii = 0; ii < TI; ++ii) {
    const float2 xi = *reinterpret_cast<const float2*>(xit + ii * kKC + kk + 2 * t);
    split_tf32(xa.x * xi.x, ab[ii][0], as[ii][0]);  // A[g][t]
    split_tf32(xb.x * xi.x, ab[ii][1], as[ii][1]);  // A[g + 8][t]
    split_tf32(xa.y * xi.y, ab[ii][2], as[ii][2]);  // A[g][t + 4]
    split_tf32(xb.y * xi.y, ab[ii][3], as[ii][3]);  // A[g + 8][t + 4]
  }
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const float2 w = *reinterpret_cast<const float2*>(wt + (n * 8 + g) * kLd + kk + 2 * t);
    unsigned wb0, ws0, wb1, ws1;
    split_tf32(w.x, wb0, ws0);  // B[t][g]
    split_tf32(w.y, wb1, ws1);  // B[t + 4][g]
#pragma unroll
    for (int ii = 0; ii < TI; ++ii) mma_3xtf32(acc[ii][n], ab[ii], as[ii], wb0, wb1, ws0, ws1);
  }
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Rows [row0, row0 + ROWS) and columns [col0, col0 + kKC) of a row-major
// matrix of nrows x ncols (row stride ld_src) into dst (row stride ld_dst)
// by cp.async, zero past nrows and ncols (ncols a multiple of 16 bytes).
template <typename T, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows(const T* src, long long ld_src, int row0, int nrows,
                                           int col0, int ncols, T* dst, int ld_dst, int tid) {
  constexpr int E = 16 / sizeof(T), kPerRow = kKC / E, kCount = ROWS * kPerRow;
#pragma unroll
  for (int q = 0; q < (kCount + THREADS - 1) / THREADS; ++q) {
    const int e = tid + q * THREADS;
    if (kCount % THREADS != 0 && e >= kCount) break;
    const int r = e / kPerRow, cc = (e % kPerRow) * E;
    const bool ok = row0 + r < nrows && col0 + cc < ncols;
    cp_async16(dst + r * ld_dst + cc, ok ? src + (row0 + r) * ld_src + col0 + cc : src, ok);
  }
}

template <typename T, int ND>
__global__ void __launch_bounds__(Cfg<T, ND>::kThreads) outer_mma_kernel(OArgs a) {
  using C = Cfg<T, ND>;
  constexpr int TI = C::TI, E = C::kPiece, kRing = C::kRing;
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = a.N, S = a.S, D = a.D;
  const int nch = (S + kKC - 1) / kKC;
  T* w_s = reinterpret_cast<T*>(smem);
  T* x_s = w_s + kRing * C::DP * kLd;
  T* xi_s = x_s + kRing * C::JT * kLd;
  float* u_s = reinterpret_cast<float*>(xi_s + kRing * C::TIB * kKC);
  T* ep_s = reinterpret_cast<T*>(u_s + (C::TIB + C::JT + 1) * C::kLdU);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wj = warp % kWarpsJ, wi = warp / kWarpsJ;
  // the block's task: (b, first j, first i), j fastest
  const int jtiles = (N + C::JT - 1) / C::JT, igroups = (N + C::TIB - 1) / C::TIB;
  const long long task = blockIdx.x, rest = task / jtiles;
  const int j0 = (int)(task - rest * jtiles) * C::JT;
  const int i0 = (int)(rest % igroups) * C::TIB;
  const int b = (int)(rest / igroups);
  const T* xb = static_cast<const T*>(a.xl) + (long long)b * N * S;

  // Chunk c's xl_j rows, xl_i rows and W1 rows into ring slot c % kRing; one
  // commit group a chunk, empty past the last.
  auto load_chunk = [&](int c) {
    if (c < nch) {
      const int s0 = c * kKC, slot = c % kRing;
      stage_rows<T, C::JT, C::kThreads>(xb, S, j0, N, s0, S, x_s + slot * C::JT * kLd, kLd, tid);
      stage_rows<T, C::TIB, C::kThreads>(xb, S, i0, N, s0, S, xi_s + slot * C::TIB * kKC, kKC,
                                         tid);
      stage_rows<T, C::DP, C::kThreads>(static_cast<const T*>(a.w1), a.ldw, 0, D, s0, S,
                                        w_s + slot * C::DP * kLd, kLd, tid);
    }
    cp_async_commit();
  };

  // The task's u rows: u_i of its TIB rows i, u_j of its JT rows j (zero
  // past N), then the bias; one commit group.
  auto load_u = [&]() {
    const float* ub = a.u + (long long)b * N * D;
    constexpr int kPerRow = C::DP / 4, kCount = (C::TIB + C::JT + 1) * kPerRow;
#pragma unroll
    for (int q = 0; q < (kCount + C::kThreads - 1) / C::kThreads; ++q) {
      const int e = tid + q * C::kThreads;
      if (kCount % C::kThreads != 0 && e >= kCount) break;
      const int r = e / kPerRow, cc = (e % kPerRow) * 4;
      const int row = r < C::TIB ? i0 + r : j0 + r - C::TIB;
      const bool bias = r == C::TIB + C::JT, ok = cc < D && (bias || row < N);
      const float* src = bias ? a.bias + cc : ub + (long long)row * D + cc;
      cp_async16(u_s + r * C::kLdU + cc, ok ? src : a.bias, ok);
    }
    cp_async_commit();
  };

  float acc[TI][ND][4];
#pragma unroll
  for (int ii = 0; ii < TI; ++ii)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[ii][n][q] = 0.f;
  for (int c = 0; c < kRing - 1; ++c) load_chunk(c);
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1's slot
    if (c == nch - 1) load_u();  // landing behind the last chunk's products
    load_chunk(c + kRing - 1);
    const int slot = c % kRing;
    const T* xt = x_s + slot * C::JT * kLd + wj * 16 * kLd;
    const T* wt = w_s + slot * C::DP * kLd;
    const T* xit = xi_s + slot * C::TIB * kKC + wi * TI * kKC;
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) step_bf16<ND, TI>(acc, xt, wt, xit, kk, lane);
    } else {
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 8) step_f32<ND, TI>(acc, xt, wt, xit, kk, lane);
    }
  }

  // The task's epilogue: per row i and group of 64 channels, the warp
  // adds u_i, then bias - u_j, to its sums in the accumulators' layout,
  // rounds to T into its tile, and writes whole rows in 16-byte pieces.
  cp_async_wait<1>();  // the u rows are in (the newest group is the prefetch)
  __syncthreads();
  const int jl = wj * 16, il = wi * TI, g = lane >> 2, q4 = lane & 3;
  T* tile = ep_s + warp * 16 * kLdE;
  const float* bias_s = u_s + (C::TIB + C::JT) * C::kLdU;
  const float* uj0 = u_s + (C::TIB + jl + g) * C::kLdU;
  const float* uj1 = uj0 + 8 * C::kLdU;
#pragma unroll
  for (int cg = 0; cg < ND / 8; ++cg) {
    if (cg * 64 >= D) break;
    const int ppr = min(64, D - cg * 64) / E;  // 16-byte pieces a row
#pragma unroll
    for (int ii = 0; ii < TI; ++ii) {
      const float* ui = u_s + (il + ii) * C::kLdU;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = cg * 64 + n * 8 + 2 * q4;
        const float2 u = *reinterpret_cast<const float2*>(ui + d);
        const float2 bb = *reinterpret_cast<const float2*>(bias_s + d);
        const float2 v0 = *reinterpret_cast<const float2*>(uj0 + d);
        const float2 v1 = *reinterpret_cast<const float2*>(uj1 + d);
        const int m = cg * 8 + n;
        store2(tile + g * kLdE + n * 8 + 2 * q4, (acc[ii][m][0] + u.x) + (bb.x - v0.x),
               (acc[ii][m][1] + u.y) + (bb.y - v0.y));
        store2(tile + (g + 8) * kLdE + n * 8 + 2 * q4, (acc[ii][m][2] + u.x) + (bb.x - v1.x),
               (acc[ii][m][3] + u.y) + (bb.y - v1.y));
      }
      __syncwarp();
      const int i = i0 + il + ii;
      T* orow = static_cast<T*>(a.out) + (((long long)b * N + i) * N + j0 + jl) * D + cg * 64;
#pragma unroll
      for (int e = lane; e < 16 * (64 / E); e += 32) {
        const int r = e / (64 / E), pc = e % (64 / E);
        if (pc < ppr && i < N && j0 + jl + r < N)
          *reinterpret_cast<uint4*>(orow + (long long)r * D + pc * E) =
              *reinterpret_cast<const uint4*>(tile + r * kLdE + pc * E);
      }
      __syncwarp();  // the tile's reads are done before the next row's writes
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

template <typename T, int ND>
cudaError_t launch(const OArgs& a, cudaStream_t stream) {
  using C = Cfg<T, ND>;
  constexpr size_t smem = smem_bytes<T, ND>();
  static_assert(smem <= kMaxSmem, "outer_mma_kernel's shared memory");
  auto kern = outer_mma_kernel<T, ND>;
  // set at every launch: the attribute belongs to the current device
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const long long jtiles = (a.N + C::JT - 1) / C::JT, igroups = (a.N + C::TIB - 1) / C::TIB;
  const long long ntasks = (long long)a.B * jtiles * igroups;  // a block a task
  if (ntasks > 2147483647LL) return cudaErrorInvalidValue;
  kern<<<(unsigned)ntasks, C::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const OArgs& a, cudaStream_t stream) {
  return a.D <= 64 ? launch<T, 8>(a, stream) : launch<T, 16>(a, stream);
}

}  // namespace

extern "C" {

// K11's product and sums on the tensor cores. Takes D a multiple of 8 up to
// 128, S and ldw multiples of 8 (bf16) or 4 (f32), B and N from 1 to 65535.
int prd_outer_mma(const void* xl, const void* u, const void* w1, long long ldw, const void* bias,
                  void* out, int dtype, int B, int N, int S, int D, void* stream) {
  const int piece = dtype == 1 ? 8 : 4;
  const bool ok = (dtype == 0 || dtype == 1) && B > 0 && B <= 65535 && N > 0 && N <= 65535 &&
                  S > 0 && S % piece == 0 && D > 0 && D <= kMaxD && D % 8 == 0 && ldw >= S &&
                  ldw % piece == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  const OArgs a{xl, static_cast<const float*>(u), w1, static_cast<const float*>(bias), out, ldw,
                B, N, S, D};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_d<float>(a, s);
  return (int)launch_d<bf16>(a, s);
}

}  // extern "C"
