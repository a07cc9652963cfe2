// Hand-written Hopper (sm_90a) fused triangle multiplication, outgoing and
// incoming, on the tensor cores: bf16 (mma.sync m16n8k16) and f32 (3xTF32).
//
// Replaces the Pallas TPU kernel K9 of protein_redesign_tpu/ops/pallas_trimul.py,
// fused_triangle_multiply (:145) -> _trimul_kernel (:76), behind the switch
// use_pallas_trimul: both triangle multiplications of every FoldingBlock.
// The function is trimul.cu's (the CUDA-core body, kept callable to time the
// two side by side):
//
//   x = LN(pair);  a, b = sigmoid(x Wg + bg) * (x Wp + bp) * mask   (rounded to T)
//   outgoing: p[i, j, d] = sum_k a[i, k, d] b[j, k, d]
//   incoming: p[i, j, d] = sum_k a[k, i, d] b[k, j, d]
//   out = sigmoid(x Wog + bog) * (round(LN_d(p)) Wop + bop)            (in T)
//
// Statistics, the contraction, sums, biases and gates in f32; x, a, b, the
// normed product and the weights rounded to T (T = float: f32 throughout,
// every product in 3xTF32, the Pallas kernel in interpret mode).
//
// What bounds it: at bucket 192, B = 2, D = 64: 3.6 GFLOP of projections
// (2 B N^2 D 6 D) and 1.8 of contraction (2 B N^3 D), about 5.5 us on the
// tensor cores in bf16, against ~94 MB of device-memory traffic with the
// scratch below (~28 us at 3.35 TB/s; much of it stays in the 50 MB L2), so
// the bytes once the products run on the tensor cores.
//
// Three kernels, launched back to back by one entry point:
// 1. trimul_project_mma_kernel: ln_project.cuh's block, one per 64 pair
//    positions: LN, x^ rounded to T, [64, D] x [D, 5 D] in 64-column slices.
//    The wrapper interleaves w_in's gate and projection columns 8 by 8
//    (gate n-tile 2 i, projection n-tile 2 i + 1 of the same 8 channels), so
//    one thread holds both factors of a and b; its epilogue writes them
//    channel-major in the pair's own (x, y) order, [B, D, N, NP] with rows
//    padded to NP = N rounded up to 8 (the writer of y = N - 1 zeroes the
//    pad), y contiguous, so that a warp's stores run along y in both modes.
//    The out gate goes to f32 scratch [B, N, N, D].
// 2. trimul_contract_kernel: P_d = A_d B_d^T for each (b, d) as a batched
//    GEMM, one block of 4 warps per 64 x 64 output tile of one channel, k in
//    stages of 64 (bf16) or 32 (f32) by cp.async, double-buffered. Outgoing
//    reads a and b as [i][k] and [j][k] (k contiguous: A fragments by
//    ldmatrix, B fragments as for S = Q K^T); incoming as [k][i] and [k][j]
//    (A by ldmatrix.trans, B as for O = P V). In f32 the same tiles feed 3xTF32
//    m16n8k8 fragments element by element, row strides chosen
//    conflict-free for each orientation. Rows and columns past N are zero
//    (zero-filled copies, the zeroed pad); masked k contribute 0, because a
//    and b already carry the mask. The f32 product goes to scratch
//    [B, D, N, N], channel-major, written along j.
// 3. trimul_out_mma_kernel: ln_project.cuh's block again over the product:
//    its loader reads 64 positions of the channel-major product (coalesced
//    along the positions), LN over d in f32, round(x^) W_op^T on the tensor
//    cores, + bop, times the out gate, in T.
// The epilogue of the product is a third GEMM kernel rather than all D
// channels of an output tile kept in one block (the CUDA-core body's way,
// whose [D, 16, 16] f32 sum took D / 8 x 8 registers a lane): the product's
// round trip costs B N^2 D 8 bytes (18.9 MB written and read at 192, about
// 11 us at 3.35 TB/s, mostly in L2) and each kernel stays one simple tile
// loop. No kernel is specialised on D, so the registers and spills ptxas
// reports hold at every D (chip_smoke prints them).
//
// Layout: pair contiguous [B, N, N, D] in T; mask contiguous f32 [B, N, N];
// w_in [D, 5D] in T, columns [gate 8 | proj 8] for each 8 of the 2D a | b
// channels, then the D out-gate columns; b_in [5D] f32 in the same order;
// wop_t [D, D] in T; bop [D] f32; scratch a_t, b_t [B, D, N, NP] in T, gate
// [B, N, N, D] f32, prod [B, D, N, N] f32; out contiguous [B, N, N, D].
// Takes D a multiple of 8 up to 512: past 128 the two LN + projection
// stages run on ln_project.cuh's wide block (trimul_wide_mma.cu, the A tile
// alone resident, W streamed in K slices), around the same contraction. The
// entry point returns cudaGetLastError().
//
// The wide body (prd_trimul_wide) takes every other pair width from 1 to
// 512 (those not a multiple of 8), the JAX kernel's reach (VMEM is its only
// bound), and every width where ops.trimul.trimul_takes_tensor_cores is
// patched to False past 128. The contraction is the kernel above,
// unchanged: it works on one channel plane at a time, so D never enters it.
// The two LN + projection stages become CUDA-core kernels of 256 threads
// over 64 positions (trimul.cu's register tiles): LN of each position over
// its D real channels into a transposed f32 tile [D][68] in shared memory,
// then each 64-column slice of the output summed over K slices of 128 weight
// rows staged beside it, so that only the LN tile grows with D (139 KB at
// 512).
//   trimul_project_wide_kernel: a, b and the out gate from w_in [D, 5D] in
//     trimul.cu's order [gate_a | gate_b | proj_a | proj_b | out_gate], into
//     the scratch layouts above;
//   trimul_out_wide_kernel: the channel-major product read along the
//     positions into the tile, LN over d, round(x^) W_op + bop, times the
//     out gate, in T.
// Both are bound by their FMAs on the CUDA cores (2 B N^2 D 6 D in all),
// which the tensor-core bodies do in mma.sync.

#include "trimul_rows.cuh"

// trimul_wide_mma.cu's LN + projection stages on the wide block (stage 0 the
// projection, 1 the out-projection; args a TmArgs), which launch() runs past
// D = 128.
extern "C" int prd_trimul_mma_wide_stage(const void* args, int stage, int dtype, void* stream);

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTmMaxD = kLnwMaxD;
constexpr int kCt = 64;       // output tile of one channel: kCt x kCt
constexpr int kCThreads = 128;
// k per stage: 64 in bf16, 32 in f32 (the stages' static shared memory)
template <typename T>
constexpr int kCk = sizeof(T) == 2 ? 64 : 32;

template <typename T>
__global__ void __launch_bounds__(kLnpThreads, kLnpMinBlocks) trimul_project_mma_kernel(const TmArgs a) {
  extern __shared__ __align__(16) unsigned char smem_tm[];
  const long long positions = (long long)a.B * a.N * a.N;
  const long long p0 = (long long)blockIdx.x * kLnpRows;
  const int rows = (int)min((long long)kLnpRows, positions - p0);
  const PairRows<T> load{static_cast<const T*>(a.pair), a.D};
  const GatedPair<T> epi{a.b_in, a.mask, static_cast<T*>(a.a_t), static_cast<T*>(a.b_t), a.gate,
                         a.N, (a.N + 7) & ~7, a.D};
  ln_project<T>(load, static_cast<const T*>(a.w_in), a.D, 5 * a.D, p0, rows, epi, smem_tm);
}

// The contraction's staged tiles of one stage: [kCt][kCk + pad] (rows i or
// j, k contiguous: outgoing) or [kCk][kCt + 8] (rows k: incoming). Row
// strides: bf16 an odd number of 16-byte units (conflict-free ldmatrix);
// f32 kCk + 4 = 4 mod 8 for [row][k] fragment reads, kCt + 8 = 8 mod 32 for
// [k][row] ones.
template <typename T, bool INCOMING>
struct ContractTile {
  static constexpr int kLd = INCOMING ? kCt + 8 : kCk<T> + (sizeof(T) == 2 ? 8 : 4);
  static constexpr int kSize = (INCOMING ? kCk<T> : kCt) * kLd;
};

// Stage k [k0, k0 + kCk) of the block's rows [r0, r0 + kCt) of one channel
// plane [N][NP] by cp.async: outgoing rows r, k contiguous; incoming rows k,
// r contiguous. Rows past N and 16-byte chunks past NP are zero-filled.
template <typename T, bool INCOMING>
__device__ __forceinline__ void stage_plane(const T* __restrict__ plane, int N, int NP, int r0,
                                            int k0, T* dst) {
  constexpr int kChunk = 16 / sizeof(T);
  constexpr int kLd = ContractTile<T, INCOMING>::kLd;
  constexpr int kRows = INCOMING ? kCk<T> : kCt;
  constexpr int kPerRow = (INCOMING ? kCt : kCk<T>) / kChunk;
  for (int e = threadIdx.x; e < kRows * kPerRow; e += kCThreads) {
    const int row = e / kPerRow;
    const int c = (e - row * kPerRow) * kChunk;
    const int pr = INCOMING ? k0 + row : r0 + row;  // the plane's row
    const int pc = INCOMING ? r0 + c : k0 + c;      // its column
    const bool ok = pr < N && pc < NP;
    cp_async16(dst + row * kLd + c, ok ? plane + (long long)pr * NP + pc : plane, ok);
  }
}

// acc += A B over one stage for the warp's 16 rows (i) and the tile's 64
// columns (j), bf16.
template <bool INCOMING>
__device__ __forceinline__ void contract_stage(const bf16* a_s, const bf16* b_s, int warp,
                                               int lane, float (&acc)[8][4]) {
  constexpr int kLd = ContractTile<bf16, INCOMING>::kLd;
#pragma unroll
  for (int kc = 0; kc < kCk<bf16>; kc += 16) {
    unsigned a[4];
    if (INCOMING)
      load_a_frag_trans(a, a_s, kLd, kc, warp * 16, lane);
    else
      load_a_frag(a, a_s + warp * 16 * kLd, kLd, kc, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      if (INCOMING)
        load_b_frags(b, b_s, kLd, kc, np * 16, lane);
      else
        load_bt_frags(b, b_s, kLd, np * 16, kc, lane);
      mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// The same in f32 (3xTF32): element (row, k) of A at a_s[row * kLd + k]
// (outgoing) or a_s[k * kLd + row] (incoming), of B likewise.
template <bool INCOMING>
__device__ __forceinline__ void contract_stage(const float* a_s, const float* b_s, int warp,
                                               int lane, float (&acc)[8][4]) {
  constexpr int kLd = ContractTile<float, INCOMING>::kLd;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = warp * 16;
  auto at = [&](const float* s, int row, int k) {
    return INCOMING ? s[k * kLd + row] : s[row * kLd + k];
  };
#pragma unroll
  for (int kc = 0; kc < kCk<float>; kc += 8) {
    unsigned ab[4], as[4];
    split_tf32(at(a_s, m0 + g, kc + t4), ab[0], as[0]);
    split_tf32(at(a_s, m0 + g + 8, kc + t4), ab[1], as[1]);
    split_tf32(at(a_s, m0 + g, kc + t4 + 4), ab[2], as[2]);
    split_tf32(at(a_s, m0 + g + 8, kc + t4 + 4), ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      unsigned bb0, bs0, bb1, bs1;
      split_tf32(at(b_s, n * 8 + g, kc + t4), bb0, bs0);
      split_tf32(at(b_s, n * 8 + g, kc + t4 + 4), bb1, bs1);
      mma_3xtf32(acc[n], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

template <typename T, bool INCOMING>
__global__ void __launch_bounds__(kCThreads)
    trimul_contract_kernel(const T* __restrict__ a_t, const T* __restrict__ b_t,
                           float* __restrict__ prod, int N, int D) {
  using Tile = ContractTile<T, INCOMING>;
  __shared__ __align__(16) T a_s[2][Tile::kSize];
  __shared__ __align__(16) T b_s[2][Tile::kSize];
  const int NP = (N + 7) & ~7;
  const int tiles = (N + kCt - 1) / kCt;
  const int it = blockIdx.x / tiles;
  const int i0 = it * kCt, j0 = (blockIdx.x - it * tiles) * kCt;
  const long long channel = (long long)blockIdx.z * D + blockIdx.y;  // (b, d)
  const T* a_p = a_t + channel * N * NP;
  const T* b_p = b_t + channel * N * NP;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int stages = (N + kCk<T> - 1) / kCk<T>;
  stage_plane<T, INCOMING>(a_p, N, NP, i0, 0, a_s[0]);
  stage_plane<T, INCOMING>(b_p, N, NP, j0, 0, b_s[0]);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    const int buf = s & 1;
    if (s + 1 < stages) {
      stage_plane<T, INCOMING>(a_p, N, NP, i0, (s + 1) * kCk<T>, a_s[buf ^ 1]);
      stage_plane<T, INCOMING>(b_p, N, NP, j0, (s + 1) * kCk<T>, b_s[buf ^ 1]);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    contract_stage<INCOMING>(a_s[buf], b_s[buf], warp, lane, acc);
    __syncthreads();  // the next stage's copies overwrite this buffer
  }

  float* out = prod + channel * N * N;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + warp * 16 + g + 8 * (e >> 1);
      const int j = j0 + n * 8 + 2 * t4 + (e & 1);
      if (i < N && j < N) out[(long long)i * N + j] = acc[n][e];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kLnpThreads, kLnpMinBlocks) trimul_out_mma_kernel(const TmArgs a) {
  extern __shared__ __align__(16) unsigned char smem_tm[];
  const long long positions = (long long)a.B * a.N * a.N;
  const long long p0 = (long long)blockIdx.x * kLnpRows;
  const int rows = (int)min((long long)kLnpRows, positions - p0);
  const ProductRows load{a.prod, a.N, a.D};
  const GatedOut<T> epi{a.gate, a.bop, static_cast<T*>(a.out), a.D};
  ln_project<T>(load, static_cast<const T*>(a.wop_t), a.D, a.D, p0, rows, epi, smem_tm);
}

constexpr int kWideMaxD = 512;
constexpr int kWThreads = 256;
constexpr int kWRows = 64;          // positions a block: 16 groups of 4
constexpr int kWLd = kWRows + 4;    // row stride of the transposed LN tile
constexpr int kWCols = 64;          // output columns a slice: 16 groups of 4
constexpr int kWK = 128;            // weight rows (input channels) a K slice

__host__ __device__ constexpr size_t wide_smem_bytes(int D, int cols) {
  return sizeof(float) * ((size_t)D * kWLd + (size_t)kWK * cols);
}

// pos = (bb, x, y) of the [B, N, N] pair grid.
__device__ __forceinline__ void pair_coords(long long pos, int N, long long& bb, int& x, int& y) {
  const long long bx = pos / N;
  y = (int)(pos - bx * N);
  bb = bx / N;
  x = (int)(bx - bb * N);
}

// acc += (the LN tile's 4 positions pg * 4 ..) x (weight columns [c0, c0 + 64)
// of w [D, ld]) over all D rows, K slices of kWK rows staged into ws
// [kWK][cols] at column offset off; columns past limit are zero.
template <typename T>
__device__ __forceinline__ void wide_slice(float (&acc)[4][4], const float* xsT, float* ws,
                                           int cols, int off, const T* __restrict__ w, int ld,
                                           int c0, int limit, int D, int pg, int cl) {
  for (int k0 = 0; k0 < D; k0 += kWK) {
    const int kn = min(kWK, D - k0);
    __syncthreads();  // the LN tile is in; the previous K slice's reads are done
    for (int e = threadIdx.x; e < kn * kWCols; e += kWThreads) {
      const int d = e / kWCols, c = e - d * kWCols;
      ws[d * cols + off + c] =
          c0 + c < limit ? Io<T>::load(w + (long long)(k0 + d) * ld + c0 + c) : 0.f;
    }
    __syncthreads();
    tile_4x4(acc, xsT + k0 * kWLd + pg * 4, kWLd, ws + off + cl, cols, kn);
  }
}

__device__ __forceinline__ void zero4x4(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// w_in here is [D, 5D] in trimul.cu's column order [gate_a | gate_b | proj_a
// | proj_b | out_gate], b_in likewise.
template <typename T>
__global__ void __launch_bounds__(kWThreads) trimul_project_wide_kernel(const TmArgs a) {
  extern __shared__ __align__(16) unsigned char smem_tm[];
  const int D = a.D, N = a.N, NP = (N + 7) & ~7, W = 5 * D;
  float* xsT = reinterpret_cast<float*>(smem_tm);  // [D][kWLd]: the LN rows, transposed
  float* ws = xsT + D * kWLd;                       // [kWK][2 kWCols]: gate | projection
  const long long positions = (long long)a.B * N * N;
  const long long p0 = (long long)blockIdx.x * kWRows;
  const int rows = (int)min((long long)kWRows, positions - p0);
  const T* pair = static_cast<const T*>(a.pair);
  const T* w_in = static_cast<const T*>(a.w_in);
  T* a_t = static_cast<T*>(a.a_t);
  T* b_t = static_cast<T*>(a.b_t);
  const int tid = threadIdx.x;
  for (int r = tid >> 5; r < kWRows; r += kWThreads / 32)
    layer_norm_to_column<T>(pair + (p0 + min(r, rows - 1)) * D, r < rows, D, xsT + r, kWLd);
  const int pg = tid % (kWRows / 4), cl = (tid / (kWRows / 4)) * 4;

  // a and b: slices of 64 of the 2D a | b channels, gate and projection together
  for (int s0 = 0; s0 < 2 * D; s0 += kWCols) {
    float g[4][4], pr[4][4];
    zero4x4(g);
    zero4x4(pr);
    for (int k0 = 0; k0 < D; k0 += kWK) {
      const int kn = min(kWK, D - k0);
      __syncthreads();
      for (int e = tid; e < kn * kWCols; e += kWThreads) {
        const int d = e / kWCols, c = e - d * kWCols;
        const bool ok = s0 + c < 2 * D;
        const T* row = w_in + (long long)(k0 + d) * W + s0 + c;
        ws[d * 2 * kWCols + c] = ok ? Io<T>::load(row) : 0.f;
        ws[d * 2 * kWCols + kWCols + c] = ok ? Io<T>::load(row + 2 * D) : 0.f;
      }
      __syncthreads();
      tile_4x4(g, xsT + k0 * kWLd + pg * 4, kWLd, ws + cl, 2 * kWCols, kn);
      tile_4x4(pr, xsT + k0 * kWLd + pg * 4, kWLd, ws + kWCols + cl, 2 * kWCols, kn);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (pg * 4 + i >= rows) continue;
      const long long pos = p0 + pg * 4 + i;
      long long bb;
      int x, y;
      pair_coords(pos, N, bb, x, y);
      const float m = a.mask[pos];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = s0 + cl + j;
        if (c >= 2 * D) continue;
        const float v = sigmoid_f(g[i][j] + a.b_in[c]) * (pr[i][j] + a.b_in[2 * D + c]) * m;
        T* dst = c < D ? a_t : b_t;
        const int ch = c < D ? c : c - D;
        T* row = dst + ((bb * D + ch) * N + x) * NP;
        row[y] = Io<T>::cast(v);
        if (y == N - 1)
          for (int yy = N; yy < NP; ++yy) row[yy] = Io<T>::cast(0.f);
      }
    }
  }
  // the out gate: slices of 64 of the D columns 4D ..
  for (int s0 = 0; s0 < D; s0 += kWCols) {
    float g[4][4];
    zero4x4(g);
    wide_slice<T>(g, xsT, ws, kWCols, 0, w_in + 4 * D, W, s0, D, D, pg, cl);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (pg * 4 + i >= rows) continue;
      float* dst = a.gate + (p0 + pg * 4 + i) * D;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = s0 + cl + j;
        if (c < D) dst[c] = sigmoid_f(g[i][j] + a.b_in[4 * D + c]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWThreads) trimul_out_wide_kernel(const TmArgs a) {
  extern __shared__ __align__(16) unsigned char smem_tm[];
  const int D = a.D, N = a.N;
  float* xsT = reinterpret_cast<float*>(smem_tm);  // [D][kWLd]: the product's rows, transposed
  float* ws = xsT + D * kWLd;                       // [kWK][kWCols]: W_op rows
  const long long nn = (long long)N * N;
  const long long positions = (long long)a.B * nn;
  const long long p0 = (long long)blockIdx.x * kWRows;
  const int rows = (int)min((long long)kWRows, positions - p0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the channel-major product, a run of 64 positions per channel
  for (int e = tid; e < D * kWRows; e += kWThreads) {
    const int d = e / kWRows, p = e - d * kWRows;
    float v = 0.f;
    if (p < rows) {
      const long long pos = p0 + p;
      const long long bb = pos / nn;
      v = a.prod[(bb * D + d) * nn + (pos - bb * nn)];
    }
    xsT[d * kWLd + p] = v;
  }
  __syncthreads();
  // LN over d of each position, a warp a position, rounded to T in place
  for (int p = tid >> 5; p < kWRows; p += kWThreads / 32) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += xsT[d * kWLd + p];
    const float mu = warp_sum(s) / (float)D;
    float sq = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float t = xsT[d * kWLd + p] - mu;
      sq = fmaf(t, t, sq);
    }
    const float rstd = rsqrtf(warp_sum(sq) / (float)D + 1e-5f);
    for (int d = lane; d < D; d += 32) xsT[d * kWLd + p] = Io<T>::round((xsT[d * kWLd + p] - mu) * rstd);
  }
  const int pg = tid % (kWRows / 4), cl = (tid / (kWRows / 4)) * 4;
  const T* wop_t = static_cast<const T*>(a.wop_t);
  T* out = static_cast<T*>(a.out);
  for (int s0 = 0; s0 < D; s0 += kWCols) {
    float acc[4][4];
    zero4x4(acc);
    wide_slice<T>(acc, xsT, ws, kWCols, 0, wop_t, D, s0, D, D, pg, cl);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (pg * 4 + i >= rows) continue;
      const long long pos = p0 + pg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = s0 + cl + j;
        if (c < D) out[pos * D + c] = Io<T>::cast(a.gate[pos * D + c] * (acc[i][j] + a.bop[c]));
      }
    }
  }
}

template <typename T>
cudaError_t launch_wide(const TmArgs& a, bool incoming, cudaStream_t stream) {
  const long long positions = (long long)a.B * a.N * a.N;
  const long long blocks = (positions + kWRows - 1) / kWRows;
  const long long tiles = (a.N + kCt - 1) / kCt;
  if (blocks > 0x7fffffffLL || tiles * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem_p = wide_smem_bytes(a.D, 2 * kWCols);
  const size_t smem_o = wide_smem_bytes(a.D, kWCols);
  cudaError_t e = cudaSuccess;
  if (smem_p > 48 * 1024)
    e = cudaFuncSetAttribute(trimul_project_wide_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_p);
  if (e == cudaSuccess && smem_o > 48 * 1024)
    e = cudaFuncSetAttribute(trimul_out_wide_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_o);
  if (e != cudaSuccess) return e;
  trimul_project_wide_kernel<T><<<(unsigned)blocks, kWThreads, smem_p, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(tiles * tiles), a.D, a.B);
  const T* at = static_cast<const T*>(a.a_t);
  const T* bt = static_cast<const T*>(a.b_t);
  if (incoming)
    trimul_contract_kernel<T, true><<<grid, kCThreads, 0, stream>>>(at, bt, a.prod, a.N, a.D);
  else
    trimul_contract_kernel<T, false><<<grid, kCThreads, 0, stream>>>(at, bt, a.prod, a.N, a.D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  trimul_out_wide_kernel<T><<<(unsigned)blocks, kWThreads, smem_o, stream>>>(a);
  return cudaGetLastError();
}

template <typename Kernel>
cudaError_t launch_rows(Kernel kern, size_t smem, long long blocks, const TmArgs& a,
                        cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<(unsigned)blocks, kLnpThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const TmArgs& a, bool incoming, cudaStream_t stream) {
  const long long positions = (long long)a.B * a.N * a.N;
  const long long blocks = (positions + kLnpRows - 1) / kLnpRows;
  const long long tiles = (a.N + kCt - 1) / kCt;
  if (blocks > 0x7fffffffLL || tiles * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool wide = a.D > kLnpMaxD;  // past the block's whole-row tiles: trimul_wide_mma.cu's
  const int dtype = sizeof(T) == 2;
  const size_t smem = lnp_smem_bytes<T>(a.D);  // the block's (unused where wide)
  cudaError_t e = wide ? (cudaError_t)prd_trimul_mma_wide_stage(&a, 0, dtype, stream)
                       : launch_rows(trimul_project_mma_kernel<T>, smem, blocks, a, stream);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)(tiles * tiles), a.D, a.B);
  const T* at = static_cast<const T*>(a.a_t);
  const T* bt = static_cast<const T*>(a.b_t);
  if (incoming)
    trimul_contract_kernel<T, true><<<grid, kCThreads, 0, stream>>>(at, bt, a.prod, a.N, a.D);
  else
    trimul_contract_kernel<T, false><<<grid, kCThreads, 0, stream>>>(at, bt, a.prod, a.N, a.D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (wide) return (cudaError_t)prd_trimul_mma_wide_stage(&a, 1, dtype, stream);
  return launch_rows(trimul_out_mma_kernel<T>, smem, blocks, a, stream);
}

}  // namespace

extern "C" {

// K9 on the tensor cores, dtype 0 f32 (3xTF32), 1 bf16; mode 0 outgoing,
// 1 incoming. Takes D a multiple of 8 up to 512 (past 128 the LN +
// projection stages of trimul_wide_mma.cu) and B up to 65535.
int prd_trimul_mma(const void* pair, const void* mask, const void* w_in, const void* b_in,
                   const void* wop_t, const void* bop, void* a_t, void* b_t, void* gate,
                   void* prod, void* out, int dtype, int mode, int B, int N, int D, void* stream) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
  };
  const bool ok = (dtype == 0 || dtype == 1) && (mode == 0 || mode == 1) && B > 0 &&
                  B <= 65535 && N > 0 && D > 0 && D <= kTmMaxD && D % 8 == 0 && aligned(w_in) &&
                  aligned(wop_t) && aligned(a_t) && aligned(b_t);
  if (!ok) return (int)cudaErrorInvalidValue;
  const TmArgs a{pair, static_cast<const float*>(mask), w_in, static_cast<const float*>(b_in),
                 wop_t, static_cast<const float*>(bop), a_t, b_t, static_cast<float*>(gate),
                 static_cast<float*>(prod), out, B, N, D};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, mode == 1, s);
  return (int)launch<bf16>(a, mode == 1, s);
}

// K9's wide body, dtype 0 f32, 1 bf16; mode 0 outgoing, 1 incoming. Takes D
// from 1 to 512 and B up to 65535; w_in in trimul.cu's column order.
int prd_trimul_wide(const void* pair, const void* mask, const void* w_in, const void* b_in,
                    const void* wop_t, const void* bop, void* a_t, void* b_t, void* gate,
                    void* prod, void* out, int dtype, int mode, int B, int N, int D,
                    void* stream) {
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<unsigned long long>(p) & 15u) == 0;
  };
  const bool ok = (dtype == 0 || dtype == 1) && (mode == 0 || mode == 1) && B > 0 &&
                  B <= 65535 && N > 0 && D > 0 && D <= kWideMaxD && aligned(a_t) &&
                  aligned(b_t);
  if (!ok) return (int)cudaErrorInvalidValue;
  const TmArgs a{pair, static_cast<const float*>(mask), w_in, static_cast<const float*>(b_in),
                 wop_t, static_cast<const float*>(bop), a_t, b_t, static_cast<float*>(gate),
                 static_cast<float*>(prod), out, B, N, D};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_wide<float>(a, mode == 1, s);
  return (int)launch_wide<bf16>(a, mode == 1, s);
}

}  // extern "C"
