// Hand-written Hopper (sm_90a) fused transition: LN -> W1 + b1 -> ReLU -> W2 (+ b2).
//
// Replaces the Pallas TPU kernel K10 of protein_redesign_tpu/ops/pallas_transition.py,
// _fused_transition_impl (:71) -> _kernel (:33), behind the switch
// use_pallas_transition: FoldingBlock's single_fc (512 -> 2048 -> 512 over B*N
// rows) and pair_fc (64 -> 256 -> 64 over B*N*N rows) at paper width.
//
// Per row: x^ = LN(x) rounded to T; h = ReLU(x^ W1 + b1) rounded to T;
// out = h W2 (+ b2) in T. Sums, biases and statistics in f32 (T = float: f32
// throughout, as the Pallas kernel in interpret mode).
//
// What bounds it: 2 M Hd (D + Dout) operations against one read of x and one
// write of out, so the operations at the card's rate for T. This kernel runs
// them on the CUDA cores in f32 (tensor cores are later work), and what its
// design buys is the fusion: the LN copy and the [M, Hd] hidden activations
// never reach device memory (the unfused route writes and reads both).
//
// Layout of the work: one block of 256 threads per tile of 64 rows and, for
// an output wider than 64, per 64-unit chunk of the hidden dimension. Where
// they fit (D up to 670: smem_bytes), the tile's LN rows sit in shared
// memory whole, transposed ([D][68], a warp per row), normalised once per
// block. Wider rows (single_dim 768) take the streamed layout (STREAM): the
// block computes each row's mean and rstd once in f32 (the same warp sums),
// and x^ is normalised and rounded 64 columns at a time into a [64][68] slab
// beside the W1 slab it multiplies, re-read from x (L2) for every hidden
// chunk the block runs; that takes any D. The whole-row layout stays where
// it fits: it reads x once per block and normalises it once.
// Both products run as 64 x 64 tiles: thread (rg, cg) keeps a 4 x 4 register
// tile (rows 4 rg.., columns 4 cg..) and adds 16 FMAs per two 16-byte shared
// loads (tile_4x4). The hidden chunk x^ W1 streams W1 in 64 x 64 slabs, goes
// through ReLU and rounding into shared memory (transposed) and multiplies the
// chunk's 64 rows of W2, 64 output columns at a time. With Dout <= 64 a block
// runs every hidden chunk and keeps its outputs in registers; with a wider
// output (single_fc, 384 rows at bucket 192, B = 2: only 6 row tiles) blocks
// split the hidden dimension, store their partial outputs into their hidden
// chunk's slab of an f32 scratch, and a second kernel sums the slabs in
// chunk order, adds b2 and rounds to T (no atomics: the same bits at every
// call).
//
// Layout: x contiguous [M, D]; w1t [D, Hd] and w2t [Hd, Dout] in T (the flax
// kernels' layout); b1 [Hd] and b2 [Dout] f32 (b2 may be null); out
// contiguous [M, Dout]; out32 an f32 [ceil(Hd / 64), M, Dout] scratch when
// Dout > 64.
// The entry point returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;         // rows, hidden units and output columns per tile
constexpr int kLd = kT + 4;    // row stride of the transposed tiles
constexpr int kSmemFixed = kT * kT + kT * kLd + kT * kT;  // w1s, hsT, w2s (floats)
constexpr size_t kMaxSmem = 232448;  // bytes a block can use on the H100

// Shared memory (bytes) of the whole-row layout, and of the streamed one
// (a [64][68] slab of x^ and the rows' mean and rstd).
size_t whole_smem(int D) { return sizeof(float) * ((size_t)D * kLd + kSmemFixed); }
constexpr size_t kStreamSmem = sizeof(float) * ((size_t)kT * kLd + kSmemFixed + 2 * kT);

template <typename T, bool SPLIT, bool STREAM>
__global__ void __launch_bounds__(kThreads)
    transition_kernel(const T* __restrict__ x, const T* __restrict__ w1t,
                      const float* __restrict__ b1, const T* __restrict__ w2t,
                      const float* __restrict__ b2, T* __restrict__ out,
                      float* __restrict__ out32, long long M, int D, int Hd, int Dout) {
  extern __shared__ __align__(16) float smem[];
  float* xsT = smem;                           // [D][kLd] (STREAM: [kT][kLd]): x^, transposed
  float* w1s = xsT + (STREAM ? kT : D) * kLd;  // [kT][kT]: a 64 x 64 slab of W1
  float* hsT = w1s + kT * kT;    // [kT][kLd]: the hidden chunk, transposed
  float* w2s = hsT + kT * kLd;   // [kT][kT]: the chunk's rows of W2, 64 columns
  float* mu_s = w2s + kT * kT;   // STREAM: [kT] row means
  float* rs_s = mu_s + kT;       // STREAM: [kT] row rstd

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long m0 = (long long)blockIdx.x * kT;
  const int rows = (int)min((long long)kT, M - m0);
  for (int r = warp; r < kT; r += kThreads / 32) {
    if (!STREAM) {
      layer_norm_to_column<T>(x + (m0 + r) * D, r < rows, D, xsT + r, kLd);
      continue;
    }
    // layer_norm_to_column's statistics, kept for the slabs
    float mu = 0.f, rstd = 0.f;
    if (r < rows) {
      const T* row = x + (m0 + r) * D;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += Io<T>::load(row + d);
      mu = warp_sum(s) / (float)D;
      float sq = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float t = Io<T>::load(row + d) - mu;
        sq = fmaf(t, t, sq);
      }
      rstd = rsqrtf(warp_sum(sq) / (float)D + 1e-5f);
    }
    if (lane == 0) {
      mu_s[r] = mu;
      rs_s[r] = rstd;
    }
  }

  float acc[4][4];  // the outputs (!SPLIT), kept over the hidden chunks
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int c_begin = SPLIT ? blockIdx.y : 0;
  const int c_end = SPLIT ? blockIdx.y + 1 : (Hd + kT - 1) / kT;
  for (int chunk = c_begin; chunk < c_end; ++chunk) {
    const int h0 = chunk * kT;
    float h[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kT) {
      __syncthreads();  // the LN rows are in; the previous slab's reads are done
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int dd = e / kT, j = e - dd * kT;
        w1s[e] = d0 + dd < D && h0 + j < Hd ? Io<T>::load(w1t + (long long)(d0 + dd) * Hd + h0 + j)
                                            : 0.f;
      }
      if (STREAM) {  // x^ of columns [d0, d0 + 64), a row's columns along the threads
        for (int e = tid; e < kT * kT; e += kThreads) {
          const int r = e / kT, dd = e - r * kT;
          xsT[dd * kLd + r] =
              r < rows && d0 + dd < D
                  ? Io<T>::round((Io<T>::load(x + (m0 + r) * D + d0 + dd) - mu_s[r]) * rs_s[r])
                  : 0.f;
        }
      }
      __syncthreads();
      tile_4x4(h, (STREAM ? xsT : xsT + d0 * kLd) + rg * 4, kLd, w1s + cg * 4, kT,
               min(kT, D - d0));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int hj = h0 + cg * 4 + j;
        hsT[(cg * 4 + j) * kLd + rg * 4 + i] =
            hj < Hd ? Io<T>::round(fmaxf(h[i][j] + b1[hj], 0.f)) : 0.f;
      }
    for (int c0 = 0; c0 < Dout; c0 += kT) {
      __syncthreads();  // hsT is in; the previous W2 slab's reads are done
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int j = e / kT, c = e - j * kT;
        w2s[e] = h0 + j < Hd && c0 + c < Dout
                     ? Io<T>::load(w2t + (long long)(h0 + j) * Dout + c0 + c)
                     : 0.f;
      }
      __syncthreads();
      if (SPLIT) {
        float o[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
        tile_4x4(o, hsT + rg * 4, kLd, w2s + cg * 4, kT, kT);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rg * 4 + i;
          if (r >= rows) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + cg * 4 + j;
            if (c < Dout) out32[(blockIdx.y * M + m0 + r) * Dout + c] = o[i][j];
          }
        }
      } else {
        tile_4x4(acc, hsT + rg * 4, kLd, w2s + cg * 4, kT, kT);
      }
    }
    __syncthreads();  // hsT's reads are done before the next chunk writes it
  }

  if (!SPLIT) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg * 4 + j;
        if (c < Dout) {
          const float bias = b2 != nullptr ? b2[c] : 0.f;
          out[(m0 + r) * Dout + c] = Io<T>::cast(acc[i][j] + bias);
        }
      }
    }
  }
}

// out = round(sum of the chunks' slabs + b2), the slabs of out32 [chunks, n]
// added in chunk order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    transition_finish_kernel(const float* __restrict__ out32, const float* __restrict__ b2,
                             T* __restrict__ out, long long n, int Dout, int chunks) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float sum = 0.f;
  for (int c = 0; c < chunks; ++c) sum += out32[c * n + e];
  out[e] = Io<T>::cast(sum + (b2 != nullptr ? b2[e % Dout] : 0.f));
}

template <typename T, bool SPLIT, bool STREAM>
cudaError_t launch(const void* x, const void* w1t, const float* b1, const void* w2t,
                   const float* b2, void* out, float* out32, long long M, int D, int Hd,
                   int Dout, cudaStream_t stream) {
  const size_t smem = STREAM ? kStreamSmem : whole_smem(D);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const long long tiles = (M + kT - 1) / kT;
  if (tiles > 0x7fffffffLL || (SPLIT && (Hd + kT - 1) / kT > 65535)) return cudaErrorInvalidValue;
  auto kern = transition_kernel<T, SPLIT, STREAM>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((unsigned)tiles, SPLIT ? (Hd + kT - 1) / kT : 1);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w1t),
                                         b1, static_cast<const T*>(w2t), b2, static_cast<T*>(out),
                                         out32, M, D, Hd, Dout);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !SPLIT) return e;
  const long long n = M * Dout;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  transition_finish_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      out32, b2, static_cast<T*>(out), n, Dout, (int)grid.y);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w1t, const float* b1, const void* w2t,
                     const float* b2, void* out, float* out32, long long M, int D, int Hd,
                     int Dout, cudaStream_t stream) {
  const bool stream_rows = whole_smem(D) > kMaxSmem;
  if (Dout <= kT) {
    if (stream_rows)
      return launch<T, false, true>(x, w1t, b1, w2t, b2, out, out32, M, D, Hd, Dout, stream);
    return launch<T, false, false>(x, w1t, b1, w2t, b2, out, out32, M, D, Hd, Dout, stream);
  }
  if (out32 == nullptr) return cudaErrorInvalidValue;
  if (stream_rows)
    return launch<T, true, true>(x, w1t, b1, w2t, b2, out, out32, M, D, Hd, Dout, stream);
  return launch<T, true, false>(x, w1t, b1, w2t, b2, out, out32, M, D, Hd, Dout, stream);
}

}  // namespace

extern "C" {

// K10 over M rows. Takes any D (the whole-row layout up to D = 670, the
// streamed one past it) and, for Dout > 64, Hd up to 65535 64-unit chunks
// (grid.y). out32: an f32 [ceil(Hd / 64), M, Dout] scratch, needed when
// Dout > 64.
int prd_transition(const void* x, const void* w1t, const void* b1, const void* w2t,
                   const void* b2, void* out, void* out32, int dtype, int M, int D, int Hd,
                   int Dout, void* stream) {
  const bool ok = (dtype == 0 || dtype == 1) && M > 0 && D > 0 && Hd > 0 && Dout > 0 &&
                  x != nullptr && b1 != nullptr;
  if (!ok) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto bias1 = static_cast<const float*>(b1);
  const auto bias2 = static_cast<const float*>(b2);
  const auto sums = static_cast<float*>(out32);
  if (dtype == 0)
    return (int)dispatch<float>(x, w1t, bias1, w2t, bias2, out, sums, M, D, Hd, Dout, s);
  return (int)dispatch<__nv_bfloat16>(x, w1t, bias1, w2t, bias2, out, sums, M, D, Hd, Dout, s);
}

}  // extern "C"
