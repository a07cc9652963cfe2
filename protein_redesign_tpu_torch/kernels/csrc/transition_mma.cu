// Hand-written Hopper (sm_90a) tensor-core body of the fused transition,
// LN -> W1 + b1 -> ReLU -> W2 (+ b2), in both dtypes:
//
//   transition_mma_rows_kernel   <- _fused_transition_impl (:71) / _kernel (:33)
//   transition_mma_split_kernel     of protein_redesign_tpu/ops/pallas_transition.py
//   (+ transition_mma_finish_kernel)   (K10, behind use_pallas_transition)
//
// It replaces, for input, hidden and output widths that are multiples of 8
// in bf16 (4 in f32), the CUDA-core body of transition.cu, which stays for
// other widths and callable to time it beside this one.
//
// Per row, as transition_reference: x^ = LN(x) (no affine, eps 1e-5, f32
// statistics) rounded to T; h = ReLU(x^ W1 + b1) rounded to T; out = h W2
// (+ b2) rounded to T; sums and biases in f32.
//
// What bounds it: 2 M Hd (D + Dout) operations against one read of x and
// one write of out. At pair_fc (64 -> 256 -> 64 over B N^2 rows) that is 64
// operations a byte in bf16, under the card's ~295: the bytes bound it, and
// the design keeps x^ and h out of device memory and reads each weight from
// device memory once per block. The products run on the tensor cores: bf16
// by mma.sync m16n8k16 (ldmatrix fragments), f32 by 3xTF32 m16n8k8 with a
// fresh fragment per product (mma.cuh's mma_3xtf32), which keeps the f32
// parity that one TF32 product would break.
//
// h never leaves registers. A warp owns 16 rows; the hidden dimension runs
// in chunks of 64 units, and a chunk's x^ W1 accumulators, plus b1, through
// ReLU and rounded to T, are the A fragment of the second product as they
// lie: in bf16 the accumulators of two neighbouring 8-unit n-tiles, packed
// in pairs, are the A fragment of a 16-deep step (the C -> A identity of
// mma.cuh, as K1's P.V); in f32 each 8-unit n-tile is one 8-deep step with
// its units renumbered (k slot t is unit 2t, slot t + 4 unit 2t + 1, as the
// tf32 attention bodies' P.V), so W2's B fragment reads units 2t and 2t + 1
// of one row, one 8-byte load. W1 [Hd, D] and W2 [Dout, Hd] keep the Linear
// layout: each row of either is contiguous along the product's depth, the
// B operand's layout for ldmatrix without .trans and for the f32 fragment
// reads.
//
// Three layouts of the work:
// - Rows, W resident (Dout <= 128 where W1 and W2 fit shared memory whole:
//   pair_fc, 64 -> 256 -> 64 over B N^2 rows, in both dtypes): W1, W2, b1 and
//   b2 are staged once per block of 8 warps, and each warp then
//   walks 16-row tiles of its own over a persistent grid, its x
//   double-buffered by its own cp.async copies, so that no block barrier
//   follows the first: LN in place (two lanes a row, LN once per row), per
//   hidden chunk the two products, the outputs in registers over the chunks
//   (Dout / 2 or / 4 a thread) and out through the warp's dead x rows, so
//   that it writes whole rows in 16-byte pieces.
// - Rows, W streamed (pair width 128: W past shared memory): blocks of 8
//   warps walk 128-row tiles; per hidden chunk W1's and W2's 64-unit slices
//   load while the other product runs, block barriers around each.
// - Split (Dout > 128: single_fc, 512 -> 2048 -> 512 over B N rows, only 6
//   tiles of 64 rows at bucket 192): grid.y splits the hidden dimension into
//   its 64-unit chunks, so that the grid fills the card. A block's 64 rows
//   of x (32 where 64 do not fit) land whole and are normalised in place
//   once; W1's chunk in 64-column slabs for the first product, then W2's
//   rows in 64-output slabs for the second, stream through one ring of three
//   slots (two in flight); the partial sums go into an f32 scratch by
//   16-byte atomics (a warp's [16, 64] slab through shared memory, so that a
//   lane adds four neighbouring outputs); transition_mma_finish_kernel adds
//   b2 and rounds.
//
// Layout: x contiguous [M, D]; w1 [Hd, D] and w2 [Dout, Hd] contiguous in T;
// b1 [Hd] and b2 [Dout] f32 (b2 may be null); out contiguous [M, Dout];
// out32 a zeroed f32 [M, Dout] scratch for the split layout. x, w1, w2 and
// out start on 16 bytes. The entry point returns cudaGetLastError().

#include "ln_project.cuh"  // LnpOperand, unpack16 (and common.cuh, mma.cuh)

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHid = 64;            // hidden units a chunk
constexpr int kRowWarps = 8;        // the streamed rows layout: 128 rows a tile
constexpr int kSlab = 64;           // input columns and outputs of a split slab
constexpr size_t kMaxSmem = 232448;  // bytes a block can use on the H100

// The operand type's MMA depth, row padding and 16-byte piece are
// ln_project.cuh's: Op<T>::kDepth (16 bf16, 8 f32), kPad (rows of an odd
// number of 16-byte units in bf16, 4 mod 8 floats in f32: conflict-free
// fragment reads), kChunk (8, 4).
template <typename T>
using Op = LnpOperand<T>;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Row strides (elements): rows read along a product's depth K (the A tile,
// W1); W2's rows of HK hidden units (a multiple of 64; + 8: 8 mod 16 for
// ldmatrix in bf16, 8 mod 32 for f32's 8-byte fragment reads); the output
// tile (8 mod 32: conflict-free fragment writes in both dtypes).
template <typename T>
__host__ __device__ constexpr int k_stride(int K) {
  return round_up(K, Op<T>::kDepth) + Op<T>::kPad;
}
__host__ __device__ constexpr int w2_stride(int HK) { return HK + 8; }
__host__ __device__ constexpr int out_stride(int Dout) { return round_up(Dout, 32) + 8; }

struct TArgs {
  const void* x;
  const void* w1;
  const float* b1;
  const void* w2;
  const float* b2;
  void* out;
  float* out32;
  long long M;
  int D, Hd, Dout;
};

// Rows [r0, r0 + rows) and columns [c0, c0 + cols) of a row-major matrix of
// nrows x ncols (row stride src_ld) into dst (row stride ld) by cp.async;
// zero past nrows and ncols. cols, c0 and ncols are multiples of a 16-byte
// piece.
template <typename T>
__device__ __forceinline__ void stage(const T* src, long long src_ld, long long r0, int rows,
                                      long long nrows, int c0, int cols, int ncols, T* dst,
                                      int ld) {
  constexpr int K = Op<T>::kChunk;
  const int cpr = cols / K;
  for (int e = threadIdx.x; e < rows * cpr; e += blockDim.x) {
    const int r = e / cpr;
    const int c = (e - r * cpr) * K;
    const bool ok = r0 + r < nrows && c0 + c < ncols;
    cp_async16(dst + r * ld + c, ok ? src + (r0 + r) * src_ld + c0 + c : src, ok);
  }
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// 16 bytes of T from f32 (ln_project.cuh's unpack16 the other way).
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// acc += (the warp's 16 rows of A, stride lda) x (64 rows of W, stride ldw)^T
// over the depth K (a multiple of the MMA depth): the 64 hidden units of a
// chunk, 8 n-tiles.
__device__ __forceinline__ void prod_hidden(const bf16* a_w, int lda, const bf16* w, int ldw,
                                            int K, int lane, float (&acc)[8][4]) {
  for (int kc = 0; kc < K; kc += 16) {
    unsigned af[4];
    load_a_frag(af, a_w, lda, kc, lane);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      load_bt_frags(b, w, ldw, np * 16, kc, lane);
      mma_bf16_16816(acc[2 * np], af, b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], af, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void prod_hidden(const float* a_w, int lda, const float* w, int ldw,
                                            int K, int lane, float (&acc)[8][4]) {
  const int g = lane >> 2, t4 = lane & 3;
  for (int kc = 0; kc < K; kc += 8) {
    unsigned ab[4], as[4];
    split_tf32(a_w[g * lda + kc + t4], ab[0], as[0]);
    split_tf32(a_w[(g + 8) * lda + kc + t4], ab[1], as[1]);
    split_tf32(a_w[g * lda + kc + t4 + 4], ab[2], as[2]);
    split_tf32(a_w[(g + 8) * lda + kc + t4 + 4], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float* w_row = w + (n * 8 + g) * ldw + kc + t4;
      unsigned bb0, bs0, bb1, bs1;
      split_tf32(w_row[0], bb0, bs0);
      split_tf32(w_row[4], bb1, bs1);
      mma_3xtf32(acc[n], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// acc += h W2^T for the warp's 16 rows: h the chunk's 64 rounded units in
// the first product's accumulators, W2 8 NO rows (outputs) of 64 units from
// w2 (row stride ld2).
template <int NO>
__device__ __forceinline__ void prod_out(const float (&h)[8][4], const bf16* w2, int ld2,
                                         int lane, float (&acc)[NO][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const unsigned af[4] = {pack_bf16(h[2 * kk][0], h[2 * kk][1]),
                            pack_bf16(h[2 * kk][2], h[2 * kk][3]),
                            pack_bf16(h[2 * kk + 1][0], h[2 * kk + 1][1]),
                            pack_bf16(h[2 * kk + 1][2], h[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < NO / 2; ++np) {
      unsigned b[4];
      load_bt_frags(b, w2, ld2, np * 16, kk * 16, lane);
      mma_bf16_16816(acc[2 * np], af, b[0], b[1]);
      mma_bf16_16816(acc[2 * np + 1], af, b[2], b[3]);
    }
  }
}

template <int NO>
__device__ __forceinline__ void prod_out(const float (&h)[8][4], const float* w2, int ld2,
                                         int lane, float (&acc)[NO][4]) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    unsigned ab[4], as[4];  // k slot t: unit kk 8 + 2t; slot t + 4: unit kk 8 + 2t + 1
    split_tf32(h[kk][0], ab[0], as[0]);
    split_tf32(h[kk][2], ab[1], as[1]);
    split_tf32(h[kk][1], ab[2], as[2]);
    split_tf32(h[kk][3], ab[3], as[3]);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float2 w = *reinterpret_cast<const float2*>(w2 + (n * 8 + g) * ld2 + kk * 8 + 2 * t4);
      unsigned bb0, bs0, bb1, bs1;
      split_tf32(w.x, bb0, bs0);
      split_tf32(w.y, bb1, bs1);
      mma_3xtf32(acc[n], ab, as, bb0, bb1, bs0, bs1);
    }
  }
}

// LayerNorm of the warp's 16 rows of a tile in place (f32 statistics, eps
// 1e-5, rounded to T), two lanes a row, each over every other 16-byte piece
// of it, so that a row's sums need one shuffle. Columns past D stay as
// staged (zero); a zero row stays zero.
template <typename T>
__device__ __forceinline__ void ln_in_place(T* rows, int ld, int D, int lane) {
  constexpr int K = Op<T>::kChunk;
  T* row = rows + (lane >> 1) * ld;
  const int cpr = D / K;
  float mu = 0.f, sq = 0.f;
  for (int c = lane & 1; c < cpr; c += 2) {
    float f[K];
    unpack16(*reinterpret_cast<const uint4*>(row + c * K), f);
#pragma unroll
    for (int j = 0; j < K; ++j) mu += f[j];
  }
  mu = (mu + __shfl_xor_sync(kFull, mu, 1)) / (float)D;
  for (int c = lane & 1; c < cpr; c += 2) {
    float f[K];
    unpack16(*reinterpret_cast<const uint4*>(row + c * K), f);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float t = f[j] - mu;
      sq = fmaf(t, t, sq);
    }
  }
  const float rstd = rsqrtf((sq + __shfl_xor_sync(kFull, sq, 1)) / (float)D + 1e-5f);
  for (int c = lane & 1; c < cpr; c += 2) {
    uint4* piece = reinterpret_cast<uint4*>(row + c * K);
    float f[K];
    unpack16(*piece, f);
#pragma unroll
    for (int j = 0; j < K; ++j) f[j] = (f[j] - mu) * rstd;
    *piece = pack(f);
  }
}

// h = ReLU(acc + b1) rounded to T in place; b1_s the chunk's 64 biases in
// shared memory (zero past Hd, where W1's rows are zero too, so h is 0).
template <typename T>
__device__ __forceinline__ void relu_hidden_s(float (&acc)[8][4], const float* b1_s, int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 b = *reinterpret_cast<const float2*>(b1_s + n * 8 + 2 * t4);
    acc[n][0] = Io<T>::round(fmaxf(acc[n][0] + b.x, 0.f));
    acc[n][1] = Io<T>::round(fmaxf(acc[n][1] + b.y, 0.f));
    acc[n][2] = Io<T>::round(fmaxf(acc[n][2] + b.x, 0.f));
    acc[n][3] = Io<T>::round(fmaxf(acc[n][3] + b.y, 0.f));
  }
}

// The warp's 16 output rows from the accumulators plus b2 (b2_s, zero when
// absent), through its rows of a shared tile (stride ld) so that it stores
// whole rows in 16-byte pieces; rows at or past M are not stored. The tile
// may be the warp's own dead input rows: the caller has synced the warp.
template <typename T, int NO>
__device__ __forceinline__ void store_rows(float (&acc)[NO][4], const float* b2_s, T* tile, int ld,
                                           T* __restrict__ out, long long row0, long long M,
                                           int Dout, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t4;
    if (col < Dout) {
      const float2 b = *reinterpret_cast<const float2*>(b2_s + col);
      store2(tile + g * ld + col, acc[n][0] + b.x, acc[n][1] + b.y);
      store2(tile + (g + 8) * ld + col, acc[n][2] + b.x, acc[n][3] + b.y);
    }
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  __syncwarp();
  const int cpr = Dout / Op<T>::kChunk;
  for (int e = lane; e < 16 * cpr; e += 32) {
    const int r = e / cpr;
    const int col = (e - r * cpr) * Op<T>::kChunk;
    if (row0 + r < M)
      *reinterpret_cast<uint4*>(out + (row0 + r) * Dout + col) =
          *reinterpret_cast<const uint4*>(tile + r * ld + col);
  }
  __syncwarp();
}

// Biases into shared memory as f32, zero past n (b may be null: all zero).
__device__ __forceinline__ void stage_bias(const float* __restrict__ b, int n, int padded,
                                           float* dst) {
  for (int i = threadIdx.x; i < padded; i += blockDim.x)
    dst[i] = b != nullptr && i < n ? b[i] : 0.f;
}

// The rows layout with W resident: W1, W2, b1 and b2 staged once per block;
// then each warp walks 16-row tiles of its own (a persistent grid), its x
// double-buffered by its own cp.async copies, so that no block barrier
// follows the first: LN in place, per hidden chunk the first product, ReLU
// and the second product from registers, the outputs through the dead x
// rows. NO: 8-output n-tiles (8: Dout <= 64, 16: <= 128).
template <typename T, int NO, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1) transition_mma_rows_kernel(const TArgs a) {
  const int D = a.D, Hd = a.Hd, Dout = a.Dout;
  const int DP = round_up(D, Op<T>::kDepth), lda = k_stride<T>(D);
  const int ldx = k_stride<T>(D > Dout ? D : Dout);  // x rows, then the output rows
  const int nch = (Hd + kHid - 1) / kHid, HK = nch * kHid, ld2 = w2_stride(HK);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w1_s = reinterpret_cast<T*>(smem_raw);  // [HK][lda]
  T* w2_s = w1_s + HK * lda;                 // [8 NO][ld2]
  float* b1_s = reinterpret_cast<float*>(w2_s + 8 * NO * ld2);  // [HK]
  float* b2_s = b1_s + HK;                                      // [8 NO]
  T* x_s = reinterpret_cast<T*>(b2_s + 8 * NO);                 // [WARPS][2][16][ldx]
  const T* x = static_cast<const T*>(a.x);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);
  T* out = static_cast<T*>(a.out);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tiles = (a.M + 15) / 16;
  const long long step = (long long)gridDim.x * WARPS;
  long long tile = (long long)blockIdx.x * WARPS + warp;
  T* xw = x_s + warp * 2 * 16 * ldx;
  // the warp's x tile into buffer buf: its lanes' own copies
  auto stage_x = [&](long long t, int buf) {
    constexpr int K = Op<T>::kChunk;
    const int cpr = DP / K;
    T* dst = xw + buf * 16 * ldx;
    for (int e = lane; e < 16 * cpr; e += 32) {
      const int r = e / cpr;
      const int c = (e - r * cpr) * K;
      const bool ok = t < tiles && t * 16 + r < a.M && c < D;
      cp_async16(dst + r * ldx + c, ok ? x + (t * 16 + r) * D + c : x, ok);
    }
  };

  stage(w1, D, 0, HK, Hd, 0, DP, D, w1_s, lda);
  stage(w2, Hd, 0, 8 * NO, Dout, 0, HK, Hd, w2_s, ld2);
  stage_x(tile, 0);
  cp_async_commit();
  stage_x(tile + step, 1);
  cp_async_commit();
  stage_bias(a.b1, Hd, HK, b1_s);
  stage_bias(a.b2, Dout, 8 * NO, b2_s);
  cp_async_wait<1>();
  __syncthreads();  // W and the biases are in, and every warp's first tile

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int i = 0; tile < tiles; ++i, tile += step) {
    T* a_w = xw + (i & 1) * 16 * ldx;
    ln_in_place<T>(a_w, ldx, D, lane);
    __syncwarp();
    for (int c = 0; c < nch; ++c) {
      float h[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) h[n][0] = h[n][1] = h[n][2] = h[n][3] = 0.f;
      prod_hidden(a_w, ldx, w1_s + c * kHid * lda, lda, DP, lane, h);
      relu_hidden_s<T>(h, b1_s + c * kHid, lane);
      prod_out<NO>(h, w2_s + c * kHid, ld2, lane, acc);
    }
    __syncwarp();  // every lane is done reading the tile: it takes the outputs
    store_rows<T, NO>(acc, b2_s, a_w, ldx, out, tile * 16, a.M, Dout, lane);
    stage_x(tile + 2 * step, i & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();  // the next tile is in
  }
  cp_async_wait<0>();
}

// The rows layout with W streamed (W1 and W2 past shared memory whole, as
// at pair width 128): blocks of 8 warps walk 128-row tiles; per hidden chunk
// W1's and W2's 64-unit slices load while the other product runs (block
// barriers around each), the next tile's x once the last chunk's first
// product has read the A tile.
template <typename T, int NO>
__global__ void __launch_bounds__(kRowWarps * 32, 1) transition_mma_chunks_kernel(const TArgs a) {
  constexpr int TM = 16 * kRowWarps;
  const int D = a.D, Hd = a.Hd, Dout = a.Dout;
  const int DP = round_up(D, Op<T>::kDepth), lda = k_stride<T>(D);
  const int nch = (Hd + kHid - 1) / kHid;
  const int ld2 = w2_stride(kHid), ldo = out_stride(Dout);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a_s = reinterpret_cast<T*>(smem_raw);  // [TM][lda]: x, then x^ in place
  T* o_s = a_s + TM * lda;                  // [TM][ldo]: the output tile
  T* w1_s = o_s + TM * ldo;                 // [kHid][lda]
  T* w2_s = w1_s + kHid * lda;              // [8 NO][ld2]
  float* b1_s = reinterpret_cast<float*>(w2_s + 8 * NO * ld2);  // [nch 64]
  float* b2_s = b1_s + nch * kHid;                              // [8 NO]
  const T* x = static_cast<const T*>(a.x);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);
  T* out = static_cast<T*>(a.out);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tiles = (a.M + TM - 1) / TM;
  long long tile = blockIdx.x;
  T* a_w = a_s + warp * 16 * lda;

  // groups in order: (x, W1's first chunk), (W2's first chunk); then per
  // chunk (the next W1 chunk and, after a tile's last chunk, the next tile's
  // x) and (the next W2 chunk)
  stage(x, D, tile * TM, TM, a.M, 0, DP, D, a_s, lda);
  stage(w1, D, 0, kHid, Hd, 0, DP, D, w1_s, lda);
  cp_async_commit();
  stage(w2, Hd, 0, 8 * NO, Dout, 0, kHid, Hd, w2_s, ld2);
  cp_async_commit();
  stage_bias(a.b1, Hd, nch * kHid, b1_s);
  stage_bias(a.b2, Dout, 8 * NO, b2_s);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  while (tile < tiles) {
    for (int c = 0; c < nch; ++c) {
      cp_async_wait<1>();
      __syncthreads();  // x (at c = 0) and W1's chunk are in
      if (c == 0) {
        ln_in_place<T>(a_w, lda, D, lane);
        __syncwarp();
      }
      float h[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) h[n][0] = h[n][1] = h[n][2] = h[n][3] = 0.f;
      prod_hidden(a_w, lda, w1_s, lda, DP, lane, h);
      relu_hidden_s<T>(h, b1_s + c * kHid, lane);
      __syncthreads();  // every warp is done with W1's chunk and, at the last, the A tile
      const bool last = c + 1 == nch;
      const long long next = last ? tile + gridDim.x : tile;
      if (next < tiles) {
        if (last) stage(x, D, next * TM, TM, a.M, 0, DP, D, a_s, lda);
        stage(w1, D, (last ? 0 : c + 1) * kHid, kHid, Hd, 0, DP, D, w1_s, lda);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // W2's chunk is in
      prod_out<NO>(h, w2_s, ld2, lane, acc);
      __syncthreads();  // every warp is done with W2's chunk
      if (next < tiles)
        stage(w2, Hd, 0, 8 * NO, Dout, (last ? 0 : c + 1) * kHid, kHid, Hd, w2_s, ld2);
      cp_async_commit();
    }
    store_rows<T, NO>(acc, b2_s, o_s + warp * 16 * ldo, ldo, out, tile * TM + warp * 16, a.M,
                      Dout, lane);
    tile += gridDim.x;
  }
  cp_async_wait<0>();
}

// 16 bytes of partial sums added into the f32 scratch.
__device__ __forceinline__ void add4(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

// acc's [16, 64] sums (the warp's rows, outputs [c0, c0 + 64)) added into
// the f32 scratch 16 bytes at a time: through the warp's [16][68] f32 tile,
// so that each lane adds four neighbouring outputs of one row.
__device__ __forceinline__ void add_partial(const float (&acc)[8][4], float* tile,
                                            float* __restrict__ out32, long long row0,
                                            long long M, int c0, int Dout, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    store2(tile + g * 68 + n * 8 + 2 * t4, acc[n][0], acc[n][1]);
    store2(tile + (g + 8) * 68 + n * 8 + 2 * t4, acc[n][2], acc[n][3]);
  }
  __syncwarp();
  for (int e = lane; e < 16 * 16; e += 32) {
    const int r = e >> 4, c = (e & 15) * 4;
    if (row0 + r < M && c0 + c < Dout)
      add4(out32 + (row0 + r) * Dout + c0 + c, *reinterpret_cast<const float4*>(tile + r * 68 + c));
  }
  __syncwarp();
}

// The split layout: block (row tile of 16 WARPS rows, hidden chunk of 64).
// The tile's x lands whole and each warp normalises its 16 rows in place
// (LN once per block). W1's chunk in 64-column slabs (the first product)
// and then W2's rows in 64-output slabs (the second, whose partial sums go
// into the f32 scratch) stream through one ring of kRing slots, kRing - 1
// slabs in flight while one is multiplied.
constexpr int kRing = 3;
constexpr int kSlot = kSlab * 72;  // elements of a ring slot: 64 rows of up to 72

template <typename T, int WARPS>
__global__ void __launch_bounds__(WARPS * 32) transition_mma_split_kernel(const TArgs a) {
  constexpr int TM = 16 * WARPS;
  constexpr int LDS = k_stride<T>(kSlab), LD2 = w2_stride(kHid);
  const int D = a.D, Hd = a.Hd, Dout = a.Dout;
  const int DP = round_up(D, Op<T>::kDepth), lda = k_stride<T>(D);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a_s = reinterpret_cast<T*>(smem_raw);  // [TM][lda]: x, then x^ in place
  T* ring = a_s + TM * lda;                 // [kRing][kSlot]: W1 and W2 slabs
  float* t_s = reinterpret_cast<float*>(ring + kRing * kSlot);  // [TM][68]: partial sums
  const T* x = static_cast<const T*>(a.x);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w2 = static_cast<const T*>(a.w2);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long m0 = (long long)blockIdx.x * TM;
  const int h0 = blockIdx.y * kHid;
  T* a_w = a_s + warp * 16 * lda;
  const int s1 = (D + kSlab - 1) / kSlab;               // W1's slabs, then
  const int slabs = s1 + (Dout + kSlab - 1) / kSlab;     // W2's
  auto stage_slab = [&](int s) {
    T* slot = ring + (s % kRing) * kSlot;
    if (s < s1)
      stage(w1, D, h0, kHid, Hd, s * kSlab, kSlab, D, slot, LDS);
    else
      stage(w2, Hd, (s - s1) * kSlab, kSlab, Dout, h0, kHid, Hd, slot, LD2);
  };

  // groups: (x, slab 0), then one a slab
  stage(x, D, m0, TM, a.M, 0, DP, D, a_s, lda);
  stage_slab(0);
  cp_async_commit();
  for (int s = 1; s < kRing - 1; ++s) {
    if (s < slabs) stage_slab(s);
    cp_async_commit();
  }
  float h[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) h[n][0] = h[n][1] = h[n][2] = h[n][3] = 0.f;
  for (int s = 0; s < slabs; ++s) {
    if (s + kRing - 1 < slabs) stage_slab(s + kRing - 1);
    cp_async_commit();
    cp_async_wait<kRing - 1>();
    __syncthreads();  // slab s (the first time, x too) is in
    const T* slot = ring + (s % kRing) * kSlot;
    if (s == 0) {
      ln_in_place<T>(a_w, lda, D, lane);
      __syncwarp();
    }
    if (s < s1) {  // the slab's depth: 64 columns, or what is left of DP (zero past D)
      prod_hidden(a_w + s * kSlab, lda, slot, LDS, min(kSlab, DP - s * kSlab), lane, h);
    } else {
      if (s == s1) {  // h = ReLU(x^ W1^T + b1), rounded
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int u = h0 + n * 8 + 2 * (lane & 3) + e;
            const float bias = u < Hd ? __ldg(a.b1 + u) : 0.f;
            h[n][e] = Io<T>::round(fmaxf(h[n][e] + bias, 0.f));
            h[n][e + 2] = Io<T>::round(fmaxf(h[n][e + 2] + bias, 0.f));
          }
      }
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      prod_out<8>(h, slot, LD2, lane, acc);
      add_partial(acc, t_s + warp * 16 * 68, a.out32, m0 + warp * 16, a.M, (s - s1) * kSlab,
                  Dout, lane);
    }
    __syncthreads();  // every warp is done with slot s % kRing before it is refilled
  }
}

// out = round(out32 + b2) for the split blocks' sums.
template <typename T>
__global__ void __launch_bounds__(256)
    transition_mma_finish_kernel(const float* __restrict__ out32, const float* __restrict__ b2,
                                 T* __restrict__ out, long long n, int Dout) {
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  if (e < n) out[e] = Io<T>::cast(out32[e] + (b2 != nullptr ? b2[e % Dout] : 0.f));
}

// Warps a block of the resident rows layout: 8 (in bf16 two such blocks fit
// an SM at pair_fc; 16 a block ran 6% slower there, kernels.variants
// k10rows), 4 where 8 do not fit.
template <typename T>
constexpr int kResidentWarps = 8;

// Shared memory (bytes) of each layout; the layout a shape takes (0: rows,
// W resident; 1: rows, W streamed; 2: split; -1: none). ops/transition.py
// mirrors these.
template <typename T>
size_t rows_smem(int D, int Hd, int Dout, int warps) {
  const int NO8 = Dout <= 64 ? 64 : 128, HK = round_up(Hd, kHid), lda = k_stride<T>(D);
  const int ldx = k_stride<T>(D > Dout ? D : Dout);
  return sizeof(T) * ((size_t)HK * lda + (size_t)NO8 * w2_stride(HK) + (size_t)warps * 32 * ldx) +
         sizeof(float) * (HK + NO8);
}

template <typename T>
size_t chunks_smem(int D, int Hd, int Dout) {
  constexpr int TM = 16 * kRowWarps;
  const int NO8 = Dout <= 64 ? 64 : 128, lda = k_stride<T>(D);
  return sizeof(T) * ((size_t)TM * lda + (size_t)TM * out_stride(Dout) + (size_t)kHid * lda +
                      (size_t)NO8 * w2_stride(kHid)) +
         sizeof(float) * (round_up(Hd, kHid) + NO8);
}

template <typename T>
size_t split_smem(int D, int warps) {
  return sizeof(T) * ((size_t)16 * warps * k_stride<T>(D) + (size_t)kRing * kSlot) +
         sizeof(float) * 16 * warps * 68;
}

// Warps a block of the split layout: 4 (64 rows) where they fit, else 2.
template <typename T>
int split_warps(int D) {
  return split_smem<T>(D, 4) <= kMaxSmem ? 4 : (split_smem<T>(D, 2) <= kMaxSmem ? 2 : 0);
}

template <typename T>
int resident_warps(int D, int Hd, int Dout) {
  for (int w = kResidentWarps<T>; w >= kResidentWarps<T> / 2; w /= 2)
    if (rows_smem<T>(D, Hd, Dout, w) <= kMaxSmem) return w;
  return 0;
}

template <typename T>
int layout_of(int D, int Hd, int Dout) {
  if (Dout <= 128) {
    if (resident_warps<T>(D, Hd, Dout) > 0) return 0;
    if (chunks_smem<T>(D, Hd, Dout) <= kMaxSmem) return 1;
  }
  return split_warps<T>(D) > 0 && (Hd + kHid - 1) / kHid <= 65535 ? 2 : -1;
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15u) == 0; }

// A persistent grid: the blocks of a kernel that fit on the card at once,
// asked of the runtime once per kernel (each launch function keeps its own)
// and shared-memory size (host time).
struct GridCache {
  size_t smem = 0;
  long long blocks = 0;
};

template <typename Kernel>
cudaError_t resident_blocks(Kernel kern, int threads, size_t smem, GridCache& cache) {
  if (smem == cache.smem) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int device = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cache.smem = smem;
  cache.blocks = (long long)sms * per_sm;
  return cudaSuccess;
}

template <typename T, int NO, int WARPS>
cudaError_t launch_rows(const TArgs& a, cudaStream_t stream) {
  auto kern = transition_mma_rows_kernel<T, NO, WARPS>;
  const size_t smem = rows_smem<T>(a.D, a.Hd, a.Dout, WARPS);
  static GridCache cache;
  const cudaError_t e = resident_blocks(kern, WARPS * 32, smem, cache);
  if (e != cudaSuccess) return e;
  const long long need = ((a.M + 15) / 16 + WARPS - 1) / WARPS;
  kern<<<(unsigned)(need < cache.blocks ? need : cache.blocks), WARPS * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int NO>
cudaError_t launch_chunks(const TArgs& a, cudaStream_t stream) {
  auto kern = transition_mma_chunks_kernel<T, NO>;
  const size_t smem = chunks_smem<T>(a.D, a.Hd, a.Dout);
  static GridCache cache;
  const cudaError_t e = resident_blocks(kern, kRowWarps * 32, smem, cache);
  if (e != cudaSuccess) return e;
  const long long need = (a.M + 16 * kRowWarps - 1) / (16 * kRowWarps);
  kern<<<(unsigned)(need < cache.blocks ? need : cache.blocks), kRowWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int WARPS>
cudaError_t launch_split(const TArgs& a, cudaStream_t stream) {
  if (a.out32 == nullptr) return cudaErrorInvalidValue;
  auto kern = transition_mma_split_kernel<T, WARPS>;
  const size_t smem = split_smem<T>(a.D, WARPS);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const long long tiles = (a.M + 16 * WARPS - 1) / (16 * WARPS);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<dim3((unsigned)tiles, (a.Hd + kHid - 1) / kHid), WARPS * 32, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = a.M * a.Dout;
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  transition_mma_finish_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      a.out32, a.b2, static_cast<T*>(a.out), n, a.Dout);
  return cudaGetLastError();
}

template <typename T, int NO>
cudaError_t dispatch_rows(const TArgs& a, cudaStream_t stream) {
  constexpr int W = kResidentWarps<T>;
  if (resident_warps<T>(a.D, a.Hd, a.Dout) == W) return launch_rows<T, NO, W>(a, stream);
  return launch_rows<T, NO, W / 2>(a, stream);
}

template <typename T>
cudaError_t dispatch(const TArgs& a, cudaStream_t stream) {
  constexpr int K = Op<T>::kChunk;
  if (a.D % K || a.Hd % K || a.Dout % K || !aligned16(a.x) || !aligned16(a.w1) ||
      !aligned16(a.w2) || !aligned16(a.out))
    return cudaErrorInvalidValue;
  switch (layout_of<T>(a.D, a.Hd, a.Dout)) {
    case 0:
      return a.Dout <= 64 ? dispatch_rows<T, 8>(a, stream) : dispatch_rows<T, 16>(a, stream);
    case 1:
      return a.Dout <= 64 ? launch_chunks<T, 8>(a, stream) : launch_chunks<T, 16>(a, stream);
    case 2:
      return split_warps<T>(a.D) == 4 ? launch_split<T, 4>(a, stream)
                                       : launch_split<T, 2>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// K10 on the tensor cores over M rows: D, Hd and Dout multiples of 8 (bf16)
// or 4 (f32). out32: a zeroed f32 [M, Dout] scratch, needed where the split
// layout runs (Dout > 128, or the rows layout's tiles past shared memory).
int prd_transition_mma(const void* x, const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, void* out32, int dtype, int M, int D, int Hd,
                       int Dout, void* stream) {
  const TArgs a{x, w1, static_cast<const float*>(b1), w2, static_cast<const float*>(b2), out,
                static_cast<float*>(out32), M, D, Hd, Dout};
  if ((dtype != 0 && dtype != 1) || M <= 0 || D <= 0 || Hd <= 0 || Dout <= 0 || b1 == nullptr)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 0 ? dispatch<float>(a, s) : dispatch<bf16>(a, s));
}

// The layout prd_transition_mma takes for these widths (0: rows with W
// resident, 1: rows with W streamed, 2: split, -1: none).
int prd_transition_mma_layout(int dtype, int D, int Hd, int Dout) {
  return dtype == 0 ? layout_of<float>(D, Hd, Dout) : layout_of<bf16>(D, Hd, Dout);
}

}  // extern "C"
