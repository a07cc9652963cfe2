// Hand-written Hopper (sm_90a) fused gated rows attention on the tensor
// cores, bf16 (mma.sync m16n8k16) and f32 (3xTF32): the whole no-bias
// GatedAttention of a triangle attention in one entry point, for head
// widths C that are a multiple of 8.
//
// Replaces the Pallas TPU kernel K8 of protein_redesign_tpu/ops/pallas_attention.py,
// _fused_gated_impl (:1164) -> _make_fused_gated_kernel (:1064), behind the
// switch use_pallas_fused_gated: both triangle attentions of every FoldingBlock
// at N < 2048. The function is fused_gated.cu's (which keeps the CUDA-core
// body for C = 4 mod 8): per row r of pair rows x [R, N, D],
//
//   x^ = LN(x) rounded to T
//   q = round(x^ Wq / sqrt(C)), k = round(x^ Wk), v = round(x^ Wv)   per head
//   g = sigmoid(x^ Wg + bg)                                           f32
//   o = softmax(q k^T, keys masked with -2^15) v                      f32 softmax
//   out = sum_h round(g_h * o_h) Wo_h + bo                            in T
//
// (T = float: f32 throughout, as the Pallas kernel in interpret mode; every
// product in 3xTF32, which keeps the 1e-5 parity one TF32 product breaks.)
//
// What bounds it: at bucket 192, B = 2 (R = 384, N = 192, D = 64, H = 4,
// C = 16) 6.6 GFLOP (4 R H N^2 C + 10 R N D H C) against ~9.4 MB of rows in
// and out in bf16, so the operations: about 7 us on the tensor cores at
// 989 TFLOP/s, where the CUDA-core body took ~1 ms. What the card then
// spends is the scratch round trip (q, k, v in T and the gate in f32, ~113 MB
// written and read at 192 in bf16) and the softmax's elementwise work. The
// fusion keeps the LN copy, the probabilities and the gated heads out of
// device memory; q, k, v and the gate pass through scratch once, because
// every query tile of a row reads all of its keys (a row's q, k, v and gate
// do not fit in shared memory at N = 1024).
//
// Two kernels, launched back to back by one entry point:
// 1. fused_gated_project_mma_kernel: ln_project.cuh's block, one per 64 row
//    positions: x read through its strides as [R1, R2, N, D] (the "ending"
//    attention's transposed view [B, j, i, D] needs no copy), LN in f32, x^
//    rounded to T into the A tile, [64, D] x [D, 4 H C] in 64-column slices;
//    the epilogue scales q in f32 and rounds it, rounds k and v, and takes
//    the gate's sigmoid in f32, into contiguous scratch [3, R, N, H C] and
//    [R, N, H C].
// 2. fused_gated_attention_{mma,tf32}_kernel, one block of 4 warps per (row,
//    64 queries), 16 queries a warp: for each head, and for each slice of up
//    to 64 of its channels (C > 64 recomputes the logits per slice, so no
//    warp holds more than 64 channels of o), the flash pass of K3's bodies
//    (bf16: attention_mma.cuh's stage_keys, rows_pass with logits_mma,
//    tile_mask / apply_fill, online_step and pv_mma; f32:
//    attention_tf32.cuh's stage_f32, logits_tf32 and pv_tf32 in the same
//    loop): q, K and V tiles by cp.async (K and V double-buffered), online
//    softmax from -inf with the -2^15 fill at masked keys, p = exp(l - m)
//    rounded to T for P.V; round(g * o / s) (the gate read before the pass)
//    goes into the block's gated-heads tile [64, H C] in shared memory. Then
//    one product on the tensor cores, the tile by W_o [H C, D] staged 64 rows
//    at a time into the K and V tiles' space, gives each warp its [16, D] f32
//    sum over heads; out = sum + bo in T. The sum is live only after the
//    passes, so they run under K3's register caps with as many warps a SM
//    (a sum kept in registers across heads would hold 32-64 more registers
//    a thread through every pass). A fully masked row has every logit at
//    -2^15 and attends uniformly, as the reference softmax does.
//
// Rounding: the tensor-core body rounds the unnormalised probabilities to T
// for P.V and divides by the sum after, as K1's tensor-core body and the
// CUDA-core body do; the plain version rounds the normalised ones. In f32
// that is exact; in bf16 it stays inside the 2e-2 gate.
//
// Layout: x [R1, R2, N, D] with D contiguous and element strides (s1, s2, sn);
// mask contiguous f32 [R, N] (R = R1 R2); w_in [D, 4 H C] in T (q | k | v |
// gate columns); bg [H C] f32; wo_t [H C, D] in T; bo [D] f32; out contiguous
// [R, N, D]. Takes D up to 512, C a multiple of 8 up to 128 and H C up to
// 512 (h16x4, h64x1, h64x4 at pair widths 64-512). Past D = 128 the
// out-projection runs in slices of 128 output columns, each re-reading the
// gated-heads tile (one slice up to 128, so those widths keep their bits),
// and the LN + projection is fused_gated_wide.cu's kernel on ln_project.cuh's
// wide block (the A tile alone resident, W streamed in K slices). The entry
// points return cudaGetLastError().

#include "attention_tf32.cuh"
#include "fused_gated_rows.cuh"

// fused_gated_wide.cu's LN + projection on ln_project.cuh's wide block,
// which project() runs past D = 128.
extern "C" int prd_fused_gated_project_wide(const void* x, const void* w_in, const void* bg,
                                            void* qkv, void* gate, int dtype, int R1, int R2,
                                            int N, int D, int HC, float scale, long long s1,
                                            long long s2, long long sn, void* stream);

namespace {

constexpr int kFgMaxD = 512;  // out-projection slices of 128 columns past 128
constexpr int kFgMaxC = 128;
constexpr int kFgMaxWidth = 512;  // H C

struct FgArgs {
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
};

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kLnpThreads, kLnpMinBlocks)
    fused_gated_project_mma_kernel(const FgArgs a) {
  extern __shared__ __align__(16) unsigned char smem_fg[];
  const int HC = a.H * a.C;
  const long long positions = (long long)a.R1 * a.R2 * a.N;
  const long long p0 = (long long)blockIdx.x * kLnpRows;
  const int rows = (int)min((long long)kLnpRows, positions - p0);
  const StridedRows<T> load =
      strided_rows(static_cast<const T*>(a.x), a.R2, a.N, a.D, a.s1, a.s2, a.sn);
  const QkvGate<T> epi{static_cast<T*>(a.qkv), a.gate, a.bg, HC, a.scale, positions};
  ln_project<T>(load, static_cast<const T*>(a.w_in), a.D, 4 * HC, p0, rows, epi, smem_fg);
}

// Rows [k0, k0 + 64) and columns [d0, d0 + DP) of W_o [HC, D] (T) into
// shared memory as [64][ld], zero past HC and past D: by cp.async where D
// fills whole 16-byte chunks, else element by element.
template <typename T>
__device__ __forceinline__ void stage_wo(const T* __restrict__ wo, int HC, int D, int d0, int DP,
                                         int k0, int ld, T* dst) {
  constexpr int kChunk = 16 / sizeof(T);
  if (D % kChunk == 0) {
    const int per_row = DP / kChunk;
    for (int e = threadIdx.x; e < 64 * per_row; e += blockDim.x) {
      const int j = e / per_row;
      const int d = (e - j * per_row) * kChunk;
      const bool ok = k0 + j < HC && d0 + d < D;
      cp_async16(dst + j * ld + d, ok ? wo + (long long)(k0 + j) * D + d0 + d : wo, ok);
    }
    return;
  }
  for (int e = threadIdx.x; e < 64 * DP; e += blockDim.x) {
    const int j = e / DP;
    const int d = e - j * DP;
    dst[j * ld + d] =
        k0 + j < HC && d0 + d < D ? wo[(long long)(k0 + j) * D + d0 + d] : Io<T>::cast(0.f);
  }
}

// The gate of the warp's 16 queries (rows row_a, row_a + 8) at the slice's
// channels [cs0, cs0 + 8 NT) of one head, in the P.V accumulators' layout;
// zero past N and past C. Read before the pass, so that its latency hides
// behind it.
template <int NT>
__device__ __forceinline__ void load_gate(const float* gate_h, int HC, int N, int C, int cs0,
                                          int row_a, int lane, float2 (&g)[NT][2]) {
  const int t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = cs0 + n * 8 + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = row_a + 8 * half;
      g[n][half] = q < N && c < C  // C % 8 == 0: c + 1 < C too
                       ? *reinterpret_cast<const float2*>(gate_h + (long long)q * HC + c)
                       : make_float2(0.f, 0.f);
    }
  }
}

// round(g * o / s) of the warp's 16 queries and the slice's channels into
// the gated heads' tile go_s [64][ld] (columns of head h at h C), as T.
template <typename T, int NT>
__device__ __forceinline__ void store_gated(const float (&acc)[NT][4], float s_a, float s_b,
                                            const float2 (&g)[NT][2], int C, int col0, int cs0,
                                            int row_w, int lane, T* go_s, int ld) {
  const int t4 = lane & 3, gr = lane >> 2;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = cs0 + n * 8 + 2 * t4;
    if (c >= C) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float s = half ? s_b : s_a;
      store_pair(go_s + (row_w + gr + 8 * half) * ld + col0 + c,
                 g[n][half].x * (acc[n][2 * half] / s), g[n][half].y * (acc[n][2 * half + 1] / s));
    }
  }
}

// out = sum + bo for the warp's 16 queries, DT n-tiles of 8 output columns
// from d0.
template <typename T, int DT>
__device__ __forceinline__ void store_rows(T* out_r, const float* bo, int N, int D, int d0,
                                           int row_a, const float (&oacc)[DT][4], int lane) {
  const int t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = row_a + 8 * (e >> 1);
      const int col = d0 + n * 8 + 2 * t4 + (e & 1);
      if (q < N && col < D) out_r[(long long)q * D + col] = Io<T>::cast(oacc[n][e] + bo[col]);
    }
  }
}

// The out-projection of the block's gated heads: oacc = go [64, HC] W_o
// [HC, d0 + 8 DT) for the warp's 16 rows, W_o's columns from d0 staged 64
// rows at a time into wo_s (the K and V tiles' space, free after the
// passes). Starts with a barrier.
template <int DT>
__device__ __forceinline__ void out_project(const bf16* go_s, int gs, const bf16* wo, int HC,
                                            int D, int d0, bf16* wo_s, int warp, int lane,
                                            float (&oacc)[DT][4]) {
  constexpr int DP = 8 * DT, OS = DP + 8;
  for (int k0 = 0; k0 < HC; k0 += 64) {
    __syncthreads();  // go_s is complete; the previous chunk's reads are done
    stage_wo(wo, HC, D, d0, DP, k0, OS, wo_s);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int kk = 0; kk < 64 && k0 + kk < HC; kk += 16) {
      unsigned a[4];
      load_a_frag(a, go_s + warp * 16 * gs, gs, k0 + kk, lane);
#pragma unroll
      for (int np = 0; np < DT / 2; ++np) {
        unsigned b[4];
        load_b_frags(b, wo_s, OS, kk, np * 16, lane);
        mma_bf16_16816(oacc[2 * np], a, b[0], b[1]);
        mma_bf16_16816(oacc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

template <int DT>
__device__ __forceinline__ void out_project(const float* go_s, int gs, const float* wo, int HC,
                                            int D, int d0, float* wo_s, int warp, int lane,
                                            float (&oacc)[DT][4]) {
  constexpr int DP = 8 * DT, OS = DP + 8;  // OS = 8 mod 32: conflict-free B reads
  const int g = lane >> 2, t4 = lane & 3;
  const float* a_w = go_s + warp * 16 * gs;
  for (int k0 = 0; k0 < HC; k0 += 64) {
    __syncthreads();  // go_s is complete; the previous chunk's reads are done
    stage_wo(wo, HC, D, d0, DP, k0, OS, wo_s);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int kk = 0; kk < 64 && k0 + kk < HC; kk += 8) {
      const int kc = k0 + kk;
      unsigned ab[4], as[4];
      split_tf32(a_w[g * gs + kc + t4], ab[0], as[0]);
      split_tf32(a_w[(g + 8) * gs + kc + t4], ab[1], as[1]);
      split_tf32(a_w[g * gs + kc + t4 + 4], ab[2], as[2]);
      split_tf32(a_w[(g + 8) * gs + kc + t4 + 4], ab[3], as[3]);
      const float* w0 = wo_s + (kk + t4) * OS + g;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        unsigned bb0, bs0, bb1, bs1;
        split_tf32(w0[n * 8], bb0, bs0);
        split_tf32(w0[4 * OS + n * 8], bb1, bs1);
        mma_3xtf32(oacc[n], ab, as, bb0, bb1, bs0, bs1);
      }
    }
  }
}

// Blocks of the attention kernels that must fit on an SM at once, which caps
// their registers: the passes are latency-bound, as K1's and K3's (whose
// caps these are), and the out-projection's [16, D] sum is live only after
// them; at D > 64 (DT = 16) its 64 accumulators are left uncapped.
template <int NT, int DT>
constexpr int kFgMinBlocks = DT > 8 ? 1 : (NT <= 2 ? 24 : 16) / kWarps;
template <int NTQ, int DT>
constexpr int kFgF32MinBlocks = DT > 8 ? 1 : kF32MinBlocks<kWarps, NTQ < 8 ? NTQ : 8>;

// The gated heads' tile: [64][HC + pad] in T (bf16 rows of an odd number of
// 16-byte units where HC is a multiple of 16; f32 rows = 4 mod 8), the pad
// zeroed: the out-projection reads it in 16-column steps.
template <typename T>
__host__ __device__ constexpr int go_stride(int HC) {
  return HC + (sizeof(T) == 2 ? 8 : 4);
}

template <typename T>
__device__ __forceinline__ void zero_pad(T* go_s, int HC, int gs) {
  for (int e = threadIdx.x; e < kTQ * (gs - HC); e += blockDim.x) {
    const int i = e / (gs - HC);
    go_s[i * gs + HC + (e - i * (gs - HC))] = Io<T>::cast(0.f);
  }
}

// bf16: NT 8-channel n-tiles per slice of a head (16, 32 or 64 channels),
// DT n-tiles of output columns (D up to 8 DT).
template <int NT, int DT>
__global__ void __launch_bounds__(kWarps * 32, kFgMinBlocks<NT, DT>)
    fused_gated_attention_mma_kernel(const FgArgs fa) {
  constexpr int CS = 8 * NT, VS = CS + 8, BK = 64;
  extern __shared__ __align__(16) unsigned char smem_fg[];
  const int N = fa.N, C = fa.C, H = fa.H, HC = H * C, D = fa.D;
  const int CP = (C + 15) & ~15, QS = CP + 8, GS = go_stride<bf16>(HC);
  bf16* go_s = reinterpret_cast<bf16*>(smem_fg);  // [kTQ][GS]: the gated heads
  bf16* q_s = go_s + kTQ * GS;                     // [kTQ][QS]
  bf16* k_s = q_s + kTQ * QS;                      // [2][BK][QS]
  bf16* v_s = k_s + 2 * BK * QS;                   // [2][BK][VS]
  const int R = fa.R1 * fa.R2;
  const long long positions = (long long)R * N;
  const bf16* qkv = static_cast<const bf16*>(fa.qkv);
  const Strides st3{(long long)N * HC, HC, C};
  const Args a{qkv, qkv + positions * HC, qkv + 2 * positions * HC, fa.mask, nullptr, nullptr,
               R, N, H, C, 1.f, st3, st3, st3};  // q is scaled already
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Block b = block_of(N, CS);
  const int row_a = b.q0 + warp * 16 + (lane >> 2);
  const float* gate_r = fa.gate + (long long)b.r * N * HC;

  zero_pad(go_s, HC, GS);
  for (int h = 0; h < H; ++h) {
    b.h = h;
    for (int cs0 = 0; cs0 < C; cs0 += CS) {
      b.cs0 = cs0;
      // q by cp.async, landing with the first key tile (the previous pass
      // ended on a barrier, so q_s is free)
      if (cs0 == 0) stage_keys(a.q + b.r * a.qs.r + h * a.qs.h, HC, b.q0, kTQ, N, C, 0, CP, QS, q_s);
      float2 g[NT][2];
      load_gate<NT>(gate_r + h * C, HC, N, C, cs0, row_a, lane, g);
      RowsState<NT> st;
      init_rows(st);
      rows_pass<kOnline, BK, NT>(a, b, q_s + warp * 16 * QS, k_s, v_s, CP, st, lane);
      store_gated<bf16, NT>(st.acc, quad_sum(st.s_a), quad_sum(st.s_b), g, C, h * C, cs0,
                            warp * 16, lane, go_s, GS);
    }
  }
  // the out-projection in slices of 8 DT output columns (one up to D = 128)
  for (int d0 = 0; d0 < D; d0 += 8 * DT) {
    float oacc[DT][4];
#pragma unroll
    for (int n = 0; n < DT; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
    out_project<DT>(go_s, GS, static_cast<const bf16*>(fa.wo_t), HC, D, d0, k_s, warp, lane,
                    oacc);
    store_rows<bf16, DT>(static_cast<bf16*>(fa.out) + (long long)b.r * N * D, fa.bo, N, D, d0,
                         row_a, oacc, lane);
  }
}

// f32 (3xTF32): q and K rows of 8 NTQ channels (the padded head), slices of
// 8 NT = min(8 NTQ, 64) channels of V, BK-key tiles as the one-pass f32 body
// takes them.
template <int NTQ, int DT>
__global__ void __launch_bounds__(kWarps * 32, kFgF32MinBlocks<NTQ, DT>)
    fused_gated_attention_tf32_kernel(const FgArgs fa) {
  constexpr int CPQ = 8 * NTQ, NT = NTQ < 8 ? NTQ : 8, CS = 8 * NT;
  constexpr int BK = kF32Keys<NTQ>, NS = BK / 8;
  constexpr int LD = CPQ + 4, LDV = CS + 4;
  extern __shared__ __align__(16) unsigned char smem_fg[];
  const int N = fa.N, C = fa.C, H = fa.H, HC = H * C, D = fa.D;
  const int GS = go_stride<float>(HC);
  float* go_s = reinterpret_cast<float*>(smem_fg);  // [kTQ][GS]: the gated heads
  float* q_s = go_s + kTQ * GS;                      // [kTQ][LD]
  float* k_s = q_s + kTQ * LD;                       // [2][BK][LD]
  float* v_s = k_s + 2 * BK * LD;                    // [2][BK][LDV]
  const long long positions = (long long)fa.R1 * fa.R2 * N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Block b = block_of(N, CS);
  const int row_a = b.q0 + warp * 16 + (lane >> 2);
  const float* qkv = static_cast<const float*>(fa.qkv);
  const float* q_r = qkv + (long long)b.r * N * HC;
  const float* k_r = q_r + positions * HC;
  const float* v_r = k_r + positions * HC;
  const float* gate_r = fa.gate + (long long)b.r * N * HC;
  const float* mask_row = fa.mask + (long long)b.r * N;
  const float* q_w = q_s + warp * 16 * LD;
  const int tiles = (N + BK - 1) / BK;

  zero_pad(go_s, HC, GS);
  for (int h = 0; h < H; ++h) {
    for (int cs0 = 0; cs0 < C; cs0 += CS) {
      // q lands with the first key tile (the previous pass ended on a barrier)
      if (cs0 == 0) stage_f32(q_r + h * C, HC, b.q0, kTQ, N, C, CPQ, LD, q_s);
      const float* k_base = k_r + h * C;
      const float* v_base = v_r + h * C + cs0;
      stage_f32(k_base, HC, 0, BK, N, C, CPQ, LD, k_s);
      stage_f32(v_base, HC, 0, BK, N, C - cs0, CS, LDV, v_s);
      cp_async_commit();
      float2 g[NT][2];
      load_gate<NT>(gate_r + h * C, HC, N, C, cs0, row_a, lane, g);
      RowsState<NT> st;
      init_rows(st);
      float nm_a = 0.f, nm_b = 0.f;
      for (int t = 0; t < tiles; ++t) {
        const int buf = t & 1;
        if (t + 1 < tiles) {
          stage_f32(k_base, HC, (t + 1) * BK, BK, N, C, CPQ, LD, k_s + (buf ^ 1) * BK * LD);
          stage_f32(v_base, HC, (t + 1) * BK, BK, N, C - cs0, CS, LDV, v_s + (buf ^ 1) * BK * LDV);
        }
        cp_async_commit();
        const TileMask<BK> tm = tile_mask<BK>(mask_row, t * BK, N, lane);
        cp_async_wait<1>();
        __syncthreads();
        float s[NS][4];
        logits_tf32<NS, CPQ>(q_w, k_s + buf * BK * LD, LD, lane, s);  // S = Q K^T
        apply_fill<NS, BK>(s, tm);
        online_step<true, NS, NT>(s, st, nm_a, nm_b);
        exp_rows<true, NS, NT>(s, st, nm_a, nm_b);
        pv_tf32<NS, NT>(s, v_s + buf * BK * LDV, LDV, lane, st.acc);  // acc += P V
        __syncthreads();  // the next tile's loads overwrite this buffer
      }
      store_gated<float, NT>(st.acc, quad_sum(st.s_a), quad_sum(st.s_b), g, C, h * C, cs0,
                             warp * 16, lane, go_s, GS);
    }
  }
  for (int d0 = 0; d0 < D; d0 += 8 * DT) {
    float oacc[DT][4];
#pragma unroll
    for (int n = 0; n < DT; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
    out_project<DT>(go_s, GS, static_cast<const float*>(fa.wo_t), HC, D, d0, k_s, warp, lane,
                    oacc);
    store_rows<float, DT>(static_cast<float*>(fa.out) + (long long)b.r * N * D, fa.bo, N, D, d0,
                          row_a, oacc, lane);
  }
}

template <typename Kernel>
cudaError_t launch_attention(Kernel kern, size_t smem, const FgArgs& a, cudaStream_t stream) {
  const long long blocks = (long long)a.R1 * a.R2 * ((a.N + kTQ - 1) / kTQ);
  if (blocks > 0x7fffffffLL || smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<(unsigned)blocks, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// Shared memory of the attention kernels: the gated heads' tile, the query
// tile and the K and V tiles' space, which the out-projection's 64-row W_o
// chunks reuse.
template <int NT, int DT>
cudaError_t launch_mma(const FgArgs& a, cudaStream_t stream) {
  constexpr int CS = 8 * NT, BK = 64, OS = 8 * DT + 8;
  const int QS = ((a.C + 15) & ~15) + 8;
  const size_t kv = (size_t)2 * BK * QS + 2 * BK * (CS + 8);
  const size_t wo = (size_t)64 * OS;
  const size_t smem = sizeof(bf16) * ((size_t)kTQ * (go_stride<bf16>(a.H * a.C) + QS) +
                                      (kv > wo ? kv : wo));
  return launch_attention(fused_gated_attention_mma_kernel<NT, DT>, smem, a, stream);
}

template <int NTQ, int DT>
cudaError_t launch_tf32(const FgArgs& a, cudaStream_t stream) {
  constexpr int CPQ = 8 * NTQ, CS = 8 * (NTQ < 8 ? NTQ : 8), BK = kF32Keys<NTQ>;
  constexpr int OS = 8 * DT + 8;
  const size_t kv = (size_t)2 * BK * (CPQ + 4) + 2 * BK * (CS + 4);
  const size_t wo = (size_t)64 * OS;
  const size_t smem = sizeof(float) * ((size_t)kTQ * (go_stride<float>(a.H * a.C) + CPQ + 4) +
                                       (kv > wo ? kv : wo));
  return launch_attention(fused_gated_attention_tf32_kernel<NTQ, DT>, smem, a, stream);
}

template <int DT>
cudaError_t dispatch_attention(const FgArgs& a, bool f32, cudaStream_t stream) {
  if (f32) {
    if (a.C <= 8) return launch_tf32<1, DT>(a, stream);
    if (a.C <= 16) return launch_tf32<2, DT>(a, stream);
    if (a.C <= 32) return launch_tf32<4, DT>(a, stream);
    if (a.C <= 64) return launch_tf32<8, DT>(a, stream);
    return launch_tf32<16, DT>(a, stream);
  }
  const int CP = (a.C + 15) & ~15;
  if (CP <= 16) return launch_mma<2, DT>(a, stream);
  if (CP <= 32) return launch_mma<4, DT>(a, stream);
  return launch_mma<8, DT>(a, stream);
}

// K8's LN + projection into the scratch (the whole call's first kernel, and
// the split route's): the block above up to D = 128, the wide block past it
// (or at any D where wide is set).
template <typename T>
cudaError_t project(const FgArgs& a, cudaStream_t stream, bool wide = false) {
  if (wide || a.D > kLnpMaxD)
    return (cudaError_t)prd_fused_gated_project_wide(a.x, a.w_in, a.bg, a.qkv, a.gate,
                                                     sizeof(T) == 2, a.R1, a.R2, a.N, a.D,
                                                     a.H * a.C, a.scale, a.s1, a.s2, a.sn, stream);
  const long long blocks = ((long long)a.R1 * a.R2 * a.N + kLnpRows - 1) / kLnpRows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = lnp_smem_bytes<T>(a.D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(fused_gated_project_mma_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return e;
  }
  fused_gated_project_mma_kernel<T><<<(unsigned)blocks, kLnpThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const FgArgs& a, cudaStream_t stream) {
  const cudaError_t e = project<T>(a, stream);
  if (e != cudaSuccess) return e;
  const bool f32 = sizeof(T) == sizeof(float);
  return a.D <= 64 ? dispatch_attention<8>(a, f32, stream) : dispatch_attention<16>(a, f32, stream);
}

}  // namespace

extern "C" {

// K8 on the tensor cores over rows x [R1, R2, N, D], dtype 0 f32 (3xTF32),
// 1 bf16. Takes D up to 512, C a multiple of 8 up to 128 and H C up to 512.
int prd_fused_gated_mma(const void* x, const void* mask, const void* w_in, const void* bg,
                        const void* wo_t, const void* bo, void* qkv, void* gate, void* out,
                        int dtype, int R1, int R2, int N, int D, int H, int C, float scale,
                        long long s1, long long s2, long long sn, void* stream) {
  const bool ok = (dtype == 0 || dtype == 1) && R1 > 0 && R2 > 0 && N > 0 && D > 0 &&
                  D <= kFgMaxD && H > 0 && C > 0 && C <= kFgMaxC && C % 8 == 0 &&
                  H * C <= kFgMaxWidth && mask != nullptr && aligned16(w_in) && aligned16(qkv) &&
                  aligned16(gate);
  if (!ok) return (int)cudaErrorInvalidValue;
  const FgArgs a{x, static_cast<const float*>(mask), w_in, static_cast<const float*>(bg), wo_t,
                 static_cast<const float*>(bo), qkv, static_cast<float*>(gate), out,
                 R1, R2, N, D, H, C, scale, s1, s2, sn};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, s);
  return (int)launch<bf16>(a, s);
}

// K8's LN + projection alone, the split route's first kernel: x [R1, R2, N,
// D] through its strides into qkv [3, R1 R2 N, H C] (q scaled) in T and gate
// [R1 R2 N, H C] f32, on the tensor cores: ln_project.cuh's block up to D =
// 128 unless wide is 1, its wide block past 128 or where wide is 1
// (ops.attention.split_projection_block). Takes D up to 512 and H C a
// multiple of 4.
int prd_fused_gated_project_mma(const void* x, const void* w_in, const void* bg, void* qkv,
                                void* gate, int dtype, int R1, int R2, int N, int D, int HC,
                                float scale, long long s1, long long s2, long long sn, int wide,
                                void* stream) {
  const bool ok = (dtype == 0 || dtype == 1) && R1 > 0 && R2 > 0 && N > 0 && D > 0 &&
                  D <= kFgMaxD && HC > 0 && HC % 4 == 0 && aligned16(w_in) && aligned16(qkv) &&
                  aligned16(gate);
  if (!ok) return (int)cudaErrorInvalidValue;
  const FgArgs a{x, nullptr, w_in, static_cast<const float*>(bg), nullptr, nullptr, qkv,
                 static_cast<float*>(gate), nullptr, R1, R2, N, D, 1, HC, scale, s1, s2, sn};
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)project<float>(a, s, wide != 0);
  return (int)project<bf16>(a, s, wide != 0);
}

}  // extern "C"
