// Hand-written Hopper (sm_90a) flash backward of the rows attention kernel,
// the CUDA-core body: float32, and bf16 at head widths that are not a
// multiple of 8 (bf16 otherwise takes the tensor-core body of
// attention_bwd_mma.cu). It stays callable (ops.attention.attention_body) to
// time it beside that one.
//
// Replaces the Pallas TPU kernel of protein_redesign_tpu/ops/pallas_attention.py
//
//   rows_attention_bwd  <- _rows_attention_bwd_impl / _make_rowhead_bwd_kernel
//                          (full-key backward of triangle attention)
//
// Per (row r, head h), with qt = q * scale rounded to the input type (the
// forward's pre-scaled q) and the key mask filled with -2^15:
//   P   = softmax(qt k^T)                        f32 logits and probabilities
//   dv  = round_v(P)^T dO
//   dP  = dO v^T
//   dS  = P o (dP - delta),  delta_i = sum_j dP_ij P_ij   (JAX's rowsum(dP o P))
//   dS  = 0 at masked keys, then rounded to the input type
//   dqt = dS k,   dk = dS^T qt
// with f32 accumulation and outputs in the input type. dqt is the gradient
// with respect to the pre-scaled q; the wrapper multiplies it by the scale.
// A fully masked row has uniform P, so it feeds dv, while its dS (and with it
// dqt and dk) is zero, as autodiff of the reference's `where` gives.
//
// delta is rowsum(dP o P), as the Pallas kernel computes it (:821), and not
// rowsum(dO o O): the two are equal in exact arithmetic, but O is rounded to
// the input type, so in bf16 they differ by more than the recompute costs.
//
// What bounds it on the card. The Pallas kernel holds a whole [N, N] f32
// probability block of one row in VMEM and sums dk and dv over the query
// axis inside one program. An SM holds neither [N, N] at N = 384..2048 nor
// a sum carried between blocks, which run in no order. So the backward is
// two kernels, each with one output row per thread and no cross-block sums:
//   rows_attention_bwd_dq_kernel: one query per thread; three passes over
//     32-key tiles staged in shared memory: (1) row max m and sum s of
//     exp, (2) delta, (3) dqt. Writes m, s and delta to a [3, R, H, N] f32
//     scratch for the second kernel.
//   rows_attention_bwd_dkdv_kernel: one key per thread; one pass over
//     32-query tiles (qt, dO, m, s, delta staged in shared memory)
//     accumulating dk and dv in registers.
// Both recompute each logit with the same dot-product order, so P, dP and
// delta agree bit for bit between them. Shared memory is O(32 * C) and there
// is no bound on N. A thread keeps its row's vectors in registers (3C floats
// for dq, 4C for dk/dv), which bounds this layout at C = 32. The products run
// on the CUDA cores in f32: issue-bound (FMAs plus broadcast shared-memory
// loads), about 10 FMAs of C per (query, key) pair in all.
//
// Wider heads (32 < C <= 128, the h64 layouts) take the K6 layout instead,
// the same passes and outputs: each warp holds 4 query (or key) rows with the
// lanes on the head channels, 4 C / 32 accumulators per lane and row, and
// rows staged in shared memory (O((TQ + 64) C) floats):
//   rows_attention_bwd_wide_dq_kernel: lane j of a 32-key tile computes its
//     logit and dP against the warp's 4 queries (dot_smem); passes (1) and
//     (2) reduce over the lanes, pass (3) broadcasts each dS by a shuffle
//     into the channel accumulators of dqt.
//   rows_attention_bwd_wide_dkdv_kernel: the same with the roles of queries
//     and keys swapped, reading m, s and delta from the scratch.
// The logit and dP dot products run in the same order in both kernels.
// Heads run to 1024 (CPL = C / 32 values a lane and row) on the same two
// kernels; past 512 (SHARE) a block takes 8 rows and one tile buffer, into
// which K (qt) is staged for the logits, then V (dO) for dP and dv's sums,
// then K (qt) again for the dS products, each sum in the order it has
// without SHARE; the accumulators spill at that width.
//
// Layout: q, k, v and dO are [R, N, H, C] with the head dimension contiguous
// and the other strides given in elements; mask is contiguous f32 [R, N];
// dq, dk, dv are contiguous [R, N, H, C]. The entry point returns
// cudaGetLastError() after its launches.

#include "common.cuh"

namespace {

constexpr int kTile = 32;     // keys (dq kernel) or queries (dk/dv kernel) per staged tile
constexpr int kThreads = 64;  // queries (dq kernel) or keys (dk/dv kernel) per block

// sum_c a[c] * b[c] over CP channels (zero past C) in one fixed order; a in
// registers, b in 16-byte aligned shared memory.
template <int CP>
__device__ __forceinline__ float dot(const float (&a)[CP], const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < CP; c += 4) {
    const float4 bv = *reinterpret_cast<const float4*>(b + c);
    acc = fmaf(a[c], bv.x, acc);
    acc = fmaf(a[c + 1], bv.y, acc);
    acc = fmaf(a[c + 2], bv.z, acc);
    acc = fmaf(a[c + 3], bv.w, acc);
  }
  return acc;
}

// One [R, N, H, C] row vector into registers as f32 (zero past C or for a
// dead row), optionally multiplied by the scale and rounded to the input type.
template <typename T, int CP, bool SCALE>
__device__ __forceinline__ void load_row(const T* __restrict__ p, bool live, int C, float scale,
                                         float (&out)[CP]) {
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    float x = 0.f;
    if (live && c < C) {
      x = Io<T>::load(p + c);
      if (SCALE) x = Io<T>::round(x * scale);
    }
    out[c] = x;
  }
}

// kTile rows [t0, t0 + kTile) of one head of an operand into shared memory
// [kTile][CP] as f32, zero past N and past C; SCALE as in load_row.
template <typename T, int CP, bool SCALE>
__device__ __forceinline__ void stage(const T* __restrict__ base, long long stride_n, int t0,
                                      int N, int C, float scale, float* dst) {
  for (int e = threadIdx.x; e < kTile * CP; e += blockDim.x) {
    const int j = e / CP;
    const int c = e - j * CP;
    const int t = t0 + j;
    float x = 0.f;
    if (t < N && c < C) {
      x = Io<T>::load(base + t * stride_n + c);
      if (SCALE) x = Io<T>::round(x * scale);
    }
    dst[e] = x;
  }
}

// The key tile [k0, k0 + kTile) of K (and V) and its mask values into shared
// memory, between barriers.
template <typename T, int CP>
__device__ __forceinline__ void stage_keys(const T* __restrict__ k_base, long long k_sn,
                                           const T* __restrict__ v_base, long long v_sn,
                                           const float* __restrict__ mask_row, int k0, int N,
                                           int C, bool with_v, float* k_s, float* v_s,
                                           float* mask_s) {
  __syncthreads();
  stage<T, CP, false>(k_base, k_sn, k0, N, C, 1.f, k_s);
  if (with_v) stage<T, CP, false>(v_base, v_sn, k0, N, C, 1.f, v_s);
  if (threadIdx.x < kTile) {
    const int key = k0 + threadIdx.x;
    mask_s[threadIdx.x] = key < N ? mask_row[key] : 0.f;
  }
  __syncthreads();
}

// The f32 logit of this thread's query against staged key jj, with the fill
// at masked keys.
template <int CP>
__device__ __forceinline__ float masked_logit(const float (&qt)[CP], const float* k_s,
                                              const float* mask_s, int jj) {
  const float l = dot<CP>(qt, k_s + jj * CP);
  return mask_s[jj] < 0.5f ? kMaskFill : l;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* mask;
  const void* g;  // dO
  void* dq;
  void* dk;
  void* dv;
  float* stats;  // [3, R, H, N]: m, s, delta
  int R, N, H, C;
  float scale;
  Strides qs, ks, vs, gs;
  cudaStream_t stream;
};

template <typename T, int CP>
__global__ void __launch_bounds__(kThreads)
    rows_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const float* __restrict__ mask,
                                 const T* __restrict__ g, T* __restrict__ dq,
                                 float* __restrict__ stats, int R, int N, int H, int C,
                                 float scale, Strides qs, Strides ks, Strides vs, Strides gs) {
  __shared__ __align__(16) float k_s[kTile * CP];
  __shared__ __align__(16) float v_s[kTile * CP];
  __shared__ float mask_s[kTile];

  // grid.x walks (row, query tile) with the tiles of a row adjacent.
  const int tiles = (N + kThreads - 1) / kThreads;
  const int r = blockIdx.x / tiles;
  const int i = (blockIdx.x - r * tiles) * kThreads + threadIdx.x;
  const int h = blockIdx.y;
  const bool live = i < N;
  const T* k_base = k + r * ks.r + h * ks.h;
  const T* v_base = v + r * vs.r + h * vs.h;
  const float* mask_row = mask + (long long)r * N;

  float qt[CP], go[CP];
  load_row<T, CP, true>(q + r * qs.r + h * qs.h + (long long)i * qs.n, live, C, scale, qt);
  load_row<T, CP, false>(g + r * gs.r + h * gs.h + (long long)i * gs.n, live, C, 1.f, go);

  // Pass 1: row max and sum of exp.
  float m = neg_inf(), s = 0.f;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    stage_keys<T, CP>(k_base, ks.n, v_base, vs.n, mask_row, k0, N, C, false, k_s, v_s, mask_s);
    const int nk = min(kTile, N - k0);
    if (live) {
      for (int jj = 0; jj < nk; ++jj) {
        const float l = masked_logit<CP>(qt, k_s, mask_s, jj);
        if (l > m) {
          s = s * expf(m - l) + 1.f;
          m = l;
        } else {
          s += expf(l - m);
        }
      }
    }
  }

  // Pass 2: delta = sum_j dP_ij P_ij.
  float delta = 0.f;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    stage_keys<T, CP>(k_base, ks.n, v_base, vs.n, mask_row, k0, N, C, true, k_s, v_s, mask_s);
    const int nk = min(kTile, N - k0);
    if (live) {
      for (int jj = 0; jj < nk; ++jj) {
        const float p = expf(masked_logit<CP>(qt, k_s, mask_s, jj) - m) / s;
        delta = fmaf(dot<CP>(go, v_s + jj * CP), p, delta);
      }
    }
  }

  // Pass 3: dqt = dS k.
  float acc[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    stage_keys<T, CP>(k_base, ks.n, v_base, vs.n, mask_row, k0, N, C, true, k_s, v_s, mask_s);
    const int nk = min(kTile, N - k0);
    if (live) {
      for (int jj = 0; jj < nk; ++jj) {
        if (mask_s[jj] < 0.5f) continue;  // dS is zero at masked keys
        const float p = expf(masked_logit<CP>(qt, k_s, mask_s, jj) - m) / s;
        const float ds = Io<T>::round(p * (dot<CP>(go, v_s + jj * CP) - delta));
        const float* k_row = k_s + jj * CP;
#pragma unroll
        for (int c = 0; c < CP; ++c) acc[c] = fmaf(ds, k_row[c], acc[c]);
      }
    }
  }

  if (!live) return;
  T* out = dq + (((long long)r * N + i) * H + h) * C;
#pragma unroll
  for (int c = 0; c < CP; ++c)
    if (c < C) out[c] = Io<T>::cast(acc[c]);
  const long long rhn = (long long)R * H * N;
  const long long idx = ((long long)r * H + h) * N + i;
  stats[idx] = m;
  stats[rhn + idx] = s;
  stats[2 * rhn + idx] = delta;
}

template <typename T, int CP>
__global__ void __launch_bounds__(kThreads)
    rows_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const float* __restrict__ mask,
                                   const T* __restrict__ g, const float* __restrict__ stats,
                                   T* __restrict__ dk, T* __restrict__ dv, int R, int N, int H,
                                   int C, float scale, Strides qs, Strides ks, Strides vs,
                                   Strides gs) {
  __shared__ __align__(16) float q_s[kTile * CP];
  __shared__ __align__(16) float g_s[kTile * CP];
  __shared__ float m_s[kTile], s_s[kTile], d_s[kTile];

  const int tiles = (N + kThreads - 1) / kThreads;
  const int r = blockIdx.x / tiles;
  const int j = (blockIdx.x - r * tiles) * kThreads + threadIdx.x;
  const int h = blockIdx.y;
  const bool live = j < N;
  const bool masked = !live || mask[(long long)r * N + j] < 0.5f;
  const T* q_base = q + r * qs.r + h * qs.h;
  const T* g_base = g + r * gs.r + h * gs.h;
  const long long rhn = (long long)R * H * N;
  const float* m_row = stats + ((long long)r * H + h) * N;

  float kr[CP], vr[CP];
  load_row<T, CP, false>(k + r * ks.r + h * ks.h + (long long)j * ks.n, live, C, 1.f, kr);
  load_row<T, CP, false>(v + r * vs.r + h * vs.h + (long long)j * vs.n, live, C, 1.f, vr);
  float dk_acc[CP], dv_acc[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  for (int i0 = 0; i0 < N; i0 += kTile) {
    __syncthreads();
    stage<T, CP, true>(q_base, qs.n, i0, N, C, scale, q_s);
    stage<T, CP, false>(g_base, gs.n, i0, N, C, 1.f, g_s);
    if (threadIdx.x < kTile) {
      const int qi = i0 + threadIdx.x;
      const bool ok = qi < N;
      m_s[threadIdx.x] = ok ? m_row[qi] : 0.f;
      s_s[threadIdx.x] = ok ? m_row[rhn + qi] : 1.f;
      d_s[threadIdx.x] = ok ? m_row[2 * rhn + qi] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const int ni = min(kTile, N - i0);
    for (int ii = 0; ii < ni; ++ii) {
      const float* q_row = q_s + ii * CP;
      const float* g_row = g_s + ii * CP;
      const float l = masked ? kMaskFill : dot<CP>(kr, q_row);
      const float p = expf(l - m_s[ii]) / s_s[ii];
      const float pv = Io<T>::round(p);
#pragma unroll
      for (int c = 0; c < CP; ++c) dv_acc[c] = fmaf(pv, g_row[c], dv_acc[c]);
      if (!masked) {
        const float ds = Io<T>::round(p * (dot<CP>(vr, g_row) - d_s[ii]));
#pragma unroll
        for (int c = 0; c < CP; ++c) dk_acc[c] = fmaf(ds, q_row[c], dk_acc[c]);
      }
    }
  }

  if (!live) return;
  const long long off = (((long long)r * N + j) * H + h) * C;
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    if (c < C) {
      dk[off + c] = Io<T>::cast(dk_acc[c]);
      dv[off + c] = Io<T>::cast(dv_acc[c]);
    }
  }
}

constexpr int kRPW = 4;  // rows per warp in the wide kernels

// The wide layout's 4 x CPL channel accumulators of a warp (channel
// lane + 32 t) into rows first .. first + 3 of a contiguous [R, N, H, C] output.
template <typename T, int CPL>
__device__ __forceinline__ void store_rows(T* __restrict__ out, const float (&acc)[kRPW][CPL],
                                           int r, int first, int N, int H, int h, int C,
                                           int lane) {
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    const int row = first + rr;
    if (row >= N) continue;
    T* dst = out + (((long long)r * N + row) * H + h) * C;
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = lane + 32 * t;
      if (c < C) dst[c] = Io<T>::cast(acc[rr][t]);
    }
  }
}

template <typename T, int CPL, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32)
    rows_attention_bwd_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                      const T* __restrict__ v, const float* __restrict__ mask,
                                      const T* __restrict__ g, T* __restrict__ dq,
                                      float* __restrict__ stats, int R, int N, int H, int C,
                                      float scale, Strides qs, Strides ks, Strides vs,
                                      Strides gs) {
  constexpr int TQ = NWARPS * kRPW;
  constexpr bool SHARE = CPL > 16;
  extern __shared__ __align__(16) float smem[];
  const int stride = C + 4;  // padded K/V rows: conflict-free float4 reads by lane
  float* q_s = smem;                                // [TQ][C]
  float* g_s = q_s + TQ * C;                        // [TQ][C]
  float* k_s = g_s + TQ * C;                        // [kTile][C + 4]
  float* v_s = SHARE ? k_s : k_s + kTile * stride;  // [kTile][C + 4]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles = (N + TQ - 1) / TQ;
  const int r = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - r * tiles) * TQ;
  const int h = blockIdx.y;
  const T* k_base = k + r * ks.r + h * ks.h;
  const T* v_base = v + r * vs.r + h * vs.h;
  const float* mask_row = mask + (long long)r * N;

  stage_rows<T, true>(q + r * qs.r + h * qs.h, qs.n, q0, TQ, N, C, scale, q_s, C);
  stage_rows<T, false>(g + r * gs.r + h * gs.h, gs.n, q0, TQ, N, C, 1.f, g_s, C);

  const int row0 = warp * kRPW;
  float m[kRPW], s[kRPW];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    m[rr] = neg_inf();
    s[rr] = 0.f;
  }

  // Pass 1: per-lane running max and sum of exp, then combined over the lanes.
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    stage_rows<T, false>(k_base, ks.n, k0, kTile, N, C, 1.f, k_s, stride);
    __syncthreads();
    const int j = k0 + lane;
    if (j < N) {
      const bool masked = mask_row[j] < 0.5f;
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr) {
        const float l = masked ? kMaskFill
                               : dot_smem(q_s + (row0 + rr) * C, k_s + lane * stride, C);
        if (l > m[rr]) {
          s[rr] = s[rr] * expf(m[rr] - l) + 1.f;
          m[rr] = l;
        } else {
          s[rr] += expf(l - m[rr]);
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(kFull, m[rr], off);
      const float so = __shfl_xor_sync(kFull, s[rr], off);
      const float mn = fmaxf(m[rr], mo);
      const float a = m[rr] == neg_inf() ? 0.f : s[rr] * expf(m[rr] - mn);
      const float b = mo == neg_inf() ? 0.f : so * expf(mo - mn);
      m[rr] = mn;
      s[rr] = a + b;
    }
  }

  // Pass 2: delta = sum_j dP_ij P_ij, over the lanes.
  float delta[kRPW];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) delta[rr] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    stage_rows<T, false>(k_base, ks.n, k0, kTile, N, C, 1.f, k_s, stride);
    if constexpr (!SHARE) stage_rows<T, false>(v_base, vs.n, k0, kTile, N, C, 1.f, v_s, stride);
    __syncthreads();
    const int j = k0 + lane;
    float p[kRPW];
    if (j < N) {
      const bool masked = mask_row[j] < 0.5f;
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr) {
        const float l = masked ? kMaskFill
                               : dot_smem(q_s + (row0 + rr) * C, k_s + lane * stride, C);
        p[rr] = expf(l - m[rr]) / s[rr];
      }
    }
    if constexpr (SHARE) {
      __syncthreads();  // every warp's logits have read K's tile
      stage_rows<T, false>(v_base, vs.n, k0, kTile, N, C, 1.f, v_s, stride);
      __syncthreads();
    }
    if (j < N) {
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr)
        delta[rr] =
            fmaf(dot_smem(g_s + (row0 + rr) * C, v_s + lane * stride, C), p[rr], delta[rr]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) delta[rr] = warp_sum(delta[rr]);

  // Pass 3: dqt = dS k, dS broadcast from the key's lane.
  float acc[kRPW][CPL];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr)
#pragma unroll
    for (int t = 0; t < CPL; ++t) acc[rr][t] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kTile) {
    __syncthreads();
    stage_rows<T, false>(k_base, ks.n, k0, kTile, N, C, 1.f, k_s, stride);
    if constexpr (!SHARE) stage_rows<T, false>(v_base, vs.n, k0, kTile, N, C, 1.f, v_s, stride);
    __syncthreads();
    const int j = k0 + lane;
    const bool keep = j < N && mask_row[j] >= 0.5f;  // dS is zero at masked keys
    float p[kRPW], ds[kRPW];
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      p[rr] = 0.f;
      if (keep) {
        const float l = dot_smem(q_s + (row0 + rr) * C, k_s + lane * stride, C);
        p[rr] = expf(l - m[rr]) / s[rr];
      }
    }
    if constexpr (SHARE) {
      __syncthreads();  // every warp's logits have read K's tile
      stage_rows<T, false>(v_base, vs.n, k0, kTile, N, C, 1.f, v_s, stride);
      __syncthreads();
    }
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      ds[rr] = 0.f;
      if (keep) {
        const float dp = dot_smem(g_s + (row0 + rr) * C, v_s + lane * stride, C);
        ds[rr] = Io<T>::round(p[rr] * (dp - delta[rr]));
      }
    }
    if constexpr (SHARE) {
      __syncthreads();  // every warp's dP has read V's tile
      stage_rows<T, false>(k_base, ks.n, k0, kTile, N, C, 1.f, k_s, stride);
      __syncthreads();
    }
    const int nk = min(kTile, N - k0);
    for (int jj = 0; jj < nk; ++jj) {
      const float* k_row = k_s + jj * stride;
      float kv[CPL];
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        const int c = lane + 32 * t;
        kv[t] = c < C ? k_row[c] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr) {
        const float d = __shfl_sync(kFull, ds[rr], jj);
#pragma unroll
        for (int t = 0; t < CPL; ++t) acc[rr][t] = fmaf(d, kv[t], acc[rr][t]);
      }
    }
  }
  store_rows<T, CPL>(dq, acc, r, q0 + row0, N, H, h, C, lane);
  if (lane == 0) {
    const long long rhn = (long long)R * H * N;
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      const int qi = q0 + row0 + rr;
      if (qi >= N) continue;
      const long long idx = ((long long)r * H + h) * N + qi;
      stats[idx] = m[rr];
      stats[rhn + idx] = s[rr];
      stats[2 * rhn + idx] = delta[rr];
    }
  }
}

template <typename T, int CPL, int NWARPS>
__global__ void __launch_bounds__(NWARPS * 32)
    rows_attention_bwd_wide_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v, const float* __restrict__ mask,
                                        const T* __restrict__ g, const float* __restrict__ stats,
                                        T* __restrict__ dk, T* __restrict__ dv, int R, int N,
                                        int H, int C, float scale, Strides qs, Strides ks,
                                        Strides vs, Strides gs) {
  constexpr int TK = NWARPS * kRPW;
  constexpr bool SHARE = CPL > 16;
  extern __shared__ __align__(16) float smem[];
  const int stride = C + 4;  // padded q/dO rows: conflict-free float4 reads by lane
  float* k_s = smem;                                // [TK][C]
  float* v_s = k_s + TK * C;                        // [TK][C]
  float* q_s = v_s + TK * C;                        // [kTile][C + 4]
  float* g_s = SHARE ? q_s : q_s + kTile * stride;  // [kTile][C + 4]
  float* m_s = g_s + kTile * stride;  // [kTile]
  float* s_s = m_s + kTile;           // [kTile]
  float* d_s = s_s + kTile;           // [kTile]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles = (N + TK - 1) / TK;
  const int r = blockIdx.x / tiles;
  const int j0 = (blockIdx.x - r * tiles) * TK;
  const int h = blockIdx.y;
  const T* q_base = q + r * qs.r + h * qs.h;
  const T* g_base = g + r * gs.r + h * gs.h;
  const long long rhn = (long long)R * H * N;
  const float* m_row = stats + ((long long)r * H + h) * N;

  stage_rows<T, false>(k + r * ks.r + h * ks.h, ks.n, j0, TK, N, C, 1.f, k_s, C);
  stage_rows<T, false>(v + r * vs.r + h * vs.h, vs.n, j0, TK, N, C, 1.f, v_s, C);

  const int row0 = warp * kRPW;
  bool masked[kRPW];
  float dkr[kRPW][CPL], dvr[kRPW][CPL];
#pragma unroll
  for (int rr = 0; rr < kRPW; ++rr) {
    const int j = j0 + row0 + rr;
    masked[rr] = j >= N || mask[(long long)r * N + j] < 0.5f;
#pragma unroll
    for (int t = 0; t < CPL; ++t) dkr[rr][t] = dvr[rr][t] = 0.f;
  }

  for (int i0 = 0; i0 < N; i0 += kTile) {
    __syncthreads();
    stage_rows<T, true>(q_base, qs.n, i0, kTile, N, C, scale, q_s, stride);
    if constexpr (!SHARE) stage_rows<T, false>(g_base, gs.n, i0, kTile, N, C, 1.f, g_s, stride);
    if (threadIdx.x < kTile) {
      const int qi = i0 + threadIdx.x;
      const bool ok = qi < N;
      m_s[threadIdx.x] = ok ? m_row[qi] : 0.f;
      s_s[threadIdx.x] = ok ? m_row[rhn + qi] : 1.f;
      d_s[threadIdx.x] = ok ? m_row[2 * rhn + qi] : 0.f;
    }
    __syncthreads();
    const bool live = i0 + lane < N;
    const float* q_row = q_s + lane * stride;
    const float* g_row = g_s + lane * stride;
    float p[kRPW], pv[kRPW], ds[kRPW];
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      p[rr] = pv[rr] = ds[rr] = 0.f;
      if (!live) continue;
      const float l = masked[rr] ? kMaskFill : dot_smem(q_row, k_s + (row0 + rr) * C, C);
      p[rr] = expf(l - m_s[lane]) / s_s[lane];
      pv[rr] = Io<T>::round(p[rr]);
    }
    if constexpr (SHARE) {
      __syncthreads();  // every warp's logits have read qt's tile
      stage_rows<T, false>(g_base, gs.n, i0, kTile, N, C, 1.f, g_s, stride);
      __syncthreads();
    }
#pragma unroll
    for (int rr = 0; rr < kRPW; ++rr) {
      if (live && !masked[rr]) {
        const float dp = dot_smem(g_row, v_s + (row0 + rr) * C, C);
        ds[rr] = Io<T>::round(p[rr] * (dp - d_s[lane]));
      }
    }
    const int ni = min(kTile, N - i0);
    if constexpr (SHARE) {
      sum_tile<kRPW, CPL>(dvr, pv, g_s, stride, ni, C, lane);
      __syncthreads();  // every warp's sums have read dO's tile
      stage_rows<T, true>(q_base, qs.n, i0, kTile, N, C, scale, q_s, stride);
      __syncthreads();
      sum_tile<kRPW, CPL>(dkr, ds, q_s, stride, ni, C, lane);
      continue;
    }
    for (int ii = 0; ii < ni; ++ii) {
      float qv[CPL], gv[CPL];
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        const int c = lane + 32 * t;
        qv[t] = c < C ? q_s[ii * stride + c] : 0.f;
        gv[t] = c < C ? g_s[ii * stride + c] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRPW; ++rr) {
        const float p = __shfl_sync(kFull, pv[rr], ii);
        const float d = __shfl_sync(kFull, ds[rr], ii);
#pragma unroll
        for (int t = 0; t < CPL; ++t) {
          dvr[rr][t] = fmaf(p, gv[t], dvr[rr][t]);
          dkr[rr][t] = fmaf(d, qv[t], dkr[rr][t]);
        }
      }
    }
  }
  store_rows<T, CPL>(dk, dkr, r, j0 + row0, N, H, h, C, lane);
  store_rows<T, CPL>(dv, dvr, r, j0 + row0, N, H, h, C, lane);
}

template <typename Kernel, typename... Params>
cudaError_t launch_wide_one(Kernel kern, int rows_per_block, size_t smem, int threads,
                            const Args& a, Params... params) {
  const long long blocks = (long long)((a.N + rows_per_block - 1) / rows_per_block) * a.R;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3((unsigned)blocks, a.H), threads, smem, a.stream>>>(params...);
  return cudaGetLastError();
}

// The wide layout (32 < C <= 1024): 4 x CPL accumulators per lane and row.
template <typename T, int CPL>
cudaError_t launch_wide(const Args& a) {
  constexpr int NWARPS = CPL <= 2 ? 8 : (CPL > 16 ? 2 : 4);
  constexpr int ROWS = NWARPS * kRPW;
  constexpr int TILES = CPL > 16 ? 1 : 2;  // SHARE: one tile buffer
  const size_t smem =
      sizeof(float) * (size_t)(2 * ROWS * a.C + TILES * kTile * (a.C + 4) + 3 * kTile);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.g);
  const cudaError_t e = launch_wide_one(
      rows_attention_bwd_wide_dq_kernel<T, CPL, NWARPS>, ROWS, smem, NWARPS * 32, a, q, k, v,
      a.mask, g, static_cast<T*>(a.dq), a.stats, a.R, a.N, a.H, a.C, a.scale, a.qs, a.ks, a.vs,
      a.gs);
  if (e != cudaSuccess) return e;
  return launch_wide_one(rows_attention_bwd_wide_dkdv_kernel<T, CPL, NWARPS>, ROWS, smem,
                         NWARPS * 32, a, q, k, v, a.mask, g, (const float*)a.stats,
                         static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.R, a.N, a.H, a.C,
                         a.scale, a.qs, a.ks, a.vs, a.gs);
}

template <typename T, int CP>
cudaError_t launch(const Args& a) {
  const long long blocks = (long long)((a.N + kThreads - 1) / kThreads) * a.R;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, a.H);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.g);
  rows_attention_bwd_dq_kernel<T, CP><<<grid, kThreads, 0, a.stream>>>(
      q, k, v, a.mask, g, static_cast<T*>(a.dq), a.stats, a.R, a.N, a.H, a.C, a.scale, a.qs,
      a.ks, a.vs, a.gs);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  rows_attention_bwd_dkdv_kernel<T, CP><<<grid, kThreads, 0, a.stream>>>(
      q, k, v, a.mask, g, a.stats, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.R, a.N, a.H,
      a.C, a.scale, a.qs, a.ks, a.vs, a.gs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_width(const Args& a) {
  if (a.C <= 16) return launch<T, 16>(a);
  if (a.C <= 32) return launch<T, 32>(a);
  if (a.C <= 64) return launch_wide<T, 2>(a);
  if (a.C <= 128) return launch_wide<T, 4>(a);
  if (a.C <= 256) return launch_wide<T, 8>(a);
  if (a.C <= 512) return launch_wide<T, 16>(a);
  return launch_wide<T, 32>(a);
}

}  // namespace

extern "C" {

// K7: dq (w.r.t. the pre-scaled q), dk and dv of rows attention, C up to 1024
// (a multiple of 4 above 32). stats is caller-allocated f32 scratch of
// 3 * R * H * N values.
int prd_rows_attention_bwd(const void* q, const void* k, const void* v, const void* mask,
                           const void* dout, void* dq, void* dk, void* dv, void* stats, int dtype,
                           int R, int N, int H, int C, float scale, long long q_sr,
                           long long q_sn, long long q_sh, long long k_sr, long long k_sn,
                           long long k_sh, long long v_sr, long long v_sn, long long v_sh,
                           long long g_sr, long long g_sn, long long g_sh, void* stream) {
  const Args a{q, k, v, static_cast<const float*>(mask), dout, dq, dk, dv,
               static_cast<float*>(stats), R, N, H, C, scale,
               {q_sr, q_sn, q_sh}, {k_sr, k_sn, k_sh}, {v_sr, v_sn, v_sh}, {g_sr, g_sn, g_sh},
               static_cast<cudaStream_t>(stream)};
  const bool ok = (dtype == 0 || dtype == 1) && R > 0 && N > 0 && H > 0 && H <= 65535 &&
                  C > 0 && C <= 1024 && (C <= 32 || C % 4 == 0) && mask != nullptr &&
                  stats != nullptr;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_width<float>(a);
  return (int)dispatch_width<__nv_bfloat16>(a);
}

}  // extern "C"
