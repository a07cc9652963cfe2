// Hand-written Hopper (sm_90a) flash backward of the rows attention kernel.
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
// for dq, 4C for dk/dv), which bounds C at 32. The products run on the CUDA
// cores in f32: issue-bound (FMAs plus broadcast shared-memory loads), about
// 10 FMAs of C per (query, key) pair in all; tensor cores are later work.
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
  return launch<T, 32>(a);
}

}  // namespace

extern "C" {

// K7: dq (w.r.t. the pre-scaled q), dk and dv of rows attention. stats is
// caller-allocated f32 scratch of 3 * R * H * N values.
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
                  C > 0 && C <= 32 && mask != nullptr && stats != nullptr;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)dispatch_width<float>(a);
  return (int)dispatch_width<__nv_bfloat16>(a);
}

}  // extern "C"
