// Helpers shared by the attention kernels (attention.cu, attention_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kMaskFill = -32768.0f;  // -2^15, the reference's padding fill
constexpr unsigned kFull = 0xffffffffu;

// Element strides of an [R, N, H, C] operand (the head dimension is contiguous).
struct Strides {
  long long r, n, h;
};

// Loads in f32, rounding to the input type, and the output cast.
template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float cast(float x) { return x; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 cast(float x) {
    return __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

}  // namespace
