// Four-channel vector loads and stores shared by the port's kernels.
//
// Both kernels read channels_last (NHWC) activations, where the channels of one
// pixel are contiguous. A thread moves four neighbouring channels at a time:
// 16 bytes in float32 and 8 bytes in bfloat16. Arithmetic is always float32;
// bfloat16 is rounded to nearest-even once, on the store.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  __device__ __forceinline__ static void load(const float* p, float v[4]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ __forceinline__ static void store(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec4<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float v[4]) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 a, b;
    memcpy(&a, &r.x, sizeof(a));
    memcpy(&b, &r.y, sizeof(b));
    const float2 fa = __bfloat1622float2(a);
    const float2 fb = __bfloat1622float2(b);
    v[0] = fa.x;
    v[1] = fa.y;
    v[2] = fb.x;
    v[3] = fb.y;
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float v[4]) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 r;
    memcpy(&r.x, &a, sizeof(a));
    memcpy(&r.y, &b, sizeof(b));
    *reinterpret_cast<uint2*>(p) = r;
  }
};

// Grid size for a grid-stride loop over `work` items with `threads` per block:
// enough blocks to fill every SM several times over, never more than the work.
inline int grid_for(long long work, int threads) {
  const long long blocks = (work + threads - 1) / threads;
  const long long cap = 132LL * 16;
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}
