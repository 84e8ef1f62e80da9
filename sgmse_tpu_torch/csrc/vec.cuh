// Vector loads and stores shared by the port's kernels.
//
// Both kernels read channels_last (NHWC) activations, where the channels of one
// pixel are contiguous. Arithmetic is always float32; bfloat16 is widened
// exactly on the load and rounded to nearest-even once, on the store.
//
// Vec16<T> moves one 16-byte vector: 4 float32 or 8 bfloat16 channels.
// Vec4<T> moves four channels (16 bytes in float32, 8 in bfloat16); the
// resampling kernel's simple path uses it where C is not a multiple of 8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float v[N]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float v[N]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  // A bfloat16 is the upper half of a float32: widening is a shift.
  __device__ __forceinline__ static void unpack(const uint4& r, float v[N]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float v[N]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      memcpy(&w[i], &h, sizeof(h));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

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
    v[0] = __uint_as_float(r.x << 16);
    v[1] = __uint_as_float(r.x & 0xffff0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xffff0000u);
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

// 16-byte asynchronous copy from device to shared memory (cp.async, cache in
// L2 only). With src_bytes = 0 it reads nothing and writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

// Wait until this thread's cp.async copies have landed (visible to this thread).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Close the group of this thread's cp.async copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `n` of this thread's committed groups are still in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// The largest dynamic shared memory a block of this device may opt into, with
// the error of opting `kernel` into it (needed above 48 KB). Each launcher
// keeps it in a function-local static,
//     static const SmemOptIn smem = opt_in_dynamic_smem(kernel);
// which C++11 initialises once, under a lock: a thread that reaches the static
// while another one initialises it waits, so no launch reads the limit before
// cudaFuncSetAttribute has succeeded or failed. A failure is kept, and every
// later launch of that kernel returns it.
struct SmemOptIn {
  cudaError_t err;
  int limit;  // 0 unless err is cudaSuccess
};

template <typename Kernel>
SmemOptIn opt_in_dynamic_smem(Kernel kernel) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  }
  return SmemOptIn{err, err == cudaSuccess ? limit : 0};
}
