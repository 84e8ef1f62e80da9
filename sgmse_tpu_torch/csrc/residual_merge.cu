// K8: the merge of a block's residual branch h with its skip, together with the
// biases of the convolutions that computed the two, in one launch on
// channels_last activations, written over h:
//
//     h[p, c] = ((skip[p, c] + skip_bias[c]) + (h[p, c] + bias[c])) * scale
//
// Replaces XLA's fusion, in the JAX package, of the epilogue after a block's
// last convolutions: the bias of Conv_1, the shortcut Conv_2 or NIN_0 with its
// bias, and the `(x + h) / sqrt(2)` merge of the res-blocks
// (sgmse_tpu/models/blocks.py:423-431, :368-377), NIN_3's bias and the merge
// of the attention block (:244-248), Combine's Conv_0 bias and its sum
// (:211-216), and the residual pyramids' merges (sgmse_tpu/models/ncsnpp.py:190,
// :254). The convolutions run in cuDNN without their biases; eager PyTorch
// would add each bias in a broadcast pass of its own (the non-vectorised
// elementwise kernel: the bias is not contiguous with the output), then the
// sum and the scale in two more.
//
// Arithmetic: float32 inside (the biases are the float32 parameters; a bias
// not given is 0), one rounding to the tensor's dtype at the end. The scale is
// 1/sqrt(2) or 1.
//
// Bound on the H100: bytes. A handful of flops per element against three
// passes, the least there is: one read of skip, one read of h, one write over
// h. The design: every thread owns one 16-byte vector of channels (8 bfloat16
// or 4 float32) and walks pixels; a block holds whole pixels (threads / lanes
// of them, lanes = C / 8 or C / 4) and the grid's stride is whole pixels, so
// a thread's channels never change and it reads its biases once, into
// registers. kUnroll pixels of both inputs are in flight per thread; the grid
// is capped at kBlocksPerSm blocks an SM, each walking several pixels. Any
// other channel count (not a multiple of the vector, or more than 256 vectors
// a pixel) or a pointer off 16 bytes takes the general path: one element per
// thread, its channel by division, the same arithmetic.
#include <algorithm>

#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSm = 8;

struct MergeArgs {
  const uint4* skip;
  uint4* h;
  const float* bias;       // (C,) or null
  const float* skip_bias;  // (C,) or null
  long long pixels;
  int lanes;  // 16-byte vectors per pixel
  int rows;   // pixels per block
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) residual_merge_kernel(const MergeArgs a) {
  using V = Vec16<T>;
  constexpr int N = V::N;
  const int lane = threadIdx.x % a.lanes;
  const int row = threadIdx.x / a.lanes;
  if (row >= a.rows) return;
  float bh[N], bs[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int c = lane * N + k;
    bh[k] = a.bias ? a.bias[c] : 0.f;
    bs[k] = a.skip_bias ? a.skip_bias[c] : 0.f;
  }
  const long long step = static_cast<long long>(gridDim.x) * a.rows;
  for (long long p = static_cast<long long>(blockIdx.x) * a.rows + row; p < a.pixels;
       p += kUnroll * step) {
    uint4 rs[kUnroll], rh[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + u * step;
      if (q < a.pixels) {
        const size_t i = static_cast<size_t>(q) * a.lanes + lane;
        rs[u] = __ldg(a.skip + i);
        rh[u] = a.h[i];  // written below: not through the read-only path
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + u * step;
      if (q < a.pixels) {
        float vs[N], vh[N];
        V::unpack(rs[u], vs);
        V::unpack(rh[u], vh);
#pragma unroll
        for (int k = 0; k < N; ++k) vh[k] = ((vs[k] + bs[k]) + (vh[k] + bh[k])) * a.scale;
        a.h[static_cast<size_t>(q) * a.lanes + lane] = V::pack(vh);
      }
    }
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void narrow(float v, float* out) { *out = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// The general path: any C, any alignment of the element type.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    residual_merge_kernel_any(const T* __restrict__ skip, T* h, const float* bias,
                              const float* skip_bias, long long n, int C, float scale) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += step) {
    const int c = static_cast<int>(i % C);
    const float bs = skip_bias ? skip_bias[c] : 0.f;
    const float bh = bias ? bias[c] : 0.f;
    narrow(((widen(skip[i]) + bs) + (widen(h[i]) + bh)) * scale, h + i);
  }
}

int blocks_cap() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms * kBlocksPerSm;
}

template <typename T>
cudaError_t launch_any(const void* skip, void* h, const float* bias, const float* skip_bias,
                       long long pixels, int C, float scale, void* stream) {
  const long long n = pixels * C;
  const long long blocks = std::min<long long>((n + kThreads - 1) / kThreads, blocks_cap());
  residual_merge_kernel_any<T><<<static_cast<int>(std::max(1LL, blocks)), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(skip), static_cast<T*>(h), bias, skip_bias, n, C, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(MergeArgs a, void* stream) {
  a.rows = kThreads / a.lanes;
  const long long per_block = static_cast<long long>(a.rows) * kUnroll;
  const long long blocks = std::min<long long>((a.pixels + per_block - 1) / per_block,
                                               blocks_cap());
  residual_merge_kernel<T><<<static_cast<int>(std::max(1LL, blocks)), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // namespace

// skip, h: device pointers, channels_last (pixels, C) of one dtype, float32
// (is_bf16 == 0) or bfloat16, aligned to it, not overlapping; h is overwritten
// with the result. bias, skip_bias: float32 (C,), or null. The vector
// path where C is a multiple of 8 (bfloat16) or 4 (float32) with at most 256
// vectors of 16 bytes a pixel and both pointers are 16-byte aligned, the
// general path otherwise. Returns the launch's error code.
extern "C" int sgmse_residual_merge(const void* skip, void* h, const float* bias,
                                    const float* skip_bias, long long pixels, int C, float scale,
                                    int is_bf16, void* stream) {
  if (pixels < 0 || C < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (pixels == 0 || C == 0) return 0;
  const int n = is_bf16 ? 8 : 4;
  const bool aligned =
      (reinterpret_cast<uintptr_t>(skip) | reinterpret_cast<uintptr_t>(h)) % 16 == 0;
  cudaError_t err;
  if (aligned && C % n == 0 && C / n <= kThreads) {
    MergeArgs a{static_cast<const uint4*>(skip), static_cast<uint4*>(h), bias, skip_bias,
                pixels, C / n, 0, scale};
    err = is_bf16 ? launch<__nv_bfloat16>(a, stream) : launch<float>(a, stream);
  } else {
    err = is_bf16 ? launch_any<__nv_bfloat16>(skip, h, bias, skip_bias, pixels, C, scale, stream)
                  : launch_any<float>(skip, h, bias, skip_bias, pixels, C, scale, stream);
  }
  return static_cast<int>(err);
}
