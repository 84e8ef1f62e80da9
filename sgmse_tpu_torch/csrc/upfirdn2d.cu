// K1: upfirdn2d, FIR resampling on channels_last activations.
//
// Replaces the XLA depthwise convolution of sgmse_tpu/ops/upfirdn2d.py:84-139
// (`upfirdn2d` and `_upfirdn_separable`, reached through upsample_2d and
// downsample_2d at :155-172), which the score network calls 36 times per
// evaluation: on h and the skip x of each up/down res-block and in the input
// and output pyramids.
//
// Semantics: zero-stuff by `up`, pad by (pad0, pad1) on both spatial axes
// (negative crops), correlate with the flipped FIR kernel, keep every
// `down`-th sample. out = (in*up + pad0 + pad1 - k) / down + 1.
//
// Bound on the H100: bytes. A 4x4 FIR does at most 16 multiply-adds per output
// element (4 after upsampling, where three taps in four land on stuffed zeros),
// far below the ~300 flop/byte the card needs before compute is the limit. So
// the design moves each byte once: a thread owns four neighbouring channels of
// one output pixel (one 16-byte float32 or 8-byte bfloat16 load per tap,
// neighbouring threads on neighbouring addresses), the zero-stuffing is index
// arithmetic (a tap whose source row or column is a stuffed zero is skipped,
// nothing is materialised), the taps travel in the launch parameters, and the
// input rows a block touches stay in L2 between the taps.
#include "vec4.cuh"

namespace {

constexpr int kMaxTaps = 4;

struct Taps {
  float k[kMaxTaps * kMaxTaps];  // flipped FIR, row-major kh x kw
};

template <typename T>
__global__ void upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y, const Taps taps,
                                 int B, int H, int W, int C, int OH, int OW, int up, int down,
                                 int pad0, int kh, int kw) {
  const int cv = C / 4;
  const int total = B * OH * OW * cv;
  const int up_h = H * up, up_w = W * up;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int c4 = i % cv;
    int p = i / cv;
    const int ox = p % OW;
    p /= OW;
    const int oy = p % OH;
    const int b = p / OH;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ky = 0; ky < kh; ++ky) {
      const int uy = oy * down + ky - pad0;  // row in the zero-stuffed signal
      if (uy < 0 || uy >= up_h || uy % up != 0) continue;
      const int iy = uy / up;
      for (int kx = 0; kx < kw; ++kx) {
        const int ux = ox * down + kx - pad0;
        if (ux < 0 || ux >= up_w || ux % up != 0) continue;
        const int ix = ux / up;
        float v[4];
        Vec4<T>::load(x + ((b * H + iy) * W + ix) * C + c4 * 4, v);
        const float w = taps.k[ky * kw + kx];
        acc[0] += w * v[0];
        acc[1] += w * v[1];
        acc[2] += w * v[2];
        acc[3] += w * v[3];
      }
    }
    Vec4<T>::store(y + ((b * OH + oy) * OW + ox) * C + c4 * 4, acc);
  }
}

}  // namespace

// x, y: device pointers, channels_last (B, C, H, W) / (B, C, OH, OW), dtype
// float32 (is_bf16 == 0) or bfloat16. k: HOST pointer to the kh x kw FIR as
// given (unflipped), float32. Returns cudaGetLastError() after the launch.
extern "C" int sgmse_upfirdn2d(const void* x, void* y, const float* k, int kh, int kw, int B,
                               int H, int W, int C, int OH, int OW, int up, int down, int pad0,
                               int is_bf16, void* stream) {
  if (kh < 1 || kw < 1 || kh > kMaxTaps || kw > kMaxTaps || C % 4 != 0 || up < 1 || down < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps taps;
  for (int i = 0; i < kh; ++i) {
    for (int j = 0; j < kw; ++j) taps.k[i * kw + j] = k[(kh - 1 - i) * kw + (kw - 1 - j)];
  }
  const int threads = 256;
  const int grid = grid_for(static_cast<long long>(B) * OH * OW * (C / 4), threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    upfirdn2d_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), taps, B, H, W, C,
        OH, OW, up, down, pad0, kh, kw);
  } else {
    upfirdn2d_kernel<float><<<grid, threads, 0, s>>>(static_cast<const float*>(x),
                                                     static_cast<float*>(y), taps, B, H, W, C,
                                                     OH, OW, up, down, pad0, kh, kw);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sgmse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
