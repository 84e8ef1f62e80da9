// K1: upfirdn2d, FIR resampling on channels_last activations, for one tensor or
// a pair of tensors of the same shape in one launch.
//
// Replaces the XLA depthwise convolution of sgmse_tpu/ops/upfirdn2d.py:84-139
// (`upfirdn2d` and `_upfirdn_separable`, reached through upsample_2d and
// downsample_2d at :155-172), which the score network calls 36 times per
// evaluation: on h and the skip x of each of the 12 up/down res-blocks (one
// launch per pair here, so 12) and 12 times in the input and output pyramids
// (C = 4): 24 launches.
//
// Semantics: zero-stuff by `up`, pad by (pad0, pad1) on both spatial axes
// (negative crops), correlate with the flipped FIR kernel, keep every
// `down`-th sample. out = (in*up + pad0 + pad1 - k) / down + 1.
//
// Bound on the H100: bytes. A 4x4 FIR does at most 16 multiply-adds per output
// element (4 after upsampling), far below the ~300 flop/byte the card needs
// before compute is the limit. So the design reads each input byte from device
// memory about once and keeps the reuse on chip:
//   - A block owns an 8x16 tile of output pixels (16x16 when upsampling), a slice of 128 bytes of
//     channels (64 bfloat16 or 32 float32) and one tensor of the pair
//     (blockIdx.z). It copies the input tile with its halo into shared memory
//     once, with 16-byte cp.async copies whose source size is 0 outside the
//     image: the padding is zero-filled by the copy itself. Each input pixel is
//     fetched once per tile instead of once per tap (4-16 times).
//   - Threads then compute from shared memory, one output pixel x 16 bytes of
//     channels each, and store 16 bytes: neighbouring threads on neighbouring
//     channels, then neighbouring pixels, in global and in shared memory.
//   - Polyphase: for output row oy only the taps ky = (pad0 - oy*down) mod up,
//     +up, ... land on real samples of the zero-stuffed signal, so an upsampling
//     output loops over its own 2x2 taps and no iteration meets a stuffed zero.
//     The same loop with up = 1 is the plain 4x4 correlation of downsampling.
//     The FIR is taken as a general 4x4 (not assumed separable); the taps travel
//     in the launch parameters. up and down are template parameters, so the
//     tap and index arithmetic has no divides.
//   - Tensors whose C is not a multiple of the 16-byte vector (the C = 4
//     pyramids in bfloat16, <= 2 MB per call) take a simple path: one thread
//     per four channels of an output pixel, reading through L1/L2.
#include "vec.cuh"

namespace {

constexpr int kMaxTaps = 4;
constexpr int kTileW = 16;
constexpr int kSliceVecs = 8;  // 16-byte vectors per channel slice: 128 bytes
constexpr int kThreads = 256;

struct Taps {
  float k[kMaxTaps * kMaxTaps];  // flipped FIR, row-major with stride kMaxTaps
};

struct Pair {
  const void* x[2];
  void* y[2];
};

struct Shape {
  int B, H, W, C, OH, OW, pad0, kh, kw;
};

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Output rows per tile: upsampling reads a quarter of an input pixel per
// output, so its tiles are taller to amortise the halo and the block.
template <int UP>
__host__ __device__ constexpr int tile_h() {
  return UP == 2 ? 16 : 8;
}

template <typename T, int UP, int DOWN>
__global__ void __launch_bounds__(kThreads) upfirdn2d_tile_kernel(
    const __grid_constant__ Pair io, const __grid_constant__ Taps taps, const Shape s, int tiles_w,
    int in_rows, int in_cols) {
  using V = Vec16<T>;
  constexpr int N = V::N;
  extern __shared__ uint4 tile[];  // in_rows x in_cols x nv vectors
  const int cv = s.C / N;
  const int v0 = blockIdx.y * kSliceVecs;
  const int nv = min(kSliceVecs, cv - v0);
  const int t = blockIdx.z / s.B;
  const int b = blockIdx.z % s.B;
  const int oy0 = (blockIdx.x / tiles_w) * tile_h<UP>();
  const int ox0 = (blockIdx.x % tiles_w) * kTileW;
  const int iy0 = floor_div(oy0 * DOWN - s.pad0, UP);  // first input row of the tile
  const int ix0 = floor_div(ox0 * DOWN - s.pad0, UP);

  const uint4* x =
      static_cast<const uint4*>(io.x[t]) + static_cast<size_t>(b) * s.H * s.W * cv + v0;
  const int n_in = in_rows * in_cols * nv;
  for (int i = threadIdx.x; i < n_in; i += kThreads) {
    const int v = i % nv;
    const int px = i / nv;
    const int iy = iy0 + px / in_cols;
    const int ix = ix0 + px % in_cols;
    const bool inside = iy >= 0 && iy < s.H && ix >= 0 && ix < s.W;
    cp_async16(&tile[i], inside ? x + (static_cast<size_t>(iy) * s.W + ix) * cv + v : x,
               inside ? 16 : 0);
  }
  cp_async_wait_all();
  __syncthreads();

  uint4* y = static_cast<uint4*>(io.y[t]) + static_cast<size_t>(b) * s.OH * s.OW * cv + v0;
  for (int i = threadIdx.x; i < tile_h<UP>() * kTileW * nv; i += kThreads) {
    const int v = i % nv;
    const int px = i / nv;
    const int oy = oy0 + px / kTileW;
    const int ox = ox0 + px % kTileW;
    if (oy >= s.OH || ox >= s.OW) continue;
    const int uy = oy * DOWN - s.pad0;  // tap ky reads stuffed row uy + ky
    const int ux = ox * DOWN - s.pad0;
    const int ky0 = ((-uy) % UP + UP) % UP;
    const int kx0 = ((-ux) % UP + UP) % UP;
    float acc[N];
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = 0.f;
    for (int ky = ky0; ky < s.kh; ky += UP) {
      const int r = (uy + ky) / UP - iy0;  // exact: uy + ky is a multiple of UP
      for (int kx = kx0; kx < s.kw; kx += UP) {
        const int c = (ux + kx) / UP - ix0;
        float in[N];
        V::unpack(tile[(r * in_cols + c) * nv + v], in);
        const float w = taps.k[ky * kMaxTaps + kx];
#pragma unroll
        for (int k = 0; k < N; ++k) acc[k] = fmaf(w, in[k], acc[k]);
      }
    }
    y[(static_cast<size_t>(oy) * s.OW + ox) * cv + v] = V::pack(acc);
  }
}

template <typename T>
__global__ void upfirdn2d_simple_kernel(const __grid_constant__ Pair io,
                                        const __grid_constant__ Taps taps, const Shape s, int up,
                                        int down) {
  const int cv = s.C / 4;
  const int total = s.B * s.OH * s.OW * cv;
  const int up_h = s.H * up, up_w = s.W * up;
  const T* x = static_cast<const T*>(io.x[blockIdx.y]);
  T* y = static_cast<T*>(io.y[blockIdx.y]);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int c4 = i % cv;
    int p = i / cv;
    const int ox = p % s.OW;
    p /= s.OW;
    const int oy = p % s.OH;
    const int b = p / s.OH;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ky = 0; ky < s.kh; ++ky) {
      const int uy = oy * down + ky - s.pad0;  // row in the zero-stuffed signal
      if (uy < 0 || uy >= up_h || uy % up != 0) continue;
      for (int kx = 0; kx < s.kw; ++kx) {
        const int ux = ox * down + kx - s.pad0;
        if (ux < 0 || ux >= up_w || ux % up != 0) continue;
        float v[4];
        Vec4<T>::load(
            x + ((static_cast<size_t>(b) * s.H + uy / up) * s.W + ux / up) * s.C + c4 * 4, v);
        const float w = taps.k[ky * kMaxTaps + kx];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = fmaf(w, v[k], acc[k]);
      }
    }
    Vec4<T>::store(y + ((static_cast<size_t>(b) * s.OH + oy) * s.OW + ox) * s.C + c4 * 4, acc);
  }
}

template <typename T, int UP, int DOWN>
cudaError_t launch_tiles(const Pair& io, int n, const Taps& taps, const Shape& s,
                         cudaStream_t stream) {
  static const SmemOptIn opt_in = opt_in_dynamic_smem(upfirdn2d_tile_kernel<T, UP, DOWN>);
  if (opt_in.err != cudaSuccess) return opt_in.err;
  const int in_rows = ((tile_h<UP>() - 1) * DOWN + s.kh - 1) / UP + 2;
  const int in_cols = ((kTileW - 1) * DOWN + s.kw - 1) / UP + 2;
  const int cv = s.C / Vec16<T>::N;
  const int slice_vecs = cv < kSliceVecs ? cv : kSliceVecs;
  const size_t smem = static_cast<size_t>(in_rows) * in_cols * slice_vecs * sizeof(uint4);
  const int tiles_h = (s.OH + tile_h<UP>() - 1) / tile_h<UP>();
  const int tiles_w = (s.OW + kTileW - 1) / kTileW;
  const dim3 grid(tiles_h * tiles_w, (cv + kSliceVecs - 1) / kSliceVecs, n * s.B);
  if (grid.z > 65535 || grid.y > 65535) return cudaErrorInvalidValue;
  upfirdn2d_tile_kernel<T, UP, DOWN><<<grid, kThreads, smem, stream>>>(io, taps, s, tiles_w,
                                                                        in_rows, in_cols);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const Pair& io, int n, const Taps& taps, const Shape& s, int up, int down,
                   cudaStream_t stream) {
  if (s.C % Vec16<T>::N != 0) {
    const long long work = static_cast<long long>(s.B) * s.OH * s.OW * (s.C / 4);
    const long long blocks = (work + kThreads - 1) / kThreads;
    const dim3 grid(static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16), n);
    upfirdn2d_simple_kernel<T><<<grid, kThreads, 0, stream>>>(io, taps, s, up, down);
    return cudaSuccess;
  }
  if (up == 1 && down == 1) return launch_tiles<T, 1, 1>(io, n, taps, s, stream);
  if (up == 1 && down == 2) return launch_tiles<T, 1, 2>(io, n, taps, s, stream);
  if (up == 2 && down == 1) return launch_tiles<T, 2, 1>(io, n, taps, s, stream);
  return launch_tiles<T, 2, 2>(io, n, taps, s, stream);
}

}  // namespace

// x0, x1, y0, y1: device pointers, channels_last (B, C, H, W) / (B, C, OH, OW),
// all of one dtype, float32 (is_bf16 == 0) or bfloat16, 16-byte aligned; n = 1
// (x1, y1 unused) or 2. k: HOST pointer to the kh x kw FIR as given
// (unflipped), float32, kh, kw <= 4. up, down in {1, 2}; C a multiple of 4.
// Returns the launch's error code.
extern "C" int sgmse_upfirdn2d(const void* x0, const void* x1, void* y0, void* y1, int n,
                               const float* k, int kh, int kw, int B, int H, int W, int C, int OH,
                               int OW, int up, int down, int pad0, int is_bf16, void* stream) {
  if (n < 1 || n > 2 || kh < 1 || kw < 1 || kh > kMaxTaps || kw > kMaxTaps || C % 4 != 0 ||
      up < 1 || up > 2 || down < 1 || down > 2 || B < 1 || OH < 1 || OW < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps taps = {};
  for (int i = 0; i < kh; ++i) {
    for (int j = 0; j < kw; ++j) taps.k[i * kMaxTaps + j] = k[(kh - 1 - i) * kw + (kw - 1 - j)];
  }
  const Pair io{{x0, n == 2 ? x1 : x0}, {y0, n == 2 ? y1 : y0}};
  const Shape s{B, H, W, C, OH, OW, pad0, kh, kw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(io, n, taps, s, up, down, st)
                            : launch<float>(io, n, taps, s, up, down, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

extern "C" const char* sgmse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
