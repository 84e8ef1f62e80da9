// K6: FIR resampling fused with a 3x3 convolution and its bias, on channels_last
// activations, one launch per call, for the two directions of the score
// network's FIRConv2d:
//
//   down:  y = conv3x3_stride2(FIR(x)) + bias     (conv_downsample_2d)
//   up:    y = FIR(conv_transpose3x3_stride2(x)) + bias     (upsample_conv_2d)
//
// It replaces no Pallas kernel. The JAX package writes these as an XLA
// convolution and an XLA depthwise FIR convolution (sgmse_tpu/ops/upfirdn2d.py:
// upsample_conv_2d :175-202, conv_downsample_2d :205-224), followed by
// FIRConv2d's bias add (sgmse_tpu/models/blocks.py:251-283), which XLA fuses.
// The 48 kHz net with residual pyramids calls it 12 times per evaluation (6
// down in the input pyramid, 6 up in the output pyramid).
//
// Semantics (per axis; the FIR is separable, given as its 1-D taps, already
// flipped and scaled by the host: fir[a] = k[3 - a] / sum(k), times 2 for up):
//   down: xf[i] = sum_a fir[a] x[i + a - 2]   (i = 0..H, x zero outside)
//         y[o] = sum_r w[r] xf[2o + r]        (o = 0..(H-2)/2)
//   up:   t[j] = sum_r w[r] xs[j + r - 2]     (j = 0..2H, xs = x zero-stuffed by 2)
//         y[o] = sum_a fir[a] t[o + a - 1]    (o = 0..2H-1, t zero outside)
// The intermediate (xf, t) is rounded to the tensors' dtype, as the composition
// and XLA round it; products and sums run in float32, the bias is added in
// float32 and the result is rounded once.
//
// Bound on the H100: operations. By the shapes of the 48 kHz net's 12 calls,
// the convolution's ~130 GFLOP at the bf16 tensor-core rate and the separable
// FIR's ~3 GFLOP (8 MACs an output) at the float32 rate take longer than moving the calls' inputs,
// weights and outputs once. The composition it replaces (cuDNN's convolution,
// then the FIR as a separate pass) wrote the intermediate to device memory and
// read it back (by the shapes, 58% of the bytes it moved), and took a second
// launch; folding the FIR into 6x6 weights keeps one launch but quadruples the
// tensor-core work. This kernel keeps the 3x3
// convolution's work and the intermediate on chip:
//   - The convolution is an implicit GEMM on the tensor cores with mma.sync:
//     bf16 products with float32 sums (m16n8k16); float32 inputs take TF32
//     (m16n8k8) when cuDNN may (torch.backends.cudnn.allow_tf32), else three
//     TF32 products per product (hi*hi + hi*lo + lo*hi), about float32's
//     accuracy. Rows are pixels gathered from a tile in shared memory, columns
//     output channels, the depth C_in x taps; one k-step is 8 words of
//     channels (16 bf16 or 8 float32), so both types share the fragment code.
//   - Weights come as the network holds them, channels_last (O, kh, kw, I in
//     memory), so each (tap, output channel) row of a k-step is 32 contiguous
//     bytes, copied with cp.async.
//   - down: a block of 16 warps owns 8x16 output pixels x 128 output channels
//     and a share of C_in. Per slice of one k-step of C_in, the input tile with
//     its halo (20x36 pixels) and the 9 taps' weights arrive by cp.async,
//     zero-filled outside the image, double-buffered; between one pair of
//     barriers the block filters slice s + 1 into a FIR tile (17x33, two of
//     them) and runs the 9 taps of slice s. Where the tiles are too few to
//     fill the card, a cluster of up to 8 blocks splits a tile's C_in and
//     adds up its sums through distributed shared memory; every block stores
//     whole pixels' channels.
//   - up: persistent and weight-stationary. A block of 8 warps holds the
//     weights of its 64 output channels (32 or 16 where C_in or float32 makes
//     them too large) for all taps and all of C_in, loaded once, and takes
//     (batch row, 16x16 output tile) items in turn. Per item it copies the
//     input tile, all of C_in, and computes the transposed convolution's
//     output on the tile plus a 3-pixel halo (the FIR's reach) by parity
//     class: even rows take taps 0 and 2, odd rows tap 1, so each of the four
//     classes is a dense GEMM over its own taps, with no product on a stuffed
//     zero and no barrier between its k-steps (bf16 fragments by ldmatrix).
//     The halo costs 36% more products. Each class's sums go to the tile in
//     shared memory; the FIR then runs from there (across 4 columns into
//     registers, then a sliding window of 4 rows down) while the next item's
//     input is in flight, adds the bias and writes each output once, 16 bytes
//     a thread.
//   - C_in below 16 (the input pyramid's first level, C_in = 4) takes a plain
//     CUDA-core path: the block filters its input tile into shared memory once
//     for 128 output channels, and each thread sums 8 of them at 8 pixels.
#include <cooperative_groups.h>

#include <type_traits>

#include "vec.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;     // the narrow and up paths' blocks: 8 warps
constexpr int kMmaThreads = 512;  // the down path's blocks: 16 warps
constexpr int kStepWords = 8;   // one k-step: 8 words of channels (16 bf16, 8 float32)
constexpr int kRowWords = 12;   // a k-step's row in shared memory, padded against bank conflicts
constexpr int kFirWords = 10;   // a FIR-tile pixel: stride-2 gathers hit 8 distinct bank groups
constexpr int kMaxUpMtiles = 8;  // row tiles of 16 a class of an up tile may have
// down: 8x16 output pixels, warps 4 (pixels) x 4 (channels), each 32 x 32
constexpr int kDownTH = 8, kDownTW = 16;

struct Geometry {
  int B, H, W, Cin, Cout, OH, OW;
  int th, tw, tiles_h, tiles_w;
  int ksplit;  // down: blocks of a cluster that share a tile's C_in slices
  float fir[4];
};

template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
};
template <>
struct Elem<float> {
  static constexpr int kPerWord = 1;
};

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(f));
  return r;
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-step's operand fragment, as the tensor cores take it. MODE 0: bf16
// pairs as they are; 1: TF32; 3: TF32 high and low parts.
template <int MODE, int N>
struct Frag {
  uint32_t hi[N];
  uint32_t lo[MODE == 3 ? N : 1];
  __device__ __forceinline__ void set(int i, uint32_t raw) {
    if constexpr (MODE == 0) {
      hi[i] = raw;
    } else {
      const float f = __uint_as_float(raw);
      hi[i] = to_tf32(f);
      if constexpr (MODE == 3) lo[i] = to_tf32(f - __uint_as_float(hi[i]));
    }
  }
};

// Four 8x8 b16 matrices from shared memory, each lane giving one row's address:
// lanes 8i..8i+7 the rows of matrix i, which lands in r[i] as an mma fragment.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a * b for one 16x8 tile over one k-step (the small products first).
template <int MODE>
__device__ __forceinline__ void mma_step(float c[4], const Frag<MODE, 4>& a, const uint32_t* bhi,
                                         const uint32_t* blo) {
  if constexpr (MODE == 0) {
    mma_bf16(c, a.hi, bhi);
  } else if constexpr (MODE == 1) {
    mma_tf32(c, a.hi, bhi);
  } else {
    mma_tf32(c, a.lo, bhi);
    mma_tf32(c, a.hi, blo);
    mma_tf32(c, a.hi, bhi);
  }
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ------------------------------------------------------------------------------- down

template <typename T, int MODE>
__global__ void __launch_bounds__(kMmaThreads, 1)
    fir_conv_down_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const float* __restrict__ bias, T* __restrict__ y, const Geometry g) {
  constexpr int WM = 4, MT = 2, NT = 4, NB = 128;  // warps 4 (pixels) x 4 (channels)
  constexpr int KS = kStepWords * Elem<T>::kPerWord;  // channels per slice
  constexpr int E = 16 / sizeof(T);                    // elements per 16-byte vector
  constexpr int in_rows = 2 * kDownTH + 4, in_cols = 2 * kDownTW + 4;
  constexpr int f_rows = 2 * kDownTH + 1, f_cols = 2 * kDownTW + 1;
  constexpr int x_words = in_rows * in_cols * kRowWords;
  constexpr int f_words = (f_rows * f_cols * kFirWords + 3) / 4 * 4;  // 16-byte aligned
  constexpr int w_words = 9 * NB * kRowWords;
  extern __shared__ uint4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* const xs = smem;                 // two slice buffers of x_words
  uint32_t* const xf = smem + 2 * x_words;   // two FIR tiles of f_words
  uint32_t* const ws = xf + 2 * f_words;     // two slice buffers of w_words

  const int b = blockIdx.z;
  const int split = blockIdx.y % g.ksplit, n0 = (blockIdx.y / g.ksplit) * NB;
  const int oy0 = (blockIdx.x / g.tiles_w) * kDownTH, ox0 = (blockIdx.x % g.tiles_w) * kDownTW;
  const int iy0 = 2 * oy0 - 2, ix0 = 2 * ox0 - 2;
  // This block's slices of C_in: a cluster of ksplit blocks shares the tile's.
  const int per_split = (g.Cin / KS + g.ksplit - 1) / g.ksplit;
  const int s_first = split * per_split;
  const int slices = max(0, min(g.Cin / KS - s_first, per_split));

  // A slice's input tile (KS channels) and the 9 taps' weights, [tap][n][ci].
  auto load_x = [&](int s, int buf) {
    for (int i = threadIdx.x; i < in_rows * in_cols * 2; i += kMmaThreads) {
      const int half = i & 1, px = i >> 1;
      const int iy = iy0 + px / in_cols, ix = ix0 + px % in_cols;
      const bool inside = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
      const T* src = x + ((static_cast<size_t>(b) * g.H + (inside ? iy : 0)) * g.W +
                          (inside ? ix : 0)) * g.Cin + (s_first + s) * KS + half * E;
      cp_async16(xs + buf * x_words + px * kRowWords + half * 4, src, inside ? 16 : 0);
    }
  };
  auto load_w = [&](int s, int buf) {
    for (int i = threadIdx.x; i < 9 * NB * 2; i += kMmaThreads) {
      const int half = i & 1, n = (i >> 1) % NB, t = (i >> 1) / NB;
      const bool valid = n0 + n < g.Cout;
      const T* src = w + (static_cast<size_t>(valid ? n0 + n : 0) * 9 + t) * g.Cin +
                     (s_first + s) * KS + half * E;
      cp_async16(ws + buf * w_words + (t * NB + n) * kRowWords + half * 4, src,
                 valid ? 16 : 0);
    }
  };
  // xf = FIR(x) on the slice, rounded to T. An item is a column of the FIR tile,
  // one 16-byte vector of channels, and a run of its rows: each input row is
  // filtered across (4 taps) once, and the last 4 such rows are combined down.
  constexpr int runs = 7, run_rows = (f_rows + runs - 1) / runs;  // one item a thread
  static_assert(f_cols * 2 * runs <= kMmaThreads, "FIR items");
  auto fir = [&](const uint32_t* src, uint32_t* dst) {
    for (int i = threadIdx.x; i < f_cols * 2 * runs; i += kMmaThreads) {
      const int half = i & 1, c = (i >> 1) % f_cols, run = (i >> 1) / f_cols;
      const int r0 = run * run_rows, r1 = min(f_rows, r0 + run_rows);
      float h[4][E];
      auto across = [&](int r, float* out) {
#pragma unroll
        for (int k = 0; k < E; ++k) out[k] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v[E];
          Vec16<T>::unpack(
              *reinterpret_cast<const uint4*>(src + (r * in_cols + c + q) * kRowWords + half * 4),
              v);
#pragma unroll
          for (int k = 0; k < E; ++k) out[k] = fmaf(g.fir[q], v[k], out[k]);
        }
      };
      across(r0, h[0]);
      across(r0 + 1, h[1]);
      across(r0 + 2, h[2]);
#pragma unroll
      for (int r = r0; r < r0 + run_rows; ++r) {
        if (r >= r1) break;
        across(r + 3, h[3]);
        float acc[E];
#pragma unroll
        for (int k = 0; k < E; ++k) {
          acc[k] = fmaf(g.fir[0], h[0][k], fmaf(g.fir[1], h[1][k],
                        fmaf(g.fir[2], h[2][k], g.fir[3] * h[3][k])));
          h[0][k] = h[1][k];
          h[1][k] = h[2][k];
          h[2][k] = h[3][k];
        }
        const uint4 o = Vec16<T>::pack(acc);
        uint2* d = reinterpret_cast<uint2*>(dst + (r * f_cols + c) * kFirWords + half * 4);
        d[0] = make_uint2(o.x, o.y);
        d[1] = make_uint2(o.z, o.w);
      }
    }
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int gq = lane >> 2, qq = lane & 3;
  int abase[MT][2];  // FIR-tile word of each of this thread's rows at tap (0, 0)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (wm * MT + mt) * 16 + gq + 8 * h;
      abase[mt][h] = (2 * (p / kDownTW) * f_cols + 2 * (p % kDownTW)) * kFirWords + qq;
    }
  }
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;

  // One barrier a slice: after it, slice s + 2's input and s + 1's weights are
  // issued, then each warp filters its share of slice s + 1 and runs its
  // products of slice s, so that one warp's filtering overlaps another's products.
  if (slices > 0) {
    load_x(0, 0);
    if (slices > 1) load_x(1, 1);
    load_w(0, 0);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (slices > 0) fir(xs, xf);
  for (int s = 0; s < slices; ++s) {
    cp_async_wait_all();
    __syncthreads();
    if (s + 2 < slices) load_x(s + 2, s & 1);
    if (s + 1 < slices) load_w(s + 1, (s + 1) & 1);
    cp_async_commit();
    if (s + 1 < slices) fir(xs + ((s + 1) & 1) * x_words, xf + ((s + 1) & 1) * f_words);
    const uint32_t* const xfb = xf + (s & 1) * f_words;
    const uint32_t* wsb = ws + (s & 1) * w_words + (wn * NT * 8 + gq) * kRowWords + qq;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int toff = ((t / 3) * f_cols + t % 3) * kFirWords;
      Frag<MODE, 2 * NT> bf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t* row = wsb + (t * NB + nt * 8) * kRowWords;
        bf.set(2 * nt, row[0]);
        bf.set(2 * nt + 1, row[4]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t* r0 = xfb + abase[mt][0] + toff;
        const uint32_t* r1 = xfb + abase[mt][1] + toff;
        Frag<MODE, 4> af;
        af.set(0, r0[0]);
        af.set(1, r1[0]);
        af.set(2, r0[4]);
        af.set(3, r1[4]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_step<MODE>(acc[mt][nt], af, &bf.hi[2 * nt], &bf.lo[MODE == 3 ? 2 * nt : 0]);
        }
      }
    }
  }

  // Epilogue: each block's float32 sums go to its shared memory (over the input
  // buffers, [pixel][channel]); the cluster's blocks then each add up a share
  // of the tile's pixels across the cluster (distributed shared memory), add
  // the bias and store whole pixels' channels.
  constexpr int pps = NB + 4;  // partial tile pixel stride, floats
  static_assert(kDownTH * kDownTW * pps <= 2 * x_words, "partial tile fits");
  float* const part = reinterpret_cast<float*>(xs);
  __syncthreads();  // every warp is done with the input buffers
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (wm * MT + mt) * 16 + gq + 8 * h;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        *reinterpret_cast<float2*>(part + p * pps + wn * NT * 8 + nt * 8 + 2 * qq) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  constexpr int px_tile = kDownTH * kDownTW;
  const int share = (px_tile + g.ksplit - 1) / g.ksplit;
  for (int i = threadIdx.x; i < share * (NB / 4); i += kMmaThreads) {
    const int p = split * share + i / (NB / 4), n = (i % (NB / 4)) * 4;
    const int oy = oy0 + p / kDownTW, ox = ox0 + p % kDownTW;
    if (p >= px_tile || oy >= g.OH || ox >= g.OW || n0 + n >= g.Cout) continue;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < g.ksplit; ++r) {
      const float4 v = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r) +
                                                        p * pps + n);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (bias) {
      sum.x += bias[n0 + n];
      sum.y += bias[n0 + n + 1];
      sum.z += bias[n0 + n + 2];
      sum.w += bias[n0 + n + 3];
    }
    T* out = y + ((static_cast<size_t>(b) * g.OH + oy) * g.OW + ox) * g.Cout + n0 + n;
    store_pair(out, sum.x, sum.y);
    store_pair(out + 2, sum.z, sum.w);
  }
  cluster.sync();  // the other blocks' reads of this block's sums are done
}

// ------------------------------------------------------------------------- down, narrow

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fir_conv_down_narrow_kernel(const T* __restrict__ x, const T* __restrict__ w,
                                const float* __restrict__ bias, T* __restrict__ y,
                                const Geometry g) {
  constexpr int in_rows = 2 * kDownTH + 4, in_cols = 2 * kDownTW + 4;
  constexpr int f_rows = 2 * kDownTH + 1, f_cols = 2 * kDownTW + 1;
  constexpr int NB = 128;  // output channels a block
  static_assert(kThreads == (NB / 8) * (kDownTH * kDownTW / 8), "narrow thread layout");
  constexpr int E = 16 / sizeof(T);
  const int cin = g.Cin, fps = cin + 1;  // FIR-tile pixel stride, padded
  extern __shared__ uint4 smem4[];
  float* xt = reinterpret_cast<float*>(smem4);    // in_rows x in_cols x cin
  float* xf = xt + in_rows * in_cols * cin;       // f_rows x f_cols x fps
  float* wt = xf + (f_rows * f_cols * fps + 3) / 4 * 4;  // [ci][tap][n], 16-byte aligned

  const int b = blockIdx.z;
  const int n0 = blockIdx.y * NB;
  const int oy0 = (blockIdx.x / g.tiles_w) * kDownTH, ox0 = (blockIdx.x % g.tiles_w) * kDownTW;
  for (int i = threadIdx.x; i < in_rows * in_cols * cin; i += kThreads) {
    const int ci = i % cin, px = i / cin;
    const int iy = 2 * oy0 - 2 + px / in_cols, ix = 2 * ox0 - 2 + px % in_cols;
    const bool inside = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    xt[i] = inside ? static_cast<float>(
                         x[((static_cast<size_t>(b) * g.H + iy) * g.W + ix) * cin + ci])
                   : 0.f;
  }
  for (int i = threadIdx.x; i < NB * 9 * cin; i += kThreads) {  // in the weights' order
    const int n = i / (9 * cin), t = (i / cin) % 9, ci = i % cin;
    wt[(ci * 9 + t) * NB + n] =
        n0 + n < g.Cout ? static_cast<float>(w[static_cast<size_t>(n0) * 9 * cin + i]) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < f_rows * f_cols * cin; i += kThreads) {
    const int ci = i % cin, px = i / cin;
    const int r = px / f_cols, c = px % f_cols;
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float row = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        row = fmaf(g.fir[q], xt[((r + a) * in_cols + c + q) * cin + ci], row);
      }
      acc = fmaf(g.fir[a], row, acc);
    }
    xf[px * fps + ci] = static_cast<float>(static_cast<T>(acc));  // rounded as the composition
  }
  __syncthreads();

  // Thread: 8 output channels (v) at 8 neighbouring pixels of a tile row (pg), so
  // that the 16 threads of a pixel group store a pixel's 128 channels as one
  // contiguous run.
  const int v = threadIdx.x % (NB / 8), pg = threadIdx.x / (NB / 8);
  const int py = pg / (kDownTW / 8), px0 = (pg % (kDownTW / 8)) * 8;
  float acc[8][8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[q][k] = 0.f;
  for (int ci = 0; ci < cin; ++ci) {
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const float4* wr = reinterpret_cast<const float4*>(wt + (ci * 9 + t) * NB + v * 8);
      const float4 w0 = wr[0], w1 = wr[1];
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const float* xrow = xf + ((2 * py + t / 3) * f_cols + 2 * px0 + t % 3) * fps + ci;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float xv = xrow[2 * q * fps];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[q][k] = fmaf(wv[k], xv, acc[q][k]);
      }
    }
  }
  const int n = n0 + v * 8, oy = oy0 + py;
  if (n >= g.Cout || oy >= g.OH) return;
  float bv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) bv[k] = bias ? bias[n + k] : 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int ox = ox0 + px0 + q;
    if (ox >= g.OW) break;
    T* out = y + ((static_cast<size_t>(b) * g.OH + oy) * g.OW + ox) * g.Cout + n;
#pragma unroll
    for (int h = 0; h < 8 / E; ++h) {
      float o[E];
#pragma unroll
      for (int k = 0; k < E; ++k) o[k] = acc[q][h * E + k] + bv[h * E + k];
      reinterpret_cast<uint4*>(out)[h] = Vec16<T>::pack(o);
    }
  }
}

// --------------------------------------------------------------------------------- up

// Persistent and weight-stationary: a block holds its NB output channels'
// weights for all taps and all of C_in in shared memory, loaded once, and walks
// the (batch row, tile) items blockIdx.x, + gridDim.x, ...: so no barrier
// falls between the k-steps of a tile, and the next tile's input is in flight
// during this tile's FIR.
template <typename T, int MODE, int NB>
__global__ void __launch_bounds__(kThreads, 1)
    fir_conv_up_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bias, T* __restrict__ y, const Geometry g) {
  constexpr int WN = NB >= 64 ? 2 : 1, NT = NB / 8 / WN;  // warps over channels, n8 tiles
  constexpr int WM = 8 / WN, MT = kMaxUpMtiles / WM;      // warps over pixels, row tiles
  constexpr int KS = kStepWords * Elem<T>::kPerWord;
  constexpr int E = 16 / sizeof(T);
  constexpr int yps = NB / Elem<T>::kPerWord + 4;        // y-tile pixel stride, words
  static_assert(WM * WN * 32 == kThreads && NT >= 1, "warp layout");
  const int th = g.th, tw = g.tw;
  const int xr = th / 2 + 2, xc = tw / 2 + 2;            // input tile
  const int yr = th + 3, yc = tw + 3;                    // conv output tile with the FIR's halo
  const int xps = g.Cin / Elem<T>::kPerWord + 4;         // input-tile pixel stride, words
  const int chunks = g.Cin / KS;
  const int per_image = g.tiles_h * g.tiles_w, items = per_image * g.B;
  extern __shared__ uint4 smem4[];
  // weights [chunk][tap][n][8 words]: the two 16-byte halves of rows n with bit 2 set
  // are swapped, so that a fragment's 8 rows hit 8 distinct bank groups
  uint32_t* const ws = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* const xt = ws + chunks * 9 * NB * kStepWords;
  uint32_t* const yt = xt + xr * xc * xps;
  const int n0 = blockIdx.y * NB;

  for (int i = threadIdx.x; i < chunks * 9 * NB * 2; i += kThreads) {
    const int half = i & 1, n = (i >> 1) % NB, rest = (i >> 1) / NB;  // rest: chunk * 9 + tap
    const bool valid = n0 + n < g.Cout;
    const T* src = w + (static_cast<size_t>(valid ? n0 + n : 0) * 9 + rest % 9) * g.Cin +
                   (rest / 9) * KS + half * E;
    cp_async16(ws + (rest * NB + n) * kStepWords + (half ^ ((n >> 2) & 1)) * 4, src,
               valid ? 16 : 0);
  }
  auto load_x = [&](int item) {  // the input tile of an item, all of C_in
    const int b = item / per_image, tile = item % per_image;
    const int iy0 = (tile / g.tiles_w) * th / 2 - 1, ix0 = (tile % g.tiles_w) * tw / 2 - 1;
    const int vecs = g.Cin / E;
    for (int i = threadIdx.x; i < xr * xc * vecs; i += kThreads) {
      const int v = i % vecs, px = i / vecs;
      const int iy = iy0 + px / xc, ix = ix0 + px % xc;
      const bool inside = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
      const T* src = x + ((static_cast<size_t>(b) * g.H + (inside ? iy : 0)) * g.W +
                          (inside ? ix : 0)) * g.Cin + v * E;
      cp_async16(xt + px * xps + v * 4, src, inside ? 16 : 0);
    }
    cp_async_commit();
  };

  // Warps w and w + 4 share a scheduler (SMSP): with two channel halves, give
  // them row tiles wm and wm + 2, so that the schedulers' shares of a class's
  // row tiles differ by one at most.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wn = WN == 2 ? warp & 1 : 0;
  const int wm = WN == 2 ? ((warp >> 1) & 1) + 2 * (warp >> 2) : warp;
  const int gq = lane >> 2, qq = lane & 3;
  const int sw = (gq & 4) ? 4 : 0;  // the swapped halves of this thread's weight rows
  const uint32_t* const wsb = ws + (wn * NT * 8 + gq) * kStepWords + qq;
  const int l_n = wn * NT * 8 + (lane & 7) + 8 * (lane >> 4);  // this lane's ldmatrix B row
  const uint32_t* const wl =
      ws + l_n * kStepWords + 4 * (((lane >> 3) & 1) ^ ((l_n >> 2) & 1));

  // One class of the conv outputs by (row, column) parity, even first, its taps
  // known at compile time: even rows take taps r = 0 (input row offset 0) and 2
  // (offset 1), odd rows r = 1. The class's sums go to the tile, rounded to T.
  auto run_class = [&](auto cy_c, auto cx_c) {
    constexpr int CY = decltype(cy_c)::value, CX = decltype(cx_c)::value;
    constexpr int NTX = 2 - CX, NTAPS = (2 - CY) * NTX;
    const int nc = tw / 2 + 1 + CX;
    const int count = (th / 2 + 1 + CY) * nc;
    const int mtiles = (count + 15) / 16;
    int abase[MT][2];  // input-tile word of each of this thread's rows at offset (0, 0)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = min((wm + WM * mt) * 16 + gq + 8 * h, count - 1);
        abase[mt][h] = ((m / nc) * xc + m % nc) * xps + qq;
      }
    }
    // bf16 loads its fragments with ldmatrix: lane l gives row (l & 15) of an
    // A tile (its k-half l >> 4), and row (l & 7) + 8 (l >> 4) of a pair of B
    // tiles (its k-half (l >> 3) & 1, in the halves as stored).
    int lrow[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = min((wm + WM * mt) * 16 + (lane & 15), count - 1);
      lrow[mt] = ((m / nc) * xc + m % nc) * xps + 4 * (lane >> 4);
    }
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;
#pragma unroll 4
    for (int c = 0; c < chunks; ++c) {
#pragma unroll
      for (int tap = 0; tap < NTAPS; ++tap) {
        const int ry = CY ? 0 : tap / NTX, rx = CX ? 0 : tap % NTX;
        const int t = (CY ? 1 : 2 * ry) * 3 + (CX ? 1 : 2 * rx);
        const int off = (ry * xc + rx) * xps + c * kStepWords;
        if constexpr (MODE == 0) {
          uint32_t bfr[NT][2];
#pragma unroll
          for (int pr = 0; pr < NT / 2; ++pr) {
            uint32_t r[4];
            ldmatrix_x4(r, wl + (c * 9 + t) * NB * kStepWords + pr * 16 * kStepWords);
            bfr[2 * pr][0] = r[0];
            bfr[2 * pr][1] = r[1];
            bfr[2 * pr + 1][0] = r[2];
            bfr[2 * pr + 1][1] = r[3];
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (wm + WM * mt < mtiles) {
              uint32_t a[4];
              ldmatrix_x4(a, xt + lrow[mt] + off);
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, bfr[nt]);
            }
          }
        } else {  // float32: TF32 fragments, converted as they are loaded
          const uint32_t* brow = wsb + (c * 9 + t) * NB * kStepWords;
          Frag<MODE, 2 * NT> bf;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            bf.set(2 * nt, brow[nt * 8 * kStepWords + sw]);
            bf.set(2 * nt + 1, brow[nt * 8 * kStepWords + 4 - sw]);
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if (wm + WM * mt < mtiles) {
              const uint32_t* r0 = xt + abase[mt][0] + off;
              const uint32_t* r1 = xt + abase[mt][1] + off;
              Frag<MODE, 4> af;
              af.set(0, r0[0]);
              af.set(1, r1[0]);
              af.set(2, r0[4]);
              af.set(3, r1[4]);
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                mma_step<MODE>(acc[mt][nt], af, &bf.hi[2 * nt],
                               &bf.lo[MODE == 3 ? 2 * nt : 0]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (wm + WM * mt >= mtiles) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (wm + WM * mt) * 16 + gq + 8 * h;
        if (m >= count) continue;
        const int pix = (2 * (m / nc) + 1 - CY) * yc + 2 * (m % nc) + 1 - CX;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = wn * NT * 8 + nt * 8 + 2 * qq;
          store_pair(reinterpret_cast<T*>(yt + pix * yps) + n, acc[mt][nt][2 * h],
                     acc[mt][nt][2 * h + 1]);
        }
      }
    }
  };

  constexpr int NV = NB / E;
  const int segs = (th + 7) / 8;
  if (blockIdx.x < items) load_x(blockIdx.x);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    cp_async_wait_all();  // the weights (first item) and this item's input tile
    __syncthreads();
    run_class(std::integral_constant<int, 0>{}, std::integral_constant<int, 0>{});
    run_class(std::integral_constant<int, 0>{}, std::integral_constant<int, 1>{});
    run_class(std::integral_constant<int, 1>{}, std::integral_constant<int, 0>{});
    run_class(std::integral_constant<int, 1>{}, std::integral_constant<int, 1>{});
    __syncthreads();  // the conv tile is whole; the input tile is free
    if (item + gridDim.x < items) load_x(item + gridDim.x);

    // FIR from the tile: each piece of work is (column, 16-byte channel vector,
    // 8 output rows); across 4 columns first, then down a window of 4 rows.
    const int b = item / per_image, tile = item % per_image;
    const int oy0 = (tile / g.tiles_w) * th, ox0 = (tile % g.tiles_w) * tw;
    for (int i = threadIdx.x; i < tw * NV * segs; i += kThreads) {
      const int v = i % NV, col = (i / NV) % tw, seg = i / (NV * tw);
      const int n = n0 + v * E;
      const int ox = ox0 + col;
      if (n >= g.Cout || ox >= g.OW) continue;
      float bv[E];
#pragma unroll
      for (int k = 0; k < E; ++k) bv[k] = bias ? bias[n + k] : 0.f;
      auto across = [&](int r, float* hsum) {
#pragma unroll
        for (int k = 0; k < E; ++k) hsum[k] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float val[E];
          Vec16<T>::unpack(
              *reinterpret_cast<const uint4*>(yt + (r * yc + col + q) * yps + v * 4), val);
#pragma unroll
          for (int k = 0; k < E; ++k) hsum[k] = fmaf(g.fir[q], val[k], hsum[k]);
        }
      };
      const int a0 = seg * 8, a1 = min(th, a0 + 8);
      float h[4][E];
      across(a0, h[0]);
      across(a0 + 1, h[1]);
      across(a0 + 2, h[2]);
#pragma unroll
      for (int a = a0; a < a0 + 8; ++a) {
        if (a >= a1) break;
        across(a + 3, h[3]);
        float o[E];
#pragma unroll
        for (int k = 0; k < E; ++k) {
          o[k] = fmaf(g.fir[0], h[0][k], fmaf(g.fir[1], h[1][k], fmaf(g.fir[2], h[2][k],
                      fmaf(g.fir[3], h[3][k], bv[k]))));
          h[0][k] = h[1][k];
          h[1][k] = h[2][k];
          h[2][k] = h[3][k];
        }
        const int oy = oy0 + a;
        if (oy < g.OH) {
          *reinterpret_cast<uint4*>(y + ((static_cast<size_t>(b) * g.OH + oy) * g.OW + ox) *
                                            g.Cout + n) = Vec16<T>::pack(o);
        }
      }
    }
  }
}

template <typename T, int MODE>
cudaError_t launch_down(dim3 grid, int smem, cudaStream_t st, const void* x, const void* w,
                        const float* bias, void* y, const Geometry& g) {
  static const SmemOptIn opt_in = opt_in_dynamic_smem(fir_conv_down_kernel<T, MODE>);
  if (opt_in.err != cudaSuccess) return opt_in.err;
  if (smem > opt_in.limit || g.ksplit < 1 || g.ksplit > 8 || grid.y % g.ksplit) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = g.ksplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fir_conv_down_kernel<T, MODE>, static_cast<const T*>(x),
                            static_cast<const T*>(w), bias, static_cast<T*>(y), g);
}

template <typename T>
cudaError_t launch_narrow(dim3 grid, int smem, cudaStream_t st, const void* x, const void* w,
                          const float* bias, void* y, const Geometry& g) {
  static const SmemOptIn opt_in = opt_in_dynamic_smem(fir_conv_down_narrow_kernel<T>);
  if (opt_in.err != cudaSuccess) return opt_in.err;
  if (smem > opt_in.limit) return cudaErrorInvalidValue;
  fir_conv_down_narrow_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, static_cast<T*>(y), g);
  return cudaSuccess;
}

template <typename T, int MODE, int NB>
cudaError_t launch_up_nb(dim3 grid, int smem, cudaStream_t st, const void* x, const void* w,
                         const float* bias, void* y, const Geometry& g) {
  static const SmemOptIn opt_in = opt_in_dynamic_smem(fir_conv_up_kernel<T, MODE, NB>);
  if (opt_in.err != cudaSuccess) return opt_in.err;
  if (smem > opt_in.limit) return cudaErrorInvalidValue;
  fir_conv_up_kernel<T, MODE, NB><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, static_cast<T*>(y), g);
  return cudaSuccess;
}

template <typename T, int MODE>
cudaError_t launch_up(int nb, dim3 grid, int smem, cudaStream_t st, const void* x,
                      const void* w, const float* bias, void* y, const Geometry& g) {
  if (nb == 64) return launch_up_nb<T, MODE, 64>(grid, smem, st, x, w, bias, y, g);
  if (nb == 32) return launch_up_nb<T, MODE, 32>(grid, smem, st, x, w, bias, y, g);
  if (nb == 16) return launch_up_nb<T, MODE, 16>(grid, smem, st, x, w, bias, y, g);
  return cudaErrorInvalidValue;
}

}  // namespace

// x: (B, H, W, Cin) channels_last; w: (Cout, Cin, 3, 3) channels_last, x's dtype;
// bias: float32 (Cout) or null; y: (B, OH, OW, Cout) channels_last. All device
// pointers, 16-byte aligned. fir: HOST pointer to the 4 taps, flipped and
// scaled. variant: 0 down, 1 down narrow (Cin < 16), 2 up. The tile (th, tw)
// and the tiles, the grid, the output channels a block (nb), the blocks that
// share a down tile's C_in (ksplit, a cluster) and the shared memory come from
// the host plan (ops/upfirdn2d.py:fir_conv_plan). mode: 0
// bf16, 1 TF32, 3 three TF32 products. Returns the launch's error code.
extern "C" int sgmse_fir_conv(const void* x, const void* w, const void* bias, void* y,
                              int variant, int B, int H, int W, int Cin, int Cout, int OH, int OW,
                              int th, int tw, int tiles_h, int tiles_w, int grid_x, int grid_y,
                              int grid_z, int nb, int ksplit, int smem, const float* fir,
                              int is_bf16, int mode, void* stream) {
  if (B < 1 || OH < 1 || OW < 1 || Cout % 8 != 0 || tiles_h < 1 || tiles_w < 1 ||
      grid_x < 1 || grid_y < 1 || grid_y > 65535 || grid_z < 1 || grid_z > 65535 ||
      variant < 0 || variant > 2 || (mode != 0 && mode != 1 && mode != 3) ||
      (is_bf16 != 0) != (mode == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((variant != 1 && Cin % 16 != 0) || (variant == 1 && (Cin % 4 != 0 || Cin > 16)) ||
      (variant == 2 && (th % 2 != 0 || (th / 2 + 2) * (tw / 2 + 2) > kMaxUpMtiles * 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g{B, H, W, Cin, Cout, OH, OW, th, tw, tiles_h, tiles_w, ksplit,
             {fir[0], fir[1], fir[2], fir[3]}};
  const float* b = static_cast<const float*>(bias);
  const dim3 grid(grid_x, grid_y, grid_z);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (variant == 1) {
    err = is_bf16 ? launch_narrow<__nv_bfloat16>(grid, smem, st, x, w, b, y, g)
                  : launch_narrow<float>(grid, smem, st, x, w, b, y, g);
  } else if (variant == 0) {
    err = mode == 0   ? launch_down<__nv_bfloat16, 0>(grid, smem, st, x, w, b, y, g)
          : mode == 1 ? launch_down<float, 1>(grid, smem, st, x, w, b, y, g)
                      : launch_down<float, 3>(grid, smem, st, x, w, b, y, g);
  } else {
    err = mode == 0   ? launch_up<__nv_bfloat16, 0>(nb, grid, smem, st, x, w, b, y, g)
          : mode == 1 ? launch_up<float, 1>(nb, grid, smem, st, x, w, b, y, g)
                      : launch_up<float, 3>(nb, grid, smem, st, x, w, b, y, g);
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
