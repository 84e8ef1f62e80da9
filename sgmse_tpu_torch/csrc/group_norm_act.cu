// K2: GroupNorm with an optional bias added first and an optional SiLU after,
// on channels_last activations, in one launch:
//
//     y = act(GroupNorm(x + bias[b, c]))
//
// Replaces flax nn.GroupNorm followed by jax.nn.silu as the JAX package uses it
// (sgmse_tpu/models/blocks.py:157-167, the res-block norms at :398-399 and
// :420-421, the attention norm at :232, and the output-pyramid norms at
// sgmse_tpu/models/ncsnpp.py:222-244), together with the time-embedding add
// `h + Dense_0(act(temb))[:, None, None, :]` before GroupNorm_1 (:416-419),
// all of which XLA fuses into the neighbouring convolutions. The score network
// calls it 109 times per evaluation (105 with SiLU, 4 without; 49 with a bias).
//
// Arithmetic, as flax 0.12 does it: statistics in float32 whatever the input
// dtype, variance = E[x^2] - E[x]^2 clamped at 0 (flax's use_fast_variance),
// y = (x - mean) * (rsqrt(var + eps) * gamma) + beta, then x * sigmoid(x) in
// float32 (with the hardware exp2 and reciprocal: a few float32 ulps), rounded
// once to the input dtype. The bias, in the input dtype (the
// Dense_0 output as it comes, so no cast kernel runs), is added in float32.
//
// Bound on the H100: bytes. A handful of flops per element against one read
// and one write. The least traffic is one read of x and one write of y, but the
// statistics of a group need every pixel before the first output can be
// written. The design:
//   - One cooperative launch of at most one block per SM (132 on the H100),
//     sized to the work (at least kMinBlockBytes of input per block, so the
//     4x4-pixel calls launch a few blocks, not 132). Block j of batch row b
//     owns a contiguous range of pixels across all channels, so every load is a
//     coalesced 16-byte vector (8 bfloat16 or 4 float32 channels).
//   - Pass 1 reads the range once. As much of it as fits in dynamic shared
//     memory (up to ~190 KB per block) is copied there with cp.async, every
//     copy in flight at once; the rest (the tail) is read meanwhile through
//     registers, kUnroll 16-byte loads in flight per thread. x and x^2 are
//     summed per channel in registers, the staged part from shared memory.
//     The block reduces these to per-group partials in a fixed order and writes
//     them to a small scratch array.
//   - grid.sync(). Every block of batch row b then combines that row's
//     partials in float64, in the same fixed order, so all blocks hold the same
//     (mean, rstd); results repeat bit for bit (no atomics).
//   - Pass 2 normalises and writes. Its arithmetic is small per byte, except
//     the SiLU: an IEEE expf and divide are tens of instructions per element,
//     enough to make pass 2 issue-bound at the 256x256 shapes, so the SiLU uses
//     __expf and __fdividef (the hardware exp2 and reciprocal). The staged
//     part comes from shared memory; the rest (inputs above ~25 MB, the
//     256x256 and the wide 128x128 calls) is read a second time, tail first,
//     the part pass 1 read last and so likeliest still in the 50 MB L2.
// A block that cannot be co-resident makes cudaLaunchCooperativeKernel fail;
// the wrapper raises. There is no multi-pass fallback.
//
// Under training the same launch also writes each (b, group)'s float32
// (mean, variance before the clamp at 0) to `stats`, which the backward
// (K2b, group_norm_act_bwd.cu) reads; at inference `stats` is null and the
// launch does what it did before.
#include <cooperative_groups.h>

#include <algorithm>

#include "vec.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr long long kMinBlockBytes = 16 * 1024;

struct GnArgs {
  const void* x;
  void* y;
  const float* gamma;
  const float* beta;
  const void* bias;   // (B, C) in the input dtype, or null
  float2* stats;      // (B, G) (mean, unclamped variance) out, or null
  float2* partial;    // (B * nb, G) per-block (sum, sum of squares)
  int HW, C, G;
  int nb;         // blocks per batch row
  int ppb;        // pixels per block
  int stage_pix;  // pixels of a block's range held in shared memory
  float eps;
  int silu;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) gn_act_kernel(const GnArgs a) {
  using V = Vec16<T>;
  constexpr int N = V::N;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.C;
  const int lanes = C / N;             // 16-byte vectors per pixel
  const int sweep = kThreads / lanes;  // pixels per sweep of the block
  const int tid = threadIdx.x;
  const bool active = tid < sweep * lanes;
  const int lane = tid % lanes;
  const int poff = tid / lanes;
  const int b = blockIdx.x / a.nb;
  const int p0 = (blockIdx.x % a.nb) * a.ppb;
  const int p1 = min(p0 + a.ppb, a.HW);
  const int pst = min(p1, p0 + a.stage_pix);  // [p0, pst) is staged
  const int step = kUnroll * sweep;

  uint4* stage = reinterpret_cast<uint4*>(smem);
  float2* red = reinterpret_cast<float2*>(smem + static_cast<size_t>(a.stage_pix) * C * sizeof(T));
  float2* chan = red + sweep * C;  // per channel (sum, sum of squares)
  float2* stats = chan + C;        // per group (mean, rstd)
  float2* affine = stats + a.G;    // per channel (gamma, beta)
  const size_t row = static_cast<size_t>(b) * a.HW * lanes + lane;
  const uint4* xb = reinterpret_cast<const uint4*>(a.x) + row;
  uint4* yb = reinterpret_cast<uint4*>(a.y) + row;

  // Loads whose latency would otherwise sit on the path after the barrier.
  for (int c = tid; c < C; c += kThreads) affine[c] = make_float2(a.gamma[c], a.beta[c]);
  float bias[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    bias[k] = (a.bias && active)
                  ? static_cast<float>(static_cast<const T*>(a.bias)[b * C + lane * N + k])
                  : 0.f;
  }

  // Pass 1: copy the staged range into shared memory with cp.async, all copies
  // in flight at once; meanwhile read the tail through registers; then sum the
  // staged part from shared memory. Each thread reads back only the slots it
  // copied itself, so its own cp.async wait suffices.
  if (active) {
    for (int p = p0 + poff; p < pst; p += sweep) {
      cp_async16(&stage[(p - p0) * lanes + lane], xb + static_cast<size_t>(p) * lanes);
    }
    float s[N], ss[N];
#pragma unroll
    for (int k = 0; k < N; ++k) s[k] = ss[k] = 0.f;
    auto accumulate = [&](const uint4& r) {
      float v[N];
      V::unpack(r, v);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float t = v[k] + bias[k];
        s[k] += t;
        ss[k] = fmaf(t, t, ss[k]);
      }
    };
    for (int p = pst + poff; p < p1; p += step) {
      uint4 r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = p + u * sweep;
        if (q < p1) r[u] = __ldg(xb + static_cast<size_t>(q) * lanes);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + u * sweep < p1) accumulate(r[u]);
      }
    }
    cp_async_wait_all();
    for (int p = p0 + poff; p < pst; p += sweep) accumulate(stage[(p - p0) * lanes + lane]);
#pragma unroll
    for (int k = 0; k < N; ++k) red[poff * C + lane * N + k] = make_float2(s[k], ss[k]);
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    float cs = 0.f, css = 0.f;
    for (int po = 0; po < sweep; ++po) {
      const float2 t = red[po * C + c];
      cs += t.x;
      css += t.y;
    }
    chan[c] = make_float2(cs, css);
  }
  __syncthreads();
  const int cpg = C / a.G;
  for (int g = tid; g < a.G; g += kThreads) {
    float gs = 0.f, gss = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      gs += chan[c].x;
      gss += chan[c].y;
    }
    a.partial[static_cast<size_t>(blockIdx.x) * a.G + g] = make_float2(gs, gss);
  }

  // A row held by one block needs no grid-wide barrier: its own partials are
  // visible to it after __syncthreads (every block takes the same branch).
  if (a.nb > 1) {
    cg::this_grid().sync();
  } else {
    __syncthreads();
  }

  // Every block of row b combines the row's partials in the same order.
  const double inv_count = 1.0 / (static_cast<double>(a.HW) * cpg);
  for (int g = tid; g < a.G; g += kThreads) {
    double s = 0.0, ss = 0.0;
    for (int j = 0; j < a.nb; ++j) {
      const float2 t = __ldcg(a.partial + (static_cast<size_t>(b) * a.nb + j) * a.G + g);
      s += t.x;
      ss += t.y;
    }
    const double mean = s * inv_count;
    const double var_raw = ss * inv_count - mean * mean;
    const double var = fmax(var_raw, 0.0);
    stats[g] = make_float2(static_cast<float>(mean), rsqrtf(static_cast<float>(var) + a.eps));
    if (a.stats && blockIdx.x % a.nb == 0) {
      a.stats[static_cast<size_t>(b) * a.G + g] =
          make_float2(static_cast<float>(mean), static_cast<float>(var_raw));
    }
  }
  __syncthreads();
  if (!active) return;

  float mean[N], mul[N], beta[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int c = lane * N + k;
    const float2 st = stats[c / cpg];
    mean[k] = st.x;
    mul[k] = st.y * affine[c].x;
    beta[k] = affine[c].y;
  }
  auto apply = [&](const uint4& r) {
    float v[N];
    V::unpack(r, v);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float t = ((v[k] + bias[k]) - mean[k]) * mul[k] + beta[k];
      if (a.silu) t = __fdividef(t, 1.f + __expf(-t));  // -> -0 as t -> -inf
      v[k] = t;
    }
    return V::pack(v);
  };

  // Pass 2: the unstaged tail from device memory (L2), then the staged part.
  for (int p = pst + poff; p < p1; p += step) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * sweep;
      if (q < p1) r[u] = __ldcg(xb + static_cast<size_t>(q) * lanes);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * sweep;
      if (q < p1) yb[static_cast<size_t>(q) * lanes] = apply(r[u]);
    }
  }
  for (int p = p0 + poff; p < pst; p += sweep) {
    yb[static_cast<size_t>(p) * lanes] = apply(stage[(p - p0) * lanes + lane]);
  }
}

template <typename T>
cudaError_t launch(const GnArgs& args, int B, int blocks_cap, void* stream) {
  constexpr int N = Vec16<T>::N;
  static const SmemOptIn opt_in = opt_in_dynamic_smem(gn_act_kernel<T>);
  if (opt_in.err != cudaSuccess) return opt_in.err;
  const int smem_limit = opt_in.limit;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  GnArgs a = args;
  const int lanes = a.C / N;
  const int sweep = kThreads / lanes;
  const long long row_bytes = static_cast<long long>(a.HW) * a.C * sizeof(T);
  const long long by_work = (row_bytes + kMinBlockBytes - 1) / kMinBlockBytes;
  const long long nb = std::max(1LL, std::min<long long>(sms / B, by_work));
  a.ppb = static_cast<int>((a.HW + nb - 1) / nb);
  a.nb = (a.HW + a.ppb - 1) / a.ppb;
  if (B * a.nb > blocks_cap) return cudaErrorInvalidValue;
  const size_t fixed = (static_cast<size_t>(sweep) * a.C + 2 * a.C + a.G) * sizeof(float2);
  const size_t pix_bytes = static_cast<size_t>(a.C) * sizeof(T);
  if (fixed + pix_bytes > static_cast<size_t>(smem_limit)) return cudaErrorInvalidValue;
  a.stage_pix = static_cast<int>(std::min<size_t>(a.ppb, (smem_limit - fixed) / pix_bytes));
  const size_t smem = a.stage_pix * pix_bytes + fixed;
  void* params[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gn_act_kernel<T>), dim3(B * a.nb),
                                     dim3(kThreads), params, smem,
                                     static_cast<cudaStream_t>(stream));
}

}  // namespace

// x, y: device pointers, channels_last (B, C, H, W), float32 (is_bf16 == 0) or
// bfloat16, 16-byte aligned. gamma, beta: float32 (C,). bias: (B, C) in x's
// dtype, or null. stats: float32 (B, G, 2) out, or null. partial: float32
// scratch of partial_blocks * G * 2, partial_blocks >= B times the blocks per
// row the launch picks (at most the SM count / B). C must be a multiple of 8
// (bfloat16) or 4 (float32), with at most 512 vectors of 16 bytes per pixel,
// and a multiple of G. Returns the launch's error code.
extern "C" int sgmse_group_norm_act(const void* x, void* y, const float* gamma, const float* beta,
                                    const void* bias, void* stats, void* partial,
                                    int partial_blocks, int B, int HW, int C, int G, float eps,
                                    int silu, int is_bf16, void* stream) {
  const int n = is_bf16 ? 8 : 4;
  if (B < 1 || HW < 1 || G < 1 || C % n != 0 || C / n > kThreads || C % G != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GnArgs a{x, y, gamma, beta, bias, static_cast<float2*>(stats), static_cast<float2*>(partial),
           HW, C, G, 0, 0, 0, eps, silu};
  cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(a, B, partial_blocks, stream)
                            : launch<float>(a, B, partial_blocks, stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
