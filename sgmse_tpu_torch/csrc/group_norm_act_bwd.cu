// K2b: the backward of K2 (group_norm_act.cu), on channels_last activations.
//
// Replaces XLA's autodiff of flax nn.GroupNorm followed by jax.nn.silu and
// the time-embedding add before GroupNorm_1 (sgmse_tpu/models/blocks.py:157-167,
// :416-421), as the JAX train step differentiates it. One call per norm of
// the score network in a train step's backward: 109.
//
// With u = x + bias[b, c], x^ = (u - mean) * rstd, v = gamma * x^ + beta,
// s = sigmoid(v), dv = dy * s * (1 + v * (1 - s)) (dv = dy without SiLU),
// g = gamma * dv, and f = 1, 1/2 or 0 as the variance before the clamp is
// above, at or below 0 (JAX's derivative of maximum):
//
//     dgamma[c] = sum_{b,hw} dv * x^          dbeta[c] = sum_{b,hw} dv
//     dx = rstd * (g - mean_grp(g) - f * x^ * mean_grp(g * x^))
//     dbias[b, c] = sum_hw dx
//
// The group means follow from per-(b, c) sums: with S1 = sum_hw dv,
// S2 = sum_hw dv * x^ and S3 = sum_hw x^, mean_grp(g) = sum_c gamma_c S1 / n
// and mean_grp(g * x^) = sum_c gamma_c S2 / n (n = C/G * HW), and
// dbias = rstd * (gamma S1 - HW mean_grp(g) - f mean_grp(g * x^) S3). The
// forward's (mean, unclamped variance) per (b, group) come in `stats`.
//
// Bound on the H100: bytes. A few tens of flops per element against reading x
// and dy and writing dx: the least traffic is 3 passes over the tensor. This
// first design is simple and right, and makes 5: three launches on the stream,
//   1. reduce: block (j, b) owns a contiguous range of pixels of batch row b
//      across all channels (16-byte vectors, as K2), reads x and dy once and
//      sums S1, S2, S3 per channel in registers, then over the block's pixel
//      slots in shared memory in a fixed order, into a per-block partial;
//   2. combine: per (b, c), the row's partials in a fixed order;
//   3. apply: every block of row b forms the group means from the row sums,
//      reads x and dy again (from L2 where they fit) and writes dx; the row's
//      first block writes dbias, block (0, 0) dgamma and dbeta (sums over b in
//      order).
// No atomics: the results repeat bit for bit. Keeping x and dy on chip
// between the passes (as K2 stages x) is left to a later design.
#include "vec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxGroups = 512;
constexpr int kCombineChannels = 64;                         // channels per combine block
constexpr int kCombineSplit = kThreads / kCombineChannels;  // threads per channel

struct BwdArgs {
  const void* dy;
  const void* x;
  void* dx;
  const float* gamma;
  const float* beta;
  const void* bias;     // (B, C) in the input dtype, or null
  const float2* stats;  // (B, G) (mean, unclamped variance) of the forward
  void* dbias;          // (B, C) in the input dtype, or null
  float* dgamma;        // (C,)
  float* dbeta;         // (C,)
  float4* partial;      // (B, nb, C) per block (S1, S2, S3, 0)
  float4* rowsum;       // (B, C) per batch row (S1, S2, S3, 0)
  int B, HW, C, G;
  int nb;   // blocks per batch row
  int ppb;  // pixels per block
  float eps;
  int silu;
};

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float rstd_of(float var, float eps) {
  return rsqrtf(fmaxf(var, 0.f) + eps);  // the forward's rsqrt(max(var, 0) + eps)
}

// dL/dv from dL/dy: through the SiLU when there is one.
__device__ __forceinline__ float dv_of(float dy, float xh, float gamma, float beta, int silu) {
  if (!silu) return dy;
  const float v = fmaf(gamma, xh, beta);
  const float s = 1.f / (1.f + __expf(-v));
  return dy * s * (1.f + v * (1.f - s));
}

// The per-channel constants of a thread's N channels of batch row b.
template <typename T>
__device__ __forceinline__ void channel_params(const BwdArgs& a, int b, int lane, float* mean,
                                               float* rstd, float* gamma, float* beta,
                                               float* bias) {
  constexpr int N = Vec16<T>::N;
  const int cpg = a.C / a.G;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int c = lane * N + k;
    const float2 st = a.stats[static_cast<size_t>(b) * a.G + c / cpg];
    mean[k] = st.x;
    rstd[k] = rstd_of(st.y, a.eps);
    gamma[k] = a.gamma[c];
    beta[k] = a.beta[c];
    bias[k] = a.bias ? static_cast<float>(
                           static_cast<const T*>(a.bias)[static_cast<size_t>(b) * a.C + c])
                     : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gn_bwd_reduce_kernel(const BwdArgs a) {
  using V = Vec16<T>;
  constexpr int N = V::N;
  __shared__ float red[3][kThreads * 8];  // per (pixel slot, channel): S1, S2, S3
  const int C = a.C;
  const int lanes = C / N;
  const int sweep = kThreads / lanes;
  const int tid = threadIdx.x;
  const bool active = tid < sweep * lanes;
  const int lane = tid % lanes;
  const int poff = tid / lanes;
  const int b = blockIdx.y;
  const int j = blockIdx.x;
  const int p0 = j * a.ppb;
  const int p1 = min(p0 + a.ppb, a.HW);

  if (active) {
    float mean[N], rstd[N], gamma[N], beta[N], bias[N], s1[N], s2[N], s3[N];
    channel_params<T>(a, b, lane, mean, rstd, gamma, beta, bias);
#pragma unroll
    for (int k = 0; k < N; ++k) s1[k] = s2[k] = s3[k] = 0.f;
    const size_t row = static_cast<size_t>(b) * a.HW * lanes + lane;
    const uint4* xb = reinterpret_cast<const uint4*>(a.x) + row;
    const uint4* gb = reinterpret_cast<const uint4*>(a.dy) + row;
    const int step = kUnroll * sweep;
    for (int p = p0 + poff; p < p1; p += step) {
      uint4 rx[kUnroll], rg[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = p + u * sweep;
        if (q < p1) {
          rx[u] = __ldg(xb + static_cast<size_t>(q) * lanes);
          rg[u] = __ldg(gb + static_cast<size_t>(q) * lanes);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + u * sweep < p1) {
          float xv[N], gv[N];
          V::unpack(rx[u], xv);
          V::unpack(rg[u], gv);
#pragma unroll
          for (int k = 0; k < N; ++k) {
            const float xh = ((xv[k] + bias[k]) - mean[k]) * rstd[k];
            const float dv = dv_of(gv[k], xh, gamma[k], beta[k], a.silu);
            s1[k] += dv;
            s2[k] = fmaf(dv, xh, s2[k]);
            s3[k] += xh;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const int i = poff * C + lane * N + k;
      red[0][i] = s1[k];
      red[1][i] = s2[k];
      red[2][i] = s3[k];
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    float t1 = 0.f, t2 = 0.f, t3 = 0.f;
    for (int po = 0; po < sweep; ++po) {
      t1 += red[0][po * C + c];
      t2 += red[1][po * C + c];
      t3 += red[2][po * C + c];
    }
    a.partial[(static_cast<size_t>(b) * a.nb + j) * C + c] = make_float4(t1, t2, t3, 0.f);
  }
}

// Block (x, b): kCombineChannels channels of batch row b, kCombineSplit threads
// per channel each summing every kCombineSplit-th partial, then in order.
__global__ void __launch_bounds__(kThreads) gn_bwd_combine_kernel(const BwdArgs a) {
  __shared__ float4 part[kCombineSplit][kCombineChannels];
  const int cl = threadIdx.x % kCombineChannels;
  const int q = threadIdx.x / kCombineChannels;
  const int c = blockIdx.x * kCombineChannels + cl;
  const int b = blockIdx.y;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < a.C) {
    for (int j = q; j < a.nb; j += kCombineSplit) {
      const float4 t = a.partial[(static_cast<size_t>(b) * a.nb + j) * a.C + c];
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
    }
  }
  part[q][cl] = s;
  __syncthreads();
  if (q == 0 && c < a.C) {
    float4 r = part[0][cl];
    for (int i = 1; i < kCombineSplit; ++i) {
      r.x += part[i][cl].x;
      r.y += part[i][cl].y;
      r.z += part[i][cl].z;
    }
    a.rowsum[static_cast<size_t>(b) * a.C + c] = r;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gn_bwd_apply_kernel(const BwdArgs a) {
  using V = Vec16<T>;
  constexpr int N = V::N;
  __shared__ float2 coef[kMaxGroups];  // per group: mean_grp(g), f * mean_grp(g * x^)
  const int C = a.C;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int j = blockIdx.x;
  const int cpg = C / a.G;
  const float4* rows = a.rowsum + static_cast<size_t>(b) * C;
  const float inv_n = 1.f / (static_cast<float>(a.HW) * cpg);
  for (int g = tid; g < a.G; g += kThreads) {
    float sa = 0.f, sb = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      const float4 r = rows[c];
      sa = fmaf(a.gamma[c], r.x, sa);
      sb = fmaf(a.gamma[c], r.y, sb);
    }
    const float var = a.stats[static_cast<size_t>(b) * a.G + g].y;
    const float f = var > 0.f ? 1.f : (var == 0.f ? 0.5f : 0.f);
    coef[g] = make_float2(sa * inv_n, f * sb * inv_n);
  }
  __syncthreads();

  if (j == 0 && a.dbias) {
    for (int c = tid; c < C; c += kThreads) {
      const int g = c / cpg;
      const float rstd = rstd_of(a.stats[static_cast<size_t>(b) * a.G + g].y, a.eps);
      const float4 r = rows[c];
      const float d = rstd * (a.gamma[c] * r.x - static_cast<float>(a.HW) * coef[g].x -
                              coef[g].y * r.z);
      static_cast<T*>(a.dbias)[static_cast<size_t>(b) * C + c] = from_float<T>(d);
    }
  }
  if (j == 0 && b == 0) {
    for (int c = tid; c < C; c += kThreads) {
      float dg = 0.f, db = 0.f;
      for (int bb = 0; bb < a.B; ++bb) {
        const float4 r = a.rowsum[static_cast<size_t>(bb) * C + c];
        dg += r.y;
        db += r.x;
      }
      a.dgamma[c] = dg;
      a.dbeta[c] = db;
    }
  }

  const int lanes = C / N;
  const int sweep = kThreads / lanes;
  if (tid >= sweep * lanes) return;
  const int lane = tid % lanes;
  const int poff = tid / lanes;
  const int p0 = j * a.ppb;
  const int p1 = min(p0 + a.ppb, a.HW);
  float mean[N], rstd[N], gamma[N], beta[N], bias[N], ga[N], gb[N];
  channel_params<T>(a, b, lane, mean, rstd, gamma, beta, bias);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float2 cf = coef[(lane * N + k) / cpg];
    ga[k] = cf.x;
    gb[k] = cf.y;
  }
  const size_t row = static_cast<size_t>(b) * a.HW * lanes + lane;
  const uint4* xb = reinterpret_cast<const uint4*>(a.x) + row;
  const uint4* gyb = reinterpret_cast<const uint4*>(a.dy) + row;
  uint4* dxb = reinterpret_cast<uint4*>(a.dx) + row;
  const int step = kUnroll * sweep;
  for (int p = p0 + poff; p < p1; p += step) {
    uint4 rx[kUnroll], rg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * sweep;
      if (q < p1) {
        rx[u] = __ldcg(xb + static_cast<size_t>(q) * lanes);
        rg[u] = __ldcg(gyb + static_cast<size_t>(q) * lanes);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * sweep;
      if (q < p1) {
        float xv[N], gv[N];
        V::unpack(rx[u], xv);
        V::unpack(rg[u], gv);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float xh = ((xv[k] + bias[k]) - mean[k]) * rstd[k];
          const float dv = dv_of(gv[k], xh, gamma[k], beta[k], a.silu);
          xv[k] = rstd[k] * (fmaf(gamma[k], dv, -ga[k]) - xh * gb[k]);
        }
        dxb[static_cast<size_t>(q) * lanes] = V::pack(xv);
      }
    }
  }
}

template <typename T>
cudaError_t launch(BwdArgs a, cudaStream_t stream) {
  a.ppb = (a.HW + a.nb - 1) / a.nb;
  const dim3 grid(a.nb, a.B);
  gn_bwd_reduce_kernel<T><<<grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 combine((a.C + kCombineChannels - 1) / kCombineChannels, a.B);
  gn_bwd_combine_kernel<<<combine, kThreads, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_bwd_apply_kernel<T><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dy, x, dx: device pointers, channels_last (B, C, H, W), one dtype, float32
// (is_bf16 == 0) or bfloat16, 16-byte aligned. gamma, beta: float32 (C,).
// bias: (B, C) in x's dtype, or null; dbias the same shape out, or null.
// stats: float32 (B, G, 2), the forward's (mean, unclamped variance).
// dgamma, dbeta: float32 (C,) out. partial: float32 scratch of B * nb * C * 4;
// rowsum: float32 scratch of B * C * 4. C must be a multiple of 8 (bfloat16)
// or 4 (float32) with at most 256 vectors of 16 bytes per pixel, and a
// multiple of G <= 512. Returns the first launch error code.
extern "C" int sgmse_group_norm_act_bwd(const void* dy, const void* x, void* dx,
                                        const float* gamma, const float* beta, const void* bias,
                                        const float* stats, void* dbias, float* dgamma,
                                        float* dbeta, void* partial, void* rowsum, int nb, int B,
                                        int HW, int C, int G, float eps, int silu, int is_bf16,
                                        void* stream) {
  const int n = is_bf16 ? 8 : 4;
  if (B < 1 || B > 65535 || HW < 1 || G < 1 || G > kMaxGroups || nb < 1 || C % n != 0 ||
      C / n > kThreads || C % G != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a{dy,
            x,
            dx,
            gamma,
            beta,
            bias,
            reinterpret_cast<const float2*>(stats),
            dbias,
            dgamma,
            dbeta,
            static_cast<float4*>(partial),
            static_cast<float4*>(rowsum),
            B,
            HW,
            C,
            G,
            nb,
            0,
            eps,
            silu};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
  return static_cast<int>(err);
}
