// K2: GroupNorm with optional SiLU on channels_last activations.
//
// Replaces flax nn.GroupNorm followed by jax.nn.silu as the JAX package uses it
// (sgmse_tpu/models/blocks.py:157-167, the res-block norms at :398-399 and
// :420-421, the attention norm at :232, and the output-pyramid norms at
// sgmse_tpu/models/ncsnpp.py:222-244), which XLA fuses into the neighbouring
// convolutions. Eager PyTorch would run it as several separate passes. The
// score network calls it 109 times per evaluation (105 with SiLU, 4 without).
//
// Arithmetic, as flax 0.12 does it: statistics in float32 whatever the input
// dtype, variance = E[x^2] - E[x]^2 clamped at 0 (flax's use_fast_variance),
// y = (x - mean) * (rsqrt(var + eps) * gamma) + beta, then x * sigmoid(x) in
// float32, rounded once to the input dtype.
//
// Bound on the H100: bytes. Each element is read twice and written once, with
// a handful of flops. A group at the top level holds 256*256*4 elements per
// utterance, so one block per group would leave most of the 132 SMs idle. The
// design therefore splits the reduction:
//   pass 1: blocks over (pixel chunk, batch); each reads a chunk of pixels with
//           16-byte (float32) or 8-byte (bf16) vector loads across all channels
//           and writes per-group partial sums in a fixed order (no atomics, so
//           results repeat bit for bit);
//   pass 2: one block per batch row combines the partials in float64 and
//           writes (mean, rstd) per group;
//   pass 3: a grid-stride elementwise pass normalises, applies the affine and
//           the SiLU, and stores in the input dtype.
#include "vec4.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void gn_partial_kernel(const T* __restrict__ x, float2* __restrict__ partial, int HW,
                                  int C, int G, int pix_per_chunk, int n_chunks) {
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int lanes = C / 4;             // vec4 lanes across one pixel
  const int sweep = kThreads / lanes;  // pixels covered per sweep of the block
  const int tid = threadIdx.x;
  const int lane = tid % lanes;
  const int poff = tid / lanes;
  float s = 0.f, ss = 0.f;
  if (poff < sweep) {
    const int p0 = chunk * pix_per_chunk;
    const int p1 = min(p0 + pix_per_chunk, HW);
    const T* xb = x + static_cast<size_t>(b) * HW * C + lane * 4;
    for (int p = p0 + poff; p < p1; p += sweep) {
      float v[4];
      Vec4<T>::load(xb + static_cast<size_t>(p) * C, v);
      s += (v[0] + v[1]) + (v[2] + v[3]);
      ss += (v[0] * v[0] + v[1] * v[1]) + (v[2] * v[2] + v[3] * v[3]);
    }
  }
  __shared__ float sh_s[kThreads];
  __shared__ float sh_ss[kThreads];
  sh_s[tid] = s;
  sh_ss[tid] = ss;
  __syncthreads();
  const int lanes_per_group = (C / G) / 4;
  for (int g = tid; g < G; g += kThreads) {
    float gs = 0.f, gss = 0.f;
    for (int po = 0; po < sweep; ++po) {
      for (int l = g * lanes_per_group; l < (g + 1) * lanes_per_group; ++l) {
        gs += sh_s[po * lanes + l];
        gss += sh_ss[po * lanes + l];
      }
    }
    partial[(static_cast<size_t>(b) * n_chunks + chunk) * G + g] = make_float2(gs, gss);
  }
}

__global__ void gn_stats_kernel(const float2* __restrict__ partial, float2* __restrict__ stats,
                                int n_chunks, int G, double inv_count, float eps) {
  const int b = blockIdx.x;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    double s = 0.0, ss = 0.0;
    for (int c = 0; c < n_chunks; ++c) {
      const float2 v = partial[(static_cast<size_t>(b) * n_chunks + c) * G + g];
      s += v.x;
      ss += v.y;
    }
    const double mean = s * inv_count;
    const double var = fmax(ss * inv_count - mean * mean, 0.0);
    stats[b * G + g] = make_float2(static_cast<float>(mean), rsqrtf(static_cast<float>(var) + eps));
  }
}

template <typename T>
__global__ void gn_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                                const float2* __restrict__ stats, const float* __restrict__ gamma,
                                const float* __restrict__ beta, int HW, int C, int G, int total_vec,
                                int silu) {
  const int lanes = C / 4;
  const int cg = C / G;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total_vec; i += gridDim.x * blockDim.x) {
    const int c = (i % lanes) * 4;
    const int b = i / (HW * lanes);
    const float2 st = stats[b * G + c / cg];
    const float4 ga = *reinterpret_cast<const float4*>(gamma + c);
    const float4 be = *reinterpret_cast<const float4*>(beta + c);
    const float gv[4] = {ga.x, ga.y, ga.z, ga.w};
    const float bv[4] = {be.x, be.y, be.z, be.w};
    float v[4];
    Vec4<T>::load(x + static_cast<size_t>(i) * 4, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float t = (v[k] - st.x) * (st.y * gv[k]) + bv[k];
      if (silu) t = t / (1.f + expf(-t));
      v[k] = t;
    }
    Vec4<T>::store(y + static_cast<size_t>(i) * 4, v);
  }
}

}  // namespace

// x, y: device pointers, channels_last (B, C, H, W), float32 (is_bf16 == 0) or
// bfloat16. gamma, beta: float32 (C,). partial: float32 scratch of
// B * n_chunks * G * 2; stats: float32 scratch of B * G * 2. C and C / G must be
// multiples of 4, C <= 4 * 256. Returns cudaGetLastError() after the launches.
extern "C" int sgmse_group_norm_act(const void* x, void* y, const float* gamma, const float* beta,
                                    void* partial, void* stats, int B, int HW, int C, int G,
                                    int pix_per_chunk, int n_chunks, float eps, int silu,
                                    int is_bf16, void* stream) {
  if (C % 4 != 0 || G < 1 || C % G != 0 || (C / G) % 4 != 0 || C / 4 > kThreads ||
      n_chunks * pix_per_chunk < HW) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* part = static_cast<float2*>(partial);
  float2* st = static_cast<float2*>(stats);
  const dim3 grid1(n_chunks, B);
  const int total_vec = B * HW * (C / 4);
  const int grid3 = grid_for(total_vec, kThreads);
  const double inv_count = 1.0 / (static_cast<double>(HW) * (C / G));
  if (is_bf16) {
    gn_partial_kernel<__nv_bfloat16><<<grid1, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), part, HW, C, G, pix_per_chunk, n_chunks);
  } else {
    gn_partial_kernel<float><<<grid1, kThreads, 0, s>>>(static_cast<const float*>(x), part, HW,
                                                        C, G, pix_per_chunk, n_chunks);
  }
  gn_stats_kernel<<<B, 32, 0, s>>>(part, st, n_chunks, G, inv_count, eps);
  if (is_bf16) {
    gn_apply_kernel<__nv_bfloat16><<<grid3, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), st, gamma, beta,
        HW, C, G, total_vec, silu);
  } else {
    gn_apply_kernel<float><<<grid3, kThreads, 0, s>>>(static_cast<const float*>(x),
                                                      static_cast<float*>(y), st, gamma, beta,
                                                      HW, C, G, total_vec, silu);
  }
  return static_cast<int>(cudaGetLastError());
}
