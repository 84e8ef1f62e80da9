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
// and dy and writing dx, so the least traffic is three passes over the tensor:
// 1.5 GiB at 256 x 256 x 256 channels and 96 MiB at 128 x 128 x 128 (B = 8,
// float32). But dx needs the sums of its whole (b, group) first, and a kernel
// that sums, then reads x and dy again, makes five passes wherever the second
// read misses L2 (2.5 GiB and 160 MiB at those two calls).
//
// The design: one cooperative launch of at most one block per SM, which keeps
// x and dy on chip between the sums and dx.
//   - Tiles. A tile is one batch row's band of channels over all its pixels.
//     A band is a run of whole groups at least 128 bytes wide where C allows
//     (32 float32 or 64 bfloat16 channels at C = 128, 256 and 512, 48 or 96 at
//     384), so each pixel's slice of a band is whole cache lines of the
//     channels_last tensor, and a tile holds every pixel its groups sum over.
//   - Waves. The host plans (ops/group_norm.py: bwd_plan) how many tiles run
//     side by side (a wave: all SMs' shared memory, ~28 MB, plus up to 12 MiB
//     that L2 keeps) and over how many blocks each tile spreads. Per wave,
//     each block
//       1. copies its pixel range of x and dy into shared memory with cp.async,
//          every copy in flight at once, in two groups, and sums S1, S2, S3
//          per channel from each group as it lands; float32 overwrites x and
//          dy with x^ and dv, so that dx costs a few flops. What does not fit
//          (the tail) is read through registers, and read again for dx, from
//          L2 where it is still there;
//       2. reduces its sums over its pixel rows (warp shuffles, then the warps
//          in order) into a per-block partial;
//       3. where a tile spreads over several blocks, counts itself in on the
//          tile's counter; the last block to arrive combines the tile's
//          partials in a fixed order, writes the group coefficients, the row's
//          dbias and the tile's sums, and raises the tile's flag, which the
//          others wait on. Tiles do not wait for each other;
//       4. asks L2 for the start of its next wave's range (prefetch), which
//          device memory fetches while this wave writes dx and the next wave
//          begins (asked earlier, it slows the blocks still reading), and
//          writes dx from shared memory.
//     The next wave's copies refill the same shared memory: each thread reads
//     back only the slots it copied itself. After the last wave, a grid.sync,
//     and dgamma and dbeta are summed over b in order. No atomics in the sums:
//     the results repeat bit for bit.
//   - Traffic from device memory: x and dy read once, dx written once, plus
//     O(B * C) of sums, as long as L2 keeps the tails and the prefetched
//     lines until they are read. 256 x 256 x 256 float32: 32 waves of two 16
//     MiB tiles, each block holding 873 of its 993 pixels (4 MB of tails a
//     wave); 128 x 128 x 128: 4 waves of 8 tiles of 4 MiB.
//   - Calls whose tiles fit a block each (16 x 16 and under at B = 8) need no
//     counters: one wave, and the grid.sync for dgamma and dbeta.
// What holds it from the bound: the device memory idles while the blocks of
// a tile wait for the slowest of them, the last one combines and the flag
// travels, a few microseconds a wave, and the blocks' reads land unevenly.
// A tile larger than all of shared memory and the L2 share (C = 128 at 768 x
// 256, the 48 kHz network's top level) takes every SM and reads its tails
// twice, the second time mostly from device memory.
// A block that cannot be co-resident makes cudaLaunchCooperativeKernel fail;
// the wrapper raises.
#include <cooperative_groups.h>

#include "vec.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
// int32 per tile of a wave in `sync`: its counter and, a cache line away, its
// flag, so that the blocks polling the flag do not slow the arrivals.
constexpr int kSyncStride = 64;

// 16-byte loads in flight per thread and tensor on the unstaged tail.
constexpr int kTailUnroll = 2;

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
  float4* partial;      // (grid, band) per block: (S1, S2, S3, 0)
  float4* rowsum;       // (B, C) per batch row: (S1, S2, S3, 0)
  float4* coefs;        // (waves, tpw, groups per band) a tile's group coefficients
  int* sync;            // (waves, tpw, kSyncStride) a tile's count of arrived blocks, its flag
  int B, HW, C, G;
  int band;       // channels per band
  int nbt;        // blocks per tile
  int ppb;        // pixels per block
  int stage_pix;  // pixels of a block's range held in shared memory
  int pf_pix;     // pixels of a block's next range prefetched into L2
  int tpw;        // tiles per wave
  int waves;
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

// dL/dv from dL/dy: through the SiLU when there is one (the hardware exp2 and
// reciprocal, as K2's SiLU).
__device__ __forceinline__ float dv_of(float dy, float xh, float gamma, float beta, int silu) {
  if (!silu) return dy;
  const float v = fmaf(gamma, xh, beta);
  const float s = __fdividef(1.f, 1.f + __expf(-v));
  return dy * s * (1.f + v * (1.f - s));
}

// The tiles' counters and flags, at gpu scope: a block's threads store its
// partials, meet at a barrier, and one thread counts the block in (release); the
// count's last taker (acquire) then reads them all. Its flag is raised the same way.
__device__ __forceinline__ int arrive(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(p) : "memory");
  return old;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Threads per pixel row of a block: the band's 16-byte vectors rounded up to a
// power of two (a whole warp's divisor, so a warp holds whole rows) or to whole
// warps.
__host__ __device__ inline int lane_stride(int lanes) {
  if (lanes > 32) return (lanes + 31) / 32 * 32;
  int s = 1;
  while (s < lanes) s *= 2;
  return s;
}

// Float4 slots of the block reduction: per warp (or per row, where a row is
// whole warps) and band channel.
__host__ __device__ inline int red_slots(int band, int elem) {
  const int ls = lane_stride(band * elem / 16);
  return (ls <= 32 ? kThreads / 32 : kThreads / ls) * band;
}

// Dynamic shared memory of a block, in this order: x and dy of stage_pix pixels
// of a band; the reduction slots; the sums (float4 per channel); the group
// coefficients (float4 per group); gamma of the band; the groups' variances; a flag.
// ops/group_norm.py (bwd_smem_bytes) reckons the same.
__host__ __device__ inline size_t smem_bytes(int stage_pix, int band, int groups_per_band,
                                             int elem) {
  return 2 * static_cast<size_t>(stage_pix) * band * elem +
         static_cast<size_t>(red_slots(band, elem)) * sizeof(float4) + band * sizeof(float4) +
         groups_per_band * sizeof(float4) + band * sizeof(float) +
         groups_per_band * sizeof(float) + sizeof(int);
}

__device__ __forceinline__ void add3(float4& s, const float4& t) {
  s.x += t.x;
  s.y += t.y;
  s.z += t.z;
}

// Threads per channel for a sum over many terms: a power of two that fits a
// warp and the block's threads over the band's channels.
__device__ __forceinline__ int threads_per_channel(int band) {
  int nq = 1;
  while (nq < 32 && 2 * nq * band <= kThreads) nq *= 2;
  return nq;
}

// Sum of a float4 over the nq consecutive lanes of a channel (a fixed order).
__device__ __forceinline__ float4 lane_sum(float4 s, int nq) {
  for (int off = 1; off < nq; off *= 2) {
    s.x += __shfl_xor_sync(0xffffffffu, s.x, off);
    s.y += __shfl_xor_sync(0xffffffffu, s.y, off);
    s.z += __shfl_xor_sync(0xffffffffu, s.z, off);
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) gn_bwd_kernel(const BwdArgs a) {
  using V = Vec16<T>;
  constexpr int N = V::N;
  constexpr int U = kTailUnroll;
  // float32 stages x^ and dv in place of x and dy (the same 16 bytes), so dx
  // costs a few flops; bfloat16 would need twice the room, and recomputes them.
  constexpr bool kDerived = sizeof(T) == sizeof(float);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int band = a.band;
  const int lanes = band / N;  // 16-byte vectors per pixel of the band
  const int ls = lane_stride(lanes);
  const int sweep = kThreads / ls;  // pixel rows per sweep of the block
  const int lane = tid % ls;
  const int poff = tid / ls;
  const bool active = lane < lanes && poff < sweep;
  const int vpp = a.C / N;  // 16-byte vectors per pixel of the tensor
  const int cpg = a.C / a.G;
  const int gpb = band / cpg;
  const int nbands = a.C / band;
  const int ntiles = a.B * nbands;
  const int slot = blockIdx.x / a.nbt;  // the block's tile within a wave
  const int j = blockIdx.x % a.nbt;     // its pixel range within the tile
  const int p0 = j * a.ppb;
  const int p1 = min(p0 + a.ppb, a.HW);
  const int pst = min(p1, p0 + a.stage_pix);  // [p0, pst) is staged
  const int ppf = min(p1, p0 + a.pf_pix);     // [p0, ppf) of the next range is prefetched
  const int nst = a.stage_pix * lanes;
  const int nq = threads_per_channel(band);
  const int qc = tid / nq;  // the channel and share of a thread in the sums over rows
  const int qq = tid % nq;

  uint4* sx = reinterpret_cast<uint4*>(smem);
  uint4* sdy = sx + nst;
  float4* red = reinterpret_cast<float4*>(sdy + nst);
  float4* tsum = red + red_slots(band, sizeof(T));
  float4* coef = tsum + band;  // per group: mean_grp(g), f * mean_grp(g x^), rstd
  float* sgam = reinterpret_cast<float*>(coef + gpb);
  float* sgvar = sgam + band;  // per group: the variance before the clamp
  int* last = reinterpret_cast<int*>(sgvar + gpb);  // this block completes its tile
  cg::grid_group grid = cg::this_grid();

  // The tiles' counters and flags start at 0 in every call.
  if (a.nbt > 1) {
    const int n = kSyncStride * a.waves * a.tpw;
    for (int i = blockIdx.x * kThreads + tid; i < n; i += gridDim.x * kThreads) {
      a.sync[i] = 0;
    }
    grid.sync();
  }

  for (int w = 0; w < a.waves; ++w) {
    const int tile = w * a.tpw + slot;
    const bool mine = tile < ntiles;  // the last wave may hold fewer tiles
    const int b = mine ? tile / nbands : 0;
    const int c0 = (tile % nbands) * band;
    const size_t row = static_cast<size_t>(b) * a.HW * vpp + c0 / N + lane;
    const uint4* xb = reinterpret_cast<const uint4*>(a.x) + row;
    const uint4* gyb = reinterpret_cast<const uint4*>(a.dy) + row;

    // 1. Ask for the staged part of the range, in two groups of cp.async
    // copies, all in flight at once.
    const int nslots =
        mine && active && pst - p0 > poff ? (pst - p0 - poff - 1) / sweep + 1 : 0;
    if (nslots > 0) {
      const int half = nslots / 2;
      for (int i = 0; i < nslots; ++i) {
        if (i == half) cp_async_commit();
        const int p = p0 + poff + i * sweep;
        cp_async16(&sx[(p - p0) * lanes + lane], xb + static_cast<size_t>(p) * vpp);
        cp_async16(&sdy[(p - p0) * lanes + lane], gyb + static_cast<size_t>(p) * vpp);
      }
    }
    cp_async_commit();
    // Meanwhile, the per-channel constants: x^ = x * rstd + shift with
    // shift = (bias - mean) * rstd; the group's variance for the coefficients.
    float rstd[N], shift[N], gamma[N], beta[N], s1[N], s2[N], s3[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      s1[k] = s2[k] = s3[k] = 0.f;
      rstd[k] = shift[k] = gamma[k] = beta[k] = 0.f;
      if (!active) continue;
      const int c = c0 + lane * N + k;
      const float2 st = a.stats[static_cast<size_t>(b) * a.G + c / cpg];
      const float bias = a.bias ? static_cast<float>(static_cast<const T*>(
                                      a.bias)[static_cast<size_t>(b) * a.C + c])
                                : 0.f;
      rstd[k] = rstd_of(st.y, a.eps);
      shift[k] = (bias - st.x) * rstd[k];
      gamma[k] = a.gamma[c];
      beta[k] = a.beta[c];
    }
    const float gvar =
        tid < gpb ? a.stats[static_cast<size_t>(b) * a.G + c0 / cpg + tid].y : 0.f;
    auto accumulate = [&](const uint4& rx, const uint4& rg, float* xh, float* dv) {
      float xv[N], gv[N];
      V::unpack(rx, xv);
      V::unpack(rg, gv);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        xh[k] = fmaf(xv[k], rstd[k], shift[k]);
        dv[k] = dv_of(gv[k], xh[k], gamma[k], beta[k], a.silu);
        s1[k] += dv[k];
        s2[k] = fmaf(dv[k], xh[k], s2[k]);
        s3[k] += xh[k];
      }
    };
    // Sum each group of the staged part as it lands (float32 keeps x^ and dv
    // in its place); then the tail through registers.
    auto sum_staged = [&](int i0, int i1) {
      for (int i = i0; i < i1; ++i) {
        const int s = (i * sweep + poff) * lanes + lane;
        float xh[N], dv[N];
        accumulate(sx[s], sdy[s], xh, dv);
        if constexpr (kDerived) {
          sx[s] = Vec16<float>::pack(xh);
          sdy[s] = Vec16<float>::pack(dv);
        }
      }
    };
    cp_async_wait_group<1>();
    sum_staged(0, nslots / 2);
    cp_async_wait_group<0>();
    sum_staged(nslots / 2, nslots);
    if (mine && active) {
      for (int p = pst + poff; p < p1; p += U * sweep) {
        uint4 rx[U], rg[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int q = p + u * sweep;
          if (q < p1) {
            rx[u] = __ldg(xb + static_cast<size_t>(q) * vpp);
            rg[u] = __ldg(gyb + static_cast<size_t>(q) * vpp);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float xh[N], dv[N];
          if (p + u * sweep < p1) accumulate(rx[u], rg[u], xh, dv);
        }
      }
    }
    // 2. The block's sums per channel of the band: over the pixel rows of each
    // warp by shuffles, then over the warps, nq threads per channel.
#pragma unroll
    for (int k = 0; k < N; ++k) {
      for (int off = ls; off < 32; off *= 2) {
        s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], off);
        s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], off);
        s3[k] += __shfl_xor_sync(0xffffffffu, s3[k], off);
      }
    }
    const int rrow = ls <= 32 ? tid / 32 : poff;
    const int rrows = ls <= 32 ? kThreads / 32 : sweep;
    if (active && (ls > 32 || tid % 32 < ls)) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        red[rrow * band + lane * N + k] = make_float4(s1[k], s2[k], s3[k], 0.f);
      }
    }
    __syncthreads();  // also: every thread is done with the last wave's sgam and sgvar
    if (active && poff == 0) {
#pragma unroll
      for (int k = 0; k < N; ++k) sgam[lane * N + k] = gamma[k];
    }
    if (tid < gpb) sgvar[tid] = gvar;
    {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      if (qc < band) {
        for (int r = qq; r < rrows; r += nq) add3(s, red[r * band + qc]);
      }
      s = lane_sum(s, nq);
      if (qc < band && qq == 0) tsum[qc] = s;
    }

    // 3. The tile's sums. A block that holds its tile has them. Otherwise each
    // block writes its partials and counts itself in; the last block of the
    // tile to arrive combines the tile's partials in a fixed order, writes the
    // group coefficients, dbias and the tile's sums, and raises the tile's
    // flag, on which the others wait for the coefficients.
    const float inv_n = 1.f / (static_cast<float>(a.HW) * cpg);
    auto finish = [&]() {  // from the tile's sums in tsum
      __syncthreads();
      if (tid < gpb) {
        float sa = 0.f, sb = 0.f;
        for (int c = tid * cpg; c < (tid + 1) * cpg; ++c) {
          sa = fmaf(sgam[c], tsum[c].x, sa);
          sb = fmaf(sgam[c], tsum[c].y, sb);
        }
        const float var = sgvar[tid];
        const float f = var > 0.f ? 1.f : (var == 0.f ? 0.5f : 0.f);
        coef[tid] = make_float4(sa * inv_n, f * sb * inv_n, rstd_of(var, a.eps), 0.f);
      }
      __syncthreads();
      for (int c = tid; c < band; c += kThreads) {
        const size_t bc = static_cast<size_t>(b) * a.C + c0 + c;
        const float4 t = tsum[c];
        a.rowsum[bc] = t;
        if (a.dbias) {
          const float4 cf = coef[c / cpg];
          const float d = cf.z * (sgam[c] * t.x - static_cast<float>(a.HW) * cf.x - cf.y * t.z);
          static_cast<T*>(a.dbias)[bc] = from_float<T>(d);
        }
      }
    };
    if (a.nbt == 1) {
      if (mine) finish();
    } else if (mine) {
      const int ws = w * a.tpw + slot;  // this wave's tile slot: its counter, flag, coefficients
      float4* part = a.partial + static_cast<size_t>(slot) * a.nbt * band;
      if (qc < band && qq == 0) part[static_cast<size_t>(j) * band + qc] = tsum[qc];
      __syncthreads();
      if (tid == 0) *last = arrive(a.sync + kSyncStride * ws) == a.nbt - 1;
      __syncthreads();
      if (*last) {
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (qc < band) {
#pragma unroll 8
          for (int jj = qq; jj < a.nbt; jj += nq) {
            add3(t, __ldcg(part + static_cast<size_t>(jj) * band + qc));
          }
        }
        t = lane_sum(t, nq);
        if (qc < band && qq == 0) tsum[qc] = t;
        finish();
        if (tid < gpb) a.coefs[static_cast<size_t>(ws) * gpb + tid] = coef[tid];
        __syncthreads();
        if (tid == 0) store_release(a.sync + kSyncStride * ws + kSyncStride / 2, 1);
      } else {
        if (tid == 0) {
          while (load_acquire(a.sync + kSyncStride * ws + kSyncStride / 2) == 0) __nanosleep(64);
        }
        __syncthreads();
        if (tid < gpb) coef[tid] = __ldcg(a.coefs + static_cast<size_t>(ws) * gpb + tid);
      }
    }
    __syncthreads();
    if (!mine) continue;

    // 4. Ask L2 for the start of the next wave's range, which device memory
    // fetches while this wave writes dx and the next one begins. Then dx
    // from shared memory (the tail from device memory again).
    const int next = tile + a.tpw;
    if (next < ntiles && active) {
      const size_t nrow = static_cast<size_t>(next / nbands) * a.HW * vpp +
                          (next % nbands) * band / N + lane;
      for (int p = p0 + poff; p < ppf; p += sweep) {
        prefetch_l2(reinterpret_cast<const uint4*>(a.x) + nrow + static_cast<size_t>(p) * vpp);
        prefetch_l2(reinterpret_cast<const uint4*>(a.dy) + nrow + static_cast<size_t>(p) * vpp);
      }
    }
    if (!active) continue;
    float ga[N], gb[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float4 cf = coef[(lane * N + k) / cpg];
      ga[k] = cf.x;
      gb[k] = cf.y;
    }
    auto dx_of = [&](const float* xh, const float* dv) {
      float d[N];
#pragma unroll
      for (int k = 0; k < N; ++k) d[k] = rstd[k] * (fmaf(gamma[k], dv[k], -ga[k]) - xh[k] * gb[k]);
      return V::pack(d);
    };
    auto grad = [&](const uint4& rx, const uint4& rg) {
      float xv[N], gv[N], xh[N], dv[N];
      V::unpack(rx, xv);
      V::unpack(rg, gv);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        xh[k] = fmaf(xv[k], rstd[k], shift[k]);
        dv[k] = dv_of(gv[k], xh[k], gamma[k], beta[k], a.silu);
      }
      return dx_of(xh, dv);
    };
    uint4* dxb = reinterpret_cast<uint4*>(a.dx) + row;
    for (int p = p0 + poff; p < pst; p += sweep) {
      const int i = (p - p0) * lanes + lane;
      uint4 d;
      if constexpr (kDerived) {
        float xh[N], dv[N];
        Vec16<float>::unpack(sx[i], xh);
        Vec16<float>::unpack(sdy[i], dv);
        d = dx_of(xh, dv);
      } else {
        d = grad(sx[i], sdy[i]);
      }
      __stcs(dxb + static_cast<size_t>(p) * vpp, d);
    }
    for (int p = pst + poff; p < p1; p += U * sweep) {
      uint4 rx[U], rg[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = p + u * sweep;
        if (q < p1) {
          rx[u] = __ldcg(xb + static_cast<size_t>(q) * vpp);
          rg[u] = __ldcg(gyb + static_cast<size_t>(q) * vpp);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = p + u * sweep;
        if (q < p1) __stcs(dxb + static_cast<size_t>(q) * vpp, grad(rx[u], rg[u]));
      }
    }
  }

  // dgamma and dbeta: the tiles' sums over b, in order.
  grid.sync();
  for (int c = blockIdx.x * kThreads + tid; c < a.C; c += gridDim.x * kThreads) {
    float dg = 0.f, db = 0.f;
#pragma unroll 8
    for (int bb = 0; bb < a.B; ++bb) {
      const float4 r = __ldcg(a.rowsum + static_cast<size_t>(bb) * a.C + c);
      dg += r.y;
      db += r.x;
    }
    a.dgamma[c] = dg;
    a.dbeta[c] = db;
  }
}

template <typename T>
cudaError_t launch(const BwdArgs& args, cudaStream_t stream) {
  static const SmemOptIn opt_in = opt_in_dynamic_smem(gn_bwd_kernel<T>);
  if (opt_in.err != cudaSuccess) return opt_in.err;
  const int smem_limit = opt_in.limit;
  const size_t smem =
      smem_bytes(args.stage_pix, args.band, args.band / (args.C / args.G), sizeof(T));
  if (smem > static_cast<size_t>(smem_limit)) return cudaErrorInvalidValue;
  BwdArgs a = args;
  void* params[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gn_bwd_kernel<T>),
                                     dim3(a.tpw * a.nbt), dim3(kThreads), params, smem, stream);
}

}  // namespace

// dy, x, dx: device pointers, channels_last (B, C, H, W), one dtype, float32
// (is_bf16 == 0) or bfloat16, 16-byte aligned. gamma, beta: float32 (C,).
// bias: (B, C) in x's dtype, or null; dbias the same shape out, or null.
// stats: float32 (B, G, 2), the forward's (mean, unclamped variance).
// dgamma, dbeta: float32 (C,) out. Scratch: partial, float32 of tpw * nbt *
// band * 4; rowsum, float32 of B * C * 4; coefs, float32 of waves * tpw *
// (band / (C / G)) * 4; sync, int32 of waves * tpw * 64.
// The plan (band, nbt, ppb, stage_pix, pf_pix, tpw, waves) comes from the
// wrapper's bwd_plan: band a multiple of C/G and of the 16-byte vector dividing
// C, at most kThreads channels; nbt * ppb >= HW; pf_pix <= stage_pix <= ppb;
// tpw * waves tiles at least B * C / band; tpw * nbt blocks co-resident.
// Returns the launch's error code.
extern "C" int sgmse_group_norm_act_bwd(const void* dy, const void* x, void* dx,
                                        const float* gamma, const float* beta, const void* bias,
                                        const float* stats, void* dbias, float* dgamma,
                                        float* dbeta, void* partial, void* rowsum, void* coefs,
                                        void* sync, int B, int HW,
                                        int C, int G, int band, int nbt, int ppb, int stage_pix,
                                        int pf_pix, int tpw, int waves, float eps, int silu,
                                        int is_bf16,
                                        void* stream) {
  const int n = is_bf16 ? 8 : 4;
  if (B < 1 || HW < 1 || G < 1 || C % G != 0 || band < n || band > kThreads || band % n != 0 ||
      C % band != 0 || band % (C / G) != 0 || nbt < 1 || ppb < 1 ||
      static_cast<long long>(nbt) * ppb < HW || stage_pix < 1 || stage_pix > ppb ||
      pf_pix < 0 || pf_pix > ppb || tpw < 1 ||
      waves < 1 || static_cast<long long>(tpw) * waves < static_cast<long long>(B) * (C / band)) {
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
            static_cast<float4*>(coefs),
            static_cast<int*>(sync),
            B,
            HW,
            C,
            G,
            band,
            nbt,
            ppb,
            stage_pix,
            pf_pix,
            tpw,
            waves,
            eps,
            silu};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(a, st) : launch<float>(a, st);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
