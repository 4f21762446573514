// What the sunsky adjoint kernels (sunsky_adjoint.cu: K5-K8;
// sunsky_spectral_adjoint.cu: K12, K13) share: the block shape, the
// warp-level sum of the sky pdf's gaussian table cotangent, and the second
// pass that sums the blocks' partial rows in a fixed order.
//
// Each adjoint takes two passes. Pass 1 is a grid-stride loop over the
// lanes (one thread per lane at a time, at most kMaxBlocks blocks); every
// thread of a block runs the same number of iterations, so warp-level
// shuffles inside and after the loop see all 32 lanes (lanes past n carry
// zero cotangents). Each block writes one partial row of the table
// cotangents; reduce_partials sums the rows in a fixed order.
#pragma once

#include "sunsky_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGaussN = 14 * tsk::N_GAUSS;       // the (14, 20) table

int adjoint_rows(int n) {
  int blocks = (n + kThreads - 1) / kThreads;
  return blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

// v summed over the warp's 32 lanes, the same total on every lane (a
// butterfly: a fixed order of additions)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The sky pdf's gaussian sum over the lanes of a warp (all 32 lanes call
// it): returns each lane's sum and adds its coordinates' cotangents to
// *g_phi, *g_theta. Every lane with a cotangent touches all 20 gaussians,
// five table entries each, so the table's cotangent is summed over the
// warp by shuffles, gaussian by gaussian, and lane 0 adds the sums to
// s_gauss, the warp's own copy of the table: no two lanes contend for an
// entry.
__device__ __forceinline__ float gauss_sum_vjp_warp(
    const float* __restrict__ gauss, const tsk::PdfLane& P, float* g_phi,
    float* g_theta, float* s_gauss) {
  *g_phi = 0.0f;
  *g_theta = 0.0f;
  if (!__any_sync(kFull, P.sky)) return 0.0f;
  bool lane0 = (threadIdx.x & 31) == 0;
  float tg = 0.0f;
  for (int i = 0; i < tsk::N_GAUSS; ++i) {
    float out[5];
    tg += tsk::gauss_term_vjp(gauss, i, P.phi_rel, P.theta, P.g_tg, g_phi,
                              g_theta, out);
#pragma unroll
    for (int k = 0; k < 5; ++k) out[k] = warp_sum(out[k]);
    if (lane0) {
      atomicAdd(s_gauss + tsk::G_A * tsk::N_GAUSS + i, out[0]);
      atomicAdd(s_gauss + tsk::G_MU1 * tsk::N_GAUSS + i, out[1]);
      atomicAdd(s_gauss + tsk::G_S1 * tsk::N_GAUSS + i, out[2]);
      atomicAdd(s_gauss + tsk::G_MU2 * tsk::N_GAUSS + i, out[3]);
      atomicAdd(s_gauss + tsk::G_S2 * tsk::N_GAUSS + i, out[4]);
    }
  }
  return P.sky ? tg : 0.0f;
}

// A cotangent of a warp's lanes that is, on each lane, an outer product
// g[c] * (a[k] * b[j]) on one row `key` of a table in shared memory
// (entry (c * kNK + k) * kNJ + j; kK or kJ 0 for an absent factor, whose
// count kNK or kNJ is then 1), added to that row (all 32 lanes call it;
// has false on a lane without one). A warp's lanes often share a row
// (K6's and K13's sun-cone samples all do), so adding them lane by lane
// would put up to 32 shared atomics on each address. Instead the lanes are
// grouped by row (__match_any_sync) and stage their kC + kK + kJ floats
// in s_rec (the warp's 32 records); for each group lane l sums entries l,
// l + 32, ... (or, where a row of g has at most 8 entries, lane c those
// of g[c]) over the group's lanes in lane order and adds each with one
// shared atomic: only the block's warps contend for an address. A warp
// whose lanes have none returns at once.
template <int kC, int kK, int kJ>
__device__ __forceinline__ void outer_rows_warp(bool has, int key,
                                                const float* g,
                                                const float* a,
                                                const float* b, float* s_rec,
                                                float* rows, int row_len) {
  constexpr int kRec = kC + kK + kJ;
  constexpr int kNK = kK > 0 ? kK : 1, kNJ = kJ > 0 ? kJ : 1;
  unsigned todo = __ballot_sync(kFull, has);
  if (todo == 0u) return;
  int lane = threadIdx.x & 31;
  unsigned same = __match_any_sync(kFull, has ? key : -1);
  float* mine = s_rec + lane * kRec;
#pragma unroll
  for (int c = 0; c < kC; ++c) mine[c] = g[c];
#pragma unroll
  for (int k = 0; k < kK; ++k) mine[kC + k] = a[k];
#pragma unroll
  for (int j = 0; j < kJ; ++j) mine[kC + kK + j] = b[j];
  __syncwarp();
  while (todo != 0u) {
    int leader = __ffs(todo) - 1;
    unsigned group = __shfl_sync(kFull, same, leader);
    float* row = rows + __shfl_sync(kFull, key, leader) * row_len;
    if constexpr (kC <= 32 && kNK * kNJ <= 8) {
      // few entries a row of g: lane c sums all of them, reading each
      // record's g[c] once
      if (lane < kC) {
        float sum[kNK * kNJ];
#pragma unroll
        for (int q = 0; q < kNK * kNJ; ++q) sum[q] = 0.0f;
        for (unsigned m = group; m != 0u; m &= m - 1) {
          const float* rec = s_rec + (__ffs(m) - 1) * kRec;
          float gc = rec[lane];
#pragma unroll
          for (int k = 0; k < kNK; ++k)
#pragma unroll
            for (int j = 0; j < kNJ; ++j) {
              float ak = kK > 0 ? rec[kC + k] : 1.0f;
              float bj = kJ > 0 ? rec[kC + kK + j] : 1.0f;
              sum[k * kNJ + j] += gc * (ak * bj);
            }
        }
#pragma unroll
        for (int q = 0; q < kNK * kNJ; ++q)
          atomicAdd(row + lane * kNK * kNJ + q, sum[q]);
      }
    } else {
      for (int e = lane; e < kC * kNK * kNJ; e += 32) {
        int c = e / (kNK * kNJ), k = (e / kNJ) % kNK, j = e % kNJ;
        float sum = 0.0f;
        for (unsigned m = group; m != 0u; m &= m - 1) {
          const float* rec = s_rec + (__ffs(m) - 1) * kRec;
          float ak = kK > 0 ? rec[kC + k] : 1.0f;
          float bj = kJ > 0 ? rec[kC + kK + j] : 1.0f;
          sum += rec[c] * (ak * bj);
        }
        atomicAdd(row + e, sum);
      }
    }
    todo &= ~group;
  }
  __syncwarp();   // the records are read before the next call writes them
}

// The RGB sun table's cotangent of a warp's lanes, added to s_sun (45, 72),
// the block's copy: a lane's is g[ch] * (xp[k] * cp[j]) on its row
// (tsk::SunCot), staged in s_rec (the warp's 32 x kSunRec floats).
constexpr int kSunRec = 3 + 4 + tsk::N_LD;

__device__ __forceinline__ void sun_row_warp(const tsk::SunCot& sc,
                                             float* s_rec, float* s_sun) {
  bool has = sc.g[0] != 0.0f || sc.g[1] != 0.0f || sc.g[2] != 0.0f;
  outer_rows_warp<3, 4, tsk::N_LD>(has, sc.pos, sc.g, sc.xp, sc.cp, s_rec,
                                   s_sun, tsk::SUN_F);
}

// The sum of the warps' copies w of a shared table, entry j, in warp order.
__device__ __forceinline__ float warps_sum(const float* s, int stride,
                                           int j) {
  float v = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v += s[w * stride + j];
  return v;
}

// Each thread's per-lane sums acc[k], k < kN, summed over the block in a
// fixed order: over the warp by shuffles into s (kWarps x kN), then over
// the warps by the caller (warps_sum) after a __syncthreads.
template <int kN>
__device__ __forceinline__ void warp_partials(const float* acc, float* s) {
  bool lane0 = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    float v = warp_sum(acc[k]);
    if (lane0) s[(threadIdx.x >> 5) * kN + k] = v;
  }
}

// out[j] = sum over rows b of partial[b, j], rows of `cols` floats, in a
// fixed order: 32 columns a block, warp w sums rows w, w + 8, ... and the 8
// warp sums are added in warp order.
__global__ void __launch_bounds__(kThreads)
reduce_partials(const float* __restrict__ partial, int rows, int cols,
                float* __restrict__ out) {
  __shared__ float s[kWarps][32];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int j = blockIdx.x * 32 + lane;
  float v = 0.0f;
  if (j < cols)
    for (int b = warp; b < rows; b += kWarps)
      v += partial[(size_t)b * cols + j];
  s[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && j < cols) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += s[w][lane];
    out[j] = t;
  }
}

// After pass 1: its launch error, else launch pass 2 and return its error.
int finish(const float* partial, int rows, int cols, float* out,
           cudaStream_t stream) {
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  reduce_partials<<<(cols + 31) / 32, kThreads, 0, stream>>>(partial, rows,
                                                             cols, out);
  return (int)cudaGetLastError();
}

}  // namespace
