// What the sunsky adjoint kernels (sunsky_adjoint.cu: K5-K8;
// sunsky_spectral_adjoint.cu: K12, K13) share: the block shape, the
// warp-level sums of the table cotangents (the sun rows' and the sample
// placement's grouped by row, the pdf's gaussian table's by a transposed
// sum whose entries each lane owns), and the second pass that sums the
// blocks' partial rows in a fixed order.
//
// Each adjoint takes two passes. Pass 1 is a grid-stride loop over the
// lanes (one thread per lane at a time; K12/K13 at most kMaxBlocks blocks,
// K5-K8 as many as the SMs hold at once); every thread of a block runs
// the same number of iterations, so warp-level shuffles inside and after
// the loop see all 32 lanes (lanes past n carry zero cotangents). Each
// block writes one partial row of the table cotangents; reduce_partials
// sums the rows in a fixed order. What bounds the pdf's reverse on an
// H100: the 20 gaussian terms a lane (an exp each) and their table
// cotangent's sum over a warp. Summed by butterflies, gaussian by
// gaussian, with IEEE divisions by sigma, it took ~1.5 ms of K8's 2.5 at
// 2M lanes (an NVIDIA H100 80GB HBM3 at 700 W, tools/torch_ab.py rgb_bwd);
// the transposed sums take ~100 shuffles a warp where the butterflies
// took 500, no atomics in the loop, and multiply by 1/sigma (K12 with the
// pdf 1.44 -> 0.61 ms, K13 2.10 -> 1.04, spec_bwd, the same card).
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

// The transposed sum of kM values v over a warp's 32 lanes (all lanes
// call it): recursive halving. At each of the five steps a lane keeps half
// of its values and sends the other half to its partner (lane ^ kOff),
// which keeps the opposite half, and each adds what it receives to what
// it kept; a value count that is odd gains a zero. Each of the kM sums
// ends on one lane, transpose_owner(kM, lane) says which, after about kM
// shuffles where a butterfly sum of every value takes 5 kM. The order of
// the additions is fixed, so the sums are the same from run to run.
template <int kM, int kOff>
struct TransposeSum {
  static __device__ __forceinline__ float run(const float* v) {
    constexpr int kH = (kM + 1) / 2;
    const bool up = (threadIdx.x & kOff) != 0;
    float w[kH];
#pragma unroll
    for (int j = 0; j < kH; ++j) {
      float lo = v[j], hi = j + kH < kM ? v[j + kH] : 0.0f;
      w[j] = (up ? hi : lo) + __shfl_xor_sync(kFull, up ? lo : hi, kOff);
    }
    return TransposeSum<kH, kOff / 2>::run(w);
  }
};

template <int kM>
struct TransposeSum<kM, 0> {
  static __device__ __forceinline__ float run(const float* v) {
    return v[0];
  }
};

template <int kM>
__device__ __forceinline__ float warp_transpose_sum(const float (&v)[kM]) {
  return TransposeSum<kM, 16>::run(v);
}

// Which of warp_transpose_sum's kM sums lane holds: its index, or -1. It
// follows the lane's halves: `size` values, the first `real` of them not
// padding, starting at index `first`.
__device__ __forceinline__ int transpose_owner(int m, int lane) {
  int first = 0, size = m, real = m;
  for (int off = 16; off > 0; off >>= 1) {
    int h = (size + 1) / 2;
    if (lane & off) {
      first += h;
      real -= h;
    } else {
      real = min(real, h);
    }
    size = h;
    if (real <= 0) return -1;
  }
  return first;
}

// The sky pdf's 20 gaussians as the adjoints read them, records gz (mu1,
// 1/sigma1, mu2, 1/sigma2) and amplitudes gamp, staged by thread t of nt
// (K12, K13; K5-K8 read StagedRgb's); the caller syncs the block before
// reading.
__device__ __forceinline__ void stage_gauss(float4* gz, float* gamp,
                                            const float* __restrict__ g,
                                            int t, int nt) {
  for (int i = t; i < tsk::N_GAUSS; i += nt) {
    gz[i] = make_float4(g[tsk::G_MU1 * tsk::N_GAUSS + i],
                        g[tsk::G_INV_S1 * tsk::N_GAUSS + i],
                        g[tsk::G_MU2 * tsk::N_GAUSS + i],
                        g[tsk::G_INV_S2 * tsk::N_GAUSS + i]);
    gamp[i] = g[tsk::G_A * tsk::N_GAUSS + i];
  }
}

// The sky pdf's gaussian sum at each lane's (P.phi_rel, P.theta) and its
// reverse for the sum's cotangent P.g_tg, over the lanes of a warp (all 32
// lanes call it): returns the lane's sum (0 where !P.sky) and adds its
// coordinates' cotangents to *g_phi, *g_theta. Each gaussian term reads
// its staged record (gz, gamp), z = (x - mu) * (1/sigma), the same terms as
// staged_pdf, so no division is left in the loop. The table's cotangents
// [A, mu1, sigma1, mu2, sigma2] of kGaussGroup gaussians at a time (20
// values a lane) are summed over the warp by warp_transpose_sum, and the
// lane adds the one sum it holds to own[group]: it owns that entry
// (gauss_table_warp writes it at the end of the pass). A warp without a
// lane on the gaussians returns at once.
constexpr int kGaussGroup = 4;
constexpr int kGaussGroups = tsk::N_GAUSS / kGaussGroup;
constexpr int kGaussVals = 5 * kGaussGroup;

__device__ __forceinline__ float gauss_vjp_warp(
    const float4* gz, const float* gamp, const tsk::PdfLane& P,
    float* g_phi, float* g_theta, float (&own)[kGaussGroups]) {
  *g_phi = 0.0f;
  *g_theta = 0.0f;
  if (!__any_sync(kFull, P.sky)) return 0.0f;
  float tg = 0.0f;
#pragma unroll 1
  for (int q = 0; q < kGaussGroups; ++q) {
    float v[kGaussVals];
#pragma unroll
    for (int k = 0; k < kGaussGroup; ++k) {
      int i = q * kGaussGroup + k;
      float4 r = gz[i];
      float a = gamp[i];
      float z1 = (P.phi_rel - r.x) * r.y;
      float z2 = (P.theta - r.z) * r.w;
      float e = expf(-0.5f * (z1 * z1 + z2 * z2));
      tg += a * e;
      float gq = -0.5f * (P.g_tg * a * e);   // d/d(z1^2 + z2^2)
      float w1 = gq * 2.0f * z1 * r.y, w2 = gq * 2.0f * z2 * r.w;
      *g_phi += w1;
      *g_theta += w2;
      v[5 * k] = P.g_tg * e;
      v[5 * k + 1] = -w1;
      v[5 * k + 2] = -w1 * z1;
      v[5 * k + 3] = -w2;
      v[5 * k + 4] = -w2 * z2;
    }
    // own[q] += the sum; own rotates, so that it stays in registers
    float sum = own[0] + warp_transpose_sum(v);
#pragma unroll
    for (int j = 0; j + 1 < kGaussGroups; ++j) own[j] = own[j + 1];
    own[kGaussGroups - 1] = sum;
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
// shared atomic (`Add`: plain adds where rows is the warp's own): only the
// block's warps contend for an address. A warp whose lanes have none
// returns at once.
template <int kC, int kK, int kJ, class Add = tsk::AtomicAdd>
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
          Add()(row + lane * kNK * kNJ + q, sum[q]);
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
        Add()(row + e, sum);
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

// K8's and K13's sample placement cotangents of a warp's lanes (place, 8
// floats of gaussian idx; idx -1 for none) added to s_place, the warp's
// own (20, 8) copy, [gaussian][c]: the lanes that picked one gaussian are
// summed in lane order and added once (outer_rows_warp), so no two lanes
// meet on an address and the sums are the same from run to run.
constexpr int kPlaceN = tsk::N_GAUSS * tsk::N_PLACE;

__device__ __forceinline__ void place_rows_warp(
    int idx, const float (&place)[tsk::N_PLACE], float* s_rec,
    float* s_place) {
  outer_rows_warp<tsk::N_PLACE, 0, 0, tsk::PlainAdd>(
      idx >= 0, idx, place, nullptr, nullptr, s_rec, s_place, tsk::N_PLACE);
}

// At the end of pass 1, the warp's gaussian table cotangent (14, 20) into
// g_w (kGaussN floats of shared memory the warp owns; all 32 lanes call
// it): the pdf's entries each lane owns (own, from gauss_vjp_warp), plus
// the placement copy s_place unless it is null.
__device__ __forceinline__ void gauss_table_warp(
    const float (&own)[kGaussGroups], const float* s_place, float* g_w) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int j = lane; j < kGaussN; j += 32) g_w[j] = 0.0f;
  __syncwarp();
  const int e = transpose_owner(kGaussVals, lane);
  if (e >= 0) {
    // [A, mu1, sigma1, mu2, sigma2] of gaussian q * kGaussGroup + e / 5
    const int r = e % 5, row = r == 0 ? tsk::G_A : tsk::place_row(r - 1);
#pragma unroll
    for (int q = 0; q < kGaussGroups; ++q)
      g_w[row * tsk::N_GAUSS + q * kGaussGroup + e / 5] = own[q];
  }
  if (s_place != nullptr) {
    __syncwarp();
    for (int j = lane; j < kPlaceN; j += 32)
      g_w[tsk::place_row(j % tsk::N_PLACE) * tsk::N_GAUSS
          + j / tsk::N_PLACE] += s_place[j];
  }
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
// fixed order: over the warp by shuffles into s (kWarps rows of `stride`),
// then over the warps by the caller (warps_sum) after a __syncthreads.
template <int kN>
__device__ __forceinline__ void warp_partials(const float* acc, float* s,
                                              int stride = kN) {
  bool lane0 = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    float v = warp_sum(acc[k]);
    if (lane0) s[(threadIdx.x >> 5) * stride + k] = v;
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
