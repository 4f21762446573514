// Sunsky emitter kernels K1-K3 for sm_90a.
//
// K1 sunsky_eval_rgb  replaces tpusky/ops/pallas/sunsky_kernel.py:
//                     sunsky_eval_rgb_pallas (_sunsky_rgb_kernel)
// K2 sunsky_hit_rgb   replaces sunsky_kernel.py:sunsky_hit_rgb_pallas
//                     (_hit_kernel): radiance + mixture pdf
// K3 sunsky_nee_rgb   replaces sunsky_kernel.py:sunsky_nee_rgb_pallas
//                     (_nee_kernel): sample + radiance + pdf
//
// What bounds them on an H100: arithmetic, mostly special functions
// (K1 ~12 a lane: three sky formulas with two expf, a division and a
// sqrt each, the sun's angle; K2 adds atan2, asin and the 20 exps of the
// gaussian mixture; K3 adds erfinv/erf/exp or the cone map), against
// 24-36 bytes of I/O a lane (K1 12 in + 12 out, K2 12 + 16, K3 8 + 28).
// At 2M lanes that is under 80 MB, ~20 us of HBM time (K1's bytes
// bound it, K2's and K3's operations). So the design spends no
// instruction a lane does not need (the spectral kernels' findings,
// csrc/sunsky_spectral.cu):
// - a grid of as many 256-thread blocks as the SMs hold at once walks the
//   lanes (grid-stride); each block stages the small tables in shared
//   memory once (sunsky_staged.cuh: StagedRgb, 1.7 KB): the sky rows as
//   float4s, misc, and for K2/K3 the pdf's 20 gaussians as float4
//   records with 1/sigma in place of two divisions each, read as
//   broadcasts; the sun table (45, 72), which only disc lanes read,
//   stays in global memory (a warp's disc lanes share its row; staged,
//   it took ~0.004 ms off K1's all-disc lanes, made K2 spill, and would
//   take K3 past 48 KB of static shared memory);
// - the sun's segment and limb geometry (acos, cbrt, sin, a division, a
//   sqrt) is computed only in its disc, the sun polynomial's 24 products
//   once for the three channels, and the three sky formulas' divisions by
//   cos theta + 0.01 take one reciprocal and a remainder each (div_by:
//   the division's value, bitwise);
// - K3 ranks each warp's 128 lanes by strategy (rank_by_strategy, as
//   K11): its sky samples run in passes apart from its sun-cone samples,
//   so a pass pays one sample branch and, without cone samples, no disc.
//   Each lane's inputs and outputs pass through the warp's slots in
//   shared memory; no block barrier couples the warps.
// Radiance and directions are the global-memory design's bitwise
// (K5-K8 redraw K3's samples from the global tables); the pdf moves by
// the 1/sigma products, within ~1e-6.
// At 2M lanes on an H100 (700 W) K1 takes ~0.038 ms, K2 ~0.077 and K3
// ~0.134 (K3 all sky samples ~0.117, all sun-cone samples ~0.123), where
// the global-memory design took 0.047, 0.123 and 0.180 (PERF.md).

#include "sunsky_staged.cuh"

namespace {

constexpr int kThreads = 256;

// One lane of K1 (kKind 0) or K2 (1) on the staged tables S.
template <int kKind>
__device__ __forceinline__ void rgb_lane(const tsk::StagedRgb& S,
                                         const float* __restrict__ sun,
                                         int i, const float* __restrict__ d,
                                         float* __restrict__ rad_out,
                                         float* __restrict__ pdf_out) {
  float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  float rad[3];
  tsk::rgb_radiance(S, sun, dx, dy, dz, rad);
#pragma unroll
  for (int c = 0; c < 3; ++c) rad_out[3 * i + c] = rad[c];
  if (kKind == 1) pdf_out[i] = tsk::staged_pdf<false>(S, dx, dy, dz, true);
}

// The block's lanes, grid-stride, after staging the tables in S.
template <int kKind>
__device__ __forceinline__ void rgb_lanes(tsk::StagedRgb& S,
                                          const float* __restrict__ d, int n,
                                          const tsk::Tables& T,
                                          float* __restrict__ rad_out,
                                          float* __restrict__ pdf_out) {
  tsk::stage_rgb<kKind != 0>(S, T);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads)
    rgb_lane<kKind>(S, T.sun, i, d, rad_out, pdf_out);
}

__global__ void __launch_bounds__(kThreads, 4)
eval_kernel(const float* __restrict__ d, int n, tsk::Tables T,
            float* __restrict__ out) {
  __shared__ tsk::StagedRgb S;
  rgb_lanes<0>(S, d, n, T, out, nullptr);
}

__global__ void __launch_bounds__(kThreads, 4)
hit_kernel(const float* __restrict__ d, int n, tsk::Tables T,
           float* __restrict__ rad_out, float* __restrict__ pdf_out) {
  __shared__ tsk::StagedRgb S;
  rgb_lanes<1>(S, d, n, T, rad_out, pdf_out);
}

// K3 by chunks of kChunk lanes a warp, ranked by strategy
// (tsk::rank_by_strategy); a lane's slot: in u0, u1 | out d, pdf |
// radiance. Unlike K11's, the pdf's gaussians are unrolled (it spills
// nothing under the bound of three blocks an SM, and ran 1-3% faster).
constexpr int kChunk = 128;
constexpr int kPasses = kChunk / 32;

__global__ void __launch_bounds__(kThreads, 3)
nee_kernel(const float* __restrict__ u, int n, tsk::Tables T,
           float* __restrict__ d_out, float* __restrict__ rad_out,
           float* __restrict__ pdf_out) {
  constexpr int kWarps = kThreads / 32;
  __shared__ tsk::StagedRgb S;
  __shared__ float4 io[kWarps][kChunk][2];
  __shared__ int order[kWarps][kChunk];
  tsk::stage_rgb<true>(S, T);
  const tsk::Tables V = tsk::staged_view(T, S);
  const float w_sky = S.misc[tsk::M_WMIX];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4 (*slot)[2] = io[warp];
  int* ord = order[warp];
  for (int base = (blockIdx.x * kWarps + warp) * kChunk; base < n;
       base += gridDim.x * kWarps * kChunk) {
    bool sky[kPasses], valid[kPasses];
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      int i = base + 32 * k + lane;
      valid[k] = i < n;
      sky[k] = false;
      if (valid[k]) {
        float u0 = u[2 * i], u1 = u[2 * i + 1];
        slot[32 * k + lane][0] = make_float4(u0, u1, 0.0f, 0.0f);
        sky[k] = u0 < w_sky;
      }
    }
    const int count = tsk::rank_by_strategy(sky, valid, ord);
    // the lanes at places lane, lane + 32, ...: sample, radiance, pdf
    for (int q = lane; q < count; q += 32) {
      int j = ord[q];
      float4 uu = slot[j][0];
      float d[3], rad[3];
      bool pick_sky = tsk::nee_sample(V, uu.x, uu.y, d);
      tsk::rgb_radiance(S, T.sun, d[0], d[1], d[2], rad);
      float pdf = d[2] >= 0.0f
                      ? tsk::staged_pdf<false>(S, d[0], d[1], d[2], pick_sky)
                      : 0.0f;
      slot[j][0] = make_float4(d[0], d[1], d[2], pdf);
      slot[j][1] = make_float4(rad[0], rad[1], rad[2], 0.0f);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      int i = base + 32 * k + lane;
      if (i < n) {
        float4 o = slot[32 * k + lane][0], r = slot[32 * k + lane][1];
        d_out[3 * i] = o.x;
        d_out[3 * i + 1] = o.y;
        d_out[3 * i + 2] = o.z;
        rad_out[3 * i] = r.x;
        rad_out[3 * i + 1] = r.y;
        rad_out[3 * i + 2] = r.z;
        pdf_out[i] = o.w;
      }
    }
    __syncwarp();
  }
}

tsk::Tables tables(const float* skyp, const float* skyr, const float* sun,
                   const float* misc, const float* gauss) {
  return tsk::Tables{skyp, skyr, sun, misc, gauss};
}

}  // namespace

extern "C" {

int tsk_sunsky_eval_rgb(const float* d, int n, const float* skyp,
                        const float* skyr, const float* sun,
                        const float* misc, float* out, void* stream) {
  if (n > 0)
    tsk::staged_launch<kThreads>(eval_kernel, n, stream, d, n,
                                 tables(skyp, skyr, sun, misc, nullptr), out);
  return (int)cudaGetLastError();
}

int tsk_sunsky_hit_rgb(const float* d, int n, const float* skyp,
                       const float* skyr, const float* sun,
                       const float* misc, const float* gauss, float* rad,
                       float* pdf, void* stream) {
  if (n > 0)
    tsk::staged_launch<kThreads>(hit_kernel, n, stream, d, n,
                                 tables(skyp, skyr, sun, misc, gauss), rad,
                                 pdf);
  return (int)cudaGetLastError();
}

int tsk_sunsky_nee_rgb(const float* u, int n, const float* skyp,
                       const float* skyr, const float* sun,
                       const float* misc, const float* gauss, float* d,
                       float* rad, float* pdf, void* stream) {
  if (n > 0)
    tsk::staged_launch<kThreads>(nee_kernel, n, stream, u, n,
                                 tables(skyp, skyr, sun, misc, gauss), d,
                                 rad, pdf);
  return (int)cudaGetLastError();
}

}  // extern "C"
