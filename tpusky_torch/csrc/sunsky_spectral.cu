// Spectral sunsky emitter kernels K9-K11 for sm_90a.
//
// K9  sunsky_eval_spec  replaces tpusky/ops/pallas/sunsky_kernel.py:
//                       sunsky_eval_spec_pallas (_spec_eval_kernel)
// K10 sunsky_hit_spec   replaces sunsky_kernel.py:sunsky_hit_spec_pallas
//                       (_spec_hit_kernel): radiance + mixture pdf
// K11 sunsky_nee_spec   replaces sunsky_kernel.py:sunsky_nee_spec_pallas
//                       (_spec_nee_kernel): sample + radiance + pdf
//
// Lanes come as d (N, 3) or u (N, 2) and wavelengths (N, W) row-major;
// radiance goes out as (N, W).
//
// The TPU kernel evaluated all 11 dataset channels as (11, B) tiles and
// collapsed them per hero wavelength with one-hot masks and matrix
// products. Here each lane computes the shared geometry once and, for each
// of its wavelengths, only the two neighbouring channels: 2W channel
// evaluations (8 at W = 4) instead of 11, and none for a wavelength
// outside [320, 720] nm.
//
// What bounds them on an H100: arithmetic. A lane moves 44-56 bytes
// (K9: 12 + 16 in, 16 out; K10 adds a 4-byte pdf; K11: 8 + 16 in,
// 12 + 16 + 4 out), ~30 us of HBM time at 2M lanes, against ~1000 FP32
// operations and ~100 special-function instructions (eight sky channels
// with two exps and two divisions each; K10/K11 add the 20-gaussian pdf,
// K11 the sample's erfinvs or cone map). So the design spends no
// instruction a lane does not need:
// - a grid of as many 256-thread blocks as the SMs hold at once walks the
//   lanes (grid-stride); each block stages the tables in shared memory
//   once (sunsky_staged.cuh: StagedSpec, ~10 KB), so the lanes' divergent
//   channel-row reads are float4 shared loads and the pdf's 20 gaussians
//   are broadcasts, with 1/sigma in place of a division;
// - the geometry the sun alone reads is computed only in its disc;
// - K11 at W = 4 runs each warp's sky samples in passes of their own,
//   apart from its sun-cone samples (nee_chunks4), so a pass pays one
//   strategy and, unless it holds cone samples, no disc;
// - the render path's W = 4 is its own instantiation (kW4): wl read and
//   radiance written as one float4 a lane, the wavelength loop unrolled
//   in K9 and K10. The launcher takes it when W = 4 and wl and the
//   radiance are 16-byte aligned; every other W runs the runtime-W
//   instantiation.
// At 2M lanes x 4 wavelengths on an H100 (700 W) K9 takes ~0.071 ms,
// K10 ~0.107 and K11 ~0.173, where the global-memory design took 0.092,
// 0.160 and 0.238 (PERF.md).

#include <stdint.h>

#include "sunsky_staged.cuh"

namespace {

constexpr int kThreads = 256;
// The kernels are compiled for at least three blocks an SM at W = 4 (at
// most 85 registers a thread; they take ~56-80) and two at runtime W (at
// most 128; left unbounded, they took 169-188): __launch_bounds__'s
// kW4 ? 3 : 2.

// One lane of K9 (kKind 0), K10 (1) or K11 (2) on the staged tables S
// (V: the global tables with misc and gauss staged, for nee_sample),
// reading its inputs and writing its outputs in global memory. K9 and K10
// at W = 4 unroll the wavelengths and the pdf's gaussians; the runtime-W
// kernels roll them (kRolled), which keeps their registers down.
template <int kKind, bool kW4>
__device__ __forceinline__ void spec_lane(const tsk::StagedSpec& S,
                                          const tsk::Tables& V, int i,
                                          const float* __restrict__ in,
                                          const float* __restrict__ wl,
                                          int nw, float* __restrict__ d_out,
                                          float* __restrict__ rad_out,
                                          float* __restrict__ pdf_out) {
  float d[3];
  bool check_sun = true;
  if (kKind == 2) {
    check_sun = tsk::nee_sample(V, in[2 * i], in[2 * i + 1], d);
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) d[c] = in[3 * i + c];
  }
  if (kW4) {
    float4 w = __ldg(reinterpret_cast<const float4*>(wl) + i);
    reinterpret_cast<float4*>(rad_out)[i] =
        tsk::spec_radiance4<false>(S, d[0], d[1], d[2], w);
  } else {
    size_t row = (size_t)i * nw;
    tsk::spec_radiance(S, d[0], d[1], d[2], wl + row, nw, rad_out + row);
  }
  constexpr bool kRolled = !kW4;
  if (kKind == 1)
    pdf_out[i] = tsk::staged_pdf<kRolled>(S, d[0], d[1], d[2], true);
  if (kKind == 2) {
    pdf_out[i] =
        d[2] >= 0.0f
            ? tsk::staged_pdf<kRolled>(S, d[0], d[1], d[2], check_sun)
            : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) d_out[3 * i + c] = d[c];
  }
}

// The block's lanes, grid-stride, after staging the tables in S.
template <int kKind, bool kW4>
__device__ __forceinline__ void spec_lanes(tsk::StagedSpec& S,
                                           const float* __restrict__ in,
                                           const float* __restrict__ wl,
                                           int n, int nw, const tsk::Tables& T,
                                           float* __restrict__ d_out,
                                           float* __restrict__ rad_out,
                                           float* __restrict__ pdf_out) {
  tsk::stage_spec<kKind != 0>(S, T);
  const tsk::Tables V = tsk::staged_view(T, S);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads)
    spec_lane<kKind, kW4>(S, V, i, in, wl, nw, d_out, rad_out, pdf_out);
}

// K11 at W = 4, by chunks of kChunk lanes a warp: each chunk's TGMM sky
// samples run in passes of their own, apart from its sun-cone samples, so
// that a warp pays one strategy's sample and, unless it holds cone samples
// (which lie in the sun's disc), no disc radiance (tsk::rank_by_strategy,
// which K3 shares). Each lane's inputs and outputs pass through the warp's
// slots in shared memory (io), so global memory is read and written in
// lane order; no block-wide barrier couples the warps. The wavelengths
// and the pdf's gaussians are rolled (kRolled): unrolled, the chunk's
// bookkeeping and their registers spill.
constexpr int kChunk = 128;
constexpr int kPasses = kChunk / 32;

__device__ __forceinline__ void nee_chunks4(tsk::StagedSpec& S,
                                            const float* __restrict__ u,
                                            const float* __restrict__ wl,
                                            int n, const tsk::Tables& T,
                                            float* __restrict__ d_out,
                                            float* __restrict__ rad_out,
                                            float* __restrict__ pdf_out) {
  constexpr int kWarps = kThreads / 32;
  // a lane's slot: in u0, u1 | wl; out d, pdf | radiance
  __shared__ float4 io[kWarps][kChunk][2];
  __shared__ int order[kWarps][kChunk];
  tsk::stage_spec<true>(S, T);
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
        slot[32 * k + lane][1] =
            __ldg(reinterpret_cast<const float4*>(wl) + i);
        sky[k] = u0 < w_sky;
      }
    }
    const int count = tsk::rank_by_strategy(sky, valid, ord);
    // the lanes at places lane, lane + 32, ...: sample, radiance, pdf
    for (int q = lane; q < count; q += 32) {
      int j = ord[q];
      float4 uu = slot[j][0];
      float d[3];
      bool pick_sky = tsk::nee_sample(V, uu.x, uu.y, d);
      float4 rad =
          tsk::spec_radiance4<true>(S, d[0], d[1], d[2], slot[j][1]);
      float pdf = d[2] >= 0.0f
                      ? tsk::staged_pdf<true>(S, d[0], d[1], d[2], pick_sky)
                      : 0.0f;
      slot[j][0] = make_float4(d[0], d[1], d[2], pdf);
      slot[j][1] = rad;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      int i = base + 32 * k + lane;
      if (i < n) {
        float4 o = slot[32 * k + lane][0];
        d_out[3 * i] = o.x;
        d_out[3 * i + 1] = o.y;
        d_out[3 * i + 2] = o.z;
        pdf_out[i] = o.w;
        reinterpret_cast<float4*>(rad_out)[i] = slot[32 * k + lane][1];
      }
    }
    __syncwarp();
  }
}

template <bool kW4>
__global__ void __launch_bounds__(kThreads, kW4 ? 3 : 2)
eval_spec_kernel(const float* __restrict__ d, const float* __restrict__ wl,
                 int n, int nw, tsk::Tables T, float* __restrict__ out) {
  __shared__ tsk::StagedSpec S;
  spec_lanes<0, kW4>(S, d, wl, n, nw, T, nullptr, out, nullptr);
}

template <bool kW4>
__global__ void __launch_bounds__(kThreads, kW4 ? 3 : 2)
hit_spec_kernel(const float* __restrict__ d, const float* __restrict__ wl,
                int n, int nw, tsk::Tables T, float* __restrict__ rad_out,
                float* __restrict__ pdf_out) {
  __shared__ tsk::StagedSpec S;
  spec_lanes<1, kW4>(S, d, wl, n, nw, T, nullptr, rad_out, pdf_out);
}

template <bool kW4>
__global__ void __launch_bounds__(kThreads, kW4 ? 3 : 2)
nee_spec_kernel(const float* __restrict__ u, const float* __restrict__ wl,
                int n, int nw, tsk::Tables T, float* __restrict__ d_out,
                float* __restrict__ rad_out, float* __restrict__ pdf_out) {
  __shared__ tsk::StagedSpec S;
  if (kW4)
    nee_chunks4(S, u, wl, n, T, d_out, rad_out, pdf_out);
  else
    spec_lanes<2, false>(S, u, wl, n, nw, T, d_out, rad_out, pdf_out);
}

tsk::Tables tables(const float* skyp, const float* skyr, const float* sun,
                   const float* ld, const float* misc, const float* gauss) {
  return tsk::Tables{skyp, skyr, sun, misc, gauss, ld};
}

// The W = 4 instantiation's condition: four wavelengths a lane, rows of
// wl and of the radiance on 16-byte boundaries.
bool w4(int nw, const float* wl, const float* rad) {
  return nw == 4 && (uintptr_t)wl % 16 == 0 && (uintptr_t)rad % 16 == 0;
}

}  // namespace

extern "C" {

int tsk_sunsky_eval_spec(const float* d, const float* wl, int n, int nw,
                         const float* skyp, const float* skyr,
                         const float* sun, const float* ld,
                         const float* misc, float* out, void* stream) {
  if (n > 0) {
    tsk::Tables T = tables(skyp, skyr, sun, ld, misc, nullptr);
    if (w4(nw, wl, out))
      tsk::staged_launch<kThreads>(eval_spec_kernel<true>, n, stream, d, wl,
                                   n, nw, T, out);
    else
      tsk::staged_launch<kThreads>(eval_spec_kernel<false>, n, stream, d, wl,
                                   n, nw, T, out);
  }
  return (int)cudaGetLastError();
}

int tsk_sunsky_hit_spec(const float* d, const float* wl, int n, int nw,
                        const float* skyp, const float* skyr,
                        const float* sun, const float* ld, const float* misc,
                        const float* gauss, float* rad, float* pdf,
                        void* stream) {
  if (n > 0) {
    tsk::Tables T = tables(skyp, skyr, sun, ld, misc, gauss);
    if (w4(nw, wl, rad))
      tsk::staged_launch<kThreads>(hit_spec_kernel<true>, n, stream, d, wl,
                                   n, nw, T, rad, pdf);
    else
      tsk::staged_launch<kThreads>(hit_spec_kernel<false>, n, stream, d, wl,
                                   n, nw, T, rad, pdf);
  }
  return (int)cudaGetLastError();
}

int tsk_sunsky_nee_spec(const float* u, const float* wl, int n, int nw,
                        const float* skyp, const float* skyr,
                        const float* sun, const float* ld, const float* misc,
                        const float* gauss, float* d, float* rad, float* pdf,
                        void* stream) {
  if (n > 0) {
    tsk::Tables T = tables(skyp, skyr, sun, ld, misc, gauss);
    if (w4(nw, wl, rad))
      tsk::staged_launch<kThreads>(nee_spec_kernel<true>, n, stream, u, wl,
                                   n, nw, T, d, rad, pdf);
    else
      tsk::staged_launch<kThreads>(nee_spec_kernel<false>, n, stream, u, wl,
                                   n, nw, T, d, rad, pdf);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
