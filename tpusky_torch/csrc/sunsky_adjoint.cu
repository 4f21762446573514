// Sunsky adjoint kernels K5-K8 for sm_90a.
//
// K5 sunsky_eval_rgb_bwd  replaces tpusky/ops/pallas/sunsky_kernel.py:
//                         sunsky_eval_rgb_bwd_pallas (_eval_rgb_bwd_kernel):
//                         the radiance adjoint. (d, g_rad) -> per-lane dd and
//                         the table cotangents summed over all lanes.
// K6 sunsky_nee_rgb_bwd   replaces sunsky_kernel.py:
//                         sunsky_nee_rgb_bwd_nopdf_pallas
//                         (_nee_rgb_bwd_nopdf_kernel): the NEE block's
//                         radiance adjoint with the pdf detached. Each lane
//                         redraws its sample with K3's nee_sample (placement
//                         is fully detached) and runs K5's adjoint there.
// K7 sunsky_hit_rgb_bwd   replaces sunsky_kernel.py:sunsky_hit_rgb_bwd_pallas
//                         (_hit_rgb_bwd_kernel): the emitter-hit block's
//                         adjoint with the pdf attached. K5 plus the mixture
//                         pdf's reverse (the mixture weight attached, as
//                         model.py::pdf_direction keeps it): dd gains the
//                         pdf's direction cotangent, the tables the
//                         gaussian table's.
// K8 sunsky_nee_rgb_pdf_bwd  replaces sunsky_kernel.py:
//                         sunsky_nee_rgb_bwd_pallas (_nee_rgb_bwd_kernel):
//                         the NEE block's adjoint with the pdf attached. K6
//                         plus the pdf at the sample, the mixture weight
//                         detached, whose direction cotangent goes back
//                         through the sample's placement (nee_sample_vjp).
//
// All take reverse sweeps derived by hand in sunsky_core.cuh
// (radiance_vjp, pdf_lane_vjp/gauss_term_vjp/pdf_vjp_tail, nee_sample_vjp);
// the TPU kernels traced a jax.vjp of their gradient-safe forward body
// instead.
//
// What bounds them on an H100: arithmetic (the forward plus its reverse
// sweep, ~3x K1's work a lane; K7/K8 add the 20-gaussian pdf twice over)
// and, for the table cotangents, the reduction over lanes. The TPU kernel
// summed the table cotangents in VMEM across its sequential grid; blocks
// here run in parallel and in no order, so the sum takes the two passes of
// adjoint_common.cuh. In pass 1 each thread keeps the 46 small-table
// cotangents (skyp, skyr, misc) in registers over its lanes, summed over
// the block at the end; the (45, 72) sun-table cotangent goes to a
// block-wide copy in shared memory by shared atomics (13 KB), since lanes
// of a block land in different sun segments; the gaussian table's (K7,
// K8) to a copy per warp: the pdf's part, which every lane has for all 20
// gaussians, summed over the warp by shuffles first; the sample
// placement's part, one gaussian a lane, by atomics. A block writes its
// partial row [sun 3240 | skyp 27 | skyr 3 | misc 16 (| gauss 280)]. So
// only the order of shared-memory atomics varies from run to run. Lanes
// whose cotangents are all zero skip the per-lane body. The likely slow
// spot is the sun atomics of K6/K8, whose sun-strategy lanes mostly land
// in one or two sun segments; it is measured, not tuned, here.

#include "adjoint_common.cuh"

namespace {

constexpr int kSunN = tsk::N_SEG * tsk::SUN_F;          // 3240
constexpr int kRow = kSunN + tsk::N_ACC;                  // 3286
constexpr int kRowPdf = kRow + kGaussN;                   // 3566

// Pass 1. kNee false (K5, K7) reads directions in (n, 3) and writes dd;
// kNee true (K6, K8) reads uniforms in (n, 2) and redraws each sample.
// kPdf adds the pdf's cotangent g_pdf (n,).
template <bool kNee, bool kPdf>
__device__ __forceinline__ void adjoint_pass(
    const float* __restrict__ in, const float* __restrict__ g,
    const float* __restrict__ g_pdf, int n, const tsk::Tables& T,
    float* __restrict__ dd_out, float* __restrict__ partial) {
  __shared__ float s_sun[kSunN];
  __shared__ float s_acc[kWarps * tsk::N_ACC];
  __shared__ float s_gauss[kPdf ? kWarps * kGaussN : 1];
  for (int i = threadIdx.x; i < kSunN; i += kThreads) s_sun[i] = 0.0f;
  if (kPdf)
    for (int i = threadIdx.x; i < kWarps * kGaussN; i += kThreads)
      s_gauss[i] = 0.0f;
  __syncthreads();
  float* s_gauss_w = s_gauss + (kPdf ? (threadIdx.x >> 5) * kGaussN : 0);

  float acc[tsk::N_ACC];
#pragma unroll
  for (int k = 0; k < tsk::N_ACC; ++k) acc[k] = 0.0f;

  for (long long base = (long long)blockIdx.x * kThreads; base < n;
       base += (long long)gridDim.x * kThreads) {
    int i = (int)base + threadIdx.x;
    bool live = i < n;
    float gl[3] = {0.0f, 0.0f, 0.0f};
    float gp = 0.0f;
    if (live) {
      gl[0] = g[3 * i];
      gl[1] = g[3 * i + 1];
      gl[2] = g[3 * i + 2];
      if (kPdf) gp = g_pdf[i];
    }
    bool rad = gl[0] != 0.0f || gl[1] != 0.0f || gl[2] != 0.0f;
    float d[3] = {0.0f, 0.0f, 1.0f};
    float u0 = 0.0f, u1 = 0.0f;
    bool pick_sky = true;
    float dd[3] = {0.0f, 0.0f, 0.0f};
    if (live && (rad || gp != 0.0f)) {
      if (kNee) {
        u0 = in[2 * i];
        u1 = in[2 * i + 1];
        pick_sky = tsk::nee_sample(T, u0, u1, d);
      } else {
        d[0] = in[3 * i];
        d[1] = in[3 * i + 1];
        d[2] = in[3 * i + 2];
      }
      if (rad) tsk::radiance_vjp(T, d[0], d[1], d[2], gl, dd, acc, s_sun);
    }
    if (kPdf) {
      // an NEE sample's pdf is masked below the horizon
      if (kNee && !(d[2] >= 0.0f)) gp = 0.0f;
      tsk::PdfLane P = tsk::pdf_lane_vjp(T, d[0], d[1], d[2], pick_sky, gp);
      float g_phi, g_theta;
      float tg = gauss_sum_vjp_warp(T.gauss, P, &g_phi, &g_theta, s_gauss_w);
      if (gp != 0.0f) {
        if (kNee) {
          float dp[3] = {0.0f, 0.0f, 0.0f};
          tsk::pdf_vjp_tail(T.misc, d[0], d[1], d[2], P, tg, gp, true,
                            g_phi, g_theta, dp, acc + tsk::ACC_MISC);
          tsk::nee_sample_vjp(T, u0, u1, dp, acc + tsk::ACC_MISC, s_gauss_w,
                              tsk::AtomicAdd());
        } else {
          tsk::pdf_vjp_tail(T.misc, d[0], d[1], d[2], P, tg, gp, false,
                            g_phi, g_theta, dd, acc + tsk::ACC_MISC);
        }
      }
    }
    if (!kNee && live) {
      dd_out[3 * i] = dd[0];
      dd_out[3 * i + 1] = dd[1];
      dd_out[3 * i + 2] = dd[2];
    }
  }

  warp_partials<tsk::N_ACC>(acc, s_acc);
  __syncthreads();
  constexpr int kCols = kPdf ? kRowPdf : kRow;
  float* __restrict__ row = partial + (size_t)blockIdx.x * kCols;
  for (int j = threadIdx.x; j < kSunN; j += kThreads) row[j] = s_sun[j];
  if (threadIdx.x < tsk::N_ACC)
    row[kSunN + threadIdx.x] = warps_sum(s_acc, tsk::N_ACC, threadIdx.x);
  if (kPdf)
    for (int j = threadIdx.x; j < kGaussN; j += kThreads)
      row[kRow + j] = warps_sum(s_gauss, kGaussN, j);
}

__global__ void __launch_bounds__(kThreads)
eval_bwd_kernel(const float* __restrict__ d, const float* __restrict__ g,
                int n, tsk::Tables T, float* __restrict__ dd,
                float* __restrict__ partial) {
  adjoint_pass<false, false>(d, g, nullptr, n, T, dd, partial);
}

__global__ void __launch_bounds__(kThreads)
nee_bwd_kernel(const float* __restrict__ u, const float* __restrict__ g,
               int n, tsk::Tables T, float* __restrict__ partial) {
  adjoint_pass<true, false>(u, g, nullptr, n, T, nullptr, partial);
}

__global__ void __launch_bounds__(kThreads)
hit_bwd_kernel(const float* __restrict__ d, const float* __restrict__ g,
               const float* __restrict__ g_pdf, int n, tsk::Tables T,
               float* __restrict__ dd, float* __restrict__ partial) {
  adjoint_pass<false, true>(d, g, g_pdf, n, T, dd, partial);
}

__global__ void __launch_bounds__(kThreads)
nee_pdf_bwd_kernel(const float* __restrict__ u, const float* __restrict__ g,
                   const float* __restrict__ g_pdf, int n, tsk::Tables T,
                   float* __restrict__ partial) {
  adjoint_pass<true, true>(u, g, g_pdf, n, T, nullptr, partial);
}

}  // namespace

extern "C" {

// Rows of the block-partial scratch a launch over n lanes needs (the
// wrapper allocates rows x the kernel's row width of floats).
int tsk_adjoint_rows(int n) { return adjoint_rows(n); }

// K5: d (n, 3), g (n, 3) -> dd (n, 3), out (3286,) = [sun | skyp | skyr |
// misc] cotangents; partial: tsk_adjoint_rows(n) x 3286 floats of scratch.
int tsk_sunsky_eval_rgb_bwd(const float* d, const float* g, int n,
                            const float* skyp, const float* skyr,
                            const float* sun, const float* misc, float* dd,
                            float* partial, float* out, void* stream) {
  int rows = adjoint_rows(n);
  cudaStream_t s = (cudaStream_t)stream;
  eval_bwd_kernel<<<rows, kThreads, 0, s>>>(
      d, g, n, tsk::Tables{skyp, skyr, sun, misc, nullptr}, dd, partial);
  return finish(partial, rows, kRow, out, s);
}

// K6: u (n, 2), g (n, 3) -> out (3286,), as K5 without a per-lane output.
int tsk_sunsky_nee_rgb_bwd(const float* u, const float* g, int n,
                           const float* skyp, const float* skyr,
                           const float* sun, const float* misc,
                           const float* gauss, float* partial, float* out,
                           void* stream) {
  int rows = adjoint_rows(n);
  cudaStream_t s = (cudaStream_t)stream;
  nee_bwd_kernel<<<rows, kThreads, 0, s>>>(
      u, g, n, tsk::Tables{skyp, skyr, sun, misc, gauss}, partial);
  return finish(partial, rows, kRow, out, s);
}

// K7: d (n, 3), g (n, 3), g_pdf (n,) -> dd (n, 3), out (3566,) = [sun |
// skyp | skyr | misc | gauss (14, 20)]; partial: rows x 3566 floats.
int tsk_sunsky_hit_rgb_bwd(const float* d, const float* g,
                           const float* g_pdf, int n, const float* skyp,
                           const float* skyr, const float* sun,
                           const float* misc, const float* gauss, float* dd,
                           float* partial, float* out, void* stream) {
  int rows = adjoint_rows(n);
  cudaStream_t s = (cudaStream_t)stream;
  hit_bwd_kernel<<<rows, kThreads, 0, s>>>(
      d, g, g_pdf, n, tsk::Tables{skyp, skyr, sun, misc, gauss}, dd,
      partial);
  return finish(partial, rows, kRowPdf, out, s);
}

// K8: u (n, 2), g (n, 3), g_pdf (n,) -> out (3566,), as K7 without a
// per-lane output.
int tsk_sunsky_nee_rgb_pdf_bwd(const float* u, const float* g,
                               const float* g_pdf, int n, const float* skyp,
                               const float* skyr, const float* sun,
                               const float* misc, const float* gauss,
                               float* partial, float* out, void* stream) {
  int rows = adjoint_rows(n);
  cudaStream_t s = (cudaStream_t)stream;
  nee_pdf_bwd_kernel<<<rows, kThreads, 0, s>>>(
      u, g, g_pdf, n, tsk::Tables{skyp, skyr, sun, misc, gauss}, partial);
  return finish(partial, rows, kRowPdf, out, s);
}

}  // extern "C"
