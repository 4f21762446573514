// Sunsky adjoint kernels K5 and K6 for sm_90a.
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
//
// Both take the reverse-mode body radiance_vjp (sunsky_core.cuh), derived
// by hand from radiance(); the TPU kernels traced a jax.vjp of their
// gradient-safe forward body instead.
//
// What bounds them on an H100: arithmetic again (the forward radiance plus
// its reverse sweep, ~3x K1's work per lane) and, for the table
// cotangents, the reduction over lanes. The TPU kernel summed the table
// cotangents in VMEM across its sequential grid; blocks here run in
// parallel and in no order, so the sum takes two passes:
//   1. a grid-stride pass over the lanes (one thread per lane at a time,
//      at most kMaxBlocks blocks). Each thread keeps the 46 small-table
//      cotangents (skyp, skyr, misc) in registers over its lanes; each warp
//      reduces them by shuffles in a fixed order into its own shared slot.
//      The (45, 72) sun-table cotangent goes to a block-wide copy in shared
//      memory by shared atomics (13 KB), since lanes of a block land in
//      different sun segments. The block writes its partial row of 3286
//      floats [sun 3240 | skyp 27 | skyr 3 | misc 16].
//   2. reduce_partials sums the rows in a fixed order.
// So only the order of one block's shared-memory sun atomics varies from
// run to run. Lanes whose cotangent is all zero (masked by the caller)
// skip the body: nothing they compute can reach the sums. The likely slow
// spot is the sun atomics of K6, whose sun-strategy lanes mostly land in
// one or two sun segments; it is measured, not tuned, here.

#include "sunsky_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSunN = tsk::N_SEG * tsk::SUN_F;          // 3240
constexpr int kRow = kSunN + tsk::N_ACC;                  // 3286

// pass 1, shared by K5 and K6. K5 (kNee false) reads directions in (n, 3)
// and writes dd; K6 reads uniforms in (n, 2) and redraws each sample.
template <bool kNee>
__device__ __forceinline__ void adjoint_pass(
    const float* __restrict__ in, const float* __restrict__ g, int n,
    const tsk::Tables& T, float* __restrict__ dd_out,
    float* __restrict__ partial) {
  __shared__ float s_sun[kSunN];
  __shared__ float s_acc[kWarps][tsk::N_ACC];
  for (int i = threadIdx.x; i < kSunN; i += kThreads) s_sun[i] = 0.0f;
  __syncthreads();

  float acc[tsk::N_ACC];
#pragma unroll
  for (int k = 0; k < tsk::N_ACC; ++k) acc[k] = 0.0f;

  // every thread of a warp runs the same number of iterations, so the
  // shuffles below see all 32 lanes
  for (long long base = (long long)blockIdx.x * kThreads; base < n;
       base += (long long)gridDim.x * kThreads) {
    int i = (int)base + threadIdx.x;
    if (i >= n) continue;
    float gl[3] = {g[3 * i], g[3 * i + 1], g[3 * i + 2]};
    float dd[3] = {0.0f, 0.0f, 0.0f};
    if (gl[0] != 0.0f || gl[1] != 0.0f || gl[2] != 0.0f) {
      float d[3];
      if (kNee) {
        tsk::nee_sample(T, in[2 * i], in[2 * i + 1], d);
      } else {
        d[0] = in[3 * i];
        d[1] = in[3 * i + 1];
        d[2] = in[3 * i + 2];
      }
      tsk::radiance_vjp(T, d[0], d[1], d[2], gl, dd, acc, s_sun);
    }
    if (!kNee) {
      dd_out[3 * i] = dd[0];
      dd_out[3 * i + 1] = dd[1];
      dd_out[3 * i + 2] = dd[2];
    }
  }

  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < tsk::N_ACC; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_acc[warp][k] = v;
  }
  __syncthreads();

  float* __restrict__ row = partial + (size_t)blockIdx.x * kRow;
  for (int i = threadIdx.x; i < kSunN; i += kThreads) row[i] = s_sun[i];
  if (threadIdx.x < tsk::N_ACC) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += s_acc[w][threadIdx.x];
    row[kSunN + threadIdx.x] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
eval_bwd_kernel(const float* __restrict__ d, const float* __restrict__ g,
                int n, tsk::Tables T, float* __restrict__ dd,
                float* __restrict__ partial) {
  adjoint_pass<false>(d, g, n, T, dd, partial);
}

__global__ void __launch_bounds__(kThreads)
nee_bwd_kernel(const float* __restrict__ u, const float* __restrict__ g,
               int n, tsk::Tables T, float* __restrict__ partial) {
  adjoint_pass<true>(u, g, n, T, nullptr, partial);
}

// out[j] = sum over rows b of partial[b, j], in a fixed order: 32 columns
// a block, warp w sums rows w, w + 8, ... and the 8 warp sums are added
// in warp order.
__global__ void __launch_bounds__(kThreads)
reduce_partials(const float* __restrict__ partial, int rows,
                float* __restrict__ out) {
  __shared__ float s[kWarps][32];
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int j = blockIdx.x * 32 + lane;
  float v = 0.0f;
  if (j < kRow)
    for (int b = warp; b < rows; b += kWarps) v += partial[(size_t)b * kRow + j];
  s[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && j < kRow) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += s[w][lane];
    out[j] = t;
  }
}

int finish(const float* partial, int rows, float* out, cudaStream_t stream) {
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  reduce_partials<<<(kRow + 31) / 32, kThreads, 0, stream>>>(partial, rows,
                                                              out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the block-partial scratch a launch over n lanes needs (the
// wrapper allocates rows x 3286 floats).
int tsk_adjoint_rows(int n) {
  constexpr int kMaxBlocks = 1024;
  int blocks = (n + kThreads - 1) / kThreads;
  return blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

// K5: d (n, 3), g (n, 3) -> dd (n, 3), out (3286,) = [sun | skyp | skyr |
// misc] cotangents; partial: tsk_adjoint_rows(n) x 3286 floats of scratch.
int tsk_sunsky_eval_rgb_bwd(const float* d, const float* g, int n,
                            const float* skyp, const float* skyr,
                            const float* sun, const float* misc, float* dd,
                            float* partial, float* out, void* stream) {
  int rows = tsk_adjoint_rows(n);
  cudaStream_t s = (cudaStream_t)stream;
  eval_bwd_kernel<<<rows, kThreads, 0, s>>>(
      d, g, n, tsk::Tables{skyp, skyr, sun, misc, nullptr}, dd, partial);
  return finish(partial, rows, out, s);
}

// K6: u (n, 2), g (n, 3) -> out (3286,), as K5 without a per-lane output.
int tsk_sunsky_nee_rgb_bwd(const float* u, const float* g, int n,
                           const float* skyp, const float* skyr,
                           const float* sun, const float* misc,
                           const float* gauss, float* partial, float* out,
                           void* stream) {
  int rows = tsk_adjoint_rows(n);
  cudaStream_t s = (cudaStream_t)stream;
  nee_bwd_kernel<<<rows, kThreads, 0, s>>>(
      u, g, n, tsk::Tables{skyp, skyr, sun, misc, gauss}, partial);
  return finish(partial, rows, out, s);
}

}  // extern "C"
