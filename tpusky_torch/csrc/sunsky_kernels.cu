// Sunsky emitter kernels K1-K3 for sm_90a.
//
// K1 sunsky_eval_rgb  replaces tpusky/ops/pallas/sunsky_kernel.py:
//                     sunsky_eval_rgb_pallas (_sunsky_rgb_kernel)
// K2 sunsky_hit_rgb   replaces sunsky_kernel.py:sunsky_hit_rgb_pallas
//                     (_hit_kernel): radiance + mixture pdf
// K3 sunsky_nee_rgb   replaces sunsky_kernel.py:sunsky_nee_rgb_pallas
//                     (_nee_kernel): sample + radiance + pdf
//
// What bounds them on an H100: arithmetic, mostly transcendentals
// (K1 ~12 per lane; K2 adds atan2, asin and 20 exps of the gaussian
// mixture; K3 adds erfinv/erf/exp or the cone warp), against 12-28 bytes
// of I/O per lane (K1 12 in + 12 out, K2 12 + 16, K3 8 + 28). At 2M lanes
// that is under 60 MB, about 20 us of HBM time, so the kernels sit on the
// compute side. The simple design: one thread per lane, 256 threads a
// block, no shared memory; the ~14 KB of state tables are read through
// const __restrict__ pointers and stay in L1/L2 for every block.
// Vectorised loads, packed tables in shared memory and fewer
// transcendentals are work for later.

#include "sunsky_core.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
eval_kernel(const float* __restrict__ d, int n, tsk::Tables T,
            float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float rad[3];
  tsk::radiance(T, d[3 * i], d[3 * i + 1], d[3 * i + 2], rad);
  out[3 * i] = rad[0];
  out[3 * i + 1] = rad[1];
  out[3 * i + 2] = rad[2];
}

__global__ void __launch_bounds__(kThreads)
hit_kernel(const float* __restrict__ d, int n, tsk::Tables T,
           float* __restrict__ rad_out, float* __restrict__ pdf_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  float rad[3];
  tsk::radiance(T, dx, dy, dz, rad);
  rad_out[3 * i] = rad[0];
  rad_out[3 * i + 1] = rad[1];
  rad_out[3 * i + 2] = rad[2];
  pdf_out[i] = tsk::mixture_pdf(T, dx, dy, dz, true);
}

__global__ void __launch_bounds__(kThreads)
nee_kernel(const float* __restrict__ u, int n, tsk::Tables T,
           float* __restrict__ d_out, float* __restrict__ rad_out,
           float* __restrict__ pdf_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float d[3], rad[3];
  float pdf = tsk::nee(T, u[2 * i], u[2 * i + 1], d, rad);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    d_out[3 * i + c] = d[c];
    rad_out[3 * i + c] = rad[c];
  }
  pdf_out[i] = pdf;
}

tsk::Tables tables(const float* skyp, const float* skyr, const float* sun,
                   const float* misc, const float* gauss) {
  return tsk::Tables{skyp, skyr, sun, misc, gauss};
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int tsk_sunsky_eval_rgb(const float* d, int n, const float* skyp,
                        const float* skyr, const float* sun,
                        const float* misc, float* out, void* stream) {
  if (n > 0)
    eval_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        d, n, tables(skyp, skyr, sun, misc, nullptr), out);
  return (int)cudaGetLastError();
}

int tsk_sunsky_hit_rgb(const float* d, int n, const float* skyp,
                       const float* skyr, const float* sun,
                       const float* misc, const float* gauss, float* rad,
                       float* pdf, void* stream) {
  if (n > 0)
    hit_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        d, n, tables(skyp, skyr, sun, misc, gauss), rad, pdf);
  return (int)cudaGetLastError();
}

int tsk_sunsky_nee_rgb(const float* u, int n, const float* skyp,
                       const float* skyr, const float* sun,
                       const float* misc, const float* gauss, float* d,
                       float* rad, float* pdf, void* stream) {
  if (n > 0)
    nee_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        u, n, tables(skyp, skyr, sun, misc, gauss), d, rad, pdf);
  return (int)cudaGetLastError();
}

}  // extern "C"
