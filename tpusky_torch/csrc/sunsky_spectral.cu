// Spectral sunsky emitter kernels K9-K11 for sm_90a.
//
// K9  sunsky_eval_spec  replaces tpusky/ops/pallas/sunsky_kernel.py:
//                       sunsky_eval_spec_pallas (_spec_eval_kernel)
// K10 sunsky_hit_spec   replaces sunsky_kernel.py:sunsky_hit_spec_pallas
//                       (_spec_hit_kernel): radiance + mixture pdf
// K11 sunsky_nee_spec   replaces sunsky_kernel.py:sunsky_nee_spec_pallas
//                       (_spec_nee_kernel): sample + radiance + pdf
//
// Lanes come as d (N, 3) or u (N, 2) and wavelengths (N, W) row-major, W
// a runtime argument (4 hero wavelengths on the render path); radiance
// goes out as (N, W).
//
// The TPU kernel evaluated all 11 dataset channels as (11, B) tiles and
// collapsed them per hero wavelength with one-hot masks and matrix
// products. Here each lane computes the shared geometry once
// (tsk::sky_geometry, as K1-K3 do) and, for each of its wavelengths, only
// the two neighbouring channels: 2W channel evaluations (8 at W = 4)
// instead of 11, and none for a wavelength outside [320, 720] nm.
//
// What bounds them on an H100: arithmetic. A lane moves 44-56 bytes
// (K9: 12 + 16 in, 16 out; K10 adds a 4-byte pdf; K11: 8 + 16 in,
// 12 + 16 + 4 out), ~5 us of HBM time at 2M lanes, against ~1000 FP32
// operations (eight sky channels with two expf each, the geometry's
// trigonometry; K10/K11 add the 20-gaussian pdf). The simple design: one
// thread per lane, 256 threads a block, no shared memory; the ~10 KB of
// tables are read through const __restrict__ pointers and stay in L1/L2.

#include "sunsky_core.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
eval_spec_kernel(const float* __restrict__ d, const float* __restrict__ wl,
                 int n, int nw, tsk::Tables T, float* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  size_t row = (size_t)i * nw;
  tsk::radiance_spec(T, d[3 * i], d[3 * i + 1], d[3 * i + 2], wl + row, nw,
                     out + row);
}

__global__ void __launch_bounds__(kThreads)
hit_spec_kernel(const float* __restrict__ d, const float* __restrict__ wl,
                int n, int nw, tsk::Tables T, float* __restrict__ rad_out,
                float* __restrict__ pdf_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  size_t row = (size_t)i * nw;
  tsk::radiance_spec(T, dx, dy, dz, wl + row, nw, rad_out + row);
  pdf_out[i] = tsk::mixture_pdf(T, dx, dy, dz, true);
}

__global__ void __launch_bounds__(kThreads)
nee_spec_kernel(const float* __restrict__ u, const float* __restrict__ wl,
                int n, int nw, tsk::Tables T, float* __restrict__ d_out,
                float* __restrict__ rad_out, float* __restrict__ pdf_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float d[3];
  bool pick_sky = tsk::nee_sample(T, u[2 * i], u[2 * i + 1], d);
  pdf_out[i] = d[2] >= 0.0f ? tsk::mixture_pdf(T, d[0], d[1], d[2], pick_sky)
                            : 0.0f;
  size_t row = (size_t)i * nw;
  tsk::radiance_spec(T, d[0], d[1], d[2], wl + row, nw, rad_out + row);
#pragma unroll
  for (int c = 0; c < 3; ++c) d_out[3 * i + c] = d[c];
}

tsk::Tables tables(const float* skyp, const float* skyr, const float* sun,
                   const float* ld, const float* misc, const float* gauss) {
  return tsk::Tables{skyp, skyr, sun, misc, gauss, ld};
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int tsk_sunsky_eval_spec(const float* d, const float* wl, int n, int nw,
                         const float* skyp, const float* skyr,
                         const float* sun, const float* ld,
                         const float* misc, float* out, void* stream) {
  if (n > 0)
    eval_spec_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        d, wl, n, nw, tables(skyp, skyr, sun, ld, misc, nullptr), out);
  return (int)cudaGetLastError();
}

int tsk_sunsky_hit_spec(const float* d, const float* wl, int n, int nw,
                        const float* skyp, const float* skyr,
                        const float* sun, const float* ld, const float* misc,
                        const float* gauss, float* rad, float* pdf,
                        void* stream) {
  if (n > 0)
    hit_spec_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        d, wl, n, nw, tables(skyp, skyr, sun, ld, misc, gauss), rad, pdf);
  return (int)cudaGetLastError();
}

int tsk_sunsky_nee_spec(const float* u, const float* wl, int n, int nw,
                        const float* skyp, const float* skyr,
                        const float* sun, const float* ld, const float* misc,
                        const float* gauss, float* d, float* rad, float* pdf,
                        void* stream) {
  if (n > 0)
    nee_spec_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        u, wl, n, nw, tables(skyp, skyr, sun, ld, misc, gauss), d, rad, pdf);
  return (int)cudaGetLastError();
}

}  // extern "C"
