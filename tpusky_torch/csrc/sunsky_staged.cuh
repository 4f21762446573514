// The sunsky state staged in shared memory, and the forward path that
// reads it: radiance, the mixture pdf and the NEE sample. The spectral
// kernels K9-K11 (csrc/sunsky_spectral.cu), the RGB kernels K1-K3
// (csrc/sunsky_kernels.cu), the RGB adjoints K5-K8 (csrc/sunsky_adjoint.cu)
// and the megakernel K4 (csrc/megakernel.cu) read their tables so; only
// K12 and K13 (csrc/sunsky_spectral_adjoint.cu) read them from global
// memory, through sunsky_core.cuh (K13's redrawn sample: nee_sample).
//
// What it changes against reading the tables from global memory:
// - every table a lane reads at a divergent address (a channel's sky
//   formula row, the spectral limb-darkening and sun rows, the sampler's
//   gaussian at its pick) is one or a few shared-memory loads, rows padded
//   to float4s; the warp-uniform ones (the pdf's 20 gaussians, misc) are
//   broadcasts;
// - values every lane computed alike are computed once a block, by the
//   same operations, so they stay bitwise: sin(half aperture)^2, the sun
//   cone's pdf and sun_phi - pi/2 (the staged structs' common fields);
// - the sun's segment and limb coordinates (acos, cbrt, sin, a division
//   and a sqrt) are computed only in the sun's disc, the one place that
//   reads them, and the sky formula's sqrt(cos theta) and cos theta + 0.01
//   once a lane, not once a channel; the divisions by cos theta + 0.01
//   (one a channel) and by 40 nm take a reciprocal and a remainder
//   (div_by), which gives the division's value bitwise;
// - the pdf's gaussian terms multiply by the table's 1/sigma where
//   mixture_pdf divides by sigma: the one change of arithmetic, within
//   ~1e-6 of the pdf.
// Radiance and sample are the global-memory functions' operation for
// operation. The functions below that read only the common fields (sky
// rows, misc, the gaussians and the once-a-block scalars) take either
// struct, StagedSpec or StagedRgb.
#pragma once

#include <map>
#include <mutex>

#include "sunsky_core.cuh"

namespace tsk {

// The spectral state as a block keeps it in shared memory (10,396 bytes).
struct StagedSpec {
  float4 sky[N_CH][3];       // channel c: k0-k3 | k4-k7 | k8, mean, 0, 0
  float4 ld[N_CH][2];        // channel c: l0-l3 | l4, l5, 0, 0
  float4 sun[N_SEG][N_CH];   // segment s, channel c: 4 elevation powers
  float4 gz[N_GAUSS];        // gaussian i: mu1, 1/sigma1, mu2, 1/sigma2
  float gamp[N_GAUSS];       // gaussian i: amplitude
  float gauss[14 * N_GAUSS];  // the table as packed (the sampler's)
  float misc[16];
  float sin_ap2;             // sin(half aperture)^2
  float sun_pdf;             // the cone's pdf, 1 / (2 pi (1 - cos_cut))
  float phi0;                // sun_phi - pi / 2
};

// The RGB state as a block keeps it (1,744 bytes): the spectral one's
// fields for 3 channels, without the limb-darkening rows (the RGB sun
// table folds them in) and without the sun table (45, 72), which only
// disc lanes read, from global memory.
struct StagedRgb {
  float4 sky[3][3];
  float4 gz[N_GAUSS];
  float gamp[N_GAUSS];
  float gauss[14 * N_GAUSS];
  float misc[16];
  float sin_ap2;
  float sun_pdf;
  float phi0;
};

// The sky rows of kCh channels (9 parameters, then the mean) as float4s;
// thread t of nt.
template <int kCh>
__device__ __forceinline__ void stage_sky(float4 (&rows)[kCh][3],
                                          const Tables& T, int t, int nt) {
  float* sky = &rows[0][0].x;
  for (int k = t; k < kCh * 12; k += nt) {
    int c = k / 12, j = k - 12 * c;
    sky[k] = j < 9 ? T.skyp[9 * c + j] : (j == 9 ? T.skyr[c] : 0.0f);
  }
}

// The common fields: misc, the gaussian table only when kGauss, and the
// once-a-block scalars.
template <bool kGauss, class Staged>
__device__ __forceinline__ void stage_common(Staged& S, const Tables& T,
                                             int t, int nt) {
  if (t < 16) S.misc[t] = T.misc[t];
  if (kGauss) {
    const float* __restrict__ g = T.gauss;
    for (int k = t; k < 14 * N_GAUSS; k += nt) S.gauss[k] = g[k];
    for (int i = t; i < N_GAUSS; i += nt) {
      S.gz[i] = make_float4(g[G_MU1 * N_GAUSS + i], g[G_INV_S1 * N_GAUSS + i],
                            g[G_MU2 * N_GAUSS + i], g[G_INV_S2 * N_GAUSS + i]);
      S.gamp[i] = g[G_A * N_GAUSS + i];
    }
  }
  if (t == 0) {
    float sin_ap = sinf(T.misc[M_HALF_AP]);
    S.sin_ap2 = sin_ap * sin_ap;
    S.sun_pdf = INV_TWO_PI_F / (1.0f - T.misc[M_COS_CUT]);
    S.phi0 = T.misc[M_SUN_PHI] - 0.5f * PI_F;
  }
}

// Stage T into S, the gaussian table only when kGauss; every thread of the
// block takes part, and the block waits for it.
template <bool kGauss>
__device__ __forceinline__ void stage_spec(StagedSpec& S, const Tables& T) {
  int t = threadIdx.x, nt = blockDim.x;
  stage_sky<N_CH>(S.sky, T, t, nt);
  float* ld = &S.ld[0][0].x;
  for (int k = t; k < N_CH * 8; k += nt) {
    int c = k / 8, j = k - 8 * c;
    ld[k] = j < N_LD ? T.ld[N_LD * c + j] : 0.0f;
  }
  // (45, 44) row-major is (45, 11) float4s: [s * 44 + 4 c + k]
  float* sun = &S.sun[0][0].x;
  for (int k = t; k < N_SEG * SUN_SPEC_F; k += nt) sun[k] = T.sun[k];
  stage_common<kGauss>(S, T, t, nt);
  __syncthreads();
}

template <bool kGauss>
__device__ __forceinline__ void stage_rgb(StagedRgb& S, const Tables& T) {
  int t = threadIdx.x, nt = blockDim.x;
  stage_sky<3>(S.sky, T, t, nt);
  stage_common<kGauss>(S, T, t, nt);
  __syncthreads();
}

// a / b from y = 1 / b (both correctly rounded): the quotient a * y
// corrected by its remainder, which is a / b correctly rounded wherever
// neither overflows nor underflows (Markstein's theorem): the IEEE
// division's value in three instructions where b is reused.
__device__ __forceinline__ float div_by(float a, float b, float y) {
  float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
}

// sky_geometry() at an above-horizon direction, with the sky formula's
// per-lane terms; the sun's segment (pos, xp) and limb powers (cp) are set
// only where hit_sun.
struct StagedGeom {
  float ct, ct1, sqrt_ct;    // cos(theta), ct + 0.01, safe_sqrt(ct)
  float inv_ct1;             // 1 / ct1
  float gamma, cos_gamma, cg2;
  bool hit_sun;
  int pos;
  float xp[4], cp[N_LD];
};

template <class Staged>
__device__ __forceinline__ StagedGeom staged_geometry(const Staged& S,
                                                      float dx, float dy,
                                                      float dz) {
  StagedGeom g;
  g.ct = dz;
  g.ct1 = dz + 0.01f;
  g.inv_ct1 = 1.0f / g.ct1;
  g.sqrt_ct = safe_sqrt(dz);
  g.gamma = sun_gamma(S.misc, dx, dy, dz);
  g.cos_gamma = cosf(g.gamma);
  g.cg2 = g.cos_gamma * g.cos_gamma;
  g.hit_sun = g.cos_gamma >= S.misc[M_COS_CUT];
  if (g.hit_sun) {
    float elevation = 0.5f * PI_F - safe_acos(g.ct);
    int pos = (int)floorf(cbrtf(2.0f * elevation / PI_F) * N_SEG);
    g.pos = min(max(pos, 0), N_SEG - 1);
    float bx = (float)g.pos / N_SEG;
    float x = fmaxf(elevation - 0.5f * PI_F * (bx * bx * bx), 0.0f);
    float sin_g = sinf(g.gamma);
    float cos_psi = safe_sqrt(1.0f - (sin_g * sin_g) / S.sin_ap2);
    g.xp[0] = 1.0f;
    g.xp[1] = x;
    g.xp[2] = x * x;
    g.xp[3] = x * x * x;
    g.cp[0] = 1.0f;
#pragma unroll
    for (int j = 1; j < N_LD; ++j) g.cp[j] = g.cp[j - 1] * cos_psi;
  }
  return g;
}

// sky_channel() of channel c from its staged row. 1 + cos(gamma)^2 is
// rounded after the square, as radiance() and radiance_spec() round it:
// left to nvcc, it was contracted into an FMA in K2 but not in K1 (one
// H100 build), which moved some of K2's radiances off radiance()'s.
template <class Staged>
__device__ __forceinline__ float staged_sky(const Staged& S, int c,
                                            const StagedGeom& g) {
  float4 a = S.sky[c][0], b = S.sky[c][1], m = S.sky[c][2];
  float c1 = 1.0f + a.x * expf(div_by(a.y, g.ct1, g.inv_ct1));
  float h = m.x;
  float base = 1.0f + h * h - 2.0f * h * g.cos_gamma;
  float chi = __fadd_rn(1.0f, g.cg2) / (base * safe_sqrt(base));
  float c2 = a.z + a.w * expf(b.x * g.gamma) + b.y * g.cg2 + b.z * chi
             + b.w * g.sqrt_ct;
  return c1 * c2 * m.y;
}

// Channel c's sun polynomial and limb darkening (in the disc)
__device__ __forceinline__ void spec_sun(const StagedSpec& S, int c,
                                         const StagedGeom& g, float* sun,
                                         float* ld) {
  float4 co = S.sun[g.pos][c], l0 = S.ld[c][0], l1 = S.ld[c][1];
  float s = 0.0f;
  s += co.x * g.xp[0];
  s += co.y * g.xp[1];
  s += co.z * g.xp[2];
  s += co.w * g.xp[3];
  float l = 0.0f;
  l += l0.x * g.cp[0];
  l += l0.y * g.cp[1];
  l += l0.z * g.cp[2];
  l += l0.w * g.cp[3];
  l += l1.x * g.cp[4];
  l += l1.y * g.cp[5];
  *sun = s;
  *ld = l;
}

// The radiance at one wavelength wl (nm): its two neighbouring channels'
// sky, sun and limb darkening, each lerped, then combined; 0 outside
// [320, 720] nm (sunsky_core.cuh's spec_lerp bounds).
__device__ __forceinline__ float spec_wavelength(const StagedSpec& S,
                                                 const StagedGeom& g,
                                                 float wl) {
  float nwl = div_by(wl - 320.0f, 40.0f, 1.0f / 40.0f);   // (wl - 320) / 40
  if (!(nwl >= 0.0f && nwl <= (float)(N_CH - 1))) return 0.0f;
  int lo = min(max((int)floorf(nwl), 0), N_CH - 1);
  int hi = min(lo + 1, N_CH - 1);
  float f = nwl - (float)lo;
  float sky0 = staged_sky(S, lo, g), sky1 = staged_sky(S, hi, g);
  float r = S.misc[M_SKY_SCALE] * ((1.0f - f) * sky0 + f * sky1);
  if (g.hit_sun) {
    float sun0, ld0, sun1, ld1;
    spec_sun(S, lo, g, &sun0, &ld0);
    spec_sun(S, hi, g, &sun1, &ld1);
    float sun = (1.0f - f) * sun0 + f * sun1;
    float ld = (1.0f - f) * ld0 + f * ld1;
    r += S.misc[M_SUN_SCALE] * sun * ld;
  }
  return r;
}

// Spectral radiance toward local direction d (model.py::_eval_spec_plain)
// at the render path's four wavelengths w; zero below the horizon. With
// kRolled the four go through one loop body (rotated through w), which
// takes fewer registers than four unrolled ones.
template <bool kRolled>
__device__ __forceinline__ float4 spec_radiance4(const StagedSpec& S,
                                                 float dx, float dy,
                                                 float dz, float4 w) {
  float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (dz >= 0.0f) {
    StagedGeom g = staged_geometry(S, dx, dy, dz);
    if (kRolled) {
#pragma unroll 1
      for (int k = 0; k < 4; ++k)
        w = make_float4(w.y, w.z, w.w, spec_wavelength(S, g, w.x));
      r = w;
    } else {
      r.x = spec_wavelength(S, g, w.x);
      r.y = spec_wavelength(S, g, w.y);
      r.z = spec_wavelength(S, g, w.z);
      r.w = spec_wavelength(S, g, w.w);
    }
  }
  return r;
}

// The same at nw wavelengths wl -> out
__device__ __forceinline__ void spec_radiance(const StagedSpec& S, float dx,
                                              float dy, float dz,
                                              const float* __restrict__ wl,
                                              int nw,
                                              float* __restrict__ out) {
  if (dz < 0.0f) {
    for (int w = 0; w < nw; ++w) out[w] = 0.0f;
    return;
  }
  StagedGeom g = staged_geometry(S, dx, dy, dz);
#pragma unroll 1
  for (int w = 0; w < nw; ++w) out[w] = spec_wavelength(S, g, wl[w]);
}

// RGB radiance toward local direction d (radiance(),
// model.py::_eval_rgb_plain) -> out; the sun table (45, 72) read from
// global memory in the disc alone. Zero below the horizon. The 24
// products of the sun polynomial are taken once for the three channels.
// radiance() leaves its sums to nvcc's contraction, which in its kernels
// made each channel's sum the FMA chain s = fma(coef, xp * cp, s) and its
// result fma(sky_scale, sky, sun_scale * s); here the roundings are
// written out (__fmul_rn, __fmaf_rn), so the values are radiance()'s
// whatever the code around them: left to contraction, this order of
// statements moved disc lanes off radiance()'s (one H100 build).
__device__ __forceinline__ void rgb_radiance(const StagedRgb& S,
                                             const float* __restrict__ sun,
                                             float dx, float dy, float dz,
                                             float out[3]) {
  if (dz < 0.0f) {
    out[0] = out[1] = out[2] = 0.0f;
    return;
  }
  StagedGeom g = staged_geometry(S, dx, dy, dz);
  float s[3] = {0.0f, 0.0f, 0.0f};
  if (g.hit_sun) {
    const float* __restrict__ coefs = sun + g.pos * SUN_F;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        float p = __fmul_rn(g.xp[k], g.cp[j]);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          s[c] = __fmaf_rn(__ldg(coefs + c * 24 + k * 6 + j), p, s[c]);
      }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = __fmul_rn(__fmaf_rn(S.misc[M_SKY_SCALE], staged_sky(S, c, g),
                                 __fmul_rn(S.misc[M_SUN_SCALE], s[c])),
                       CIE_Y_NORM);
}

// mixture_pdf() on the staged tables: the same coordinates, cone test and
// mix, the gaussian terms z = (x - mu) * (1/sigma); the gaussians' loop
// unrolled whole (kRolled false) or by 4.
template <bool kRolled, class Staged>
__device__ __forceinline__ float staged_pdf(const Staged& S, float dx,
                                            float dy, float dz,
                                            bool check_sun) {
  const float* misc = S.misc;
  float sin_theta = safe_sqrt(dx * dx + dy * dy);
  bool active = (dz >= 0.0f) && (sin_theta != 0.0f);
  float sun_pdf = 0.0f, sky_pdf = 0.0f;
  if (active) {
    float phi = atan2f(dy, dx);
    float az = fabsf(dz) - 1.0f;
    float len = sqrtf(dx * dx + dy * dy + az * az);
    float tz = 2.0f * safe_asin(0.5f * len);
    float theta = dz >= 0.0f ? tz : PI_F - tz;
    float phi_rel = phi - S.phi0;
    if (phi_rel < 0.0f) phi_rel += 2.0f * PI_F;
    if (phi_rel > 2.0f * PI_F) phi_rel -= 2.0f * PI_F;
    if (theta >= 0.0f && theta <= 0.5f * PI_F) {
      float tg = 0.0f;
#pragma unroll(kRolled ? 4 : N_GAUSS)
      for (int i = 0; i < N_GAUSS; ++i) {
        float4 q = S.gz[i];
        float z1 = (phi_rel - q.x) * q.y;
        float z2 = (theta - q.z) * q.w;
        tg += S.gamp[i] * expf(-0.5f * (z1 * z1 + z2 * z2));
      }
      sky_pdf = tg / fmaxf(sin_theta, SIN_OFFSET);
    }
    bool in_cone = misc[M_SUNX] * dx + misc[M_SUNY] * dy + misc[M_SUNZ] * dz
                   >= misc[M_COS_CUT];
    if (in_cone || !check_sun) sun_pdf = S.sun_pdf;
  }
  float w = misc[M_WMIX];
  return (1.0f - w) * sun_pdf + w * sky_pdf;
}

// The global tables with misc and the gaussian table pointing at the
// staged copies, for the unchanged functions of sunsky_core.cuh
// (nee_sample) to read shared memory.
template <class Staged>
__device__ __forceinline__ Tables staged_view(const Tables& T,
                                              const Staged& S) {
  return Tables{T.skyp, T.skyr, T.sun, S.misc, S.gauss, T.ld};
}

// The NEE kernels' lane order (K3, K11): a warp's chunk of kPasses x 32
// lanes, lane k * 32 + l valid[k] and a TGMM sky sample sky[k] in thread
// l, ranked by strategy with ballots, sky samples first, then the
// sun-cone samples: the thread at place q of that order computes lane
// ord[q], so that of the chunk's passes at most one holds both
// strategies and only the sun-cone passes reach the disc. Returns the
// number of valid lanes; ord is the warp's own, and the warp has synced.
template <int kPasses>
__device__ __forceinline__ int rank_by_strategy(const bool (&sky)[kPasses],
                                                const bool (&valid)[kPasses],
                                                int* ord) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned b_sky[kPasses], b_cone[kPasses];
  int n_sky = 0;
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    b_sky[k] = __ballot_sync(~0u, sky[k]);
    b_cone[k] = __ballot_sync(~0u, valid[k] && !sky[k]);
    n_sky += __popc(b_sky[k]);
  }
  int sky_before = 0, cone_before = 0;
#pragma unroll
  for (int k = 0; k < kPasses; ++k) {
    if (b_sky[k] >> lane & 1u)
      ord[sky_before + __popc(b_sky[k] & below)] = 32 * k + lane;
    else if (b_cone[k] >> lane & 1u)
      ord[n_sky + cone_before + __popc(b_cone[k] & below)] = 32 * k + lane;
    sky_before += __popc(b_sky[k]);
    cone_before += __popc(b_cone[k]);
  }
  __syncwarp();
  return sky_before + cone_before;
}

// A grid of as many kThreads-thread blocks of `kernel` as the SMs hold at
// once, at most one a kThreads lanes and at least one; the kernels walk the
// lanes grid-stride and stage their tables once a block. The card's
// capacity for a kernel is asked once a process (cudaGetDevice, two
// attribute queries and the occupancy query cost more host time than a
// launch: ~0.035 ms a call on an H100).
template <int kThreads, class Kernel>
inline int staged_blocks(Kernel kernel, int n) {
  static std::mutex mu;
  static std::map<const void*, int> full;
  int f;
  {
    std::lock_guard<std::mutex> lock(mu);
    int& cached = full[(const void*)kernel];
    if (cached == 0) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0);
      cached = sms * per_sm > 0 ? sms * per_sm : 1;
    }
    f = cached;
  }
  long long need = ((long long)n + kThreads - 1) / kThreads;
  return need < 1 ? 1 : (need < f ? (int)need : f);
}

template <int kThreads, class Kernel, class... Args>
inline void staged_launch(Kernel kernel, int n, void* stream, Args... args) {
  kernel<<<staged_blocks<kThreads>(kernel, n), kThreads, 0,
           (cudaStream_t)stream>>>(args...);
}

}  // namespace tsk
