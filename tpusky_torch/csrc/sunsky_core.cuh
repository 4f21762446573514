// Device functions shared by the sunsky kernels (K1-K3; spectral K9-K11
// through sunsky_staged.cuh), their adjoints (K5-K8, K12, K13) and the
// direct-illumination megakernel (K4): sky/sun radiance, the mixture
// pdf, the NEE direction sample, the reverse sweeps of all three, the
// counter-hash RNG and analytic shape intersection.
//
// Each function computes what the plain PyTorch versions in
// tpusky_torch/models/sunsky/model.py, render/sampler.py and
// render/shapes.py compute, in the same order of operations where that is
// free, with CUDA's own asinf/acosf/atan2f/erfinvf/cbrtf. The TPU kernels
// (tpusky/ops/pallas/sunsky_kernel.py) used polynomial stand-ins for
// those and a one-hot matrix product to fetch the sun segment; here the
// segment row is indexed directly.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tsk {

constexpr float PI_F = 3.14159265358979323846f;
constexpr float INV_PI_F = (float)(1.0 / 3.14159265358979323846);
constexpr float INV_TWO_PI_F = (float)(1.0 / (2.0 * 3.14159265358979323846));
constexpr float EPS_F32 = 5.9604644775390625e-08f;       // 2^-24
constexpr float SIN_OFFSET = EPS_F32;
constexpr float CIE_Y_NORM = (float)(1.0 / 106.7502593994140625);
// 0.5 * pi - 2^-24 rounded once from double, as the plain version does
constexpr float THETA_MAX =
    (float)(1.5707963267948966 - 5.9604644775390625e-08);
constexpr float SQRT2_F = (float)1.4142135623730951;
constexpr float HALF_SQRT_PI = (float)0.88622692545275801;
constexpr float RAY_EPS = 1e-4f;
constexpr float SHADOW_EPS = 1e-3f;

constexpr int N_SEG = 45;
constexpr int SUN_F = 72;          // 3 channels x 4 elevation x 6 limb powers
constexpr int N_GAUSS = 20;
constexpr int N_CH = 11;           // spectral channels, 320..720 nm
constexpr int SUN_SPEC_F = 44;     // 11 channels x 4 elevation powers
constexpr int N_LD = 6;            // limb-darkening powers

// misc row (16 floats), packed by ops/cuda/sunsky_kernel.py::_misc_row
// (RGB: the sun scale carries the RGB conversion constant) or
// _misc_row_spec (spectral: it does not)
enum {
  M_SUNX, M_SUNY, M_SUNZ, M_HALF_AP, M_SKY_SCALE, M_SUN_SCALE, M_SUN_PHI,
  M_WMIX, M_COS_CUT, M_SX, M_SY, M_SZ, M_TX, M_TY, M_TZ, M_SOFT
};
// gaussian table (14, 20), packed by _gauss_rows
enum {
  G_MU1, G_MU2, G_S1, G_S2, G_INV_S1, G_INV_S2, G_A, G_CDF, G_PMF,
  G_CA1, G_CB1, G_CA2, G_CB2, G_CDF_PREV
};

// RGB tables, or spectral ones (channels 11; sun (45, 44) laid out as
// [c * 4 + k]; ld set)
struct Tables {
  const float* __restrict__ skyp;   // (3, 9) sky formula parameters
  const float* __restrict__ skyr;   // (3,)   sky mean radiance
  const float* __restrict__ sun;    // (45, 72) sun coefficients
  const float* __restrict__ misc;   // (16,)
  const float* __restrict__ gauss;  // (14, 20)
  const float* __restrict__ ld;     // (11, 6) limb darkening; spectral only
};

__device__ __forceinline__ float safe_sqrt(float x) {
  return x > 0.0f ? sqrtf(x) : 0.0f;
}

__device__ __forceinline__ float safe_asin(float x) {
  if (fabsf(x) < 1.0f) return asinf(x);
  return x >= 1.0f ? 0.5f * PI_F : -0.5f * PI_F;
}

__device__ __forceinline__ float safe_acos(float x) {
  if (fabsf(x) < 1.0f) return acosf(x);
  return x >= 1.0f ? 0.0f : PI_F;
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// erfinv with one Newton polish step against erf (ops/math.py::erfinv)
__device__ __forceinline__ float erfinv_polished(float x) {
  float y0 = erfinvf(x);
  if (!isfinite(y0) || fabsf(y0) >= 5.9f) return y0;
  return y0 - (erff(y0) - x) * HALF_SQRT_PI * expf(y0 * y0);
}

// angle between the sun direction n and d, stable near 0 and pi
__device__ __forceinline__ float sun_gamma(const float* __restrict__ misc,
                                           float dx, float dy, float dz) {
  float nx = misc[M_SUNX], ny = misc[M_SUNY], nz = misc[M_SUNZ];
  float dot = nx * dx + ny * dy + nz * dz;
  float s = dot >= 0.0f ? 1.0f : -1.0f;
  float ex = dx - s * nx, ey = dy - s * ny, ez = dz - s * nz;
  float temp = 2.0f * safe_asin(0.5f * sqrtf(ex * ex + ey * ey + ez * ez));
  return dot >= 0.0f ? temp : PI_F - temp;
}

// What radiance() reads about an above-horizon direction (the spectral
// radiance's SpecGeom, sunsky_staged.cuh, is its counterpart): the angle
// to the sun, the sun's elevation segment and the coordinate in it (as
// powers), the limb coordinate (as powers) and the disc test.
struct SkyGeom {
  float ct;             // cos(theta) = dz >= 0
  float gamma, cos_gamma, cg2;
  int pos;              // sun segment
  float xp[4];          // x^k, x the elevation within the segment
  float cp[N_LD];       // cos_psi^j
  bool hit_sun;         // inside the sun's disc
};

__device__ __forceinline__ SkyGeom sky_geometry(
    const float* __restrict__ misc, float dx, float dy, float dz) {
  SkyGeom g;
  g.ct = dz;
  g.gamma = sun_gamma(misc, dx, dy, dz);
  g.cos_gamma = cosf(g.gamma);
  g.cg2 = g.cos_gamma * g.cos_gamma;

  // sun: 45-segment polynomial in elevation, limb darkening in cos_psi
  float elevation = 0.5f * PI_F - safe_acos(g.ct);
  int pos = (int)floorf(cbrtf(2.0f * elevation / PI_F) * N_SEG);
  g.pos = min(max(pos, 0), N_SEG - 1);
  float bx = (float)g.pos / N_SEG;
  float x = fmaxf(elevation - 0.5f * PI_F * (bx * bx * bx), 0.0f);
  float sin_ap = sinf(misc[M_HALF_AP]);
  float sin_g = sinf(g.gamma);
  float cos_psi = safe_sqrt(1.0f - (sin_g * sin_g) / (sin_ap * sin_ap));
  g.hit_sun = g.cos_gamma >= misc[M_COS_CUT];
  g.xp[0] = 1.0f;
  g.xp[1] = x;
  g.xp[2] = x * x;
  g.xp[3] = x * x * x;
  g.cp[0] = 1.0f;
#pragma unroll
  for (int j = 1; j < N_LD; ++j) g.cp[j] = g.cp[j - 1] * cos_psi;
  return g;
}

// Hosek-Wilkie sky formula of one channel (model.py::_sky_formula):
// parameters k9 (9,), mean radiance `mean`
__device__ __forceinline__ float sky_channel(const float* __restrict__ k9,
                                             float mean, const SkyGeom& g) {
  float c1 = 1.0f + k9[0] * expf(k9[1] / (g.ct + 0.01f));
  float h = k9[8];
  float base = 1.0f + h * h - 2.0f * h * g.cos_gamma;
  float chi = (1.0f + g.cg2) / (base * safe_sqrt(base));
  float c2 = k9[2] + k9[3] * expf(k9[4] * g.gamma) + k9[5] * g.cg2
             + k9[6] * chi + k9[7] * safe_sqrt(g.ct);
  return c1 * c2 * mean;
}

// RGB radiance toward local direction d (model.py::_eval_rgb_plain)
__device__ inline void radiance(const Tables& T, float dx, float dy,
                                float dz, float out[3]) {
  const float* __restrict__ misc = T.misc;
  if (dz < 0.0f) {
    out[0] = out[1] = out[2] = 0.0f;
    return;
  }
  SkyGeom g = sky_geometry(misc, dx, dy, dz);
  const float* __restrict__ coefs = T.sun + g.pos * SUN_F;

#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float sky = sky_channel(T.skyp + 9 * c, T.skyr[c], g);
    float sun = 0.0f;
    if (g.hit_sun) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 6; ++j)
          sun += coefs[c * 24 + k * 6 + j] * (g.xp[k] * g.cp[j]);
    }
    out[c] = (misc[M_SKY_SCALE] * sky + misc[M_SUN_SCALE] * sun) * CIE_Y_NORM;
  }
}

// The RGB small tables' cotangents in K5-K8's partial row (after the sun
// table's): skyp (3, 9), then skyr (3,), then misc (16,).
constexpr int ACC_SKYP = 0;
constexpr int ACC_SKYR = 27;
constexpr int ACC_MISC = 30;
constexpr int N_ACC = 46;
// The spectral small tables' cotangents (K12/K13's per-warp copy):
// skyp (11, 9), then skyr (11,), then ld (11, 6).
constexpr int SPEC_SKYP = 0;
constexpr int SPEC_SKYR = 99;
constexpr int SPEC_LD = 110;
constexpr int N_SPEC_SMALL = 176;

// How a reverse sweep adds a cotangent: into a thread's own registers, or
// into memory other threads share.
struct PlainAdd {
  __device__ __forceinline__ void operator()(float* p, float v) const {
    *p += v;
  }
};
struct AtomicAdd {
  __device__ __forceinline__ void operator()(float* p, float v) const {
    atomicAdd(p, v);
  }
};

// The reverse sweeps below are what torch autograd computes for the plain
// versions in model.py at one lane. They are gradient-safe where the plain
// versions are: zero through sqrt at 0 and through asin/acos at |x| >= 1;
// clamps pass the derivative at their bounds, as torch's do.

// The forward intermediates of the spectral radiance at an above-horizon
// direction that its reverse sweeps read (K12, K13; the RGB adjoints keep
// their own, sunsky_adjoint.cu's LaneGeom).
struct VjpGeom {
  float ct;                     // cos(theta) = dz
  float dot, s, ex, ey, ez, len, hc;   // gamma = 2 asin(|d - s n| / 2)
  float gamma, cos_g, sin_g, cg2;
  int pos;                      // sun segment
  float x_raw, xp[4];           // coordinate in the segment, its powers
  float sin_ap, q, cos_psi, cp[N_LD];  // cos_psi = sqrt(q), its powers
  float cos_cut, hard, eps, eps_c, ramp;   // the disc weight
};

__device__ __forceinline__ VjpGeom vjp_geometry(
    const float* __restrict__ misc, float dx, float dy, float dz) {
  VjpGeom v;
  float nx = misc[M_SUNX], ny = misc[M_SUNY], nz = misc[M_SUNZ];
  v.ct = dz;
  v.dot = nx * dx + ny * dy + nz * dz;
  v.s = v.dot >= 0.0f ? 1.0f : -1.0f;
  v.ex = dx - v.s * nx;
  v.ey = dy - v.s * ny;
  v.ez = dz - v.s * nz;
  v.len = sqrtf(v.ex * v.ex + v.ey * v.ey + v.ez * v.ez);
  v.hc = 0.5f * v.len;
  float temp = 2.0f * safe_asin(v.hc);
  v.gamma = v.dot >= 0.0f ? temp : PI_F - temp;
  v.cos_g = cosf(v.gamma);
  v.sin_g = sinf(v.gamma);
  v.cg2 = v.cos_g * v.cos_g;

  float elevation = 0.5f * PI_F - safe_acos(v.ct);
  int pos = (int)floorf(cbrtf(2.0f * elevation / PI_F) * N_SEG);
  v.pos = min(max(pos, 0), N_SEG - 1);
  float bx = (float)v.pos / N_SEG;
  v.x_raw = elevation - 0.5f * PI_F * (bx * bx * bx);
  float x = fmaxf(v.x_raw, 0.0f);
  v.xp[0] = 1.0f;
  v.xp[1] = x;
  v.xp[2] = x * x;
  v.xp[3] = x * x * x;
  v.sin_ap = sinf(misc[M_HALF_AP]);
  v.q = 1.0f - (v.sin_g * v.sin_g) / (v.sin_ap * v.sin_ap);
  v.cos_psi = safe_sqrt(v.q);
  v.cp[0] = 1.0f;
#pragma unroll
  for (int j = 1; j < N_LD; ++j) v.cp[j] = v.cp[j - 1] * v.cos_psi;
  v.cos_cut = misc[M_COS_CUT];
  v.hard = v.cos_g >= v.cos_cut ? 1.0f : 0.0f;
  v.eps = 0.5f * (1.0f - v.cos_cut) * misc[M_SOFT];
  v.eps_c = fmaxf(v.eps, 1e-12f);
  v.ramp = (v.cos_g - v.cos_cut) / v.eps_c + 0.5f;
  return v;
}

// Cotangents of the shared geometry's values: cos(theta), gamma,
// cos(gamma), cos^2(gamma), the segment coordinate x, cos_psi and the disc
// weight w.
struct GeomCot {
  float ct, gamma, cg, cg2, x, cpsi, w;
};

// The sky formula of one channel (sky_channel, model.py::_sky_formula)
// and its reverse for the cotangent gs of its value: adds its 9
// parameters' cotangents to ak[0..8] and its mean radiance's to *amean,
// with `add`, and the geometry's to c. Returns the value.
template <class Add>
__device__ __forceinline__ float sky_channel_vjp(
    const float* __restrict__ k9, float mean, const VjpGeom& v, float gs,
    float* ak, float* amean, GeomCot& c, Add add) {
  float a = k9[0], b = k9[1], kc = k9[2], kd = k9[3], ke = k9[4];
  float kf = k9[5], kg = k9[6], ki = k9[7], h = k9[8];
  float r = safe_sqrt(v.ct);
  float ct1 = v.ct + 0.01f;
  float e1 = expf(b / ct1);
  float c1 = 1.0f + a * e1;
  float base = 1.0f + h * h - 2.0f * h * v.cos_g;
  float sqb = safe_sqrt(base);
  float den = base * sqb;
  float chi = (1.0f + v.cg2) / den;
  float e2 = expf(ke * v.gamma);
  float c2 = kc + kd * e2 + kf * v.cg2 + kg * chi + ki * r;
  float sky = c1 * c2 * mean;

  add(amean, gs * c1 * c2);
  float g_c1 = gs * c2 * mean;
  float g_c2 = gs * c1 * mean;
  // c1 = 1 + a exp(b / (ct + 0.01))
  add(ak + 0, g_c1 * e1);
  float g_arg1 = g_c1 * a * e1;
  add(ak + 1, g_arg1 / ct1);
  c.ct -= g_arg1 * b / (ct1 * ct1);
  // c2 = c + d exp(e gamma) + f cg2 + g chi + i sqrt(ct)
  add(ak + 2, g_c2);
  add(ak + 3, g_c2 * e2);
  float g_arg2 = g_c2 * kd * e2;
  add(ak + 4, g_arg2 * v.gamma);
  c.gamma += g_arg2 * ke;
  add(ak + 5, g_c2 * v.cg2);
  c.cg2 += g_c2 * kf;
  add(ak + 6, g_c2 * chi);
  float g_chi = g_c2 * kg;
  add(ak + 7, g_c2 * r);
  if (v.ct > 0.0f) c.ct += g_c2 * ki * 0.5f / r;
  // chi = (1 + cg2) / (base sqrt(base))
  c.cg2 += g_chi / den;
  float g_den = -g_chi * chi / den;
  float g_base = g_den * sqb;
  if (base > 0.0f) g_base += g_den * base * 0.5f / sqb;
  // base = 1 + h^2 - 2 h cos_gamma
  add(ak + 8, g_base * (2.0f * h - 2.0f * v.cos_g));
  c.cg -= g_base * 2.0f * h;
  return sky;
}

// The reverse of the shared geometry, from its values' cotangents c: adds
// the direction's cotangent to dd and the misc row's (sun direction, half
// aperture, cos_cut, disc softness) to am. The disc mask is the
// straight-through surrogate of model.py::_disc_weight: its value is the
// hard cone test, its derivative the ramp clamp((cos_gamma - cos_cut) /
// eps + 1/2, 0, 1), eps = (1 - cos_cut) * disc_softness / 2, so lanes just
// outside the disc get a sun-direction cotangent.
__device__ __forceinline__ void geometry_vjp(const float* __restrict__ misc,
                                             const VjpGeom& v, GeomCot c,
                                             float dd[3], float* am) {
  c.cg += c.cg2 * 2.0f * v.cos_g;
  // disc surrogate: w = clamp(ramp, 0, 1) + (hard - that, detached)
  if (v.ramp >= 0.0f && v.ramp <= 1.0f) {
    c.cg += c.w / v.eps_c;
    am[M_COS_CUT] -= c.w / v.eps_c;
    float g_eps = -c.w * (v.cos_g - v.cos_cut) / (v.eps_c * v.eps_c);
    if (v.eps >= 1e-12f) {
      am[M_COS_CUT] -= 0.5f * misc[M_SOFT] * g_eps;
      am[M_SOFT] += 0.5f * (1.0f - v.cos_cut) * g_eps;
    }
  }
  // cos_psi = sqrt(1 - sin_g^2 / sin_ap^2) (zero derivative where q <= 0)
  if (v.q > 0.0f) {
    float g_q = c.cpsi * 0.5f / v.cos_psi;
    float sa2 = v.sin_ap * v.sin_ap;
    c.gamma += g_q * (-2.0f * v.sin_g / sa2) * v.cos_g;
    am[M_HALF_AP] += g_q * (2.0f * v.sin_g * v.sin_g / (sa2 * v.sin_ap))
                     * cosf(misc[M_HALF_AP]);
  }
  // x = max(elevation - break_x, 0), elevation = pi/2 - acos(ct)
  if (v.x_raw >= 0.0f && fabsf(v.ct) < 1.0f)
    c.ct += c.x / sqrtf(1.0f - v.ct * v.ct);
  // gamma = 2 asin(|d - s n| / 2), mirrored past 90 degrees
  c.gamma -= c.cg * v.sin_g;
  float g_temp = v.dot >= 0.0f ? c.gamma : -c.gamma;
  if (fabsf(v.hc) < 1.0f && v.len > 0.0f) {
    float g_len = g_temp / sqrtf(1.0f - v.hc * v.hc);   // 2 * asin' * 1/2
    float k = g_len / v.len;
    float gx = k * v.ex, gy = k * v.ey, gz = k * v.ez;
    dd[0] += gx;
    dd[1] += gy;
    dd[2] += gz;
    am[M_SUNX] -= v.s * gx;
    am[M_SUNY] -= v.s * gy;
    am[M_SUNZ] -= v.s * gz;
  }
  dd[2] += c.ct;
}

// A lane's cotangent of the sun table: row pos, entry ch * 24 + k * 6 + j
// is g[ch] * (xp[k] * cp[j]), an outer product of 13 floats; g is all zero
// on a lane without one.
struct SunCot {
  int pos;
  float g[3], xp[4], cp[N_LD];
};

// Spectral channel ch's sun polynomial and limb darkening at the lane's
// geometry, with their partials in x and cos_psi.
struct SpecSun {
  float sun, sun_x, ld, ld_cp;
};

__device__ __forceinline__ SpecSun spec_sun_channel(const Tables& T,
                                                    const VjpGeom& v,
                                                    int ch) {
  const float* __restrict__ co = T.sun + v.pos * SUN_SPEC_F + 4 * ch;
  const float* __restrict__ lc = T.ld + N_LD * ch;
  SpecSun s = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s.sun += co[k] * v.xp[k];
    if (k > 0) s.sun_x += co[k] * ((float)k * v.xp[k - 1]);
  }
#pragma unroll
  for (int j = 0; j < N_LD; ++j) {
    s.ld += lc[j] * v.cp[j];
    if (j > 0) s.ld_cp += lc[j] * ((float)j * v.cp[j - 1]);
  }
  return s;
}

// Wavelength wl's two dataset channels and its lerp weight between them;
// false outside [320, 720] nm (both channels are channel 10 at 720 nm).
__device__ __forceinline__ bool spec_lerp(float wl, int* lo, int* hi,
                                          float* f) {
  float nwl = (wl - 320.0f) / 40.0f;
  if (!(nwl >= 0.0f && nwl <= (float)(N_CH - 1))) return false;
  *lo = min(max((int)floorf(nwl), 0), N_CH - 1);
  *hi = min(*lo + 1, N_CH - 1);
  *f = nwl - (float)*lo;
  return true;
}

// a[lo] += (1 - f) x and a[hi] += f x, lo and hi known only at run time,
// by selection over the channels (a stays in registers)
__device__ __forceinline__ void lerp_add(float a[N_CH], int lo, int hi,
                                         float f, float x) {
#pragma unroll
  for (int ch = 0; ch < N_CH; ++ch) {
    if (ch == lo) a[ch] += (1.0f - f) * x;
    if (ch == hi) a[ch] += f * x;
  }
}

// a[i], i known only at run time, by selection
__device__ __forceinline__ float pick(const float a[N_CH], int i) {
  float v = a[0];
#pragma unroll
  for (int ch = 1; ch < N_CH; ++ch) v = ch == i ? a[ch] : v;
  return v;
}

// A lane's cotangents of the spectral radiance's per-channel values,
// folded from its wavelengths onto the 11 dataset channels. Everything after a
// wavelength's lerp between its two channels is linear in the cotangents,
// so channel ch's is the sum over the lane's wavelengths of the lerp
// weight times the wavelength's cotangent; the tables' cotangents then
// take one reverse a channel, not one a (wavelength, channel) pair.
struct SpecFold {
  unsigned need;        // bit ch: a wavelength with a cotangent reads ch
  bool sun;             // in the disc: sun and ld carry cotangents
  float sky[N_CH];      // of the sky formula's value (sky_scale not in)
  float sun_c[N_CH];    // of the sun polynomial's value
  float ld[N_CH];       // of the limb darkening's value
};

// The reverse of the spectral radiance (model.py::_eval_spec_plain) at one
// above-horizon lane, first pass: over its nw wavelengths wl with
// cotangents g, folds them onto the channels (F, zeroed by the caller)
// and takes what the sun polynomial and the limb darkening's values give
// at each wavelength: the misc row's sun scale (am), the disc weight's
// and the geometry's cotangents (c). The sky formula's reverse follows
// once a channel (sky_channel_vjp with F.sky), its table cotangents summed
// over a warp; then spec_dwl and geometry_vjp.
__device__ __forceinline__ void spec_fold(const Tables& T, const VjpGeom& v,
                                          const float* __restrict__ wl,
                                          const float* __restrict__ g,
                                          int nw, SpecFold& F, float am[16],
                                          GeomCot& c) {
  // the sun and limb darkening's values reach the cotangents in the disc
  // and, through the disc weight, on its ramp
  bool sun_value = v.hard != 0.0f || (v.ramp >= 0.0f && v.ramp <= 1.0f);
  float sun_scale = T.misc[M_SUN_SCALE];
  for (int w = 0; w < nw; ++w) {
    float G = g[w];
    int lo, hi;
    float f;
    if (G == 0.0f || !spec_lerp(wl[w], &lo, &hi, &f)) continue;
    F.need |= (1u << lo) | (1u << hi);
    lerp_add(F.sky, lo, hi, f, G);
    if (sun_value) {
      SpecSun s0 = spec_sun_channel(T, v, lo);
      SpecSun s1 = spec_sun_channel(T, v, hi);
      float sun = (1.0f - f) * s0.sun + f * s1.sun;
      float ld = (1.0f - f) * s0.ld + f * s1.ld;
      am[M_SUN_SCALE] += G * v.hard * sun * ld;
      c.w += G * sun_scale * sun * ld;
      if (v.hard != 0.0f) {
        float g_sun = G * sun_scale * ld;
        float g_ld = G * sun_scale * sun;
        F.sun = true;
        lerp_add(F.sun_c, lo, hi, f, g_sun);
        lerp_add(F.ld, lo, hi, f, g_ld);
        c.x += ((1.0f - f) * g_sun) * s0.sun_x + (f * g_sun) * s1.sun_x;
        c.cpsi += ((1.0f - f) * g_ld) * s0.ld_cp + (f * g_ld) * s1.ld_cp;
      }
    }
  }
}

// Each wavelength's cotangent (dwl, nw floats) after the sky's channel
// values sky (those F.need names) are known: through the lerp weight f of
// each of the sky, sun and limb-darkening lerps, 0 outside [320, 720] nm
// and, since both channels are channel 10 there, at 720 nm exactly.
__device__ __forceinline__ void spec_dwl(const Tables& T, const VjpGeom& v,
                                         const float* __restrict__ wl,
                                         const float* __restrict__ g,
                                         int nw, const float sky[N_CH],
                                         float* __restrict__ dwl) {
  float sky_scale = T.misc[M_SKY_SCALE], sun_scale = T.misc[M_SUN_SCALE];
  for (int w = 0; w < nw; ++w) {
    float G = g[w];
    int lo, hi;
    float f, g_f = 0.0f;
    if (G != 0.0f && spec_lerp(wl[w], &lo, &hi, &f)) {
      g_f = G * sky_scale * (pick(sky, hi) - pick(sky, lo));
      if (v.hard != 0.0f) {
        SpecSun s0 = spec_sun_channel(T, v, lo);
        SpecSun s1 = spec_sun_channel(T, v, hi);
        float sun = (1.0f - f) * s0.sun + f * s1.sun;
        float ld = (1.0f - f) * s0.ld + f * s1.ld;
        g_f += G * sun_scale * ld * (s1.sun - s0.sun)
               + G * sun_scale * sun * (s1.ld - s0.ld);
      }
    }
    dwl[w] = g_f / 40.0f;
  }
}

// mixture_pdf()'s forward state at one direction (model.py::compute_pdfs):
// its reverse keeps it, with the cotangent of the gaussian sum.
struct PdfLane {
  float sin_theta, stc, len;   // sin(theta), clamped; |(dx, dy, |dz| - 1)|
  float phi_rel, theta;        // the TGMM coordinates (0 where !sky)
  float sun_pdf, w;
  bool sky;                    // active and in range: the gaussian sum counts
  float g_tg;                  // the gaussian sum's cotangent (the reverse's)
};

// check_sun: count the cone pdf only inside the cone.
__device__ __forceinline__ PdfLane pdf_lane(const Tables& T, float dx,
                                            float dy, float dz,
                                            bool check_sun) {
  const float* __restrict__ misc = T.misc;
  PdfLane P;
  P.sin_theta = safe_sqrt(dx * dx + dy * dy);
  bool active = (dz >= 0.0f) && (P.sin_theta != 0.0f);
  P.stc = fmaxf(P.sin_theta, SIN_OFFSET);
  float phi = atan2f(dy, dx);
  float az = fabsf(dz) - 1.0f;
  P.len = sqrtf(dx * dx + dy * dy + az * az);
  float tz = 2.0f * safe_asin(0.5f * P.len);
  float theta = dz >= 0.0f ? tz : PI_F - tz;
  float phi_rel = phi - (misc[M_SUN_PHI] - 0.5f * PI_F);
  if (phi_rel < 0.0f) phi_rel += 2.0f * PI_F;
  if (phi_rel > 2.0f * PI_F) phi_rel -= 2.0f * PI_F;
  bool in_range = theta >= 0.0f && theta <= 0.5f * PI_F;
  float cos_cut = misc[M_COS_CUT];
  bool in_cone = misc[M_SUNX] * dx + misc[M_SUNY] * dy + misc[M_SUNZ] * dz
                 >= cos_cut;
  P.sun_pdf = (active && (in_cone || !check_sun))
                  ? INV_TWO_PI_F / (1.0f - cos_cut) : 0.0f;
  P.w = misc[M_WMIX];
  P.sky = active && in_range;
  P.phi_rel = P.sky ? phi_rel : 0.0f;
  P.theta = P.sky ? theta : 0.0f;
  P.g_tg = 0.0f;
  return P;
}

// exp(-|z|^2 / 2) of gaussian i at (phi_rel, theta), z = (x - mu) / sigma
__device__ __forceinline__ float gauss_exp(const float* __restrict__ g,
                                           int i, float phi_rel, float theta,
                                           float* z1, float* z2) {
  *z1 = (phi_rel - g[G_MU1 * N_GAUSS + i]) / g[G_S1 * N_GAUSS + i];
  *z2 = (theta - g[G_MU2 * N_GAUSS + i]) / g[G_S2 * N_GAUSS + i];
  return expf(-0.5f * (*z1 * *z1 + *z2 * *z2));
}

// Solid-angle pdf of the sky/sun mixture (model.py::compute_pdfs + lerp).
__device__ inline float mixture_pdf(const Tables& T, float dx, float dy,
                                   float dz, bool check_sun) {
  const float* __restrict__ g = T.gauss;
  PdfLane P = pdf_lane(T, dx, dy, dz, check_sun);
  float sky_pdf = 0.0f;
  if (P.sky) {
    float tg = 0.0f, z1, z2;
#pragma unroll 4
    for (int i = 0; i < N_GAUSS; ++i)
      tg += g[G_A * N_GAUSS + i] * gauss_exp(g, i, P.phi_rel, P.theta, &z1,
                                             &z2);
    sky_pdf = tg / P.stc;
  }
  return (1.0f - P.w) * P.sun_pdf + P.w * sky_pdf;
}

// Concentric square -> disk map (ops/warp.py)
__device__ __forceinline__ void disk_concentric(float u0, float u1,
                                                float* px, float* py) {
  float x = 2.0f * u0 - 1.0f;
  float y = 2.0f * u1 - 1.0f;
  bool is_zero = (x == 0.0f) && (y == 0.0f);
  bool q13 = fabsf(x) < fabsf(y);
  float r = q13 ? y : x;
  float rp = q13 ? x : y;
  float phi = 0.25f * PI_F * rp / (is_zero ? 1.0f : r);
  phi = q13 ? 0.5f * PI_F - phi : phi;
  phi = is_zero ? 0.0f : phi;
  *px = r * cosf(phi);
  *py = r * sinf(phi);
}

// A TGMM sky sample's discrete part (model.py::sample_sky): the gaussian
// picked over the normalised cdf (searchsorted, side=right), the reused
// uniform, and the two placement uniforms before their clamp.
struct SkyPick {
  int idx;
  float reused, p1, p2;
};

__device__ __forceinline__ SkyPick sky_pick(const float* __restrict__ g,
                                            float w, float u0, float u1) {
  SkyPick k;
  float su0 = clamp01(u0 / fmaxf(w, 1e-12f));
  int idx = 0;
#pragma unroll 4
  for (int i = 0; i < N_GAUSS; ++i) idx += g[G_CDF * N_GAUSS + i] <= su0;
  k.idx = min(idx, N_GAUSS - 1);
  float pmf = fmaxf(g[G_PMF * N_GAUSS + k.idx], 1e-37f);
  k.reused = clamp01((su0 - g[G_CDF_PREV * N_GAUSS + k.idx]) / pmf);
  k.p1 = (1.0f - k.reused) * g[G_CA1 * N_GAUSS + k.idx]
         + k.reused * g[G_CB1 * N_GAUSS + k.idx];
  k.p2 = (1.0f - u1) * g[G_CA2 * N_GAUSS + k.idx]
         + u1 * g[G_CB2 * N_GAUSS + k.idx];
  return k;
}

__device__ __forceinline__ float clamp_eps(float p) {
  return fminf(fmaxf(p, EPS_F32), 1.0f - EPS_F32);
}

// A sun-cone sample's point on the unit disk (model.py::sample_sun).
__device__ __forceinline__ void cone_disk(float w, float u0, float u1,
                                          float* px, float* py) {
  float su0 = clamp01((u0 - w) / fmaxf(1.0f - w, 1e-12f));
  disk_concentric(su0, u1, px, py);
}

// NEE direction sample (model.py::sample_direction): strategy pick, TGMM
// inverse CDF for the sky, uniform cone for the sun. Returns pick_sky.
__device__ inline bool nee_sample(const Tables& T, float u0, float u1,
                                  float d[3]) {
  const float* __restrict__ misc = T.misc;
  const float* __restrict__ g = T.gauss;
  float w = misc[M_WMIX];
  bool pick_sky = u0 < w;
  if (pick_sky) {
    SkyPick k = sky_pick(g, w, u0, u1);
    float ang1 = SQRT2_F * erfinv_polished(2.0f * clamp_eps(k.p1) - 1.0f)
                     * g[G_S1 * N_GAUSS + k.idx] + g[G_MU1 * N_GAUSS + k.idx];
    float ang2 = SQRT2_F * erfinv_polished(2.0f * clamp_eps(k.p2) - 1.0f)
                     * g[G_S2 * N_GAUSS + k.idx] + g[G_MU2 * N_GAUSS + k.idx];
    float phi = ang1 + misc[M_SUN_PHI] - 0.5f * PI_F;
    float theta = fminf(ang2, THETA_MAX);
    float st = sinf(theta);
    d[0] = cosf(phi) * st;
    d[1] = sinf(phi) * st;
    d[2] = cosf(theta);
  } else {
    float px, py;
    cone_disk(w, u0, u1, &px, &py);
    float cos_cut = misc[M_COS_CUT];
    float one_minus = 1.0f - cos_cut;
    float pn = px * px + py * py;
    float lz = cos_cut + one_minus * (1.0f - pn);
    float scale = safe_sqrt(one_minus * (2.0f - one_minus * pn));
    float lx = px * scale, ly = py * scale;
    d[0] = lx * misc[M_SX] + ly * misc[M_TX] + lz * misc[M_SUNX];
    d[1] = lx * misc[M_SY] + ly * misc[M_TY] + lz * misc[M_SUNY];
    d[2] = lx * misc[M_SZ] + ly * misc[M_TZ] + lz * misc[M_SUNZ];
  }
  return pick_sky;
}

// NEE block: sample + pdf + radiance (model.py::_sample_eval_rgb_plain)
__device__ __forceinline__ float nee(const Tables& T, float u0, float u1,
                                     float d[3], float rad[3]) {
  bool pick_sky = nee_sample(T, u0, u1, d);
  float pdf = d[2] >= 0.0f ? mixture_pdf(T, d[0], d[1], d[2], pick_sky)
                           : 0.0f;
  radiance(T, d[0], d[1], d[2], rad);
  return pdf;
}

// ---- reverse of the mixture pdf and of the sample's placement ----

// mixture_pdf()'s forward state for the pdf's cotangent g_pdf: the gaussian
// sum is needed, and has a cotangent, only where g_pdf is not 0. The sum
// and its reverse are taken by the caller (adjoint_common.cuh's
// gauss_vjp_warp, the table's cotangent summed over a warp's lanes). The
// table is read as mixture_pdf() reads it (the amplitude row folds in the
// weight and the truncated volume), so its cotangent is the packed
// table's and autograd through `_gauss_rows` takes it to the state.
__device__ __forceinline__ PdfLane pdf_lane_vjp(const Tables& T, float dx,
                                                float dy, float dz,
                                                bool check_sun,
                                                float g_pdf) {
  PdfLane P = pdf_lane(T, dx, dy, dz, check_sun);
  P.sky = P.sky && g_pdf != 0.0f;
  if (!P.sky) P.phi_rel = P.theta = 0.0f;
  P.g_tg = P.sky ? g_pdf * P.w / P.stc : 0.0f;
  return P;
}

// mixture_pdf()'s reverse after its gaussian sum tg, given the
// coordinates' cotangents g_phi, g_theta: adds the direction's cotangent
// to dd and the misc row's (the sun's phi, cos_cut through the cone pdf,
// and the mixture weight unless detach_w) to am.
__device__ __forceinline__ void pdf_vjp_tail(const float* __restrict__ misc,
                                             float dx, float dy, float dz,
                                             const PdfLane& P, float tg,
                                             float g_pdf, bool detach_w,
                                             float g_phi, float g_theta,
                                             float dd[3], float* am) {
  float sky_pdf = P.sky ? tg / P.stc : 0.0f;
  // pdf = (1 - w) sun_pdf + w sky_pdf
  if (!detach_w) am[M_WMIX] += g_pdf * (sky_pdf - P.sun_pdf);
  if (P.sun_pdf != 0.0f) {
    float om = 1.0f - misc[M_COS_CUT];
    am[M_COS_CUT] += g_pdf * (1.0f - P.w) * INV_TWO_PI_F / (om * om);
  }
  if (!P.sky) return;
  // sky_pdf = tg / max(sin_theta, SIN_OFFSET), sin_theta = |(dx, dy)|
  if (P.sin_theta >= SIN_OFFSET) {
    float g_s = -(g_pdf * P.w) * tg / (P.stc * P.stc);
    float k = g_s / P.sin_theta;
    dd[0] += k * dx;
    dd[1] += k * dy;
  }
  // phi_rel = atan2(dy, dx) - (sun_phi - pi/2), wrapped
  am[M_SUN_PHI] -= g_phi;
  float r2 = dx * dx + dy * dy;
  dd[0] -= g_phi * dy / r2;
  dd[1] += g_phi * dx / r2;
  // theta = 2 asin(|(dx, dy, |dz| - 1)| / 2) (dz >= 0 here)
  float hc = 0.5f * P.len;
  if (hc < 1.0f && P.len > 0.0f) {
    float k = g_theta / sqrtf(1.0f - hc * hc) / P.len;
    float sz = dz > 0.0f ? 1.0f : (dz < 0.0f ? -1.0f : 0.0f);
    dd[0] += k * dx;
    dd[1] += k * dy;
    dd[2] += k * (fabsf(dz) - 1.0f) * sz;
  }
}

// erfinv_polished(x) and erfinv's derivative there, c exp(y^2), c =
// sqrt(pi) / 2. Autograd of the plain version (ops/math.py::erfinv)
// differentiates the Newton step too: it multiplies this by
// (1 - 2 c y0 r e), e = exp(y0^2), where r = erf(y0) - x is the step's
// residual, in float32 the rounding of erf near +-1 (~6e-8). That factor
// is noise: below 1e-6 of the derivative for p (x = 2p - 1) in
// [1e-2, 1 - 1e-2], 3e-4 at 1e-4 from a bound, 6e-2 at 1e-6.
__device__ __forceinline__ float erfinv_polished_vjp(float x, float* dydx) {
  float y = erfinv_polished(x);
  *dydx = HALF_SQRT_PI * expf(y * y);
  return y;
}

// The reverse of nee_sample()'s placement for the cotangent gd of the
// sampled direction, as the plain version keeps it attached
// (model.py::sample_direction): the strategy pick, the gaussian pick and
// the reused uniform are detached; a sky sample's mu, sigma and truncation
// CDFs of its gaussian and the sun's phi, and a cone sample's cos_cut and
// sun frame, are attached. Adds the misc row's cotangents to am; a sky
// sample returns the index of its gaussian and writes that gaussian's
// cotangents to place (rows place_row(0..7)), a cone sample returns -1
// and zeros. The caller sums place over lanes that picked the same
// gaussian.
constexpr int N_PLACE = 8;

// the gaussian table's row of place[c]: mu1, sigma1, mu2, sigma2, then
// the truncation CDFs ca1, cb1, ca2, cb2
__device__ __forceinline__ int place_row(int c) {
  return c < 4 ? (c & 1) * (G_S1 - G_MU1) + (c >> 1) * (G_MU2 - G_MU1)
               : G_CA1 + (c - 4);
}

__device__ __forceinline__ int nee_place_vjp(const Tables& T, float u0,
                                             float u1, const float gd[3],
                                             float* am,
                                             float place[N_PLACE]) {
  const float* __restrict__ misc = T.misc;
  const float* __restrict__ g = T.gauss;
  float w = misc[M_WMIX];
#pragma unroll
  for (int k = 0; k < N_PLACE; ++k) place[k] = 0.0f;
  if (u0 < w) {
    SkyPick k = sky_pick(g, w, u0, u1);
    int idx = k.idx;
    float reused = k.reused, p1r = k.p1, p2r = k.p2;
    float p1 = clamp_eps(p1r), p2 = clamp_eps(p2r);
    float dy1, dy2;
    float y1 = erfinv_polished_vjp(2.0f * p1 - 1.0f, &dy1);
    float y2 = erfinv_polished_vjp(2.0f * p2 - 1.0f, &dy2);
    float s1 = g[G_S1 * N_GAUSS + idx], s2 = g[G_S2 * N_GAUSS + idx];
    float ang1 = SQRT2_F * y1 * s1 + g[G_MU1 * N_GAUSS + idx];
    float ang2 = SQRT2_F * y2 * s2 + g[G_MU2 * N_GAUSS + idx];
    float phi = ang1 + misc[M_SUN_PHI] - 0.5f * PI_F;
    float theta = fminf(ang2, THETA_MAX);
    float st = sinf(theta), ct = cosf(theta);
    float sp = sinf(phi), cph = cosf(phi);
    // d = (cos phi sin theta, sin phi sin theta, cos theta)
    float g_theta = (gd[0] * cph + gd[1] * sp) * ct - gd[2] * st;
    float g_phi = (gd[1] * cph - gd[0] * sp) * st;
    float g_ang2 = ang2 <= THETA_MAX ? g_theta : 0.0f;
    am[M_SUN_PHI] += g_phi;
    // ang = sqrt(2) erfinv(2 p - 1) sigma + mu, p = clamp(lerp(ca, cb, u))
    place[0] = g_phi;
    place[1] = g_phi * (SQRT2_F * y1);
    place[2] = g_ang2;
    place[3] = g_ang2 * (SQRT2_F * y2);
    if (p1r >= EPS_F32 && p1r <= 1.0f - EPS_F32) {
      float gp = 2.0f * dy1 * (g_phi * SQRT2_F * s1);
      place[4] = gp * (1.0f - reused);
      place[5] = gp * reused;
    }
    if (p2r >= EPS_F32 && p2r <= 1.0f - EPS_F32) {
      float gp = 2.0f * dy2 * (g_ang2 * SQRT2_F * s2);
      place[6] = gp * (1.0f - u1);
      place[7] = gp * u1;
    }
    return idx;
  }
  float px, py;
  cone_disk(w, u0, u1, &px, &py);
  float cos_cut = misc[M_COS_CUT];
  float om = 1.0f - cos_cut;
  float pn = px * px + py * py;
  float lz = cos_cut + om * (1.0f - pn);
  float q = om * (2.0f - om * pn);
  float scale = safe_sqrt(q);
  float lx = px * scale, ly = py * scale;
  // d = lx s + ly t + lz n
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    am[M_SX + k] += gd[k] * lx;
    am[M_TX + k] += gd[k] * ly;
    am[M_SUNX + k] += gd[k] * lz;
  }
  float g_lx = gd[0] * misc[M_SX] + gd[1] * misc[M_SY] + gd[2] * misc[M_SZ];
  float g_ly = gd[0] * misc[M_TX] + gd[1] * misc[M_TY] + gd[2] * misc[M_TZ];
  float g_lz = gd[0] * misc[M_SUNX] + gd[1] * misc[M_SUNY]
               + gd[2] * misc[M_SUNZ];
  // lz = cos_cut + om (1 - pn), scale = sqrt(om (2 - om pn)), om =
  // 1 - cos_cut
  float g_om = g_lz * (1.0f - pn);
  if (q > 0.0f)
    g_om += (g_lx * px + g_ly * py) * 0.5f / scale * (2.0f - 2.0f * om * pn);
  am[M_COS_CUT] += g_lz - g_om;
  return -1;
}

// ---- counter-hash RNG (render/sampler.py, kind "independent") ----

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float rand_unit(uint32_t lane, uint32_t dim,
                                           uint32_t c, uint32_t seed) {
  uint32_t dc = dim * 64u + c;
  uint32_t x = hash_u32(lane * 0x85EBCA6Bu + dc * 0xC2B2AE35u + seed);
  x = hash_u32(x ^ (lane + 0x9E3779B9u));
  x = hash_u32(x + dc);
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

// ---- analytic shapes (render/shapes.py): 0 sphere, 1 rectangle, 2 disk ----
// row: 12 floats, the world->object affine map [A (row-major 3x3), b].
// Returns t (+inf on a miss) and the unnormalised world normal.

__device__ inline float isect_shape(int kind, const float* __restrict__ row,
                             const float o[3], const float d[3], float n[3]) {
  float ol[3], dl[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ol[i] = o[0] * row[3 * i] + o[1] * row[3 * i + 1] + o[2] * row[3 * i + 2]
            + row[9 + i];
    dl[i] = d[0] * row[3 * i] + d[1] * row[3 * i + 1] + d[2] * row[3 * i + 2];
  }
  float t, nl[3];
  if (kind == 0) {
    float a = dl[0] * dl[0] + dl[1] * dl[1] + dl[2] * dl[2];
    float b = 2.0f * (ol[0] * dl[0] + ol[1] * dl[1] + ol[2] * dl[2]);
    float c = (ol[0] * ol[0] + ol[1] * ol[1] + ol[2] * ol[2]) - 1.0f;
    float disc = b * b - 4.0f * a * c;
    t = INFINITY;
    if (disc >= 0.0f) {       // a ray that misses skips the divisions
      float sb = (b > 0.0f) ? 1.0f : ((b < 0.0f) ? -1.0f : 0.0f);
      float q = -0.5f * (b + sb * safe_sqrt(disc));
      float t0 = q / a;
      float t1 = c / (q == 0.0f ? 1.0f : q);
      float tn = fminf(t0, t1), tf = fmaxf(t0, t1);
      t = tn > RAY_EPS ? tn : (tf > RAY_EPS ? tf : INFINITY);
    }
    float tc = isfinite(t) ? t : 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) nl[i] = ol[i] + tc * dl[i];
  } else {
    float t_pl = -ol[2] / (dl[2] == 0.0f ? 1.0f : dl[2]);
    float px = ol[0] + t_pl * dl[0];
    float py = ol[1] + t_pl * dl[1];
    bool inside = kind == 2 ? (px * px + py * py <= 1.0f)
                            : (fabsf(px) <= 1.0f && fabsf(py) <= 1.0f);
    bool ok = dl[2] != 0.0f && t_pl > RAY_EPS && inside;
    t = ok ? t_pl : INFINITY;
    nl[0] = 0.0f; nl[1] = 0.0f; nl[2] = 1.0f;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    n[i] = nl[0] * row[i] + nl[1] * row[3 + i] + nl[2] * row[6 + i];
  return t;
}

}  // namespace tsk
