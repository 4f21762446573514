// Device functions shared by the sunsky kernels (K1-K3, spectral K9-K11)
// and the direct-illumination megakernel (K4): sky/sun radiance, the
// mixture pdf, the NEE direction sample, the counter-hash RNG and analytic
// shape intersection.
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

// What radiance() and radiance_spec() share about an above-horizon
// direction: the angle to the sun, the sun's elevation segment and the
// coordinate in it (as powers), the limb coordinate (as powers) and the
// disc test.
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

// One spectral dataset channel c at geometry g: the sky, and in the disc
// the sun polynomial and the limb darkening (0 outside it)
__device__ __forceinline__ void spec_channel(const Tables& T,
                                             const SkyGeom& g, int c,
                                             float* sky, float* sun,
                                             float* ld) {
  *sky = sky_channel(T.skyp + 9 * c, T.skyr[c], g);
  float s = 0.0f, l = 0.0f;
  if (g.hit_sun) {
    const float* __restrict__ co = T.sun + g.pos * SUN_SPEC_F + 4 * c;
    const float* __restrict__ lc = T.ld + N_LD * c;
#pragma unroll
    for (int k = 0; k < 4; ++k) s += co[k] * g.xp[k];
#pragma unroll
    for (int j = 0; j < N_LD; ++j) l += lc[j] * g.cp[j];
  }
  *sun = s;
  *ld = l;
}

// Spectral radiance toward local direction d at the lane's nw wavelengths
// wl (nm) -> out (model.py::_eval_spec_plain). Per wavelength only its two
// neighbouring dataset channels are evaluated; sky, sun and limb
// darkening are each lerped between them, then combined. Wavelengths
// outside [320, 720] nm and directions below the horizon give 0.
__device__ inline void radiance_spec(const Tables& T, float dx, float dy,
                                     float dz, const float* __restrict__ wl,
                                     int nw, float* __restrict__ out) {
  const float* __restrict__ misc = T.misc;
  if (dz < 0.0f) {
    for (int w = 0; w < nw; ++w) out[w] = 0.0f;
    return;
  }
  SkyGeom g = sky_geometry(misc, dx, dy, dz);
  float sky_scale = misc[M_SKY_SCALE], sun_scale = misc[M_SUN_SCALE];
  for (int w = 0; w < nw; ++w) {
    float nwl = (wl[w] - 320.0f) / 40.0f;
    if (!(nwl >= 0.0f && nwl <= (float)(N_CH - 1))) {
      out[w] = 0.0f;
      continue;
    }
    int lo = min(max((int)floorf(nwl), 0), N_CH - 1);
    int hi = min(lo + 1, N_CH - 1);
    float f = nwl - (float)lo;
    float sky0, sun0, ld0, sky1, sun1, ld1;
    spec_channel(T, g, lo, &sky0, &sun0, &ld0);
    spec_channel(T, g, hi, &sky1, &sun1, &ld1);
    float r = sky_scale * ((1.0f - f) * sky0 + f * sky1);
    if (g.hit_sun) {
      float sun = (1.0f - f) * sun0 + f * sun1;
      float ld = (1.0f - f) * ld0 + f * ld1;
      r += sun_scale * sun * ld;
    }
    out[w] = r;
  }
}

// Cotangent accumulator layout of the small tables (radiance_vjp's acc):
// skyp (3, 9), then skyr (3,), then misc (16,).
constexpr int ACC_SKYP = 0;
constexpr int ACC_SKYR = 27;
constexpr int ACC_MISC = 30;
constexpr int N_ACC = 46;

// Reverse-mode derivative of radiance(): what torch autograd computes for
// model.py::_eval_rgb_plain at one direction, given the cotangent g of its
// RGB output. Adds the direction's cotangent to dd, the small tables'
// cotangents to acc (layout ACC_*; only what radiance() reads is touched)
// and the sun row's to sun_acc (the (45, 72) table in shared memory, by
// atomics: lanes of a block share rows). Gradient-safe where the plain
// version is: zero through sqrt at 0 and through asin/acos at |x| >= 1.
// The disc mask is the straight-through surrogate of model.py::_disc_weight:
// its value is the hard cone test, its derivative the ramp
// clamp((cos_gamma - cos_cut) / eps + 1/2, 0, 1), eps = (1 - cos_cut) *
// disc_softness / 2, so lanes just outside the disc get a sun-direction
// cotangent. Clamps pass the derivative at their bounds, as torch's do.
__device__ inline void radiance_vjp(const Tables& T, float dx, float dy,
                                    float dz, const float g[3], float dd[3],
                                    float acc[N_ACC], float* sun_acc) {
  if (dz < 0.0f) return;                  // below the horizon: radiance 0
  const float* __restrict__ misc = T.misc;
  // ---- forward, as radiance() ----
  float nx = misc[M_SUNX], ny = misc[M_SUNY], nz = misc[M_SUNZ];
  float dot = nx * dx + ny * dy + nz * dz;
  float s = dot >= 0.0f ? 1.0f : -1.0f;
  float ex = dx - s * nx, ey = dy - s * ny, ez = dz - s * nz;
  float len = sqrtf(ex * ex + ey * ey + ez * ez);
  float hc = 0.5f * len;
  float temp = 2.0f * safe_asin(hc);
  float gamma = dot >= 0.0f ? temp : PI_F - temp;
  float ct = dz;
  float cos_g = cosf(gamma);
  float sin_g = sinf(gamma);
  float cg2 = cos_g * cos_g;

  float elevation = 0.5f * PI_F - safe_acos(ct);
  int pos = (int)floorf(cbrtf(2.0f * elevation / PI_F) * N_SEG);
  pos = min(max(pos, 0), N_SEG - 1);
  float bx = (float)pos / N_SEG;
  float x_raw = elevation - 0.5f * PI_F * (bx * bx * bx);
  float x = fmaxf(x_raw, 0.0f);
  float half_ap = misc[M_HALF_AP];
  float sin_ap = sinf(half_ap);
  float q = 1.0f - (sin_g * sin_g) / (sin_ap * sin_ap);
  float cos_psi = safe_sqrt(q);
  float cos_cut = misc[M_COS_CUT];
  float hard = cos_g >= cos_cut ? 1.0f : 0.0f;
  float soft = misc[M_SOFT];
  float eps = 0.5f * (1.0f - cos_cut) * soft;
  float eps_c = fmaxf(eps, 1e-12f);
  float ramp = (cos_g - cos_cut) / eps_c + 0.5f;
  float xp[4] = {1.0f, x, x * x, x * x * x};
  float cp[6];
  cp[0] = 1.0f;
#pragma unroll
  for (int j = 1; j < 6; ++j) cp[j] = cp[j - 1] * cos_psi;
  const float* __restrict__ coefs = T.sun + pos * SUN_F;
  float* __restrict__ sun_row = sun_acc + pos * SUN_F;
  float sky_scale = misc[M_SKY_SCALE], sun_scale = misc[M_SUN_SCALE];

  // ---- reverse ----
  float g_ct = 0.0f, g_gamma = 0.0f, g_cg = 0.0f, g_cg2 = 0.0f;
  float g_x = 0.0f, g_cpsi = 0.0f, g_w = 0.0f;
  float r = safe_sqrt(ct);
  float ct1 = ct + 0.01f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float G = g[c] * CIE_Y_NORM;
    // sun polynomial and its partials in x and cos_psi
    float sun = 0.0f, sun_x = 0.0f, sun_cp = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        float co = coefs[c * 24 + k * 6 + j];
        sun += co * (xp[k] * cp[j]);
        if (k > 0) sun_x += co * ((float)k * xp[k - 1] * cp[j]);
        if (j > 0) sun_cp += co * (xp[k] * (float)j * cp[j - 1]);
      }
    // sky formula (model.py::_sky_formula)
    const float* __restrict__ k9 = T.skyp + 9 * c;
    float a = k9[0], b = k9[1], kc = k9[2], kd = k9[3], ke = k9[4];
    float kf = k9[5], kg = k9[6], ki = k9[7], h = k9[8];
    float e1 = expf(b / ct1);
    float c1 = 1.0f + a * e1;
    float base = 1.0f + h * h - 2.0f * h * cos_g;
    float sqb = safe_sqrt(base);
    float den = base * sqb;
    float chi = (1.0f + cg2) / den;
    float e2 = expf(ke * gamma);
    float c2 = kc + kd * e2 + kf * cg2 + kg * chi + ki * r;
    float mean = T.skyr[c];
    float sky = c1 * c2 * mean;

    // out = (sky_scale * sky + w * sun_scale * sun) * CIE_Y_NORM
    acc[ACC_MISC + M_SKY_SCALE] += G * sky;
    acc[ACC_MISC + M_SUN_SCALE] += G * hard * sun;
    g_w += G * sun_scale * sun;
    float g_sun = G * sun_scale * hard;
    if (g_sun != 0.0f) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 6; ++j)
          atomicAdd(sun_row + c * 24 + k * 6 + j, g_sun * (xp[k] * cp[j]));
      g_x += g_sun * sun_x;
      g_cpsi += g_sun * sun_cp;
    }
    float g_sky = G * sky_scale;
    acc[ACC_SKYR + c] += g_sky * c1 * c2;
    float g_c1 = g_sky * c2 * mean;
    float g_c2 = g_sky * c1 * mean;
    float* __restrict__ ak = acc + ACC_SKYP + 9 * c;
    // c1 = 1 + a exp(b / (ct + 0.01))
    ak[0] += g_c1 * e1;
    float g_arg1 = g_c1 * a * e1;
    ak[1] += g_arg1 / ct1;
    g_ct -= g_arg1 * b / (ct1 * ct1);
    // c2 = c + d exp(e gamma) + f cg2 + g chi + i sqrt(ct)
    ak[2] += g_c2;
    ak[3] += g_c2 * e2;
    float g_arg2 = g_c2 * kd * e2;
    ak[4] += g_arg2 * gamma;
    g_gamma += g_arg2 * ke;
    ak[5] += g_c2 * cg2;
    g_cg2 += g_c2 * kf;
    ak[6] += g_c2 * chi;
    float g_chi = g_c2 * kg;
    ak[7] += g_c2 * r;
    if (ct > 0.0f) g_ct += g_c2 * ki * 0.5f / r;
    // chi = (1 + cg2) / (base sqrt(base))
    g_cg2 += g_chi / den;
    float g_den = -g_chi * chi / den;
    float g_base = g_den * sqb;
    if (base > 0.0f) g_base += g_den * base * 0.5f / sqb;
    // base = 1 + h^2 - 2 h cos_gamma
    ak[8] += g_base * (2.0f * h - 2.0f * cos_g);
    g_cg -= g_base * 2.0f * h;
  }
  g_cg += g_cg2 * 2.0f * cos_g;

  // disc surrogate: w = clamp(ramp, 0, 1) + (hard - that, detached)
  if (ramp >= 0.0f && ramp <= 1.0f) {
    g_cg += g_w / eps_c;
    acc[ACC_MISC + M_COS_CUT] -= g_w / eps_c;
    float g_eps = -g_w * (cos_g - cos_cut) / (eps_c * eps_c);
    if (eps >= 1e-12f) {
      acc[ACC_MISC + M_COS_CUT] -= 0.5f * soft * g_eps;
      acc[ACC_MISC + M_SOFT] += 0.5f * (1.0f - cos_cut) * g_eps;
    }
  }
  // cos_psi = sqrt(1 - sin_g^2 / sin_ap^2) (zero derivative where q <= 0)
  if (q > 0.0f) {
    float g_q = g_cpsi * 0.5f / cos_psi;
    float sa2 = sin_ap * sin_ap;
    g_gamma += g_q * (-2.0f * sin_g / sa2) * cos_g;
    acc[ACC_MISC + M_HALF_AP] +=
        g_q * (2.0f * sin_g * sin_g / (sa2 * sin_ap)) * cosf(half_ap);
  }
  // x = max(elevation - break_x, 0), elevation = pi/2 - acos(ct)
  if (x_raw >= 0.0f && fabsf(ct) < 1.0f)
    g_ct += g_x / sqrtf(1.0f - ct * ct);
  // gamma = 2 asin(|d - s n| / 2), mirrored past 90 degrees
  g_gamma -= g_cg * sin_g;
  float g_temp = dot >= 0.0f ? g_gamma : -g_gamma;
  if (fabsf(hc) < 1.0f && len > 0.0f) {
    float g_len = g_temp / sqrtf(1.0f - hc * hc);   // 2 * asin' * 1/2
    float k = g_len / len;
    float gx = k * ex, gy = k * ey, gz = k * ez;
    dd[0] += gx;
    dd[1] += gy;
    dd[2] += gz;
    acc[ACC_MISC + M_SUNX] -= s * gx;
    acc[ACC_MISC + M_SUNY] -= s * gy;
    acc[ACC_MISC + M_SUNZ] -= s * gz;
  }
  dd[2] += g_ct;
}

// Solid-angle pdf of the sky/sun mixture (model.py::compute_pdfs + lerp).
// check_sun: count the cone pdf only inside the cone.
__device__ inline float mixture_pdf(const Tables& T, float dx, float dy,
                                   float dz, bool check_sun) {
  const float* __restrict__ misc = T.misc;
  const float* __restrict__ g = T.gauss;
  float sin_theta = safe_sqrt(dx * dx + dy * dy);
  bool active = (dz >= 0.0f) && (sin_theta != 0.0f);
  float sin_theta_c = fmaxf(sin_theta, SIN_OFFSET);

  float phi = atan2f(dy, dx);
  float az = fabsf(dz) - 1.0f;
  float tz = 2.0f * safe_asin(0.5f * sqrtf(dx * dx + dy * dy + az * az));
  float theta = dz >= 0.0f ? tz : PI_F - tz;
  float phi_rel = phi - (misc[M_SUN_PHI] - 0.5f * PI_F);
  if (phi_rel < 0.0f) phi_rel += 2.0f * PI_F;
  if (phi_rel > 2.0f * PI_F) phi_rel -= 2.0f * PI_F;
  bool in_range = theta >= 0.0f && theta <= 0.5f * PI_F;

  float sky_pdf = 0.0f;
  if (active && in_range) {
    float tg = 0.0f;
#pragma unroll 4
    for (int i = 0; i < N_GAUSS; ++i) {
      float z1 = (phi_rel - g[G_MU1 * N_GAUSS + i]) / g[G_S1 * N_GAUSS + i];
      float z2 = (theta - g[G_MU2 * N_GAUSS + i]) / g[G_S2 * N_GAUSS + i];
      tg += g[G_A * N_GAUSS + i] * expf(-0.5f * (z1 * z1 + z2 * z2));
    }
    sky_pdf = tg / sin_theta_c;
  }

  float cos_cut = misc[M_COS_CUT];
  bool in_cone = misc[M_SUNX] * dx + misc[M_SUNY] * dy + misc[M_SUNZ] * dz
                 >= cos_cut;
  float sun_pdf = (active && (in_cone || !check_sun))
                      ? INV_TWO_PI_F / (1.0f - cos_cut) : 0.0f;
  float w = misc[M_WMIX];
  return (1.0f - w) * sun_pdf + w * sky_pdf;
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

// NEE direction sample (model.py::sample_direction): strategy pick, TGMM
// inverse CDF for the sky, uniform cone for the sun. Returns pick_sky.
__device__ inline bool nee_sample(const Tables& T, float u0, float u1,
                                  float d[3]) {
  const float* __restrict__ misc = T.misc;
  const float* __restrict__ g = T.gauss;
  float w = misc[M_WMIX];
  bool pick_sky = u0 < w;
  if (pick_sky) {
    float su0 = clamp01(u0 / fmaxf(w, 1e-12f));
    // discrete pick over the normalised cdf (searchsorted, side=right)
    int idx = 0;
#pragma unroll 4
    for (int i = 0; i < N_GAUSS; ++i) idx += g[G_CDF * N_GAUSS + i] <= su0;
    idx = min(idx, N_GAUSS - 1);
    float pmf = fmaxf(g[G_PMF * N_GAUSS + idx], 1e-37f);
    float reused = clamp01((su0 - g[G_CDF_PREV * N_GAUSS + idx]) / pmf);
    float ca1 = g[G_CA1 * N_GAUSS + idx], cb1 = g[G_CB1 * N_GAUSS + idx];
    float ca2 = g[G_CA2 * N_GAUSS + idx], cb2 = g[G_CB2 * N_GAUSS + idx];
    float p1 = fminf(fmaxf((1.0f - reused) * ca1 + reused * cb1, EPS_F32),
                     1.0f - EPS_F32);
    float p2 = fminf(fmaxf((1.0f - u1) * ca2 + u1 * cb2, EPS_F32),
                     1.0f - EPS_F32);
    float ang1 = SQRT2_F * erfinv_polished(2.0f * p1 - 1.0f)
                     * g[G_S1 * N_GAUSS + idx] + g[G_MU1 * N_GAUSS + idx];
    float ang2 = SQRT2_F * erfinv_polished(2.0f * p2 - 1.0f)
                     * g[G_S2 * N_GAUSS + idx] + g[G_MU2 * N_GAUSS + idx];
    float phi = ang1 + misc[M_SUN_PHI] - 0.5f * PI_F;
    float theta = fminf(ang2, THETA_MAX);
    float st = sinf(theta);
    d[0] = cosf(phi) * st;
    d[1] = sinf(phi) * st;
    d[2] = cosf(theta);
  } else {
    float su0 = clamp01((u0 - w) / fmaxf(1.0f - w, 1e-12f));
    float px, py;
    disk_concentric(su0, u1, &px, &py);
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
    float sb = (b > 0.0f) ? 1.0f : ((b < 0.0f) ? -1.0f : 0.0f);
    float q = -0.5f * (b + sb * safe_sqrt(disc));
    float t0 = q / a;
    float t1 = c / (q == 0.0f ? 1.0f : q);
    float tn = fminf(t0, t1), tf = fmaxf(t0, t1);
    t = tn > RAY_EPS ? tn : (tf > RAY_EPS ? tf : INFINITY);
    if (!(disc >= 0.0f)) t = INFINITY;
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
