// K4: direct-illumination megakernel for sm_90a.
//
// Replaces tpusky/ops/pallas/megakernel.py:direct_rgb_megakernel
// (_mega_kernel). One thread runs one whole depth-2 RGB path, exactly the
// estimator of the plain wavefront path (render/integrator.py::_path_sample
// at max_depth 2, no Russian roulette): hash-RNG camera ray, closest hit
// over the analytic shapes, NEE toward the sunsky (K3's sample), a shadow
// ray, a cosine-sampled continuation ray and, where it escapes, the
// emitter-hit MIS lookup (K2's radiance and pdf). Camera rays that miss
// see the sky with MIS weight 1. On back-facing two-sided hits the
// continuation is built around the geometric normal, as the wavefront
// path does (the JAX megakernel flips it).
//
// What bounds it on an H100: arithmetic. A hit lane costs the NEE sample,
// two radiance and two pdf lookups (40 exps of the gaussian mixture),
// 3 x n_shapes intersections and some 25 IEEE divisions, against 12 bytes
// written per lane. Measured on the global-memory design (PERF.md): the
// lookups were ~70% of the time, occupancy did not bound it. The design:
// - the sunsky tables are staged once a block (sunsky_staged.cuh:
//   StagedRgb with the gaussians), and every lookup is the staged one:
//   rgb_radiance (radiance()'s value bitwise), nee_sample on the staged
//   view (K3's directions bitwise) and staged_pdf (the 1/sigma products,
//   within ~1e-6 of mixture_pdf);
// - the scene rows and the state's misc row and gaussian table are
//   computed in the staging from the raw tensors (camera to_world, field
//   of view and aspect; each shape's to_object, material index and kind;
//   the materials' albedo and two-sided flag; env_to_world; the RGB
//   state's fields), so the host builds no row and keeps none: a frame
//   is one launch. The shape rows are rotated into the environment's
//   local frame (world' = env_to_world^T world); under a rotated
//   environment the continuation's shading frame is built in world
//   coordinates, as the wavefront path builds it. A block keeps the rows
//   of the first 64 shapes; a larger scene's further shapes have their
//   rows built from to_object at each test;
// - a lane collects its sunsky lookups (the camera miss; the NEE
//   direction where it is lit and unshadowed; the escaped continuation)
//   and runs them through one call site, so that one copy of the lookup
//   code serves a warp's miss, NEE and continuation lookups together; a
//   shadowed NEE direction costs no lookup (compacting the lookups through
//   per-warp slots in shared memory was slower);
// - a divisor that repeats takes one IEEE reciprocal and tsk::div_by (the
//   quotient bitwise), the pixel's row and column a corrected float
//   quotient, and a ray that misses a sphere skips its divisions;
// - a grid of as many 256-thread blocks as the SMs hold at once (three an
//   SM at 79 registers, no spills) walks the lanes grid-stride
//   (tsk::staged_launch, the grid asked once a process).
// Lane order is pixel-major (lane = pixel * spp + sample), as the RNG is
// keyed. On an H100 (NVIDIA H100 80GB HBM3, 700 W) the headline 512x512x8
// frame takes ~0.24 ms and a frame whose every lane misses ~0.072, where
// the global-memory design took 0.286 and 0.090 (PERF.md).

#include "sunsky_staged.cuh"

namespace {

constexpr int kThreads = 256;
// the shapes whose rows a block keeps in shared memory; the rows of any
// further shapes are built from the raw tensors at each test
constexpr int kStaged = 64;

// camera row (16 floats): rotation (row-major, camera -> env-local),
// origin, tan(fov_x / 2), aspect
enum { C_R0 = 0, C_OX = 9, C_OY = 10, C_OZ = 11, C_TANH = 12, C_ASPECT = 13 };
constexpr int kCamW = 16;

// The scene as the host holds it (contiguous, one device).
struct SceneIn {
  const float* __restrict__ to_world;   // (4, 4) camera -> world
  const float* __restrict__ fov;        // () fov_x in degrees
  const float* __restrict__ aspect;     // ()
  const float* __restrict__ env;        // (3, 3) env local -> world
  const float* __restrict__ to_object;  // (n, 4, 4) world -> object
  const long long* __restrict__ bsdf_idx;  // (n,)
  const int* __restrict__ kind;         // (n,)
  const float* __restrict__ albedo;     // (m, 3)
  const unsigned char* __restrict__ twosided;  // (m,) bool
  int n, m;
};

// The RGB sunsky state as the host holds it (contiguous float32).
struct StateIn {
  const float* __restrict__ skyp;       // (3, 9) sky_params
  const float* __restrict__ skyr;       // (3,) sky_radiance
  const float* __restrict__ sun;        // (45, 72) sun_radiance
  const float* __restrict__ sun_n;      // (3,) sun_frame_n
  const float* __restrict__ sun_s;      // (3,) sun_frame_s
  const float* __restrict__ sun_t;      // (3,) sun_frame_t
  const float* __restrict__ angles;     // (2,) sun_angles (phi, theta)
  const float* __restrict__ sky_w;      // () sky_sampling_w
  const float* __restrict__ gaussians;  // (20, 5) mu1, mu2, s1, s2, w
  const float* __restrict__ half_ap;    // () params.sun_half_aperture
  const float* __restrict__ sky_scale;  // ()
  const float* __restrict__ sun_scale;  // ()
  const float* __restrict__ softness;   // () params.disc_softness
};

// The rows a block keeps in shared memory.
struct StagedScene {
  float4 shp[kStaged][3];      // world' -> object: A E (row-major) | b
  float4 mat[kStaged];         // albedo rgb, twosided
  int kind[kStaged];
  float cam[kCamW];
  float inv_aspect;            // 1 / aspect
  float env[9];                // env local -> world, row-major
  bool rotated;                // env is not the identity
  // the misc row and the gaussian table, as sunsky_kernel.py's _misc_row
  // and _gauss_rows pack them; stage_rgb copies them into StagedRgb
  float misc[16];
  float gauss[14 * tsk::N_GAUSS];
};

// shape s's row [A E (row-major), b] from its to_object and env e
__device__ __forceinline__ void shape_row_of(const SceneIn& in,
                                             const float* e, int s,
                                             float row[12]) {
  const float* __restrict__ t2o = in.to_object + 16 * s;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      row[3 * i + k] = t2o[4 * i] * e[k] + t2o[4 * i + 1] * e[3 + k]
                       + t2o[4 * i + 2] * e[6 + k];
    row[9 + i] = t2o[4 * i + 3];
  }
}

// shape s's material: albedo rgb, twosided
__device__ __forceinline__ float4 material_of(const SceneIn& in, int s) {
  long long b = in.bsdf_idx[s];
  b = b < 0 ? 0 : (b >= in.m ? in.m - 1 : b);
  return make_float4(in.albedo[3 * b], in.albedo[3 * b + 1],
                     in.albedo[3 * b + 2], in.twosided[b] ? 1.0f : 0.0f);
}

// The gaussian cdf as ops/math.py::gaussian_cdf rounds it
__device__ __forceinline__ float gauss_cdf(float mu, float sigma, float x) {
  return 0.5f * (1.0f + erff((0.70710677f * (x - mu)) / sigma));
}

// The misc row and the gaussian table from the raw state, operation for
// operation as sunsky_kernel.py's _misc_row (RGB) and _gauss_rows compute
// them, but for the order of the weights' sum and cumulative sum.
__device__ __forceinline__ void stage_state(StagedScene& S,
                                            const StateIn& st) {
  using namespace tsk;
  const int t = threadIdx.x;
  if (t < N_GAUSS) {
    const float* __restrict__ g = st.gaussians + 5 * t;
    float mu1 = g[0], mu2 = g[1], s1 = g[2], s2 = g[3], w = g[4];
    float ca1 = gauss_cdf(mu1, s1, 0.0f), ca2 = gauss_cdf(mu2, s2, 0.0f);
    float cb1 = gauss_cdf(mu1, s1, 6.2831855f);
    float cb2 = gauss_cdf(mu2, s2, 1.5707964f);
    float vol = (cb1 - ca1) * (cb2 - ca2) * s1 * s2;
    float* r = S.gauss;
    r[G_MU1 * N_GAUSS + t] = mu1;
    r[G_MU2 * N_GAUSS + t] = mu2;
    r[G_S1 * N_GAUSS + t] = s1;
    r[G_S2 * N_GAUSS + t] = s2;
    r[G_INV_S1 * N_GAUSS + t] = 1.0f / s1;
    r[G_INV_S2 * N_GAUSS + t] = 1.0f / s2;
    r[G_A * N_GAUSS + t] = w / (6.2831855f * fmaxf(vol, 1e-30f));
    r[G_CA1 * N_GAUSS + t] = ca1;
    r[G_CB1 * N_GAUSS + t] = cb1;
    r[G_CA2 * N_GAUSS + t] = ca2;
    r[G_CB2 * N_GAUSS + t] = cb2;
  } else if (t == 32) {
    const float* __restrict__ g = st.gaussians;
    float sum = 0.0f;
    for (int i = 0; i < N_GAUSS; ++i) sum += g[5 * i + 4];
    sum = fmaxf(sum, 1e-30f);
    float cdf = 0.0f;
    for (int i = 0; i < N_GAUSS; ++i) {
      float pmf = g[5 * i + 4] / sum;
      S.gauss[G_CDF_PREV * N_GAUSS + i] = cdf;
      cdf += pmf;
      S.gauss[G_PMF * N_GAUSS + i] = pmf;
      S.gauss[G_CDF * N_GAUSS + i] = cdf;
    }
  } else if (t == 64) {
    float* m = S.misc;
    float h = st.half_ap[0];
    // the physical disc's solid angle over the aperture's (area_ratio),
    // then the spectral-to-RGB sun constant
    float ratio = (1.0f - cosf(0.0046757371f)) / (1.0f - cosf(h));
    for (int i = 0; i < 3; ++i) {
      m[M_SUNX + i] = st.sun_n[i];
      m[M_SX + i] = st.sun_s[i];
      m[M_TX + i] = st.sun_t[i];
    }
    m[M_HALF_AP] = h;
    m[M_SKY_SCALE] = st.sky_scale[0];
    m[M_SUN_SCALE] = st.sun_scale[0] * ratio * 467.06927f;
    m[M_SUN_PHI] = st.angles[0];
    m[M_WMIX] = st.sky_w[0];
    m[M_COS_CUT] = cosf(h);
    m[M_SOFT] = st.softness[0];
  }
}

// The rows from the raw tensors (ops/cuda/megakernel.py::scene_rows is
// the plain version): camera R' = E^T R, o' = E^T o; shape A E.
__device__ __forceinline__ void stage_scene(StagedScene& S,
                                            const SceneIn& in) {
  const float* __restrict__ e = in.env;
  const int ns = min(in.n, kStaged);
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    shape_row_of(in, e, s, &S.shp[s][0].x);
    S.mat[s] = material_of(in, s);
    S.kind[s] = in.kind[s];
  }
  if (threadIdx.x == 0) {
    const float* __restrict__ r = in.to_world;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        S.cam[C_R0 + 3 * i + j] = r[j] * e[i] + r[4 + j] * e[3 + i]
                                  + r[8 + j] * e[6 + i];
      S.cam[C_OX + i] = r[3] * e[i] + r[7] * e[3 + i] + r[11] * e[6 + i];
    }
    S.cam[C_TANH] = tanf(0.5f * (in.fov[0] * 0.017453292519943295f));
    S.cam[C_ASPECT] = in.aspect[0];
    S.cam[14] = S.cam[15] = 0.0f;
    S.inv_aspect = 1.0f / in.aspect[0];
    bool rotated = false;
    for (int k = 0; k < 9; ++k) {
      S.env[k] = e[k];
      rotated |= e[k] != (k % 4 == 0 ? 1.0f : 0.0f);
    }
    S.rotated = rotated;
  }
}

// The shading frame's tangents around unit normal n (ops/math.py::Frame).
__device__ __forceinline__ void frame(const float n[3], float sv[3],
                                      float tv[3]) {
  float fs = n[2] >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (fs + n[2]);
  float b = n[0] * n[1] * a;
  sv[0] = n[0] * n[0] * a * fs + 1.0f; sv[1] = b * fs; sv[2] = -n[0] * fs;
  tv[0] = b; tv[1] = n[1] * n[1] * a + fs; tv[2] = -n[1];
}

// e v and e^T v for row-major (3, 3) e
__device__ __forceinline__ void rot(const float* e, const float v[3],
                                    float out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = e[3 * i] * v[0] + e[3 * i + 1] * v[1] + e[3 * i + 2] * v[2];
}

__device__ __forceinline__ void rot_t(const float* e, const float v[3],
                                      float out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = e[i] * v[0] + e[3 + i] * v[1] + e[6 + i] * v[2];
}

__device__ __forceinline__ const float* shape_row(const StagedScene& S,
                                                  int s) {
  return &S.shp[s][0].x;
}

// v / |v|, each component's quotient the IEEE division's (tsk::div_by)
__device__ __forceinline__ void normalize(float v[3]) {
  float len = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  float inv = 1.0f / len;
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = tsk::div_by(v[i], len, inv);
}

// a / b (a >= 0, b > 0, a < 2^24) and its remainder, from y = 1 / b: the
// float quotient corrected to the integer one
__device__ __forceinline__ int div_exact(int a, int b, float y, int* rem) {
  int q = (int)((float)a * y);
  int r = a - q * b;
  while (r < 0) {
    --q;
    r += b;
  }
  while (r >= b) {
    ++q;
    r -= b;
  }
  *rem = r;
  return q;
}

// closest hit: returns the shape index or -1; t, unit normal
__device__ __forceinline__ int intersect(const StagedScene& S, const SceneIn& in,
                         const float o[3], const float d[3], float* t_best,
                         float n_best[3]) {
  int best = -1;
  *t_best = INFINITY;
  float nb[3] = {0.0f, 0.0f, 0.0f};
  const int ns = min(in.n, kStaged);
  for (int s = 0; s < ns; ++s) {
    float nv[3];
    float t = tsk::isect_shape(S.kind[s], shape_row(S, s), o, d, nv);
    if (t < *t_best) {
      *t_best = t;
      best = s;
      nb[0] = nv[0]; nb[1] = nv[1]; nb[2] = nv[2];
    }
  }
  for (int s = kStaged; s < in.n; ++s) {
    float row[12], nv[3];
    shape_row_of(in, S.env, s, row);
    float t = tsk::isect_shape(in.kind[s], row, o, d, nv);
    if (t < *t_best) {
      *t_best = t;
      best = s;
      nb[0] = nv[0]; nb[1] = nv[1]; nb[2] = nv[2];
    }
  }
  if (best < 0) {
    nb[0] = 0.0f; nb[1] = 0.0f; nb[2] = 1.0f;
  }
  normalize(nb);
  n_best[0] = nb[0];
  n_best[1] = nb[1];
  n_best[2] = nb[2];
  return best;
}

__device__ __forceinline__ bool occluded(const StagedScene& S, const SceneIn& in,
                         const float o[3], const float d[3]) {
  const int ns = min(in.n, kStaged);
  for (int s = 0; s < ns; ++s) {
    float nv[3];
    if (isfinite(tsk::isect_shape(S.kind[s], shape_row(S, s), o, d, nv)))
      return true;
  }
  for (int s = kStaged; s < in.n; ++s) {
    float row[12], nv[3];
    shape_row_of(in, S.env, s, row);
    if (isfinite(tsk::isect_shape(in.kind[s], row, o, d, nv))) return true;
  }
  return false;
}

__device__ __forceinline__ float mis(float a, float b) {
  float a2 = a * a, b2 = b * b;
  float w = a2 / (a2 + b2);
  return isfinite(w) ? w : 0.0f;
}

__device__ __forceinline__ float sgn(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// ray origin pushed off the surface along +-n, toward d
__device__ __forceinline__ void offset(const float p[3], const float n[3],
                                       const float d[3], float out[3]) {
  float plen = sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2]);
  float eps = tsk::SHADOW_EPS * fmaxf(1.0f, plen);
  float s = sgn(n[0] * d[0] + n[1] * d[1] + n[2] * d[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = p[i] + s * n[i] * eps;
}

// a lane's sunsky lookups: the camera ray's miss (weight 1), an NEE
// direction (weighed by its pdf against the BSDF's, a), an escaped
// continuation (its BSDF pdf a against the emitter's)
enum { Q_MISS, Q_NEE, Q_CONT };

struct Query {
  float d[3];
  float a;
  int kind;
  bool check_sun;
};

struct Params {
  SceneIn in;
  StateIn st;
  uint32_t seed;
  int spp_shift, width, height, n_lanes;   // spp = 2^spp_shift
  float inv_w, inv_h;                      // 1 / width, 1 / height
  float* __restrict__ out;
  float* __restrict__ rows;     // staged rows (debug), or null
};

// The lane's path up to its lookups q0, q1: m is the albedo they are
// weighed by. Returns the number of lookups (0-2).
__device__ __forceinline__ int trace(const StagedScene& S,
                                     const tsk::Tables& V, const Params& P,
                                     uint32_t lane, float m[3], Query& q0,
                                     Query& q1) {
  const uint32_t seed = P.seed;
  int px_i;
  int py_i = div_exact((int)(lane >> P.spp_shift), P.width, P.inv_w, &px_i);
  float px = (float)px_i, py = (float)py_i;

  // ---- camera ray (sensors.py::perspective_ray) ----
  const float* cam = S.cam;
  float u0 = tsk::rand_unit(lane, 10000u, 0u, seed);
  float u1 = tsk::rand_unit(lane, 10000u, 1u, seed);
  float uvx = tsk::div_by(px + u0, (float)P.width, P.inv_w);
  float uvy = tsk::div_by(py + u1, (float)P.height, P.inv_h);
  float xc = (2.0f * uvx - 1.0f) * cam[C_TANH];
  float yc = tsk::div_by((1.0f - 2.0f * uvy) * cam[C_TANH], cam[C_ASPECT],
                         S.inv_aspect);
  float d[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    d[i] = xc * cam[C_R0 + 3 * i] + yc * cam[C_R0 + 3 * i + 1]
           + cam[C_R0 + 3 * i + 2];
  normalize(d);
  float o[3] = {cam[C_OX], cam[C_OY], cam[C_OZ]};

  float t, nrm[3];
  int s = intersect(S, P.in, o, d, &t, nrm);
  if (s < 0) {
    // camera ray escapes: previous "sample" is a delta, MIS weight 1
    m[0] = m[1] = m[2] = 1.0f;
    q0 = Query{{d[0], d[1], d[2]}, 1.0f, Q_MISS, true};
    return 1;
  }
  int nq = 0;
  float p[3] = {o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]};
  float4 mat = s < kStaged ? S.mat[s] : material_of(P.in, s);
  m[0] = mat.x; m[1] = mat.y; m[2] = mat.z;
  // shading frame around the geometric normal (ops/math.py::Frame),
  // built in world coordinates as the wavefront path builds it: the frame
  // is not rotation-equivariant, so under a rotated environment it is
  // built around E n and its tangents are rotated back
  float sv[3], tv[3];
  if (S.rotated) {
    float nw[3], sw[3], tw[3];
    rot(S.env, nrm, nw);
    frame(nw, sw, tw);
    rot_t(S.env, sw, sv);
    rot_t(S.env, tw, tv);
  } else {
    frame(nrm, sv, tv);
  }
  float wi_z = -d[0] * nrm[0] + -d[1] * nrm[1] + -d[2] * nrm[2];
  // two-sided adapter: mirror the frame when arriving from below
  float flip = (mat.w > 0.5f && wi_z < 0.0f) ? -1.0f : 1.0f;
  float cos_i = wi_z * flip;

  // ---- NEE toward the sky (K3's sample); its radiance and pdf are
  // looked up only where they can count: above the horizon, on the lit
  // side, unshadowed ----
  float de[3];
  bool pick_sky = tsk::nee_sample(V, tsk::rand_unit(lane, 0u, 0u, seed),
                                  tsk::rand_unit(lane, 0u, 1u, seed), de);
  float cos_o = (de[0] * nrm[0] + de[1] * nrm[1] + de[2] * nrm[2]) * flip;
  if (cos_i > 0.0f && cos_o > 0.0f && de[2] >= 0.0f) {
    float os[3];
    offset(p, nrm, de, os);
    if (!occluded(S, P.in, os, de)) {
      q0 = Query{{de[0], de[1], de[2]}, tsk::INV_PI_F * fmaxf(cos_o, 0.0f),
                 Q_NEE, pick_sky};
      nq = 1;
    }
  }

  // ---- cosine-sampled continuation (bsdf.py::diffuse_sample) ----
  if (cos_i > 0.0f) {
    float lx, ly;
    tsk::disk_concentric(tsk::rand_unit(lane, 1u, 0u, seed),
                         tsk::rand_unit(lane, 1u, 1u, seed), &lx, &ly);
    float lz = tsk::safe_sqrt(1.0f - (lx * lx + ly * ly));
    float pdf_next = tsk::INV_PI_F * fmaxf(lz, 0.0f);
    float wz = lz * flip;
    float dn[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) dn[i] = lx * sv[i] + ly * tv[i] + wz * nrm[i];
    if (pdf_next > 0.0f) {
      float o2[3];
      offset(p, nrm, dn, o2);
      if (!occluded(S, P.in, o2, dn)) {
        Query qc{{dn[0], dn[1], dn[2]}, pdf_next, Q_CONT, true};
        if (nq == 0)
          q0 = qc;
        else
          q1 = qc;
        ++nq;
      }
    }
  }
  return nq;
}

__global__ void __launch_bounds__(kThreads, 3) mega_kernel(Params P) {
  __shared__ tsk::StagedRgb ST;
  __shared__ StagedScene SS;
  stage_scene(SS, P.in);
  stage_state(SS, P.st);
  __syncthreads();
  const tsk::Tables T{P.st.skyp, P.st.skyr, P.st.sun, SS.misc, SS.gauss,
                      nullptr};
  tsk::stage_rgb<true>(ST, T);   // syncs the block
  if (P.rows != nullptr && blockIdx.x == 0) {
    // camera (16), misc (16), gaussians (280), then each shape's row (12)
    // and material (4) as the lanes read them
    const int g0 = 2 * kCamW, s0 = g0 + 14 * tsk::N_GAUSS;
    for (int k = threadIdx.x; k < s0; k += blockDim.x)
      P.rows[k] = k < kCamW ? SS.cam[k]
                  : k < g0 ? ST.misc[k - kCamW] : ST.gauss[k - g0];
    for (int s = threadIdx.x; s < P.in.n; s += blockDim.x) {
      float row[12];
      if (s < kStaged) {
        for (int k = 0; k < 12; ++k) row[k] = shape_row(SS, s)[k];
      } else {
        shape_row_of(P.in, SS.env, s, row);
      }
      for (int k = 0; k < 12; ++k) P.rows[s0 + 12 * s + k] = row[k];
      float4 mat = s < kStaged ? SS.mat[s] : material_of(P.in, s);
      float* mr = P.rows + s0 + 12 * P.in.n + 4 * s;
      mr[0] = mat.x; mr[1] = mat.y; mr[2] = mat.z; mr[3] = mat.w;
    }
  }
  const tsk::Tables V = tsk::staged_view(T, ST);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < P.n_lanes;
       i += gridDim.x * kThreads) {
    float m[3];
    Query q0, q1;
    int nq = trace(SS, V, P, (uint32_t)i, m, q0, q1);
    float res[3] = {0.0f, 0.0f, 0.0f};
    // the lane's lookups through one call site
    for (int k = 0; k < nq; ++k) {
      const Query qk = k == 0 ? q0 : q1;
      float rad[3];
      tsk::rgb_radiance(ST, P.st.sun, qk.d[0], qk.d[1], qk.d[2], rad);
      float w = 1.0f;
      if (qk.kind != Q_MISS) {
        float pdf = tsk::staged_pdf<false>(ST, qk.d[0], qk.d[1], qk.d[2],
                                          qk.check_sun);
        if (qk.kind == Q_NEE)
          w = pdf > 0.0f ? qk.a * (mis(pdf, qk.a) / fmaxf(pdf, 1e-20f))
                         : 0.0f;
        else
          w = mis(qk.a, pdf);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) res[c] += m[c] * rad[c] * w;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      P.out[3 * i + c] = isfinite(res[c]) ? res[c] : 0.0f;
  }
}

}  // namespace

extern "C" {

// One depth-2 RGB frame -> out (width * height * spp, 3), from the
// scene's and the RGB sunsky state's raw tensors. rows (or null): the
// staged camera row (16,), misc row (16,) and gaussian table (14, 20),
// then the shape rows (n_shapes, 12) and material rows (n_shapes, 4) as
// the lanes read them, one after another.
int tsk_direct_rgb_megakernel(
    const float* to_world, const float* fov, const float* aspect,
    const float* env, const float* to_object, const long long* bsdf_idx,
    const int* kind, int n_shapes, const float* albedo,
    const unsigned char* twosided, int n_mats, const float* skyp,
    const float* skyr, const float* sun, const float* sun_n,
    const float* sun_s, const float* sun_t, const float* sun_angles,
    const float* sky_w, const float* gaussians, const float* half_ap,
    const float* sky_scale, const float* sun_scale, const float* softness,
    unsigned int seed, int spp, int width, int height, float* out,
    float* rows, void* stream) {
  int n_lanes = width * height * spp, spp_shift = 0;
  while ((1 << spp_shift) < spp) ++spp_shift;
  if (n_shapes < 0 || n_mats < 1 || (1 << spp_shift) != spp
      || width * height >= (1 << 24))
    return (int)cudaErrorInvalidValue;
  if (n_lanes > 0) {
    Params P{SceneIn{to_world, fov, aspect, env, to_object, bsdf_idx, kind,
                     albedo, twosided, n_shapes, n_mats},
             StateIn{skyp, skyr, sun, sun_n, sun_s, sun_t, sun_angles, sky_w,
                     gaussians, half_ap, sky_scale, sun_scale, softness},
             (uint32_t)seed, spp_shift, width, height, n_lanes,
             1.0f / (float)width, 1.0f / (float)height, out, rows};
    tsk::staged_launch<kThreads>(mega_kernel, n_lanes, stream, P);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
