// K4: direct-illumination megakernel for sm_90a.
//
// Replaces tpusky/ops/pallas/megakernel.py:direct_rgb_megakernel
// (_mega_kernel). One thread runs one whole depth-2 RGB path, exactly the
// estimator of the plain wavefront path (render/integrator.py::_path_sample
// at max_depth 2, no Russian roulette): hash-RNG camera ray, closest hit
// over the analytic shapes, NEE toward the sunsky (the K3 core), a shadow
// ray, a cosine-sampled continuation ray and, where it escapes, the
// emitter-hit MIS lookup (the K2 core). Camera rays that miss see the sky
// with MIS weight 1.
//
// What bounds it on an H100: arithmetic. A path costs two radiance cores,
// two pdf cores (40 exps of the gaussian mixture), the NEE sample and
// 3 x n_shapes intersections, all in registers, against 12 bytes written
// per lane. The simple design: one thread per lane (pixel-major lane
// order, lane = pixel * spp + sample, as the RNG is keyed), 256 threads a
// block, no shared memory; scene rows and sunsky tables (under 15 KB) are
// read through const __restrict__ pointers. Lanes whose camera ray misses
// or whose continuation is occluded exit early, so warps diverge at the
// object silhouettes; sorting lanes or persistent blocks is later work.
//
// The whole frame runs in the environment's local frame: the wrapper
// rotates the camera and the shape transforms by env_to_world^T once.

#include "sunsky_core.cuh"

namespace {

constexpr int kThreads = 256;

// camera row (16 floats): rotation (row-major, camera -> env-local),
// origin, tan(fov_x / 2), aspect
enum { C_R0 = 0, C_OX = 9, C_OY = 10, C_OZ = 11, C_TANH = 12, C_ASPECT = 13 };

struct Scene {
  const float* __restrict__ shp;   // (n, 12) world->object rows
  const float* __restrict__ mat;   // (n, 4) albedo rgb, twosided
  const int* __restrict__ kind;    // (n,)
  int n;
};

// closest hit: returns the shape index or -1; t, unit normal
__device__ int intersect(const Scene& S, const float o[3], const float d[3],
                         float* t_best, float n_best[3]) {
  int best = -1;
  *t_best = INFINITY;
  float nb[3] = {0.0f, 0.0f, 0.0f};
  for (int s = 0; s < S.n; ++s) {
    float n[3];
    float t = tsk::isect_shape(S.kind[s], S.shp + 12 * s, o, d, n);
    if (t < *t_best) {
      *t_best = t;
      best = s;
      nb[0] = n[0]; nb[1] = n[1]; nb[2] = n[2];
    }
  }
  if (best < 0) {
    nb[0] = 0.0f; nb[1] = 0.0f; nb[2] = 1.0f;
  }
  float len = sqrtf(nb[0] * nb[0] + nb[1] * nb[1] + nb[2] * nb[2]);
  n_best[0] = nb[0] / len;
  n_best[1] = nb[1] / len;
  n_best[2] = nb[2] / len;
  return best;
}

__device__ bool occluded(const Scene& S, const float o[3], const float d[3]) {
  for (int s = 0; s < S.n; ++s) {
    float n[3];
    if (isfinite(tsk::isect_shape(S.kind[s], S.shp + 12 * s, o, d, n)))
      return true;
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

__global__ void __launch_bounds__(kThreads)
mega_kernel(const float* __restrict__ cam, Scene S, tsk::Tables T,
            uint32_t seed, int spp, int width, int height, int n_lanes,
            float* __restrict__ out) {
  int lane_i = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane_i >= n_lanes) return;
  uint32_t lane = (uint32_t)lane_i;
  int pixel = lane_i / spp;
  float px = (float)(pixel % width);
  float py = (float)(pixel / width);

  // ---- camera ray (sensors.py::perspective_ray) ----
  float u0 = tsk::rand_unit(lane, 10000u, 0u, seed);
  float u1 = tsk::rand_unit(lane, 10000u, 1u, seed);
  float uvx = (px + u0) / (float)width;
  float uvy = (py + u1) / (float)height;
  float xc = (2.0f * uvx - 1.0f) * cam[C_TANH];
  float yc = (1.0f - 2.0f * uvy) * cam[C_TANH] / cam[C_ASPECT];
  float d[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    d[i] = xc * cam[C_R0 + 3 * i] + yc * cam[C_R0 + 3 * i + 1]
           + cam[C_R0 + 3 * i + 2];
  float dlen = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  d[0] /= dlen; d[1] /= dlen; d[2] /= dlen;
  float o[3] = {cam[C_OX], cam[C_OY], cam[C_OZ]};

  float res[3] = {0.0f, 0.0f, 0.0f};
  float t, n[3];
  int s = intersect(S, o, d, &t, n);
  if (s < 0) {
    // camera ray escapes: previous "sample" is a delta, MIS weight 1
    tsk::radiance(T, d[0], d[1], d[2], res);
  } else {
    float p[3] = {o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]};
    const float* m = S.mat + 4 * s;
    // shading frame around the geometric normal (ops/math.py::Frame)
    float fs = n[2] >= 0.0f ? 1.0f : -1.0f;
    float a = -1.0f / (fs + n[2]);
    float b = n[0] * n[1] * a;
    float sv[3] = {n[0] * n[0] * a * fs + 1.0f, b * fs, -n[0] * fs};
    float tv[3] = {b, n[1] * n[1] * a + fs, -n[1]};
    float wi_z = -d[0] * n[0] + -d[1] * n[1] + -d[2] * n[2];
    // two-sided adapter: mirror the frame when arriving from below
    float flip = (m[3] > 0.5f && wi_z < 0.0f) ? -1.0f : 1.0f;
    float cos_i = wi_z * flip;

    // ---- NEE toward the sky (the K3 core) ----
    float de[3], le[3];
    float pdf_e = tsk::nee(T, tsk::rand_unit(lane, 0u, 0u, seed),
                           tsk::rand_unit(lane, 0u, 1u, seed), de, le);
    float cos_o = (de[0] * n[0] + de[1] * n[1] + de[2] * n[2]) * flip;
    bool refl = cos_i > 0.0f && cos_o > 0.0f;
    float pdf_b = refl ? tsk::INV_PI_F * fmaxf(cos_o, 0.0f) : 0.0f;
    float os[3];
    offset(p, n, de, os);
    if (pdf_e > 0.0f && !occluded(S, os, de)) {
      float w = mis(pdf_e, pdf_b) / fmaxf(pdf_e, 1e-20f);
#pragma unroll
      for (int c = 0; c < 3; ++c) res[c] += m[c] * pdf_b * le[c] * w;
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
      for (int i = 0; i < 3; ++i) dn[i] = lx * sv[i] + ly * tv[i] + wz * n[i];
      if (pdf_next > 0.0f) {
        float o2[3];
        offset(p, n, dn, o2);
        if (!occluded(S, o2, dn)) {
          // ---- emitter hit with MIS (the K2 core) ----
          float le2[3];
          tsk::radiance(T, dn[0], dn[1], dn[2], le2);
          float w = mis(pdf_next, tsk::mixture_pdf(T, dn[0], dn[1], dn[2],
                                                   true));
#pragma unroll
          for (int c = 0; c < 3; ++c) res[c] += m[c] * le2[c] * w;
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[3 * lane_i + c] = isfinite(res[c]) ? res[c] : 0.0f;
}

}  // namespace

extern "C" int tsk_direct_rgb_megakernel(
    const float* cam, const float* shp, const float* mat, const int* kind,
    int n_shapes, unsigned int seed, int spp, int width, int height,
    const float* skyp, const float* skyr, const float* sun, const float* misc,
    const float* gauss, float* out, void* stream) {
  int n_lanes = width * height * spp;
  if (n_lanes > 0) {
    Scene S{shp, mat, kind, n_shapes};
    tsk::Tables T{skyp, skyr, sun, misc, gauss};
    mega_kernel<<<(n_lanes + kThreads - 1) / kThreads, kThreads, 0,
                  (cudaStream_t)stream>>>(cam, S, T, (uint32_t)seed, spp,
                                          width, height, n_lanes, out);
  }
  return (int)cudaGetLastError();
}
