// Triangle-mesh closest hit, kernel K14, for sm_90a.
//
// K14 mesh_intersect  replaces tpusky/ops/pallas/mesh_kernel.py:
//                     mesh_intersect_pallas -> _mesh_isect_pallas: the
//                     closest ray-triangle hit by Moller-Trumbore over
//                     Morton-ordered 128-triangle tiles, with supertile
//                     (16 tiles) and tile bounding-box culling.
//
// The TPU kernel keeps the whole mesh in VMEM and tests one triangle at a
// time, as scalars broadcast against a 2,048-ray block. On an H100 the
// mesh does not fit in a block's shared memory (36 B a triangle: 2.9 MB
// at 81,920 triangles against 227 KB), but it fits in the 50 MB L2. So:
//
//  * one thread per ray, 128 consecutive rays a block (after the
//    wavefront sort they are coherent);
//  * every thread slab-tests a supertile's box against its own closest
//    hit so far; the block descends if any thread's test passes
//    (__syncthreads_or), and decides each of the 16 tiles the same way;
//  * a tile the block enters is staged in shared memory with coalesced
//    float4 loads (9 planes x 128 floats, 4.6 KB), and every thread whose
//    own slab test passed runs Moller-Trumbore over its 128 triangles in
//    index order with a strict `<`, so the lowest index wins a tie, as in
//    the plain version's argmin.
//
// Culling skips only tiles a ray cannot hit closer than its best, so the
// kernel returns the dense plain version's hits. The determinant, the
// barycentrics and t are written with __fmul_rn / __fadd_rn / __fsub_rn
// and __frcp_rn: nvcc does not contract them into FMAs, so they round as
// the plain version's separate PyTorch ops do (render/mesh.py::_tile_mt),
// and the edge tests u >= 0, v >= 0, u + v <= 1 and t > 1e-4 fall the same
// way on edge and grazing rays.
//
// What bounds it on this card: operations on the tiles the block enters.
// A ray reads and writes 40 bytes and the tables are read once from L2
// per entered tile; a coherent block enters a few tiles of hundreds, an
// incoherent one many, and its warps run the 128-triangle loop wherever
// any of their threads entered. The design answers with coherence (the
// wavefront sort) and block-level culling; binned ray lists, a BVH,
// cp.async double-buffering of tiles and warp-level culling are later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;    // rays a block
constexpr int kTile = 128;       // triangles a tile
constexpr int kSuper = 16;       // tiles a supertile
constexpr int kTileFloats = 9 * kTile;
constexpr float kRayEps = 1e-4f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Does the ray enter the box [lo, hi] within (0, best)? The reference's
// branch-free slab test (mesh_kernel.py:81-100).
__device__ __forceinline__ bool enters(const float4* box, int i,
                                       const Ray& r, float best) {
  float4 lo = box[2 * i], hi = box[2 * i + 1];
  float t0x = (lo.x - r.ox) * r.ix, t1x = (hi.x - r.ox) * r.ix;
  float t0y = (lo.y - r.oy) * r.iy, t1y = (hi.y - r.oy) * r.iy;
  float t0z = (lo.z - r.oz) * r.iz, t1z = (hi.z - r.oz) * r.iz;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                   fminf(t0z, t1z));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                   fmaxf(t0z, t1z));
  return tf >= fmaxf(tn, 0.0f) && tn < best;
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
// a.x * b.x + a.y * b.y + a.z * b.z, left to right, each step rounded
__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

// Moller-Trumbore of one ray against triangle k of the staged tile s
// (planes v0, e1, e2 by component); on a hit closer than best, update
// the closest hit.
__device__ __forceinline__ void mt_hit(const float* s, int k, const Ray& r,
                                       int tri, float& bt, float& bb1,
                                       float& bb2, int& btri) {
  float v0x = s[0 * kTile + k], v0y = s[1 * kTile + k],
        v0z = s[2 * kTile + k];
  float e1x = s[3 * kTile + k], e1y = s[4 * kTile + k],
        e1z = s[5 * kTile + k];
  float e2x = s[6 * kTile + k], e2y = s[7 * kTile + k],
        e2z = s[8 * kTile + k];
  float px = sub(mul(r.dy, e2z), mul(r.dz, e2y));
  float py = sub(mul(r.dz, e2x), mul(r.dx, e2z));
  float pz = sub(mul(r.dx, e2y), mul(r.dy, e2x));
  float det = dot3(e1x, e1y, e1z, px, py, pz);
  if (!(fabsf(det) > 1e-12f)) return;   // parallel, degenerate or padding
  float inv = __frcp_rn(det);
  float tx = sub(r.ox, v0x), ty = sub(r.oy, v0y), tz = sub(r.oz, v0z);
  float u = mul(dot3(tx, ty, tz, px, py, pz), inv);
  float qx = sub(mul(ty, e1z), mul(tz, e1y));
  float qy = sub(mul(tz, e1x), mul(tx, e1z));
  float qz = sub(mul(tx, e1y), mul(ty, e1x));
  float v = mul(dot3(r.dx, r.dy, r.dz, qx, qy, qz), inv);
  float t = mul(dot3(e2x, e2y, e2z, qx, qy, qz), inv);
  if (u >= 0.0f && v >= 0.0f && add(u, v) <= 1.0f && t > kRayEps &&
      t < bt) {
    bt = t;
    bb1 = u;
    bb2 = v;
    btri = tri;
  }
}

__global__ void __launch_bounds__(kThreads)
mesh_isect_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  int n, const float4* __restrict__ tv,
                  const float4* __restrict__ boxes,
                  const float4* __restrict__ super_boxes, int n_super,
                  float* __restrict__ t_out, float* __restrict__ b1_out,
                  float* __restrict__ b2_out, int* __restrict__ tri_out) {
  __shared__ float4 staged4[kTileFloats / 4];
  const float* staged = reinterpret_cast<const float*>(staged4);
  int i = blockIdx.x * kThreads + threadIdx.x;
  bool live = i < n;
  Ray r{0.f, 0.f, 0.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
  if (live) {
    r.ox = o[3 * i];
    r.oy = o[3 * i + 1];
    r.oz = o[3 * i + 2];
    r.dx = d[3 * i];
    r.dy = d[3 * i + 1];
    r.dz = d[3 * i + 2];
    r.ix = 1.0f / (r.dx == 0.0f ? 1e-20f : r.dx);
    r.iy = 1.0f / (r.dy == 0.0f ? 1e-20f : r.dy);
    r.iz = 1.0f / (r.dz == 0.0f ? 1e-20f : r.dz);
  }
  float bt = __int_as_float(0x7f800000);   // +inf
  float bb1 = 0.0f, bb2 = 0.0f;
  int btri = -1;

  for (int sp = 0; sp < n_super; ++sp) {
    // every branch below is block-uniform: it follows a block vote
    if (!__syncthreads_or(live && enters(super_boxes, sp, r, bt))) continue;
    for (int tile = sp * kSuper; tile < (sp + 1) * kSuper; ++tile) {
      bool mine = live && enters(boxes, tile, r, bt);
      // this vote is also the barrier that keeps the previous tile's
      // readers ahead of the next staging
      if (!__syncthreads_or(mine)) continue;
      const float4* src = tv + (size_t)tile * (kTileFloats / 4);
      for (int k = threadIdx.x; k < kTileFloats / 4; k += kThreads)
        staged4[k] = src[k];
      __syncthreads();
      if (mine) {
        int base = tile * kTile;
        for (int k = 0; k < kTile; ++k)
          mt_hit(staged, k, r, base + k, bt, bb1, bb2, btri);
      }
    }
  }
  if (live) {
    t_out[i] = bt;
    b1_out[i] = bb1;
    b2_out[i] = bb2;
    tri_out[i] = btri;
  }
}

}  // namespace

extern "C" {

// o, d: (n, 3) rays; tv: (n_super * 16, 9, 128) triangle planes;
// boxes: (n_super * 16, 8) and super_boxes: (n_super, 8) bounds as
// [lo.xyz, 0, hi.xyz, 0]; out: t, b1, b2 (n,) and tri (n,) int32.
int tsk_mesh_intersect(const float* o, const float* d, int n,
                       const float* tv, const float* boxes,
                       const float* super_boxes, int n_super, float* t_out,
                       float* b1_out, float* b2_out, int* tri_out,
                       cudaStream_t stream) {
  if (n <= 0) return 0;
  int blocks = (n + kThreads - 1) / kThreads;
  mesh_isect_kernel<<<blocks, kThreads, 0, stream>>>(
      o, d, n, reinterpret_cast<const float4*>(tv),
      reinterpret_cast<const float4*>(boxes),
      reinterpret_cast<const float4*>(super_boxes), n_super, t_out, b1_out,
      b2_out, tri_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
