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
// mesh (48 B a triangle: 3.9 MB at 81,920 triangles) stays in the 50 MB
// L2, and what bounds the kernel is the work of the tiles each ray tests.
// So every ray culls for itself:
//
//  * one thread per ray, no block votes, barriers or shared staging: each
//    lane walks its own boxes and tests its own tiles. The loop over a
//    tile is uniform, only the tile differs between lanes, so a warp
//    costs the largest of its lanes' tile counts, not the union of its
//    lanes' tiles;
//  * nearest first: the lane visits the supertiles it enters in order of
//    entry distance (then index), and the tiles it enters inside each the
//    same way, by repeated selection over a bitmask held in registers
//    (4 x 64 supertiles a group, 16 tiles a supertile), recomputing each
//    remaining box's entry against its running best and dropping the
//    boxes it no longer enters. The first hit culls what lies beyond it;
//  * inside a tile, each quarter (a leaf of 32 triangles) has its own box,
//    so a ray tests ~1 leaf of a tile's 4; a triangle whose b1 falls
//    outside [0, 1] stops there, before v and t;
//  * a triangle is one 48-byte record, three read-only float4 loads:
//    (v0.xyz, e1.x), (e1.yz, e2.xy), (e2.z, 0, 0, 0).
//
// Exact under any visiting order: the kernel returns the dense plain
// version's hit. The determinant, barycentrics and t are written with
// __fmul_rn / __fadd_rn / __fsub_rn and __frcp_rn: nvcc does not contract
// them into FMAs, so they round as the plain version's separate PyTorch
// ops do (render/mesh.py::_tile_mt), and the edge tests u >= 0, v >= 0,
// u + v <= 1 and t > 1e-4 fall the same way on edge and grazing rays. A
// hit wins when (t, triangle index) is lexicographically smaller, the
// plain version's argmin order, and a box is culled only when its entry
// lies strictly beyond the best t, so a lower-index triangle at exactly
// the best t in a tile visited later still wins.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // rays a block
constexpr int kTile = 128;       // triangles a tile
constexpr int kLeaf = 32;        // triangles a leaf box
constexpr int kLeaves = kTile / kLeaf;
constexpr int kSuper = 16;       // tiles a supertile
constexpr int kWords = 4;        // 64-bit mask words of supertiles a group
constexpr int kGroup = 64 * kWords;
constexpr float kRayEps = 1e-4f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Does the ray enter box i within [0, best]? The reference's slab test
// (mesh_kernel.py:81-100) with the cull at tn > best; *key is the entry
// distance clamped at 0, the visiting order.
__device__ __forceinline__ bool enters(const float4* __restrict__ box, int i,
                                       const Ray& r, float best, float* key) {
  float4 lo = __ldg(box + 2 * i), hi = __ldg(box + 2 * i + 1);
  float t0x = (lo.x - r.ox) * r.ix, t1x = (hi.x - r.ox) * r.ix;
  float t0y = (lo.y - r.oy) * r.iy, t1y = (hi.y - r.oy) * r.iy;
  float t0z = (lo.z - r.oz) * r.iz, t1z = (hi.z - r.oz) * r.iz;
  float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                   fminf(t0z, t1z));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                   fmaxf(t0z, t1z));
  *key = fmaxf(tn, 0.0f);
  return tf >= *key && tn <= best;
}

// Over the boxes base + b of the set bits b of *mask: clear those the ray
// no longer enters, and keep in (*key, *sel) the nearest of the rest,
// the lowest index on a tie (bits are visited in ascending order).
__device__ __forceinline__ void nearest(const float4* __restrict__ box,
                                        int base, uint64_t* mask,
                                        const Ray& r, float best, float* key,
                                        int* sel) {
  for (uint64_t b = *mask; b; b &= b - 1) {
    int j = __ffsll((long long)b) - 1;
    float k;
    if (!enters(box, base + j, r, best, &k))
      *mask &= ~(1ull << j);
    else if (k < *key) {
      *key = k;
      *sel = base + j;
    }
  }
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

// Moller-Trumbore of the ray against the triangle whose record starts at
// rec; on a hit that precedes (bt, btri) in (t, index) order, take it.
__device__ __forceinline__ void mt_hit(const float4* __restrict__ rec,
                                       const Ray& r, int tri, float& bt,
                                       float& bb1, float& bb2, int& btri) {
  float4 a = __ldg(rec), b = __ldg(rec + 1), c = __ldg(rec + 2);
  float v0x = a.x, v0y = a.y, v0z = a.z;
  float e1x = a.w, e1y = b.x, e1z = b.y;
  float e2x = b.z, e2y = b.w, e2z = c.x;
  float px = sub(mul(r.dy, e2z), mul(r.dz, e2y));
  float py = sub(mul(r.dz, e2x), mul(r.dx, e2z));
  float pz = sub(mul(r.dx, e2y), mul(r.dy, e2x));
  float det = dot3(e1x, e1y, e1z, px, py, pz);
  if (!(fabsf(det) > 1e-12f)) return;   // parallel, degenerate or padding
  float inv = __frcp_rn(det);
  float tx = sub(r.ox, v0x), ty = sub(r.oy, v0y), tz = sub(r.oz, v0z);
  float u = mul(dot3(tx, ty, tz, px, py, pz), inv);
  // a hit needs u in [0, 1] (v >= 0 and u + v <= 1, rounded, imply u <= 1),
  // as the plain version tests it: most triangles stop here, and the
  // lanes of a coherent warp, on the same triangle, agree
  if (!(u >= 0.0f && u <= 1.0f)) return;
  float qx = sub(mul(ty, e1z), mul(tz, e1y));
  float qy = sub(mul(tz, e1x), mul(tx, e1z));
  float qz = sub(mul(tx, e1y), mul(ty, e1x));
  float v = mul(dot3(r.dx, r.dy, r.dz, qx, qy, qz), inv);
  float t = mul(dot3(e2x, e2y, e2z, qx, qy, qz), inv);
  if (v >= 0.0f && add(u, v) <= 1.0f && t > kRayEps &&
      (t < bt || (t == bt && tri < btri))) {
    bt = t;
    bb1 = u;
    bb2 = v;
    btri = tri;
  }
}

// tris: (n_super * 16 * 128) records of three float4; leaves, boxes,
// super_boxes: [lo.xyz, 0, hi.xyz, 0] rows of 32 triangles, tiles and
// supertiles. work (or null) gets the tiles and the leaves each ray
// tested, two ints a ray.
__global__ void __launch_bounds__(kThreads)
mesh_isect_kernel(const float* __restrict__ o, const float* __restrict__ d,
                  int n, const float4* __restrict__ tris,
                  const float4* __restrict__ leaves,
                  const float4* __restrict__ boxes,
                  const float4* __restrict__ super_boxes, int n_super,
                  float* __restrict__ t_out, float* __restrict__ b1_out,
                  float* __restrict__ b2_out, int* __restrict__ tri_out,
                  int* __restrict__ work) {
  int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;        // no warp-collective code below
  Ray r;
  r.ox = o[3 * i];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  r.ix = 1.0f / (r.dx == 0.0f ? 1e-20f : r.dx);
  r.iy = 1.0f / (r.dy == 0.0f ? 1e-20f : r.dy);
  r.iz = 1.0f / (r.dz == 0.0f ? 1e-20f : r.dz);
  float bt = __int_as_float(0x7f800000);   // +inf
  float bb1 = 0.0f, bb2 = 0.0f;
  int btri = -1, tested = 0, leaves_tested = 0;

  // supertiles g0 + 64 w + b of the current group still to visit, and
  // tiles tile0 + b of the current supertile
  uint64_t smask[kWords] = {0, 0, 0, 0};
  uint64_t tmask = 0;
  int g0 = -kGroup, tile0 = 0;
  // One tile per iteration, so the lanes of a warp run the triangle loop
  // together; finding the next tile is the divergent part.
  for (;;) {
    int tile = -1;
    for (;;) {
      float key = __int_as_float(0x7f800000);
      nearest(boxes, tile0, &tmask, r, bt, &key, &tile);
      if (tile >= 0) {
        tmask &= ~(1ull << (tile - tile0));
        break;
      }
      int sp = -1;
#pragma unroll
      for (int w = 0; w < kWords; ++w)
        nearest(super_boxes, g0 + 64 * w, &smask[w], r, bt, &key, &sp);
      if (sp >= 0) {
#pragma unroll
        for (int w = 0; w < kWords; ++w)
          if (((sp - g0) >> 6) == w) smask[w] &= ~(1ull << ((sp - g0) & 63));
        tile0 = sp * kSuper;
        tmask = (1ull << kSuper) - 1;
        continue;
      }
      g0 += kGroup;
      if (g0 >= n_super) break;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        int left = n_super - (g0 + 64 * w);
        smask[w] = left >= 64 ? ~0ull : (left > 0 ? (1ull << left) - 1 : 0);
      }
    }
    if (tile < 0) break;
    ++tested;
    // the tile's four leaves in index order, each behind its own box
    for (int leaf = tile * kLeaves; leaf < (tile + 1) * kLeaves; ++leaf) {
      float key;
      if (!enters(leaves, leaf, r, bt, &key)) continue;
      ++leaves_tested;
      const float4* rec = tris + (size_t)leaf * kLeaf * 3;
      int tri0 = leaf * kLeaf;
#pragma unroll 4
      for (int k = 0; k < kLeaf; ++k)
        mt_hit(rec + 3 * k, r, tri0 + k, bt, bb1, bb2, btri);
    }
  }
  t_out[i] = bt;
  b1_out[i] = bb1;
  b2_out[i] = bb2;
  tri_out[i] = btri;
  if (work) {
    work[2 * i] = tested;
    work[2 * i + 1] = leaves_tested;
  }
}

}  // namespace

extern "C" {

// o, d: (n, 3) rays; tris: (n_super * 16 * 128, 12) triangle records;
// leaves: (n_super * 64, 8), boxes: (n_super * 16, 8) and super_boxes:
// (n_super, 8) bounds as [lo.xyz, 0, hi.xyz, 0]; out: t, b1, b2 (n,), tri
// (n,) int32 and, unless null, work (n, 2) int32, the tiles and leaves
// each ray tested.
int tsk_mesh_intersect(const float* o, const float* d, int n,
                       const float* tris, const float* leaves,
                       const float* boxes, const float* super_boxes,
                       int n_super, float* t_out, float* b1_out,
                       float* b2_out, int* tri_out, int* work,
                       cudaStream_t stream) {
  if (n <= 0) return 0;
  int blocks = (n + kThreads - 1) / kThreads;
  mesh_isect_kernel<<<blocks, kThreads, 0, stream>>>(
      o, d, n, reinterpret_cast<const float4*>(tris),
      reinterpret_cast<const float4*>(leaves),
      reinterpret_cast<const float4*>(boxes),
      reinterpret_cast<const float4*>(super_boxes), n_super, t_out, b1_out,
      b2_out, tri_out, work);
  return (int)cudaGetLastError();
}

}  // extern "C"
