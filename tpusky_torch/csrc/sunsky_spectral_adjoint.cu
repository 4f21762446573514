// Spectral sunsky adjoint kernels K12 and K13 for sm_90a.
//
// K12 sunsky_hit_spec_bwd  replaces tpusky/ops/pallas/sunsky_kernel.py:
//                          sunsky_hit_spec_bwd_pallas (_spec_hit_bwd_kernel):
//                          the adjoint of the spectral eval (K9) and
//                          emitter-hit (K10) blocks. (d, wl, g_rad (N, W)
//                          [, g_pdf]) -> per-lane dd (N, 3) and dwl (N, W)
//                          and the table cotangents summed over all lanes.
//                          with_pdf adds the mixture pdf's reverse, the
//                          mixture weight attached (model.py::pdf_direction).
// K13 sunsky_nee_spec_bwd  replaces sunsky_kernel.py:
//                          sunsky_nee_spec_bwd_pallas (_spec_nee_bwd_kernel):
//                          the spectral NEE block's adjoint. Each lane
//                          redraws its sample with K11's nee_sample and
//                          runs the radiance's reverse there (the direction
//                          detached) -> dwl and the tables. with_pdf adds
//                          the pdf at the sample, the mixture weight
//                          detached, through the sample's placement; without
//                          it the placement is fully detached, as in K6.
//
// with_pdf is a template flag, chosen at launch by whether g_pdf is given.
// The reverse sweeps are sunsky_core.cuh's: the radiance's in pieces
// (vjp_geometry, spec_fold, sky_channel_vjp, spec_dwl, geometry_vjp),
// pdf_lane_vjp, pdf_vjp_tail and nee_place_vjp, and adjoint_common.cuh's
// gauss_vjp_warp. The TPU kernels traced a jax.vjp over (11, B) channel tiles and one-hot
// products (sunsky_kernel.py:1203-1280).
//
// What bounds them on an H100: arithmetic, as K5-K8 (the forward plus its
// reverse, ~3x K9's work a lane), and how the table cotangents are summed
// over lanes. A lane's wavelengths are first folded onto the 11 dataset
// channels (spec_fold), one cotangent a channel for each of the sky
// formula, the sun polynomial and the limb darkening. The sky tables'
// cotangents (skyp (11, 9), skyr) are then taken channel by channel,
// warp-uniformly: a channel no lane of the warp reads is skipped
// (__any_sync), the others reversed in registers (sky_channel_vjp with
// PlainAdd), staged per warp and summed over its lanes, one lane an
// entry, into the warp's copy (against shuffle sums added by lane 0, on
// an H100 at 2M lanes x 4 wavelengths: K12 0.495 ms against 0.538). The
// sun row's ((45, 44), the block's copy) and the limb table's ((11, 6),
// the warp's copy) take K6's epilogue
// (adjoint_common.cuh::outer_rows_warp): records staged per warp, the sun
// row summed over the lanes that share it, the limb table over the warp,
// one shared atomic per entry per group. No two lanes of a warp add to
// one address of these tables. The misc row's (16), which every lane
// touches, stays in registers and is summed at the end. With the pdf the
// gaussians are staged once a block as K7 and K8 stage them: the pdf's
// table cotangent is summed over the warp by K7's transposed sums, each
// lane owning a few entries in registers (gauss_vjp_warp), and K13's
// placement cotangent grouped by gaussian as K8's (place_rows_warp), into
// the warp's own copy without atomics. A block's partial row is [sun 1980 | skyp 99 |
// skyr 11 | ld 66 | misc 16 | gauss 280] (gauss zero without the pdf).

#include "adjoint_common.cuh"

namespace {

constexpr int kSunN = tsk::N_SEG * tsk::SUN_SPEC_F;            // 1980
constexpr int kMiscCol = kSunN + tsk::N_SPEC_SMALL;            // 2156
constexpr int kGaussCol = kMiscCol + 16;                        // 2172
constexpr int kRow = kGaussCol + kGaussN;                       // 2452
// a lane's staged record: the limb table's (11 + 6 floats), the largest of
// the sun row's (11 + 4), the limb table's and a sky channel's (10)
constexpr int kSpecRec = tsk::N_CH + tsk::N_LD;
// a warp's records, which at the end of the pass hold its gaussian table
// (gauss_table_warp)
constexpr int kWarpRec = 32 * kSpecRec;
static_assert(kWarpRec >= kGaussN, "the warp's records hold its table");

// The sky formula's reverse of a warp's lanes, channel by channel (all 32
// lanes call it): lane by lane in registers for the channels it reads
// (F.need), writing their values to sky and the geometry's cotangents to
// c, the sky scale's to am. A channel's 10 table cotangents are staged in
// s_rec (the warp's 32 x 10 floats), lane k < 10 sums entry k over the 32
// lanes in lane order and adds it to small (the warp's copy, layout
// SPEC_*): no atomics.
__device__ __forceinline__ void spec_sky_warp(const tsk::Tables& T,
                                              const tsk::VjpGeom& v,
                                              const tsk::SpecFold& F,
                                              float sky[tsk::N_CH],
                                              tsk::GeomCot& c, float am[16],
                                              float* small, float* s_rec) {
  float sky_scale = T.misc[tsk::M_SKY_SCALE];
  int lane = threadIdx.x & 31;
#pragma unroll
  for (int ch = 0; ch < tsk::N_CH; ++ch) {
    bool has = (F.need >> ch) & 1u;
    sky[ch] = 0.0f;
    if (!__any_sync(kFull, has)) continue;
    float ak[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) ak[k] = 0.0f;
    if (has) {
      sky[ch] = tsk::sky_channel_vjp(T.skyp + 9 * ch, T.skyr[ch], v,
                                     F.sky[ch] * sky_scale, ak, ak + 9, c,
                                     tsk::PlainAdd());
      am[tsk::M_SKY_SCALE] += F.sky[ch] * sky[ch];
    }
#pragma unroll
    for (int k = 0; k < 10; ++k) s_rec[lane * 10 + k] = ak[k];
    __syncwarp();
    if (lane < 10) {
      float sum = 0.0f;
      for (int l = 0; l < 32; ++l) sum += s_rec[l * 10 + lane];
      small[lane < 9 ? tsk::SPEC_SKYP + 9 * ch + lane
                     : tsk::SPEC_SKYR + ch] += sum;
    }
    __syncwarp();   // read before the next channel writes
  }
}

// Pass 1. kNee false (K12) reads directions (n, 3) and writes dd (unless
// null); kNee true (K13) reads uniforms (n, 2) and redraws each sample.
// Both write dwl (n, nw) unless it is null. Every thread of a block runs
// the same iterations and calls the warp-level parts on each.
template <bool kNee, bool kPdf>
__device__ __forceinline__ void spec_adjoint_pass(
    const float* __restrict__ in, const float* __restrict__ wl,
    const float* __restrict__ g, const float* __restrict__ g_pdf, int n,
    int nw, const tsk::Tables& T, float* __restrict__ dd_out,
    float* __restrict__ dwl_out, float* __restrict__ partial) {
  constexpr bool kPlace = kNee && kPdf;
  __shared__ float s_sun[kSunN];
  __shared__ float s_small[kWarps * tsk::N_SPEC_SMALL];
  __shared__ float s_misc[kWarps * 16];
  __shared__ float4 s_gz[tsk::N_GAUSS];
  __shared__ float s_gamp[tsk::N_GAUSS];
  __shared__ float s_place[kPlace ? kWarps * kPlaceN : 1];
  __shared__ float s_rec[kWarps * kWarpRec];
  for (int i = threadIdx.x; i < kSunN; i += kThreads) s_sun[i] = 0.0f;
  for (int i = threadIdx.x; i < kWarps * tsk::N_SPEC_SMALL; i += kThreads)
    s_small[i] = 0.0f;
  if (kPlace)
    for (int i = threadIdx.x; i < kWarps * kPlaceN; i += kThreads)
      s_place[i] = 0.0f;
  if (kPdf) stage_gauss(s_gz, s_gamp, T.gauss, threadIdx.x, kThreads);
  __syncthreads();
  int warp = threadIdx.x >> 5;
  float* s_small_w = s_small + warp * tsk::N_SPEC_SMALL;
  float* s_place_w = s_place + (kPlace ? warp * kPlaceN : 0);
  float* s_rec_w = s_rec + warp * kWarpRec;

  float am[16], own_g[kGaussGroups];
#pragma unroll
  for (int k = 0; k < 16; ++k) am[k] = 0.0f;
#pragma unroll
  for (int q = 0; q < kGaussGroups; ++q) own_g[q] = 0.0f;

  for (long long base = (long long)blockIdx.x * kThreads; base < n;
       base += (long long)gridDim.x * kThreads) {
    int i = (int)base + threadIdx.x;
    bool live = i < n;
    size_t row = (size_t)(live ? i : 0) * nw;
    bool rad = false;
    if (live)
      for (int w = 0; w < nw; ++w) rad = rad || g[row + w] != 0.0f;
    float gp = (kPdf && live) ? g_pdf[i] : 0.0f;
    float d[3] = {0.0f, 0.0f, 1.0f};
    float u0 = 0.0f, u1 = 0.0f;
    bool pick_sky = true;
    float dd[3] = {0.0f, 0.0f, 0.0f};
    float* dwl = (live && dwl_out != nullptr) ? dwl_out + row : nullptr;
    if (live && (rad || gp != 0.0f)) {
      if (kNee) {
        u0 = in[2 * i];
        u1 = in[2 * i + 1];
        pick_sky = tsk::nee_sample(T, u0, u1, d);
      } else {
        d[0] = in[3 * i];
        d[1] = in[3 * i + 1];
        d[2] = in[3 * i + 2];
      }
    }
    // the radiance's reverse (0 below the horizon)
    bool act = live && rad && d[2] >= 0.0f;
    tsk::VjpGeom v = {};
    tsk::GeomCot c = {};
    tsk::SpecFold F = {};
    float sky[tsk::N_CH];
    if (act) {
      v = tsk::vjp_geometry(T.misc, d[0], d[1], d[2]);
      tsk::spec_fold(T, v, wl + row, g + row, nw, F, am, c);
    }
    // the sun row's and the limb table's cotangents first, so that their
    // folded channels are not held through the sky's reverse
    outer_rows_warp<tsk::N_CH, 4, 0>(F.sun, v.pos, F.sun_c, v.xp, nullptr,
                                     s_rec_w, s_sun, tsk::SUN_SPEC_F);
    outer_rows_warp<tsk::N_CH, 0, tsk::N_LD>(F.sun, 0, F.ld, nullptr, v.cp,
                                             s_rec_w,
                                             s_small_w + tsk::SPEC_LD, 0);
    spec_sky_warp(T, v, F, sky, c, am, s_small_w, s_rec_w);
    if (act) {
      if (dwl != nullptr) tsk::spec_dwl(T, v, wl + row, g + row, nw, sky, dwl);
      tsk::geometry_vjp(T.misc, v, c, dd, am);
    } else if (dwl != nullptr) {
      for (int w = 0; w < nw; ++w) dwl[w] = 0.0f;
    }
    if (kPdf) {
      // an NEE sample's pdf is masked below the horizon
      if (kNee && !(d[2] >= 0.0f)) gp = 0.0f;
      tsk::PdfLane P = tsk::pdf_lane_vjp(T, d[0], d[1], d[2], pick_sky, gp);
      float g_phi, g_theta;
      float tg = gauss_vjp_warp(s_gz, s_gamp, P, &g_phi, &g_theta, own_g);
      int idx = -1;
      float place[tsk::N_PLACE] = {};
      if (gp != 0.0f) {
        if (kNee) {
          float dp[3] = {0.0f, 0.0f, 0.0f};
          tsk::pdf_vjp_tail(T.misc, d[0], d[1], d[2], P, tg, gp, true,
                            g_phi, g_theta, dp, am);
          idx = tsk::nee_place_vjp(T, u0, u1, dp, am, place);
        } else {
          tsk::pdf_vjp_tail(T.misc, d[0], d[1], d[2], P, tg, gp, false,
                            g_phi, g_theta, dd, am);
        }
      }
      if (kPlace) place_rows_warp(idx, place, s_rec_w, s_place_w);
    }
    if (!kNee && live && dd_out != nullptr) {
      dd_out[3 * i] = dd[0];
      dd_out[3 * i + 1] = dd[1];
      dd_out[3 * i + 2] = dd[2];
    }
  }

  warp_partials<16>(am, s_misc);
  if (kPdf) gauss_table_warp(own_g, kPlace ? s_place_w : nullptr, s_rec_w);
  __syncthreads();
  float* __restrict__ out = partial + (size_t)blockIdx.x * kRow;
  for (int j = threadIdx.x; j < kSunN; j += kThreads) out[j] = s_sun[j];
  for (int j = threadIdx.x; j < tsk::N_SPEC_SMALL; j += kThreads)
    out[kSunN + j] = warps_sum(s_small, tsk::N_SPEC_SMALL, j);
  if (threadIdx.x < 16)
    out[kMiscCol + threadIdx.x] = warps_sum(s_misc, 16, threadIdx.x);
  for (int j = threadIdx.x; j < kGaussN; j += kThreads)
    out[kGaussCol + j] = kPdf ? warps_sum(s_rec, kWarpRec, j) : 0.0f;
}

template <bool kPdf>
__global__ void __launch_bounds__(kThreads)
spec_hit_bwd_kernel(const float* __restrict__ d, const float* __restrict__ wl,
                    const float* __restrict__ g,
                    const float* __restrict__ g_pdf, int n, int nw,
                    tsk::Tables T, float* __restrict__ dd,
                    float* __restrict__ dwl, float* __restrict__ partial) {
  spec_adjoint_pass<false, kPdf>(d, wl, g, g_pdf, n, nw, T, dd, dwl,
                                 partial);
}

template <bool kPdf>
__global__ void __launch_bounds__(kThreads)
spec_nee_bwd_kernel(const float* __restrict__ u, const float* __restrict__ wl,
                    const float* __restrict__ g,
                    const float* __restrict__ g_pdf, int n, int nw,
                    tsk::Tables T, float* __restrict__ dwl,
                    float* __restrict__ partial) {
  spec_adjoint_pass<true, kPdf>(u, wl, g, g_pdf, n, nw, T, nullptr, dwl,
                                partial);
}

tsk::Tables tables(const float* skyp, const float* skyr, const float* sun,
                   const float* ld, const float* misc, const float* gauss) {
  return tsk::Tables{skyp, skyr, sun, misc, gauss, ld};
}

}  // namespace

extern "C" {

// K12: d (n, 3), wl (n, nw), g (n, nw), g_pdf (n,) or null (with_pdf
// false) -> dd (n, 3) and dwl (n, nw), each unless null, and out (2452,) =
// [sun (45, 44) | skyp (11, 9) | skyr (11,) | ld (11, 6) | misc (16,) |
// gauss (14, 20)] cotangents; partial: tsk_adjoint_rows(n) x 2452 floats.
int tsk_sunsky_hit_spec_bwd(const float* d, const float* wl, const float* g,
                            const float* g_pdf, int n, int nw,
                            const float* skyp, const float* skyr,
                            const float* sun, const float* ld,
                            const float* misc, const float* gauss, float* dd,
                            float* dwl, float* partial, float* out,
                            void* stream) {
  int rows = adjoint_rows(n);
  cudaStream_t s = (cudaStream_t)stream;
  tsk::Tables T = tables(skyp, skyr, sun, ld, misc, gauss);
  if (g_pdf != nullptr)
    spec_hit_bwd_kernel<true><<<rows, kThreads, 0, s>>>(
        d, wl, g, g_pdf, n, nw, T, dd, dwl, partial);
  else
    spec_hit_bwd_kernel<false><<<rows, kThreads, 0, s>>>(
        d, wl, g, nullptr, n, nw, T, dd, dwl, partial);
  return finish(partial, rows, kRow, out, s);
}

// K13: u (n, 2), wl (n, nw), g (n, nw), g_pdf (n,) or null -> dwl (n, nw)
// unless null, out (2452,) as K12.
int tsk_sunsky_nee_spec_bwd(const float* u, const float* wl, const float* g,
                            const float* g_pdf, int n, int nw,
                            const float* skyp, const float* skyr,
                            const float* sun, const float* ld,
                            const float* misc, const float* gauss,
                            float* dwl, float* partial, float* out,
                            void* stream) {
  int rows = adjoint_rows(n);
  cudaStream_t s = (cudaStream_t)stream;
  tsk::Tables T = tables(skyp, skyr, sun, ld, misc, gauss);
  if (g_pdf != nullptr)
    spec_nee_bwd_kernel<true><<<rows, kThreads, 0, s>>>(
        u, wl, g, g_pdf, n, nw, T, dwl, partial);
  else
    spec_nee_bwd_kernel<false><<<rows, kThreads, 0, s>>>(
        u, wl, g, nullptr, n, nw, T, dwl, partial);
  return finish(partial, rows, kRow, out, s);
}

}  // extern "C"
