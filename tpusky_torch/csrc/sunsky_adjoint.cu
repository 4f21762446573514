// Sunsky adjoint kernels K5-K8 for sm_90a.
//
// K5 sunsky_eval_rgb_bwd  replaces tpusky/ops/pallas/sunsky_kernel.py:
//                         sunsky_eval_rgb_bwd_pallas (_eval_rgb_bwd_kernel):
//                         the radiance adjoint. (d, g_rad) -> per-lane dd and
//                         the table cotangents summed over all lanes.
// K6 sunsky_nee_rgb_bwd   replaces sunsky_kernel.py:
//                         sunsky_nee_rgb_bwd_nopdf_pallas
//                         (_nee_rgb_bwd_nopdf_kernel): the NEE block's
//                         radiance adjoint with the pdf detached. Each lane
//                         redraws its sample as K3 draws it (placement is
//                         fully detached) and runs K5's adjoint there.
// K7 sunsky_hit_rgb_bwd   replaces sunsky_kernel.py:sunsky_hit_rgb_bwd_pallas
//                         (_hit_rgb_bwd_kernel): the emitter-hit block's
//                         adjoint with the pdf attached. K5 plus the mixture
//                         pdf's reverse (the mixture weight attached, as
//                         model.py::pdf_direction keeps it): dd gains the
//                         pdf's direction cotangent, the tables the
//                         gaussian table's.
// K8 sunsky_nee_rgb_pdf_bwd  replaces sunsky_kernel.py:
//                         sunsky_nee_rgb_bwd_pallas (_nee_rgb_bwd_kernel):
//                         the NEE block's adjoint with the pdf attached. K6
//                         plus the pdf at the sample, the mixture weight
//                         detached, whose direction cotangent goes back
//                         through the sample's placement (nee_place_vjp).
//
// The reverse sweeps are derived by hand (the TPU kernels traced a jax.vjp
// of their gradient-safe forward body instead): the radiance's below, the
// pdf's in sunsky_core.cuh (pdf_lane_vjp, pdf_vjp_tail, nee_place_vjp)
// and adjoint_common.cuh (gauss_vjp_warp).
//
// What bounds them on an H100: arithmetic, a chain of special functions a
// lane (asin, sin, cos, the sky formula's two exps a channel; in the disc
// acos, cbrt and the sun polynomial with its partials; K7/K8's 20 exps of
// the pdf, K6/K8's erfinv of the sample), run at the occupancy the
// registers allow, and the table cotangents' sum over lanes. Measured
// first (tools/torch_ab.py rgb_bwd, 2M lanes, an NVIDIA H100 80GB HBM3 at
// 700 W): the earlier kernels ran at 150-167 registers, one block an SM;
// the sun work on every lane was half of K5, the gaussians' reverse (an
// IEEE division per term and value, 25 shuffles and 5 atomics a
// gaussian) ~1.5 ms of K7's and K8's ~2.1-2.5. The design:
// - a grid of as many 256-thread blocks as the SMs hold at once walks the
//   lanes; each block stages the small tables once (sunsky_staged.cuh's
//   StagedRgb: the sky rows, misc, the gaussians as (mu, 1/sigma) records
//   and the sampler's table) and the values every lane would compute alike
//   (AdjConsts). K6 and K8 redraw their samples from the staged tables
//   with K3's own function, so their directions are K3's;
// - few live registers: the skyp and skyr cotangents (30) are not carried
//   across the loop but summed over the warp after each channel's
//   reverse, by a transposed sum that leaves each lane one entry it owns
//   (warp_transpose_sum), and the gaussian table's (K7, K8) likewise, 4
//   gaussians (20 values) at a time; only the misc row's 16 and the owned
//   entries stay in registers. K5 and K6 fit 80 registers (three blocks an
//   SM), K7 and K8 128 (two), none spilling;
// - the sun's segment and limb geometry, its 72 coefficients and the
//   polynomial with its partials are computed only where they are read:
//   in the disc and on the thin ring of the disc weight's ramp outside it,
//   whose cotangent reaches cos_cut, the softness and the sun direction;
// - the gaussian terms multiply by 1/sigma, no division left in the pdf;
// - K6 and K8 rank each warp's 128 lanes by strategy (rank_by_strategy,
//   as K3): the sky samples' passes apart from the sun-cone samples'
//   (in turns, K8's headline 6-9% faster: mixed warps paid both branches
//   of the sample and the placement, and the disc);
// - the (45, 72) sun table's cotangent goes to the block's copy in shared
//   memory, the lanes of a warp that share a row summed first
//   (sun_row_warp, one shared atomic per entry per group); K8's placement
//   cotangents, 8 entries of the gaussian a lane picked, are grouped by
//   gaussian the same way into the warp's own copy, without atomics.
// A block writes its partial row [sun 3240 | skyp 27 | skyr 3 | misc 16
// (| gauss 280)], and reduce_partials sums the rows in a fixed order. Only
// the order of the sun table's shared atomics varies from run to run.
// At 2M lanes on that card (rgb_bwd, in turns with the earlier kernels;
// PERF.md) K5 takes ~0.12 ms (0.36-0.40 before), K6 ~0.27 (0.61-0.66), K7
// ~0.25 (2.07-2.14), K8 ~0.53 (2.46-2.54).

#include "adjoint_common.cuh"
#include "sunsky_staged.cuh"

namespace {

constexpr int kSunN = tsk::N_SEG * tsk::SUN_F;          // 3240
constexpr int kRow = kSunN + tsk::N_ACC;                  // 3286
constexpr int kRowPdf = kRow + kGaussN;                   // 3566
// blocks an SM the kernels are compiled for: K5 and K6 fit 80 registers
// without spilling, three blocks; K7 and K8 128, two (at 80 they spill)
constexpr int kBlocksRad = 3;
constexpr int kBlocksPdf = 2;
constexpr int kChunk = 128;      // K6, K8: lanes a warp ranks at a time
constexpr int kPasses = kChunk / 32;
// a warp's records for sun_row_warp and place_rows_warp, which at the end
// of the pass hold its gaussian table (gauss_table_warp)
constexpr int kWarpRec = 32 * kSunRec;
static_assert(kWarpRec >= kGaussN, "the warp's records hold its table");

// What every lane of the reverse would compute alike from the misc row,
// computed once a block.
struct AdjConsts {
  float inv_sin_ap2;    // 1 / sin(half aperture)^2
  float ap_k;           // 2 cos(half ap) / sin(half ap)^3: d(q)/d(half ap)
                        // is sin(gamma)^2 ap_k, q = 1 - sin^2(g) / sin^2(ap)
  float eps, eps_c, inv_eps_c;   // the disc weight's ramp: eps, max(eps,
                                 // 1e-12) and its reciprocal
};

// Thread 0 fills K; the caller syncs the block before it is read.
__device__ __forceinline__ void stage_consts(AdjConsts& K,
                                             const float* __restrict__ misc) {
  if (threadIdx.x != 0) return;
  float sin_ap = sinf(misc[tsk::M_HALF_AP]);
  float sa2 = sin_ap * sin_ap;
  K.inv_sin_ap2 = 1.0f / sa2;
  K.ap_k = 2.0f * cosf(misc[tsk::M_HALF_AP]) / (sa2 * sin_ap);
  K.eps = 0.5f * (1.0f - misc[tsk::M_COS_CUT]) * misc[tsk::M_SOFT];
  K.eps_c = fmaxf(K.eps, 1e-12f);
  K.inv_eps_c = 1.0f / K.eps_c;
}

// The forward values at an above-horizon direction that the radiance's
// reverse reads (sunsky_core.cuh's VjpGeom without the sun's segment and
// limb coordinates, which sun_vjp computes where it needs them).
struct LaneGeom {
  float ct, ct1, inv_ct1;       // cos(theta), ct + 0.01, 1 / ct1
  float r, half_inv_r;          // sqrt(ct), 0.5 / sqrt(ct) (0 at ct 0)
  float s, ex, ey, ez, len, hc; // gamma = 2 asin(hc), hc = |d - s n| / 2
  float gamma, cos_g, sin_g, cg2;
  bool hard, ramp;              // in the disc; on the disc weight's ramp
};

__device__ __forceinline__ LaneGeom lane_geometry(const tsk::StagedRgb& S,
                                                  const AdjConsts& K,
                                                  float dx, float dy,
                                                  float dz) {
  const float* misc = S.misc;
  LaneGeom v;
  float nx = misc[tsk::M_SUNX], ny = misc[tsk::M_SUNY],
        nz = misc[tsk::M_SUNZ];
  v.ct = dz;
  v.ct1 = dz + 0.01f;
  v.inv_ct1 = 1.0f / v.ct1;
  v.r = tsk::safe_sqrt(dz);
  v.half_inv_r = dz > 0.0f ? 0.5f / v.r : 0.0f;
  float dot = nx * dx + ny * dy + nz * dz;
  v.s = dot >= 0.0f ? 1.0f : -1.0f;
  v.ex = dx - v.s * nx;
  v.ey = dy - v.s * ny;
  v.ez = dz - v.s * nz;
  v.len = sqrtf(v.ex * v.ex + v.ey * v.ey + v.ez * v.ez);
  v.hc = 0.5f * v.len;
  float temp = 2.0f * tsk::safe_asin(v.hc);
  v.gamma = dot >= 0.0f ? temp : tsk::PI_F - temp;
  v.cos_g = cosf(v.gamma);
  v.sin_g = sinf(v.gamma);
  v.cg2 = v.cos_g * v.cos_g;
  float cos_cut = misc[tsk::M_COS_CUT];
  v.hard = v.cos_g >= cos_cut;
  // (cos_g - cos_cut) / eps_c + 1/2, the division's value bitwise
  float ramp = tsk::div_by(v.cos_g - cos_cut, K.eps_c, K.inv_eps_c) + 0.5f;
  v.ramp = ramp >= 0.0f && ramp <= 1.0f;
  return v;
}

// Channel ch's sky formula (model.py::_sky_formula) from its staged row
// and its reverse for gs, its value's cotangent: writes its 9 parameters'
// cotangents to ak[0..8] and its mean radiance's to ak[9], adds the
// geometry's to c and returns the value. The divisions by ct + 0.01 and
// by base^(3/2) take one reciprocal each.
__device__ __forceinline__ float sky_vjp(const tsk::StagedRgb& S, int ch,
                                         const LaneGeom& v, float gs,
                                         float (&ak)[10], tsk::GeomCot& c) {
  const float4 A = S.sky[ch][0], B = S.sky[ch][1], M = S.sky[ch][2];
  const float a = A.x, b = A.y, kd = A.w, ke = B.x, kf = B.y, kg = B.z;
  const float ki = B.w, h = M.x, mean = M.y;
  float e1 = expf(tsk::div_by(b, v.ct1, v.inv_ct1));
  float c1 = 1.0f + a * e1;
  float base = 1.0f + h * h - 2.0f * h * v.cos_g;
  float sqb = tsk::safe_sqrt(base);
  float inv_den = 1.0f / (base * sqb);
  float chi = (1.0f + v.cg2) * inv_den;
  float e2 = expf(ke * v.gamma);
  float c2 = A.z + kd * e2 + kf * v.cg2 + kg * chi + ki * v.r;
  ak[9] = gs * c1 * c2;
  float g_c1 = gs * c2 * mean, g_c2 = gs * c1 * mean;
  // c1 = 1 + a exp(b / (ct + 0.01))
  ak[0] = g_c1 * e1;
  float g_arg1 = g_c1 * a * e1 * v.inv_ct1;
  ak[1] = g_arg1;
  c.ct -= g_arg1 * b * v.inv_ct1;
  // c2 = c + d exp(e gamma) + f cg2 + g chi + i sqrt(ct)
  ak[2] = g_c2;
  ak[3] = g_c2 * e2;
  float g_arg2 = g_c2 * kd * e2;
  ak[4] = g_arg2 * v.gamma;
  c.gamma += g_arg2 * ke;
  ak[5] = g_c2 * v.cg2;
  c.cg2 += g_c2 * kf;
  ak[6] = g_c2 * chi;
  float g_chi = g_c2 * kg;
  ak[7] = g_c2 * v.r;
  c.ct += g_c2 * ki * v.half_inv_r;
  // chi = (1 + cg2) / base^(3/2), base = 1 + h^2 - 2 h cos_gamma
  c.cg2 += g_chi * inv_den;
  float g_base = -1.5f * g_chi * chi * inv_den * sqb;
  ak[8] = g_base * (2.0f * h - 2.0f * v.cos_g);
  c.cg -= g_base * 2.0f * h;
  return c1 * c2 * mean;
}

// The sun's part of the radiance's reverse at a lane in the disc or on
// the disc weight's ramp, for the channels' cotangents G (CIE_Y_NORM
// folded in): the segment and limb coordinates, the sun polynomial
// (sum_k x^k L_k, L_k = sum_j coef_kj cos_psi^j, from the global table)
// and, in the disc, its partials; records the sun row's cotangent in sc
// and takes the disc weight's, the segment coordinate's and the limb's
// cotangents back to c and the misc row (am).
__device__ __forceinline__ void sun_vjp(const tsk::StagedRgb& S,
                                        const AdjConsts& K,
                                        const float* __restrict__ sun,
                                        const LaneGeom& v, const float G[3],
                                        float* am, tsk::GeomCot& c,
                                        tsk::SunCot& sc) {
  using namespace tsk;
  const float* misc = S.misc;
  float elevation = 0.5f * PI_F - safe_acos(v.ct);
  int pos = (int)floorf(cbrtf(2.0f * elevation / PI_F) * N_SEG);
  pos = min(max(pos, 0), N_SEG - 1);
  float bx = (float)pos / N_SEG;
  float x_raw = elevation - 0.5f * PI_F * (bx * bx * bx);
  float x = fmaxf(x_raw, 0.0f);
  float q = 1.0f - div_by(v.sin_g * v.sin_g, S.sin_ap2, K.inv_sin_ap2);
  float cos_psi = safe_sqrt(q);
  sc.pos = pos;
  sc.xp[0] = 1.0f;
  sc.xp[1] = x;
  sc.xp[2] = x * x;
  sc.xp[3] = x * x * x;
  sc.cp[0] = 1.0f;
#pragma unroll
  for (int j = 1; j < N_LD; ++j) sc.cp[j] = sc.cp[j - 1] * cos_psi;
  const float sun_scale = misc[M_SUN_SCALE];
  const float* __restrict__ coefs = sun + pos * SUN_F;
  float cw = 0.0f, cx = 0.0f, ccp = 0.0f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float val = 0.0f, val_x = 0.0f, val_cp = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float l = 0.0f, l_cp = 0.0f;
#pragma unroll
      for (int j = 0; j < N_LD; ++j) {
        float co = __ldg(coefs + ch * 24 + k * N_LD + j);
        l += co * sc.cp[j];
        if (j > 0) l_cp += co * ((float)j * sc.cp[j - 1]);
      }
      val += sc.xp[k] * l;
      if (k > 0) val_x += ((float)k * sc.xp[k - 1]) * l;
      val_cp += sc.xp[k] * l_cp;
    }
    // out = (sky_scale sky + w sun_scale sun) CIE_Y_NORM, w the disc weight
    cw += G[ch] * sun_scale * val;
    sc.g[ch] = v.hard ? G[ch] * sun_scale : 0.0f;
    if (v.hard) {
      am[M_SUN_SCALE] += G[ch] * val;
      cx += sc.g[ch] * val_x;
      ccp += sc.g[ch] * val_cp;
    }
  }
  // the disc weight: w = clamp(ramp, 0, 1) + (hard - that, detached),
  // ramp = (cos_gamma - cos_cut) / eps + 1/2, eps = (1 - cos_cut) soft / 2
  if (v.ramp) {
    float cos_cut = misc[M_COS_CUT];
    float w_e = cw * K.inv_eps_c;
    c.cg += w_e;
    am[M_COS_CUT] -= w_e;
    float g_eps = -w_e * (v.cos_g - cos_cut) * K.inv_eps_c;
    if (K.eps >= 1e-12f) {
      am[M_COS_CUT] -= 0.5f * misc[M_SOFT] * g_eps;
      am[M_SOFT] += 0.5f * (1.0f - cos_cut) * g_eps;
    }
  }
  if (v.hard) {
    // cos_psi = sqrt(q) (zero derivative where q <= 0)
    if (q > 0.0f) {
      float g_q = ccp * 0.5f / cos_psi;
      c.gamma += g_q * (-2.0f * v.sin_g * K.inv_sin_ap2) * v.cos_g;
      am[M_HALF_AP] += g_q * (v.sin_g * v.sin_g * K.ap_k);
    }
    // x = max(elevation - break_x, 0), elevation = pi/2 - acos(ct)
    if (x_raw >= 0.0f && fabsf(v.ct) < 1.0f)
      c.ct += cx / sqrtf(1.0f - v.ct * v.ct);
  }
}

// gamma's reverse and cos(theta)'s: adds the direction's cotangent to dd
// and the sun direction's to am.
__device__ __forceinline__ void gamma_vjp(const LaneGeom& v,
                                          tsk::GeomCot c, float dd[3],
                                          float* am) {
  c.cg += c.cg2 * 2.0f * v.cos_g;
  c.gamma -= c.cg * v.sin_g;
  // gamma = 2 asin(|d - s n| / 2), mirrored past 90 degrees
  float g_temp = v.s * c.gamma;
  if (fabsf(v.hc) < 1.0f && v.len > 0.0f) {
    float g_len = g_temp / sqrtf(1.0f - v.hc * v.hc);   // 2 * asin' * 1/2
    float k = g_len / v.len;
    float gx = k * v.ex, gy = k * v.ey, gz = k * v.ez;
    dd[0] += gx;
    dd[1] += gy;
    dd[2] += gz;
    am[tsk::M_SUNX] -= v.s * gx;
    am[tsk::M_SUNY] -= v.s * gy;
    am[tsk::M_SUNZ] -= v.s * gz;
  }
  dd[2] += c.ct;
}

// The radiance's reverse (radiance(), model.py::_eval_rgb_plain) for a
// warp's lanes (all 32 call it; act on a lane above the horizon with a
// cotangent gl): adds the direction's cotangent to dd, the misc row's to
// am and the sky rows' to own_sky (each lane's owned entry of a channel's
// 10, warp_transpose_sum's order), and the sun table's to s_sun.
__device__ __forceinline__ void radiance_vjp_warp(
    const tsk::StagedRgb& S, const AdjConsts& K,
    const float* __restrict__ sun, bool act, const float d[3],
    const float gl[3], float dd[3], float* am, float (&own_sky)[3],
    float* s_rec, float* s_sun) {
  LaneGeom v = {};
  tsk::GeomCot c = {};
  float G[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) G[ch] = gl[ch] * tsk::CIE_Y_NORM;
  if (act) v = lane_geometry(S, K, d[0], d[1], d[2]);
  if (__any_sync(kFull, act)) {
    const float sky_scale = S.misc[tsk::M_SKY_SCALE];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float ak[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) ak[k] = 0.0f;
      if (act)
        am[tsk::M_SKY_SCALE] += G[ch] * sky_vjp(S, ch, v, G[ch] * sky_scale,
                                                ak, c);
      own_sky[ch] += warp_transpose_sum(ak);
    }
  }
  tsk::SunCot sc;
  sc.pos = 0;
  sc.g[0] = sc.g[1] = sc.g[2] = 0.0f;
  if (act && (v.hard || v.ramp)) sun_vjp(S, K, sun, v, G, am, c, sc);
  sun_row_warp(sc, s_rec, s_sun);
  if (act) gamma_vjp(v, c, dd, am);
}

// Pass 1. kNee false (K5, K7) reads directions in (n, 3) and writes dd;
// kNee true (K6, K8) reads uniforms in (n, 2) and redraws each sample.
// kPdf adds the pdf's cotangent g_pdf (n,). Every thread of a block runs
// the same iterations and calls the warp-level parts on each.
template <bool kNee, bool kPdf>
__device__ __forceinline__ void adjoint_pass(
    const float* __restrict__ in, const float* __restrict__ g,
    const float* __restrict__ g_pdf, int n, const tsk::Tables& T,
    float* __restrict__ dd_out, float* __restrict__ partial) {
  constexpr bool kPlace = kNee && kPdf;
  __shared__ tsk::StagedRgb S;
  __shared__ AdjConsts K;
  __shared__ float s_sun[kSunN];
  __shared__ float s_small[kWarps * tsk::N_ACC];
  __shared__ float s_rec[kWarps * kWarpRec];
  __shared__ float s_place[kPlace ? kWarps * kPlaceN : 1];
  for (int i = threadIdx.x; i < kSunN; i += kThreads) s_sun[i] = 0.0f;
  if (kPlace)
    for (int i = threadIdx.x; i < kWarps * kPlaceN; i += kThreads)
      s_place[i] = 0.0f;
  stage_consts(K, T.misc);
  tsk::stage_rgb<kNee || kPdf>(S, T);   // syncs the block
  const tsk::Tables V = tsk::staged_view(T, S);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* s_rec_w = s_rec + warp * kWarpRec;
  float* s_place_w = s_place + (kPlace ? warp * kPlaceN : 0);

  float am[16], own_sky[3] = {0.0f, 0.0f, 0.0f}, own_g[kGaussGroups];
#pragma unroll
  for (int k = 0; k < 16; ++k) am[k] = 0.0f;
#pragma unroll
  for (int q = 0; q < kGaussGroups; ++q) own_g[q] = 0.0f;

  // one lane (all 32 of a warp call it at once; live false past n)
  auto lane_step = [&](int i, bool live) {
    float gl[3] = {0.0f, 0.0f, 0.0f};
    float gp = 0.0f;
    if (live) {
      gl[0] = g[3 * i];
      gl[1] = g[3 * i + 1];
      gl[2] = g[3 * i + 2];
      if (kPdf) gp = g_pdf[i];
    }
    const bool rad = gl[0] != 0.0f || gl[1] != 0.0f || gl[2] != 0.0f;
    float d[3] = {0.0f, 0.0f, 1.0f};
    float u0 = 0.0f, u1 = 0.0f;
    bool pick_sky = true;
    if (live && (rad || gp != 0.0f)) {
      if (kNee) {
        u0 = in[2 * i];
        u1 = in[2 * i + 1];
        pick_sky = tsk::nee_sample(V, u0, u1, d);
      } else {
        d[0] = in[3 * i];
        d[1] = in[3 * i + 1];
        d[2] = in[3 * i + 2];
      }
    }
    float dd[3] = {0.0f, 0.0f, 0.0f};
    radiance_vjp_warp(S, K, T.sun, live && rad && d[2] >= 0.0f, d, gl, dd,
                      am, own_sky, s_rec_w, s_sun);
    if (kPdf) {
      // an NEE sample's pdf is masked below the horizon
      if (kNee && !(d[2] >= 0.0f)) gp = 0.0f;
      tsk::PdfLane P = tsk::pdf_lane_vjp(V, d[0], d[1], d[2], pick_sky, gp);
      float g_phi, g_theta;
      float tg = gauss_vjp_warp(S.gz, S.gamp, P, &g_phi, &g_theta, own_g);
      int idx = -1;
      float place[tsk::N_PLACE] = {};
      if (gp != 0.0f) {
        if (kNee) {
          float dp[3] = {0.0f, 0.0f, 0.0f};
          tsk::pdf_vjp_tail(S.misc, d[0], d[1], d[2], P, tg, gp, true,
                            g_phi, g_theta, dp, am);
          idx = tsk::nee_place_vjp(V, u0, u1, dp, am, place);
        } else {
          tsk::pdf_vjp_tail(S.misc, d[0], d[1], d[2], P, tg, gp, false,
                            g_phi, g_theta, dd, am);
        }
      }
      if (kPlace) place_rows_warp(idx, place, s_rec_w, s_place_w);
    }
    if (!kNee && live) {
      dd_out[3 * i] = dd[0];
      dd_out[3 * i + 1] = dd[1];
      dd_out[3 * i + 2] = dd[2];
    }
  };
  if constexpr (kNee) {
    // K6, K8: a warp's chunks of kChunk lanes, ranked by strategy (as K3
    // ranks them): the sky samples' passes apart from the sun-cone
    // samples', so a pass pays one sample branch and one placement
    // reverse, and only the sun-cone passes reach the disc
    __shared__ int order[kWarps][kChunk];
    int* ord = order[warp];
    const float w_sky = S.misc[tsk::M_WMIX];
    for (long long base = ((long long)blockIdx.x * kWarps + warp) * kChunk;
         base < n; base += (long long)gridDim.x * kWarps * kChunk) {
      bool sky[kPasses], valid[kPasses];
#pragma unroll
      for (int k = 0; k < kPasses; ++k) {
        long long i = base + 32 * k + lane;
        valid[k] = i < n;
        sky[k] = valid[k] && in[2 * i] < w_sky;
      }
      const int count = tsk::rank_by_strategy(sky, valid, ord);
#pragma unroll 1
      for (int q = lane; q < kChunk; q += 32) {
        bool live = q < count;
        lane_step(live ? (int)base + ord[q] : 0, live);
      }
      __syncwarp();   // ord is read before the next chunk ranks
    }
  } else {
    for (long long base = (long long)blockIdx.x * kThreads; base < n;
         base += (long long)gridDim.x * kThreads) {
      const int i = (int)base + threadIdx.x;
      lane_step(i, i < n);
    }
  }

  // the warp's sums: misc by shuffles, the sky rows' owned entries, the
  // gaussian table into its records
  warp_partials<16>(am, s_small + tsk::ACC_MISC, tsk::N_ACC);
  const int e = transpose_owner(10, lane);
  if (e >= 0)
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      s_small[warp * tsk::N_ACC + (e < 9 ? tsk::ACC_SKYP + 9 * ch + e
                                         : tsk::ACC_SKYR + ch)] = own_sky[ch];
  if (kPdf) gauss_table_warp(own_g, kPlace ? s_place_w : nullptr, s_rec_w);
  __syncthreads();
  constexpr int kCols = kPdf ? kRowPdf : kRow;
  float* __restrict__ row = partial + (size_t)blockIdx.x * kCols;
  for (int j = threadIdx.x; j < kSunN; j += kThreads) row[j] = s_sun[j];
  if (threadIdx.x < tsk::N_ACC)
    row[kSunN + threadIdx.x] = warps_sum(s_small, tsk::N_ACC, threadIdx.x);
  if (kPdf)
    for (int j = threadIdx.x; j < kGaussN; j += kThreads)
      row[kRow + j] = warps_sum(s_rec, kWarpRec, j);
}

__global__ void __launch_bounds__(kThreads, kBlocksRad)
eval_bwd_kernel(const float* __restrict__ d, const float* __restrict__ g,
                int n, tsk::Tables T, float* __restrict__ dd,
                float* __restrict__ partial) {
  adjoint_pass<false, false>(d, g, nullptr, n, T, dd, partial);
}

__global__ void __launch_bounds__(kThreads, kBlocksRad)
nee_bwd_kernel(const float* __restrict__ u, const float* __restrict__ g,
               int n, tsk::Tables T, float* __restrict__ partial) {
  adjoint_pass<true, false>(u, g, nullptr, n, T, nullptr, partial);
}

__global__ void __launch_bounds__(kThreads, kBlocksPdf)
hit_bwd_kernel(const float* __restrict__ d, const float* __restrict__ g,
               const float* __restrict__ g_pdf, int n, tsk::Tables T,
               float* __restrict__ dd, float* __restrict__ partial) {
  adjoint_pass<false, true>(d, g, g_pdf, n, T, dd, partial);
}

__global__ void __launch_bounds__(kThreads, kBlocksPdf)
nee_pdf_bwd_kernel(const float* __restrict__ u, const float* __restrict__ g,
                   const float* __restrict__ g_pdf, int n, tsk::Tables T,
                   float* __restrict__ partial) {
  adjoint_pass<true, true>(u, g, g_pdf, n, T, nullptr, partial);
}

// The grid of kernel k (5-8) over n lanes (tsk::staged_blocks).
int rgb_rows(int k, int n) {
  return k == 5   ? tsk::staged_blocks<kThreads>(eval_bwd_kernel, n)
         : k == 6 ? tsk::staged_blocks<kThreads>(nee_bwd_kernel, n)
         : k == 7 ? tsk::staged_blocks<kThreads>(hit_bwd_kernel, n)
                  : tsk::staged_blocks<kThreads>(nee_pdf_bwd_kernel, n);
}

}  // namespace

extern "C" {

// Rows of the block-partial scratch a launch of K12/K13 over n lanes needs
// (the wrapper allocates rows x the kernel's row width of floats).
int tsk_adjoint_rows(int n) { return adjoint_rows(n); }

// The same for K5-K8 (k = 5, 6, 7, 8): their grid's size.
int tsk_adjoint_rgb_rows(int n, int k) { return rgb_rows(k, n); }

// K5: d (n, 3), g (n, 3) -> dd (n, 3), out (3286,) = [sun | skyp | skyr |
// misc] cotangents; partial: tsk_adjoint_rgb_rows(n, 5) x 3286 floats of
// scratch.
int tsk_sunsky_eval_rgb_bwd(const float* d, const float* g, int n,
                            const float* skyp, const float* skyr,
                            const float* sun, const float* misc, float* dd,
                            float* partial, float* out, void* stream) {
  int rows = rgb_rows(5, n);
  cudaStream_t s = (cudaStream_t)stream;
  eval_bwd_kernel<<<rows, kThreads, 0, s>>>(
      d, g, n, tsk::Tables{skyp, skyr, sun, misc, nullptr}, dd, partial);
  return finish(partial, rows, kRow, out, s);
}

// K6: u (n, 2), g (n, 3) -> out (3286,), as K5 without a per-lane output.
int tsk_sunsky_nee_rgb_bwd(const float* u, const float* g, int n,
                           const float* skyp, const float* skyr,
                           const float* sun, const float* misc,
                           const float* gauss, float* partial, float* out,
                           void* stream) {
  int rows = rgb_rows(6, n);
  cudaStream_t s = (cudaStream_t)stream;
  nee_bwd_kernel<<<rows, kThreads, 0, s>>>(
      u, g, n, tsk::Tables{skyp, skyr, sun, misc, gauss}, partial);
  return finish(partial, rows, kRow, out, s);
}

// K7: d (n, 3), g (n, 3), g_pdf (n,) -> dd (n, 3), out (3566,) = [sun |
// skyp | skyr | misc | gauss (14, 20)]; partial: rows x 3566 floats.
int tsk_sunsky_hit_rgb_bwd(const float* d, const float* g,
                           const float* g_pdf, int n, const float* skyp,
                           const float* skyr, const float* sun,
                           const float* misc, const float* gauss, float* dd,
                           float* partial, float* out, void* stream) {
  int rows = rgb_rows(7, n);
  cudaStream_t s = (cudaStream_t)stream;
  hit_bwd_kernel<<<rows, kThreads, 0, s>>>(
      d, g, g_pdf, n, tsk::Tables{skyp, skyr, sun, misc, gauss}, dd,
      partial);
  return finish(partial, rows, kRowPdf, out, s);
}

// K8: u (n, 2), g (n, 3), g_pdf (n,) -> out (3566,), as K7 without a
// per-lane output.
int tsk_sunsky_nee_rgb_pdf_bwd(const float* u, const float* g,
                               const float* g_pdf, int n, const float* skyp,
                               const float* skyr, const float* sun,
                               const float* misc, const float* gauss,
                               float* partial, float* out, void* stream) {
  int rows = rgb_rows(8, n);
  cudaStream_t s = (cudaStream_t)stream;
  nee_pdf_bwd_kernel<<<rows, kThreads, 0, s>>>(
      u, g, g_pdf, n, tsk::Tables{skyp, skyr, sun, misc, gauss}, partial);
  return finish(partial, rows, kRowPdf, out, s);
}

}  // extern "C"
