"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. device: require CUDA; print the card's name and power limit;
2. build: compile the kernels from tpusky_torch/csrc with nvcc; print
   each kernel's registers and spills (ptxas) and require no spills in
   K1-K3's three kernels, K4's, K5-K8's four, K9-K11's six
   instantiations (W = 4 and runtime W) and K12's and K13's four;
3. K1-K3 against their plain PyTorch versions at 2,097,152 lanes, then
   the RGB lane classes: K2 with every direction in the sun's disc (1% of
   them moved to the disc's edge, the pdf's cone-edge flips counted and
   capped), K3 with every lane a TGMM sky sample and with every lane a
   sun-cone sample, each timed in phase 10; and the
   adjoints K5 and K6 against autograd of the same plain versions: table
   cotangents, K5's per-lane direction cotangent, and the cotangents
   pulled back through precompute to (turbidity, albedo, sun direction);
   then K5 with every direction in the sun's disc (K2's lanes above), held
   the same way and timed in phase 10;
4. the forward main path: precompute the headline sunsky, evaluate the sky
   dome (K1), render the headline scene (512x512, 8 spp, depth 2) through
   `render` (K4), and render it again through the wavefront `render_rows`
   (K2, K3); every kernel's launch count must rise, the image must be
   finite and non-zero, and K4 must agree with the plain wavefront path
   lane by lane and per image, on the card and against the CPU on a small
   frame; the camera, shape and material rows and the state's misc row
   and gaussian table that K4 builds in its staging must equal their
   plain versions (`megakernel.scene_rows`, `sunsky_kernel._misc_row` and
   `_gauss_rows`), and the headline `render()` must make no host-device
   synchronisation (run once under
   `torch.cuda.set_sync_debug_mode("warn")`, every sync site named) and
   must launch K4 alone;
   then a scene of 80 shapes,
   more than K4 keeps in shared memory, under a rotated environment,
   through `render` (K4): its rows and its lanes held the same way, its
   image against the plain path's own spread (its lanes when the shapes
   move by 2.4e-7, which flips as many silhouette lanes as K4's rounding);
5. the gradient main path: `bench.py::bench_grad`'s loss (512x512, 4 spp,
   mean(img^2), gradients to turbidity, albedo and sun direction through
   precompute) through `render_rows` (K2, K3 forward; K5, K6 backward) and
   through `render` (K4 forward, the wavefront replayed backward), then
   five training steps of `make_train_step_single` (512x512, 8 spp,
   log_l2_blur, Adam); K2-K6 must launch, the two gradients must agree,
   and the steps must lower the loss and raise turbidity toward the
   target's; the step's loss on a scene built from leaves that require
   grad must make no host-device synchronisation. The kernel path's gradient is then held against the plain
   path's on the card;
6. the spectral main path: K9-K11 against their plain versions at
   2,097,152 lanes with 4 hero wavelengths from `sample_rgb_spectrum` (the
   W = 4 kernels), at 10 wavelengths and at 4 unaligned ones (the
   runtime-W kernels), K10 with every direction in the sun's disc and K11
   with every lane a TGMM sky sample and with every lane a sun-cone
   sample, each timed, then `bench.py::bench_spectral`'s frame (512x512,
   8 spp, depth 4, a rough-conductor ground) through
   `render(mode="spectral")` (K10, K11) after a spectral sky dome (K9);
   every spectral kernel's launch count must rise, the frame must agree
   with the plain path on the card lane by lane and per image, and a crop
   of it with the CPU's plain render;
   then the spectral adjoints without the pdf, K12 (at 4 and at 10
   wavelengths a lane) and K13, against autograd of their plain versions:
   table cotangents (the limb-darkening table's too), per-lane direction
   and wavelength cotangents, cotangents through precompute; then K13
   with every lane a TGMM sky sample and with every lane a sun-cone
   sample, and K12 with every direction in the sun's disc, each held the
   same way and timed;
7. path 1, the spectral gradient: `bench.py::bench_spectral_grad`'s loss
   (512x512, 4 spp, depth 2, a diffuse ground, gradients to turbidity,
   albedo and sun direction through the spectral precompute) through
   `render_rows` and `render` (K10, K11 forward; K12, K13 backward) and a
   spectral sky dome's (K9 forward, K12 backward); the kernels must
   launch, the two gradients agree, and both the plain path's on the card;
8. path 2, the emitter API's attached pdf: `eval_pdf` and `sample_eval`
   with the pdf attached and a cotangent on it, at 2,097,152 lanes, in RGB
   (K2 then K7, K3 then K8) and spectral mode (K10 then K12, K11 then K13,
   both with the pdf), against autograd of the plain versions, the
   gaussian table's cotangent included; then K8 with every lane a TGMM
   sky sample and with every lane a sun-cone sample, held the same way,
   and K7 with every direction in the disc, each timed;
9. meshes: K14 against its plain version on icosphere meshes of 5,120 to
   327,680 triangles, on bench_mesh's coherent and incoherent wavefronts
   of 1,048,576 rays, direct and after the wavefront sort (hits, t, b1,
   b2, triangle ids and mesh_test), with its times, bound and the tiles
   and leaves it tests per ray and per warp; two duplicated-tile tie
   cases, where K14 must equal the plain version on every ray and take
   the lower index; then `tools/gen_scene_goldens.py::scene_mesh_gi` at
   81,920 triangles through `render` (512x512, 8 spp, depth 3; K14 ten
   times, K2 and K3, not K4; K14's tables built once), a band of rows
   against the plain path on the card, a crop against the CPU's plain
   render, and the frame's time;
10. times of each kernel and its plain version (CUDA events; for the
   adjoints, autograd's backward over a graph built once), K4 by lane
   class (the headline frame, and every lane a miss, which the plain
   intersection confirms), the fwd+bwd
   rates of bench_grad and bench_spectral_grad, a training step's time
   and peak memory, the spectral frame's time and rays per second;
11. the reference's sky goldens through `sunsky_params(hour=...)` (the
   port's float64 astronomy, equal on the card and the CPU) and K1, mean
   relative error <= 0.017, and the spectral ones through K9, <= 0.037;
12. chi-square at the reference's scale (`tools/chi2_tpu.py`'s six
   configurations, N = 1e8 over 430 x 215 cells, the pdf integrated at
   64 x 64 points a cell): directions from K3, the pdf through K2, and
   one configuration through the plain sampler; each p >= 0.01;
13. the port's 48x48, 64-spp renders of ten scene goldens Z-tested
   against tests/golden/scene_goldens.npz (`tools/torch_scene_goldens.
   py`): sunsky_sphere and sky_only through K4, rough_conductor (depth
   4, K2/K3), spectral_plane (K10/K11), mesh_gi (K14), and
   constant_cube_gi (a cube under a ConstantEnv, depth 4), area_light
   and dielectric_sphere (area emitters, a smooth dielectric, depth 6)
   envmap_lit (a 16x32 bitmap sky) and medium_sphere (a homogeneous
   Henyey-Greenstein medium, depth 6), whose wavefront is plain ops on
   the card and launches no kernel;
   render_moments' mean equal to render_rows' image bitwise;
14. inverse rendering: bench_train's evaluation loss through K4 against
   render_rows on three grid candidates (1e-4), then the recovery recipe
   of seed 0 at full size (512x512x8, 320 iterations, the full grid; K4
   counted over its evaluations, K5/K6 over its steps), gated at the
   TPU's r5 accuracy (turbidity 0.2, sun 0.52 degrees), and the
   gradient-only sun recovery (256x256x8, from 5 degrees off), gated at
   2 degrees;
15. the path tracer's breadth at full width: a 512x512x8 frame at depth
   6 with Russian roulette from depth 3 under the headline sunsky (K2,
   K3), of a dielectric sphere, a diffuse cube, a rough-conductor
   cylinder and a rectangle area panel on the ground, lit by a point, a
   directional and a spot light (one sampled a vertex), through
   `render`; K2 and K3 must launch and K4 not, its lanes agree with the
   plain path's on the card (>= 99.9% within 1e-3), the share of lanes
   whose Russian-roulette decision differs printed; `render()`'s wall
   time (in turns with the plain path's) and the device's busy share
   over a profiler window;
16. the bitmap environment at full width: `make_envmap` of a 1024x2048
   sky (a gradient and a bright disc about 3 degrees wide) on the card,
   timed; envmap_lit's sphere and ground under it through `render`
   (512x512x8, depth 2; plain ops, no kernel launches, K4 refused); a
   32x32 crop's lanes against the CPU's (>= 99.9% within 1e-3);
   `EmitterAdapter`'s chi-square over the map at N = 1e8, binned on the
   card (p >= 0.01); the frame's wall time in turns, its launches and
   busy share;
17. the material breadth at full width: a 512x512x8 frame at depth 6
   with Russian roulette from depth 3 under the headline sunsky (K2, K3)
   of a rough-dielectric sphere, a plastic cube behind a mask of opacity
   0.5, a rough-plastic cylinder, a principled sphere inside a null
   sphere, a principledthin disk and a blend rectangle, through
   `render`; K2 and K3 must launch and K4 not, its lanes agree with the
   plain path's (>= 99.9% within 1e-3), the share of lanes whose
   Russian-roulette decision differs printed, its wall time in turns
   with the plain path's and busy share; then `BSDFAdapter`'s chi-square
   of kinds 4 (the base), 5, 8, 9, 10 and 15 and `chi2_test_2d` of
   Marginal2D, Hierarchical2D and Bilinear2D at N = 1e7 on the card, each
   p >= 0.01;
18. the spectral film frame at full width: bench_spectral's scene
   (512x512x8, depth 4) plus an RGB area panel and point light
   (upsampled by rgb2spec, fitted once a render), seen by a thin lens
   through a 4-channel SRF specfilm with the mitchell filter and the
   multijitter sampler, through `render`; K10 and K11 must launch and K4
   not, its lanes agree with the plain path's (>= 99.9% within 1e-3),
   two renders be bitwise equal and `render()` make no synchronisation;
   its wall time in turns with the plain path's, launches, busy share,
   the fit's launches and the splat's time; then every sampler kind on
   2,097,152 lanes bitwise on the card and the CPU, every filter's splat
   within 1e-5 of a float64 CPU splat and bitwise between two calls,
   each sensor kind (a filter each) at 64x64x4, depth 2, against the CPU
   (>= 99.9% of pixels within 1e-3), the fwd+bwd of a 128x128x4 frame to
   the turbidity and the area radiance (K10-K13) against the plain path
   (1e-3), and a spectral envmap of 64x128 texels against the CPU;
19. textures and mesh attributes at full width: scene_mesh_gi's
   geometry (81,920 triangles, 512x512x8, depth 3, the headline sunsky)
   with a 2048x2048 bitmap on the uv-mapped icosphere, a checkerboard and
   a 512x512 normal map on a rough-plastic ground, a 64^3 volume texture
   on a principled sphere and vertex colours through a mesh attribute on
   a second mesh, through `render` in RGB (K2, K3, K14) and in spectral
   mode (K10, K11, K14; every texel fitted on the card, held against the
   host fit): K4 refused, two renders bitwise equal, no synchronisation,
   every lane within 1e-3 of the plain path with K14's hits on >= 99.9%
   and a band of rows of the fully plain path too, a crop against the
   CPU (RGB), the wall time in turns, launches and busy share; then the
   fwd+bwd at 256x256x4 to the atlas, the checker colours and the
   turbidity (K5, K6) against the plain path, and `render_aovs` at
   512x512 through K14 against the plain mesh intersection;
20. participating media at full width: the headline scene in two
   regions of fog, a homogeneous Henyey-Greenstein sphere about the
   sphere and a cube of ground fog holding a 64^3 density grid (64 march
   steps, Rayleigh, spectral-MIS free flight), 512x512x8, depth 6,
   Russian roulette from depth 3, through `render` in RGB (K2, K3) and in
   spectral mode with one-channel regions (K10, K11): K4 refused, two
   renders bitwise equal, no synchronisation, >= 99.9% of the lanes
   within 1e-3 of the plain path on the card and of a band of rows of
   the CPU's, the wall time in turns, launches, peak memory, busy share
   and the gathers' share of the device time; then the fwd+bwd at
   256x256x4, depth 4, to the grid, the sphere region's sigma_t and the
   turbidity (K5, K6) against the plain path (1e-3 of scale), with its
   time and peak memory;
21. the light-traced frame: `render_ptracer` of scene_mesh_gi's geometry
   (81,920 triangles) under the headline sunsky with an area panel and a
   spot light, 512x512 from 4,194,304 particles, depth 4, in RGB (K1,
   K14) and spectral mode (K9, K14): two calls bitwise equal, >= 99.9% of
   the pixels within 1e-3 of the plain path with K14's hits, the mean
   over lit pixels within 3% of `render`'s (512x512x8, depth 4), the
   wall time in turns, launches and busy share;
22. polarized transport at full width: `render_stokes` of the Stokes
   frame (the headline camera and sunsky, the sphere as a rough gold
   conductor on a pplastic ground, phase 9's 81,920-triangle icosphere
   as a smooth dielectric, a linear polarizer, a quarter-wave retarder
   and a circular polarizer in front of the camera, an RGB area panel
   and a point light; 512x512x8, depth 4) in RGB (K2, K3, K14) and
   spectral mode (K10, K11, K14): K4 not launched, two calls bitwise
   equal, no synchronisation, >= 99.9% of the lanes within 1e-3 of the
   plain path with K14's hits, of a band of the fully plain path's rows
   and of a row's first samples on the CPU, the degree of polarization
   at most 1 + 1e-4 where S0 > 1e-3 and above 0.1 somewhere, the wall
   time in turns, launches, peak memory and busy share; its depolarizing
   variant's S0 against `render`'s lanes (>= 99.9% within 1e-3) with
   S1..S3 exactly 0, in both modes; and the radiance-meter filter stacks
   (Malus's law, a polarizer's degree of polarization, the quarter-wave
   chain, crossed circular polarizers) against their closed forms at
   1e-4;
23. SDF grids, curves with hair and measured BRDFs at full width: the
   headline sunsky, camera and size (512x512x8, depth 4, Russian
   roulette from depth 3) over a diffuse ground, a 64^3 SDF torus shaded
   by the RGL measured BRDF (synthetic RGL-layout tables from a seed,
   spectral in spectral mode) and a tuft of 64 B-spline strands (1,536
   rounded cones) shaded by the hair BCSDF with a direct sigma_a,
   through `render` in RGB (K2, K3) and spectral mode (K10, K11): K4
   refused, two renders bitwise equal, no synchronisation, >= 99.9% of
   the lanes within 1e-3 of the plain path, render()'s time, launches,
   peak memory, the busy share of a band of rows and each intersection's
   device ms a 2^20-ray wavefront; an SDF sphere frame against the
   analytic sphere's (mean relative error below 0.05); hair's and the
   measured BRDF's sampling through the chi-square test at N = 1e7; the
   fwd+bwd at 256x256x4, depth 3, to the grid values and the turbidity
   (K5, K6) against the plain path (1e-3 of scale) with its peak memory;
   and `render_stokes` of the headline sphere as a measured pBRDF (kind
   18) at 512x512x8, depth 4: bitwise repeats, a band of rows' lanes
   within 1e-3 of the plain path, the degree of polarization at most 1;
24. one JSON line of kernel results (each kernel's launches summed over
   the main paths, the fog, light-traced, Stokes and geometry frames'
   included), then the device line, last.

It prints no result and exits non-zero without a CUDA device or outside
a checkout of the repository.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

N_LANES = 1 << 21           # bench.py's 2M-lane sunsky eval
H = W = 512                 # bench.py::bench_path
SPP = 8
GRAD_SPP = 4                # bench.py::bench_grad
MAX_DEPTH = 2
SEED = 1
SUN = [0.3, 0.2, 0.93]
TRAIN_STEPS = 5
SPEC_DEPTH = 4              # bench.py::bench_spectral
N_HERO = 4                  # hero wavelengths per path
CROP = (224, 160, 32, 32)   # x0, y0, width, height of the CPU-checked crop
# phase 9: icosphere meshes of 20 * 4^n triangles, the last one 327,680;
# the frame's is 81,920 (tools/bench_mesh.py:114)
MESH_SUBDIV = (4, 5, 6, 7)
FRAME_SUBDIV = 6
MESH_RAYS = 1 << 20         # bench_mesh's wavefronts
MESH_SUBSET = 1 << 16       # rays a wavefront the plain version runs on
MESH_SUPER = 16             # tiles a supertile
MESH_DEPTH = 3              # scene_mesh_gi's
MESH_BAND = (240, 32)       # first row and rows of the band held to plain
MESH_CROP = (352, 240, 32, 32)    # across the sphere's right limb
MESH_CROP_SPP = 2
# the duplicated-tile tie cases: icosphere(TIE_SUBDIV)'s tiles, then a copy
# of them in a random order, on bench_mesh's wavefronts; and a ground quad
# whose copy lies in a supertile that rays from above enter first
TIE_SUBDIV = 4
# The previous kernels' times (PERF.md's kernel table before K14 and K6,
# then K12 and K13, were redesigned, and K1-K3's and K5-K8's from
# chip_smoke.py on the tree before they were; NVIDIA H100 80GB HBM3,
# 700.00 W), printed beside this run's: every kernel's row (ms), K12 and
# K13 with the pdf, K14 by mesh and wavefront (triangles, wavefront) ->
# (direct, sorted) ms, K6, K12 and K13 by lane mix (K12 and K13's from
# tools/torch_ab.py spec_bwd on the same card)
PREV_MS = {"K1": 0.0478, "K2": 0.1242, "K3": 0.1833, "K4": 0.2905,
          "K5": 0.3570, "K6": 0.6136, "K7": 1.8245, "K8": 2.4844,
          "K9": 0.0931, "K10": 0.1592, "K11": 0.2388, "K12": 1.1880,
          "K13": 2.1624, "K14": 18.8273}
PREV_PDF_MS = {"K12": 1.3753, "K13": 2.0089}
PREV_K14_MS = {(5120, "coherent"): (1.478, 1.635),
              (5120, "incoherent"): (12.308, 3.704),
              (20480, "coherent"): (1.808, 1.965),
              (20480, "incoherent"): (25.079, 8.859),
              (81920, "coherent"): (2.390, 2.695),
              (81920, "incoherent"): (37.586, 18.827),
              (327680, "coherent"): (3.635, 4.048),
              (327680, "incoherent"): (50.649, 33.359)}
PREV_K6_STRATEGY_MS = {"sky": 0.3954, "sun": 0.5996}
PREV_SPEC_MIX_MS = {"K13 sky": 1.3557, "K13 sun": 2.3884, "K12 disc": 2.4716}
# K10 with every direction in the disc, K11 with every lane a sky sample
# and every lane a sun-cone sample, before K9-K11 were redesigned
# (tools/torch_ab.py spec_fwd on the parent checkout, the same card)
PREV_SPEC_FWD_MIX_MS = {"K10 disc": 0.1995, "K11 sky": 0.2076,
                        "K11 sun": 0.2089}
# K2 with every direction in the disc, K3 with every lane a sky sample and
# every lane a sun-cone sample, before K1-K3 were redesigned
# (tools/torch_ab.py rgb_fwd on the parent checkout, the same card)
PREV_RGB_MIX_MS = {"K2 disc": 0.1402, "K3 sky": 0.1542, "K3 sun": 0.1526}
# K4 with every lane a miss (the camera turned to the sky), before K4 was
# redesigned (tools/torch_ab.py k4 on the parent checkout, the same card)
PREV_K4_MIX_MS = {"all miss": 0.0900}
# K5 and K7 with every direction in the disc, K8 with every lane a sky
# sample and every lane a sun-cone sample, before K5-K8 were redesigned
# (tools/torch_ab.py rgb_bwd on the parent checkout, the same card)
PREV_RGB_BWD_MIX_MS = {"K5 disc": 0.6305, "K7 disc": 2.1786,
                       "K8 sky": 2.4295, "K8 sun": 2.1726}
# the allowed share of lanes outside a per-lane bar of phase 3
LANE_CAP = 1e-5
# the share of lanes whose direction cotangent may miss its bar: a lane
# one ulp from the disc surrogate's ramp clamp flips between a derivative
# of 2 / (1 - cos_cut) and 0
DD_CAP = 1e-4
# K6 against the plain sampler: the band around the disc weight's ramp
# clamps whose lanes are left out of the misc row's bar (4.5 float32 ulps
# of cos(gamma)), and their allowed share (the sun-cone samples within it
# are ~5% of the cone's, ~3% of the lanes at the headline sky weight)
RAMP_BAND = 0.05
RAMP_CAP = 3e-2
# K8/K13 against the plain sampler: lanes whose directions differ within
# this sin(theta) of the zenith are left out of the bars (see
# _zenith_lanes), at most this share of the lanes (~2e-4 expected)
ZENITH_BAND = 1e-2
ZENITH_CAP = 1e-3
# K10 with every direction in the sun's disc (the sun-cone samples'): the
# pdf's bar leaves out directions whose cosine to the sun lies within this
# of the cone's cosine (4 float32 ulps below 1), where the kernel's and
# the plain version's cone tests may differ (see _cone_edge): 2% of a
# uniform cone's samples, of which ~1 in 76 flips (one H100 run)
CONE_BAND = 2.4e-7
# the share of all lanes whose pdf may flip within that band (K10's
# all-disc check: 552 of 2,097,152 lanes, one H100 run)
CONE_CAP = 1e-3

# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, FP32 operations/s
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# FP32 operations per lane, counted from the CUDA sources with +, -, *
# at 1, a division or sqrtf at 4, expf 8, sinf/cosf/cbrtf/erff 12,
# asinf/acosf 14, atan2f/erfinvf 20, and compares, selects and integer
# work at 0 (tsk:: functions of tpusky_torch/csrc/sunsky_core.cuh). Work
# whose result is zero on a lane (the sun polynomial off the disc, its
# partials and the ramp's chain off the ramp) is counted only where it is
# needed; the sun segment's set-up is counted on every above-horizon lane.
OPS = {
    "radiance": 305,      # radiance(), an above-horizon lane
    "radiance_sun": 216,  # + its sun polynomial, a lane inside the disc
    "pdf": 554,           # mixture_pdf(), an active lane (20 gaussians)
    "sample_sky": 170,    # nee_sample(), TGMM branch
    "sample_sun": 75,     # nee_sample(), cone branch
    "vjp": 566,           # radiance_vjp(), an above-horizon lane: forward,
                          # the sky formula's reverse, gamma's and d's
    "vjp_sun_value": 225,  # + the sun polynomial's value and the disc
                           # weight's cotangent, a lane in the disc or ramp
    "vjp_disc": 747,      # + the polynomial's partials, the sun row's 72
                          # atomics, the limb and elevation chains, a lane
                          # in the disc
    "vjp_ramp": 24,       # + the ramp's chain to cos_cut and softness
    "path": 830,          # K4's own work per camera hit besides the sunsky
                          # cores: ray generation, 3 x 3 shape tests, BSDF
                          # eval and sample, frames, MIS
    "miss": 250,          # K4's own work for a camera ray that misses
    # radiance_spec() (K9-K11): the shared geometry of an above-horizon
    # lane (sky_geometry), then per wavelength inside [320, 720] nm its
    # two channels' sky formulas and the lerp, + their sun polynomials,
    # limb darkening and lerps in the disc; a wavelength outside costs
    # its channel coordinate
    "spec_geometry": 135,
    "spec_wavelength": 118,
    "spec_wavelength_sun": 49,
    "spec_outside": 5,
    # radiance_spec_vjp() (K12, K13): the geometry's forward and reverse
    # (vjp_geometry, geometry_vjp) of an above-horizon lane, + the limb
    # chain in the disc (the ramp's chain is "vjp_ramp"); per wavelength
    # inside [320, 720] nm with a cotangent, two sky channels' formula and
    # reverse (sky_channel_vjp) and the lerps; + the two channels' sun and
    # limb values in the disc or on its ramp; + their reverse in the disc
    "spec_vjp": 220,
    "spec_vjp_disc": 30,
    "spec_vjp_wavelength": 285,
    "spec_vjp_sun_value": 85,
    "spec_vjp_sun": 65,
    # the mixture pdf's reverse (pdf_lane, 20 x gauss_term_vjp with the
    # table cotangent's sum, pdf_vjp_tail), a lane with a pdf cotangent
    # above the horizon; the sample placement's reverse (nee_sample_vjp
    # beyond the redrawn sample), by strategy
    "pdf_vjp": 1410,
    "sample_sky_vjp": 55,
    "sample_sun_vjp": 50,
    # K14 (csrc/mesh_kernel.cu): a ray's set-up (3 reciprocals), one box's
    # slab test (6 subtractions, 6 products; min/max are compares), one
    # triangle's Moller-Trumbore (mt_hit: the cross products, 3 dot
    # products, the reciprocal, t's vector, 3 scalings and u + v), and its
    # parts up to the determinant and up to b1, where a triangle stops
    "ray_setup": 12,
    "slab": 12,
    "mt": 49,
    "mt_det": 14,
    "mt_u": 27,
}
TABLE_BYTES = 4 * (27 + 3 + 45 * 72 + 16)
SPEC_TABLE_BYTES = 4 * (11 * 9 + 11 + 45 * 44 + 11 * 6 + 16)
GAUSS_BYTES = 4 * 14 * 20
ROW_BYTES = 4 * (45 * 72 + 46)      # the adjoints' cotangent row
ROW_PDF_BYTES = ROW_BYTES + GAUSS_BYTES    # K7, K8's
SPEC_ROW_BYTES = 4 * (45 * 44 + 99 + 11 + 66 + 16) + GAUSS_BYTES  # K12, K13

# key -> (launch counter and kernel name, source, the TPU kernel it
# replaces)
_SUNSKY = "tpusky/ops/pallas/sunsky_kernel.py"
KERNELS = {
    "K1": ("sunsky_eval_rgb", "tpusky_torch/csrc/sunsky_kernels.cu",
           f"{_SUNSKY}:747"),
    "K2": ("sunsky_hit_rgb", "tpusky_torch/csrc/sunsky_kernels.cu",
           f"{_SUNSKY}:771"),
    "K3": ("sunsky_nee_rgb", "tpusky_torch/csrc/sunsky_kernels.cu",
           f"{_SUNSKY}:793"),
    "K4": ("direct_rgb_megakernel", "tpusky_torch/csrc/megakernel.cu",
           "tpusky/ops/pallas/megakernel.py:428"),
    "K5": ("sunsky_eval_rgb_bwd", "tpusky_torch/csrc/sunsky_adjoint.cu",
           f"{_SUNSKY}:1032"),
    "K6": ("sunsky_nee_rgb_bwd", "tpusky_torch/csrc/sunsky_adjoint.cu",
           f"{_SUNSKY}:1133"),
    "K7": ("sunsky_hit_rgb_bwd", "tpusky_torch/csrc/sunsky_adjoint.cu",
           f"{_SUNSKY}:1002"),
    "K8": ("sunsky_nee_rgb_pdf_bwd", "tpusky_torch/csrc/sunsky_adjoint.cu",
           f"{_SUNSKY}:1064"),
    "K9": ("sunsky_eval_spec", "tpusky_torch/csrc/sunsky_spectral.cu",
           f"{_SUNSKY}:671"),
    "K10": ("sunsky_hit_spec", "tpusky_torch/csrc/sunsky_spectral.cu",
            f"{_SUNSKY}:695"),
    "K11": ("sunsky_nee_spec", "tpusky_torch/csrc/sunsky_spectral.cu",
            f"{_SUNSKY}:721"),
    "K12": ("sunsky_hit_spec_bwd",
            "tpusky_torch/csrc/sunsky_spectral_adjoint.cu", f"{_SUNSKY}:1284"),
    "K13": ("sunsky_nee_spec_bwd",
            "tpusky_torch/csrc/sunsky_spectral_adjoint.cu", f"{_SUNSKY}:1325"),
    "K14": ("mesh_intersect", "tpusky_torch/csrc/mesh_kernel.cu",
            "tpusky/ops/pallas/mesh_kernel.py:260"),
}


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def _rel(a, b, floor):
    return (a - b).abs() / (b.abs() + floor)


def _scale_err(a, b):
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _count_outside(name, err, bar, n, cap=LANE_CAP):
    bad = int((err > bar).sum())
    limit = int(cap * n)
    print(f"check {name}: {bad} of {n} lanes outside {bar:g} (cap {limit}), "
          f"max {float(err.max()):.3e}")
    if bad > limit:
        raise AssertionError(f"{name}: {bad} lanes outside {bar:g}")
    return bad


def _check_scale(name, a, b, bar):
    """Hold a against b within bar of b's scale; bar None only prints."""
    err = _scale_err(a, b)
    if bar is None:
        print(f"read {name}: {err:.3e} of its scale (no bar)")
        return
    print(f"check {name}: {err:.3e} of its scale (bar {bar:g})")
    if not err <= bar:
        raise AssertionError(f"{name}: {err:.3e} > {bar:g}")


def _time_ms(fn, reps=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _pair_ms(kernel, plain, reps=10):
    """(kernel ms, plain ms), measured in turns plain, kernel, kernel, plain
    and averaged."""
    p1 = _time_ms(plain, reps)
    k1 = _time_ms(kernel, reps)
    k2 = _time_ms(kernel, reps)
    p2 = _time_ms(plain, reps)
    return 0.5 * (k1 + k2), 0.5 * (p1 + p2)


def _bound(nbytes, ops):
    """(bound ms, what bounds it) at the card's published peaks."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_OPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _vjp_ops(d, state):
    """radiance_vjp's operations over the directions d (N, 3), counted per
    lane class (OPS): above the horizon, in the disc, on the disc weight's
    ramp, in either."""
    above, disc, ramp = _lane_classes(d, state)
    o = OPS
    return (float(above.sum()) * o["vjp"]
            + float((disc | ramp).sum()) * o["vjp_sun_value"]
            + float(disc.sum()) * o["vjp_disc"]
            + float(ramp.sum()) * o["vjp_ramp"])


def _spec_ops(d, wl, state):
    """radiance_spec's operations over directions d (N, 3) at wavelengths
    wl (N, W), counted per lane and wavelength class (OPS)."""
    cos_cut = math.cos(float(state.params.sun_half_aperture))
    above = d[:, 2] >= 0
    disc = above & ((d * state.sun_frame_n).sum(-1) >= cos_cut)
    valid = (wl >= 320.0) & (wl <= 720.0)
    o = OPS
    return (float(above.sum()) * o["spec_geometry"]
            + float((valid & above[:, None]).sum()) * o["spec_wavelength"]
            + float((valid & disc[:, None]).sum()) * o["spec_wavelength_sun"]
            + float((~valid & above[:, None]).sum()) * o["spec_outside"])


def _lane_classes(d, state):
    """(above the horizon, in the disc, on the disc weight's ramp) masks of
    directions d (N, 3)."""
    p = state.params
    cos_cut = math.cos(float(p.sun_half_aperture))
    half = 0.25 * (1.0 - cos_cut) * float(p.disc_softness)
    cos_g = (d * state.sun_frame_n).sum(-1)
    above = d[:, 2] >= 0
    return (above, above & (cos_g >= cos_cut),
            above & ((cos_g - cos_cut).abs() <= half))


def _spec_vjp_ops(d, wl, state):
    """radiance_spec_vjp's operations over directions d (N, 3) at
    wavelengths wl (N, W), every cotangent non-zero, counted per lane and
    wavelength class (OPS)."""
    above, disc, ramp = _lane_classes(d, state)
    valid = (wl >= 320.0) & (wl <= 720.0) & above[:, None]
    o = OPS
    return (float(above.sum()) * o["spec_vjp"]
            + float(disc.sum()) * o["spec_vjp_disc"]
            + float(ramp.sum()) * o["vjp_ramp"]
            + float(valid.sum()) * o["spec_vjp_wavelength"]
            + float((valid & (disc | ramp)[:, None]).sum())
            * o["spec_vjp_sun_value"]
            + float((valid & disc[:, None]).sum()) * o["spec_vjp_sun"])


def _spectral_leaf_state(dev):
    """(leaf parameters, spectral state) at the headline parameters, the
    state's limb-darkening table a leaf of its own (a constant of the
    dataset, so its cotangent is checked there)."""
    import tpusky_torch as tt
    lp = _leaf_params(dev, "spectral")
    st = tt.sunsky_precompute(lp, mode="spectral")
    return lp, st._replace(sun_ld=st.sun_ld.detach().clone().requires_grad_())


def _with_disc_edge(d, state, rng):
    """d with the 1% of lanes after the first eighth (which the spectral
    checks keep below the horizon) moved to the disc edge
    (tests/test_pallas.py:215)."""
    import torch
    n = d.shape[0]
    sun = state.sun_frame_n.detach().cpu().numpy()
    edge = sun + 0.002 * rng.normal(size=(n // 100, 3))
    out = d.clone()
    out[n // 8:n // 8 + n // 100] = torch.tensor(
        edge / np.linalg.norm(edge, axis=-1, keepdims=True),
        dtype=torch.float32, device=d.device)
    return out


def _spectral_scene(state, device):
    """bench.py::bench_spectral's scene: a 20x20 rough-conductor ground
    (GGX alpha 0.2, albedo 0.5, the default gold-like IOR) under the
    spectral sunsky, seen by a 45-degree camera at [4,-4,2] looking at
    [0,0,0.5]."""
    from tpusky_torch.render.bsdf import ROUGH_CONDUCTOR
    from tpusky_torch.render.scene import make_scene
    from tpusky_torch.render.sensors import make_perspective
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    scene = make_scene(
        shapes=[dict(kind=1, to_world=ground, bsdf_idx=0)],
        bsdf_albedos=[[0.5, 0.5, 0.5]], bsdf_kinds=[ROUGH_CONDUCTOR],
        bsdf_alphas=[0.2], env=state, device=device)
    sensor = make_perspective([4, -4, 2.0], [0, 0, 0.5], fov_x_deg=45,
                              device=device)
    return scene, sensor


def _headline_scene(state, device):
    """bench.py's headline scene: a diffuse sphere on a diffuse ground
    rectangle under the sunsky, seen by a 45-degree perspective camera."""
    from tpusky_torch.render.scene import make_scene
    from tpusky_torch.render.sensors import make_perspective
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    sphere = np.eye(4, dtype=np.float32)
    sphere[2, 3] = 1.0
    scene = make_scene(
        shapes=[dict(kind=1, to_world=ground, bsdf_idx=0),
                dict(kind=0, to_world=sphere, bsdf_idx=1)],
        bsdf_albedos=[[0.4, 0.4, 0.4], [0.6, 0.2, 0.2]], env=state,
        device=device)
    sensor = make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device=device)
    return scene, sensor


def _many_shapes_scene(state, device, n=80):
    """A scene of n shapes, more than K4 keeps in shared memory: the
    headline ground, then spheres, rectangles and disks of both materials
    in a grid on it, some two-sided, under a rotated environment."""
    from tpusky_torch.render.scene import make_scene
    shapes = [dict(kind=1, to_world=np.diag([10.0, 10.0, 1.0, 1.0]).astype(
        np.float32), bsdf_idx=0)]
    for i in range(n - 1):
        m = np.diag([0.25, 0.25, 0.25, 1.0]).astype(np.float32)
        m[:3, 3] = [-3.0 + 0.75 * (i % 9), -3.0 + 0.75 * (i // 9),
                    0.3 + 0.1 * (i % 3)]
        shapes.append(dict(kind=i % 3, to_world=m, bsdf_idx=1 + i % 2))
    ca, sa = math.cos(0.3), math.sin(0.3)
    return make_scene(
        shapes=shapes, bsdf_albedos=[[0.4, 0.4, 0.4], [0.6, 0.2, 0.2],
                                     [0.2, 0.5, 0.3]],
        bsdf_twosided=[False, False, True], env=state,
        env_to_world=[[ca, -sa, 0.0], [sa, ca, 0.0], [0.0, 0.0, 1.0]],
        device=device)


def _k4_work(scene, sensor, state):
    """K4's work on the headline-sized frame of `scene` seen by `sensor`,
    counted from the plain wavefront path's own intermediates
    (render/integrator.py::_path_sample at depth 2, the port's plain
    functions): camera rays that hit, the hits' NEE samples from the sky
    mixture, the NEE directions K4 looks up (lit, above the horizon,
    unshadowed; of them the sun-cone samples) and the escaped
    continuations."""
    import torch
    from tpusky_torch.ops.math import Frame, dot, norm
    from tpusky_torch.render import bsdf as B, emitters as em
    from tpusky_torch.render import integrator as I
    from tpusky_torch.render.scene import scene_occluded
    from tpusky_torch.render.sensors import sample_ray
    dev = scene.shapes.to_world.device
    lane = torch.arange(H * W * SPP, device=dev)
    pixel = lane // SPP
    smp = I._SamplerCtx("independent", SEED, pixel, lane % SPP, SPP)
    u_pos = smp.next(10_000, 2)
    uv = torch.stack([((pixel % W).float() + u_pos[:, 0]) / W,
                      ((pixel // W).float() + u_pos[:, 1]) / H], -1)
    o, d = sample_ray(sensor, uv)
    _, p, ng, mat_idx, hit = I._scene_intersect(scene, o, d, True)
    frame = Frame(ng)
    wi_z = frame.to_local(-d)[:, 2]
    flip = torch.where(scene.bsdfs.twosided[mat_idx] & (wi_z < 0.0), -1.0,
                       1.0)
    lit = hit & (wi_z * flip > 0.0)

    def offset(dirs):
        return p + torch.sign(dot(ng, dirs))[..., None] * ng * (
            I._SHADOW_EPS * norm(p, keepdim=True).clamp(min=1.0))
    u_nee = smp.next(0, 2)
    sky = u_nee[:, 0] < state.sky_sampling_w
    d_e = em.env_sample_eval(state, scene.env_to_world, u_nee, mode="rgb",
                             pdf_detached=True, plain=True)[0]
    above = (d_e @ scene.env_to_world)[:, 2] >= 0.0      # env-local z
    nee = (lit & (frame.to_local(d_e)[:, 2] * flip > 0.0) & above
           & ~scene_occluded(scene, offset(d_e), d_e, torch.inf, plain=True))
    u_b = smp.next(1, 3)
    wo, _, pdf_b, _ = B.sample(scene.bsdfs, mat_idx, frame.to_local(-d),
                               u_b[:, :2], u_b[:, 2],
                               kinds=B.table_kinds(scene.bsdfs))
    d_n = frame.to_world(wo)
    cont = (lit & (pdf_b > 0.0)
            & ~I._scene_intersect(scene, offset(d_n), d_n, True)[4])
    return {k: float(v.sum()) for k, v in (
        ("hits", hit), ("sky", hit & sky), ("nee", nee),
        ("nee_sun", nee & ~sky), ("cont", cont))}


def _no_sync(fn, what):
    """fn() under torch.cuda.set_sync_debug_mode("warn"), reset
    afterwards: fails naming the file:line of every host-device
    synchronisation in it (the mode's own notice that it is a prototype
    is not one)."""
    import warnings
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = sorted({f"{os.path.relpath(w.filename)}:{w.lineno}"
                    for w in caught if "synchroniz" in str(w.message)
                    and "prototype" not in str(w.message)})
    if sites:
        raise AssertionError(f"{what} synchronises the host with the "
                             f"device at {', '.join(sites)}")
    print(f"check {what} under set_sync_debug_mode('warn'): no "
          "synchronisation")
    return out


def grad_case(kind, scene, sensor, film, tables, dev):
    """bench.py::bench_grad on the headline scene: the loss mean(img^2) at
    GRAD_SPP and its gradient to (turbidity, albedo, sun direction)
    through precompute. kind "rows" runs the wavefront with the kernels,
    "plain" the wavefront with the plain versions, "render" K4 forward and
    the wavefront replayed backward. Returns (loss, gradients)."""
    import torch
    import tpusky_torch as tt
    from tpusky_torch.models.sunsky.model import precompute
    from tpusky_torch.render import integrator
    from tpusky_torch.render.film import develop
    t = torch.tensor(3.0, device=dev, requires_grad=True)
    alb = torch.full((3,), 0.3, device=dev, requires_grad=True)
    sd = torch.tensor(SUN, device=dev, requires_grad=True)
    p = tt.make_params(turbidity=t, albedo=alb,
                       sun_direction=sd / torch.sqrt((sd ** 2).sum()),
                       device=dev)
    sc = scene._replace(env=precompute(tables, p))
    if kind == "render":
        im = integrator.render(sc, sensor, film, SEED, spp=GRAD_SPP)
    else:
        im = develop(integrator.render_rows(
            sc, sensor, film, SEED, GRAD_SPP, MAX_DEPTH, 1000, "rgb", 0, H,
            plain=kind == "plain"))
    loss = (im ** 2).mean()
    return loss.detach().item(), torch.autograd.grad(loss, [t, alb, sd])


def train_case(scene, sensor, film, tables, dev):
    """bench.py::bench_train's step on the headline scene at SPP with
    log_l2_blur, its scene_builder_min (clip, normalise) and Adam at its
    starting rates (t 0.05, albedo 0.015, sun 0), from turbidity 3.0
    toward a target rendered at turbidity 6.5. Returns (step, optimizer,
    builder, start parameters, target image)."""
    import torch
    import tpusky_torch as tt
    from tpusky_torch.ad.optimizers import Adam
    from tpusky_torch.models.sunsky.model import precompute
    from tpusky_torch.parallel.render import make_train_step_single
    from tpusky_torch.render import integrator
    from tpusky_torch.render.film import develop

    def builder(pd):
        full = tt.make_params(
            turbidity=pd["t"].clamp(1.0, 10.0),
            albedo=pd["alb"].clamp(0.0, 1.0),
            sun_direction=pd["sun"] / torch.sqrt((pd["sun"] ** 2).sum()),
            device=dev)
        return scene._replace(env=precompute(tables, full))

    sun0 = torch.tensor(SUN, device=dev) / math.sqrt(sum(x * x for x in SUN))
    start = {"t": torch.tensor(3.0, device=dev),
             "alb": torch.full((3,), 0.3, device=dev), "sun": sun0}
    opt = Adam(0.05)
    opt.set_learning_rate(t=0.05, alb=0.015, sun=0.0)
    step = make_train_step_single(builder, sensor, film, SPP, opt,
                                  max_depth=MAX_DEPTH, loss="log_l2_blur")
    with torch.no_grad():
        target = develop(integrator.render_rows(
            builder({**start, "t": torch.tensor(6.5, device=dev)}), sensor,
            film, SEED, SPP, MAX_DEPTH, 1000, "rgb", 0, H))
    return step, opt, builder, start, target


def _leaf_params(dev, mode="rgb"):
    """The headline parameters, every field a leaf that requires grad."""
    import tpusky_torch as tt
    p = tt.make_params(turbidity=3.0, albedo=0.3, sun_direction=SUN,
                       mode=mode, device=dev)
    return p._replace(**{f: getattr(p, f).detach().clone().requires_grad_()
                         for f in p._fields})


def _grads(out, wrt, g):
    """autograd.grad with unused inputs' cotangents as zeros."""
    import torch
    got = torch.autograd.grad(out, wrt, g, retain_graph=True,
                              allow_unused=True)
    return [torch.zeros_like(w) if x is None else x
            for w, x in zip(wrt, got)]


def _adjoint_check(name, out_k, out_p, g, state, params, lanes_k=(),
                   lanes_p=(), misc_bar=1e-3, pdf=False, read=False):
    """Hold an adjoint kernel's cotangents against autograd of the plain
    version (out and g may be lists): the tables it writes (sky params,
    sky radiance, sun; the limb darkening of a spectral state, given as a
    leaf; with `pdf` the gaussians), the misc row pulled back to its state
    sources, each within 1e-3 of the table's largest plain cotangent (misc
    within `misc_bar`; where it is None, the misc row and each of its
    sources are only printed); (turbidity, albedo) within 1e-3 and the sun
    direction within 3e-2, relative; with `read`, every number is only
    printed. Returns (max abs error of the
    kernel's table cotangents, per-lane cotangents of kernel and plain)."""
    import torch
    tables = [("skyp", state.sky_params), ("skyr", state.sky_radiance),
              ("sun", state.sun_radiance)]
    if state.sun_ld is not None:
        tables.append(("ld", state.sun_ld))
    if pdf:
        tables.append(("gauss", state.gaussians))
    misc_names = ("sun_frame_n", "sun_half_aperture", "sky_scale",
                  "sun_scale", "disc_softness")
    misc = [state.sun_frame_n] + [getattr(params, f) for f in misc_names[1:]]
    if pdf:
        misc_names += ("sun_angles", "sky_sampling_w", "sun_frame_s",
                       "sun_frame_t")
        misc += [state.sun_angles, state.sky_sampling_w, state.sun_frame_s,
                 state.sun_frame_t]
    pars = [params.turbidity, params.albedo, params.sun_direction]
    wrt = [t for _, t in tables] + misc + pars
    gk = _grads(out_k, wrt + list(lanes_k), g)
    gp = _grads(out_p, wrt + list(lanes_p), g)
    bar = None if read else 1e-3
    if read:
        misc_bar = None
    for i, (t, _) in enumerate(tables):
        _check_scale(f"{name} d{t}", gk[i], gp[i], bar)
    nt = len(tables)
    flat = slice(nt, nt + len(misc))
    _check_scale(f"{name} dmisc (at its state sources)",
                 torch.cat([x.reshape(-1) for x in gk[flat]]),
                 torch.cat([x.reshape(-1) for x in gp[flat]]), misc_bar)
    if misc_bar is None:
        for f, a, b in zip(misc_names, gk[flat], gp[flat]):
            _check_scale(f"{name} d{f}", a, b, None)
    n_wrt = len(wrt)
    for i, (t, bar) in enumerate((("turbidity", 1e-3), ("albedo", 1e-3),
                                  ("sun_direction", 3e-2))):
        _check_scale(f"{name} d{t} through precompute",
                     gk[n_wrt - 3 + i], gp[n_wrt - 3 + i],
                     None if read else bar)
    err = max(float((a - b).abs().max()) for a, b in zip(gk[:nt], gp[:nt]))
    return err, gk[n_wrt:], gp[n_wrt:]


def _ramp_clamp_lanes(name, d_k, d_p, state):
    """Lanes whose kernel and plain sampler directions differ and whose
    disc weight's ramp lies within RAMP_BAND of a clamp, capped at
    RAMP_CAP of the lanes (see phase 3's K6 check)."""
    import torch
    with torch.no_grad():
        p = state.params
        cos_cut = math.cos(float(p.sun_half_aperture))
        eps = 0.5 * (1.0 - cos_cut) * float(p.disc_softness)
        cos_g = (d_p.double() * state.sun_frame_n.double()).sum(-1)
        ramp = (cos_g - cos_cut) / eps + 0.5
        at_clamp = (d_k != d_p).any(-1) & (
            (ramp.abs() < RAMP_BAND) | ((ramp - 1.0).abs() < RAMP_BAND))
    n, n_clamp = d_k.shape[0], int(at_clamp.sum())
    print(f"check {name} lanes left out (directions differ, ramp within "
          f"{RAMP_BAND:g} of a clamp): {n_clamp} of {n} "
          f"(cap {int(RAMP_CAP * n)})")
    if n_clamp > RAMP_CAP * n:
        raise AssertionError(f"{name}: {n_clamp} lanes at the ramp's clamps")
    return at_clamp


def _pdf_flips(name, pdf_k, pdf_p, n):
    """Lanes whose kernel and plain pdfs differ by more than 1e-3
    (relative, floor 1e-3), capped at DD_CAP of the lanes: directions on
    the sun cone's edge, whose cone test the kernel (its dot product
    contracted into FMAs) and the plain version take differently, which
    moves the pdf by the whole cone term, 1 / (2 pi (1 - cos_cut)) ~ 1.4e4,
    and the mixture weight's cotangent with it."""
    flip = _rel(pdf_k.detach(), pdf_p.detach(), 1e-3) > 1e-3
    k = int(flip.sum())
    print(f"check {name} lanes left out (pdfs differ by > 1e-3, the cone "
          f"test flipped): {k} of {n} (cap {int(DD_CAP * n)})")
    if k > DD_CAP * n:
        raise AssertionError(f"{name}: {k} lanes' pdfs differ")
    return flip


def _zenith_lanes(name, d_k, d_p):
    """Lanes whose kernel and plain sampler directions differ and lie
    within ZENITH_BAND of the zenith (in sin(theta)), capped at
    ZENITH_CAP of the lanes. There the pdf's 1 / sin(theta) and atan2's
    1 / sin(theta)^2 turn the samplers' ulp differences (up to ~2e-5) into
    relative differences of ~2e-5 / theta in a lane's cotangents through
    the placement, and these few lanes set the gaussian table's (up to
    4e-3 of its scale with them, 3e-7 without: one H100 run)."""
    import torch
    with torch.no_grad():
        sin_t = torch.sqrt(d_p[:, 0] ** 2 + d_p[:, 1] ** 2)
        near = (d_k != d_p).any(-1) & (sin_t < ZENITH_BAND)
    n, k = d_k.shape[0], int(near.sum())
    print(f"check {name} lanes left out (directions differ, sin(theta) < "
          f"{ZENITH_BAND:g}): {k} of {n} (cap {int(ZENITH_CAP * n)})")
    if k > ZENITH_CAP * n:
        raise AssertionError(f"{name}: {k} lanes near the zenith")
    return near


def _lane_check(name, a, b, n, mask=None):
    """Per-lane cotangents within 1e-3 of each lane's scale (floor 1e-3)
    on all but DD_CAP of the lanes (those under `mask` left out); returns
    the max abs error over all lanes."""
    err = (a - b).abs().amax(-1) / (b.abs().amax(-1) + 1e-3)
    if mask is not None:
        err = err[~mask]
    _count_outside(name, err, 1e-3, n, DD_CAP)
    return float((a - b).abs().max())


def _unaligned(x):
    """A copy of x (N, C) whose rows start 4 bytes past a 16-byte
    boundary."""
    import torch
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def _cone_edge(d, state):
    """Directions d (N, 3) whose cosine to the sun lies within CONE_BAND of
    the cone's cosine: there the pdf's cone test (a float32 dot product,
    contracted into FMAs in the kernels, a sum of products in the plain
    version) may go either way."""
    import torch
    with torch.no_grad():
        cos_g = (d.double() * state.sun_frame_n.double()).sum(-1)
        cos_cut = float(torch.cos(state.params.sun_half_aperture))
        return (cos_g - cos_cut).abs() < CONE_BAND


def _check_hit(name, state, d, wl=None, cone_edge=False):
    """K10 (K2 where wl is None) against its plain version at directions
    d, wavelengths wl: radiance within 1e-4 and the pdf within 1e-3
    (relative, floor 1e-3) on all but LANE_CAP of the lanes; with
    cone_edge, the pdf's bar leaves out the lanes on the cone's edge
    (_cone_edge), counted over all lanes first, of which at most CONE_CAP
    of the lanes may flip. Returns the radiance's max abs error."""
    import torch
    from tpusky_torch.models.sunsky import model as M
    from tpusky_torch.ops.cuda import sunsky_kernel as K
    n = d.shape[0]
    if wl is None:
        rad, pdf = K.sunsky_hit_rgb(state, d)
        ref, ref_pdf = M._hit_rgb_plain(state, d)
    else:
        rad, pdf = K.sunsky_hit_spec(state, d, wl)
        ref, ref_pdf = M._hit_spec_plain(state, d, wl)
    torch.cuda.synchronize()
    _count_outside(f"{name} radiance", _rel(rad, ref, 1e-3).amax(-1), 1e-4,
                   n)
    err_pdf = _rel(pdf, ref_pdf, 1e-3)
    if cone_edge:
        edge = _cone_edge(d, state)
        flips = int((err_pdf[edge] > 1e-3).sum())
        print(f"check {name} pdf: {int((err_pdf > 1e-3).sum())} of {n} "
              f"lanes outside 1e-3, {flips} of them among the "
              f"{int(edge.sum())} lanes within {CONE_BAND:g} of the cone's "
              f"edge, which are left out (cap {int(CONE_CAP * n)})")
        if flips > CONE_CAP * n:
            raise AssertionError(f"{name}: {flips} cone-edge pdfs flipped")
        err_pdf = err_pdf[~edge]
    _count_outside(f"{name} pdf", err_pdf, 1e-3, n)
    return float((rad - ref).abs().max())


def _check_nee(name, state, u2, wl=None):
    """K11 (K3 where wl is None) against its plain version at uniforms u2,
    wavelengths wl: the direction within 1e-5, the pdf within 1e-3 where
    the directions agree, the radiance (against the plain radiance at the
    kernel's directions) at a median of 1e-4 and within 1e-2 on all but
    LANE_CAP of the lanes. Returns the direction's max abs error."""
    from tpusky_torch.models.sunsky import model as M
    from tpusky_torch.ops.cuda import sunsky_kernel as K
    n = u2.shape[0]
    if wl is None:
        d, rad, pdf = K.sunsky_nee_rgb(state, u2)
        ref_d, _, ref_pdf = M._sample_eval_rgb_plain(state, u2)
        ref_rad = M._eval_rgb_plain(state, d)
    else:
        d, rad, pdf = K.sunsky_nee_spec(state, u2, wl)
        ref_d, _, ref_pdf = M._sample_eval_spec_plain(state, u2, wl)
        ref_rad = M._eval_spec_plain(state, d, wl)
    far = (d - ref_d).abs().amax(-1)
    _count_outside(f"{name} direction", far, 1e-5, n)
    near = far <= 1e-5
    _count_outside(f"{name} pdf", _rel(pdf, ref_pdf, 1e-3)[near], 1e-3, n)
    rel = _rel(rad, ref_rad, 1e-3).amax(-1)
    med = float(rel.median())
    print(f"check {name} radiance: median {med:.3e} (bar 1e-4)")
    if not med <= 1e-4:
        raise AssertionError(f"{name} radiance median")
    _count_outside(f"{name} radiance", rel, 1e-2, n)
    return float(far.max())


def spectral_phase(dev, dirs, rng, film, card):
    """Phase 6: K9-K11 against their plain versions, bench_spectral's
    frame through render() with the launch counts of that run, the frame
    against the plain path and a crop against the CPU, K12 and K13 without
    the pdf against autograd of their plain versions, then times. Returns
    {K: (name, launches, max abs error, (ms, plain ms), (bound ms, bound
    by))}; K12's and K13's launches are filled in by phase 7."""
    import torch
    import tpusky_torch as tt
    from tpusky_torch.models.sunsky import model as M
    from tpusky_torch.ops import spectrum
    from tpusky_torch.ops.cuda import build
    from tpusky_torch.ops.cuda import sunsky_kernel as K
    from tpusky_torch.render import integrator
    from tpusky_torch.render.bsdf import table_kinds
    from tpusky_torch.render.film import Film, develop, splat_ordered

    n = dirs.shape[0]
    params = tt.make_params(turbidity=3.0, albedo=0.3, sun_direction=SUN,
                            mode="spectral", device=dev)
    state = tt.sunsky_precompute(params, mode="spectral")
    state_cpu = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=SUN, mode="spectral",
        device="cpu"), mode="spectral")
    for f in ("sky_params", "sky_radiance", "sun_radiance", "sun_ld",
              "gaussians", "sky_sampling_w"):
        a, b = getattr(state, f).cpu(), getattr(state_cpu, f)
        if not (a - b).abs().max() <= 1e-5 * b.abs().max():
            raise AssertionError(f"spectral precompute on the card: {f}")
    # an eighth of the lanes below the horizon; wavelengths as the render
    # draws them, some past 720 nm
    d = dirs.clone()
    d[: n // 8, 2] = -d[: n // 8, 2]
    u_wl = torch.tensor(rng.random(n, dtype=np.float32), device=dev)
    wl = spectrum.sample_rgb_spectrum(
        spectrum.sample_shifted(u_wl, N_HERO))[0].contiguous()
    u2 = torch.tensor(rng.random((n, 2), dtype=np.float32), device=dev)
    print(f"spectral lanes: {float((wl > 720).float().mean()):.4f} of "
          f"wavelengths past 720 nm, {float((wl < 360).float().mean()):.4f} "
          f"below 360 nm")
    err = {}

    rad9 = K.sunsky_eval_spec(state, d, wl)
    ref9 = M._eval_spec_plain(state, d, wl)
    torch.cuda.synchronize()
    _count_outside("K9 radiance", _rel(rad9, ref9, 1e-3).amax(-1), 1e-4, n)
    out = (d[:, 2:] < 0) | (wl < 320) | (wl > 720)
    if not bool((rad9[out] == 0).all()):
        raise AssertionError("K9: lanes below the horizon or outside "
                             "[320, 720] nm are not zero")
    err["K9"] = float((rad9 - ref9).abs().max())
    # W is a runtime argument: the goldens' 10 wavelengths a lane
    m = min(1 << 16, n)
    wl10 = torch.tensor(rng.uniform(300.0, 760.0, (m, 10)).astype(
        np.float32), device=dev)
    # (the last lanes: the first eighth lies below the horizon)
    _count_outside("K9 radiance, 10 wavelengths",
                   _rel(K.sunsky_eval_spec(state, d[n - m:], wl10),
                        M._eval_spec_plain(state, d[n - m:], wl10),
                        1e-3).amax(-1), 1e-4, m)
    err["K10"] = _check_hit("K10", state, d, wl)
    err["K11"] = _check_nee("K11", state, u2, wl)
    # the runtime-W kernels at the goldens' 10 wavelengths (every lane, so
    # that the bars are the headline's; drawn from a generator of their
    # own), and at 4 whose rows are not on 16-byte boundaries (the W = 4
    # kernels need them)
    wl10_all = torch.tensor(np.random.default_rng(10).uniform(
        300.0, 760.0, (n, 10)).astype(np.float32), device=dev)
    _check_hit("K10, 10 wavelengths", state, d, wl10_all)
    _check_nee("K11, 10 wavelengths", state, u2, wl10_all)
    del wl10_all
    _check_hit("K10, 4 unaligned wavelengths", state, d,
                    _unaligned(wl))
    # the lane classes: every lane a TGMM sky sample, every lane a
    # sun-cone sample (K11); every direction in the sun's disc (K10: the
    # sun-cone samples' directions)
    w_sky = float(state.sky_sampling_w)
    u_mix = {"sky": torch.stack([u2[:, 0] * w_sky, u2[:, 1]],
                                -1).contiguous(),
             "sun": torch.stack([w_sky + (1.0 - w_sky) * u2[:, 0],
                                 u2[:, 1]], -1).contiguous()}
    for mix, uu in u_mix.items():
        _check_nee(f"K11, all {mix} samples", state, uu, wl)
    d_disc10 = M._sample_eval_spec_plain(state, u_mix["sun"],
                                         wl)[0].contiguous()
    _check_hit("K10, every direction in the disc", state, d_disc10, wl,
                    cone_edge=True)
    del rad9, ref9, out

    # the main path: sky dome (K9) and bench_spectral's frame (K10, K11)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    state = tt.sunsky_precompute(params, mode="spectral")
    sky = tt.sunsky_eval(state, dirs, mode="spectral", wavelengths=wl)
    scene, sensor = _spectral_scene(state, dev)
    img = integrator.render(scene, sensor, film, SEED, spp=SPP,
                            max_depth=SPEC_DEPTH, mode="spectral")
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(build.launches)
    print(f"spectral main path: {main_s:.2f} s, launches {launches}")
    for name in ("sunsky_eval_spec", "sunsky_hit_spec", "sunsky_nee_spec"):
        if launches[name] <= 0:
            raise AssertionError(f"the spectral path never launched {name}")
    if launches["direct_rgb_megakernel"] != 0:
        raise AssertionError("the spectral frame went through K4")
    if not (bool(torch.isfinite(sky).all()) and sky.shape == wl.shape):
        raise AssertionError("spectral sky radiance")
    if not (img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
            and float(img.mean()) > 0.0):
        raise AssertionError("spectral render: image not finite, shaped or "
                             "lit")
    print(f"spectral image: mean {float(img.mean()):.5f} max "
          f"{float(img.max()):.3f}")

    kinds = table_kinds(scene.bsdfs)
    lanes_k = integrator._lane_radiance(scene, sensor, film, SEED, SPP, 0,
                                        SPP, SPEC_DEPTH, 1000, "spectral", 0,
                                        H, kinds=kinds)
    lanes_p = integrator._lane_radiance(scene, sensor, film, SEED, SPP, 0,
                                        SPP, SPEC_DEPTH, 1000, "spectral", 0,
                                        H, kinds=kinds, plain=True)
    img_p = develop(splat_ordered(film, lanes_p, SPP))
    rel = (lanes_k - lanes_p).abs().amax(-1) / \
        lanes_p.abs().clamp(min=1e-3).amax(-1)
    share = float((rel > 1e-3).float().mean())
    bar = 1e-3 * max(float(img_p.max()), 1.0)
    err_img = float((img - img_p).abs().max())
    print(f"check spectral frame lanes: {share:.2e} of lanes outside 1e-3 "
          f"(bar 1e-3), max {float(rel.max()):.3e}")
    print(f"check spectral frame image: max |kernels - plain| "
          f"{err_img:.3e}, bar {bar:.3e}")
    if not (share <= 1e-3 and err_img < bar):
        raise AssertionError("the spectral frame disagrees with the plain "
                             "path")
    del lanes_k, lanes_p, rel

    x0, y0, cw, ch = CROP
    crop = Film(H, W, 3, crop_offset=(x0, y0), crop_size=(cw, ch))
    scene_c, sensor_c = _spectral_scene(state_cpu, "cpu")
    img_c = integrator.render(scene_c, sensor_c, crop, SEED, spp=SPP,
                              max_depth=SPEC_DEPTH, mode="spectral")
    err_c = float((img[y0:y0 + ch, x0:x0 + cw].cpu() - img_c).abs().max())
    print(f"check spectral frame vs CPU plain, crop {CROP}: max {err_c:.3e}"
          f" (image max there {float(img_c.max()):.3f})")
    if not (err_c < 1e-3 * max(float(img_c.max()), 1.0)
            and float(img_c.max()) > 0):
        raise AssertionError("the spectral frame disagrees with the CPU")

    # K12 and K13 without the pdf (the render's contract) against autograd
    # of their plain versions: 1% of the directions at the disc edge, a
    # cotangent drawn from a numpy seed, gradients through precompute
    lp, st_g = _spectral_leaf_state(dev)
    d_g = _with_disc_edge(d, st_g, rng)
    g_spec = torch.tensor(rng.normal(size=(n, N_HERO)).astype(np.float32),
                          device=dev)
    d_k, d_p = d_g.clone().requires_grad_(), d_g.clone().requires_grad_()
    wl_k, wl_p = wl.clone().requires_grad_(), wl.clone().requires_grad_()
    out12p = M._eval_spec_plain(st_g, d_p, wl_p)
    err["K12"], (dd_k, dwl_k), (dd_p, dwl_p) = _adjoint_check(
        "K12", K.sunsky_eval_spec(st_g, d_k, wl_k), out12p, g_spec, st_g,
        lp, [d_k, wl_k], [d_p, wl_p])
    err["K12"] = max(err["K12"], _lane_check("K12 dd", dd_k, dd_p, n),
                     _lane_check("K12 dwl", dwl_k, dwl_p, n))
    out = (d_g[:, 2:] < 0) | (wl < 320) | (wl >= 720)
    if not bool((dwl_k[out] == 0).all()):
        raise AssertionError("K12: a wavelength cotangent below the horizon "
                             "or outside [320, 720) nm is not zero")
    del dd_k, dwl_k, dd_p, dwl_p, out
    # W = 10 wavelengths a lane, as K9's check
    d10_k = d_g[n - m:].clone().requires_grad_()
    d10_p = d_g[n - m:].clone().requires_grad_()
    wl10_k, wl10_p = wl10.clone().requires_grad_(), wl10.clone().requires_grad_()
    g10 = torch.tensor(rng.normal(size=(m, 10)).astype(np.float32),
                       device=dev)
    _, (dd_k, dwl_k), (dd_p, dwl_p) = _adjoint_check(
        "K12, 10 wavelengths", K.sunsky_eval_spec(st_g, d10_k, wl10_k),
        M._eval_spec_plain(st_g, d10_p, wl10_p), g10, st_g, lp,
        [d10_k, wl10_k], [d10_p, wl10_p])
    _lane_check("K12 dd, 10 wavelengths", dd_k, dd_p, m)
    _lane_check("K12 dwl, 10 wavelengths", dwl_k, dwl_p, m)
    del dd_k, dwl_k, dd_p, dwl_p
    # K13 redraws K11's samples bitwise: held against the plain radiance at
    # those samples, and against the plain NEE block with its own sampler
    # as phase 3 holds K6
    d13, rad13, _ = K.sunsky_nee_spec(st_g, u2, wl_k, pdf_detached=True)
    out13p = M._eval_spec_plain(st_g, d13, wl_p)
    err["K13"], (dwl_k,), (dwl_p,) = _adjoint_check(
        "K13 (at its samples)", rad13, out13p, g_spec, st_g, lp, [wl_k],
        [wl_p])
    err["K13"] = max(err["K13"], _lane_check("K13 dwl", dwl_k, dwl_p, n))
    d_ps, rad_ps = M._sample_eval_spec_plain(st_g, u2, wl_p)[:2]
    _adjoint_check("K13 (plain sampler, all lanes)", rad13, rad_ps, g_spec,
                   st_g, lp, misc_bar=None)
    at_clamp = _ramp_clamp_lanes("K13", d13, d_ps, st_g)
    _adjoint_check("K13 (plain sampler, ramp clamps left out)", rad13,
                   rad_ps, g_spec * (~at_clamp)[:, None], st_g, lp)
    del dwl_k, dwl_p, d_ps, rad_ps, rad13, at_clamp
    # K13 by sampling strategy (every lane a TGMM sky sample; every lane a
    # sun-cone sample, whose sun rows and limb table a warp sums), and K12
    # with every direction in the sun's disc (the sun-cone samples'), each
    # against autograd of the plain radiance at those directions
    for mix, uu in u_mix.items():
        wm_k, wm_p = wl.clone().requires_grad_(), wl.clone().requires_grad_()
        d_s, rad_s, _ = K.sunsky_nee_spec(st_g, uu, wm_k, pdf_detached=True)
        _, (dwl_k,), (dwl_p,) = _adjoint_check(
            f"K13, all {mix} samples (at its samples)", rad_s,
            M._eval_spec_plain(st_g, d_s, wm_p), g_spec, st_g, lp, [wm_k],
            [wm_p])
        _lane_check(f"K13 dwl, all {mix} samples", dwl_k, dwl_p, n)
    d_disc = d_s.detach().contiguous()
    dm_k = d_disc.clone().requires_grad_()
    dm_p = d_disc.clone().requires_grad_()
    wm_k, wm_p = wl.clone().requires_grad_(), wl.clone().requires_grad_()
    _, (dd_k, dwl_k), (dd_p, dwl_p) = _adjoint_check(
        "K12, every direction in the disc",
        K.sunsky_eval_spec(st_g, dm_k, wm_k),
        M._eval_spec_plain(st_g, dm_p, wm_p), g_spec, st_g, lp, [dm_k, wm_k],
        [dm_p, wm_p])
    _lane_check("K12 dd, every direction in the disc", dd_k, dd_p, n)
    _lane_check("K12 dwl, every direction in the disc", dwl_k, dwl_p, n)
    del d_s, rad_s, dm_k, dm_p, wm_k, wm_p, dd_k, dwl_k, dd_p, dwl_p

    # times (CUDA events) and bounds
    tables = K.pack_tables_spec(state, dev)
    leaves = [st_g.sky_params, st_g.sky_radiance, st_g.sun_radiance,
              st_g.sun_ld]
    times = {
        "K9": _pair_ms(lambda: K.launch_eval_spec(tables, d, wl),
                       lambda: M._eval_spec_plain(state, d, wl)),
        "K10": _pair_ms(lambda: K.launch_hit_spec(tables, d, wl),
                        lambda: M._hit_spec_plain(state, d, wl)),
        "K11": _pair_ms(lambda: K.launch_nee_spec(tables, u2, wl),
                        lambda: M._sample_eval_spec_plain(state, u2, wl)),
        # the adjoints: autograd's backward alone over the graphs above
        "K12": _pair_ms(
            lambda: K.launch_hit_spec_bwd(tables, d_g, wl, g_spec),
            lambda: _grads(out12p, leaves + [d_p, wl_p], g_spec), reps=3),
        "K13": _pair_ms(
            lambda: K.launch_nee_spec_bwd(tables, u2, wl, g_spec),
            lambda: _grads(out13p, leaves + [wl_p], g_spec), reps=3),
    }
    frame_ms, frame_plain_ms = _pair_ms(
        lambda: integrator.render(scene, sensor, film, SEED, spp=SPP,
                                  max_depth=SPEC_DEPTH, mode="spectral"),
        lambda: integrator.render_rows(scene, sensor, film, SEED, SPP,
                                       SPEC_DEPTH, 1000, "spectral", 0, H,
                                       kinds=kinds, plain=True), reps=3)
    rays = H * W * SPP * (1 + 2 * (SPEC_DEPTH - 1))
    mix_ms = {
        "K13 sky": _time_ms(lambda: K.launch_nee_spec_bwd(
            tables, u_mix["sky"], wl, g_spec), 5),
        "K13 sun": _time_ms(lambda: K.launch_nee_spec_bwd(
            tables, u_mix["sun"], wl, g_spec), 5),
        "K12 disc": _time_ms(lambda: K.launch_hit_spec_bwd(
            tables, d_disc, wl, g_spec), 5)}
    fwd_mix_ms = {
        "K10 disc": _time_ms(lambda: K.launch_hit_spec(tables, d_disc10, wl)),
        "K11 sky": _time_ms(lambda: K.launch_nee_spec(tables, u_mix["sky"],
                                                      wl)),
        "K11 sun": _time_ms(lambda: K.launch_nee_spec(tables, u_mix["sun"],
                                                      wl))}
    for key in ("K9", "K10", "K11", "K12", "K13"):
        k, p = times[key]
        print(f"time {key}: {k:.4f} ms, plain {p:.4f} ms at {n} lanes x "
              f"{N_HERO} wavelengths [{card}]")
    print(f"time K13 by strategy at {n} lanes x {N_HERO} wavelengths: all "
          f"sky samples {mix_ms['K13 sky']:.4f} ms, all sun-cone samples "
          f"{mix_ms['K13 sun']:.4f} ms (the headline sky weight "
          f"{w_sky:.4f}); K12 with every direction in the disc "
          f"{mix_ms['K12 disc']:.4f} ms; the previous kernels: "
          + ", ".join(f"{k} {v} ms" for k, v in PREV_SPEC_MIX_MS.items())
          + f" [{card}]")
    print(f"time K10 with every direction in the disc "
          f"{fwd_mix_ms['K10 disc']:.4f} ms; K11 by strategy: all sky "
          f"samples {fwd_mix_ms['K11 sky']:.4f} ms, all sun-cone samples "
          f"{fwd_mix_ms['K11 sun']:.4f} ms, at {n} lanes x {N_HERO} "
          "wavelengths; the previous kernels: "
          + ", ".join(f"{k} {v} ms" for k, v in PREV_SPEC_FWD_MIX_MS.items())
          + f" [{card}]")
    print(f"time bench_spectral frame ({W}x{H}x{SPP}, depth {SPEC_DEPTH}, "
          f"{rays} rays): render() {frame_ms:.3f} ms "
          f"({rays / frame_ms / 1e3:.2f} M rays/s), plain wavefront "
          f"{frame_plain_ms:.3f} ms ({rays / frame_plain_ms / 1e3:.2f} M "
          f"rays/s) [{card}]")

    with torch.no_grad():
        above = float((d[:, 2] >= 0).sum())
        w_sky = float(state.sky_sampling_w)
        sky_pick = float((u2[:, 0] < w_sky).sum())
        d11 = K.launch_nee_spec(tables, u2, wl)[0]
        above11 = float((d11[:, 2] >= 0).sum())
        ops9 = _spec_ops(d, wl, state)
        sample_ops = (sky_pick * OPS["sample_sky"]
                      + (n - sky_pick) * OPS["sample_sun"])
        ops11 = sample_ops + above11 * OPS["pdf"] + _spec_ops(d11, wl, state)
        ops12 = _spec_vjp_ops(d_g, wl, state)
        ops13 = sample_ops + _spec_vjp_ops(d11, wl, state)
    bounds = {
        "K9": _bound(44 * n + SPEC_TABLE_BYTES, ops9),
        "K10": _bound(48 * n + SPEC_TABLE_BYTES + GAUSS_BYTES,
                      ops9 + above * OPS["pdf"]),
        "K11": _bound(56 * n + SPEC_TABLE_BYTES + GAUSS_BYTES, ops11),
        # d, wl, g in; dd, dwl out; the cotangent row out
        "K12": _bound(72 * n + SPEC_TABLE_BYTES + SPEC_ROW_BYTES, ops12),
        # u, wl, g in; dwl out
        "K13": _bound(56 * n + SPEC_TABLE_BYTES + GAUSS_BYTES
                      + SPEC_ROW_BYTES, ops13),
    }
    return {key: (KERNELS[key][0], launches[KERNELS[key][0]], err[key],
                  times[key], bounds[key]) for key in bounds}


def spectral_grad_case(kind, scene, sensor, film, tables, dev):
    """bench.py::bench_spectral_grad: the loss mean(img^2) of the spectral
    frame (512x512, GRAD_SPP, depth MAX_DEPTH, a diffuse ground) and its
    gradient to (turbidity, albedo (11,), sun direction) through
    precompute(..., "spectral"). kind "rows" runs render_rows with the
    kernels, "plain" with the plain versions, "render" render().
    Returns (loss, gradients)."""
    import torch
    import tpusky_torch as tt
    from tpusky_torch.models.sunsky.model import precompute
    from tpusky_torch.render import integrator
    from tpusky_torch.render.bsdf import table_kinds
    from tpusky_torch.render.film import develop
    t = torch.tensor(3.0, device=dev, requires_grad=True)
    alb = torch.full((11,), 0.3, device=dev, requires_grad=True)
    sd = torch.tensor(SUN, device=dev, requires_grad=True)
    p = tt.make_params(turbidity=t, albedo=alb,
                       sun_direction=sd / torch.sqrt((sd ** 2).sum()),
                       mode="spectral", device=dev)
    sc = scene._replace(env=precompute(tables, p, "spectral"))
    if kind == "render":
        im = integrator.render(sc, sensor, film, SEED, spp=GRAD_SPP,
                               max_depth=MAX_DEPTH, mode="spectral")
    else:
        im = develop(integrator.render_rows(
            sc, sensor, film, SEED, GRAD_SPP, MAX_DEPTH, 1000, "spectral",
            0, H, kinds=table_kinds(sc.bsdfs), plain=kind == "plain"))
    loss = (im ** 2).mean()
    return loss.detach().item(), torch.autograd.grad(loss, [t, alb, sd])


def _spectral_grad_scene(state, device):
    """bench.py::bench_spectral_grad's scene: a 20x20 diffuse ground
    (albedo 0.5) under the spectral sunsky, the camera of bench_spectral."""
    from tpusky_torch.render.scene import make_scene
    from tpusky_torch.render.sensors import make_perspective
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    scene = make_scene(shapes=[dict(kind=1, to_world=ground, bsdf_idx=0)],
                       bsdf_albedos=[[0.5, 0.5, 0.5]], env=state,
                       device=device)
    sensor = make_perspective([4, -4, 2.0], [0, 0, 0.5], fov_x_deg=45,
                              device=device)
    return scene, sensor


def spectral_grad_phase(dev, dirs, rng, film, card):
    """Phase 7 (path 1): bench_spectral_grad's gradient through render_rows
    and render() (K10, K11 forward; K12, K13 without the pdf backward) and
    a spectral sky dome's (K9 forward, K12 backward), the launch counts of
    that run; both gradients against each other and against the plain
    path's on the card; then the step's time. Returns the launch counts."""
    import torch
    import tpusky_torch as tt
    from tpusky_torch.models.sunsky import model as M
    from tpusky_torch.ops import spectrum
    from tpusky_torch.ops.cuda import build
    tables = tt.load_tables("spectral", device=dev)
    state = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=SUN, mode="spectral",
        device=dev), mode="spectral")
    scene, sensor = _spectral_grad_scene(state, dev)
    n = dirs.shape[0]
    u_wl = torch.tensor(rng.random(n, dtype=np.float32), device=dev)
    wl = spectrum.sample_rgb_spectrum(
        spectrum.sample_shifted(u_wl, N_HERO))[0].contiguous()

    def case(kind):
        return spectral_grad_case(kind, scene, sensor, film, tables, dev)

    def dome(plain):
        lp = _leaf_params(dev, "spectral")
        st = tt.sunsky_precompute(lp, mode="spectral")
        sky = (M.eval(st, dirs, mode="spectral", plain=plain,
                      wavelengths=wl) ** 2).mean()
        return torch.autograd.grad(sky, [lp.turbidity, lp.albedo,
                                         lp.sun_direction])

    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    loss_k, grad_k = case("rows")
    loss_r, grad_r = case("render")
    dome_k = dome(False)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(build.launches)
    print(f"spectral gradient main path: {path_s:.2f} s, launches "
          f"{launches}")
    for name in ("sunsky_eval_spec", "sunsky_hit_spec", "sunsky_nee_spec",
                 "sunsky_hit_spec_bwd", "sunsky_nee_spec_bwd"):
        if launches[name] <= 0:
            raise AssertionError(f"the spectral gradient path never "
                                 f"launched {name}")
    names = ("turbidity", "albedo", "sun_direction")
    print("bench_spectral_grad loss %.6e, d/d(turbidity, albedo, sun) = %s"
          % (loss_k, [g.tolist() for g in grad_k]))
    if not all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
               for g in grad_k):
        raise AssertionError("bench_spectral_grad: gradients not finite or "
                             "zero")
    for name, a, b in zip(names, grad_r, grad_k):
        _check_scale(f"bench_spectral_grad render() vs render_rows d{name}",
                     a, b, 1e-4)
    loss_p, grad_p = case("plain")
    dome_p = dome(True)
    print(f"bench_spectral_grad loss: kernels {loss_k:.6e}, render() "
          f"{loss_r:.6e}, plain {loss_p:.6e}")
    for (name, bar), a, b, c, e in zip(
            ((names[0], 1e-3), (names[1], 1e-3), (names[2], 3e-2)), grad_k,
            grad_p, dome_k, dome_p):
        _check_scale(f"bench_spectral_grad d{name}: kernels vs plain on the "
                     f"card", a, b, bar)
        _check_scale(f"spectral sky dome d{name}: K9/K12 vs plain", c, e,
                     bar)

    step_ms, plain_ms = _pair_ms(lambda: case("rows"), lambda: case("plain"),
                                 reps=3)
    rays = H * W * GRAD_SPP * (1 + 2 * (MAX_DEPTH - 1))
    print(f"time bench_spectral_grad fwd+bwd ({W}x{H}x{GRAD_SPP}, depth "
          f"{MAX_DEPTH}, {rays} rays, precompute included): render_rows "
          f"with K10/K11/K12/K13 {step_ms:.2f} ms "
          f"({rays / step_ms / 1e3:.2f} M rays/s), plain {plain_ms:.2f} ms "
          f"({rays / plain_ms / 1e3:.2f} M rays/s) [{card}]")
    return launches


def attached_pdf_phase(dev, dirs, u2, rng, card):
    """Phase 8 (path 2): the emitter API's attached pdf. `eval_pdf` and
    `sample_eval` with pdf_detached=False at N_LANES lanes, differentiated
    with a cotangent on the radiance and on the pdf: RGB mode (K2 then K7,
    K3 then K8) and spectral mode at 4 hero wavelengths (K10 then K12 with
    the pdf, K11 then K13 with the pdf; K12 again at 64K lanes x 10
    wavelengths), the launch counts of that run; each held against
    autograd of its plain version. Then times. Returns {K: (name,
    launches, max abs error, (ms, plain ms), (bound ms, bound by))}."""
    import torch
    import tpusky_torch as tt
    from tpusky_torch.models.sunsky import model as M
    from tpusky_torch.ops import spectrum
    from tpusky_torch.ops.cuda import build
    from tpusky_torch.ops.cuda import sunsky_kernel as K
    n = dirs.shape[0]
    lp = _leaf_params(dev)
    st = tt.sunsky_precompute(lp)
    lps, sts = _spectral_leaf_state(dev)
    d = dirs.clone()
    d[: n // 8, 2] = -d[: n // 8, 2]
    d = _with_disc_edge(d, st, rng)
    u_wl = torch.tensor(rng.random(n, dtype=np.float32), device=dev)
    wl = spectrum.sample_rgb_spectrum(
        spectrum.sample_shifted(u_wl, N_HERO))[0].contiguous()

    def normal(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32),
                            device=dev)
    g_rad, g_pdf, g_spec = normal(n, 3), normal(n), normal(n, N_HERO)
    m = min(1 << 16, n)
    wl10 = torch.tensor(rng.uniform(300.0, 760.0, (m, 10)).astype(
        np.float32), device=dev)
    g10 = normal(m, 10)

    def pair(x):
        return x.clone().requires_grad_(), x.clone().requires_grad_()
    err, graphs = {}, {}
    torch.cuda.synchronize()
    build.reset_launches()
    # RGB hit: K2 forward, K7 backward
    d_k, d_p = pair(d)
    out_k, out_p = list(M.eval_pdf(st, d_k)), list(M._hit_rgb_plain(st, d_p))
    _adjoint_check("K7 (all lanes)", out_k, out_p, [g_rad, g_pdf], st, lp,
                   pdf=True, read=True)
    keep = (~_pdf_flips("K7", out_k[1], out_p[1], n)).float()
    err["K7"], (dd_k,), (dd_p,) = _adjoint_check(
        "K7 (cone flips left out)", out_k, out_p,
        [g_rad * keep[:, None], g_pdf * keep], st, lp, [d_k], [d_p],
        pdf=True)
    err["K7"] = max(err["K7"], _lane_check("K7 dd", dd_k, dd_p, n))
    graphs["K7"] = (list(out_p), [d_p], [g_rad, g_pdf])
    # RGB NEE: K3 forward, K8 backward; held against the plain NEE block
    # with its own sampler, as phase 3 holds K6, without the lanes at the
    # ramp's clamps, near the zenith or whose cone test flipped
    d8, rad8, pdf8 = M.sample_eval(st, u2)
    d_ps, rad_ps, pdf_ps = M._sample_eval_rgb_plain(st, u2)
    _adjoint_check("K8 (all lanes)", [rad8, pdf8], [rad_ps, pdf_ps],
                   [g_rad, g_pdf], st, lp, pdf=True, read=True)
    keep = (~(_ramp_clamp_lanes("K8", d8, d_ps, st)
              | _zenith_lanes("K8", d8, d_ps)
              | _pdf_flips("K8", pdf8, pdf_ps, n))).float()
    err["K8"], _, _ = _adjoint_check(
        "K8 (those lanes left out)", [rad8, pdf8], [rad_ps, pdf_ps],
        [g_rad * keep[:, None], g_pdf * keep], st, lp, pdf=True)
    graphs["K8"] = ([rad_ps, pdf_ps], [], [g_rad, g_pdf])
    # spectral hit: K10 forward, K12 with the pdf backward
    (d_k, d_p), (wl_k, wl_p) = pair(d), pair(wl)
    out_k = list(M.eval_pdf(sts, d_k, mode="spectral", wavelengths=wl_k))
    out_p = list(M._hit_spec_plain(sts, d_p, wl_p))
    _adjoint_check("K12 with the pdf (all lanes)", out_k, out_p,
                   [g_spec, g_pdf], sts, lps, pdf=True, read=True)
    keep = (~_pdf_flips("K12 with the pdf", out_k[1], out_p[1], n)).float()
    err["K12"], (dd_k, dwl_k), (dd_p, dwl_p) = _adjoint_check(
        "K12 with the pdf (cone flips left out)", out_k, out_p,
        [g_spec * keep[:, None], g_pdf * keep], sts, lps, [d_k, wl_k],
        [d_p, wl_p], pdf=True)
    err["K12"] = max(err["K12"],
                     _lane_check("K12 with the pdf dd", dd_k, dd_p, n),
                     _lane_check("K12 with the pdf dwl", dwl_k, dwl_p, n))
    graphs["K12"] = (list(out_p), [d_p, wl_p], [g_spec, g_pdf])
    (d10_k, d10_p), (w10_k, w10_p) = pair(d[n - m:]), pair(wl10)
    out_k = list(M.eval_pdf(sts, d10_k, mode="spectral", wavelengths=w10_k))
    out_p = list(M._hit_spec_plain(sts, d10_p, w10_p))
    keep = (~_pdf_flips("K12 with the pdf, 10 wavelengths", out_k[1],
                        out_p[1], m)).float()
    _, (dd_k, dwl_k), (dd_p, dwl_p) = _adjoint_check(
        "K12 with the pdf, 10 wavelengths", out_k, out_p,
        [g10 * keep[:, None], g_pdf[:m] * keep], sts, lps, [d10_k, w10_k],
        [d10_p, w10_p], pdf=True)
    _lane_check("K12 with the pdf dd, 10 wavelengths", dd_k, dd_p, m)
    _lane_check("K12 with the pdf dwl, 10 wavelengths", dwl_k, dwl_p, m)
    # spectral NEE: K11 forward, K13 with the pdf backward; its wavelength
    # cotangent (the radiance's alone) held at the kernel's own samples
    (wl_k, wl_p), wl_q = pair(wl), wl.clone().requires_grad_()
    d13, rad13, pdf13 = M.sample_eval(sts, u2, mode="spectral",
                                      wavelengths=wl_k)
    d_ps, rad_ps, pdf_ps = M._sample_eval_spec_plain(sts, u2, wl_p)
    _adjoint_check("K13 with the pdf (all lanes)", [rad13, pdf13],
                   [rad_ps, pdf_ps], [g_spec, g_pdf], sts, lps, pdf=True,
                   read=True)
    keep = (~(_ramp_clamp_lanes("K13 with the pdf", d13, d_ps, sts)
              | _zenith_lanes("K13 with the pdf", d13, d_ps)
              | _pdf_flips("K13 with the pdf", pdf13, pdf_ps, n))).float()
    err["K13"], _, _ = _adjoint_check(
        "K13 with the pdf (those lanes left out)", [rad13, pdf13],
        [rad_ps, pdf_ps], [g_spec * keep[:, None], g_pdf * keep], sts, lps,
        pdf=True)
    (dwl_k,) = _grads([rad13, pdf13], [wl_k], [g_spec, g_pdf])
    (dwl_q,) = _grads(M._eval_spec_plain(sts, d13, wl_q), [wl_q], g_spec)
    err["K13"] = max(err["K13"], _lane_check(
        "K13 with the pdf dwl (at its samples)", dwl_k, dwl_q, n))
    graphs["K13"] = ([rad_ps, pdf_ps], [wl_p], [g_spec, g_pdf])
    torch.cuda.synchronize()
    launches = dict(build.launches)
    print(f"attached-pdf path: launches {launches}")
    for key in ("K2", "K3", "K7", "K8", "K10", "K11", "K12", "K13"):
        if launches[KERNELS[key][0]] <= 0:
            raise AssertionError(f"the attached-pdf path never launched "
                                 f"{KERNELS[key][0]}")
    del dd_k, dwl_k, dd_p, dwl_p, dwl_q

    # K8's lane classes: every lane a TGMM sky sample, every lane a
    # sun-cone sample. The cotangent is held in its two parts, each with
    # the headline's bars: the radiance's at K8's own samples (as phase 3
    # holds K6), the pdf's against the plain NEE block with its own
    # sampler, without the lanes near the zenith or whose cone test
    # flipped. (The disc weight's ramp enters the radiance's part alone.
    # Held together against the plain sampler, all sun-cone samples leave
    # 3.2% of the lanes at the ramp's clamps where the two samplers'
    # directions differ, past RAMP_CAP, sized for the headline's 66%
    # sun-cone samples: one H100 run.)
    w_sky = float(st.sky_sampling_w.detach())
    u_cls = {"sky": torch.stack([u2[:, 0] * w_sky, u2[:, 1]],
                                -1).contiguous(),
             "sun": torch.stack([w_sky + (1.0 - w_sky) * u2[:, 0],
                                 u2[:, 1]], -1).contiguous()}
    for mix, uu in u_cls.items():
        name = f"K8, all {mix} samples"
        d8, rad8, pdf8 = M.sample_eval(st, uu)
        e_rad, _, _ = _adjoint_check(
            f"{name}, the radiance's cotangent (at its samples)", rad8,
            M._eval_rgb_plain(st, d8), g_rad, st, lp)
        d_ps, _, pdf_ps = M._sample_eval_rgb_plain(st, uu)
        keep = (~(_zenith_lanes(name, d8, d_ps)
                  | _pdf_flips(name, pdf8, pdf_ps, n))).float()
        e_pdf, _, _ = _adjoint_check(
            f"{name}, the pdf's cotangent (those lanes left out)", pdf8,
            pdf_ps, g_pdf * keep, st, lp, pdf=True)
        err["K8"] = max(err["K8"], e_rad, e_pdf)
    del d8, rad8, pdf8, d_ps, pdf_ps
    # every direction in the disc (the plain sampler's sun-cone samples,
    # 1% of them at the disc's edge), for K7's time
    with torch.no_grad():
        d_disc = _with_disc_edge(M._sample_eval_rgb_plain(
            st, u_cls["sun"])[0].contiguous(), st, np.random.default_rng(2))

    # times: each kernel against autograd's backward alone over the plain
    # graphs built above
    state = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=SUN, device=dev))
    spec = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=SUN, mode="spectral",
        device=dev), mode="spectral")
    tab = K.pack_tables(state, dev)
    tab_s = K.pack_tables_spec(spec, dev)
    rgb = [st.sky_params, st.sky_radiance, st.sun_radiance, st.gaussians]
    spc = [sts.sky_params, sts.sky_radiance, sts.sun_radiance, sts.sun_ld,
           sts.gaussians]
    kernels = {
        "K7": lambda: K.launch_hit_bwd(tab, d, g_rad, g_pdf),
        "K8": lambda: K.launch_nee_pdf_bwd(tab, u2, g_rad, g_pdf),
        "K12": lambda: K.launch_hit_spec_bwd(tab_s, d, wl, g_spec, g_pdf),
        "K13": lambda: K.launch_nee_spec_bwd(tab_s, u2, wl, g_spec, g_pdf),
    }
    times = {}
    for key, run in kernels.items():
        out, lanes, cts = graphs[key]
        leaves = (rgb if key in ("K7", "K8") else spc) + lanes
        times[key] = _pair_ms(run, lambda: _grads(out, leaves, cts), reps=3)
        prev = (f"; the previous kernel "
                f"{(PREV_PDF_MS.get(key) or PREV_MS[key]):.4f} ms")
        print(f"time {key} with the pdf: {times[key][0]:.4f} ms, plain "
              f"{times[key][1]:.4f} ms at {n} lanes{prev} [{card}]")
    del graphs
    mix_ms = {
        "K7 disc": _time_ms(lambda: K.launch_hit_bwd(tab, d_disc, g_rad,
                                                     g_pdf), 3),
        "K8 sky": _time_ms(lambda: K.launch_nee_pdf_bwd(
            tab, u_cls["sky"], g_rad, g_pdf), 3),
        "K8 sun": _time_ms(lambda: K.launch_nee_pdf_bwd(
            tab, u_cls["sun"], g_rad, g_pdf), 3)}
    print(f"time K7 with the pdf, every direction in the disc "
          f"{mix_ms['K7 disc']:.4f} ms; K8 by strategy: all sky samples "
          f"{mix_ms['K8 sky']:.4f} ms, all sun-cone samples "
          f"{mix_ms['K8 sun']:.4f} ms, at {n} lanes; the previous kernels: "
          + ", ".join(f"{k} {v} ms" for k, v in PREV_RGB_BWD_MIX_MS.items()
                      if k != "K5 disc") + f" [{card}]")

    with torch.no_grad():
        o = OPS
        w_sky = float(state.sky_sampling_w)
        sky_pick = float((u2[:, 0] < w_sky).sum())
        d3 = K.launch_nee(tab, u2)[0]
        sample_ops = (sky_pick * (o["sample_sky"] + o["sample_sky_vjp"])
                      + (n - sky_pick) * (o["sample_sun"]
                                          + o["sample_sun_vjp"]))
        above = float((d[:, 2] >= 0).sum())
        above3 = float((d3[:, 2] >= 0).sum())
        ops7 = _vjp_ops(d, state) + above * o["pdf_vjp"]
        ops8 = sample_ops + _vjp_ops(d3, state) + above3 * o["pdf_vjp"]
        d11 = K.launch_nee_spec(tab_s, u2, wl)[0]
        above11 = float((d11[:, 2] >= 0).sum())
        ops12 = _spec_vjp_ops(d, wl, spec) + above * o["pdf_vjp"]
        ops13 = (sample_ops + _spec_vjp_ops(d11, wl, spec)
                 + above11 * o["pdf_vjp"])
    bounds = {
        # d, g_rad, g_pdf in; dd out
        "K7": _bound(40 * n + TABLE_BYTES + GAUSS_BYTES + ROW_PDF_BYTES,
                     ops7),
        # u, g_rad, g_pdf in
        "K8": _bound(24 * n + TABLE_BYTES + GAUSS_BYTES + ROW_PDF_BYTES,
                     ops8),
        # d, wl, g_rad, g_pdf in; dd, dwl out
        "K12": _bound(76 * n + SPEC_TABLE_BYTES + GAUSS_BYTES
                      + SPEC_ROW_BYTES, ops12),
        # u, wl, g_rad, g_pdf in; dwl out
        "K13": _bound(60 * n + SPEC_TABLE_BYTES + GAUSS_BYTES
                      + SPEC_ROW_BYTES, ops13),
    }
    for key, (ms, by) in bounds.items():
        print(f"bound {key} with the pdf: {ms:.4f} ms ({by}); measured "
              f"{times[key][0]:.4f} ms, {100 * ms / times[key][0]:.1f}% of "
              f"the bound's rate [{card}]")
    return {key: (KERNELS[key][0], launches[KERNELS[key][0]], err[key],
                  times[key], bounds[key]) for key in bounds}


def _mesh_wavefronts(rng, dev):
    """tools/bench_mesh.py:75-96's two wavefronts of MESH_RAYS rays, made
    with numpy: coherent, raster-ordered camera-style rays from y = -4;
    incoherent, bounce-style rays from the r = 1.3 sphere in random
    directions. {kind: (o, d)} on the card."""
    import torch
    side = int(math.isqrt(MESH_RAYS))
    ys, xs = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    u0 = (xs.ravel() + 0.5) / side * 2 - 1
    u1 = (ys.ravel() + 0.5) / side * 2 - 1
    coherent = (np.stack([u0 * 2, np.full(side * side, -4.0), u1 * 2], -1),
                np.stack([-0.2 * u0, np.ones(side * side), -0.2 * u1], -1))
    d = rng.normal(size=(MESH_RAYS, 3))
    o = 1.5 * rng.normal(size=(MESH_RAYS, 3))
    incoherent = (o / np.linalg.norm(o, axis=-1, keepdims=True) * 1.3, d)
    out = {}
    for kind, (o, d) in (("coherent", coherent), ("incoherent", incoherent)):
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        out[kind] = tuple(torch.tensor(x.astype(np.float32), device=dev)
                          for x in (o, d))
    return out


def _median_ms(fn, reps=5, warmup=1):
    """Median over reps of one call's CUDA-event time (ms)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def _mesh_ops(tables, o, d, t_best):
    """K14's operations for rays o, d (N, 3) whose closest hits are t_best
    (inf on a miss), as these inputs need them (OPS): per ray its set-up
    and every supertile's slab test, 16 tile slab tests in each supertile
    it enters before t_best, 4 leaf slab tests in each tile it enters
    before t_best, and Moller-Trumbore against the 32 triangles of each
    leaf it enters before t_best, up to the determinant, up to b1 or in
    full, as far as each triangle goes. Returns (operations, supertiles,
    tiles and leaves the rays enter, and the tiles that at least one ray
    of a warp of 32 and of a block of 128 consecutive rays enters: the
    previous K14, which culled by block and warp votes, ran the triangle
    loop on a warp's and staged a block's; `_mesh_work` reads what the
    kernel of one thread a ray does)."""
    import torch

    def enters(box, o, inv, t):
        t0 = (box[None, :, 0:3] - o[:, None]) * inv[:, None]
        t1 = (box[None, :, 4:7] - o[:, None]) * inv[:, None]
        tn = torch.minimum(t0, t1).amax(-1)
        tf = torch.maximum(t0, t1).amin(-1)
        return (tf >= tn.clamp(min=0.0)) & (tn < t[:, None])

    def mt_ops(o, d, recs):
        """Operations of Moller-Trumbore of rays o, d (P, 3) against the
        leaves' triangles recs (P, 32, 12), stopping where K14 stops."""
        v0, e1, e2 = recs[..., 0:3], recs[..., 3:6], recs[..., 6:9]
        p = torch.cross(d[:, None].expand_as(e2), e2, dim=-1)
        det = (e1 * p).sum(-1)
        u = ((o[:, None] - v0) * p).sum(-1) / det
        ok = det.abs() > 1e-12
        full = ok & (u >= 0.0) & (u <= 1.0)
        return (int((~ok).sum()) * OPS["mt_det"]
                + int((ok & ~full).sum()) * OPS["mt_u"]
                + int(full.sum()) * OPS["mt"])

    n_super, n_tiles = tables.super_boxes.shape[0], tables.boxes.shape[0]
    n_leaves = tables.leaves.shape[0]
    leaf_recs = tables.tris.reshape(n_leaves, -1, 12)
    step = max(128, (1 << 24) // n_leaves // 128 * 128)
    supers = tiles = leaves = warp_tiles = block_tiles = tri_ops = 0
    with torch.no_grad():
        for r0 in range(0, o.shape[0], step):
            oc, tc = o[r0:r0 + step], t_best[r0:r0 + step]
            dc = d[r0:r0 + step]
            inv = 1.0 / torch.where(dc == 0.0, 1e-20, dc)
            sup = enters(tables.super_boxes, oc, inv, tc)
            tile = enters(tables.boxes, oc, inv, tc) & sup.repeat_interleave(
                MESH_SUPER, 1)
            leaf = enters(tables.leaves, oc, inv, tc) & \
                tile.repeat_interleave(n_leaves // n_tiles, 1)
            supers += int(sup.sum())
            tiles += int(tile.sum())
            leaves += int(leaf.sum())
            warp_tiles += int(tile.reshape(-1, 32, n_tiles).any(1).sum())
            block_tiles += int(tile.reshape(-1, 128, n_tiles).any(1).sum())
            ray, lf = leaf.nonzero(as_tuple=True)
            for p0 in range(0, ray.shape[0], 1 << 16):
                r_, l_ = ray[p0:p0 + (1 << 16)], lf[p0:p0 + (1 << 16)]
                tri_ops += mt_ops(oc[r_], dc[r_], leaf_recs[l_])
    o_ = OPS
    ops = (o.shape[0] * (o_["ray_setup"] + n_super * o_["slab"])
           + supers * MESH_SUPER * o_["slab"]
           + tiles * (n_leaves // n_tiles) * o_["slab"] + tri_ops)
    return ops, supers, tiles, leaves, warp_tiles, block_tiles


def _mesh_work(tables, o, d):
    """K14's work as the kernel does it, read from the kernel itself (its
    per-ray counts of the tiles and the leaves it tests, in its
    nearest-first order against its running best): their means over rays,
    and the means over warps of 32 consecutive rays of the largest count
    of their lanes (a warp runs its tile loop on the largest tile count;
    its leaf loops on at least the largest leaf count)."""
    from tpusky_torch.ops.cuda import mesh_kernel as MKT
    tested = MKT.launch(tables, o, d, work=True)[4].float()
    n = tested.shape[0] // 32 * 32
    warp = tested[:n].reshape(-1, 32, 2).amax(1).mean(0)
    mean = tested.mean(0)
    return (float(mean[0]), float(warp[0]), float(mean[1]),
            float(warp[1]))


def _tie_mesh(mesh, rng):
    """mesh's tiles, then a copy of them in a random tile order, built
    directly (make_mesh_table's Morton order would put each copy beside
    its original): every hit ties with its copy, the original has the
    lower index, and the copy's supertiles, each of tiles from all over
    the mesh, are often entered first."""
    import torch
    from tpusky_torch.render import mesh as TM
    n_t = mesh.v0.shape[0] // 128
    perm = torch.tensor(rng.permutation(n_t), device=mesh.v0.device)

    def dup(x):
        if x is None:
            return None
        xt = x.reshape((n_t, 128) + x.shape[1:])
        return torch.cat([xt, xt[perm]]).reshape((-1,) + x.shape[1:])
    return TM.MeshTable(*(dup(x) for x in mesh))


def _flat_tie_case(rng, dev, n):
    """A ground quad (z = 0) in tile 0 and its copy in tile 16: supertile 0
    holds the quad and 15 tiles of small triangles below it, supertile 1
    the copy and 15 tiles of small triangles above it, so a ray from above
    enters supertile 1 first, finds the copy at t, and must still take
    the quad at the same t from a box whose entry is t itself (the cull
    is at entry > best, not >=). -> (mesh, o, d) with n rays from above
    toward the quad."""
    import torch
    from tpusky_torch.render import mesh as TM

    def tile(v):                      # (k, 3, 3) corners -> padded tile
        k = v.shape[0]
        v0, e1, e2 = (np.zeros((128, 3), np.float32) for _ in range(3))
        v0[:k], e1[:k], e2[:k] = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
        return v0, e1, e2, np.arange(128) < k

    def small(z0, z1):
        c = rng.uniform([-2, -2, z0], [2, 2, z1], (128, 1, 3))
        return (c + rng.normal(scale=0.01, size=(128, 3, 3))).astype(
            np.float32)
    quad = np.array([[[-2, -2, 0], [2, -2, 0], [2, 2, 0]],
                     [[-2, -2, 0], [2, 2, 0], [-2, 2, 0]]], np.float32)
    tiles = ([tile(quad)] + [tile(small(-3.0, -0.5)) for _ in range(15)]
             + [tile(quad)] + [tile(small(0.5, 1.0)) for _ in range(15)])
    v0, e1, e2, valid = (torch.tensor(np.concatenate(x), device=dev)
                         for x in zip(*tiles))
    z = torch.zeros_like(v0)
    mesh = TM.MeshTable(v0, e1, e2, z, z, z,
                        torch.zeros_like(valid, dtype=torch.int64), valid,
                        torch.zeros((v0.shape[0], 3, 2), device=dev))
    o = rng.uniform([-1.5, -1.5, 2.0], [1.5, 1.5, 3.0], (n, 3))
    d = rng.uniform([-1.9, -1.9, 0.0], [1.9, 1.9, 0.0], (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return mesh, *(torch.tensor(x.astype(np.float32), device=dev)
                   for x in (o, d))


def mesh_tie_phase(dev, waves, rng):
    """Phase 9a's tie cases: K14 equals its plain version on every ray,
    direct and after the wavefront sort (hit, t, b1, b2, ids bitwise), and
    returns the lower index on every tied ray."""
    import torch
    from tpusky_torch.ops.cuda import mesh_kernel as MKT
    from tpusky_torch.render import mesh as TM
    from tpusky_torch.utils.meshio import icosphere
    pos, idx = icosphere(TIE_SUBDIV)
    sphere = _tie_mesh(TM.make_mesh_table(
        [dict(positions=pos, indices=idx, normals=pos.copy(), bsdf_idx=0)],
        device=dev), rng)
    flat, o_f, d_f = _flat_tie_case(rng, dev, MESH_RAYS)
    cases = [(f"K14 tie, icosphere({TIE_SUBDIV}) + its copy, {kind}",
              sphere, o, d) for kind, (o, d) in waves.items()]
    cases.append(("K14 tie, a ground quad and its copy", flat, o_f, d_f))
    for tag, mesh, o, d in cases:
        tables = MKT.mesh_tables(mesh)
        t_p, b1_p, b2_p, tri_p = TM._closest_plain(mesh, o, d)
        order, inv = TM._ray_sort_order(mesh, o, d,
                                        (tables.key_lo, tables.key_hi))
        direct = MKT.mesh_intersect_kernel(mesh, o, d, tables)
        sorted_ = [x[inv] for x in MKT.mesh_intersect_kernel(
            mesh, o[order].contiguous(), d[order].contiguous(), tables)]
        for how, (t, b1, b2, tri, hit) in (("direct", direct),
                                           ("sorted", sorted_)):
            same = ((t == t_p) | (torch.isinf(t) & torch.isinf(t_p)))
            same &= (b1 == b1_p) & (b2 == b2_p) & (tri.long() == tri_p)
            _count_outside(f"{tag}, {how}: rays differing from plain",
                           (~same).float(), 0.5, o.shape[0], cap=0.0)
        # the originals: the quad's triangles 0 and 1 (their copies 2048
        # and 2049), the sphere's first half
        n_orig = 2 if mesh is flat else mesh.v0.shape[0] // 2
        tied = (tri_p >= 0) & ((tri_p % 2048 <= 1) if mesh is flat else True)
        n_tied = int(tied.sum())
        lower = min(int((x[3].long() < n_orig)[tied].sum())
                    for x in (direct, sorted_))
        print(f"check {tag}: the lower index on {lower} of {n_tied} tied "
              f"rays")
        if lower != n_tied or n_tied < o.shape[0] // 10:
            raise AssertionError(f"{tag}: tie rule")
        del tables, direct, sorted_, t_p, b1_p, b2_p, tri_p


def _mesh_scene(state, n_subdiv, device):
    """tools/gen_scene_goldens.py::scene_mesh_gi: an icosphere with vertex
    normals at (0, 0, 1) on a 20x20 diffuse ground under the sunsky, seen
    by a 45-degree camera at [3.5, -3.5, 2] looking at [0, 0, 1]."""
    from tpusky_torch.render.scene import make_scene
    from tpusky_torch.render.sensors import make_perspective
    from tpusky_torch.utils.meshio import icosphere
    pos, idx = icosphere(n_subdiv)
    t2w = np.eye(4, dtype=np.float32)
    t2w[2, 3] = 1.0
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    scene = make_scene(
        shapes=[dict(kind=1, to_world=ground, bsdf_idx=0)],
        bsdf_albedos=[[0.5, 0.5, 0.5], [0.3, 0.5, 0.7]],
        meshes=[dict(positions=pos, indices=idx, normals=pos.copy(),
                     to_world=t2w, bsdf_idx=1)], env=state, device=device)
    sensor = make_perspective([3.5, -3.5, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device=device)
    return scene, sensor


def mesh_kernel_phase(dev, card):
    """Phase 9a: K14 against its plain version on icosphere meshes of
    MESH_SUBDIV subdivisions, on bench_mesh's coherent and incoherent
    wavefronts of MESH_RAYS rays, direct and after the wavefront sort. The
    plain version runs on a strided MESH_SUBSET-ray subset of each
    wavefront (on all of them for the frame's mesh and the incoherent
    wavefront, whose numbers stand in the kernels line); mesh_test on the
    subset. Prints each case's times, bound and work, the previous
    kernel's times beside;
    then the tie cases (`mesh_tie_phase`). Returns (max abs error, (ms,
    plain ms), (bound ms, by)) of the frame's mesh and the incoherent
    wavefront, sorted."""
    import torch
    from tpusky_torch.ops.cuda import mesh_kernel as MKT
    from tpusky_torch.render import mesh as TM
    from tpusky_torch.utils.meshio import icosphere
    rng = np.random.default_rng(14)
    waves = _mesh_wavefronts(rng, dev)
    maxt = torch.tensor(rng.uniform(0.0, 4.0, MESH_RAYS).astype(np.float32),
                        device=dev)
    err, line = 0.0, None
    for n_subdiv in MESH_SUBDIV:
        pos, idx = icosphere(n_subdiv)
        mesh = TM.make_mesh_table([dict(positions=pos, indices=idx,
                                        normals=pos.copy(), bsdf_idx=0)],
                                  device=dev)
        n_tris = len(idx)
        tables = MKT.mesh_tables(mesh)
        for kind, (o, d) in waves.items():
            tag = f"K14 {n_tris} triangles, {kind}"
            t, b1, b2, tri, hit = MKT.mesh_intersect_kernel(mesh, o, d,
                                                            tables)
            order, inv = TM._ray_sort_order(mesh, o, d)
            o_s, d_s = o[order].contiguous(), d[order].contiguous()
            sorted_ = [x[inv] for x in MKT.mesh_intersect_kernel(
                mesh, o_s, d_s, tables)]
            torch.cuda.synchronize()
            # the sorted query returns the direct one's results
            same = ((sorted_[0] == t) | (torch.isinf(sorted_[0])
                                          & torch.isinf(t)))
            same &= (sorted_[3] == tri) & (sorted_[4] == hit)
            _count_outside(f"{tag}: sorted vs direct",
                           (~same).float(), 0.5, MESH_RAYS)
            full = n_subdiv == FRAME_SUBDIV and kind == "incoherent"
            sel = (torch.arange(MESH_RAYS, device=dev) if full else
                   torch.arange(0, MESH_RAYS, MESH_RAYS // MESH_SUBSET,
                                device=dev))
            n_sel = sel.shape[0]
            res = []
            plain_ms = _median_ms(lambda: res.append(TM._closest_plain(
                mesh, o[sel], d[sel])), reps=1, warmup=0)
            t_p, b1_p, b2_p, tri_p = res[0]
            hit_p = torch.isfinite(t_p) & (tri_p >= 0)
            _count_outside(f"{tag}: hit vs plain",
                           (hit[sel] != hit_p).float(), 0.5, n_sel)
            both = hit[sel] & hit_p
            rel_t = _rel(t[sel][both], t_p[both], 0.0)
            _count_outside(f"{tag}: t vs plain (relative, both hit)", rel_t,
                           1e-5, n_sel)
            db = torch.maximum((b1[sel] - b1_p).abs(),
                               (b2[sel] - b2_p).abs())[both]
            _count_outside(f"{tag}: b1, b2 vs plain (both hit)", db, 1e-4,
                           n_sel)
            tri_eq = float((tri[sel].long()[both] == tri_p[both])
                           .float().mean())
            print(f"check {tag}: tri equal on {tri_eq:.6f} of "
                  f"{int(both.sum())} hits (bar 0.999)")
            if not tri_eq >= 0.999:
                raise AssertionError(f"{tag}: triangle ids")
            occ = TM.mesh_test(mesh, o, d, maxt)
            sub = torch.arange(0, MESH_RAYS, MESH_RAYS // MESH_SUBSET,
                               device=dev)
            occ_p = TM._occluded_plain(mesh, o[sub], d[sub], maxt[sub])
            _count_outside(f"{tag}: mesh_test vs plain",
                           (occ[sub] != occ_p).float(), 0.5, MESH_SUBSET)
            if bool(both.any()):
                err = max(err, float((t[sel][both] - t_p[both]).abs().max()),
                          float(db.max()))
            del res, t_p, b1_p, b2_p, tri_p, hit_p, occ, occ_p

            ms = _median_ms(lambda: MKT.launch(tables, o, d))
            ms_s = _median_ms(lambda: MKT.launch(tables, o_s, d_s))
            ms_path = _median_ms(lambda: TM._closest(mesh, o, d, False,
                                                     tables))
            ops, supers, tiles, leaves, warp_tiles, block_tiles = _mesh_ops(
                tables, o_s, d_s, t[order].contiguous())
            ray_tiles, warp_tiles_k, ray_leaves, warp_leaves_k = _mesh_work(
                tables, o_s, d_s)
            nbytes = (40 * MESH_RAYS
                      + sum(x.numel() * 4 for x in tables[:4]))
            bound = _bound(nbytes, ops)
            prev = PREV_K14_MS[(n_tris, kind)]
            print(f"time {tag}: direct {ms:.3f} ms "
                  f"({MESH_RAYS / ms / 1e3:.1f} M rays/s), sorted "
                  f"{ms_s:.3f} ms ({MESH_RAYS / ms_s / 1e3:.1f} M rays/s), "
                  f"sort + kernel + unsort {ms_path:.3f} ms "
                  f"({MESH_RAYS / ms_path / 1e3:.1f} M rays/s); plain "
                  f"{plain_ms:.1f} ms at {n_sel} rays; the previous "
                  f"kernel: direct {prev[0]:.3f} ms, sorted {prev[1]:.3f} "
                  f"ms [{card}]")
            print(f"bound {tag}, sorted: {bound[0]:.4f} ms ({bound[1]}; "
                  f"{hit.float().mean():.3f} of rays hit, a ray enters "
                  f"{supers / MESH_RAYS:.2f} supertiles, "
                  f"{tiles / MESH_RAYS:.2f} tiles and "
                  f"{leaves / MESH_RAYS:.2f} leaves before its hit), "
                  f"{100 * bound[0] / ms_s:.1f}% of it; the tiles a warp of "
                  f"32 sorted rays enters: >= "
                  f"{32 * warp_tiles / MESH_RAYS:.2f} (the previous "
                  f"kernel's warp ran its "
                  f"128-triangle loop on these), a block of 128 >= "
                  f"{128 * block_tiles / MESH_RAYS:.2f}; in K14's own "
                  f"nearest-first order a ray tests {ray_tiles:.2f} tiles "
                  f"and {ray_leaves:.2f} leaves of 32 triangles, a warp "
                  f"runs its tile loop on {warp_tiles_k:.2f} tiles and its "
                  f"leaf loops on >= {warp_leaves_k:.2f} leaves, the "
                  f"largest of its lanes' [{card}]")
            if full:
                line = ((ms_s, plain_ms), bound)
            del o_s, d_s, sorted_, t, b1, b2, tri, hit
        del mesh, tables
    mesh_tie_phase(dev, waves, rng)
    return err, line


def _profile_window(name, fn, card, iters=2,
                    focus=(("K14", "mesh_isect_kernel"),)):
    """Where one call of fn spends the card's time: a torch.profiler window
    of iters calls after a warm-up; prints the wall time, the device's
    busy share, the device time of each (label, kernel name pattern) in
    `focus` with its share of the busy time, and the 12 largest
    device-time entries. It records the device's activity alone: the
    host's ops would add several events a launch to the profiler's
    bookkeeping, tens of seconds for a frame of 60,000 launches. Returns
    the busy share."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile

    def device_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0) / iters
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels) / iters

    def kernel_ms(kernel):
        pattern = re.compile(rf"\b{kernel}\b")
        return sum(e.device_time_total for e in kernels
                   if pattern.search(e.name)) / iters / 1e3
    parts = ", ".join(
        f"{label} {kernel_ms(kernel):.3f} ms "
        f"({100 * 1e3 * kernel_ms(kernel) / max(busy_us, 1e-9):.1f}% of "
        "the busy time)" for label, kernel in focus)
    print(f"profile {name}: wall {wall_us / 1e3:.2f} ms a call, device busy "
          f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), of "
          f"which {parts}; {len(kernels) // iters} kernel launches a call "
          f"[{card}]")
    rows = sorted(prof.key_averages(), key=device_us, reverse=True)
    for e in rows[:12]:
        print(f"profile   {device_us(e) / iters / 1e3:9.3f} ms "
              f"{e.count // iters:6d}x  {e.key[:80]}")
    return busy_us / wall_us


def mesh_frame_phase(dev, card):
    """Phase 9b: scene_mesh_gi at icosphere(FRAME_SUBDIV) through render()
    at H x W x SPP, depth MESH_DEPTH, with the launch counts of that run;
    a band of rows against the plain path on the card, a crop against the
    CPU's plain render; then the frame's time and a profiler window of it.
    Returns (K14's launches, the band's max abs error)."""
    import torch
    import tpusky_torch as tt
    from tpusky_torch.ops.cuda import build
    from tpusky_torch.ops.cuda import mesh_kernel as MKT
    from tpusky_torch.render import integrator
    from tpusky_torch.render import mesh as TM
    from tpusky_torch.render.film import Film
    from tpusky_torch.render.scene import with_mesh_tables
    from tpusky_torch.render.sensors import sample_ray
    film = Film(H, W, 3)
    params = dict(turbidity=3.0, albedo=0.3, sun_direction=SUN)
    scene, sensor = _mesh_scene(tt.sunsky_precompute(
        tt.make_params(**params, device=dev)), FRAME_SUBDIV, dev)
    torch.cuda.synchronize()
    build.reset_launches()
    MKT.builds = 0
    t0 = time.perf_counter()
    img = integrator.render(scene, sensor, film, SEED, spp=SPP,
                            max_depth=MESH_DEPTH)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(build.launches)
    print(f"mesh main path: {main_s:.2f} s, launches {launches}, K14's "
          f"tables built {MKT.builds} times")
    if MKT.builds != 1:
        raise AssertionError(f"render() built K14's tables {MKT.builds} "
                             "times, not once")
    # per spp chunk of render_rows (2 of 2^20 lanes at 512x512x8), 3
    # closest-hit queries and 2 shadow queries
    chunks = SPP // min(SPP, (1 << 20) // (H * W))
    want = chunks * (MESH_DEPTH + (MESH_DEPTH - 1))
    if launches["mesh_intersect"] != want:
        raise AssertionError(f"K14 launched {launches['mesh_intersect']} "
                             f"times, not {want}")
    for name in ("sunsky_hit_rgb", "sunsky_nee_rgb"):
        if launches[name] <= 0:
            raise AssertionError(f"the mesh frame never launched {name}")
    if launches["direct_rgb_megakernel"] != 0:
        raise AssertionError("the mesh frame went through K4")
    if not (img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
            and float(img.mean()) > 0.0):
        raise AssertionError("mesh render: image not finite, shaped or lit")
    with torch.no_grad():
        px = torch.arange(H * W, device=dev)
        uv = torch.stack([(px % W + 0.5) / W, (px // W + 0.5) / H], -1)
        cam_hit = float(TM.mesh_intersect(scene.mesh, *sample_ray(sensor, uv))
                        [6].float().mean())
    print(f"mesh image: mean {float(img.mean()):.5f} max "
          f"{float(img.max()):.3f}; {cam_hit:.4f} of camera rays hit the "
          f"mesh")
    if not cam_hit >= 0.1:
        raise AssertionError("too few camera rays hit the mesh")

    row0, n_rows = MESH_BAND
    lanes_k = integrator._lane_radiance(with_mesh_tables(scene), sensor,
                                        film, SEED, SPP, 0, SPP, MESH_DEPTH,
                                        1000, "rgb", row0, n_rows)
    lanes_p = integrator._lane_radiance(scene, sensor, film, SEED, SPP, 0,
                                        SPP, MESH_DEPTH, 1000, "rgb", row0,
                                        n_rows, plain=True)
    rel = (lanes_k - lanes_p).abs().amax(-1) / \
        lanes_p.abs().clamp(min=1e-3).amax(-1)
    share = float((rel > 1e-3).float().mean())
    print(f"check mesh frame rows {row0}-{row0 + n_rows}: {share:.2e} of "
          f"{rel.shape[0]} lanes outside 1e-3 (bar 1e-3), max "
          f"{float(rel.max()):.3e}")
    if not share <= 1e-3:
        raise AssertionError("the mesh frame disagrees with the plain path")
    err = float((lanes_k - lanes_p).abs().max())
    del lanes_k, lanes_p, rel

    x0, y0, cw, ch = MESH_CROP
    crop = Film(H, W, 3, crop_offset=(x0, y0), crop_size=(cw, ch))
    scene_c, sensor_c = _mesh_scene(tt.sunsky_precompute(
        tt.make_params(**params, device="cpu")), FRAME_SUBDIV, "cpu")
    img_k = integrator.render(scene, sensor, crop, SEED, spp=MESH_CROP_SPP,
                              max_depth=MESH_DEPTH).cpu()
    t0 = time.perf_counter()
    img_c = integrator.render(scene_c, sensor_c, crop, SEED,
                              spp=MESH_CROP_SPP, max_depth=MESH_DEPTH)
    cpu_s = time.perf_counter() - t0
    err_c = float((img_k - img_c).abs().max())
    print(f"check mesh frame vs CPU plain, crop {MESH_CROP} at "
          f"{MESH_CROP_SPP} spp: max {err_c:.3e} (image max there "
          f"{float(img_c.max()):.3f}; the CPU took {cpu_s:.1f} s)")
    if not (err_c < 1e-3 * max(float(img_c.max()), 1.0)
            and float(img_c.max()) > 0):
        raise AssertionError("the mesh frame disagrees with the CPU")

    def frame_s():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        integrator.render(scene, sensor, film, SEED, spp=SPP,
                          max_depth=MESH_DEPTH)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    frame_s()
    frame_ms = 1e3 * float(np.median([frame_s() for _ in range(5)]))
    _profile_window("scene_mesh_gi frame", lambda: integrator.render(
        scene, sensor, film, SEED, spp=SPP, max_depth=MESH_DEPTH), card)
    rays = H * W * SPP * (2 * MESH_DEPTH - 1)
    print(f"time scene_mesh_gi frame ({W}x{H}x{SPP}, depth {MESH_DEPTH}, "
          f"{int(scene.mesh.valid.sum())} "
          f"triangles, {rays} rays): render() {frame_ms:.3f} ms "
          f"({rays / frame_ms / 1e3:.2f} M rays/s) [{card}]")
    return launches["mesh_intersect"], err


# phases 11-14: the sunsky goldens, chi-square at the reference's scale,
# the scene goldens' Z-tests and the recovery recipe
RGB_GOLDENS = ((9.5, 2.0, 0.2, "sky_rgb_hour9.50_t2.000_a0.200"),
               (12.25, 5.2, 0.0, "sky_rgb_hour12.25_t5.200_a0.000"),
               (18.3, 9.8, 0.5, "sky_rgb_hour18.30_t9.800_a0.500"))
SPEC_GOLDENS = ((2.0, 2.0, "sky_spec_eta0.035_t2.000_a0.000"),
                (20.0, 5.2, "sky_spec_eta0.349_t5.200_a0.000"),
                (45.0, 9.8, "sky_spec_eta0.785_t9.800_a0.000"))
SIN_OFFSET = 0.00775        # the reference's cropped sphere (chi2_tpu.py)
CHI2_N = 100_000_000
CHI2_RES = 215
CHI2_IRES = 64
CHI2_BATCH = 4_000_000
GOLDEN_SPP = 64
GOLDEN_SEED = 1234
RECOVERY_ITERS = 320


def _counted(fn):
    """fn() with the launch counts set to 0 just before it -> (its result,
    the counts read just after)."""
    from tpusky_torch.ops.cuda import build
    build.reset_launches()
    out = fn()
    return out, dict(build.launches)


def _require(counts, names, what):
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"{what} never launched {name}")


def sky_golden_phase(dev):
    """The reference's sky goldens on the card: RGB through `sunsky_params`
    (the port's astronomy) and K1 at a mean relative error <= 0.017, the
    spectral ones through K9 at <= 0.037; `sunsky_params` on the card
    equals the CPU's."""
    import torch
    import tpusky_torch as tt
    here = os.path.dirname(os.path.abspath(__file__))
    with np.load(os.path.join(here, "tests", "golden",
                              "sunsky_golden.npz")) as z:
        gold = dict(z)
    h, w = 32, 64
    pg, tg = np.meshgrid(np.linspace(0, 2 * np.pi, w),
                         np.linspace(np.pi, 0, h))
    dirs = torch.tensor(-np.stack([np.cos(pg) * np.sin(tg),
                                   np.sin(pg) * np.sin(tg), np.cos(tg)],
                                  -1).astype(np.float32), device=dev)

    def mean_rel(img, ref):
        return float(np.mean(np.abs(img - ref) / (np.abs(ref) + 0.001)))

    def rgb():
        out = []
        for hour, turb, albedo, key in RGB_GOLDENS:
            kw = dict(turbidity=turb, albedo=albedo, hour=hour, sun_scale=0.0)
            p = tt.sunsky_params(device=dev, **kw)
            q = tt.sunsky_params(device="cpu", **kw)
            if not all(torch.equal(a.cpu(), b) for a, b in zip(p, q)):
                raise AssertionError("sunsky_params on the card differs from "
                                     "the CPU's")
            img = tt.sunsky_eval(tt.sunsky_precompute(p), dirs)
            out.append((key, hour, mean_rel(img.cpu().numpy(), gold[key])))
        return out

    wl = torch.tensor(np.broadcast_to(np.array(
        [360 + 47 / 2 + i * 47 for i in range(10)], np.float32),
        (h, w, 10)).copy(), device=dev)

    def spectral():
        out = []
        for eta, turb, key in SPEC_GOLDENS:
            st = np.pi / 2 - np.deg2rad(eta)
            p = tt.make_params(turbidity=turb, albedo=0.0,
                               sun_direction=[np.sin(st), 0.0, np.cos(st)],
                               sun_scale=0.0, mode="spectral", device=dev)
            img = tt.sunsky_eval(tt.sunsky_precompute(p), dirs,
                                 mode="spectral", wavelengths=wl)
            out.append((key, mean_rel(img.cpu().numpy(), gold[key])))
        return out

    errs, counts = _counted(rgb)
    _require(counts, ("sunsky_eval_rgb",), "the RGB sky goldens")
    for key, hour, err in errs:
        print(f"check RGB golden {key} (sunsky_params(hour={hour}), K1): "
              f"mean relative error {err:.5f} (bar 0.017)")
        if not err <= 0.017:
            raise AssertionError(f"RGB golden {key}: {err:.5f}")
    errs, counts = _counted(spectral)
    _require(counts, ("sunsky_eval_spec",), "the spectral sky goldens")
    for key, err in errs:
        print(f"check spectral golden {key} (K9): mean relative error "
              f"{err:.5f} (bar 0.037)")
        if not err <= 0.037:
            raise AssertionError(f"spectral golden {key}: {err:.5f}")


def chi2_phase(dev, card):
    """tools/chi2_tpu.py's six configurations at the reference's scale
    (N = 1e8, 430 x 215 cells of the cropped sphere, the pdf integrated at
    64 x 64 points a cell): directions from K3 (`sample_eval`), the pdf
    through K2 (`eval_pdf`); then one configuration through the plain
    `sample_direction` / `pdf_direction`. Each must reach p >= 0.01."""
    import torch
    import tpusky_torch as tt
    from tpusky_torch.models.sunsky import model as M
    from tpusky_torch.utils.chi2 import chi2_test

    def state_of(turb, theta_deg, sun_scale, aperture=None):
        th, ph = np.deg2rad(theta_deg), -4 * np.pi / 5
        kw = {} if aperture is None else {"sun_aperture_deg": aperture}
        return tt.sunsky_precompute(tt.make_params(
            turbidity=turb, albedo=0.5,
            sun_direction=[np.cos(ph) * np.sin(th), np.sin(ph) * np.sin(th),
                           np.cos(th)], sun_scale=sun_scale, device=dev,
            **kw))

    configs = [(f"sky_t{t}_theta{e}", state_of(t, e, 0.0), False)
               for t in (2.2, 6.0) for e in (20, 50)]
    configs += [(f"sunsky_t{t}_aperture30", state_of(t, 50, 1.0, 30.0),
                 False) for t in (2.2, 6.0)]
    configs.append(("sunsky_t2.2_aperture30, plain",
                    state_of(2.2, 50, 1.0, 30.0), True))
    cos_range = (0.0, float(np.sqrt(1 - SIN_OFFSET ** 2)))
    for name, state, plain in configs:
        def sample_fn(batch_seed, n, state=state, plain=plain):
            u = torch.rand(n, 2, device=dev, generator=torch.Generator(
                device=dev).manual_seed(batch_seed))
            if plain:
                return M.sample_direction(state, u)[0]
            return M.sample_eval(state, u)[0]

        def pdf_fn(d, state=state, plain=plain):
            if plain:
                return M.pdf_direction(state, d)
            return M.eval_pdf(state, d)[1]

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (p, ok, info), counts = _counted(lambda: chi2_test(
            sample_fn, pdf_fn, seed=0, sample_count=CHI2_N,
            res_phi=2 * CHI2_RES, res_cos=CHI2_RES, cos_range=cos_range,
            ires=CHI2_IRES, batch=CHI2_BATCH))
        secs = time.perf_counter() - t0
        how = ("plain" if plain else
               f"K3 x{counts['sunsky_nee_rgb']}, K2 x{counts['sunsky_hit_rgb']}")
        print(f"check chi2 {name} ({how}): p {p:.4f} (bar 0.01), stat "
              f"{info['stat']:.1f}, dof {info['dof']}, integral "
              f"{info['integral']:.6f}, outside {info['miss_frac']:.2e}, "
              f"{secs:.1f} s [{card}]")
        if not plain:
            _require(counts, ("sunsky_nee_rgb", "sunsky_hit_rgb"),
                     f"chi2 {name}")
        if not ok:
            raise AssertionError(f"chi2 {name}: p = {p:.4g}")


def golden_ztest_phase(dev):
    """The port's 48x48 renders at 64 spp of the ten scene goldens
    (`tools/torch_scene_goldens.py`) Z-tested against
    tests/golden/scene_goldens.npz: sunsky_sphere and sky_only through
    render() (K4), rough_conductor (depth 4, the wavefront: K2, K3),
    spectral_plane (K10, K11), mesh_gi (K14), and constant_cube_gi,
    area_light, dielectric_sphere, envmap_lit and medium_sphere (a
    homogeneous medium, depth 6), which have no sunsky:
    their wavefront is plain ops on the card and launches no kernel; then
    render_moments' mean against render_rows' image at the same seed,
    bitwise."""
    import torch
    from tools.torch_scene_goldens import SCENES, build, golden
    from tpusky_torch.render import integrator
    from tpusky_torch.render.film import Film, develop
    from tpusky_torch.utils.ztest import z_test
    kernels = {"sunsky_sphere": ("direct_rgb_megakernel",),
               "sky_only": ("direct_rgb_megakernel",),
               "rough_conductor": ("sunsky_hit_rgb", "sunsky_nee_rgb"),
               "spectral_plane": ("sunsky_hit_spec", "sunsky_nee_spec"),
               "mesh_gi": ("mesh_intersect",),
               "constant_cube_gi": (), "area_light": (),
               "dielectric_sphere": (), "envmap_lit": (),
               "medium_sphere": ()}
    for name in SCENES:
        scene, sensor, depth, mode = build(name, dev)
        mean, var, size, gold_depth = golden(name)
        if gold_depth != depth:
            raise AssertionError(f"{name}: depth {depth}, golden's "
                                 f"{gold_depth}")
        img, counts = _counted(lambda: integrator.render(
            scene, sensor, Film(size, size, 3), GOLDEN_SEED, spp=GOLDEN_SPP,
            max_depth=depth, mode=mode))
        _require(counts, kernels[name], f"the {name} golden")
        if not kernels[name] and any(counts.values()):
            raise AssertionError(f"the {name} golden launched {counts}")
        ok, n_failed, min_p, alpha = z_test(img.cpu().numpy(), GOLDEN_SPP,
                                            mean, var)
        print(f"check Z-test {name} "
              f"({', '.join(kernels[name]) or 'plain ops, no kernel'}): "
              f"{n_failed} of {size * size * 3} pixel tests failed, min p "
              f"{min_p:.3g}, alpha_corr {alpha:.3g}")
        if not ok:
            raise AssertionError(f"{name} fails the golden Z-test")
    scene, sensor, depth, mode = build("sunsky_sphere", dev)
    film = Film(48, 48, 3)
    mean, m2 = integrator.render_moments(scene, sensor, film, GOLDEN_SEED,
                                         spp=GOLDEN_SPP, max_depth=depth)
    img = develop(integrator.render_rows(scene, sensor, film, GOLDEN_SEED,
                                         GOLDEN_SPP, depth, 1000, mode, 0,
                                         48))
    if not (torch.equal(mean, img) and bool((m2 >= 0).all())):
        raise AssertionError("render_moments' mean is not render_rows' image")
    print("check render_moments: its mean equals render_rows' image "
          "bitwise (48x48x64, sunsky_sphere)")


def recovery_phase(dev, card):
    """bench.py::bench_train's recovery of seed 0 at full size (512x512x8,
    320 iterations, the full grid): first the evaluation loss of three grid
    candidates through `_render_impl` (K4) against the loss the training
    step takes through `render_rows` (K2/K3) at the same point (1e-4
    relative); then the recipe, K4 counted over its evaluations and K5/K6
    over its steps, gated at r5's worst TPU accuracy (turbidity 0.2, sun
    0.52 degrees); then the gradient-only sun recovery from 5 degrees
    off, gated at 2 degrees."""
    import torch
    from tools.torch_recover import instrumented_recovery
    from tpusky_torch.ad import recovery as R
    from tpusky_torch.ops.cuda import build
    machinery = R.bench_train_machinery(dev, H, W, SPP, RECOVERY_ITERS)
    eval_fn, step, opt, n4, target_of, cands, t_grid = machinery
    target, crn = target_of(0)
    for sv in cands[:3]:
        pd = {"t": torch.tensor(t_grid[0], device=dev),
              "alb": torch.full((3,), 0.3, device=dev),
              "sun": torch.tensor(np.asarray(sv, np.float32), device=dev)}
        loss_k4, counts = _counted(lambda: float(eval_fn(pd, target, crn)))
        _require(counts, ("direct_rgb_megakernel",), "the evaluation loss")
        loss_w = float(step(opt.init(pd), pd, target, crn)[2])
        rel = abs(loss_k4 - loss_w) / abs(loss_w)
        print(f"check recovery eval loss at t {t_grid[0]}, sun "
              f"{np.round(sv, 4).tolist()}: K4 {loss_k4:.7e}, the step's "
              f"render_rows {loss_w:.7e}, relative {rel:.2e} (bar 1e-4)")
        if not rel <= 1e-4:
            raise AssertionError("K4's evaluation loss differs from the "
                                 "wavefront's")

    build.reset_launches()
    run = instrumented_recovery(0, machinery, RECOVERY_ITERS)
    counts = run["launches"]
    _require(counts["eval"], ("direct_rgb_megakernel",),
             "the recipe's evaluations")
    _require(counts["step"], ("sunsky_hit_rgb", "sunsky_nee_rgb",
                              "sunsky_eval_rgb_bwd", "sunsky_nee_rgb_bwd"),
             "the recipe's steps")
    step_s, t_err, ang = run["step_s"], run["t_err"], run["ang"]
    step_ms = 1e3 * sum(step_s[1:]) / (len(step_s) - 1)
    print(f"recovery seed 0 ({H}x{W}x{SPP}, {RECOVERY_ITERS} iterations): "
          f"turbidity {float(run['params']['t']):.4f}, error {t_err:.4f} "
          f"(bar 0.2; the TPU's r4 0.041, r5 0.199), sun error {ang:.4f} deg "
          f"(bar 0.52; TPU r4 0.239, r5 0.511); {len(step_s)} steps, mean of "
          f"steps 2-{len(step_s)} {step_ms:.2f} ms; wall {run['wall_s']:.1f} "
          f"s; peak memory {run['peak_gib']:.2f} GiB; K4 "
          f"x{counts['eval']['direct_rgb_megakernel']} over the evaluations, "
          f"K5 x{counts['step']['sunsky_eval_rgb_bwd']}, K6 "
          f"x{counts['step']['sunsky_nee_rgb_bwd']} over the steps [{card}]")
    if not (t_err <= 0.2 and ang <= 0.52):
        raise AssertionError("recovery seed 0 misses r5's TPU accuracy")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, counts = _counted(lambda: R.grad_only_sun_recovery(dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _require(counts, ("sunsky_hit_rgb", "sunsky_nee_rgb",
                      "sunsky_eval_rgb_bwd", "sunsky_nee_rgb_bwd"),
             "the gradient-only sun recovery")
    print(f"gradient-only sun recovery (256x256x8, {out['iters']} "
          f"iterations, from 5 deg): sun error {out['sun_err_deg']:.4f} deg "
          f"(bar 2.0; the TPU's r5 0.876), turbidity error "
          f"{out['turbidity_abs_err']:.4f}, loss {out['losses'][0]:.4e} -> "
          f"{out['losses'][-1]:.4e}; wall {wall:.1f} s [{card}]")
    if not out["sun_err_deg"] <= 2.0:
        raise AssertionError("the gradient-only sun recovery misses 2 deg")


# phase 15: the path tracer's breadth at full width
BREADTH_DEPTH = 6
BREADTH_RR = 3
BREADTH_TURNS = 3


def _breadth_scene(state, device):
    """The breadth frame's scene under the headline sunsky: on the
    headline ground a smooth dielectric sphere, a diffuse cube, a
    rough-conductor cylinder and a rectangle area panel facing down, lit
    by a point, a directional and a spot light (three delta lights, so
    one is sampled a vertex by weight), seen by the headline camera."""
    from tpusky_torch.render.bsdf import DIELECTRIC, DIFFUSE, ROUGH_CONDUCTOR
    from tpusky_torch.render.emitters import make_spot
    from tpusky_torch.render.scene import make_scene
    from tpusky_torch.render.sensors import make_perspective

    def at(scale, xyz):
        m = np.diag(list(scale) + [1.0]).astype(np.float32)
        m[:3, 3] = xyz
        return m
    panel = at([0.8, 0.8, 1.0], [0.0, -1.0, 3.0])
    panel[:3, :3] = panel[:3, :3] @ np.diag([1.0, -1.0, -1.0])
    shapes = [dict(kind=1, to_world=at([10.0, 10.0, 1.0], [0, 0, 0]),
                   bsdf_idx=0),
              dict(kind=0, to_world=at([0.8] * 3, [0.0, 0.0, 0.8]),
                   bsdf_idx=1),
              dict(kind=3, to_world=at([0.45] * 3, [1.6, 0.7, 0.45]),
                   bsdf_idx=2),
              dict(kind=4, to_world=at([0.4, 0.4, 1.4], [-1.5, 0.9, 0.0]),
                   bsdf_idx=3),
              dict(kind=1, to_world=panel, bsdf_idx=4, emitter_idx=0)]
    rad = np.zeros((len(shapes), 3), np.float32)
    rad[4] = [12.0, 10.0, 8.0]
    scene = make_scene(
        shapes=shapes,
        bsdf_albedos=[[0.4, 0.4, 0.4], [1.0, 1.0, 1.0], [0.7, 0.3, 0.2],
                      [0.9, 0.7, 0.4], [0.0, 0.0, 0.0]],
        bsdf_kinds=[DIFFUSE, DIELECTRIC, DIFFUSE, ROUGH_CONDUCTOR, DIFFUSE],
        bsdf_alphas=[0.1, 0.1, 0.1, 0.2, 0.1],
        bsdf_iors=[1.5, 1.5, 1.5, 1.5, 1.5], area_radiance=rad, env=state,
        point_lights=[[1.5, -1.5, 2.5, 8.0, 8.0, 8.0]],
        directional_lights=[[-0.3, 0.4, -0.85, 1.0, 0.9, 0.8]],
        spot_lights=[make_spot([-2.0, -2.0, 3.5], [0.45, 0.45, -0.77],
                               [40.0, 36.0, 32.0], cutoff_angle_deg=25.0,
                               device=device)],
        delta_light_weights=[1.0, 2.0, 1.5], device=device)
    sensor = make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device=device)
    return scene, sensor


def _wavefront_frame(label, scene, sensor, depth, rr_depth, turns, card):
    """A sunsky frame (H x W x SPP) through render() with the launch
    counts of that run: K2 and K3 must launch, K4 not; its lanes against
    the plain path's on the card (>= 99.9% within 1e-3), with the share
    of lanes whose Russian-roulette decision differs; render()'s wall
    time in turns with the plain path's, and a profiler window."""
    import torch
    from tpusky_torch.render import bsdf as B
    from tpusky_torch.render import integrator
    from tpusky_torch.render.film import Film
    film = Film(H, W, 3)
    kinds = B.table_kinds(scene.bsdfs)

    def frame(plain=False):
        if plain:
            return integrator.render_rows(
                scene, sensor, film, SEED, SPP, depth, rr_depth, "rgb", 0, H,
                kinds=kinds, plain=True)
        return integrator.render(scene, sensor, film, SEED, spp=SPP,
                                 max_depth=depth, rr_depth=rr_depth)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, launches = _counted(frame)
    torch.cuda.synchronize()
    print(f"{label}: {time.perf_counter() - t0:.2f} s (first call), kinds "
          f"{kinds}, launches {launches}")
    _require(launches, ("sunsky_hit_rgb", "sunsky_nee_rgb"), f"the {label}")
    if launches["direct_rgb_megakernel"] != 0:
        raise AssertionError(f"the {label} went through K4")
    if not (img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
            and float(img.mean()) > 0.0):
        raise AssertionError(f"{label}: image not finite, shaped or lit")
    logs = ([], [])
    with torch.no_grad():
        lanes_k, lanes_p = (integrator._lane_radiance(
            scene, sensor, film, SEED, SPP, 0, SPP, depth, rr_depth, "rgb",
            0, H, kinds=kinds, plain=plain, rr_log=log)
            for plain, log in ((False, logs[0]), (True, logs[1])))
        share, worst = _lanes_share(lanes_k, lanes_p)
        ended = [int(sum(m.sum() for m in log)) for log in logs]
        rr_diff = torch.zeros_like(logs[0][0])
        for a, b in zip(*logs):
            rr_diff |= a != b
        rr_share = float(rr_diff.float().mean())
    print(f"check {label} lanes: {share:.2e} of {lanes_p.shape[0]} lanes "
          f"outside 1e-3 of the plain path (bar 1e-3), max {worst:.3e}; "
          f"image mean {float(img.mean()):.5f} max {float(img.max()):.3f}; "
          f"Russian roulette ended {ended[0]} paths (plain {ended[1]}), its "
          f"decision differs on {rr_share:.2e} of the lanes")
    if not share <= 1e-3:
        raise AssertionError(f"the {label} disagrees with the plain path")
    del lanes_k, lanes_p, logs

    frame(True)
    ms, plain_ms, runs, plain_runs = _turns(frame, lambda: frame(True),
                                            turns)
    busy = _profile_window(label, frame, card, focus=(("K2", "hit_kernel"),
                                                      ("K3", "nee_kernel")))
    print(f"time {label} ({W}x{H}x{SPP}, depth {depth}, Russian roulette "
          f"from depth {rr_depth}): render() {ms:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in runs)}), plain path "
          f"{plain_ms:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in plain_runs)}), in turns; "
          f"{launches['sunsky_hit_rgb']} K2 and {launches['sunsky_nee_rgb']} "
          f"K3 launches a render(); device busy {100 * busy:.1f}% [{card}]")


def breadth_frame_phase(dev, card):
    """Phase 15: the breadth frame (depth BREADTH_DEPTH, Russian roulette
    from depth BREADTH_RR) held as `_wavefront_frame` holds a frame."""
    import tpusky_torch as tt
    state = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=SUN, device=dev))
    scene, sensor = _breadth_scene(state, dev)
    _wavefront_frame("breadth frame", scene, sensor, BREADTH_DEPTH,
                     BREADTH_RR, BREADTH_TURNS, card)


def _wall_ms(fn):
    """Host-clock ms of one call of fn, ending in a synchronise."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def _turns(fn_a, fn_b, turns):
    """Wall ms of fn_a and fn_b run in turns a, b, b, a, `turns` times ->
    (median a, median b, runs a, runs b)."""
    runs = ([], [])
    for _ in range(turns):
        for k in (0, 1, 1, 0):
            runs[k].append(_wall_ms((fn_a, fn_b)[k]))
    return (float(np.median(runs[0])), float(np.median(runs[1])), *runs)


def _lanes_share(lanes_k, lanes_p):
    """(share of lanes whose largest channel error relative to the plain
    lanes, floor 1e-3, exceeds 1e-3; that error's maximum)."""
    rel = (lanes_k - lanes_p).abs().amax(-1) / \
        lanes_p.abs().clamp(min=1e-3).amax(-1)
    return float((rel > 1e-3).float().mean()), float(rel.max())


# phase 16: the bitmap environment at full width
ENV_H, ENV_W = 1024, 2048
ENV_SUN = (np.deg2rad(50.0), np.deg2rad(-40.0))   # theta, phi of the disc
ENV_DISC = (np.deg2rad(1.2), np.deg2rad(1.6))     # flat, then a ramp to 0
ENV_DISC_RADIANCE = 3000.0
ENV_DEPTH = 2
ENV_CROP = (240, 200, 32, 32)


def _envmap_bitmap():
    """A (ENV_H, ENV_W, 3) sky from fixed constants: a gradient from a
    blue zenith to a pale horizon over a dark ground, and a bright disc
    about 3 degrees wide, which holds most of the map's power."""
    theta = (np.arange(ENV_H) + 0.5) / ENV_H * np.pi
    phi = (np.arange(ENV_W) + 0.5) / ENV_W * 2.0 * np.pi
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    d = np.stack([np.cos(phi)[None, :] * st, np.sin(phi)[None, :] * st,
                  np.broadcast_to(ct, (ENV_H, ENV_W))], -1)
    up = np.clip(ct, 0.0, 1.0)[..., None]
    sky = (np.array([0.9, 0.9, 0.85]) * (1.0 - up)
           + np.array([0.25, 0.45, 0.9]) * up)
    sky = np.where((ct < 0.0)[..., None],
                   np.array([0.08, 0.07, 0.06]), sky)
    s_th, s_ph = ENV_SUN
    sun = np.array([np.cos(s_ph) * np.sin(s_th), np.sin(s_ph) * np.sin(s_th),
                    np.cos(s_th)])
    ang = np.arccos(np.clip(d @ sun, -1.0, 1.0))
    disc = np.clip((ENV_DISC[1] - ang) / (ENV_DISC[1] - ENV_DISC[0]),
                   0.0, 1.0)
    return (sky + ENV_DISC_RADIANCE * disc[..., None]
            * np.array([1.0, 0.95, 0.85])).astype(np.float32)


def _envmap_scene(bitmap, device):
    """`envmap_lit`'s sphere and ground and camera
    (tools/torch_scene_goldens.py) under a bitmap, its envmap built on
    `device`."""
    from tools.torch_scene_goldens import scene_envmap_lit
    from tpusky_torch.render.emitters import make_envmap
    scene, sensor, _, _ = scene_envmap_lit(device)
    return scene._replace(env=make_envmap(bitmap, device=device)), sensor


def envmap_frame_phase(dev, card):
    """Phase 16: make_envmap of a 1024x2048 bitmap on the card (timed);
    envmap_lit's sphere and ground under it at H x W x SPP, depth 2,
    through render() (no sunsky: plain ops, no hand-written kernel, K4
    refused); a crop's lanes against the CPU's (>= 99.9% within 1e-3);
    EmitterAdapter's chi-square at N = 1e8 binned on the card (p >=
    0.01); the frame's time in turns, its launches and busy share."""
    import torch
    from tpusky_torch.render import integrator
    from tpusky_torch.render.emitters import make_envmap
    from tpusky_torch.render.film import Film
    from tpusky_torch.utils.chi2 import EmitterAdapter
    bitmap = _envmap_bitmap()
    make_envmap(bitmap, device=dev)
    make_ms = float(np.median([_wall_ms(lambda: make_envmap(
        bitmap, device=dev)) for _ in range(5)]))
    scene, sensor = _envmap_scene(bitmap, dev)
    lum = bitmap @ np.array([0.212671, 0.715160, 0.072169], np.float32)
    mass = lum * np.sin((np.arange(ENV_H) + 0.5) / ENV_H * np.pi)[:, None]
    disc = bitmap[..., 0] > 100.0
    print(f"envmap: {ENV_W}x{ENV_H} bitmap, make_envmap {make_ms:.3f} ms "
          f"(host copy and Bilinear2D tables on the card); the disc's "
          f"{int(disc.sum())} texels hold {mass[disc].sum() / mass.sum():.3f}"
          f" of the sampling mass [{card}]")
    film = Film(H, W, 3)

    def frame():
        return integrator.render(scene, sensor, film, SEED, spp=SPP,
                                 max_depth=ENV_DEPTH)

    def plain_frame():
        return integrator.render_rows(scene, sensor, film, SEED, SPP,
                                      ENV_DEPTH, 1000, "rgb", 0, H,
                                      kinds=((0,), False), plain=True)
    img, launches = _counted(frame)
    if any(launches.values()):
        raise AssertionError(f"the envmap frame launched {launches}")
    if not (img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
            and float(img.mean()) > 0.0):
        raise AssertionError("envmap frame: image not finite, shaped or lit")

    x0, y0, cw, ch = ENV_CROP
    crop = Film(H, W, 3, crop_offset=(x0, y0), crop_size=(cw, ch))
    scene_c, sensor_c = _envmap_scene(bitmap, "cpu")
    with torch.no_grad():
        lanes_k, lanes_c = (integrator._lane_radiance(
            sc, se, crop, SEED, SPP, 0, SPP, ENV_DEPTH, 1000, "rgb", 0,
            ch).cpu() for sc, se in ((scene, sensor), (scene_c, sensor_c)))
    share, worst = _lanes_share(lanes_k, lanes_c)
    print(f"check envmap frame vs CPU, crop {ENV_CROP}: {share:.2e} of "
          f"{lanes_c.shape[0]} lanes outside 1e-3 (bar 1e-3), max "
          f"{worst:.3e}; crop mean {float(lanes_c.mean()):.4f}")
    if not (share <= 1e-3 and float(lanes_c.max()) > 0.0):
        raise AssertionError("the envmap frame disagrees with the CPU")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, ok, info = EmitterAdapter(scene.env).run(
        seed=0, sample_count=CHI2_N, res_phi=2 * CHI2_RES,
        res_cos=CHI2_RES, ires=CHI2_IRES, batch=CHI2_BATCH)
    secs = time.perf_counter() - t0
    print(f"check chi2 envmap {ENV_W}x{ENV_H} (EmitterAdapter, N = "
          f"{CHI2_N:.0e}, {2 * CHI2_RES} x {CHI2_RES} cells): p {p:.4f} "
          f"(bar 0.01), stat {info['stat']:.1f}, dof {info['dof']}, "
          f"integral {info['integral']:.6f}, {secs:.1f} s [{card}]")
    if not ok:
        raise AssertionError(f"chi2 envmap: p = {p:.4g}")

    ms, plain_ms, runs, plain_runs = _turns(frame, plain_frame, 3)
    busy = _profile_window("envmap frame", frame, card, focus=())
    print(f"time envmap frame ({W}x{H}x{SPP}, depth {ENV_DEPTH}, "
          f"{ENV_W}x{ENV_H} envmap): render() {ms:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in runs)}), render_rows(plain=True) "
          f"{plain_ms:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in plain_runs)}), in turns; "
          f"hand-written kernel launches {sum(launches.values())}; device "
          f"busy {100 * busy:.1f}% [{card}]")


# phase 17: the material breadth at full width
MAT_DEPTH = 6
MAT_RR = 3
MAT_TURNS = 2
MAT_CHI2_N = 10_000_000
MAT_WI = (0.3, 0.1, 0.95)


def _material_scene(state, device):
    """Under the headline sunsky and camera, on the headline ground: a
    rough-dielectric sphere, a plastic cube behind a mask of opacity 0.5,
    a rough-plastic cylinder, a principled sphere (metallic 0.3,
    clearcoat 1) inside a null sphere, a principledthin disk and a blend
    rectangle (0.4 of a rough conductor over a diffuse row). Material
    rows are named in MAT_ROWS."""
    from tpusky_torch.render import bsdf as B
    from tpusky_torch.render.scene import make_scene
    from tpusky_torch.render.sensors import make_perspective

    def at(scale, xyz, tilt=0.0):
        c, s = np.cos(tilt), np.sin(tilt)
        rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = rot @ np.diag(scale)
        m[:3, 3] = xyz
        return m
    shapes = [dict(kind=1, to_world=at([10, 10, 1], [0, 0, 0]), bsdf_idx=0),
              dict(kind=0, to_world=at([0.8] * 3, [0, 0, 0.8]), bsdf_idx=1),
              dict(kind=3, to_world=at([0.45] * 3, [1.6, 0.7, 0.45]),
                   bsdf_idx=2),
              dict(kind=4, to_world=at([0.4, 0.4, 1.4], [-1.5, 0.9, 0]),
                   bsdf_idx=3),
              dict(kind=0, to_world=at([0.45] * 3, [0.7, -1.4, 0.45]),
                   bsdf_idx=4),
              dict(kind=0, to_world=at([0.7] * 3, [0.7, -1.4, 0.45]),
                   bsdf_idx=5),
              dict(kind=2, to_world=at([0.5, 0.5, 1], [-0.9, -1.5, 0.9],
                                       1.2), bsdf_idx=6),
              dict(kind=1, to_world=at([0.5, 0.5, 1], [1.9, -0.7, 0.8],
                                       1.4), bsdf_idx=7)]
    kinds = [B.DIFFUSE, B.ROUGH_DIELECTRIC, B.PLASTIC, B.ROUGH_PLASTIC,
             B.PRINCIPLED, B.NULL_BSDF, B.PRINCIPLED_THIN, B.BLEND,
             B.DIFFUSE, B.ROUGH_CONDUCTOR]
    extras = np.zeros((len(kinds), 8), np.float32)
    extras[:, 1] = 0.5
    extras[4] = [0.3, 0.5, 0.2, 0.3, 1.0, 0.6, 0.1, 0.0]
    extras[6] = [0.4, 0.3, 0.2, 0.3, 0.2, 0.3, 0.0, 0.0]
    children = np.zeros((len(kinds), 2), np.int64)
    children[7] = [8, 9]
    weights = np.zeros((len(kinds),), np.float32)
    weights[7] = 0.4
    opacities = np.ones((len(kinds),), np.float32)
    opacities[2] = 0.5
    scene = make_scene(
        shapes=shapes,
        bsdf_albedos=[[0.4, 0.4, 0.4], [1.0, 1.0, 1.0], [0.7, 0.3, 0.2],
                      [0.2, 0.5, 0.7], [0.8, 0.6, 0.3], [1.0, 1.0, 1.0],
                      [0.6, 0.7, 0.5], [0.5, 0.5, 0.5], [0.3, 0.6, 0.3],
                      [0.9, 0.7, 0.4]],
        bsdf_kinds=kinds,
        bsdf_alphas=[0.1, 0.25, 0.1, 0.3, 0.35, 0.1, 0.3, 0.1, 0.1, 0.25],
        bsdf_iors=[1.5, 1.5, 1.5, 1.5, 1.5, 1.0, 1.45, 1.5, 1.5, 1.5],
        bsdf_twosided=[False] * 7 + [True] * 3, bsdf_extras=extras,
        bsdf_blend_children=children, bsdf_blend_weights=weights,
        bsdf_opacities=opacities, env=state, device=device)
    sensor = make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device=device)
    return scene, sensor


# (kind, the scene's row, whether it transmits) of the BSDF chi-squares
MAT_ROWS = ((4, 2, False), (5, 1, True), (8, 3, False), (9, 4, False),
            (10, 7, False), (15, 6, True))


def _grid_2d(h, w):
    """A (h, w) density with a hot patch and a zero row, from a seed."""
    rng = np.random.default_rng(6)
    v = rng.uniform(0.05, 1.0, (h, w)) ** 2
    v[h // 3: h // 2, : w // 4] *= 25.0
    v[h // 5] = 0.0
    return v.astype(np.float32)


def material_frame_phase(dev, card):
    """Phase 17: the material frame (depth MAT_DEPTH, Russian roulette
    from depth MAT_RR) held as `_wavefront_frame` holds a frame; then
    BSDFAdapter's chi-square of each new kind's row (the plastic's base:
    its coat is counted outside) and chi2_test_2d of the three distr2d
    distributions, at N = 1e7 on the card, each p >= 0.01."""
    import torch
    import tpusky_torch as tt
    from tpusky_torch.ops import distr2d as D
    from tpusky_torch.utils.chi2 import BSDFAdapter, chi2_test_2d
    state = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=SUN, device=dev))
    scene, sensor = _material_scene(state, dev)
    _wavefront_frame("material frame", scene, sensor, MAT_DEPTH, MAT_RR,
                     MAT_TURNS, card)

    wi = np.asarray(MAT_WI, np.float32) / np.linalg.norm(MAT_WI)
    for kind, row, transmits in MAT_ROWS:
        t0 = time.perf_counter()
        p, ok, info = BSDFAdapter(scene.bsdfs, row, wi).run(
            seed=kind, sample_count=MAT_CHI2_N, res_phi=256, res_cos=128,
            ires=16, batch=CHI2_BATCH,
            cos_range=(-1.0, 1.0) if transmits else (0.0, 1.0))
        print(f"check chi2 material kind {kind} (row {row}, BSDFAdapter, "
              f"N = {MAT_CHI2_N:.0e}): p {p:.4f} (bar 0.01), stat "
              f"{info['stat']:.1f}, dof {info['dof']}, integral "
              f"{info['integral']:.6f}, outside {info['miss_frac']:.4f}, "
              f"{time.perf_counter() - t0:.1f} s [{card}]")
        if not ok:
            raise AssertionError(f"chi2 material kind {kind}: p = {p:.4g}")
    grid = _grid_2d(64, 128)
    dists = (("Marginal2D", D.make_marginal_2d(grid, device=dev),
              D.marginal_sample, D.marginal_pdf),
             ("Hierarchical2D", D.make_hierarchical_2d(grid, device=dev),
              D.hierarchical_sample, D.hierarchical_pdf),
             ("Bilinear2D", D.make_bilinear_2d(_grid_2d(65, 129),
                                               device=dev),
              D.bilinear_sample, D.bilinear_pdf))
    for name, d, sample, pdf in dists:
        def sample_fn(batch_seed, n, d=d, sample=sample):
            u = torch.rand(n, 2, device=dev, generator=torch.Generator(
                device=dev).manual_seed(batch_seed))
            return sample(d, u)[0]
        t0 = time.perf_counter()
        p, ok, info = chi2_test_2d(sample_fn, lambda xy, d=d, pdf=pdf:
                                   pdf(d, xy), seed=3,
                                   sample_count=MAT_CHI2_N, res_x=128,
                                   res_y=64, batch=CHI2_BATCH)
        print(f"check chi2_test_2d {name} (N = {MAT_CHI2_N:.0e}, 128 x 64 "
              f"cells): p {p:.4f} (bar 0.01), stat {info['stat']:.1f}, dof "
              f"{info['dof']}, {time.perf_counter() - t0:.1f} s [{card}]")
        if not ok:
            raise AssertionError(f"chi2_test_2d {name}: p = {p:.4g}")


# phase 18: the spectral film frame at full width
FILM_SPP = SPP
FILM_DEPTH = SPEC_DEPTH
FILM_TURNS = 2
FILM_APERTURE = 0.05
FILM_SAMPLER_LANES = 1 << 21
FILM_SMALL = 64             # the sensor and filter cases: 64x64x4, depth 2
FILM_SMALL_SPP = 4
FILM_SPLAT = 128            # the splat cases: 128x128x8 lanes
FILM_GRAD = 128             # the gradient case: 128x128x4, depth 2
FILM_ENV = (64, 128)        # the spectral envmap's texels
FILM_ENV_RES = 128


def _film_srfs():
    """Four smooth regular sensor responses over 400-700 nm (31 values
    each), gaussians 40 nm wide at 450, 520, 590 and 650 nm."""
    grid = np.linspace(400.0, 700.0, 31)
    return tuple((400.0, 700.0, tuple(float(v) for v in np.exp(
        -0.5 * ((grid - c) / 40.0) ** 2))) for c in (450.0, 520.0, 590.0,
                                                        650.0))


def _film_scene(state, device):
    """bench_spectral's scene (`_spectral_scene`) plus a rectangle area
    panel facing down and one point light, both RGB and upsampled by
    rgb2spec in the render, seen by a thin lens (aperture FILM_APERTURE)
    at bench_spectral's camera, focused on the ground at its target."""
    from tpusky_torch.render.bsdf import DIFFUSE, ROUGH_CONDUCTOR
    from tpusky_torch.render.scene import make_scene
    from tpusky_torch.render.sensors import ThinLens, make_perspective
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    panel = np.diag([0.8, 0.8, 1.0, 1.0]).astype(np.float32)
    panel[:3, :3] = panel[:3, :3] @ np.diag([1.0, -1.0, -1.0])
    panel[:3, 3] = [0.0, -1.0, 3.0]
    rad = np.zeros((2, 3), np.float32)
    rad[1] = [12.0, 10.0, 8.0]
    scene = make_scene(
        shapes=[dict(kind=1, to_world=ground, bsdf_idx=0),
                dict(kind=1, to_world=panel, bsdf_idx=1, emitter_idx=0)],
        bsdf_albedos=[[0.5, 0.5, 0.5], [0.0, 0.0, 0.0]],
        bsdf_kinds=[ROUGH_CONDUCTOR, DIFFUSE], bsdf_alphas=[0.2, 0.1],
        area_radiance=rad, point_lights=[[1.5, -1.5, 2.5, 8.0, 6.0, 4.0]],
        env=state, device=device)
    eye, target = np.array([4.0, -4.0, 2.0]), np.array([0.0, 0.0, 0.5])
    cam = make_perspective(eye, target, fov_x_deg=45, device=device)

    return scene, ThinLens(cam.to_world, cam.fov_x_deg, cam.aspect,
                           _film_f32(FILM_APERTURE, device),
                           _film_f32(np.linalg.norm(target - eye), device))


def _film_f32(v, device):
    import torch
    return torch.tensor(np.asarray(v, np.float32), device=device)


def _small_sensors(device):
    """One sensor of each kind, looking at the film frame's ground."""
    from tpusky_torch.render import sensors as S
    persp = S.make_perspective([4.0, -4.0, 2.0], [0.0, 0.0, 0.5],
                               fov_x_deg=45, device=device)
    thin = S.ThinLens(persp.to_world, persp.fov_x_deg, persp.aspect,
                      _film_f32(0.1, device), _film_f32(5.85, device))
    irr = S.make_irradiancemeter([0.0, 0.0, 0.01], [0.0, 0.0, 1.0],
                                 half_extent=2.0, device=device)
    return {
        "perspective": persp, "thinlens": thin,
        "orthographic": S.Orthographic(persp.to_world,
                                       _film_f32(3.0, device)),
        "spherical": S.make_spherical([0.0, 0.0, 1.0], device=device),
        "distant": S.make_distant([0.3, -0.2, -0.9], radius=6.0,
                                  extent=4.0, device=device),
        "radiancemeter": S.RadianceMeter(
            _film_f32([0.0, -2.0, 2.0], device),
            _film_f32([0.0, 0.6, -0.8], device)),
        "irradiancemeter": irr,
        "batch": S.Batch((thin, S.make_spherical([0.0, 0.0, 1.0],
                                                 device=device), irr)),
    }


def _splat64(film, uv, values):
    """A float64 splat on the CPU of pixel-ordered lanes, one tap at a
    time (the reference's formulation, `tpusky/render/film.py:95-132`,
    with the port's gaussian) -> (H, W, C+1)."""
    import torch
    from tpusky_torch.render import film as F
    h, w, c = film.height, film.width, film.n_channels
    uv, v = uv.double().cpu(), values.double().cpu()
    v = torch.cat([v, torch.ones_like(v[:, :1])], -1)
    r = F._RADIUS[film.rfilter]
    img = torch.zeros((h * w, c + 1), dtype=torch.float64)
    bx = torch.floor(uv[:, 0] - 0.5) - (r - 1)
    by = torch.floor(uv[:, 1] - 0.5) - (r - 1)
    for oy in range(2 * r):
        for ox in range(2 * r):
            px, py = bx + ox, by + oy
            wgt = (F.filter_weight(film.rfilter, px + 0.5 - uv[:, 0])
                   * F.filter_weight(film.rfilter, py + 0.5 - uv[:, 1]))
            ok = (px >= 0) & (px < w) & (py >= 0) & (py < h)
            flat = (py.clamp(0, h - 1) * w + px.clamp(0, w - 1)).long()
            img.index_add_(0, flat[ok], v[ok] * wgt[ok, None])
    return img.reshape(h, w, c + 1)


def _film_sampler_checks(dev):
    """lane_samples of every kind on FILM_SAMPLER_LANES lanes at spp 8
    (orthogonal at 9 as well, stratified at 6): bitwise equal on the card
    and on the CPU."""
    import torch
    from tpusky_torch.render.sampler import VALID_KINDS, lane_samples
    words = np.array([0, SEED], np.uint32)
    lane = torch.arange(FILM_SAMPLER_LANES, device=dev)
    cases = [(k, 8) for k in VALID_KINDS] + [("orthogonal", 9),
                                            ("stratified", 6)]
    for kind, spp in cases:
        for dim, n in ((10_000, 2), (20_000, 1)):
            args = (lane // spp, lane % spp, spp, dim, n)
            on_card = lane_samples(kind, words, *args)
            on_cpu = lane_samples(kind, words, *(a.cpu() if hasattr(
                a, "cpu") else a for a in args))
            if not torch.equal(on_card.cpu(), on_cpu):
                bad = int((on_card.cpu() != on_cpu).sum())
                raise AssertionError(f"lane_samples {kind} spp {spp} dim "
                                     f"{dim}: {bad} values differ between "
                                     "the card and the CPU")
    print(f"check lane_samples, every kind ({', '.join(VALID_KINDS)}) at "
          f"spp 8, orthogonal at 9, stratified at 6, dims 10000 and 20000, "
          f"{FILM_SAMPLER_LANES} lanes: bitwise equal on the card and the "
          f"CPU")


def _film_splat_checks(dev, card):
    """splat of every filter on the card (FILM_SPLAT^2 x 8 pixel-ordered
    lanes of 4 channels): within 1e-5 of a float64 CPU splat (of the
    largest value), bitwise equal between two calls; and the splat's
    device time at the frame's chunk (1,048,576 lanes, mitchell)."""
    import torch
    from tpusky_torch.render import film as F
    g = torch.Generator(device="cpu").manual_seed(SEED)
    n = FILM_SPLAT * FILM_SPLAT * 8
    pix = torch.arange(FILM_SPLAT * FILM_SPLAT).repeat_interleave(8)
    uv = torch.stack([pix % FILM_SPLAT + torch.rand(n, generator=g),
                      pix // FILM_SPLAT + torch.rand(n, generator=g)], -1)
    vals = torch.rand((n, 4), generator=g) * 2.0
    for rf in F.FILTERS:
        film = F.Film(FILM_SPLAT, FILM_SPLAT, 4, rf)
        a = F.splat(film, uv.to(dev), vals.to(dev), spp=8)
        b = F.splat(film, uv.to(dev), vals.to(dev), spp=8)
        if not torch.equal(a, b):
            raise AssertionError(f"splat {rf}: two calls differ")
        if rf == "box":
            want = F.splat_ordered(film, vals.double(), 8)
        else:
            want = _splat64(film, uv, vals)
        err = float((a.double().cpu() - want).abs().max()
                    / want.abs().max())
        print(f"check splat {rf} on the card vs a float64 CPU splat "
              f"({FILM_SPLAT}x{FILM_SPLAT}x8 lanes): {err:.2e} of its scale "
              f"(bar 1e-5); two calls bitwise equal")
        if not err <= 1e-5:
            raise AssertionError(f"splat {rf}: {err:.3e}")
    half = H * W * FILM_SPP // 2
    pix = torch.arange(H * W, device=dev).repeat_interleave(FILM_SPP // 2)
    uv = torch.stack([pix % W + torch.rand(half, device=dev),
                      pix // W + torch.rand(half, device=dev)], -1)
    vals = torch.rand((half, 4), device=dev)
    film = F.Film(H, W, 4, "mitchell")
    ms = _time_ms(lambda: F.splat(film, uv, vals, spp=FILM_SPP // 2),
                  reps=5)
    print(f"time splat mitchell, {half} lanes of 4 channels into "
          f"{W}x{H} (one chunk of the frame): {ms:.3f} ms [{card}]")
    return ms


def _film_small_checks(state, state_cpu, dev):
    """Each sensor kind (a filter each, in turn) at FILM_SMALL^2 x
    FILM_SMALL_SPP, depth 2, the film frame's scene and SRF film: the
    card's render() against the CPU's, >= 99.9% of pixels within 1e-3."""
    import torch
    from tpusky_torch.render import film as F
    from tpusky_torch.render import integrator
    filters = F.FILTERS
    sensors_k, sensors_c = _small_sensors(dev), _small_sensors("cpu")
    scene_k, _ = _film_scene(state, dev)
    scene_c, _ = _film_scene(state_cpu, "cpu")
    for i, name in enumerate(sensors_k):
        rf = filters[i % len(filters)]
        film = F.Film(FILM_SMALL, FILM_SMALL, 4, rf, srfs=_film_srfs())
        imgs = [integrator.render(sc, se, film, SEED, spp=FILM_SMALL_SPP,
                                  max_depth=2, mode="spectral",
                                  sampler_kind="multijitter").cpu()
                for sc, se in ((scene_k, sensors_k[name]),
                               (scene_c, sensors_c[name]))]
        share, worst = _lanes_share(imgs[0].reshape(-1, 4),
                                    imgs[1].reshape(-1, 4))
        print(f"check {name} sensor, {rf} filter ({FILM_SMALL}x{FILM_SMALL}"
              f"x{FILM_SMALL_SPP}, depth 2, SRF film): card vs CPU "
              f"{share:.2e} of pixels outside 1e-3 (bar 1e-3), max "
              f"{worst:.2e}; mean {float(imgs[1].mean()):.4f}")
        if not (share <= 1e-3 and bool(torch.isfinite(imgs[0]).all())):
            raise AssertionError(f"{name} sensor: card and CPU disagree")


def _film_grad_check(dev, card):
    """fwd+bwd of the film frame's scene at FILM_GRAD^2 x 4, depth 2,
    mean(img^2) to the turbidity (through precompute) and to the area
    radiance (through the rgb2spec fit): K10-K13 launch, and both
    gradients agree with the plain path's on the card within the bars of
    bench_spectral_grad (1e-3)."""
    import torch
    import tpusky_torch as tt
    from tpusky_torch.models.sunsky.model import precompute
    from tpusky_torch.render import film as F
    from tpusky_torch.render import integrator
    from tpusky_torch.render.bsdf import table_kinds
    tables = tt.load_tables("spectral", device=dev)
    film = F.Film(FILM_GRAD, FILM_GRAD, 4, "mitchell", srfs=_film_srfs())

    def case(plain):
        t = torch.tensor(3.0, device=dev, requires_grad=True)
        p = tt.make_params(turbidity=t, albedo=0.3, sun_direction=SUN,
                           mode="spectral", device=dev)
        scene, sensor = _film_scene(precompute(tables, p, "spectral"), dev)
        rad = scene.area_radiance.clone().requires_grad_()
        im = F.develop(integrator.render_rows(
            scene._replace(area_radiance=rad), sensor, film, SEED, 4, 2,
            1000, "spectral", 0, FILM_GRAD, sampler_kind="multijitter",
            kinds=table_kinds(scene.bsdfs), plain=plain))
        return torch.autograd.grad((im ** 2).mean(), [t, rad])
    grads_k, launches = _counted(lambda: case(False))
    _require(launches, ("sunsky_hit_spec", "sunsky_nee_spec",
                        "sunsky_hit_spec_bwd", "sunsky_nee_spec_bwd"),
             "the film frame's gradient")
    grads_p = case(True)
    for name, a, b in zip(("turbidity", "area_radiance"), grads_k, grads_p):
        if not (bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0):
            raise AssertionError(f"film gradient d{name}: zero or not finite")
        _check_scale(f"film frame gradient d{name} ({FILM_GRAD}x{FILM_GRAD}"
                     f"x4, depth 2): kernels vs plain on the card", a, b,
                     1e-3)
    ms, plain_ms = _pair_ms(lambda: case(False), lambda: case(True), reps=2)
    print(f"time film frame fwd+bwd ({FILM_GRAD}x{FILM_GRAD}x4, depth 2, "
          f"precompute and fit included): kernels {ms:.2f} ms, plain "
          f"{plain_ms:.2f} ms; launches {launches} [{card}]")


def _film_envmap_check(dev):
    """A spectral envmap (FILM_ENV texels, each fitted on the host) over
    the film frame's ground at FILM_ENV_RES^2 x 4, depth 2: the card's
    lanes against the CPU's, >= 99.9% within 1e-3."""
    import torch
    from tpusky_torch.render import film as F
    from tpusky_torch.render import integrator
    from tpusky_torch.render.emitters import make_envmap
    h, w = FILM_ENV
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2.0 * np.pi
    up = np.clip(np.cos(theta), 0.0, 1.0)[:, None, None]
    bitmap = ((np.array([0.9, 0.8, 0.6]) * (1.0 - up)
               + np.array([0.2, 0.4, 0.9]) * up)
              * (1.0 + 0.5 * np.cos(phi))[None, :, None]).astype(np.float32)
    t0 = time.perf_counter()
    env_k = make_envmap(bitmap, spectral=True, device=dev)
    fit_s = time.perf_counter() - t0
    env_c = make_envmap(bitmap, spectral=True, device="cpu")
    film = F.Film(FILM_ENV_RES, FILM_ENV_RES, 3)
    lanes = []
    for env, device in ((env_k, dev), (env_c, "cpu")):
        scene, sensor = _film_scene(None, device)
        scene = scene._replace(env=env)
        with torch.no_grad():
            lanes.append(integrator._lane_radiance(
                scene, sensor, film, SEED, 4, 0, 4, 2, 1000, "spectral", 0,
                FILM_ENV_RES).cpu())
    share, worst = _lanes_share(*lanes)
    print(f"check spectral envmap frame ({w}x{h} texels fitted on the host "
          f"in {fit_s:.2f} s, {FILM_ENV_RES}x{FILM_ENV_RES}x4, depth 2): "
          f"card vs CPU {share:.2e} of lanes outside 1e-3 (bar 1e-3), max "
          f"{worst:.2e}; mean {float(lanes[1].mean()):.4f}")
    if not (share <= 1e-3 and float(lanes[1].mean()) > 0.0):
        raise AssertionError("the spectral envmap frame disagrees")


def spectral_film_phase(dev, card):
    """Phase 18: the spectral film frame at full width (H x W x FILM_SPP,
    depth FILM_DEPTH): bench_spectral's scene plus an RGB area panel and
    point light (rgb2spec), a thin lens, a 4-channel SRF specfilm, the
    mitchell filter and the multijitter sampler, through render(): K10 and
    K11 launch, K4 not; its lanes within 1e-3 of the plain path's on >=
    99.9%; two render() calls bitwise equal; no synchronisation; wall
    time in turns with the plain path, launches, busy share, the fit's
    launches and the splat's time. Then the smaller checks: samplers,
    splats, each sensor and filter, a gradient, a spectral envmap."""
    import torch
    import tpusky_torch as tt
    from tpusky_torch.render import bsdf as B
    from tpusky_torch.render import film as F
    from tpusky_torch.render import integrator
    from tpusky_torch.render.scene import with_emitter_coeffs
    t_phase = time.perf_counter()

    def state_on(device):
        return tt.sunsky_precompute(tt.make_params(
            turbidity=3.0, albedo=0.3, sun_direction=SUN, mode="spectral",
            device=device), mode="spectral")
    state = state_on(dev)
    scene, sensor = _film_scene(state, dev)
    film = F.Film(H, W, 4, "mitchell", srfs=_film_srfs())
    kinds = B.table_kinds(scene.bsdfs)

    def frame():
        return integrator.render(scene, sensor, film, SEED, spp=FILM_SPP,
                                 max_depth=FILM_DEPTH, mode="spectral",
                                 sampler_kind="multijitter")

    def plain_frame():
        return integrator.render_rows(
            scene, sensor, film, SEED, FILM_SPP, FILM_DEPTH, 1000,
            "spectral", 0, H, sampler_kind="multijitter", kinds=kinds,
            plain=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, launches = _counted(frame)
    torch.cuda.synchronize()
    print(f"spectral film frame: {time.perf_counter() - t0:.2f} s (first "
          f"call), launches {launches}")
    _require(launches, ("sunsky_hit_spec", "sunsky_nee_spec"),
             "the spectral film frame")
    if launches["direct_rgb_megakernel"] != 0:
        raise AssertionError("the spectral film frame went through K4")
    if not (img.shape == (H, W, 4) and bool(torch.isfinite(img).all())
            and float(img.mean()) > 0.0):
        raise AssertionError("spectral film frame: image not finite, "
                             "shaped or lit")
    if not torch.equal(frame(), img):
        raise AssertionError("two render() calls of the spectral film "
                             "frame differ")
    _no_sync(frame, "the spectral film frame's render()")
    with torch.no_grad():
        lanes_k, lanes_p = (integrator._lane_radiance(
            scene, sensor, film, SEED, FILM_SPP, 0, FILM_SPP, FILM_DEPTH,
            1000, "spectral", 0, H, "multijitter", kinds, plain)
            for plain in (False, True))
        share, worst = _lanes_share(lanes_k, lanes_p)
    print(f"check spectral film frame lanes: {share:.2e} of "
          f"{lanes_p.shape[0]} lanes outside 1e-3 of the plain path (bar "
          f"1e-3), max {worst:.3e}; two render() calls bitwise equal; "
          f"image mean {[round(float(x), 5) for x in img.mean((0, 1))]}")
    if not share <= 1e-3:
        raise AssertionError("the spectral film frame disagrees with the "
                             "plain path")
    del lanes_k, lanes_p
    ms, plain_ms, runs, plain_runs = _turns(frame, plain_frame, FILM_TURNS)
    busy = _profile_window("spectral film frame", frame, card, iters=1,
                           focus=(("K10", "hit_spec_kernel"),
                                  ("K11", "nee_spec_kernel")))
    fit_busy = _profile_window("rgb2spec fit of the frame's emitters",
                               lambda: with_emitter_coeffs(scene), card,
                               iters=1, focus=())
    print(f"time spectral film frame ({W}x{H}x{FILM_SPP}, depth "
          f"{FILM_DEPTH}, SRF film of 4 channels, mitchell, multijitter, "
          f"thin lens): render() {ms:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in runs)}), plain path "
          f"{plain_ms:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in plain_runs)}), in turns; "
          f"{launches['sunsky_hit_spec']} K10 and "
          f"{launches['sunsky_nee_spec']} K11 launches a render(); device "
          f"busy {100 * busy:.1f}% (the fit alone {100 * fit_busy:.1f}%) "
          f"[{card}]")
    print(f"phase 18 frame: {time.perf_counter() - t_phase:.1f} s")

    _film_sampler_checks(dev)
    _film_splat_checks(dev, card)
    _film_small_checks(state, state_on("cpu"), dev)
    _film_grad_check(dev, card)
    _film_envmap_check(dev)


# phase 19: textures and mesh attributes at full width
TEX_SIZE = 2048             # the icosphere's bitmap, TEX_SIZE^2 texels
NMAP_SIZE = 512             # the ground's normal map
VOL_SIZE = 64               # the principled sphere's volume texture
TEX_TURNS = 2
TEX_BAND = (240, 16)        # rows held against the fully plain path
TEX_CROP = (352, 240, 8, 8)         # x0, y0, width, height (CPU check)
TEX_CROP_SPP = 2
TEX_GRAD = 256              # the gradient frame: 256x256x4
TEX_GRAD_SPP = 4
TEX_AOV = 512               # the AOVs at 512x512
TEX_FIT_CHECK = 1 << 14     # texels whose device fit is held to the host's


def _textured_scene(state, device, spectral=False):
    """scene_mesh_gi's geometry (`_mesh_scene` at FRAME_SUBDIV) textured:
    the icosphere with per-vertex spherical uv and a diffuse material
    under a TEX_SIZE^2 bitmap (repeat), the ground a rough plastic with a
    checkerboard (`to_uv` x 8) and a NMAP_SIZE^2 normal map, a principled
    sphere under a VOL_SIZE^3 volume texture, and an icosphere(2) of
    random vertex colours read through a mesh attribute; texels made
    from a seed. In spectral mode every texel's coefficients are fitted
    on `device` when the table is built."""
    from tpusky_torch.render.scene import make_scene
    from tpusky_torch.render.sensors import make_perspective
    from tpusky_torch.utils.meshio import icosphere
    rng = np.random.default_rng(19)
    pos, idx = icosphere(FRAME_SUBDIV)
    uvs = np.stack([np.arctan2(pos[:, 1], pos[:, 0]) / (2 * np.pi) + 0.5,
                    np.arccos(np.clip(pos[:, 2], -1, 1)) / np.pi],
                   -1).astype(np.float32)
    pos2, idx2 = icosphere(2)
    cols = rng.uniform(0.1, 0.9, size=(len(pos2), 3)).astype(np.float32)
    bitmap = rng.uniform(size=(TEX_SIZE, TEX_SIZE, 3)).astype(np.float32)
    tilt = rng.uniform(-0.15, 0.15, size=(NMAP_SIZE, NMAP_SIZE, 2))
    nmap = np.concatenate([0.5 + tilt, np.full((NMAP_SIZE, NMAP_SIZE, 1),
                                               0.95)], -1).astype(np.float32)
    grid = rng.uniform(size=(VOL_SIZE,) * 3 + (3,)).astype(np.float32)

    def at(scale, xyz):
        m = np.diag(list(scale) + [1.0]).astype(np.float32)
        m[:3, 3] = xyz
        return m
    textures = [dict(kind="bitmap", data=bitmap, wrap="repeat"),
                dict(kind="checkerboard", color0=[0.8, 0.7, 0.6],
                     color1=[0.15, 0.2, 0.3], to_uv=np.diag([8.0, 8.0, 1.0])),
                dict(kind="bitmap", data=nmap, wrap="repeat"),
                dict(kind="volume", grid=grid,
                     to_world=at([1.0] * 3, [1.0, -0.3, 0.0])),
                dict(kind="mesh_attribute", scale=1.0)]
    scene = make_scene(
        shapes=[dict(kind=1, to_world=at([10.0, 10.0, 1.0], [0, 0, 0]),
                     bsdf_idx=0),
                dict(kind=0, to_world=at([0.5] * 3, [1.5, 0.2, 0.5]),
                     bsdf_idx=2)],
        bsdf_albedos=[[0.5] * 3, [0.3, 0.5, 0.7], [0.6, 0.5, 0.4],
                      [0.5] * 3],
        bsdf_kinds=[8, 0, 9, 0], bsdf_alphas=[0.25, 0.1, 0.35, 0.1],
        bsdf_tex_indices=[1, 0, 3, 4], bsdf_normal_tex_indices=[2, -1, -1, -1],
        textures=textures, spectral_textures=spectral,
        meshes=[dict(positions=pos, indices=idx, normals=pos.copy(), uvs=uvs,
                     to_world=at([1.0] * 3, [0, 0, 1.0]), bsdf_idx=1),
                dict(positions=pos2, indices=idx2, normals=pos2.copy(),
                     colors=cols, to_world=at([0.4] * 3, [-1.3, -1.0, 0.4]),
                     bsdf_idx=3)], env=state, device=device)
    sensor = make_perspective([3.5, -3.5, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device=device)
    return scene, sensor


@contextlib.contextmanager
def _k14_as_plain_mesh(tables):
    """The plain path with K14's hits: inside, the plain version's mesh
    queries run K14 (with the wavefront sort), whose hits are the plain
    version's exactly (phase 9; `_textured_frame`'s band), so a full
    textured frame is held against the plain sunsky and texture path
    without the dense plain intersection (17 s a million rays)."""
    import torch
    from tpusky_torch.render import mesh as TM
    saved = TM._closest_plain, TM._occluded_plain
    closest = TM._closest

    def closest_k14(mesh, o, d):
        return closest(mesh, o, d, False, tables)

    def occluded_k14(mesh, o, d, maxt):
        t, _, _, tri = closest(mesh, o, d, False, tables)
        return torch.isfinite(t) & (tri >= 0) & (t < maxt)
    TM._closest_plain, TM._occluded_plain = closest_k14, occluded_k14
    try:
        yield
    finally:
        TM._closest_plain, TM._occluded_plain = saved


def _textured_frame(label, scene, sensor, mode, card, crop=None):
    """The textured frame (H x W x SPP, depth MESH_DEPTH) through render()
    in `mode`: the mode's sunsky kernels and K14 launch, K4 not; two calls
    bitwise equal; no synchronisation; all its lanes within 1e-3 of the
    plain path with K14's hits (`_k14_as_plain_mesh`) on >= 99.9%, and
    the TEX_BAND rows of the fully plain path (the dense mesh
    intersection) too; render()'s wall time in turns with that plain
    path's, the launches and the busy share; with `crop` (a CPU scene
    and sensor), a TEX_CROP crop against the CPU's plain render."""
    import torch
    from tpusky_torch.render import bsdf as B
    from tpusky_torch.render import integrator
    from tpusky_torch.render.film import Film
    from tpusky_torch.render.scene import with_mesh_tables
    film = Film(H, W, 3)
    kinds = B.table_kinds(scene.bsdfs)
    scene_k = with_mesh_tables(scene)
    sky = (("sunsky_hit_rgb", "sunsky_nee_rgb") if mode == "rgb"
           else ("sunsky_hit_spec", "sunsky_nee_spec"))
    focus = ((("K2", "hit_kernel"), ("K3", "nee_kernel")) if mode == "rgb"
             else (("K10", "hit_spec_kernel"), ("K11", "nee_spec_kernel")))

    def frame():
        return integrator.render(scene, sensor, film, SEED, spp=SPP,
                                 max_depth=MESH_DEPTH, mode=mode)

    def plain_frame():
        with _k14_as_plain_mesh(scene_k.mesh_tables):
            return integrator.render_rows(
                scene, sensor, film, SEED, SPP, MESH_DEPTH, 1000, mode, 0,
                H, kinds=kinds, plain=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, launches = _counted(frame)
    torch.cuda.synchronize()
    print(f"{label}: {time.perf_counter() - t0:.2f} s (first call), kinds "
          f"{kinds}, launches {launches}")
    _require(launches, sky + ("mesh_intersect",), f"the {label}")
    if launches["direct_rgb_megakernel"] != 0:
        raise AssertionError(f"the {label} went through K4")
    if not (img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
            and float(img.mean()) > 0.0):
        raise AssertionError(f"{label}: image not finite, shaped or lit")
    if not torch.equal(frame(), img):
        raise AssertionError(f"two render() calls of the {label} differ")
    _no_sync(frame, f"the {label}'s render()")
    with torch.no_grad():
        lanes_k = integrator._lane_radiance(
            scene_k, sensor, film, SEED, SPP, 0, SPP, MESH_DEPTH, 1000, mode,
            0, H, kinds=kinds)
        with _k14_as_plain_mesh(scene_k.mesh_tables):
            lanes_p = integrator._lane_radiance(
                scene, sensor, film, SEED, SPP, 0, SPP, MESH_DEPTH, 1000,
                mode, 0, H, kinds=kinds, plain=True)
        share, worst = _lanes_share(lanes_k, lanes_p)
        row0, n_rows = TEX_BAND
        band = slice(row0 * W * SPP, (row0 + n_rows) * W * SPP)
        band_p = integrator._lane_radiance(
            scene, sensor, film, SEED, SPP, 0, SPP, MESH_DEPTH, 1000, mode,
            row0, n_rows, kinds=kinds, plain=True)
        band_share, band_worst = _lanes_share(lanes_k[band], band_p)
    print(f"check {label} lanes: {share:.2e} of {lanes_p.shape[0]} lanes "
          f"outside 1e-3 of the plain path with K14's hits (bar 1e-3), max "
          f"{worst:.3e}; rows {row0}-{row0 + n_rows} against the fully "
          f"plain path (dense mesh): {band_share:.2e} of {band_p.shape[0]} "
          f"outside, max {band_worst:.3e}; two render() calls bitwise "
          f"equal; image mean {float(img.mean()):.5f} max "
          f"{float(img.max()):.3f}")
    if not (share <= 1e-3 and band_share <= 1e-3):
        raise AssertionError(f"the {label} disagrees with the plain path")
    del lanes_k, lanes_p, band_p
    if crop is not None:
        x0, y0, cw, ch = TEX_CROP
        cfilm = Film(H, W, 3, crop_offset=(x0, y0), crop_size=(cw, ch))
        img_k = integrator.render(scene, sensor, cfilm, SEED,
                                  spp=TEX_CROP_SPP, max_depth=MESH_DEPTH,
                                  mode=mode).cpu()
        t0 = time.perf_counter()
        img_c = integrator.render(*crop, cfilm, SEED, spp=TEX_CROP_SPP,
                                  max_depth=MESH_DEPTH, mode=mode)
        share_c, worst_c = _lanes_share(img_k.reshape(-1, 3),
                                        img_c.reshape(-1, 3))
        print(f"check {label} vs CPU plain, crop {TEX_CROP} at "
              f"{TEX_CROP_SPP} spp: {share_c:.2e} of pixels outside 1e-3 "
              f"(bar 1e-3), max {worst_c:.3e} (the CPU took "
              f"{time.perf_counter() - t0:.1f} s)")
        if not (share_c <= 1e-3 and float(img_c.max()) > 0):
            raise AssertionError(f"the {label} disagrees with the CPU")
    plain_frame()
    ms, plain_ms, runs, plain_runs = _turns(frame, plain_frame, TEX_TURNS)
    busy = _profile_window(label, frame, card, iters=1,
                           focus=(("K14", "mesh_isect_kernel"),) + focus)
    print(f"time {label} ({W}x{H}x{SPP}, depth {MESH_DEPTH}, "
          f"{int(scene.mesh.valid.sum())} triangles, {mode}): render() "
          f"{ms:.3f} ms (runs {', '.join(f'{t:.2f}' for t in runs)}), plain "
          f"path with K14's hits {plain_ms:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in plain_runs)}), in turns; "
          f"{launches[sky[0]]} {sky[0]}, {launches[sky[1]]} {sky[1]} and "
          f"{launches['mesh_intersect']} K14 launches a render(); device "
          f"busy {100 * busy:.1f}% [{card}]")


def _texel_fit_check(dev, card):
    """The spectral table's texel fit on the card (`fit_sigmoid_coeffs_f64`,
    the host rule) against the host fit (`fit_sigmoid_coeffs`) on
    TEX_FIT_CHECK of the bitmap's texels: spectra within 1e-6; its wall
    time on the card for the whole 2048^2 bitmap."""
    import torch
    from tpusky_torch.ops.rgb2spec import (eval_sigmoid_spectrum,
                                           fit_sigmoid_coeffs,
                                           fit_sigmoid_coeffs_f64)
    rgb = np.random.default_rng(19).uniform(
        size=(TEX_SIZE * TEX_SIZE, 3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_c = fit_sigmoid_coeffs_f64(torch.tensor(rgb, device=dev))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = fit_sigmoid_coeffs(rgb[:TEX_FIT_CHECK])
    host_s = time.perf_counter() - t0
    wl = np.linspace(360.0, 830.0, 95)
    err = np.abs(eval_sigmoid_spectrum(host, wl) - eval_sigmoid_spectrum(
        dev_c[:TEX_FIT_CHECK].cpu().numpy(), wl)).max()
    print(f"check texel fit on the card vs the host fit, {TEX_FIT_CHECK} "
          f"texels: spectra within {err:.2e} (bar 1e-6); time {TEX_SIZE}^2 "
          f"texels on the card {1e3 * fit_s:.1f} ms, the host fit "
          f"{1e3 * host_s:.1f} ms for {TEX_FIT_CHECK} [{card}]")
    if not err <= 1e-6:
        raise AssertionError("the texel fit on the card disagrees with the "
                             "host fit")


def _textured_grad_check(dev, card):
    """fwd+bwd of the textured frame at TEX_GRAD^2 x TEX_GRAD_SPP, depth
    MESH_DEPTH, mean(img^2) to the 2048^2 atlas, the checker's colours
    and the turbidity (through precompute, so the sky's adjoints run):
    K2, K3, K5, K6 and K14 launch; each gradient of the kernel path within
    1e-3 of the plain path's (with K14's hits, which has no adjoint)
    scale."""
    import torch
    import tpusky_torch as tt
    from tpusky_torch.models.sunsky.model import precompute
    from tpusky_torch.render import bsdf as B
    from tpusky_torch.render import integrator
    from tpusky_torch.render.film import Film, develop
    from tpusky_torch.render.scene import with_mesh_tables
    tables = tt.load_tables("rgb", device=dev)
    scene, sensor = _textured_scene(None, dev)
    scene = with_mesh_tables(scene)
    film = Film(TEX_GRAD, TEX_GRAD, 3)
    kinds = B.table_kinds(scene.bsdfs)
    names = ("atlas", "color0", "color1", "turbidity")

    def case(plain):
        leaves = [getattr(scene.textures, f).clone().requires_grad_()
                  for f in names[:3]]
        t = torch.tensor(3.0, device=dev, requires_grad=True)
        p = tt.make_params(turbidity=t, albedo=0.3, sun_direction=SUN,
                           device=dev)
        sc = scene._replace(env=precompute(tables, p), textures=(
            scene.textures._replace(**dict(zip(names, leaves)))))
        img = develop(integrator.render_rows(
            sc, sensor, film, SEED, TEX_GRAD_SPP, MESH_DEPTH, 1000, "rgb",
            0, TEX_GRAD, kinds=kinds, plain=plain))
        return torch.autograd.grad((img ** 2).mean(), leaves + [t])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads_k, launches = _counted(lambda: case(False))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    _require(launches, ("sunsky_hit_rgb", "sunsky_nee_rgb", "mesh_intersect",
                        "sunsky_eval_rgb_bwd", "sunsky_nee_rgb_bwd"),
             "the textured frame's gradient")
    t0 = time.perf_counter()
    with _k14_as_plain_mesh(scene.mesh_tables):
        grads_p = case(True)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    for name, a, b in zip(names, grads_k, grads_p):
        if not (bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0):
            raise AssertionError(f"textured gradient d{name}: zero or not "
                                 "finite")
        _check_scale(f"textured frame gradient d{name} ({TEX_GRAD}x"
                     f"{TEX_GRAD}x{TEX_GRAD_SPP}, depth {MESH_DEPTH}): "
                     "kernels vs plain on the card", a, b, 1e-3)
    print(f"time textured frame fwd+bwd ({TEX_GRAD}x{TEX_GRAD}x"
          f"{TEX_GRAD_SPP}, depth {MESH_DEPTH}, to the atlas, the checker "
          f"colours and the turbidity, precompute included; one call "
          f"each, the host clock): kernels {ms:.2f} ms, plain with K14's "
          f"hits {plain_ms:.2f} ms; launches {launches} [{card}]")


def _textured_aov_check(dev, card):
    """`render_aovs` of the textured scene at TEX_AOV^2 through K14
    against the plain mesh intersection: prim_index equal but on lanes
    whose two hits tie in t (counted), every other channel within 1e-5 of
    its scale; K14 launches once."""
    import torch
    import tpusky_torch as tt
    from tpusky_torch.render.aov import render_aovs
    state = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=SUN, device=dev))
    scene, sensor = _textured_scene(state, dev)
    out_k, launches = _counted(lambda: render_aovs(scene, sensor, TEX_AOV,
                                                   TEX_AOV))
    if launches["mesh_intersect"] != 1:
        raise AssertionError(f"render_aovs launched K14 "
                             f"{launches['mesh_intersect']} times, not once")
    t0 = time.perf_counter()
    out_p = render_aovs(scene, sensor, TEX_AOV, TEX_AOV, plain=True)
    plain_s = time.perf_counter() - t0
    differ = out_k["prim_index"] != out_p["prim_index"]
    ties = differ & (out_k["depth"] == out_p["depth"])
    n_differ, n_ties = int(differ.sum()), int(ties.sum())
    errs = {k: _scale_err(out_k[k].float(), out_p[k].float())
            for k in ("depth", "position", "uv", "normal", "sh_normal",
                      "geo_normal", "albedo")}
    mesh_share = float((out_k["shape_idx"] == -2).float().mean())
    same_shape = bool(torch.equal(out_k["shape_idx"], out_p["shape_idx"]))
    print(f"check render_aovs {TEX_AOV}x{TEX_AOV}, K14 vs plain: prim_index "
          f"differs on {n_differ} lanes, {n_ties} of them ties in t; "
          f"shape_idx equal {same_shape}; "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" of scale (bar 1e-5); {mesh_share:.3f} of the pixels on the "
          f"mesh; the plain version took {plain_s:.1f} s [{card}]")
    if n_differ != n_ties or n_ties > 1e-4 * TEX_AOV * TEX_AOV:
        raise AssertionError("render_aovs: K14's primitives disagree")
    if not (all(v <= 1e-5 for v in errs.values()) and mesh_share > 0.05
            and same_shape):
        raise AssertionError("render_aovs: K14's channels disagree")
    ms = _time_ms(lambda: render_aovs(scene, sensor, TEX_AOV, TEX_AOV), 3,
                  1)
    print(f"time render_aovs {TEX_AOV}x{TEX_AOV} (K14): {ms:.3f} ms "
          f"[{card}]")


def textured_frame_phase(dev, card):
    """Phase 19: the textured frame at full width, RGB and spectral, its
    gradient and its AOVs (see the module docstring)."""
    import torch
    import tpusky_torch as tt
    t_phase = time.perf_counter()
    state = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=SUN, device=dev))
    scene, sensor = _textured_scene(state, dev)
    crop = _textured_scene(tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=SUN, device="cpu")), "cpu")
    _textured_frame("textured frame", scene, sensor, "rgb", card, crop=crop)
    del scene, crop
    print(f"phase 19 RGB frame: {time.perf_counter() - t_phase:.1f} s")

    state_s = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=SUN, mode="spectral",
        device=dev), mode="spectral")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene_s, sensor = _textured_scene(state_s, dev, spectral=True)
    torch.cuda.synchronize()
    print(f"time textured spectral scene build ({TEX_SIZE}^2 + "
          f"{NMAP_SIZE}^2 + {VOL_SIZE}^3 texels fitted on the card): "
          f"{time.perf_counter() - t0:.2f} s [{card}]")
    _texel_fit_check(dev, card)
    _textured_frame("textured spectral frame", scene_s, sensor, "spectral",
                    card)
    del scene_s
    _textured_grad_check(dev, card)
    _textured_aov_check(dev, card)


# phase 20: participating media at full width
FOG_DEPTH = 6
FOG_RR = 3
FOG_TURNS = 2
FOG_GRID = 64               # region (b)'s density grid, FOG_GRID^3
FOG_STEPS = 64              # its march steps
FOG_BAND = (256, 2)         # rows held against the CPU's plain lanes
FOG_GRAD = 256              # the gradient frame: 256x256x4, depth 4
FOG_GRAD_SPP = 4
FOG_GRAD_DEPTH = 4
# torch's gather and advanced-indexing kernels: the grid's corner lookups
# (and the scene's few table rows)
GATHERS = ("(?:index_elementwise_kernel|vectorized_gather_kernel"
           "|_scatter_gather_elementwise_kernel)")


def _fog_scene(state, device, spectral=False):
    """The headline scene (a diffuse sphere on a diffuse ground, the
    headline camera) in two regions of fog: (a) medium_sphere's
    homogeneous Henyey-Greenstein sphere (sigma_t [0.8, 1.2, 1.6], albedo
    0.7, g 0.3, `tools/gen_scene_goldens.py:145-157`) of radius 1.4 about
    the sphere, and (b) a cube over the ground (8 x 8 x 1, z in [0, 1])
    holding a FOG_GRID^3 density grid made from a seed, FOG_STEPS march
    steps, Rayleigh phase, spectral-MIS free flight. In spectral mode each
    region has one channel (R14)."""
    from tpusky_torch.render.medium import make_medium
    from tpusky_torch.render.scene import make_scene
    from tpusky_torch.render.sensors import make_perspective
    rng = np.random.default_rng(20)
    grid = (0.2 + 1.6 * rng.random((FOG_GRID,) * 3)).astype(np.float32)

    def at(scale, xyz):
        m = np.diag(list(scale) + [1.0]).astype(np.float32)
        m[:3, 3] = xyz
        return m
    halo = make_medium([1.2] if spectral else [0.8, 1.2, 1.6],
                       [0.7] if spectral else [0.7] * 3, g=0.3,
                       kind="sphere", to_world=at([1.4] * 3, [0, 0, 1.0]),
                       device=device)
    ground_fog = make_medium(
        [0.6] if spectral else [0.5, 0.6, 0.8],
        [0.85] if spectral else [0.9, 0.85, 0.8], kind="cube",
        to_world=at([4.0, 4.0, 0.5], [0, 0, 0.5]), density=grid,
        n_steps=FOG_STEPS, phase="rayleigh", channel_mis=True, device=device)
    scene = make_scene(
        shapes=[dict(kind=1, to_world=at([10.0, 10.0, 1.0], [0, 0, 0]),
                     bsdf_idx=0),
                dict(kind=0, to_world=at([1.0] * 3, [0, 0, 1.0]),
                     bsdf_idx=1)],
        bsdf_albedos=[[0.4, 0.4, 0.4], [0.6, 0.2, 0.2]], env=state,
        medium=(halo, ground_fog), device=device)
    sensor = make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device=device)
    return scene, sensor


def _fog_frame(label, scene, sensor, mode, card, cpu):
    """A fog frame (H x W x SPP, depth FOG_DEPTH, Russian roulette from
    FOG_RR) through render() in `mode`: the mode's sunsky kernels launch,
    K4 not; two calls bitwise equal; no synchronisation; all its lanes
    within 1e-3 of the plain path on the card on >= 99.9% (the share of
    lanes whose Russian-roulette decision differs printed), the FOG_BAND
    rows against the CPU's plain lanes (`cpu`: the scene and sensor on
    the CPU) too; render()'s wall time in turns with the plain path's,
    the launches, the peak memory, the busy share and the gathers' share
    of the device time. Returns the launches of one render()."""
    import torch
    from tpusky_torch.render import bsdf as B
    from tpusky_torch.render import integrator
    from tpusky_torch.render.film import Film
    film = Film(H, W, 3)
    kinds = B.table_kinds(scene.bsdfs)
    sky = (("sunsky_hit_rgb", "sunsky_nee_rgb") if mode == "rgb"
           else ("sunsky_hit_spec", "sunsky_nee_spec"))
    focus = ((("K2", "hit_kernel"), ("K3", "nee_kernel")) if mode == "rgb"
             else (("K10", "hit_spec_kernel"), ("K11", "nee_spec_kernel")))

    def frame():
        return integrator.render(scene, sensor, film, SEED, spp=SPP,
                                 max_depth=FOG_DEPTH, rr_depth=FOG_RR,
                                 mode=mode)

    def plain_frame():
        return integrator.render_rows(scene, sensor, film, SEED, SPP,
                                      FOG_DEPTH, FOG_RR, mode, 0, H,
                                      kinds=kinds, plain=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img, launches = _counted(frame)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label}: {first_s:.2f} s (first call), kinds {kinds}, launches "
          f"{launches}, peak memory {peak_gib:.2f} GiB")
    _require(launches, sky, f"the {label}")
    if launches["direct_rgb_megakernel"] != 0:
        raise AssertionError(f"the {label} went through K4")
    if not (img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
            and float(img.mean()) > 0.0):
        raise AssertionError(f"{label}: image not finite, shaped or lit")
    if not torch.equal(frame(), img):
        raise AssertionError(f"two render() calls of the {label} differ")
    _no_sync(frame, f"the {label}'s render()")
    logs = ([], [])
    with torch.no_grad():
        lanes_k, lanes_p = (integrator._lane_radiance(
            scene, sensor, film, SEED, SPP, 0, SPP, FOG_DEPTH, FOG_RR, mode,
            0, H, kinds=kinds, plain=plain, rr_log=log)
            for plain, log in ((False, logs[0]), (True, logs[1])))
        share, worst = _lanes_share(lanes_k, lanes_p)
        rr_diff = torch.zeros_like(logs[0][0])
        for a, b in zip(*logs):
            rr_diff |= a != b
        rr_share = float(rr_diff.float().mean())
        del lanes_p, logs, rr_diff
        row0, n_rows = FOG_BAND
        band = slice(row0 * W * SPP, (row0 + n_rows) * W * SPP)
        t0 = time.perf_counter()
        band_c = integrator._lane_radiance(
            *cpu, film, SEED, SPP, 0, SPP, FOG_DEPTH, FOG_RR, mode, row0,
            n_rows, kinds=kinds)
        cpu_s = time.perf_counter() - t0
        band_share, band_worst = _lanes_share(lanes_k[band].cpu(), band_c)
    print(f"check {label} lanes: {share:.2e} of {lanes_k.shape[0]} lanes "
          f"outside 1e-3 of the plain path (bar 1e-3), max {worst:.3e}; "
          f"Russian roulette's decision differs on {rr_share:.2e} of the "
          f"lanes; rows {row0}-{row0 + n_rows} against the CPU's plain "
          f"lanes: {band_share:.2e} of {band_c.shape[0]} outside, max "
          f"{band_worst:.3e} (the CPU took {cpu_s:.1f} s); two render() "
          f"calls bitwise equal; image mean {float(img.mean()):.5f} max "
          f"{float(img.max()):.3f}")
    if not (share <= 1e-3 and band_share <= 1e-3):
        raise AssertionError(f"the {label} disagrees with the plain path")
    del lanes_k, band_c
    plain_frame()
    ms, plain_ms, runs, plain_runs = _turns(frame, plain_frame, FOG_TURNS)
    busy = _profile_window(label, frame, card, iters=1,
                           focus=focus + (("gathers", GATHERS),))
    print(f"time {label} ({W}x{H}x{SPP}, depth {FOG_DEPTH}, Russian "
          f"roulette from {FOG_RR}, {len(scene.medium)} regions, a "
          f"{FOG_GRID}^3 grid at {FOG_STEPS} steps, {mode}): render() "
          f"{ms:.3f} ms (runs {', '.join(f'{t:.2f}' for t in runs)}), plain "
          f"path {plain_ms:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in plain_runs)}), in turns; "
          f"{launches[sky[0]]} {sky[0]} and {launches[sky[1]]} {sky[1]} "
          f"launches a render(); peak memory {peak_gib:.2f} GiB; device "
          f"busy {100 * busy:.1f}% [{card}]")
    return launches


def _fog_grad_check(dev, card):
    """fwd+bwd of the fog frame at FOG_GRAD^2 x FOG_GRAD_SPP, depth
    FOG_GRAD_DEPTH, mean(img^2) to region (b)'s density grid, region
    (a)'s sigma_t and the turbidity (through precompute, so the sky's
    adjoints run): K2, K3, K5 and K6 launch; each gradient within 1e-3
    of the plain path's scale; the time and the peak memory (the grid's
    marches rematerialised in the backward). Returns the launches."""
    import torch
    import tpusky_torch as tt
    from tpusky_torch.models.sunsky.model import precompute
    from tpusky_torch.render import bsdf as B
    from tpusky_torch.render import integrator
    from tpusky_torch.render.film import Film, develop
    tables = tt.load_tables("rgb", device=dev)
    scene, sensor = _fog_scene(None, dev)
    film = Film(FOG_GRAD, FOG_GRAD, 3)
    kinds = B.table_kinds(scene.bsdfs)
    names = ("grid", "sigma_t", "turbidity")

    def case(plain):
        halo, fog = scene.medium
        leaves = [fog.density.clone().requires_grad_(),
                  halo.sigma_t.clone().requires_grad_(),
                  torch.full((), 3.0, device=dev, requires_grad=True)]
        p = tt.make_params(turbidity=leaves[2], albedo=0.3,
                           sun_direction=SUN, device=dev)
        sc = scene._replace(env=precompute(tables, p), medium=(
            halo._replace(sigma_t=leaves[1]),
            fog._replace(density=leaves[0])))
        img = develop(integrator.render_rows(
            sc, sensor, film, SEED, FOG_GRAD_SPP, FOG_GRAD_DEPTH, 1000, "rgb",
            0, FOG_GRAD, kinds=kinds, plain=plain))
        return torch.autograd.grad((img ** 2).mean(), leaves)
    case(False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grads_k, launches = _counted(lambda: case(False))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    _require(launches, ("sunsky_hit_rgb", "sunsky_nee_rgb",
                        "sunsky_eval_rgb_bwd", "sunsky_nee_rgb_bwd"),
             "the fog frame's gradient")
    t0 = time.perf_counter()
    grads_p = case(True)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    for name, a, b in zip(names, grads_k, grads_p):
        if not (bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0):
            raise AssertionError(f"fog gradient d{name}: zero or not finite")
        _check_scale(f"fog frame gradient d{name} ({FOG_GRAD}x{FOG_GRAD}x"
                     f"{FOG_GRAD_SPP}, depth {FOG_GRAD_DEPTH}): kernels vs "
                     "plain on the card", a, b, 1e-3)
    print(f"time fog frame fwd+bwd ({FOG_GRAD}x{FOG_GRAD}x{FOG_GRAD_SPP}, "
          f"depth {FOG_GRAD_DEPTH}, to the {FOG_GRID}^3 grid, the halo's "
          f"sigma_t and the turbidity, precompute included; one call each, "
          f"the host clock): kernels {ms:.2f} ms, plain {plain_ms:.2f} ms; "
          f"peak memory {peak_gib:.2f} GiB; launches {launches} [{card}]")
    return launches


def fog_frame_phase(dev, card):
    """Phase 20: the fog frame at full width, RGB and spectral, and its
    gradient (see the module docstring). Returns each run's launches."""
    import tpusky_torch as tt
    out = {}
    for mode in ("rgb", "spectral"):
        t0 = time.perf_counter()

        def state(device, mode=mode):
            return tt.sunsky_precompute(tt.make_params(
                turbidity=3.0, albedo=0.3, sun_direction=SUN, mode=mode,
                device=device), mode=mode)
        spectral = mode == "spectral"
        scene, sensor = _fog_scene(state(dev), dev, spectral)
        cpu = _fog_scene(state("cpu"), "cpu", spectral)
        out[mode] = _fog_frame(f"fog frame ({mode})", scene, sensor, mode,
                               card, cpu)
        del scene, cpu
        print(f"phase 20 {mode}: {time.perf_counter() - t0:.1f} s")
    out["gradient"] = _fog_grad_check(dev, card)
    return out


# phase 21: the light-traced frame
PT_PARTICLES = 1 << 22
PT_DEPTH = 4
PT_TURNS = 2
PT_LIT = 0.05               # a lit pixel's mean radiance in render()'s image


def _ptracer_scene(state, device):
    """scene_mesh_gi's geometry (`_mesh_scene` at FRAME_SUBDIV, 81,920
    triangles) under `state`, with a rectangle area panel facing down
    over the ground and a spot light, so that the area, spot and
    environment strategies all run."""
    from tpusky_torch.render.emitters import make_spot
    from tpusky_torch.render.scene import make_scene
    from tpusky_torch.render.sensors import make_perspective
    from tpusky_torch.utils.meshio import icosphere
    pos, idx = icosphere(FRAME_SUBDIV)
    mesh_t2w = np.eye(4, dtype=np.float32)
    mesh_t2w[2, 3] = 1.0
    panel = np.diag([0.6, 0.6, 1.0, 1.0]).astype(np.float32)
    panel[:3, 3] = [1.5, 1.0, 2.6]
    panel[:3, :3] = panel[:3, :3] @ np.diag([1.0, -1.0, -1.0])
    rad = np.zeros((2, 3), np.float32)
    rad[1] = [8.0, 7.0, 6.0]
    scene = make_scene(
        shapes=[dict(kind=1, to_world=np.diag([10.0, 10.0, 1.0, 1.0]),
                     bsdf_idx=0),
                dict(kind=1, to_world=panel, bsdf_idx=2, emitter_idx=0)],
        bsdf_albedos=[[0.5, 0.5, 0.5], [0.3, 0.5, 0.7], [0.0, 0.0, 0.0]],
        meshes=[dict(positions=pos, indices=idx, normals=pos.copy(),
                     to_world=mesh_t2w, bsdf_idx=1)],
        area_radiance=rad, env=state,
        spot_lights=[make_spot([-2.0, -2.0, 3.5], [0.45, 0.45, -0.77],
                               [40.0, 36.0, 32.0], cutoff_angle_deg=25.0,
                               device=device)], device=device)
    sensor = make_perspective([3.5, -3.5, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device=device)
    return scene, sensor


def _ptracer_frame(label, scene, sensor, mode, card):
    """`render_ptracer` at H x W with PT_PARTICLES particles, depth
    PT_DEPTH, in `mode`: K1 (K9 in spectral mode) and K14 launch; two
    calls bitwise equal; every pixel within 1e-3 of the plain path with
    K14's hits (`_k14_as_plain_mesh`) on >= 99.9%; the mean over lit
    pixels (render()'s radiance above PT_LIT where the pixel's centre
    ray hits the scene) within 3% of render()'s at SPP, depth PT_DEPTH,
    as tests/test_plugins_extra.py:342-354 holds the reference; the wall
    time in turns with the plain path's, the launches and the busy
    share. Returns the launches of one call."""
    import torch
    from tpusky_torch.render import integrator
    from tpusky_torch.render.film import Film
    from tpusky_torch.render.ptracer import render_ptracer
    from tpusky_torch.render.scene import with_mesh_tables
    from tpusky_torch.render.sensors import sample_ray
    film = Film(H, W, 3)
    scene_k = with_mesh_tables(scene)
    sky = "sunsky_eval_rgb" if mode == "rgb" else "sunsky_eval_spec"
    focus = (("K1", "eval_kernel") if mode == "rgb"
             else ("K9", "eval_spec_kernel"))

    def frame():
        return render_ptracer(scene, sensor, film, SEED, PT_PARTICLES,
                              PT_DEPTH, mode=mode)

    def plain_frame():
        with _k14_as_plain_mesh(scene_k.mesh_tables):
            return render_ptracer(scene, sensor, film, SEED, PT_PARTICLES,
                                  PT_DEPTH, mode=mode, plain=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img, launches = _counted(frame)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label}: {first_s:.2f} s (first call), launches {launches}, "
          f"peak memory {peak_gib:.2f} GiB")
    _require(launches, (sky, "mesh_intersect"), f"the {label}")
    if not (img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
            and float(img.mean()) > 0.0):
        raise AssertionError(f"{label}: image not finite, shaped or lit")
    if not torch.equal(frame(), img):
        raise AssertionError(f"two render_ptracer() calls of the {label} "
                             "differ")
    img_p = plain_frame()
    share, worst = _lanes_share(img.reshape(-1, 3), img_p.reshape(-1, 3))
    path = integrator.render(scene, sensor, film, SEED, spp=SPP,
                             max_depth=PT_DEPTH, mode=mode)
    with torch.no_grad():
        ys, xs = torch.meshgrid(
            (torch.arange(H, device=img.device) + 0.5) / H,
            (torch.arange(W, device=img.device) + 0.5) / W, indexing="ij")
        o, d = sample_ray(sensor, torch.stack([xs, ys], -1).reshape(-1, 2))
        hit = integrator._scene_hit(scene_k, o, d, False)[5].reshape(H, W)
        lit = hit & (path.mean(-1) > PT_LIT)
        m_p, m_f = float(img[lit].mean()), float(path[lit].mean())
        rel = abs(m_p - m_f) / m_f
        n_lit = int(lit.sum())
    print(f"check {label}: {share:.2e} of {H * W} pixels outside 1e-3 of "
          f"the plain path with K14's hits (bar 1e-3), max {worst:.3e}; two "
          f"calls bitwise equal; the mean over {n_lit} lit pixels {m_p:.5f} "
          f"against render()'s {m_f:.5f} ({W}x{H}x{SPP}, depth {PT_DEPTH}): "
          f"{100 * rel:.2f}% (bar 3%)")
    if not (share <= 1e-3 and rel <= 0.03 and n_lit > 0.1 * H * W):
        raise AssertionError(f"the {label} disagrees")
    ms, plain_ms, runs, plain_runs = _turns(frame, plain_frame, PT_TURNS)
    busy = _profile_window(label, frame, card, iters=1,
                           focus=(focus, ("K14", "mesh_isect_kernel"),
                                  ("sorts", "\\w*[Ss]ort\\w*")))
    print(f"time {label} ({W}x{H}, {PT_PARTICLES} particles, depth "
          f"{PT_DEPTH}, {int(scene.mesh.valid.sum())} triangles, {mode}): "
          f"render_ptracer() {ms:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in runs)}), plain path with K14's "
          f"hits {plain_ms:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in plain_runs)}), in turns; "
          f"{launches[sky]} {sky} and {launches['mesh_intersect']} K14 "
          f"launches a call; peak memory {peak_gib:.2f} GiB; device busy "
          f"{100 * busy:.1f}% [{card}]")
    return launches


def ptracer_phase(dev, card):
    """Phase 21: the light-traced frame, RGB and spectral (see the module
    docstring). Returns each run's launches."""
    import tpusky_torch as tt
    out = {}
    for mode in ("rgb", "spectral"):
        t0 = time.perf_counter()
        state = tt.sunsky_precompute(tt.make_params(
            turbidity=3.0, albedo=0.3, sun_direction=SUN, mode=mode,
            device=dev), mode=mode)
        scene, sensor = _ptracer_scene(state, dev)
        out[mode] = _ptracer_frame(f"light-traced frame ({mode})", scene,
                                   sensor, mode, card)
        print(f"phase 21 {mode}: {time.perf_counter() - t0:.1f} s")
    return out


# phase 22: the Stokes frames
STOKES_DEPTH = 4
STOKES_TURNS = 1
STOKES_BAND = (256, 2)      # rows held against the fully plain path
STOKES_CPU = (256, 224, 64)     # the row, first column and columns whose
                                # first samples are held against the CPU
STOKES_CHUNK = 4            # spp a lane check holds at once
STOKES_LANES = 1 << 20      # render_stokes' live wavefront
AU_IOR = ([0.143, 0.375, 1.442], [3.983, 2.386, 1.603])  # loader.py:419
MALUS = (0.0, 30.0, 45.0, 60.0, 90.0)


def _stokes_scene(state, device, depolarizing=False):
    """The Stokes frame: the headline camera and sunsky; the sphere as a
    rough gold conductor (alpha 0.1) on a pplastic ground (alpha 0.08,
    reflectance [0.3, 0.2, 0.1]); phase 9's 81,920-triangle icosphere as
    a smooth dielectric (ior 1.5) beside it; three rectangles 1.2 in
    front of the camera, each about a sixth of the view: a linear
    polarizer at 30 degrees, a quarter-wave retarder at 45 and a
    right-handed circular polarizer; an area panel (RGB [5, 4, 3]) above
    and a point light. `depolarizing`: every material diffuse, no
    filters, no point light (the S0 check)."""
    from tpusky_torch.render.scene import make_scene
    from tpusky_torch.render.sensors import make_perspective
    from tpusky_torch.utils.meshio import icosphere

    def at(scale, xyz):
        m = np.diag(list(scale) + [1.0]).astype(np.float32)
        m[:3, 3] = xyz
        return m
    eye, target = np.array([4.0, -4.0, 2.0]), np.array([0.0, 0.0, 1.0])
    f = (target - eye) / np.linalg.norm(target - eye)
    r = np.cross(f, [0.0, 0.0, 1.0])
    r /= np.linalg.norm(r)
    u = np.cross(r, f)
    panel = at([0.8, 0.8, 1.0], [0.0, 0.0, 4.0])
    panel[:3, :3] = panel[:3, :3] @ np.diag([1.0, -1.0, -1.0])
    shapes = [dict(kind=1, to_world=at([10.0, 10.0, 1.0], [0, 0, 0]),
                   bsdf_idx=0),
              dict(kind=0, to_world=at([1.0] * 3, [0, 0, 1.0]), bsdf_idx=1),
              dict(kind=1, to_world=panel, bsdf_idx=5, emitter_idx=0)]
    if not depolarizing:
        for i, (dx, dy) in enumerate(((-0.25, 0.22), (0.25, 0.22),
                                      (0.0, -0.25))):
            m = np.eye(4, dtype=np.float32)
            m[:3, 0], m[:3, 1], m[:3, 2] = r * 0.2, u * 0.2, -f
            m[:3, 3] = eye + 1.2 * f + dx * r + dy * u
            shapes.append(dict(kind=1, to_world=m, bsdf_idx=2 + i))
    area = np.zeros((len(shapes), 3), np.float32)
    area[2] = [5.0, 4.0, 3.0]
    extras = np.zeros((7, 8), np.float32)
    extras[2, 0] = 30.0
    extras[3, :2] = [45.0, 90.0]
    pos, idx = icosphere(FRAME_SUBDIV)
    scene = make_scene(
        shapes=shapes,
        bsdf_kinds=[0] * 7 if depolarizing else [11, 1, 12, 13, 14, 0, 3],
        bsdf_albedos=[[0.3, 0.2, 0.1], [1.0] * 3, [1.0] * 3, [1.0] * 3,
                      [1.0] * 3, [0.5] * 3, [1.0] * 3],
        bsdf_alphas=[0.08] + [0.1] * 6, bsdf_etas=[AU_IOR[0]] * 7,
        bsdf_ks=[AU_IOR[1]] * 7, bsdf_iors=[1.49] + [1.5] * 6,
        bsdf_extras=extras, area_radiance=area,
        point_lights=None if depolarizing else [[-2.5, -1.0, 3.5, 8.0, 8.0,
                                                 8.0]],
        meshes=[dict(positions=pos, indices=idx, normals=pos.copy(),
                     to_world=at([0.7] * 3, [1.5, 1.3, 0.7]), bsdf_idx=6)],
        env=state, device=device)
    sensor = make_perspective(list(eye), list(target), fov_x_deg=45,
                              device=device)
    return scene, sensor


def _stokes_share(lanes_k, lanes_p):
    """(share of Stokes lanes (N, C, 4) whose largest error, per channel
    relative to the plain lanes' S0 there (floor 1e-3; |S1..S3| <= S0),
    exceeds 1e-3; that error's maximum)."""
    rel = ((lanes_k - lanes_p).abs()
           / lanes_p[..., :1].clamp(min=1e-3)).flatten(1).amax(-1)
    return float((rel > 1e-3).float().mean()), float(rel.max())


def _stokes_frame(label, scene, sensor, mode, card, cpu):
    """A Stokes frame (H x W x SPP, depth STOKES_DEPTH) through
    render_stokes in `mode`: the mode's sunsky kernels and K14 launch, K4
    not; two calls bitwise equal; no synchronisation; every lane within
    1e-3 of the plain path with K14's hits on >= 99.9%, the STOKES_BAND
    rows of the fully plain path (the dense mesh intersection) and the
    first samples of a part of a row of the CPU's too; the degree of polarization at
    most 1 + 1e-4 where S0 > 1e-3 and above 0.1 somewhere; the wall time
    in turns with the plain path's, the launches, the peak memory and the
    busy share. Returns the launches of one render_stokes."""
    import torch
    from tpusky_torch.render import bsdf as B
    from tpusky_torch.render.film import Film
    from tpusky_torch.render.polarized import render_stokes, stokes_lanes
    from tpusky_torch.render.scene import with_mesh_tables
    film = Film(H, W, 3)
    lanes_film = Film(H, W, 12)
    kinds = B.table_kinds(scene.bsdfs)
    scene_k = with_mesh_tables(scene)
    sky = (("sunsky_hit_rgb", "sunsky_nee_rgb") if mode == "rgb"
           else ("sunsky_hit_spec", "sunsky_nee_spec"))
    focus = ((("K2", "hit_kernel"), ("K3", "nee_kernel")) if mode == "rgb"
             else (("K10", "hit_spec_kernel"), ("K11", "nee_spec_kernel")))

    def frame():
        return render_stokes(scene, sensor, film, SEED, spp=SPP,
                             max_depth=STOKES_DEPTH, mode=mode,
                             max_lanes=STOKES_LANES)

    def plain_frame():
        with _k14_as_plain_mesh(scene_k.mesh_tables):
            return render_stokes(scene, sensor, film, SEED, spp=SPP,
                                 max_depth=STOKES_DEPTH, mode=mode,
                                 max_lanes=STOKES_LANES, plain=True)

    def lanes(sc, se, plain, spp0, chunk=STOKES_CHUNK, row0=0,
              n_rows=None, col0=0, n_cols=None):
        return stokes_lanes(sc, se, lanes_film, SEED, SPP, spp0, chunk,
                            STOKES_DEPTH, 1000, mode, kinds=kinds,
                            plain=plain, row0=row0, n_rows=n_rows,
                            col0=col0, n_cols=n_cols)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img, launches = _counted(frame)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label}: {first_s:.2f} s (first call), kinds {kinds}, launches "
          f"{launches}, peak memory {peak_gib:.2f} GiB")
    _require(launches, sky + ("mesh_intersect",), f"the {label}")
    if launches["direct_rgb_megakernel"] != 0:
        raise AssertionError(f"the {label} went through K4")
    if not (img.shape == (H, W, 4, 3) and bool(torch.isfinite(img).all())
            and float(img[:, :, 0].mean()) > 0.0):
        raise AssertionError(f"{label}: image not finite, shaped or lit")
    if not torch.equal(frame(), img):
        raise AssertionError(f"two render_stokes calls of the {label} "
                             "differ")
    _no_sync(frame, f"the {label}'s render_stokes")
    steps = [("first call, repeat, sync check", time.perf_counter() - t0)]
    s0 = img[:, :, 0]
    dop = img[:, :, 1:].norm(dim=2) / s0.clamp(min=1e-6)
    lit = s0 > 1e-3
    dop_max = float(dop[lit].max())
    print(f"check {label} degree of polarization: max {dop_max:.6f} over "
          f"{int(lit.sum())} lit pixel channels (bars <= 1 + 1e-4, > 0.1); "
          f"mean S0 {float(s0.mean()):.5f}, mean |S1..S3| "
          f"{float(img[:, :, 1:].abs().mean()):.5f}")
    if not (dop_max <= 1.0 + 1e-4 and dop_max > 0.1):
        raise AssertionError(f"the {label}'s degree of polarization is out "
                             "of bounds")
    t0 = time.perf_counter()
    with torch.no_grad():
        n_out, n_all, worst = 0, 0, 0.0
        kernel_band = []
        row0, n_rows = STOKES_BAND
        for spp0 in range(0, SPP, STOKES_CHUNK):
            lanes_k = lanes(scene_k, sensor, False, spp0)
            with _k14_as_plain_mesh(scene_k.mesh_tables):
                lanes_p = lanes(scene, sensor, True, spp0)
            share, w = _stokes_share(lanes_k, lanes_p)
            n_out += share * lanes_k.shape[0]
            n_all += lanes_k.shape[0]
            worst = max(worst, w)
            kernel_band.append(lanes_k.reshape(
                H, W, STOKES_CHUNK, 3, 4)[row0:row0 + n_rows])
            del lanes_k, lanes_p
        kernel_band = torch.cat(kernel_band, 2).reshape(-1, 3, 4)
        steps.append(("lanes", time.perf_counter() - t0))
        t0 = time.perf_counter()
        band_p = lanes(scene, sensor, True, 0, SPP, row0, n_rows)
        band_share, band_worst = _stokes_share(kernel_band, band_p)
        t_cpu = time.perf_counter()
        cpu_row, col0, n_cols = STOKES_CPU
        cpu_lanes = lanes(*cpu, True, 0, 1, cpu_row, 1, col0, n_cols)
        cpu_s = time.perf_counter() - t_cpu
        first = kernel_band.reshape(n_rows, W, SPP, 3, 4)[
            cpu_row - row0, col0:col0 + n_cols, 0].cpu()
        cpu_share, cpu_worst = _stokes_share(first, cpu_lanes)
    steps.append(("dense band and CPU", time.perf_counter() - t0))
    share = n_out / n_all
    print(f"check {label} lanes: {share:.2e} of {n_all} lanes outside 1e-3 "
          f"of the plain path with K14's hits (bar 1e-3), max {worst:.3e}; "
          f"rows {row0}-{row0 + n_rows} against the fully plain path (dense "
          f"mesh): {band_share:.2e} of {band_p.shape[0]} outside, max "
          f"{band_worst:.3e}; row {cpu_row}, columns {col0}-{col0 + n_cols}"
          f", first samples against the CPU: {cpu_share:.2e} of "
          f"{cpu_lanes.shape[0]} outside, max "
          f"{cpu_worst:.3e} (the CPU took {cpu_s:.1f} s); two calls "
          f"bitwise equal")
    if not (share <= 1e-3 and band_share <= 1e-3 and cpu_share <= 1e-3):
        raise AssertionError(f"the {label} disagrees with the plain path")
    del kernel_band, band_p
    t0 = time.perf_counter()
    plain_frame()
    ms, plain_ms, runs, plain_runs = _turns(frame, plain_frame,
                                            STOKES_TURNS)
    steps.append(("turns", time.perf_counter() - t0))
    # the profile of one chunk (half the frame's samples): its ~30K
    # launches take the profiler's bookkeeping ~25 s, the frame's ~50 s
    chunk_spp = min(SPP, max(1, STOKES_LANES // (H * W)))

    def chunk():
        return render_stokes(scene, sensor, film, SEED, spp=chunk_spp,
                             max_depth=STOKES_DEPTH, mode=mode,
                             max_lanes=STOKES_LANES)
    t0 = time.perf_counter()
    busy = _profile_window(f"{label}, one chunk of {STOKES_LANES} lanes",
                           chunk, card, iters=1,
                           focus=(("K14", "mesh_isect_kernel"),) + focus)
    steps.append(("profile", time.perf_counter() - t0))
    print(f"time {label} ({W}x{H}x{SPP}, depth {STOKES_DEPTH}, "
          f"{int(scene.mesh.valid.sum())} triangles, {mode}): render_stokes "
          f"{ms:.3f} ms (runs {', '.join(f'{t:.2f}' for t in runs)}), plain "
          f"path with K14's hits {plain_ms:.3f} ms (runs "
          f"{', '.join(f'{t:.2f}' for t in plain_runs)}), in turns; "
          f"{launches[sky[0]]} {sky[0]}, {launches[sky[1]]} {sky[1]} and "
          f"{launches['mesh_intersect']} K14 launches a call; peak memory "
          f"{peak_gib:.2f} GiB; device busy {100 * busy:.1f}% (one chunk) "
          f"[{card}]")
    print(f"{label} steps: "
          + ", ".join(f"{name} {t:.1f} s" for name, t in steps))
    return launches


def _stokes_s0_check(label, scene, sensor, mode):
    """On the depolarizing variant S0 of every lane equals the scalar
    path's (`_lane_radiance`, the same K2/K3/K14 or K10/K11/K14 lookups)
    within 1e-3 on >= 99.9% of the lanes, and S1..S3 are exactly 0."""
    import torch
    from tpusky_torch.render import bsdf as B
    from tpusky_torch.render import integrator
    from tpusky_torch.render.film import Film
    from tpusky_torch.render.polarized import stokes_lanes
    from tpusky_torch.render.scene import with_mesh_tables
    kinds = B.table_kinds(scene.bsdfs)
    scene = with_mesh_tables(scene)
    n_out, n_all, worst, pol = 0, 0, 0.0, 0.0
    with torch.no_grad():
        for spp0 in range(0, SPP, STOKES_CHUNK):
            st = stokes_lanes(scene, sensor, Film(H, W, 12), SEED, SPP,
                              spp0, STOKES_CHUNK, STOKES_DEPTH, 1000, mode,
                              kinds=kinds)
            sc = integrator._lane_radiance(
                scene, sensor, Film(H, W, 3), SEED, SPP, spp0, STOKES_CHUNK,
                STOKES_DEPTH, 1000, mode, 0, H, kinds=kinds)
            share, w = _lanes_share(st[..., 0], sc)
            n_out += share * sc.shape[0]
            n_all += sc.shape[0]
            worst = max(worst, w)
            pol = max(pol, float(st[..., 1:].abs().max()))
    print(f"check {label} S0 against the scalar path: {n_out / n_all:.2e} "
          f"of {n_all} lanes outside 1e-3 (bar 1e-3), max {worst:.3e}; "
          f"largest |S1..S3| {pol} (bar 0)")
    if not (n_out / n_all <= 1e-3 and pol == 0.0):
        raise AssertionError(f"{label}: S0 differs from the scalar path or "
                             "S1..S3 are not 0")


def _stokes_filter_checks(dev):
    """tests/test_polarized.py:142-184's radiance-meter stacks through
    render_stokes on the card (plain ops: a constant white environment)
    against their closed forms at 1e-4: Malus's law at 0, 30, 45, 60 and
    90 degrees, one polarizer with a degree of polarization of 1, the
    quarter-wave chain (|S3| = S0, S1 = S2 = 0) and the crossed circular
    polarizers."""
    import torch
    from tpusky_torch.render.emitters import ConstantEnv
    from tpusky_torch.render.film import Film
    from tpusky_torch.render.polarized import render_stokes
    from tpusky_torch.render.scene import make_scene
    from tpusky_torch.render.sensors import RadianceMeter
    meter = RadianceMeter(torch.tensor([0.0, 0.0, 3.0], device=dev),
                          torch.tensor([0.0, 0.0, -1.0], device=dev))

    def stack(elements):
        """(4, 3) Stokes seen through rectangles at z = 2, 1, ... (first
        closest to the camera) of (kind, theta, delta, left-handed)."""
        shapes, extras = [], np.zeros((len(elements), 8), np.float32)
        for i, (_, theta, delta, left) in enumerate(elements):
            m = np.eye(4, dtype=np.float32)
            m[2, 3] = 2.0 - i
            shapes.append(dict(kind=1, to_world=m, bsdf_idx=i))
            extras[i, :3] = [theta, delta, left]
        scene = make_scene(
            shapes=shapes, bsdf_kinds=[e[0] for e in elements],
            bsdf_albedos=[[1.0] * 3] * len(elements), bsdf_extras=extras,
            env=ConstantEnv(torch.ones(3, device=dev)), device=dev)
        return render_stokes(scene, meter, Film(2, 2, 3), SEED, spp=1,
                             max_depth=5)[0, 0].cpu().numpy()
    worst = 0.0
    for t in MALUS:
        s = stack([(12, 0.0, 0.0, 0.0), (12, t, 0.0, 0.0)])
        worst = max(worst, abs(s[0].mean() - 0.5 * np.cos(np.deg2rad(t)) ** 2))
    s = stack([(12, 0.0, 0.0, 0.0)])
    dop = np.linalg.norm(s[1:], axis=0) / s[0]
    worst = max(worst, abs(s[0].mean() - 0.5), np.abs(dop - 1.0).max())
    s = stack([(13, 45.0, 90.0, 0.0), (12, 0.0, 0.0, 0.0)])
    worst = max(worst, abs(s[0].mean() - 0.5),
                np.abs(np.abs(s[3]) - s[0]).max(), np.abs(s[1:3]).max())
    same = stack([(14, 0.0, 0.0, 0.0), (14, 0.0, 0.0, 0.0)])
    cross = stack([(14, 0.0, 0.0, 1.0), (14, 0.0, 0.0, 0.0)])
    worst = max(worst, abs(same[0].mean() - 0.5), abs(cross[0].mean()))
    print(f"check Stokes filters (radiance meter, plain ops on the card): "
          f"Malus's law at {MALUS} degrees, one polarizer's degree of "
          f"polarization, the quarter-wave chain and the crossed circular "
          f"polarizers against their closed forms: largest error "
          f"{worst:.2e} (bar 1e-4)")
    if not worst <= 1e-4:
        raise AssertionError("a filter stack misses its closed form")


def stokes_frame_phase(dev, card):
    """Phase 22: the Stokes frames at full width, RGB and spectral, the S0
    check in both modes and the filter stacks (see the module docstring).
    Returns each frame's launches."""
    import tpusky_torch as tt
    out = {}
    for mode in ("rgb", "spectral"):
        t0 = time.perf_counter()

        def state(device, mode=mode):
            return tt.sunsky_precompute(tt.make_params(
                turbidity=3.0, albedo=0.3, sun_direction=SUN, mode=mode,
                device=device), mode=mode)
        st = state(dev)
        scene, sensor = _stokes_scene(st, dev)
        cpu = _stokes_scene(state("cpu"), "cpu")
        print(f"phase 22 {mode}: scenes built in "
              f"{time.perf_counter() - t0:.1f} s")
        out[mode] = _stokes_frame(f"Stokes frame ({mode})", scene, sensor,
                                  mode, card, cpu)
        del scene, cpu
        t1 = time.perf_counter()
        _stokes_s0_check(f"depolarizing Stokes frame ({mode})",
                         *_stokes_scene(st, dev, depolarizing=True), mode)
        print(f"phase 22 {mode}: {time.perf_counter() - t0:.1f} s (the S0 "
              f"check {time.perf_counter() - t1:.1f} s)")
    _stokes_filter_checks(dev)
    return out


# phase 23: SDF grids, curves with hair and measured BRDFs at full width
GEO_DEPTH = 4
GEO_RR = 3
GEO_GRID = 64               # the torus's SDF grid, GEO_GRID^3
GEO_STRANDS = 64            # B-spline strands of GEO_POINTS control points:
GEO_POINTS = 6              # 24 rounded cones each at subdivision 8
GEO_BAND = (224, 32)        # rows profiled
GEO_WAVE = 1 << 20          # rays a timed intersection wavefront
GEO_SPHERE = (256, 8, 3)    # the SDF sphere check: size, spp, depth
GEO_GRAD = 256              # the gradient frame: 256x256x4, depth 3
GEO_GRAD_SPP = 4
GEO_GRAD_DEPTH = 3
GEO_CHI2_N = 10_000_000
GEO_STOKES_BAND = (256, 4)  # rows of the Stokes frame held to plain


def _rgl_fields(seed, spectral=False):
    """RGL-layout tables (one phi_i slice, 8 theta_i, 32x32 warps) made
    from a seed with tests/test_measured.py::_synthetic_fields' formulas:
    a VNDF lobe whose centre moves with theta_i, tapered at the pole, a
    luminance ramp, and RGB planes or, with `spectral`, 8 wavelengths over
    360-830 nm, each plane a smooth function of the wavelength and u."""
    rng = np.random.default_rng(seed)
    t_n, h, w = 8, 32, 32
    theta_i = np.linspace(0, np.pi / 2, t_n).astype(np.float32)
    ut = np.linspace(0, 1, w)[None, None, None, :]
    up = np.linspace(0, 1, h)[None, None, :, None]
    ti = theta_i[None, :, None, None] / (np.pi / 2)
    c0, c1, width = rng.uniform(0.2, 0.4), rng.uniform(0.2, 0.4), 0.25
    vndf = (np.exp(-((ut - c0 - c1 * ti) / width) ** 2) + 0.15
            + 0.05 * np.cos(2 * np.pi * up))
    vndf = np.broadcast_to(vndf * np.clip(ut / 0.2, 0.0, 1.0) ** 2,
                           (1, t_n, h, w)).astype(np.float32)
    lum = np.broadcast_to(0.5 + 0.5 * ut + 0.2 * up + 0.1 * ti,
                          (1, t_n, h, w)).astype(np.float32)
    out = dict(theta_i=theta_i, phi_i=np.zeros((1,), np.float32),
               ndf=np.ones((h, w), np.float32),
               sigma=np.full((h, w), 0.25, np.float32), vndf=vndf,
               luminance=lum, jacobian=np.array([0], np.uint8))
    tint = rng.uniform(0.3, 0.9, 3)
    if spectral:
        wl = np.linspace(360.0, 830.0, 8).astype(np.float32)
        sp = np.zeros((1, t_n, 8, h, w), np.float32)
        for i in range(8):
            sp[:, :, i] = (0.3 + 0.5 * np.sin(0.7 * i) ** 2
                           + 0.1 * np.linspace(0, 1, w))
        out.update(spectra=sp, wavelengths=wl)
    else:
        out["rgb"] = np.broadcast_to(tint[None, None, :, None, None],
                                     (1, t_n, 3, h, w)).astype(np.float32)
    return out


def _pbsdf_fields(seed):
    """A `_synthetic_pbsdf`-layout table (tests/test_measured.py) on wider
    grids (16 phi_d, 12 theta_d, 12 theta_h, 8 wavelengths) from a seed:
    M = [[a, b, 0, 0], [b, a, 0, 0], [0, 0, c, 0], [0, 0, 0, c]], a and
    b varying smoothly over the grid, c = sqrt(a^2 - b^2)."""
    rng = np.random.default_rng(seed)
    n_pd, n_td, n_th, n_l = 16, 12, 12, 8
    th = np.linspace(0, np.pi / 2, n_th)[None, None, :, None]
    td = np.linspace(0, np.pi / 2, n_td)[None, :, None, None]
    lam = np.linspace(0, 1, n_l)[None, None, None, :]
    a = (rng.uniform(0.3, 0.6) * (1.0 + 0.2 * np.cos(th)) + 0.05 * lam
         + 0.0 * td)
    b = rng.uniform(0.1, 0.25) * np.sin(td) ** 2 * np.ones_like(a)
    a = np.broadcast_to(a, (n_pd, n_td, n_th, n_l))
    b = np.broadcast_to(b, (n_pd, n_td, n_th, n_l))
    m = np.zeros((n_pd, n_td, n_th, n_l, 4, 4), np.float32)
    m[..., 0, 0] = m[..., 1, 1] = a
    m[..., 0, 1] = m[..., 1, 0] = b
    m[..., 2, 2] = m[..., 3, 3] = np.sqrt(np.maximum(a * a - b * b, 0.0))
    return dict(phi_d=np.linspace(-np.pi, np.pi, n_pd,
                                  dtype=np.float32)[None],
                theta_d=np.linspace(0, np.pi / 2, n_td,
                                    dtype=np.float32)[None],
                theta_h=np.linspace(0, np.pi / 2, n_th,
                                    dtype=np.float32)[None],
                wvls=np.linspace(400, 700, n_l).astype(np.uint16), M=m)


def _torus_grid(res, major=0.3, minor=0.12):
    g = np.arange(res) / (res - 1) - 0.5
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    return (np.sqrt((np.sqrt(x ** 2 + y ** 2) - major) ** 2 + z ** 2)
            - minor).astype(np.float32)


def _tuft(seed=23):
    """GEO_STRANDS B-spline strands of GEO_POINTS control points rising
    from a disc of radius 0.35 at (1.1, -1.2), 1.6 tall, radius 0.012."""
    rng = np.random.default_rng(seed)
    strands = []
    for _ in range(GEO_STRANDS):
        r, a = 0.35 * np.sqrt(rng.random()), 2 * np.pi * rng.random()
        base = np.array([1.1 + r * np.cos(a), -1.2 + r * np.sin(a)])
        phase, sway = 2 * np.pi * rng.random(), 0.1 + 0.15 * rng.random()
        k = np.arange(GEO_POINTS)
        pts = np.stack([base[0] + sway * np.sin(0.8 * k + phase),
                        base[1] + sway * np.cos(0.6 * k + phase),
                        1.6 * k / (GEO_POINTS - 1)], -1)
        strands.append(dict(points=pts.astype(np.float32), radius=0.012,
                            kind="bspline", bsdf_idx=2))
    return strands


def _geometry_scene(state, device, spectral=False):
    """The headline sunsky and camera over a diffuse ground: a GEO_GRID^3
    SDF torus (major radius 0.6, minor 0.24, about [0, 0, 1]) of the RGL
    measured BRDF (kind 17; `_rgl_fields`) and a tuft of hair (kind 16:
    sigma_a [0.25, 0.45, 0.9], beta_m 0.3, beta_n 0.3, tilt 2 deg, eta
    1.55)."""
    from tpusky_torch.render.measured import load_measured
    from tpusky_torch.render.scene import make_scene
    from tpusky_torch.render.sdf import make_sdf_grid
    from tpusky_torch.render.sensors import make_perspective
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    t2w = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    t2w[:3, 3] = [-1.0, -1.0, 0.0]
    extras = np.zeros((3, 8), np.float32)
    extras[:, 1] = 0.5
    extras[2, :2] = (0.3, 2.0)
    sigma_a = [0.25, 0.45, 0.9]
    scene = make_scene(
        shapes=[dict(kind=1, to_world=ground, bsdf_idx=0)],
        bsdf_kinds=[0, 17, 16],
        bsdf_albedos=[[0.4, 0.4, 0.4], [1.0, 1.0, 1.0], sigma_a],
        bsdf_spectral_albedos=[[0.4] * 11, [1.0] * 11,
                               np.interp(np.linspace(320, 720, 11),
                                         [450, 550, 600], sigma_a[::-1])],
        bsdf_alphas=[0.1, 0.1, 0.3], bsdf_iors=[1.5046, 1.5046, 1.55],
        bsdf_extras=extras, env=state,
        sdf=make_sdf_grid(_torus_grid(GEO_GRID), t2w, 1, device=device),
        curves=_tuft(), measured=load_measured(_rgl_fields(23, spectral),
                                               device=device),
        device=device)
    sensor = make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device=device)
    return scene, sensor


def _intersection_ms(scene, sensor, card):
    """Device ms of each new intersection on GEO_WAVE of the frame's
    camera rays: the curves' closest hit and shadow test, the SDF's."""
    import torch
    from tpusky_torch.render import curve as CV
    from tpusky_torch.render import sdf as SD
    from tpusky_torch.render import sensors as SE
    dev = scene.shapes.to_world.device
    g = torch.Generator(device=dev).manual_seed(23)
    uv = torch.rand((GEO_WAVE, 2), device=dev, generator=g)
    with torch.no_grad():
        o, d = SE.sample_ray(sensor, uv)
        hits = CV.curve_intersect(scene.curve, o, d)[3]
        out = {"curve_intersect": _median_ms(
                   lambda: CV.curve_intersect(scene.curve, o, d), reps=3),
               "curve_test": _median_ms(
                   lambda: CV.curve_test(scene.curve, o, d, torch.inf),
                   reps=3),
               "sdf_intersect": _median_ms(
                   lambda: SD.sdf_intersect(scene.sdf, o, d), reps=3)}
    print(f"time intersections on {GEO_WAVE} camera rays of the geometry "
          f"frame ({int(scene.curve.valid.sum())} rounded cones, "
          f"{float(hits.float().mean()):.4f} of the rays on a strand; a "
          f"{GEO_GRID}^3 SDF, 64 steps): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in out.items())
          + f" [{card}]")
    return out


def _geometry_frame(label, scene, sensor, mode, card):
    """The geometry frame (H x W x SPP, depth GEO_DEPTH, Russian roulette
    from GEO_RR) through render() in `mode`: the mode's sunsky kernels
    launch, K4 not; a second call, under the sync debug mode, bitwise
    equal; >= 99.9% of the lanes within 1e-3 of the plain path's; the
    wall times, launches, peak memory, a band's busy share and the
    intersections' device ms. Returns the launches of one render()."""
    import torch
    from tpusky_torch.render import bsdf as B
    from tpusky_torch.render import integrator
    from tpusky_torch.render.film import Film
    film = Film(H, W, 3)
    kinds = B.table_kinds(scene.bsdfs)
    sky = (("sunsky_hit_rgb", "sunsky_nee_rgb") if mode == "rgb"
           else ("sunsky_hit_spec", "sunsky_nee_spec"))
    focus = ((("K2", "hit_kernel"), ("K3", "nee_kernel")) if mode == "rgb"
             else (("K10", "hit_spec_kernel"), ("K11", "nee_spec_kernel")))

    def frame():
        return integrator.render(scene, sensor, film, SEED, spp=SPP,
                                 max_depth=GEO_DEPTH, rr_depth=GEO_RR,
                                 mode=mode)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img, launches = _counted(frame)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    _require(launches, sky, f"the {label}")
    if launches["direct_rgb_megakernel"] != 0:
        raise AssertionError(f"the {label} went through K4")
    if not (img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
            and float(img.mean()) > 0.0):
        raise AssertionError(f"{label}: image not finite, shaped or lit")
    t0 = time.perf_counter()
    again = _no_sync(frame, f"the {label}'s render()")
    torch.cuda.synchronize()
    again_ms = 1e3 * (time.perf_counter() - t0)
    if not torch.equal(again, img):
        raise AssertionError(f"two render() calls of the {label} differ")
    with torch.no_grad():
        lanes_ms = []
        lanes = []
        for plain in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lanes.append(integrator._lane_radiance(
                scene, sensor, film, SEED, SPP, 0, SPP, GEO_DEPTH, GEO_RR,
                mode, 0, H, kinds=kinds, plain=plain))
            torch.cuda.synchronize()
            lanes_ms.append(1e3 * (time.perf_counter() - t0))
        share, worst = _lanes_share(*lanes)
    print(f"check {label} lanes: {share:.2e} of {lanes[0].shape[0]} lanes "
          f"outside 1e-3 of the plain path (bar 1e-3), max {worst:.3e}; two "
          f"render() calls bitwise equal; image mean {float(img.mean()):.5f} "
          f"max {float(img.max()):.3f}")
    if not share <= 1e-3:
        raise AssertionError(f"the {label} disagrees with the plain path")
    del lanes
    row0, n_rows = GEO_BAND

    def band():
        return integrator.render_rows(scene, sensor, film, SEED, SPP,
                                      GEO_DEPTH, GEO_RR, mode, row0, n_rows,
                                      kinds=kinds)
    t0 = time.perf_counter()
    busy = _profile_window(f"{label}, rows {row0}-{row0 + n_rows}", band,
                           card, iters=1, focus=focus)
    print(f"the {label}'s profile window took "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"time {label} ({W}x{H}x{SPP}, depth {GEO_DEPTH}, Russian "
          f"roulette from {GEO_RR}, {mode}): render() {first_ms:.1f} ms "
          f"(first call), {again_ms:.1f} ms (second, under the sync debug "
          f"mode); lanes through the kernels {lanes_ms[0]:.1f} ms, through "
          f"the plain path {lanes_ms[1]:.1f} ms; {launches[sky[0]]} "
          f"{sky[0]} and {launches[sky[1]]} {sky[1]} launches a render(); "
          f"peak memory {peak_gib:.2f} GiB; device busy {100 * busy:.1f}% "
          f"of a {n_rows}-row band [{card}]")
    return launches


def _sdf_sphere_check(state, dev):
    """A GEO_SPHERE frame of a 64^3 SDF sphere (radius 0.7 about [0, 0,
    1]) on the diffuse ground against the analytic sphere's: the mean
    absolute difference below 0.05 of the analytic frame's mean
    (tests/test_sdf.py::test_sdf_in_scene_render)."""
    from tpusky_torch.render import integrator
    from tpusky_torch.render.film import Film
    from tpusky_torch.render.scene import make_scene
    from tpusky_torch.render.sdf import make_sdf_grid, sphere_sdf_grid
    from tpusky_torch.render.sensors import make_perspective
    size, spp, depth = GEO_SPHERE
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    sphere = np.diag([0.7, 0.7, 0.7, 1.0]).astype(np.float32)
    sphere[2, 3] = 1.0
    t2w = np.diag([2.0, 2.0, 2.0, 1.0]).astype(np.float32)
    t2w[:3, 3] = [-1.0, -1.0, 0.0]
    common = dict(bsdf_albedos=[[0.4] * 3, [0.6, 0.2, 0.2]], env=state,
                  device=dev)
    sdf_scene = make_scene(
        shapes=[dict(kind=1, to_world=ground, bsdf_idx=0)],
        sdf=make_sdf_grid(sphere_sdf_grid(64, 0.35), t2w, 1, device=dev),
        **common)
    ref_scene = make_scene(
        shapes=[dict(kind=1, to_world=ground, bsdf_idx=0),
                dict(kind=0, to_world=sphere, bsdf_idx=1)], **common)
    sensor = make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device=dev)
    film = Film(size, size, 3)
    img_s, img_r = (integrator.render(sc, sensor, film, SEED, spp=spp,
                                      max_depth=depth)
                    for sc in (sdf_scene, ref_scene))
    err = float((img_s - img_r).abs().mean() / img_r.mean().clamp(min=1e-9))
    print(f"check SDF sphere frame ({size}x{size}x{spp}, depth {depth}, a "
          f"64^3 grid) against the analytic sphere's: mean relative "
          f"difference {err:.4f} (bar 0.05)")
    if not (bool(img_s.isfinite().all()) and err < 0.05):
        raise AssertionError("the SDF sphere frame differs from the "
                             "analytic sphere's")


def _geometry_chi2(dev, card):
    """Hair's sampling over the whole sphere and the RGL measured BRDF's
    over the upper hemisphere against their pdfs, the chi-square test at
    N = GEO_CHI2_N (`utils/chi2.py`, the reference's binning), on the
    card."""
    from tpusky_torch.render import bsdf as B
    from tpusky_torch.render.measured import load_measured
    from tpusky_torch.utils.chi2 import BSDFAdapter
    extras = np.zeros((2, 8), np.float32)
    extras[0, :2] = (0.3, 2.0)
    table = B.make_material_table(
        kinds=[16, 17], albedos=[[0.25, 0.45, 0.9], [1.0] * 3],
        alphas=[0.3, 0.1], iors=[1.55, 1.5], extras=extras,
        measured=load_measured(_rgl_fields(23), device=dev), device=dev)
    for row, wi, cos_range in ((0, [0.4, 0.3, 0.866], (-1.0, 1.0)),
                               (1, [0.3, -0.1, 0.95], (0.0, 1.0))):
        wi = np.asarray(wi, np.float32) / np.linalg.norm(wi)
        t0 = time.perf_counter()
        p, ok, info = BSDFAdapter(table, row, wi).run(
            seed=23 + row, cos_range=cos_range, sample_count=GEO_CHI2_N)
        name = ("hair", "measured")[row]
        print(f"check chi-square {name} (N = {GEO_CHI2_N}): p = {p:.4f} "
              f"({time.perf_counter() - t0:.1f} s) [{card}]")
        if not ok:
            raise AssertionError(f"the {name} sampling fails its chi-square "
                                 f"test: p = {p}, {info}")


def _geometry_grad_check(dev, card):
    """fwd+bwd of the geometry frame at GEO_GRAD^2 x GEO_GRAD_SPP, depth
    GEO_GRAD_DEPTH, mean(img^2) to the SDF grid's values and the
    turbidity (through precompute): K2, K3, K5 and K6 launch; each
    gradient within 1e-3 of the plain path's scale; the time and the
    peak memory. Returns the launches."""
    import torch
    import tpusky_torch as tt
    from tpusky_torch.models.sunsky.model import precompute
    from tpusky_torch.render import bsdf as B
    from tpusky_torch.render import integrator
    from tpusky_torch.render.film import Film, develop
    tables = tt.load_tables("rgb", device=dev)
    scene, sensor = _geometry_scene(None, dev)
    film = Film(GEO_GRAD, GEO_GRAD, 3)
    kinds = B.table_kinds(scene.bsdfs)
    names = ("grid", "turbidity")

    def case(plain):
        leaves = [scene.sdf.values.clone().requires_grad_(),
                  torch.full((), 3.0, device=dev, requires_grad=True)]
        p = tt.make_params(turbidity=leaves[1], albedo=0.3,
                           sun_direction=SUN, device=dev)
        sc = scene._replace(env=precompute(tables, p),
                            sdf=scene.sdf._replace(values=leaves[0]))
        img = develop(integrator.render_rows(
            sc, sensor, film, SEED, GEO_GRAD_SPP, GEO_GRAD_DEPTH, 1000,
            "rgb", 0, GEO_GRAD, kinds=kinds, plain=plain))
        return torch.autograd.grad((img ** 2).mean(), leaves)
    case(False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grads_k, launches = _counted(lambda: case(False))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    _require(launches, ("sunsky_hit_rgb", "sunsky_nee_rgb",
                        "sunsky_eval_rgb_bwd", "sunsky_nee_rgb_bwd"),
             "the geometry frame's gradient")
    t0 = time.perf_counter()
    grads_p = case(True)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    for name, a, b in zip(names, grads_k, grads_p):
        if not (bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0):
            raise AssertionError(f"geometry gradient d{name}: zero or not "
                                 "finite")
        _check_scale(f"geometry frame gradient d{name} ({GEO_GRAD}x"
                     f"{GEO_GRAD}x{GEO_GRAD_SPP}, depth {GEO_GRAD_DEPTH}): "
                     "kernels vs plain on the card", a, b, 1e-3)
    print(f"time geometry frame fwd+bwd ({GEO_GRAD}x{GEO_GRAD}x"
          f"{GEO_GRAD_SPP}, depth {GEO_GRAD_DEPTH}, to the {GEO_GRID}^3 SDF "
          f"grid and the turbidity, precompute included; one call each, the "
          f"host clock): kernels {ms:.2f} ms, plain {plain_ms:.2f} ms; peak "
          f"memory {peak_gib:.2f} GiB; launches {launches} [{card}]")
    return launches


def _measured_stokes_frame(state, dev, card):
    """`render_stokes` of the headline sphere as the measured pBRDF (kind
    18, `_pbsdf_fields`, alpha_sample 0.3) on the diffuse ground,
    H x W x SPP, depth 4, RGB: K2 and K3 launch, K4 not; two calls bitwise
    equal; the GEO_STOKES_BAND rows' lanes within 1e-3 of the plain
    path's (>= 99.9%); the degree of polarization at most 1 + 1e-4 where
    S0 > 1e-3 and above 0.1 somewhere. Returns the launches."""
    import torch
    from tpusky_torch.render import bsdf as B
    from tpusky_torch.render import polarized as P
    from tpusky_torch.render.film import Film
    from tpusky_torch.render.measured import load_measured_polarized
    from tpusky_torch.render.scene import make_scene
    from tpusky_torch.render.sensors import make_perspective
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    sphere = np.eye(4, dtype=np.float32)
    sphere[2, 3] = 1.0
    scene = make_scene(
        shapes=[dict(kind=1, to_world=ground, bsdf_idx=0),
                dict(kind=0, to_world=sphere, bsdf_idx=1)],
        bsdf_kinds=[0, 18], bsdf_albedos=[[0.4] * 3, [1.0] * 3], env=state,
        measured_pol=load_measured_polarized(_pbsdf_fields(23), 0.3,
                                             device=dev), device=dev)
    sensor = make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device=dev)
    film = Film(H, W, 3)
    kinds = B.table_kinds(scene.bsdfs)

    def frame():
        return P.render_stokes(scene, sensor, film, SEED, spp=SPP,
                               max_depth=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, launches = _counted(frame)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    _require(launches, ("sunsky_hit_rgb", "sunsky_nee_rgb"),
             "the measured Stokes frame")
    if launches["direct_rgb_megakernel"] != 0:
        raise AssertionError("the measured Stokes frame went through K4")
    if not torch.equal(frame(), img):
        raise AssertionError("two render_stokes calls differ")
    s0 = img[..., 0, :]
    dop = img[..., 1:, :].norm(dim=-2) / s0.clamp(min=1e-6)
    lit = s0 > 1e-3
    if not (bool(torch.isfinite(img).all())
            and float(dop[lit].max()) <= 1.0 + 1e-4
            and float(dop[lit].max()) > 0.1):
        raise AssertionError("the measured Stokes frame is not finite or "
                             "its polarization out of range")
    row0, n_rows = GEO_STOKES_BAND
    with torch.no_grad():
        lanes_k, lanes_p = (P.stokes_lanes(
            scene, sensor, Film(H, W, 12), SEED, SPP, 0, SPP, 4, 1000,
            "rgb", row0=row0, n_rows=n_rows, kinds=kinds, plain=plain)
            for plain in (False, True))
        err = ((lanes_k - lanes_p).abs()
               / lanes_p[..., :1].abs().clamp(min=1e-3)).flatten(1).amax(-1)
        share = float((err > 1e-3).float().mean())
    print(f"check measured Stokes frame: two calls bitwise equal; rows "
          f"{row0}-{row0 + n_rows}: {share:.2e} of {err.shape[0]} lanes "
          f"outside 1e-3 of the plain path (bar 1e-3), max "
          f"{float(err.max()):.3e}; degree of polarization max "
          f"{float(dop[lit].max()):.6f}")
    if not share <= 1e-3:
        raise AssertionError("the measured Stokes frame disagrees with the "
                             "plain path")
    print(f"time measured Stokes frame ({W}x{H}x{SPP}, depth 4, a kind-18 "
          f"sphere): render_stokes {ms:.1f} ms (first call); "
          f"{launches['sunsky_hit_rgb']} K2 and {launches['sunsky_nee_rgb']}"
          f" K3 launches [{card}]")
    return launches


def geometry_phase(dev, card):
    """Phase 23: the geometry frames at full width, RGB and spectral, the
    SDF sphere check, the chi-square tests, the gradient and the measured
    Stokes frame (see the module docstring). Returns each main path's
    launches."""
    import tpusky_torch as tt
    out = {}
    for mode in ("rgb", "spectral"):
        t0 = time.perf_counter()
        state = tt.sunsky_precompute(tt.make_params(
            turbidity=3.0, albedo=0.3, sun_direction=SUN, mode=mode,
            device=dev), mode=mode)
        scene, sensor = _geometry_scene(state, dev, mode == "spectral")
        if mode == "rgb":
            _intersection_ms(scene, sensor, card)
        out[mode] = _geometry_frame(f"geometry frame ({mode})", scene,
                                    sensor, mode, card)
        del scene
        print(f"phase 23 {mode}: {time.perf_counter() - t0:.1f} s")
        if mode == "rgb":
            rgb_state = state
    t0 = time.perf_counter()
    _sdf_sphere_check(rgb_state, dev)
    _geometry_chi2(dev, card)
    out["gradient"] = _geometry_grad_check(dev, card)
    out["Stokes"] = _measured_stokes_frame(rgb_state, dev, card)
    print(f"phase 23 checks: {time.perf_counter() - t0:.1f} s")
    return out


START = time.perf_counter()


def main():
    import torch
    # ---- 1. device ----
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import tpusky_torch as tt
    from tpusky_torch.models.sunsky import model as M
    from tpusky_torch.ops.cuda import build
    from tpusky_torch.ops.cuda import megakernel as MK
    from tpusky_torch.ops.cuda import sunsky_kernel as K
    from tpusky_torch.parallel.render import image_loss
    from tpusky_torch.render import integrator
    from tpusky_torch.render.film import Film, develop, splat_ordered
    card = _card_line()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # the plain versions are the reference: keep float32 products exact
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.basename(lib_path)}")
    for (source, kernel), r in sorted(build.ptxas_report().items()):
        print(f"ptxas {source} {kernel}: {r.get('registers')} registers, "
              f"{r.get('stack')} bytes stack, {r.get('spill_stores')} bytes "
              f"spill stores, {r.get('spill_loads')} bytes spill loads")
        if ((source in ("sunsky_kernels.cu", "megakernel.cu")
             or (source == "sunsky_adjoint.cu" and "bwd_kernel" in kernel)
             or (source in ("sunsky_spectral.cu",
                            "sunsky_spectral_adjoint.cu")
                 and "spec" in kernel))
                and (r.get("spill_stores") or r.get("spill_loads"))):
            raise AssertionError(f"{kernel} spills registers")

    # ---- 3. K1-K3 and K5-K6 against their plain versions ----
    params = tt.make_params(turbidity=3.0, albedo=0.3, sun_direction=SUN,
                            device=dev)
    state = tt.sunsky_precompute(params)
    state_cpu = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=SUN, device="cpu"))
    for f in ("sky_params", "sky_radiance", "sun_radiance", "gaussians",
              "sky_sampling_w"):
        a, b = getattr(state, f).cpu(), getattr(state_cpu, f)
        if not (a - b).abs().max() <= 1e-5 * b.abs().max():
            raise AssertionError(f"precompute on the card differs: {f}")
    rng = np.random.default_rng(0)
    u = rng.random((N_LANES, 2), dtype=np.float32)
    ct = u[:, 0]
    st = np.sqrt(1.0 - ct * ct)
    phi = 2.0 * np.pi * u[:, 1]
    dirs = torch.tensor(np.stack([st * np.cos(phi), st * np.sin(phi), ct],
                                 -1).astype(np.float32), device=dev)
    u2 = torch.tensor(rng.random((N_LANES, 2), dtype=np.float32), device=dev)
    n = N_LANES
    results = {}

    rad1 = K.sunsky_eval_rgb(state, dirs)
    ref1 = M._eval_rgb_plain(state, dirs)
    torch.cuda.synchronize()
    _count_outside("K1 radiance", _rel(rad1, ref1, 1e-3).amax(-1), 1e-4, n)
    results["K1"] = float((rad1 - ref1).abs().max())

    results["K2"] = _check_hit("K2", state, dirs)
    results["K3"] = _check_nee("K3", state, u2)
    # the lane classes: every lane a TGMM sky sample, every lane a
    # sun-cone sample (K3); every direction in the sun's disc (K2: the
    # sun-cone samples' directions), 1% of them at the disc's edge
    w_sky = float(state.sky_sampling_w)
    u_rgb = {"sky": torch.stack([u2[:, 0] * w_sky, u2[:, 1]],
                                -1).contiguous(),
             "sun": torch.stack([w_sky + (1.0 - w_sky) * u2[:, 0],
                                 u2[:, 1]], -1).contiguous()}
    for mix, uu in u_rgb.items():
        _check_nee(f"K3, all {mix} samples", state, uu)
    d_disc = _with_disc_edge(M._sample_eval_rgb_plain(
        state, u_rgb["sun"])[0].contiguous(), state,
        np.random.default_rng(2))
    _check_hit("K2, every direction in the disc", state, d_disc,
               cone_edge=True)
    del rad1, ref1

    # K5, K6: 1% of the lanes at the disc edge (tests/test_pallas.py:215),
    # a cotangent drawn from a numpy seed, gradients through precompute
    sun_n = state.sun_frame_n.cpu().numpy()
    edge = sun_n + 0.002 * rng.normal(size=(n // 100, 3))
    d_g = dirs.clone()
    d_g[:n // 100] = torch.tensor(
        edge / np.linalg.norm(edge, axis=-1, keepdims=True),
        dtype=torch.float32, device=dev)
    g_rad = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32),
                         device=dev)
    lp = _leaf_params(dev)
    st_g = tt.sunsky_precompute(lp)
    d_k = d_g.clone().requires_grad_()
    d_p = d_g.clone().requires_grad_()
    results["K5"], (dd_k,), (dd_p,) = _adjoint_check(
        "K5", K.sunsky_eval_rgb(st_g, d_k), M._eval_rgb_plain(st_g, d_p),
        g_rad, st_g, lp, [d_k], [d_p])
    dd_err = ((dd_k - dd_p).abs().amax(-1)
              / (dd_p.abs().amax(-1) + 1e-3))
    _count_outside("K5 dd", dd_err, 1e-3, n, DD_CAP)
    results["K5"] = max(results["K5"], float((dd_k - dd_p).abs().max()))
    # K5 with every direction in the disc (K2's lanes above, 1% of them at
    # the disc's edge): the sun polynomial, its partials and the ramp on
    # every lane
    d_k = d_disc.clone().requires_grad_()
    d_p = d_disc.clone().requires_grad_()
    err, (dd_k,), (dd_p,) = _adjoint_check(
        "K5, every direction in the disc", K.sunsky_eval_rgb(st_g, d_k),
        M._eval_rgb_plain(st_g, d_p), g_rad, st_g, lp, [d_k], [d_p])
    results["K5"] = max(results["K5"], err, _lane_check(
        "K5 dd, every direction in the disc", dd_k, dd_p, n))
    # K6 redraws K3's samples bitwise, so it is held against the plain
    # radiance's autograd at those samples, and against the plain NEE
    # block with its own sampler. The two samplers' directions differ by
    # ulps (up to 7e-6, above). Near the sun, one ulp of cos(gamma) in
    # float32 (6e-8) is 0.011 of the disc weight's ramp, whose half-width
    # in cos(gamma) is 5.4e-6 here; where a lane's ramp is that close to
    # its clamp at 0 or 1, the two samplers' directions put it on either
    # side, and its derivative 1 / eps, ~2e5, reaches the aperture's and
    # the sun direction's cotangents or not. The misc row is read over
    # all lanes, and held at 1e-3 without the lanes whose directions
    # differ and whose ramp lies within RAMP_BAND of a clamp
    d6, rad6, _ = K.sunsky_nee_rgb(st_g, u2, pdf_detached=True)
    results["K6"], _, _ = _adjoint_check(
        "K6 (at its samples)", rad6, M._eval_rgb_plain(st_g, d6), g_rad,
        st_g, lp)
    d_ps, rad_ps = M._sample_eval_rgb_plain(st_g, u2)[:2]
    _adjoint_check("K6 (plain sampler, all lanes)", rad6, rad_ps, g_rad,
                   st_g, lp, misc_bar=None)
    at_clamp = _ramp_clamp_lanes("K6", d6, d_ps, st_g)
    _adjoint_check("K6 (plain sampler, ramp clamps left out)", rad6, rad_ps,
                   g_rad * (~at_clamp)[:, None], st_g, lp)
    del dd_k, dd_p, dd_err, d_k, d_p, st_g, d6, rad6, d_ps, rad_ps

    # ---- 4. the forward main path ----
    film = Film(H, W, 3)
    base_params = tt.make_params(turbidity=3.0, albedo=0.3,
                                 sun_direction=SUN, device=dev)
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    state = tt.sunsky_precompute(base_params)
    sky = tt.sunsky_eval(state, dirs)
    scene, sensor = _headline_scene(state, dev)
    img = integrator.render(scene, sensor, film, SEED, spp=SPP,
                            max_depth=MAX_DEPTH)
    acc_wave = integrator.render_rows(scene, sensor, film, SEED, SPP,
                                      MAX_DEPTH, 1000, "rgb", 0, H)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(build.launches)
    print(f"forward main path: {main_s:.2f} s, launches {launches}")
    for name in ("sunsky_eval_rgb", "sunsky_hit_rgb", "sunsky_nee_rgb",
                 "direct_rgb_megakernel"):
        if launches[name] <= 0:
            raise AssertionError(f"the main path never launched {name}")
    if not (bool(torch.isfinite(sky).all()) and sky.shape == dirs.shape):
        raise AssertionError("sky radiance")
    if not (img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
            and float(img.mean()) > 0.0):
        raise AssertionError("render: image not finite, shaped or lit")
    print(f"image: mean {float(img.mean()):.5f} max {float(img.max()):.3f}")

    lanes_k = MK.megakernel_lanes(scene, sensor, state, SEED, SPP, W, H)
    lanes_p = integrator._lane_radiance(scene, sensor, film, SEED, SPP, 0,
                                        SPP, MAX_DEPTH, 1000, "rgb", 0, H,
                                        plain=True)
    img_p = develop(splat_ordered(film, lanes_p, SPP))
    rel4 = (lanes_k - lanes_p).abs().amax(-1) / \
        lanes_p.abs().clamp(min=1e-3).amax(-1)
    share = float((rel4 > 1e-3).float().mean())
    bar = 1e-3 * max(float(img_p.max()), 1.0)
    err_img = float((img - img_p).abs().max())
    err_wave = float((develop(acc_wave) - img_p).abs().max())
    print(f"check K4 lanes: {share:.2e} of lanes outside 1e-3 (bar 1e-3), "
          f"max {float(rel4.max()):.3e}")
    print(f"check K4 image: max |K4 - plain| {err_img:.3e}, wavefront "
          f"(K2, K3) {err_wave:.3e}, bar {bar:.3e}")
    if not (share <= 1e-3 and err_img < bar and err_wave < bar):
        raise AssertionError("K4 disagrees with the plain wavefront path")
    results["K4"] = float((lanes_k - lanes_p).abs().max())
    del lanes_p
    # the rows K4 staged from the raw tensors against their plain versions
    def check_rows(sc, se, label):
        with torch.no_grad():
            lanes_r, rows_k = MK.launch(MK.pack(sc, se, state), SEED, SPP,
                                        W, H, rows=True)
        # the scene rows to 1e-6, the state's (1/sigma reaches ~15 on the
        # headline sky) to 1e-6 of their size
        err = max(float((a - b).abs().max())
                  for a, b in zip(rows_k[:3], MK.scene_rows(sc, se)))
        err_st = max(float(((a - b).abs() / b.abs().clamp(min=1.0)).max())
                     for a, b in zip(rows_k[3:], (K._misc_row(state),
                                                  K._gauss_rows(state))))
        print(f"check K4 staged rows{label}: camera, shapes, materials "
              f"against scene_rows max {err:.3e} (bar 1e-6), misc and "
              f"gaussians against _misc_row and _gauss_rows max "
              f"{err_st:.3e} relative (bar 1e-6)")
        if not (err <= 1e-6 and err_st <= 1e-6):
            raise AssertionError("K4's staged rows differ from their plain "
                                 "versions")
        return lanes_r
    if not torch.equal(check_rows(scene, sensor, ""), lanes_k):
        raise AssertionError("K4's lanes differ with the rows output")
    # the headline render() makes no host-device synchronisation and
    # launches K4 alone
    img_again, counts = _counted(lambda: _no_sync(lambda: integrator.render(
        scene, sensor, film, SEED, spp=SPP, max_depth=MAX_DEPTH),
        "the headline render()"))
    if not torch.equal(img_again, img):
        raise AssertionError("render() is not deterministic")
    if {k: v for k, v in counts.items() if v} != {"direct_rgb_megakernel": 1}:
        raise AssertionError(f"the headline render() launched {counts}, not "
                             "K4 alone")
    print("check the headline render(): K4 alone, once")

    # a scene of more shapes than K4 keeps in shared memory, through
    # render() on the card (K4), against the plain wavefront lane by lane.
    # Its 80 shapes' silhouettes make a lane's shadow or continuation ray
    # flip with the last bit of a hit test, so the image is held against
    # the plain path's own spread: its lanes when every to_object moves
    # by 2.4e-7 of itself (about two float32 ulps)
    many = _many_shapes_scene(state, dev)
    check_rows(many, sensor, f", {len(many.shapes.kind)} shapes")
    count0 = build.launches["direct_rgb_megakernel"]
    img_m = integrator.render(many, sensor, film, SEED, spp=SPP)
    if build.launches["direct_rgb_megakernel"] != count0 + 1:
        raise AssertionError("the many-shape frame did not go through K4")
    lanes_mk = MK.megakernel_lanes(many, sensor, state, SEED, SPP, W, H)

    def plain_lanes(sc):
        return integrator._lane_radiance(sc, sensor, film, SEED, SPP, 0,
                                         SPP, MAX_DEPTH, 1000, "rgb", 0, H,
                                         plain=True)

    def lane_share(a, b):
        rel = (a - b).abs().amax(-1) / b.abs().clamp(min=1e-3).amax(-1)
        return float((rel > 1e-3).float().mean())
    lanes_mp = plain_lanes(many)
    sh = many.shapes
    lanes_mq = plain_lanes(many._replace(shapes=sh._replace(
        to_object=sh.to_object * (1.0 + 2.4e-7))))
    img_mp = develop(splat_ordered(film, lanes_mp, SPP))
    err_m = float((img_m - img_mp).abs().max())
    err_mq = float((develop(splat_ordered(film, lanes_mq, SPP))
                    - img_mp).abs().max())
    share_m, share_mq = lane_share(lanes_mk, lanes_mp), \
        lane_share(lanes_mq, lanes_mp)
    bar_m = max(1e-3 * max(float(img_mp.max()), 1.0), 1.5 * err_mq)
    print(f"check K4 on {len(many.shapes.kind)} shapes: {share_m:.2e} of "
          f"lanes outside 1e-3 (bar 1e-3; the plain path moved by 2.4e-7 "
          f"{share_mq:.2e}), image max {err_m:.3e} (moved plain "
          f"{err_mq:.3e}; bar {bar_m:.3e})")
    if not (share_m <= 1e-3 and err_m <= bar_m):
        raise AssertionError("K4 disagrees with the plain wavefront path on "
                             "the many-shape scene")
    del lanes_mk, lanes_mp, lanes_mq

    # a small frame through K4 on the card and the plain path on the CPU,
    # under the identity environment and a rotated one (K4 builds the
    # continuation's frame in world coordinates, as the wavefront does)
    small = Film(32, 32, 3)
    scene_cpu, sensor_cpu = _headline_scene(state_cpu, "cpu")
    ca, sa = math.cos(0.7), math.sin(0.7)
    rot = torch.tensor([[ca, -sa * ca, sa * sa], [sa, ca * ca, -ca * sa],
                        [0.0, sa, ca]])
    for name, env in (("", None), (", rotated environment", rot)):
        sc_k, sc_c = scene, scene_cpu
        if env is not None:
            sc_k = scene._replace(env_to_world=env.to(dev))
            sc_c = scene_cpu._replace(env_to_world=env)
        img_s = integrator.render(sc_k, sensor, small, SEED, spp=4).cpu()
        img_c = integrator.render(sc_c, sensor_cpu, small, SEED, spp=4)
        err_s = float((img_s - img_c).abs().max())
        print(f"check K4 vs CPU plain, 32x32x4{name}: max {err_s:.3e}")
        if not err_s < 1e-3 * max(float(img_c.max()), 1.0):
            raise AssertionError("K4 on the card disagrees with the CPU")

    # ---- 5. the gradient main path ----
    tables_dev = tt.load_tables("rgb", device=dev)

    def bench_grad(kind):
        return grad_case(kind, scene, sensor, film, tables_dev, dev)

    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    loss_k, grad_k = bench_grad("rows")
    loss_r, grad_r = bench_grad("render")
    step, opt, builder, start, target = train_case(scene, sensor, film,
                                                   tables_dev, dev)
    torch.cuda.reset_peak_memory_stats()
    pd, ost, losses, step_s = dict(start), opt.init(start), [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        ts0 = time.perf_counter()
        ost, pd, loss = step(ost, pd, target, SEED)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - ts0)
        losses.append(float(loss))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    with torch.no_grad():
        final = float(image_loss(develop(integrator.render_rows(
            builder(pd), sensor, film, SEED, SPP, MAX_DEPTH, 1000, "rgb", 0,
            H)), target, "log_l2_blur"))
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    grad_launches = dict(build.launches)
    print(f"gradient main path: {grad_s:.2f} s, launches {grad_launches}")
    for name in ("sunsky_hit_rgb", "sunsky_nee_rgb", "direct_rgb_megakernel",
                 "sunsky_eval_rgb_bwd", "sunsky_nee_rgb_bwd"):
        if grad_launches[name] <= 0:
            raise AssertionError(f"the gradient path never launched {name}")
    # the training step's loss, its scene built from leaves that require
    # grad, makes no host-device synchronisation (the scene builder, the
    # caller's, is left out)
    from tpusky_torch.render.bsdf import table_kinds
    sc_loss = builder({k: v.detach().requires_grad_()
                       for k, v in start.items()})
    _no_sync(lambda: image_loss(develop(integrator.render_rows(
        sc_loss, sensor, film, SEED, SPP, MAX_DEPTH, 1000, "rgb", 0, H,
        kinds=table_kinds(sc_loss.bsdfs))), target, "log_l2_blur"),
        "the training step's loss")
    del sc_loss

    names = ("turbidity", "albedo", "sun_direction")
    print("bench_grad loss %.6e, d/d(turbidity, albedo, sun) = %s" % (
        loss_k, [g.tolist() for g in grad_k]))
    for name, a, b in zip(names, grad_r, grad_k):
        _check_scale(f"render() replayed gradient {name} vs render_rows",
                     a, b, 1e-4)
    if not all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
               for g in grad_k):
        raise AssertionError("bench_grad: gradients not finite or zero")
    t_final = float(pd["t"])
    print(f"train: losses {losses}, after step {TRAIN_STEPS} {final:.6e}; "
          f"turbidity 3.0 -> {t_final:.5f} (target 6.5); step times "
          f"{[round(1e3 * s, 2) for s in step_s]} ms; peak memory "
          f"{peak_gib:.2f} GiB [{card}]")
    if not (final < losses[0] and t_final > 3.0 and math.isfinite(final)):
        raise AssertionError("training did not lower the loss and raise "
                             "turbidity")

    loss_p, grad_p = bench_grad("plain")
    print(f"bench_grad loss: kernels {loss_k:.6e}, render() {loss_r:.6e}, "
          f"plain {loss_p:.6e}")
    for (name, bar), a, b in zip(((names[0], 1e-3), (names[1], 1e-3),
                                  (names[2], 3e-2)), grad_k, grad_p):
        _check_scale(f"bench_grad d{name}: kernels vs plain on the card",
                     a, b, bar)

    # ---- 6. the spectral main path ----
    spec = spectral_phase(dev, dirs, rng, film, card)
    # ---- 7. path 1, the spectral gradient ----
    spec_grad_launches = spectral_grad_phase(dev, dirs, rng, film, card)
    # ---- 8. path 2, the attached pdf ----
    attached = attached_pdf_phase(dev, dirs, u2, rng, card)
    # ---- 9. meshes ----
    mesh_err, (mesh_times, mesh_bound) = mesh_kernel_phase(dev, card)
    mesh_launches, frame_err = mesh_frame_phase(dev, card)
    print(f"mesh frame band: max |kernels - plain| {frame_err:.3e}")

    # ---- 10. times ----
    tables = K.pack_tables(state, dev)
    mega = MK.pack(scene, sensor, state)
    st_l = state._replace(**{
        f: getattr(state, f).detach().clone().requires_grad_()
        for f in ("sky_params", "sky_radiance", "sun_radiance")})
    d_l = d_g.clone().requires_grad_()
    leaves = [st_l.sky_params, st_l.sky_radiance, st_l.sun_radiance]

    # the plain adjoints: autograd's backward alone, over graphs built once
    out5 = M._eval_rgb_plain(st_l, d_l)
    out6 = M._sample_eval_rgb_plain(st_l, u2)[1]

    def plain_k5():
        return torch.autograd.grad(out5, leaves + [d_l], g_rad,
                                   retain_graph=True)

    def plain_k6():
        return torch.autograd.grad(out6, leaves, g_rad, retain_graph=True)
    times = {
        "K1": _pair_ms(lambda: K.launch_eval(tables, dirs),
                       lambda: M._eval_rgb_plain(state, dirs)),
        "K2": _pair_ms(lambda: K.launch_hit(tables, dirs),
                       lambda: M._hit_rgb_plain(state, dirs)),
        "K3": _pair_ms(lambda: K.launch_nee(tables, u2),
                       lambda: M._sample_eval_rgb_plain(state, u2)),
        "K4": _pair_ms(
            lambda: MK.launch(mega, SEED, SPP, W, H),
            lambda: integrator.render_rows(scene, sensor, film, SEED, SPP,
                                           MAX_DEPTH, 1000, "rgb", 0, H,
                                           plain=True), reps=5),
        "K5": _pair_ms(lambda: K.launch_eval_bwd(tables, d_g, g_rad),
                       plain_k5, reps=5),
        "K6": _pair_ms(lambda: K.launch_nee_bwd(tables, u2, g_rad),
                       plain_k6, reps=5),
    }
    # K6 split by sampling strategy: every lane a TGMM sky sample, then
    # every lane a sun-cone sample (those add the sun row's cotangent,
    # summed over the lanes of a warp that share its row)
    w_sky = float(state.sky_sampling_w)
    u_sky = torch.stack([u2[:, 0] * w_sky, u2[:, 1]], -1)
    u_sun = torch.stack([w_sky + (1.0 - w_sky) * u2[:, 0], u2[:, 1]], -1)
    k6_sky = _time_ms(lambda: K.launch_nee_bwd(tables, u_sky, g_rad), 5)
    k6_sun = _time_ms(lambda: K.launch_nee_bwd(tables, u_sun, g_rad), 5)
    # phase 3's RGB lane classes
    rgb_mix_ms = {
        "K5 disc": _time_ms(lambda: K.launch_eval_bwd(tables, d_disc, g_rad),
                            5),
        "K2 disc": _time_ms(lambda: K.launch_hit(tables, d_disc)),
        "K3 sky": _time_ms(lambda: K.launch_nee(tables, u_rgb["sky"])),
        "K3 sun": _time_ms(lambda: K.launch_nee(tables, u_rgb["sun"]))}
    # K4 with every lane a miss: the headline scene seen by a camera
    # turned up to the sky
    from tpusky_torch.render.sensors import make_perspective
    sky_cam = make_perspective([4, -4, 2.0], [4.5, -3.5, 12.0], fov_x_deg=45,
                               device=dev)
    miss_hits = _k4_work(scene, sky_cam, state)["hits"]
    if miss_hits != 0:
        raise AssertionError(f"{miss_hits:.0f} camera rays of the sky camera "
                             "hit the scene")
    mega_miss = MK.pack(scene, sky_cam, state)
    k4_miss = _time_ms(lambda: MK.launch(mega_miss, SEED, SPP, W, H))
    wave_ms = _time_ms(lambda: integrator.render_rows(
        scene, sensor, film, SEED, SPP, MAX_DEPTH, 1000, "rgb", 0, H), 5)
    wrap_ms = _time_ms(lambda: K.sunsky_eval_rgb(state, dirs))
    frame_ms = _time_ms(lambda: integrator.render(scene, sensor, film, SEED,
                                                  spp=SPP), 5)
    grad_ms, grad_plain_ms = _pair_ms(lambda: bench_grad("rows"),
                                      lambda: bench_grad("plain"), reps=3)
    grad_render_ms = _time_ms(lambda: bench_grad("render"), 3, 1)
    rays = H * W * SPP * (1 + 2 * (MAX_DEPTH - 1))
    grad_rays = H * W * GRAD_SPP * (1 + 2 * (MAX_DEPTH - 1))
    k1, p1 = times["K1"]
    print(f"time K1 sunsky_eval_rgb: {k1:.4f} ms ({n / k1 / 1e3:.1f} M "
          f"evals/s), plain {p1:.4f} ms ({n / p1 / 1e3:.1f} M evals/s); "
          f"wrapper with table packing {wrap_ms:.4f} ms [{card}]")
    for name in ("K2", "K3", "K5", "K6"):
        k, p = times[name]
        print(f"time {name}: {k:.4f} ms, plain {p:.4f} ms at {n} lanes "
              f"[{card}]")
    print(f"time K6 by strategy at {n} lanes: all sky samples "
          f"{k6_sky:.4f} ms, all sun-cone samples {k6_sun:.4f} ms (the "
          f"headline sky weight {w_sky:.4f}); the previous kernel: all "
          f"sky {PREV_K6_STRATEGY_MS['sky']} ms, all sun-cone "
          f"{PREV_K6_STRATEGY_MS['sun']} ms [{card}]")
    print(f"time K5 with every direction in the disc "
          f"{rgb_mix_ms['K5 disc']:.4f} ms at {n} lanes; the previous "
          f"kernel {PREV_RGB_BWD_MIX_MS['K5 disc']} ms [{card}]")
    print(f"time K2 with every direction in the disc "
          f"{rgb_mix_ms['K2 disc']:.4f} ms; K3 by strategy: all sky samples "
          f"{rgb_mix_ms['K3 sky']:.4f} ms, all sun-cone samples "
          f"{rgb_mix_ms['K3 sun']:.4f} ms, at {n} lanes; the previous "
          "kernels: "
          + ", ".join(f"{k} {v} ms" for k, v in PREV_RGB_MIX_MS.items())
          + f" [{card}]")
    k4, p4 = times["K4"]
    print(f"time K4 by lane class at {H * W * SPP} lanes: the headline "
          f"frame {k4:.4f} ms, every lane a miss {k4_miss:.4f} ms; the "
          f"previous kernel {PREV_MS['K4']} ms and "
          f"{PREV_K4_MIX_MS['all miss']} ms [{card}]")
    print(f"time K4 frame: {k4:.3f} ms ({rays / k4 / 1e3:.1f} M rays/s), "
          f"plain wavefront {p4:.3f} ms ({rays / p4 / 1e3:.1f} M rays/s), "
          f"wavefront with K2+K3 {wave_ms:.3f} ms "
          f"({rays / wave_ms / 1e3:.1f} M rays/s); render() with packing "
          f"and film {frame_ms:.3f} ms ({rays / frame_ms / 1e3:.1f} M "
          f"rays/s) [{card}]")
    print(f"time bench_grad fwd+bwd (512x512x{GRAD_SPP}, precompute "
          f"included): render_rows with K2/K3/K5/K6 {grad_ms:.2f} ms "
          f"({grad_rays / grad_ms / 1e3:.2f} M rays/s), render() "
          f"{grad_render_ms:.2f} ms ({grad_rays / grad_render_ms / 1e3:.2f} "
          f"M rays/s), plain {grad_plain_ms:.2f} ms "
          f"({grad_rays / grad_plain_ms / 1e3:.2f} M rays/s) [{card}]")
    step_ms = 1e3 * sum(step_s[1:]) / (TRAIN_STEPS - 1)
    print(f"time train step (512x512x{SPP}, log_l2_blur, Adam): mean of "
          f"steps 2-{TRAIN_STEPS} {step_ms:.2f} ms; peak memory "
          f"{peak_gib:.2f} GiB [{card}]")

    # ---- 11-14. goldens, chi-square, Z-tests, recovery ----
    t0 = time.perf_counter()
    sky_golden_phase(dev)
    chi2_phase(dev, card)
    golden_ztest_phase(dev)
    recovery_phase(dev, card)
    print(f"phases 11-14: {time.perf_counter() - t0:.1f} s")

    # ---- 15. the path tracer's breadth ----
    t0 = time.perf_counter()
    breadth_frame_phase(dev, card)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")

    # ---- 16-17. the envmap and the material breadth ----
    t0 = time.perf_counter()
    envmap_frame_phase(dev, card)
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    material_frame_phase(dev, card)
    print(f"phase 17: {time.perf_counter() - t0:.1f} s")

    # ---- 18. the spectral film frame ----
    t0 = time.perf_counter()
    spectral_film_phase(dev, card)
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")

    # ---- 19. textures and mesh attributes ----
    t0 = time.perf_counter()
    textured_frame_phase(dev, card)
    print(f"phase 19: {time.perf_counter() - t0:.1f} s")

    # ---- 20. participating media ----
    t0 = time.perf_counter()
    fog = fog_frame_phase(dev, card)
    print(f"phase 20: {time.perf_counter() - t0:.1f} s")

    # ---- 21. the particle tracer ----
    t0 = time.perf_counter()
    light_traced = ptracer_phase(dev, card)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s")

    # ---- 22. polarized transport ----
    t0 = time.perf_counter()
    stokes = stokes_frame_phase(dev, card)
    print(f"phase 22: {time.perf_counter() - t0:.1f} s")

    # ---- 23. SDF grids, curves with hair, measured BRDFs ----
    t0 = time.perf_counter()
    geometry = geometry_phase(dev, card)
    print(f"phase 23: {time.perf_counter() - t0:.1f} s")

    # ---- 24. bounds and results ----
    with torch.no_grad():
        n_sun = state.sun_frame_n
        cos_cut = math.cos(float(state.params.sun_half_aperture))
        above = float((dirs[:, 2] >= 0).sum())
        disc = float(((dirs * n_sun).sum(-1) >= cos_cut).sum())
        vjp5 = _vjp_ops(d_g, state)
        sky_pick = float((u2[:, 0] < state.sky_sampling_w).sum())
        d3 = K.launch_nee(tables, u2)[0]
        above3 = float((d3[:, 2] >= 0).sum())
        disc3 = float((((d3 * n_sun).sum(-1) >= cos_cut)
                       & (d3[:, 2] >= 0)).sum())
        vjp6 = _vjp_ops(d3, state)
        # K4's work on this frame, counted from the plain wavefront's
        # intermediates: hits, their NEE strategies, and the lookups the
        # frame needs (the NEE direction where it is lit and unshadowed,
        # the escaped continuation; a miss's sky)
        n4 = H * W * SPP
        work = _k4_work(scene, sensor, state)
        hits, sky4, nee4 = work["hits"], work["sky"], work["nee"]
        nee4_sun, cont4 = work["nee_sun"], work["cont"]
    o = OPS
    sample_ops = sky_pick * o["sample_sky"] + (n - sky_pick) * o["sample_sun"]
    nee_ops = (sample_ops + above3 * (o["pdf"] + o["radiance"])
               + disc3 * o["radiance_sun"])
    # sun-cone NEE samples lie in the disc; a sky sample's or a
    # continuation's lookup in the disc is not counted
    k4_ops = (hits * o["path"] + (n4 - hits) * (o["miss"] + o["radiance"])
              + sky4 * o["sample_sky"] + (hits - sky4) * o["sample_sun"]
              + (nee4 + cont4) * (o["pdf"] + o["radiance"])
              + nee4_sun * o["radiance_sun"])
    print(f"K4 work on the headline frame: {hits:.0f} of {n4} camera rays "
          f"hit, {sky4:.0f} sky and {hits - sky4:.0f} sun-cone NEE samples, "
          f"{nee4:.0f} NEE lookups ({nee4_sun:.0f} sun-cone), {cont4:.0f} "
          f"continuation lookups")
    bounds = {
        "K1": _bound(24 * n + TABLE_BYTES,
                     above * o["radiance"] + disc * o["radiance_sun"]),
        "K2": _bound(28 * n + TABLE_BYTES + GAUSS_BYTES,
                     above * (o["radiance"] + o["pdf"])
                     + disc * o["radiance_sun"]),
        "K3": _bound(36 * n + TABLE_BYTES + GAUSS_BYTES, nee_ops),
        "K4": _bound(12 * n4 + TABLE_BYTES + GAUSS_BYTES, k4_ops),
        "K5": _bound(36 * n + TABLE_BYTES + ROW_BYTES, vjp5),
        "K6": _bound(20 * n + TABLE_BYTES + GAUSS_BYTES + ROW_BYTES,
                     sample_ops + vjp6),
    }
    # K12 and K13 stand in the line with their main path's variant (the
    # pdf detached, path 1's launches); K7 and K8 with path 2's
    counts = {key: (grad_launches if key in ("K5", "K6") else launches)[
        KERNELS[key][0]] for key in bounds}
    for key, (name, count, err, t, b) in spec.items():
        times[key], bounds[key], results[key] = t, b, err
        counts[key] = (spec_grad_launches[name] if key in ("K12", "K13")
                       else count)
    for key, (_, count, err, t, b) in attached.items():
        if key in ("K7", "K8"):
            times[key], bounds[key], counts[key] = t, b, count
            results[key] = err
        else:
            results[key] = max(results[key], err)
    times["K14"], bounds["K14"] = mesh_times, mesh_bound
    counts["K14"], results["K14"] = mesh_launches, mesh_err
    # the fog, light-traced, Stokes and geometry frames' runs are main
    # paths of their own: their launches add to each kernel's count
    new_paths = {f"fog {k}": v for k, v in fog.items()}
    new_paths.update({f"light-traced {k}": v
                      for k, v in light_traced.items()})
    new_paths.update({f"Stokes {k}": v for k, v in stokes.items()})
    new_paths.update({f"geometry {k}": v for k, v in geometry.items()})
    for path, runs in new_paths.items():
        print(f"launches on the {path} path: "
              + ", ".join(f"{key} {runs[KERNELS[key][0]]}"
                          for key in sorted(KERNELS, key=lambda k: int(k[1:]))
                          if runs[KERNELS[key][0]]))
        for key in counts:
            counts[key] += runs[KERNELS[key][0]]
    for key, (ms, by) in bounds.items():
        print(f"bound {key}: {ms:.4f} ms ({by}); measured "
              f"{times[key][0]:.4f} ms, {100 * ms / times[key][0]:.1f}% of "
              f"the bound's rate; the previous kernel {PREV_MS[key]:.4f} "
              f"ms [{card}]")

    here = os.path.dirname(os.path.abspath(__file__))
    kernels = []
    for key in sorted(KERNELS, key=lambda k: int(k[1:])):
        name, source, replaces = KERNELS[key]
        if not os.path.exists(os.path.join(here, source)):
            raise AssertionError(f"missing source {source}")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[key],
                        "max_abs_err": results[key], "ms": times[key][0],
                        "plain_ms": times[key][1],
                        "bound_ms": bounds[key][0],
                        "bound_by": bounds[key][1], "library_ms": None})
    if not all(math.isfinite(k["ms"]) and math.isfinite(k["max_abs_err"])
               for k in kernels):
        raise AssertionError("timing")
    print(f"chip_smoke: {time.perf_counter() - START:.1f} s in all")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
