"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. device: require CUDA; print the card's name and power limit;
2. build: compile the kernels from tpusky_torch/csrc with nvcc;
3. K1-K3 against their plain PyTorch versions at 2,097,152 lanes, and the
   adjoints K5 and K6 against autograd of the same plain versions: table
   cotangents, K5's per-lane direction cotangent, and the cotangents
   pulled back through precompute to (turbidity, albedo, sun direction);
4. the forward main path: precompute the headline sunsky, evaluate the sky
   dome (K1), render the headline scene (512x512, 8 spp, depth 2) through
   `render` (K4), and render it again through the wavefront `render_rows`
   (K2, K3); every kernel's launch count must rise, the image must be
   finite and non-zero, and K4 must agree with the plain wavefront path
   lane by lane and per image, on the card and against the CPU on a small
   frame;
5. the gradient main path: `bench.py::bench_grad`'s loss (512x512, 4 spp,
   mean(img^2), gradients to turbidity, albedo and sun direction through
   precompute) through `render_rows` (K2, K3 forward; K5, K6 backward) and
   through `render` (K4 forward, the wavefront replayed backward), then
   five training steps of `make_train_step_single` (512x512, 8 spp,
   log_l2_blur, Adam); K2-K6 must launch, the two gradients must agree,
   and the steps must lower the loss and raise turbidity toward the
   target's. The kernel path's gradient is then held against the plain
   path's on the card;
6. the spectral main path: K9-K11 against their plain versions at
   2,097,152 lanes with 4 hero wavelengths from `sample_rgb_spectrum`,
   then `bench.py::bench_spectral`'s frame (512x512, 8 spp, depth 4, a
   rough-conductor ground) through `render(mode="spectral")` (K10, K11)
   after a spectral sky dome (K9); every spectral kernel's launch count
   must rise, the frame must agree with the plain path on the card lane
   by lane and per image, and a crop of it with the CPU's plain render;
   a spectral gradient on the card must raise (K12/K13 are not ported);
7. times of each kernel and its plain version (CUDA events; for the
   adjoints, autograd's backward over a graph built once), the fwd+bwd
   rate of bench_grad, a training step's time and peak memory, the
   spectral frame's time and rays per second;
8. one JSON line of kernel results, then the device line, last.

It prints no result and exits non-zero without a CUDA device or outside
a checkout of the repository.
"""

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
}
TABLE_BYTES = 4 * (27 + 3 + 45 * 72 + 16)
SPEC_TABLE_BYTES = 4 * (11 * 9 + 11 + 45 * 44 + 11 * 6 + 16)
GAUSS_BYTES = 4 * 14 * 20
ROW_BYTES = 4 * (45 * 72 + 46)      # the adjoints' cotangent row


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
    p = state.params
    cos_cut = math.cos(float(p.sun_half_aperture))
    half = 0.25 * (1.0 - cos_cut) * float(p.disc_softness)
    cos_g = (d * state.sun_frame_n).sum(-1)
    above = d[:, 2] >= 0
    disc = above & (cos_g >= cos_cut)
    ramp = above & ((cos_g - cos_cut).abs() <= half)
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


def _leaf_params(dev):
    """The headline parameters, every field a leaf that requires grad."""
    import tpusky_torch as tt
    p = tt.make_params(turbidity=3.0, albedo=0.3, sun_direction=SUN,
                       device=dev)
    return p._replace(**{f: getattr(p, f).detach().clone().requires_grad_()
                         for f in p._fields})


def _adjoint_check(name, out_k, out_p, g, state, params, lanes_k=(),
                   lanes_p=(), misc_bar=1e-3):
    """Hold an adjoint kernel's cotangents against autograd of the plain
    version: the tables it writes (sky params, sky radiance, sun), the
    misc row pulled back to its state sources, each within 1e-3 of the
    table's largest plain cotangent (misc within `misc_bar`; where it is
    None, the misc row and each of its sources are only printed);
    (turbidity, albedo) within 1e-3 and the sun direction within 3e-2,
    relative. Returns (max abs error of the kernel's table cotangents,
    per-lane cotangents of kernel and plain)."""
    import torch
    tables = [state.sky_params, state.sky_radiance, state.sun_radiance]
    misc_names = ("sun_frame_n", "sun_half_aperture", "sky_scale",
                  "sun_scale", "disc_softness")
    misc = [state.sun_frame_n] + [getattr(params, f) for f in misc_names[1:]]
    pars = [params.turbidity, params.albedo, params.sun_direction]
    wrt = tables + misc + pars
    gk = torch.autograd.grad(out_k, wrt + list(lanes_k), g,
                             retain_graph=True)
    gp = torch.autograd.grad(out_p, wrt + list(lanes_p), g,
                             retain_graph=True)
    for i, t in enumerate(("skyp", "skyr", "sun")):
        _check_scale(f"{name} d{t}", gk[i], gp[i], 1e-3)
    flat = slice(3, 3 + len(misc))
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
                     gk[n_wrt - 3 + i], gp[n_wrt - 3 + i], bar)
    err = max(float((a - b).abs().max()) for a, b in zip(gk[:3], gp[:3]))
    return err, gk[n_wrt:], gp[n_wrt:]


def spectral_phase(dev, dirs, rng, film, card):
    """Phase 6: K9-K11 against their plain versions, bench_spectral's
    frame through render() with the launch counts of that run, the frame
    against the plain path and a crop against the CPU, the refusal of a
    spectral gradient, then times. Returns {K: (name, launches, max abs
    error, (ms, plain ms), (bound ms, bound by))}."""
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
    _count_outside("K9 radiance, 10 wavelengths",
                   _rel(K.sunsky_eval_spec(state, d[:m], wl10),
                        M._eval_spec_plain(state, d[:m], wl10),
                        1e-3).amax(-1), 1e-4, m)
    rad10, pdf10 = K.sunsky_hit_spec(state, d, wl)
    ref10, refp10 = M._hit_spec_plain(state, d, wl)
    _count_outside("K10 radiance", _rel(rad10, ref10, 1e-3).amax(-1), 1e-4,
                   n)
    _count_outside("K10 pdf", _rel(pdf10, refp10, 1e-3), 1e-3, n)
    err["K10"] = float((rad10 - ref10).abs().max())
    d11, rad11, pdf11 = K.sunsky_nee_spec(state, u2, wl)
    refd11, _, refp11 = M._sample_eval_spec_plain(state, u2, wl)
    far = (d11 - refd11).abs().amax(-1)
    _count_outside("K11 direction", far, 1e-5, n)
    near = far <= 1e-5
    _count_outside("K11 pdf", _rel(pdf11, refp11, 1e-3)[near], 1e-3, n)
    rel11 = _rel(rad11, M._eval_spec_plain(state, d11, wl), 1e-3).amax(-1)
    med11 = float(rel11.median())
    print(f"check K11 radiance: median {med11:.3e} (bar 1e-4)")
    if not med11 <= 1e-4:
        raise AssertionError("K11 radiance median")
    _count_outside("K11 radiance", rel11, 1e-2, n)
    err["K11"] = float(far.max())
    del rad9, ref9, rad10, ref10, pdf10, refp10, rad11, refd11, refp11, out

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

    # the spectral adjoints K12/K13 are not ported: a gradient request on
    # the card raises instead of running anything else
    lp = tt.make_params(turbidity=3.0, albedo=0.3, sun_direction=SUN,
                        mode="spectral", device=dev)
    lp = lp._replace(turbidity=lp.turbidity.clone().requires_grad_())
    st_g = tt.sunsky_precompute(lp, mode="spectral")
    for k, ask in (
            ("K12", lambda: M.eval(st_g, d[:8], mode="spectral",
                                   wavelengths=wl[:8])),
            ("K12", lambda: M.eval_pdf(st_g, d[:8], mode="spectral",
                                       pdf_detached=True,
                                       wavelengths=wl[:8])),
            ("K13", lambda: M.sample_eval(st_g, u2[:8], mode="spectral",
                                          pdf_detached=True,
                                          wavelengths=wl[:8]))):
        try:
            ask()
        except NotImplementedError as e:
            if k not in str(e):
                raise
            print(f"check spectral gradient refused: {e}")
        else:
            raise AssertionError(f"a spectral gradient ran without {k}")

    # times (CUDA events) and bounds
    tables = K.pack_tables_spec(state, dev)
    times = {
        "K9": _pair_ms(lambda: K.launch_eval_spec(tables, d, wl),
                       lambda: M._eval_spec_plain(state, d, wl)),
        "K10": _pair_ms(lambda: K.launch_hit_spec(tables, d, wl),
                        lambda: M._hit_spec_plain(state, d, wl)),
        "K11": _pair_ms(lambda: K.launch_nee_spec(tables, u2, wl),
                        lambda: M._sample_eval_spec_plain(state, u2, wl)),
    }
    frame_ms, frame_plain_ms = _pair_ms(
        lambda: integrator.render(scene, sensor, film, SEED, spp=SPP,
                                  max_depth=SPEC_DEPTH, mode="spectral"),
        lambda: integrator.render_rows(scene, sensor, film, SEED, SPP,
                                       SPEC_DEPTH, 1000, "spectral", 0, H,
                                       kinds=kinds, plain=True), reps=3)
    rays = H * W * SPP * (1 + 2 * (SPEC_DEPTH - 1))
    for key in ("K9", "K10", "K11"):
        k, p = times[key]
        print(f"time {key}: {k:.4f} ms, plain {p:.4f} ms at {n} lanes x "
              f"{N_HERO} wavelengths [{card}]")
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
        ops11 = (sky_pick * OPS["sample_sky"]
                 + (n - sky_pick) * OPS["sample_sun"]
                 + above11 * OPS["pdf"] + _spec_ops(d11, wl, state))
    gauss = 4 * 14 * 20
    bounds = {
        "K9": _bound(44 * n + SPEC_TABLE_BYTES, ops9),
        "K10": _bound(48 * n + SPEC_TABLE_BYTES + gauss,
                      ops9 + above * OPS["pdf"]),
        "K11": _bound(56 * n + SPEC_TABLE_BYTES + gauss, ops11),
    }
    names = {"K9": "sunsky_eval_spec", "K10": "sunsky_hit_spec",
             "K11": "sunsky_nee_spec"}
    return {key: (names[key], launches[names[key]], err[key], times[key],
                  bounds[key]) for key in names}


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
    from tpusky_torch.render.sensors import sample_ray
    from tpusky_torch.render.shapes import ray_intersect
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
    with open(lib_path[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "Compiling entry" in line:
                print("ptxas:", line.strip())

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

    rad2, pdf2 = K.sunsky_hit_rgb(state, dirs)
    ref2, refp2 = M._hit_rgb_plain(state, dirs)
    _count_outside("K2 radiance", _rel(rad2, ref2, 1e-3).amax(-1), 1e-4, n)
    _count_outside("K2 pdf", _rel(pdf2, refp2, 1e-3), 1e-3, n)
    results["K2"] = float((rad2 - ref2).abs().max())

    d3, rad3, pdf3 = K.sunsky_nee_rgb(state, u2)
    refd3, _refr3, refp3 = M._sample_eval_rgb_plain(state, u2)
    far = (d3 - refd3).abs().amax(-1)
    _count_outside("K3 direction", far, 1e-5, n)
    near = far <= 1e-5
    _count_outside("K3 pdf", _rel(pdf3, refp3, 1e-3)[near], 1e-3, n)
    rel3 = _rel(rad3, M._eval_rgb_plain(state, d3), 1e-3).amax(-1)
    med3 = float(rel3.median())
    print(f"check K3 radiance: median {med3:.3e} (bar 1e-4)")
    if not med3 <= 1e-4:
        raise AssertionError("K3 radiance median")
    _count_outside("K3 radiance", rel3, 1e-2, n)
    results["K3"] = float(far.max())
    del rad1, ref1, rad2, ref2, pdf2, refp2, d3, rad3, pdf3, refd3, refp3

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
    with torch.no_grad():
        cos_cut = math.cos(float(lp.sun_half_aperture))
        eps = 0.5 * (1.0 - cos_cut) * float(lp.disc_softness)
        cos_g = (d_ps.double() * st_g.sun_frame_n.double()).sum(-1)
        ramp = (cos_g - cos_cut) / eps + 0.5
        at_clamp = (d6 != d_ps).any(-1) & (
            (ramp.abs() < RAMP_BAND) | ((ramp - 1.0).abs() < RAMP_BAND))
    n_clamp = int(at_clamp.sum())
    print(f"check K6 lanes left out (directions differ, ramp within "
          f"{RAMP_BAND:g} of a clamp): {n_clamp} of {n} "
          f"(cap {int(RAMP_CAP * n)})")
    if n_clamp > RAMP_CAP * n:
        raise AssertionError(f"K6: {n_clamp} lanes at the ramp's clamps")
    _adjoint_check("K6 (plain sampler, ramp clamps left out)", rad6, rad_ps,
                   g_rad * (~at_clamp)[:, None], st_g, lp)
    # the attached-pdf adjoints K7, K8 are not ported: asking for them on
    # the card raises instead of running anything else
    for k, ask in (("K7", lambda: M.eval_pdf(st_g, d_k[:8])),
                   ("K8", lambda: M.sample_eval(st_g, u2[:8]))):
        try:
            ask()
        except NotImplementedError as e:
            if k not in str(e):
                raise
            print(f"check {k} refused: {e}")
        else:
            raise AssertionError(f"the attached pdf's gradient ran without "
                                 f"{k}")
    del dd_k, dd_p, dd_err, d_k, d_p, st_g, d6, rad6, d_ps, rad_ps, cos_g, ramp

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

    # a small frame through K4 on the card and the plain path on the CPU
    small = Film(32, 32, 3)
    scene_cpu, sensor_cpu = _headline_scene(state_cpu, "cpu")
    img_s = integrator.render(scene, sensor, small, SEED, spp=4).cpu()
    img_c = integrator.render(scene_cpu, sensor_cpu, small, SEED, spp=4)
    err_s = float((img_s - img_c).abs().max())
    print(f"check K4 vs CPU plain, 32x32x4: max {err_s:.3e}")
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

    # ---- 7. times ----
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
    # every lane a sun-cone sample (those add the sun row's 72 atomics)
    w_sky = float(state.sky_sampling_w)
    u_sky = torch.stack([u2[:, 0] * w_sky, u2[:, 1]], -1)
    u_sun = torch.stack([w_sky + (1.0 - w_sky) * u2[:, 0], u2[:, 1]], -1)
    k6_sky = _time_ms(lambda: K.launch_nee_bwd(tables, u_sky, g_rad), 5)
    k6_sun = _time_ms(lambda: K.launch_nee_bwd(tables, u_sun, g_rad), 5)
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
          f"headline sky weight {w_sky:.4f}) [{card}]")
    k4, p4 = times["K4"]
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

    # ---- 8. bounds and results ----
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
        n4 = H * W * SPP
        u_pos = torch.rand((n4, 2), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
        px = torch.arange(n4, device=dev) // SPP
        uv = torch.stack([(px % W + u_pos[:, 0]) / W,
                          (px // W + u_pos[:, 1]) / H], -1)
        hits = float(ray_intersect(scene.shapes,
                                   *sample_ray(sensor, uv))[4].sum())
    o = OPS
    sample_ops = sky_pick * o["sample_sky"] + (n - sky_pick) * o["sample_sun"]
    nee_ops = (sample_ops + above3 * (o["pdf"] + o["radiance"])
               + disc3 * o["radiance_sun"])
    per_hit = o["path"] + o["sample_sky"] + 2 * (o["pdf"] + o["radiance"])
    bounds = {
        "K1": _bound(24 * n + TABLE_BYTES,
                     above * o["radiance"] + disc * o["radiance_sun"]),
        "K2": _bound(28 * n + TABLE_BYTES + GAUSS_BYTES,
                     above * (o["radiance"] + o["pdf"])
                     + disc * o["radiance_sun"]),
        "K3": _bound(36 * n + TABLE_BYTES + GAUSS_BYTES, nee_ops),
        "K4": _bound(12 * n4 + TABLE_BYTES + GAUSS_BYTES,
                     hits * per_hit
                     + (n4 - hits) * (o["miss"] + o["radiance"])),
        "K5": _bound(36 * n + TABLE_BYTES + ROW_BYTES, vjp5),
        "K6": _bound(20 * n + TABLE_BYTES + GAUSS_BYTES + ROW_BYTES,
                     sample_ops + vjp6),
    }
    for key, (_, _, _, t, b) in spec.items():
        times[key], bounds[key] = t, b
    for key, (ms, by) in bounds.items():
        print(f"bound {key}: {ms:.4f} ms ({by}); measured "
              f"{times[key][0]:.4f} ms, {100 * ms / times[key][0]:.1f}% of "
              f"the bound's rate [{card}]")

    here = os.path.dirname(os.path.abspath(__file__))
    src = {
        "K1": ("sunsky_eval_rgb", "tpusky_torch/csrc/sunsky_kernels.cu",
               "tpusky/ops/pallas/sunsky_kernel.py:747", launches),
        "K2": ("sunsky_hit_rgb", "tpusky_torch/csrc/sunsky_kernels.cu",
               "tpusky/ops/pallas/sunsky_kernel.py:771", launches),
        "K3": ("sunsky_nee_rgb", "tpusky_torch/csrc/sunsky_kernels.cu",
               "tpusky/ops/pallas/sunsky_kernel.py:793", launches),
        "K4": ("direct_rgb_megakernel", "tpusky_torch/csrc/megakernel.cu",
               "tpusky/ops/pallas/megakernel.py:428", launches),
        "K5": ("sunsky_eval_rgb_bwd", "tpusky_torch/csrc/sunsky_adjoint.cu",
               "tpusky/ops/pallas/sunsky_kernel.py:1032", grad_launches),
        "K6": ("sunsky_nee_rgb_bwd", "tpusky_torch/csrc/sunsky_adjoint.cu",
               "tpusky/ops/pallas/sunsky_kernel.py:1133", grad_launches),
    }
    spec_src = {"K9": "tpusky/ops/pallas/sunsky_kernel.py:671",
                "K10": "tpusky/ops/pallas/sunsky_kernel.py:695",
                "K11": "tpusky/ops/pallas/sunsky_kernel.py:721"}
    for key, (name, count, err, _, _) in spec.items():
        src[key] = (name, "tpusky_torch/csrc/sunsky_spectral.cu",
                    spec_src[key], {name: count})
        results[key] = err
    kernels = []
    for key, (name, source, replaces, counts) in src.items():
        if not os.path.exists(os.path.join(here, source)):
            raise AssertionError(f"missing source {source}")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
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
