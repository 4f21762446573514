"""Drive the PyTorch port's main path once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. device: require CUDA; print the card's name and power limit;
2. build: compile the four kernels from tpusky_torch/csrc with nvcc;
3. K1-K3 against their plain PyTorch versions at 2,097,152 lanes;
4. the main path: precompute the headline sunsky, evaluate the sky dome
   (K1), render the headline scene (512x512, 8 spp, depth 2) through
   `render` (K4), and render it again through the wavefront `render_rows`
   (K2, K3); every kernel's launch count must rise, the image must be
   finite and non-zero, and K4 must agree with the plain wavefront path
   lane by lane and per image, on the card and against the CPU on a small
   frame;
5. times of each kernel and its plain version (CUDA events);
6. one JSON line of kernel results, then the device line, last.

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
MAX_DEPTH = 2
SEED = 1
SUN = [0.3, 0.2, 0.93]
# the allowed share of lanes outside a per-lane bar of phase 3
LANE_CAP = 1e-5


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def _rel(a, b, floor):
    return (a - b).abs() / (b.abs() + floor)


def _count_outside(name, err, bar, n):
    bad = int((err > bar).sum())
    cap = int(LANE_CAP * n)
    print(f"check {name}: {bad} of {n} lanes outside {bar:g} (cap {cap}), "
          f"max {float(err.max()):.3e}")
    if bad > cap:
        raise AssertionError(f"{name}: {bad} lanes outside {bar:g}")
    return bad


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
    with open(lib_path[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "Compiling entry" in line:
                print("ptxas:", line.strip())

    # ---- 3. K1-K3 against their plain versions ----
    params = tt.make_params(turbidity=3.0, albedo=0.3, sun_direction=SUN,
                            device=dev)
    state = tt.sunsky_precompute(params)
    state_cpu = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=SUN))
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

    # ---- 4. the main path ----
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
    print(f"main path: {main_s:.2f} s, launches {launches}")
    for name, count in launches.items():
        if count <= 0:
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
    scene_cpu, sensor_cpu = _headline_scene(state_cpu, None)
    img_s = integrator.render(scene, sensor, small, SEED, spp=4).cpu()
    img_c = integrator.render(scene_cpu, sensor_cpu, small, SEED, spp=4)
    err_s = float((img_s - img_c).abs().max())
    print(f"check K4 vs CPU plain, 32x32x4: max {err_s:.3e}")
    if not err_s < 1e-3 * max(float(img_c.max()), 1.0):
        raise AssertionError("K4 on the card disagrees with the CPU")

    # ---- 5. times ----
    tables = K.pack_tables(state, dev)
    mega = MK.pack(scene, sensor, state)
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
    }
    wave_ms = _time_ms(lambda: integrator.render_rows(
        scene, sensor, film, SEED, SPP, MAX_DEPTH, 1000, "rgb", 0, H), 5)
    wrap_ms = _time_ms(lambda: K.sunsky_eval_rgb(state, dirs))
    frame_ms = _time_ms(lambda: integrator.render(scene, sensor, film, SEED,
                                                  spp=SPP), 5)
    rays = H * W * SPP * (1 + 2 * (MAX_DEPTH - 1))
    k1, p1 = times["K1"]
    print(f"time K1 sunsky_eval_rgb: {k1:.4f} ms ({n / k1 / 1e3:.1f} M "
          f"evals/s), plain {p1:.4f} ms ({n / p1 / 1e3:.1f} M evals/s); "
          f"wrapper with table packing {wrap_ms:.4f} ms [{card}]")
    for name in ("K2", "K3"):
        k, p = times[name]
        print(f"time {name}: {k:.4f} ms, plain {p:.4f} ms at {n} lanes "
              f"[{card}]")
    k4, p4 = times["K4"]
    print(f"time K4 frame: {k4:.3f} ms ({rays / k4 / 1e3:.1f} M rays/s), "
          f"plain wavefront {p4:.3f} ms ({rays / p4 / 1e3:.1f} M rays/s), "
          f"wavefront with K2+K3 {wave_ms:.3f} ms "
          f"({rays / wave_ms / 1e3:.1f} M rays/s); render() with packing "
          f"and film {frame_ms:.3f} ms ({rays / frame_ms / 1e3:.1f} M "
          f"rays/s) [{card}]")

    # ---- 6. results ----
    here = os.path.dirname(os.path.abspath(__file__))
    src = {
        "K1": ("sunsky_eval_rgb", "tpusky_torch/csrc/sunsky_kernels.cu",
               "tpusky/ops/pallas/sunsky_kernel.py:747"),
        "K2": ("sunsky_hit_rgb", "tpusky_torch/csrc/sunsky_kernels.cu",
               "tpusky/ops/pallas/sunsky_kernel.py:771"),
        "K3": ("sunsky_nee_rgb", "tpusky_torch/csrc/sunsky_kernels.cu",
               "tpusky/ops/pallas/sunsky_kernel.py:793"),
        "K4": ("direct_rgb_megakernel", "tpusky_torch/csrc/megakernel.cu",
               "tpusky/ops/pallas/megakernel.py:428"),
    }
    kernels = []
    for key, (name, source, replaces) in src.items():
        if not os.path.exists(os.path.join(here, source)):
            raise AssertionError(f"missing source {source}")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": results[key], "ms": times[key][0],
                        "plain_ms": times[key][1]})
    if not all(math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError("timing")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
