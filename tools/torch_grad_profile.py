"""Where the time of the port's gradient and spectral paths goes, on one
NVIDIA GPU.

Runs chip_smoke.py's cases under `torch.profiler`: `bench.py::
bench_grad`'s step (512x512, 4 spp, depth 2, loss mean(img^2), gradients
to turbidity, albedo and sun direction through precompute; render_rows
with K2/K3 forward and K5/K6 backward), one `make_train_step_single`
step at 512x512, 8 spp (log_l2_blur, Adam), and `bench.py::
bench_spectral`'s frame (512x512, 8 spp, depth 4, `render(mode=
"spectral")` with K10/K11). For each it prints the wall time per
iteration, the device's busy share of it, the device time of the
hand-written kernels against all the rest, and the 15 largest device-time
entries. Run from the repository root on a machine with a card, for all
cases or the named ones (grad, train, spectral):

    python3 tools/torch_grad_profile.py [case ...]
"""

import os
import sys
import time


def _device_us(evt):
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


_OWN = ("hit_kernel", "nee_kernel", "eval_kernel", "mega_kernel",
        "eval_bwd_kernel", "nee_bwd_kernel", "reduce_partials",
        "eval_spec_kernel", "hit_spec_kernel", "nee_spec_kernel")


def _profile(name, fn, iters=3):
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0) / iters
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels) / iters
    own_us = sum(e.device_time_total for e in kernels
                 if any(k in e.name for k in _OWN)) / iters
    print(f"== {name}: wall {wall_us / 1e3:.2f} ms per iteration, device "
          f"busy {busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), "
          f"of which the hand-written kernels {own_us / 1e3:.3f} ms, "
          f"{len(kernels) // iters} kernel launches per iteration")
    rows = sorted(prof.key_averages(), key=_device_us, reverse=True)
    for e in rows[:15]:
        print(f"  {_device_us(e) / iters / 1e3:9.3f} ms  {e.count // iters:6d}x"
              f"  {e.key[:90]}")


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_grad_profile needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    import tpusky_torch as tt
    from tpusky_torch.render import integrator
    from tpusky_torch.render.film import Film

    cases = set(sys.argv[1:]) or {"grad", "train", "spectral"}
    dev = torch.device("cuda", 0)
    state = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=cs.SUN, device=dev))
    scene, sensor = cs._headline_scene(state, dev)
    tables = tt.load_tables("rgb", device=dev)
    film = Film(cs.H, cs.W, 3)
    step, opt, _, params, target = cs.train_case(scene, sensor, film,
                                                 tables, dev)
    opt_state = opt.init(params)

    spec = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=cs.SUN, mode="spectral",
        device=dev), mode="spectral")
    spec_scene, spec_sensor = cs._spectral_scene(spec, dev)

    print(f"card: {cs._card_line()}, torch {torch.__version__}")
    if "grad" in cases:
        _profile(f"bench_grad fwd+bwd, {cs.H}x{cs.W}x{cs.GRAD_SPP}",
                 lambda: cs.grad_case("rows", scene, sensor, film, tables,
                                      dev))
    if "train" in cases:
        _profile(f"train step, {cs.H}x{cs.W}x{cs.SPP}, log_l2_blur",
                 lambda: step(opt_state, params, target, cs.SEED))
    if "spectral" in cases:
        _profile(f"bench_spectral frame, {cs.H}x{cs.W}x{cs.SPP}, depth "
                 f"{cs.SPEC_DEPTH}",
                 lambda: integrator.render(spec_scene, spec_sensor, film,
                                           cs.SEED, spp=cs.SPP,
                                           max_depth=cs.SPEC_DEPTH,
                                           mode="spectral"))


if __name__ == "__main__":
    main()
