"""bench.py's inverse-rendering runs (`--train`, `--gradsun`) for the
PyTorch port, on one CUDA device.

    python3 tools/torch_recover.py [--seeds 0 1 2] [--iters 320]

Runs, at bench.py's sizes:
1. the timed training step of bench_train (512x512x8, log_l2_blur,
   scheduled Adam; 10 steps after a warm-up, `bench.py:422-431`);
2. bench_train's recovery recipe for each seed (`tpusky_torch.ad.
   recovery.recover_one`: grid init, four Adam phases, sun-cap
   refinements, ternary turbidity polish), each seed's errors, wall time
   and peak memory; the errors where each Adam phase began (the grid's
   pick, then after each sun-cap search) and where the last one ended,
   before the polish (where bench.py's round-4 recipe, without the
   polish and the last refinement, stopped); the loss where the recipe
   ended and at the truth with the recovered albedo;
3. the gradient-only sun recovery (256x256x8, from 5 degrees off),
   three times: it is not deterministic.

Prints one JSON line per result under bench.py's metric names
(`sunsky_train_step_ms`, `sunsky_train_recovery_seed`,
`sunsky_train_recovery`, `sunsky_grad_only_sun_recovery`), each with the
card's name and power limit as nvidia-smi reports them. Exits non-zero
without a CUDA device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()


def _emit(card, **fields):
    print(json.dumps(dict(fields, card=card)), flush=True)


def _errors(params):
    """(turbidity error, sun error in degrees) against the truth."""
    from tpusky_torch.ad import recovery as R
    t_err = abs(float(params["t"].clamp(1.0, 10.0)) - R.TRUE_TURBIDITY)
    sd = params["sun"].double().cpu().numpy()
    cos = sd @ np.asarray(R.TRUE_SUN) / (np.linalg.norm(sd)
                                         * np.linalg.norm(R.TRUE_SUN))
    return t_err, float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def instrumented_recovery(seed, machinery, iters):
    """`recover_one(seed, machinery, iters)` on the card with each step
    timed between two synchronisations and the kernel launches of the
    evaluations and of the steps counted apart -> dict(t_err, ang,
    params, phases (the errors where each Adam phase began: the grid's
    pick, then after the 1.5, 0.5 and 0.15 degree sun-cap searches),
    before_polish (the errors where the last Adam phase ended), step_s,
    wall_s, peak_gib, launches={"eval": {...}, "step": {...}})."""
    import torch
    from tpusky_torch.ad import recovery as R
    from tpusky_torch.ops.cuda import build
    eval_fn, step, opt, n4, target_of, cands, t_grid = machinery
    launches = {"eval": {}, "step": {}}
    step_s, last, phases = [], {}, []

    def counted(fn, kind):
        def f(*args):
            before = dict(build.launches)
            out = fn(*args)
            for k, v in build.launches.items():
                launches[kind][k] = launches[kind].get(k, 0) + v - before[k]
            return out
        return f

    def timed_step(*args):
        if len(step_s) % n4 == 0:
            phases.append(_errors(args[1]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        last["params"] = out[1]
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    t_err, ang, params = R.recover_one(
        seed, (counted(eval_fn, "eval"), counted(timed_step, "step"), opt,
               n4, target_of, cands, t_grid), iters)
    torch.cuda.synchronize()
    return dict(t_err=t_err, ang=ang, params=params, phases=phases,
                before_polish=_errors(last["params"]), step_s=step_s,
                wall_s=time.perf_counter() - t0,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches=launches)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--iters", type=int, default=320)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_recover needs a CUDA device")
    from tpusky_torch.ad import recovery as R
    dev = torch.device("cuda", 0)
    card = _card()

    machinery = R.bench_train_machinery(dev, iters=args.iters)
    eval_fn, step, opt, _, target_of, _, _ = machinery

    # ---- the timed step ----
    target0, seed0 = target_of(0)
    pd0 = {"t": torch.tensor(3.0, device=dev),
           "alb": torch.full((3,), 0.3, device=dev),
           "sun": torch.tensor(np.asarray(R.SUN_INIT, np.float32)
                               / np.linalg.norm(R.SUN_INIT), device=dev)}
    out = step(opt.init(pd0), pd0, target0, seed0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        out = step(out[0], out[1], target0, seed0)
    torch.cuda.synchronize()
    _emit(card, metric="sunsky_train_step_ms",
          value=(time.perf_counter() - t0) / 10 * 1e3, unit="ms/iter")

    # ---- the recovery, seed by seed ----
    t_errs, angs = [], []
    for seed in args.seeds:
        run = instrumented_recovery(seed, machinery, args.iters)
        t_errs.append(run["t_err"])
        angs.append(run["ang"])
        params = run["params"]
        # the loss where the recipe ended and at the truth (with the
        # recovered albedo), on the seed's target
        target, crn = target_of(seed)
        truth = dict(params, t=torch.tensor(R.TRUE_TURBIDITY, device=dev),
                     sun=torch.tensor(np.asarray(R.TRUE_SUN, np.float32),
                                      device=dev))
        _emit(card, metric="sunsky_train_recovery_seed", seed=seed,
              turbidity_abs_err=run["t_err"], sun_dir_err_deg=run["ang"],
              turbidity=float(params["t"]),
              sun=params["sun"].cpu().tolist(),
              turbidity_abs_err_before_polish=run["before_polish"][0],
              sun_dir_err_deg_before_polish=run["before_polish"][1],
              errors_where_phases_began=run["phases"],
              loss=float(eval_fn(params, target, crn)),
              loss_at_truth=float(eval_fn(truth, target, crn)),
              wall_s=run["wall_s"], peak_gib=run["peak_gib"])
    _emit(card, metric="sunsky_train_recovery",
          value=float(np.median(t_errs)), unit="turbidity_abs_err_median",
          turbidity_abs_err_worst=float(max(t_errs)),
          sun_dir_err_deg_median=float(np.median(angs)),
          sun_dir_err_deg_worst=float(max(angs)), iters=args.iters,
          seeds=len(args.seeds))

    # ---- the gradient-only sun recovery, run by run (it is not
    # deterministic: the adjoints' float atomics vary a gradient's last
    # bits, and 200 Adam steps on the widened disc ramp amplify them) ----
    for run in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = R.grad_only_sun_recovery(dev)
        torch.cuda.synchronize()
        _emit(card, metric="sunsky_grad_only_sun_recovery",
              value=res["sun_err_deg"], unit="sun_dir_err_deg",
              init_err_deg=5.0, turbidity_abs_err=res["turbidity_abs_err"],
              iters=res["iters"], run=run, wall_s=time.perf_counter() - t0)

if __name__ == "__main__":
    main()
