"""The port's recovery recipe (`tpusky_torch.ad.recovery`) against
`bench.py`'s, on the CPU.

(a) `bench._recover_one` itself and the port's `recover_one` run on the
same synthetic machinery: an analytic loss of (turbidity, albedo, sun)
with its exact gradient, the reference's optax optimizer on the JAX side
and the port's `CosineAdam` on the torch side. (b) `CosineAdam` against
the optax `multi_transform` bench_train builds. (c) The port's evaluation
loss against `bench.py:363-375`'s formula on JAX's `render_rows` image.
(d) The whole recipe with real renders against `bench._recover_one` on
JAX's own bench_train machinery, marked slow, at 64x64x4 with the full
grid (at 16x16x2, and (c), in tests/test_torch_recovery_renders.py, with
the shared code in tests/torch_recovery_case.py). The full-size runs
(512x512x8, 320 iterations) go on the card: chip_smoke.py and
tools/torch_recover.py.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench

from tpusky_torch.ad import recovery as R

from torch_recovery_case import (H, SPP, W, _assert_follows, _jax_bench,
                                 _optax_ta, _port_recovery)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

_TRUE_SUN = np.asarray(R.TRUE_SUN) / np.linalg.norm(R.TRUE_SUN)


# ---------------------------------------------------------------------------
# (a) the recipe's control flow against bench._recover_one
# ---------------------------------------------------------------------------

def _loss_grad(t, alb, sun):
    """Analytic loss in float64 and its exact gradient: a turbidity bowl
    about 6.5 whose width depends on the sun's error, an albedo bowl, and
    a sun term that is minimal at the true sun."""
    t, alb, sun = (np.asarray(x, np.float64) for x in (t, alb, sun))
    n = np.linalg.norm(sun)
    u = sun / n
    c = float(u @ _TRUE_SUN)
    w = 1.0 + 3.0 * (1.0 - c)
    loss = (0.1 * w * (t - 6.5) ** 2 + float(((alb - 0.3) ** 2).sum())
            + 40.0 * (1.0 - c))
    dc = (_TRUE_SUN - c * u) / n
    g_sun = (-0.3 * (t - 6.5) ** 2 - 40.0) * dc
    return loss, (0.2 * w * (t - 6.5), 2.0 * (alb - 0.3), g_sun)


def _jax_machinery(log, n4, cands, t_grid):
    def eval_j(pd, target, key):
        loss = _loss_grad(pd["t"], pd["alb"], pd["sun"])[0]
        log.append((float(pd["t"]), np.asarray(pd["sun"], np.float64), loss))
        return loss

    opt = _optax_ta(n4)

    def step(st, params, target, key):
        loss, g = _loss_grad(params["t"], params["alb"], params["sun"])
        grads = {k: jnp.asarray(v, jnp.float32)
                 for k, v in zip(("t", "alb", "sun"), g)}
        up, st = opt.update(grads, st, params)
        return st, optax.apply_updates(params, up), loss

    return (eval_j, step, opt, n4, lambda seed: (None, None), cands, t_grid)


def _port_machinery(log, n4, cands, t_grid):
    def eval_fn(pd, target, seed):
        loss = _loss_grad(pd["t"], pd["alb"], pd["sun"])[0]
        log.append((float(pd["t"]), pd["sun"].numpy().astype(np.float64),
                    loss))
        return loss

    opt = R.CosineAdam({"t": 0.05, "alb": 0.015}, n4)

    def step(st, params, target, seed):
        loss, g = _loss_grad(params["t"], params["alb"], params["sun"])
        grads = {k: torch.tensor(np.asarray(v, np.float32))
                 for k, v in zip(("t", "alb", "sun"), g)}
        up, st = opt.update(grads, st, params)
        return st, {k: params[k] + up[k] for k in params}, loss

    return (eval_fn, step, opt, n4, lambda seed: (torch.zeros(()), seed),
            cands, t_grid)


def _final_of(log):
    """(t, sun) the recipe ends at: its last step is a 0.15-degree cap
    refinement, which evaluates the centre and then the 36 spiral
    directions (all above z = 0.05 here) and keeps the first least."""
    last = log[-37:]
    best = int(np.argmin([loss for _, _, loss in last]))
    return last[0][0], last[best][1]


def test_recipe_follows_the_reference():
    """Same grid pick, the same final turbidity and sun within 1e-5."""
    sun_init = np.asarray(R.SUN_INIT) / np.linalg.norm(R.SUN_INIT)
    cands = [sun_init, R.spiral_cap(sun_init, 20.0)[7]]
    t_grid = (3.0, 6.0)
    log_j, log_t = [], []
    err_j = bench._recover_one(0, _jax_machinery(log_j, 2, cands, t_grid))
    t_err, ang, params = R.recover_one(
        0, _port_machinery(log_t, 2, cands, t_grid))
    n_grid = len(cands) * len(t_grid)
    pick_j = int(np.argmin([v[2] for v in log_j[:n_grid]]))
    pick_t = int(np.argmin([v[2] for v in log_t[:n_grid]]))
    assert pick_j == pick_t
    assert len(log_j) == len(log_t)
    t_j, sun_j = _final_of(log_j)
    t_t, sun_t = _final_of(log_t)
    assert (t_t, sun_t.tolist()) == (float(params["t"]),
                                     params["sun"].double().tolist())
    assert abs(t_t - t_j) <= 1e-5
    assert np.abs(sun_t - sun_j).max() <= 1e-5
    assert abs(t_err - err_j[0]) <= 1e-5 and abs(ang - err_j[1]) <= 1e-5
    # the recipe did its work: turbidity from the grid's 3 or 6 to the
    # bowl's floor, the sun closer than the grid's pick (the refinements
    # reach 2.3 degrees in all)
    pick_ang = np.degrees(np.arccos(np.clip(
        cands[pick_t % len(cands)] @ _TRUE_SUN, -1, 1)))
    assert t_err < 0.05 and pick_ang - 2.31 < ang < pick_ang - 1.0


# ---------------------------------------------------------------------------
# (b) the scheduled, grouped Adam against optax.multi_transform
# ---------------------------------------------------------------------------

def test_cosine_adam_matches_optax():
    """Two phases of 6 updates of fixed gradients, the state re-initialised
    between them, against bench_train's optax optimizer: parameters within
    1e-6; the sun's updates exactly zero."""
    rng = np.random.default_rng(12)
    n = 6
    p0 = {"t": np.float32(3.0), "alb": np.full((3,), 0.3, np.float32),
          "sun": (np.asarray(R.SUN_INIT) / np.linalg.norm(R.SUN_INIT))
          .astype(np.float32)}
    grads = [{k: rng.normal(size=np.shape(v)).astype(np.float32)
              for k, v in p0.items()} for _ in range(2 * n)]
    opt_j, opt_t = _optax_ta(n), R.CosineAdam({"t": 0.05, "alb": 0.015}, n)
    p_j = {k: jnp.asarray(v) for k, v in p0.items()}
    p_t = {k: torch.tensor(v) for k, v in p0.items()}
    for phase in range(2):
        st_j, st_t = opt_j.init(p_j), opt_t.init(p_t)
        for g in grads[phase * n:(phase + 1) * n]:
            u_j, st_j = opt_j.update({k: jnp.asarray(v) for k, v in g.items()},
                                     st_j, p_j)
            p_j = optax.apply_updates(p_j, u_j)
            u_t, st_t = opt_t.update({k: torch.tensor(v)
                                      for k, v in g.items()}, st_t, p_t)
            assert torch.equal(u_t["sun"], torch.zeros(3))
            p_t = {k: p_t[k] + u_t[k] for k in p_t}
            for k in p0:
                assert np.abs(p_t[k].numpy() - np.asarray(p_j[k])).max() \
                    <= 1e-6, k
    assert float(p_t["t"]) != 3.0
    assert torch.equal(p_t["sun"], torch.tensor(p0["sun"]))


def test_cosine_rate_is_optax_schedule():
    for lr0, n in ((0.05, 80), (0.015, 2), (0.03, 100)):
        sched = optax.cosine_decay_schedule(lr0, n, 0.1)
        for k in (0, 1, n // 2, n - 1, n, n + 5):
            assert abs(R.cosine_rate(lr0, k, n) - float(sched(k))) \
                <= 1e-7 * lr0


@pytest.mark.slow
def test_full_grid_recipe_follows_the_reference():
    """As above at 64x64x4 with the full grid (8 turbidities x 37 suns)
    and five steps a phase (~100 s): every evaluation at the reference's
    sun, the turbidity within 2e-4 (five Adam steps a phase carry the
    gradients' last-digit differences further), the losses within 1e-2
    relative (near the optimum a loss is the residual of two nearly
    equal images), the final errors within 2e-4 and 1e-3 degrees."""
    machinery = R.bench_train_machinery("cpu", h=64, w=64, spp=4, iters=20)
    run = _port_recovery(machinery, machinery[5], R.T_GRID, 20)
    _assert_follows(run, _jax_bench(64, 4, 5), machinery[5], R.T_GRID,
                    1e-2, 2e-4, 1e-3)


def test_grad_only_sun_recovery_moves_toward_the_sun():
    """`bench_grad_sun_recovery`'s descent at 16x16x2, two phases of 3
    updates: finite losses, turbidity off its start of 3 and the sun
    closer than its start 5 degrees off."""
    out = R.grad_only_sun_recovery("cpu", h=H, w=W, spp=SPP, iters=3)
    assert out["iters"] == 6 and len(out["losses"]) == 6
    assert np.all(np.isfinite(out["losses"]))
    assert out["turbidity_abs_err"] < 3.5
    assert out["sun_err_deg"] < 5.0
