"""The port's recovery recipe (`tpusky_torch.ad.recovery`) against
`bench.py`'s, on the CPU.

(a) `bench._recover_one` itself and the port's `recover_one` run on the
same synthetic machinery: an analytic loss of (turbidity, albedo, sun)
with its exact gradient, the reference's optax optimizer on the JAX side
and the port's `CosineAdam` on the torch side. (b) `CosineAdam` against
the optax `multi_transform` bench_train builds. (c) The port's evaluation
loss against `bench.py:363-375`'s formula on JAX's `render_rows` image.
(d) The whole recipe with real renders at 16x16x2, and against
`bench._recover_one` on JAX's own bench_train machinery at that size
(and, marked slow, at 64x64x4 with the full grid). The full-size runs (512x512x8, 320 iterations) go on the card:
chip_smoke.py and tools/torch_recover.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench
import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky.tables import load_tables as jax_load_tables
from tpusky.render import film as JF
from tpusky.render import integrator as JI
from tpusky.render import sensors as JS
from tpusky.render.bsdf import table_kinds

from tpusky_torch.ad import recovery as R

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

_TRUE_SUN = np.asarray(R.TRUE_SUN) / np.linalg.norm(R.TRUE_SUN)


def _optax_ta(n4):
    """bench_train's optimizer (`bench.py:377-384`)."""
    return optax.multi_transform(
        {"t": optax.adam(optax.cosine_decay_schedule(0.05, n4, 0.1)),
         "alb": optax.adam(optax.cosine_decay_schedule(0.015, n4, 0.1)),
         "sun": optax.set_to_zero()}, {"t": "t", "alb": "alb", "sun": "sun"})


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


# ---------------------------------------------------------------------------
# (c), (d) real renders at 16x16x2
# ---------------------------------------------------------------------------

H = W = 16
SPP = 2
SEED = 5      # bench's PRNGKey(5): key_data(PRNGKey(5))[-1] == 5


@pytest.fixture(scope="module")
def machinery():
    return R.bench_train_machinery("cpu", h=H, w=W, spp=SPP, iters=8)


def _jax_bench(h, spp, n4):
    """bench_train's machinery as `bench.py:337-420` builds it, in JAX at
    h x h x spp -> (eval_j, step, opt, n4, target_of)."""
    from tpusky.parallel.render import make_train_step_single
    tables = jax_load_tables("rgb")
    base = bench._sphere_plane_scene()
    sensor = JS.make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45)
    film = JF.Film(h, h, 3)
    kinds = table_kinds(base.bsdfs)

    def scene_builder_min(pd):
        full = ts.make_params(
            turbidity=jnp.clip(pd["t"], 1.0, 10.0),
            albedo=jnp.clip(pd["alb"], 0.0, 1.0),
            sun_direction=pd["sun"] / jnp.linalg.norm(pd["sun"]))
        return base._replace(env=JM.precompute(tables, full, "rgb"))

    @jax.jit
    def render_loss(pd, target, key):
        # bench_train's eval_j (the image, then bench.py:363-375's loss);
        # the image also gives the target, so the file compiles one
        # forward program
        img = JF.develop(JI.render_rows(scene_builder_min(pd), sensor, film,
                                        key, spp, 2, 1000, "rgb", 0, h,
                                        kinds=kinds))
        li = jnp.log1p(jnp.maximum(img, 0.0))
        lt = jnp.log1p(jnp.maximum(target, 0.0))
        sig = h / 32.0
        r = jnp.arange(h, dtype=jnp.float32)
        B = jnp.exp(-0.5 * ((r[:, None] - r[None, :]) / sig) ** 2)
        B = B / B.sum(axis=1, keepdims=True)

        def blur(x):
            return jnp.einsum("ij,jwc->iwc", B,
                              jnp.einsum("ij,hjc->hic", B, x))
        return img, (jnp.mean((li - lt) ** 2)
                     + 16.0 * jnp.mean((blur(li) - blur(lt)) ** 2))

    def eval_j(pd, target, key):
        return render_loss(pd, target, key)[1]

    opt = _optax_ta(n4)
    step = make_train_step_single(scene_builder_min, sensor, film, spp=spp,
                                  optimizer=opt, max_depth=2, project=None,
                                  loss="log_l2_blur")
    truth = {"t": jnp.float32(6.5), "alb": jnp.full((3,), 0.3, jnp.float32),
             "sun": jnp.asarray([0.45, 0.30, 0.84], jnp.float32)}

    def target_of(seed):
        key = jax.random.PRNGKey(123 + 1000 * seed)
        return render_loss(truth, jnp.zeros((h, h, 3)), key)[0], key

    return eval_j, step, opt, n4, target_of


@pytest.fixture(scope="module")
def jax_bench():
    return _jax_bench(H, SPP, 2)


def test_eval_loss_matches_bench_formula(machinery, jax_bench):
    """The port's evaluation loss against `bench.py:363-375` on JAX's
    `render_rows` image of bench_train's scene, at two parameter points
    and one seed: 1e-4 relative."""
    eval_fn, target_of = machinery[0], machinery[4]
    eval_j = jax_bench[0]
    target, crn = target_of(0)
    assert crn == 123
    for t, sun in ((3.0, R.SUN_INIT), (6.0, (0.45, 0.31, 0.83))):
        pd = {"t": np.float32(t), "alb": np.full((3,), 0.3, np.float32),
              "sun": np.asarray(sun, np.float32)}
        ref = float(eval_j({k: jnp.asarray(v) for k, v in pd.items()},
                           jnp.asarray(target.numpy()),
                           jax.random.PRNGKey(SEED)))
        got = float(eval_fn({k: torch.tensor(v) for k, v in pd.items()},
                            target, SEED))
        assert abs(got - ref) <= 1e-4 * abs(ref), (t, got, ref)
        assert ref > 0.0


T_GRID_SMALL = (3.0, 6.0)


def _port_recovery(machinery, cands, t_grid, iters):
    """The port's recipe on a machinery -> (its evaluations as (t, sun,
    loss), its result)."""
    eval_fn, step, opt, n4, target_of = machinery[:5]
    log = []

    def logged(pd, target, seed):
        loss = float(eval_fn(pd, target, seed))
        log.append((float(pd["t"]), pd["sun"].double().numpy(), loss))
        return loss

    out = R.recover_one(0, (logged, step, opt, n4, target_of, cands, t_grid),
                        iters)
    return log, out


@pytest.fixture(scope="module")
def port_recovery(machinery):
    """The recipe on bench_train's scene at 16x16x2, 8 iterations, a
    two-point turbidity grid and three sun candidates."""
    return _port_recovery(machinery, machinery[5][:3], T_GRID_SMALL, 8)


def test_recipe_with_renders_lowers_the_loss(machinery, port_recovery):
    """The whole recipe with real renders ends at a loss no higher than
    the grid's best."""
    eval_fn, n4, target_of, cands = (machinery[0], machinery[3],
                                     machinery[4], machinery[5])
    assert n4 == 2 and len(cands) == 37
    log, (t_err, ang, params) = port_recovery
    grid_best = min(loss for _, _, loss in log[:6])
    target, crn = target_of(0)
    final = float(eval_fn(params, target, crn))
    assert final <= grid_best
    assert np.isfinite(t_err) and np.isfinite(ang)
    assert set(params) == {"t", "alb", "sun"}


def _assert_follows(port_run, jax_machinery, cands, t_grid, loss_rtol,
                    t_tol, ang_tol):
    """`bench._recover_one` on the JAX machinery, against the port's run:
    the same grid pick, every evaluation at the same sun within 1e-5 and
    turbidity within t_tol (the Adam steps' gradients differ in their
    last digits; the sun moves only by the searches, so every decision
    of the recipe is the reference's), the losses within loss_rtol
    relative and the final errors within t_tol and ang_tol degrees."""
    log_t, (t_err, ang, _) = port_run
    log_j = []
    eval_j, step, opt, n4, target_of = jax_machinery

    def logged(pd, target, key):
        loss = float(eval_j(pd, target, key))
        log_j.append((float(pd["t"]), np.asarray(pd["sun"], np.float64),
                      loss))
        return loss

    t_err_j, ang_j = bench._recover_one(
        0, (logged, step, opt, n4, target_of, cands, t_grid))
    assert len(log_j) == len(log_t)
    n_grid = len(cands) * len(t_grid)
    assert (np.argmin([v[2] for v in log_j[:n_grid]])
            == np.argmin([v[2] for v in log_t[:n_grid]]))
    for (tj, sj, lj), (tt_, st, lt) in zip(log_j, log_t):
        assert abs(tt_ - tj) <= t_tol and np.abs(st - sj).max() <= 1e-5
        assert abs(lt - lj) <= loss_rtol * lj
    assert abs(t_err - t_err_j) <= t_tol and abs(ang - ang_j) <= ang_tol


def test_recipe_with_renders_follows_the_reference(machinery, jax_bench,
                                                   port_recovery):
    """`bench._recover_one` on JAX's bench_train machinery (render_rows,
    make_train_step_single, optax) and the port's `recover_one` on
    `bench_train_machinery("cpu")`, both at 16x16x2 with n4 = 2, the
    same two-point grid and three candidates, each on its own target
    (the same seed): the same grid pick, every evaluation at the same
    point, the losses within 1e-3 relative, the final errors within 1e-5
    (turbidity) and 1e-4 degrees (sun)."""
    _assert_follows(port_recovery, jax_bench, machinery[5][:3],
                    T_GRID_SMALL, 1e-3, 1e-5, 1e-4)


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
