"""Shared parts of the port's recovery tests with real renders (16x16x2)
against `bench.py`'s (tests/test_torch_recovery.py and
tests/test_torch_recovery_renders.py, a file of at most 3 items that
pytest-xdist's `--dist loadfile` hands out after
tests/test_multihost.py): bench_train's machinery in both packages, the
port's recipe on it, and the three tests that render.
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


def _optax_ta(n4):
    """bench_train's optimizer (`bench.py:377-384`)."""
    return optax.multi_transform(
        {"t": optax.adam(optax.cosine_decay_schedule(0.05, n4, 0.1)),
         "alb": optax.adam(optax.cosine_decay_schedule(0.015, n4, 0.1)),
         "sun": optax.set_to_zero()}, {"t": "t", "alb": "alb", "sun": "sun"})


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
