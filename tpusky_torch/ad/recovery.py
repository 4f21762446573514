"""Inverse-rendering recovery: turbidity and sun direction from a render.

The PyTorch counterpart of `bench.py`'s config-5 recipe (`_recover_one`,
`bench_train`, `bench.py:224-449`) and of its gradient-only sun recovery
(`bench_grad_sun_recovery`, `bench.py:502-580`), as library code.

`recover_one` runs the recipe on a machinery tuple `(eval, step, opt, n4,
target_of, sun_cands, t_grid)`, the reference's; `bench_train_machinery`
builds bench_train's. Forward-only evaluations (the target, the grid, the
sun-cap refinements, the turbidity polish) go through
`integrator._render_impl`: kernel K4 on the card, the wavefront path on
the CPU. The gradient steps are `make_train_step_single`'s (the wavefront:
K2/K3 forward, K5/K6 backward on the card). K4's plain version is the
wavefront at the same seed, so both see one estimator.

The reference's optax optimizer, `multi_transform` of
`adam(cosine_decay_schedule(lr0, n, 0.1))` per parameter and
`set_to_zero()` for the rest, is `CosineAdam` here: the port's `Adam`
with per-parameter rates set from optax's schedule before each update.
The recipe's geometry (the cap frames, the spiral) stays in numpy
float64, as the reference keeps it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.sunsky import model as M
from ..models.sunsky.tables import load_tables
from ..parallel.render import image_loss, make_train_step_single
from ..render import film as film_mod
from ..render import integrator
from ..render.bsdf import table_kinds
from ..render.scene import make_scene
from ..render.sensors import make_perspective
from .optimizers import Adam

TRUE_TURBIDITY = 6.5
TRUE_SUN = (0.45, 0.30, 0.84)       # normalised where it is used
SUN_INIT = (0.35, 0.2, 0.91)
T_GRID = (2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0)
_UP = np.asarray([0.0, 0.0, 1.0])
_GOLDEN_ANGLE = np.pi * (3.0 - np.sqrt(5.0))


def cosine_rate(lr0: float, count: int, decay_steps: int,
                alpha: float = 0.1) -> float:
    """optax's `cosine_decay_schedule(lr0, decay_steps, alpha)` at update
    `count` (counting from 0, as `scale_by_schedule` counts)."""
    frac = min(count, decay_steps) / decay_steps
    return lr0 * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac))
                  + alpha)


class CosineAdam:
    """Adam with a cosine-decayed rate per named parameter; parameters
    without a rate are frozen (their update is exactly zero). The state is
    (update count, Adam state); `init` starts the schedule over."""

    def __init__(self, lr0: dict, decay_steps: int, alpha: float = 0.1):
        self.lr0 = dict(lr0)
        self.decay_steps = int(decay_steps)
        self.alpha = float(alpha)
        self.adam = Adam(0.0)

    def init(self, params):
        return 0, self.adam.init(params)

    def update(self, grads, state, params=None):
        count, st = state
        self.adam.set_learning_rate(**{
            k: cosine_rate(lr, count, self.decay_steps, self.alpha)
            for k, lr in self.lr0.items()})
        updates, st = self.adam.update(grads, st, params)
        updates = {k: u if k in self.lr0 else torch.zeros_like(u)
                   for k, u in updates.items()}
        return updates, (count + 1, st)


def _unit(v):
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def spiral_cap(center, radius_deg: float, n_dir: int = 36):
    """Golden-angle spiral of n_dir unit directions over the spherical cap
    of radius_deg about `center` (float64), in the reference's frame
    (`bench.py:256-270, 404-416`); directions at z <= 0.05 are left out."""
    c = _unit(center)
    t1 = np.cross(c, _UP)
    if np.linalg.norm(t1) < 1e-9:
        t1 = np.asarray([1.0, 0.0, 0.0])
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(c, t1)
    out = []
    for k in range(n_dir):
        r_f = np.sqrt((k + 0.5) / n_dir) * np.radians(radius_deg)
        th = _GOLDEN_ANGLE * k
        v = np.cos(r_f) * c + np.sin(r_f) * (np.cos(th) * t1
                                              + np.sin(th) * t2)
        v /= np.linalg.norm(v)
        if v[2] > 0.05:
            out.append(v)
    return out


def _f32(v, like):
    return torch.tensor(np.float32(v) if np.ndim(v) == 0
                        else np.asarray(v, np.float32), device=like.device)


def recover_one(seed: int, machinery, iters: int = 320):
    """One recovery run of the config-5 recipe (`bench.py:224-324`) ->
    (turbidity error, sun error in degrees, final parameters):

    1. a grid init over turbidity x the sun cap under the blurred loss;
    2. four turbidity + albedo Adam phases with the sun frozen, the
       optimizer re-initialised each phase, and after phases 1-3
    3. direct searches of the sun over caps of radius 1.5, 0.5 and 0.15
       degrees (36 spiral directions, the argmin of the loss);
    4. a 14-step ternary search of turbidity over +-0.5, then a last
       0.15-degree refinement.

    `iters` is the reference's argument; the phases' length is the
    machinery's `n4`."""
    del iters
    eval_fn, step, opt, n4, target_of, sun_cands, t_grid = machinery
    target, crn = target_of(seed)

    def loss_of(pd):
        return float(eval_fn(pd, target, crn))

    best, params = np.inf, None
    for tv in t_grid:
        for sv in sun_cands:
            pd = {"t": _f32(tv, target),
                  "alb": torch.full((3,), 0.3, device=target.device),
                  "sun": _f32(sv, target)}
            loss = loss_of(pd)
            if loss < best:
                best, params = loss, pd

    def sun_cap_refine(params, radius_deg):
        best_v = _unit(params["sun"].cpu().numpy())
        best_l = loss_of(params)
        for v in spiral_cap(best_v, radius_deg):
            cand = dict(params, sun=_f32(v, target))
            loss = loss_of(cand)
            if loss < best_l:
                best_l, best_v = loss, v
        return dict(params, sun=_f32(best_v, target))

    for radius in (1.5, 0.5, 0.15, None):
        opt_state = opt.init(params)
        for _ in range(n4):
            opt_state, params, _loss = step(opt_state, params, target, crn)
        if radius is not None:
            params = sun_cap_refine(params, radius)

    # derivative-free turbidity polish: the Adam endpoint is margin-limited
    # (the CRN loss is shallow near the optimum), so a ternary search pins
    # it at the loss minimum itself (`bench.py:288-309`)
    lo, hi = float(params["t"]) - 0.5, float(params["t"]) + 0.5
    for _ in range(14):
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        if (loss_of(dict(params, t=_f32(m1, target)))
                < loss_of(dict(params, t=_f32(m2, target)))):
            hi = m2
        else:
            lo = m1
    params = dict(params, t=_f32(0.5 * (lo + hi), target))
    params = sun_cap_refine(params, 0.15)

    t_err = abs(float(params["t"].clamp(1.0, 10.0)) - TRUE_TURBIDITY)
    sd = _unit(params["sun"].cpu().numpy())
    ang = float(np.degrees(np.arccos(np.clip(np.dot(sd, _unit(TRUE_SUN)),
                                             -1.0, 1.0))))
    return t_err, ang, params


def _sphere_plane_scene(device):
    """bench.py's `_sphere_plane_scene`: a diffuse sphere on a ground."""
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    sphere = np.eye(4, dtype=np.float32)
    sphere[2, 3] = 1.0
    return make_scene(
        shapes=[dict(kind=1, to_world=ground, bsdf_idx=0),
                dict(kind=0, to_world=sphere, bsdf_idx=1)],
        bsdf_albedos=[[0.4, 0.4, 0.4], [0.6, 0.2, 0.2]], env=None,
        device=device)


def _norm(v):
    return v / torch.sqrt((v ** 2).sum())


def bench_train_setup(device="cuda", h: int = 512, w: int = 512):
    """bench_train's scene builder, base scene, camera and film
    (`bench.py:337-358`): `scene_builder(pd)` clips turbidity to [1, 10]
    and albedo to [0, 1], normalises the sun and precomputes the sunsky
    of a parameter dict {t, alb, sun}."""
    tables = load_tables("rgb", device=device)
    base_scene = _sphere_plane_scene(device)
    sensor = make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device=device)

    def scene_builder(pd):
        full = M.make_params(turbidity=pd["t"].clamp(1.0, 10.0),
                             albedo=pd["alb"].clamp(0.0, 1.0),
                             sun_direction=_norm(pd["sun"]), device=device)
        return base_scene._replace(env=M.precompute(tables, full))

    return scene_builder, base_scene, sensor, film_mod.Film(h, w, 3)


def bench_train_machinery(device="cuda", h: int = 512, w: int = 512,
                          spp: int = 8, iters: int = 320):
    """bench_train's machinery (`bench.py:337-420`) -> (eval, step, opt,
    n4, target_of, sun_cands, t_grid), for `recover_one`.

    eval(pd, target, seed) is `bench.py:363-375`'s loss, the log-space
    MSE plus 16 x that of images blurred by a sigma = H/32 gaussian
    (`image_loss(..., "log_l2_blur")`), of the frame rendered through
    `_render_impl`; target_of(seed) renders the truth (turbidity 6.5,
    albedo 0.3, sun [0.45, 0.30, 0.84]) at the sampler seed
    123 + 1000 * seed, the reference's `PRNGKey(123 + 1000 * seed)`."""
    scene_builder, base_scene, sensor, film = bench_train_setup(device, h,
                                                                w)
    kinds = table_kinds(base_scene.bsdfs)

    def render(scene, seed):
        return film_mod.develop(integrator._render_impl(
            scene, sensor, film, seed, spp, 2, 1000, "rgb", kinds=kinds))

    @torch.no_grad()
    def eval_fn(pd, target, seed):
        return image_loss(render(scene_builder(pd), seed), target,
                          "log_l2_blur")

    n4 = max(iters // 4, 1)
    opt = CosineAdam({"t": 0.05, "alb": 0.015}, n4)
    step = make_train_step_single(scene_builder, sensor, film, spp=spp,
                                  optimizer=opt, max_depth=2, project=None,
                                  loss="log_l2_blur")
    truth = base_scene._replace(env=M.precompute(
        load_tables("rgb", device=device),
        M.make_params(turbidity=TRUE_TURBIDITY, albedo=0.3,
                      sun_direction=TRUE_SUN, device=device)))

    @torch.no_grad()
    def target_of(seed):
        crn = 123 + 1000 * seed
        return render(truth, crn), crn

    # the sun candidates: the documented init and a 20-degree cap about it
    cands = [_unit(SUN_INIT)] + spiral_cap(SUN_INIT, 20.0)
    return eval_fn, step, opt, n4, target_of, cands, T_GRID


def grad_only_sun_recovery(device="cuda", h: int = 256, w: int = 256,
                           spp: int = 8, iters: int = 100):
    """Gradient-only sun recovery (`bench.py:502-580`): joint Adam on
    (turbidity, sun direction) from a sun 5 degrees off and turbidity 3,
    albedo fixed at 0.3, the disc's straight-through ramp widened to
    `disc_softness` 2000 during the descent (the target is rendered at
    1), a log-space MSE through `render_rows` differentiated by autograd;
    two phases of `iters` updates at cosine rates (t, sun) = (0.08, 0.03),
    then (0.03, 0.006). No grid or direct search anywhere.
    -> dict(sun_err_deg, turbidity_abs_err, losses, iters)."""
    tables = load_tables("rgb", device=device)
    _, base_scene, sensor, film = bench_train_setup(device, h, w)
    kinds = table_kinds(base_scene.bsdfs)
    true_sun = _unit(TRUE_SUN)
    seed = 123

    def render_of(pd, soft):
        full = M.make_params(turbidity=pd["t"].clamp(1.0, 10.0), albedo=0.3,
                             sun_direction=_norm(pd["sun"]),
                             disc_softness=soft, device=device)
        sc = base_scene._replace(env=M.precompute(tables, full))
        return film_mod.develop(integrator.render_rows(
            sc, sensor, film, seed, spp, 2, 1000, "rgb", 0, h, kinds=kinds))

    like = torch.zeros((), device=device)
    with torch.no_grad():
        target = render_of({"t": _f32(TRUE_TURBIDITY, like),
                            "sun": _f32(true_sun, like)}, 1.0)

    ax = _unit(np.cross(true_sun, _UP))
    th = np.radians(5.0)
    pd = {"t": _f32(3.0, like),
          "sun": _f32(np.cos(th) * true_sun + np.sin(th) * ax, like)}
    losses = []
    for soft, lr_sun, lr_t in ((2000.0, 0.03, 0.08), (2000.0, 0.006, 0.03)):
        opt = CosineAdam({"t": lr_t, "sun": lr_sun}, iters)
        st = opt.init(pd)
        for _ in range(iters):
            leaves = {k: v.detach().requires_grad_() for k, v in pd.items()}
            loss = image_loss(render_of(leaves, soft), target, "log_l2")
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
            up, st = opt.update(grads, st, pd)
            pd = {k: pd[k] + up[k] for k in pd}
            losses.append(loss.detach())
    sd = _unit(pd["sun"].cpu().numpy())
    ang = float(np.degrees(np.arccos(np.clip(np.dot(sd, true_sun), -1, 1))))
    return {"sun_err_deg": ang,
            "turbidity_abs_err": abs(float(pd["t"]) - TRUE_TURBIDITY),
            "losses": [float(v) for v in torch.stack(losses).cpu()],
            "iters": 2 * iters}
