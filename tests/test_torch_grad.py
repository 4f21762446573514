"""Gradients of the port (`tpusky_torch`) against the JAX package.

Both run on the CPU from the same numpy-seeded inputs and cotangents: the
JAX side takes `jax.vjp`/`jax.grad` of its jnp path (the port's reference:
the Pallas adjoints are looser at the disc edge) and, where stated, its
Pallas adjoint kernels in interpret mode; the port takes torch autograd
through its plain versions, which is what CPU tensors run. On the card
the same plain versions are the reference the adjoint kernels K5 and K6
are held against (chip_smoke.py).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky import tables as JT
from tpusky.ops.pallas import sunsky_kernel as JK
from tpusky.render import film as JF
from tpusky.render import integrator as JI
from tpusky.render import sensors as JS
from tpusky.render.bsdf import table_kinds
from tpusky.render.scene import make_scene as jax_make_scene

import tpusky_torch as tt
from tpusky_torch import convert
from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.models.sunsky import tables as TT
from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.render import scene as TSC
from tpusky_torch.render import sensors as TS
from tpusky_torch.render import shapes as TSH

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

SUN = [0.3, 0.2, 0.93]
_PARAM_FIELDS = ("turbidity", "albedo", "sun_direction", "sky_scale",
                 "sun_scale", "sun_half_aperture", "disc_softness")
# the state fields radiance reads, by path
_RAD_FIELDS = ("sky_params", "sky_radiance", "sun_radiance", "sun_frame_n",
               "params.sky_scale", "params.sun_scale",
               "params.sun_half_aperture", "params.disc_softness")
# cotangents that sum the disc surrogate's ramp lanes (see _check_fields)
_RAMP_FIELDS = ("sun_frame_n", "params.sun_half_aperture",
                "params.disc_softness")


def _get(obj, path):
    for name in path.split("."):
        obj = getattr(obj, name)
    return obj


def _cpu_params(**kw):
    p = TM.make_params(device="cpu", **kw)
    return p._replace(**{f: getattr(p, f).clone().requires_grad_()
                         for f in _PARAM_FIELDS})


def _leaf_state(state):
    """The state with every field radiance reads made a leaf of its own."""
    def leaf(t):
        return t.detach().clone().requires_grad_()
    params = state.params._replace(**{
        f.split(".")[1]: leaf(_get(state, f))
        for f in _RAD_FIELDS if f.startswith("params.")})
    return state._replace(params=params, **{
        f: leaf(getattr(state, f)) for f in _RAD_FIELDS if "." not in f})


def _rel_max(a, b):
    """max |a - b| over max |b| (the bar is relative to the array's scale:
    entries near zero are sums that cancel)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _check_fields(grads_t, grads_j, tol, ramp_tol, soft_tol=None):
    """Each state-field cotangent within `tol` of the JAX one, relative to
    its scale; the ramp-driven ones within `ramp_tol`: one ulp of
    cos(gamma) moves a disc-edge lane across the surrogate ramp's clamp,
    where its derivative jumps from 2 / (1 - cos_cut) to 0."""
    for f in _RAD_FIELDS:
        bar = ramp_tol if f in _RAMP_FIELDS else tol
        if f == "params.disc_softness" and soft_tol is not None:
            bar = soft_tol
        err = _rel_max(grads_t[f], grads_j[f])
        assert err <= bar, (f, err)


@pytest.fixture(scope="module")
def jax_tables():
    return JT.load_tables("rgb")


@pytest.fixture(scope="module")
def torch_tables():
    return TT.load_tables("rgb", device="cpu")


# ---------------------------------------------------------------------------
# precompute
# ---------------------------------------------------------------------------

_PRECOMPUTE_CASES = [(t, sun) for t in (3.0, 3.8)
                     for sun in (SUN, [0.8, -0.3, 0.2])]


@pytest.fixture(scope="module")
def jax_precompute_vjps(jax_tables):
    """{(turbidity, sun): (the random cotangents of the state's leaves,
    their pullback to the parameters by jax.vjp)}. The pullback is one
    jitted program for all four cases, but the sun's half aperture's path
    through the sky/sun weight: that is the weight's 64 x 64 quadrature,
    whose float32 sums jit reassociates (moving the aperture's cotangent
    by up to 3e-4), so it is taken op by op, as the port does, through
    `_estimate_sky_sun_ratio` alone at the jitted state, and added to the
    aperture's own cotangent (the state carries the parameters)."""
    def leaves(p):
        return tuple(jax.tree.leaves(JM.precompute(jax_tables, p, "rgb")))

    @jax.jit
    def pull(p, cts):
        return (JM.precompute(jax_tables, p, "rgb"),
                jax.vjp(leaves, p)[1](cts)[0])
    out = {}
    for turbidity, sun in _PRECOMPUTE_CASES:
        jp = ts.make_params(turbidity=turbidity, albedo=0.3,
                            sun_direction=sun)
        rng = np.random.default_rng(int(10 * turbidity) + len(sun))
        shapes = jax.eval_shape(leaves, jp)
        cts = tuple(rng.normal(size=x.shape).astype(np.float32)
                    for x in shapes)
        js, g_j = pull(jp, cts)

        def ratio(a, js=js):
            p = js.params._replace(sun_half_aperture=a)
            return JM._estimate_sky_sun_ratio(js._replace(params=p),
                                              "rgb")[0]
        flat = jax.tree.leaves(js)
        w_at = next(i for i, x in enumerate(flat)
                    if x is js.sky_sampling_w)
        ap_at = next(i for i, x in enumerate(flat)
                     if x is js.params.sun_half_aperture)
        (g_ap,) = jax.vjp(ratio, jp.sun_half_aperture)[1](
            jnp.asarray(cts[w_at]))
        out[turbidity, tuple(sun)] = cts, g_j._replace(
            sun_half_aperture=g_ap + cts[ap_at])
    return out


@pytest.mark.parametrize("sun", [SUN, [0.8, -0.3, 0.2]])
@pytest.mark.parametrize("turbidity", [3.0, 3.8])
def test_precompute_vjp_matches_jax(jax_precompute_vjps, torch_tables,
                                    turbidity, sun):
    """A random cotangent on every state field, pulled back to the
    parameters: within 1e-4 of jax.vjp, relative to each parameter's
    cotangent scale. Integer turbidity sits on the floor/lerp kink. The
    JAX side takes the sun's half aperture through the sky/sun weight op
    by op, as the port does (`jax_precompute_vjps`)."""
    cts, g_j = jax_precompute_vjps[turbidity, tuple(sun)]
    params = _cpu_params(turbidity=turbidity, albedo=0.3, sun_direction=sun)
    state = TM.precompute(torch_tables, params)
    leaves_t = [x for x in (state.params, *state[1:]) if x is not None]
    flat_t = []
    for x in leaves_t:
        flat_t.extend(x if isinstance(x, tuple) else (x,))
    assert len(flat_t) == len(cts)
    loss = sum((x * torch.tensor(c)).sum() for x, c in zip(flat_t, cts))
    g_t = torch.autograd.grad(loss, [getattr(params, f)
                                     for f in _PARAM_FIELDS])
    for f, g in zip(_PARAM_FIELDS, g_t):
        err = _rel_max(g.numpy(), getattr(g_j, f))
        assert err <= 1e-4, (f, err)


# ---------------------------------------------------------------------------
# K5 and K6: the radiance adjoints, in their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def adjoint_case(jax_tables):
    """(JAX state, the port's leaf state, 400 directions of which 40 at
    the disc edge (tests/test_pallas.py:212-216), uniforms, g_rad)."""
    js = jax.jit(lambda p: JM.precompute(jax_tables, p, "rgb"))(
        ts.make_params(turbidity=4.2, albedo=0.25, sun_direction=SUN))
    st = _leaf_state(convert.sunsky_state(jax.tree.map(np.asarray, js),
                                          device="cpu"))
    rng = np.random.default_rng(3)
    d = rng.normal(size=(400, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sun = np.asarray(js.sun_frame_n, np.float32)
    d[:40] = sun + 0.002 * rng.normal(size=(40, 3))
    d[:40] /= np.linalg.norm(d[:40], axis=-1, keepdims=True)
    u2 = rng.uniform(size=(400, 2)).astype(np.float32)
    g_rad = rng.normal(size=(400, 3)).astype(np.float32)
    return js, st, d, u2, g_rad


def _torch_field_grads(out, st, g_rad, extra=()):
    grads = torch.autograd.grad(
        out, [_get(st, f) for f in _RAD_FIELDS] + list(extra),
        torch.tensor(g_rad), allow_unused=True)
    named = {f: (np.zeros(tuple(_get(st, f).shape), np.float32) if g is None
                 else g.numpy()) for f, g in zip(_RAD_FIELDS, grads)}
    return named, [g.numpy() for g in grads[len(_RAD_FIELDS):]]


def _jax_field_grads(d_state):
    return {f: np.asarray(_get(d_state, f)) for f in _RAD_FIELDS}


def test_eval_adjoint_plain_matches_jax_vjp(adjoint_case):
    """K5's plain version (autograd of `_eval_rgb_plain`) against the jnp
    transpose: state-field cotangents within 1e-4 (the ramp-driven ones
    within 1e-3), dd within 1e-4 of each lane's scale."""
    js, st, d, _u2, g_rad = adjoint_case
    ds_j, dd_j = jax.jit(lambda s, d, g: jax.vjp(JM._eval_rgb_jnp, s, d)[1](
        g))(js, d, g_rad)
    d_t = torch.tensor(d, requires_grad=True)
    named, (dd_t,) = _torch_field_grads(TM._eval_rgb_plain(st, d_t), st,
                                        g_rad, [d_t])
    _check_fields(named, _jax_field_grads(ds_j), 1e-4, 1e-3)
    dd_j = np.asarray(dd_j)
    scale = np.abs(dd_j).max(-1, keepdims=True) + 1e-3
    assert (np.abs(dd_t - dd_j) / scale).max() <= 1e-4
    assert np.abs(named["sun_radiance"]).max() > 0     # disc lanes count


def test_eval_adjoint_plain_matches_pallas_adjoint(adjoint_case):
    """Against the TPU kernel K5 (`sunsky_eval_rgb_bwd_pallas`) in
    interpret mode, whose polynomial trig is loose at the disc edge: the
    bar of tests/test_pallas.py:236, 3e-2."""
    js, st, d, _u2, g_rad = adjoint_case
    ds_p, dd_p = JK.sunsky_eval_rgb_bwd_pallas(js, jnp.asarray(d),
                                               jnp.asarray(g_rad),
                                               interpret=True)
    d_t = torch.tensor(d, requires_grad=True)
    named, (dd_t,) = _torch_field_grads(TM._eval_rgb_plain(st, d_t), st,
                                        g_rad, [d_t])
    _check_fields(named, _jax_field_grads(ds_p), 3e-2, 3e-2)
    assert _rel_max(dd_t, dd_p) <= 3e-2


def test_nee_adjoint_plain_matches_jax_vjp(adjoint_case):
    """K6's plain version (autograd of `_sample_eval_rgb_plain`'s radiance)
    against jax.vjp of `_sample_eval_rgb_jnp_rg`'s radiance output."""
    js, st, _d, u2, g_rad = adjoint_case
    (ds_j,) = jax.jit(lambda s, u, g: jax.vjp(
        lambda q: JM._sample_eval_rgb_jnp_rg(q, u)[1], s)[1](g))(js, u2, g_rad)
    named, _ = _torch_field_grads(
        TM._sample_eval_rgb_plain(st, torch.tensor(u2))[1], st, g_rad)
    # the softness cotangent of a ramp lane is proportional to
    # cos(gamma) - cos_cut, some 45 ulps of f32 near 1: the two packages'
    # samples differ by ulps, and one ulp is ~2% of a lane's share
    _check_fields(named, _jax_field_grads(ds_j), 1e-4, 1e-3,
                  soft_tol=1e-2)
    assert np.abs(named["sun_radiance"]).max() > 0     # sun-cone samples


def test_nee_adjoint_plain_matches_pallas_adjoint(adjoint_case):
    """Against the TPU kernel K6 (`sunsky_nee_rgb_bwd_nopdf_pallas`) in
    interpret mode, at the 3e-2 bar of the adjoint kernels."""
    js, st, _d, u2, g_rad = adjoint_case
    ds_p = JK.sunsky_nee_rgb_bwd_nopdf_pallas(js, jnp.asarray(u2),
                                              jnp.asarray(g_rad),
                                              interpret=True)
    named, _ = _torch_field_grads(
        TM._sample_eval_rgb_plain(st, torch.tensor(u2))[1], st, g_rad)
    _check_fields(named, _jax_field_grads(ds_p), 3e-2, 3e-2)


def test_disc_edge_gradient_matches_fd(torch_tables):
    """The port's copy of tests/test_ad.py:222-279: the autograd derivative
    of a disc-straddling pixel's mean radiance w.r.t. the sun elevation
    matches central finite differences within 12% (the surrogate ramp
    overestimates the boundary term by ~8%), and it is disc-dominated."""
    ap = 0.5 * np.radians(0.5358)
    el0 = np.radians(30.0)
    n = 4096
    els = np.linspace(el0 - 3.5 * ap, el0 + 3.5 * ap, n)
    d = torch.tensor(np.stack([np.cos(els), np.zeros(n), np.sin(els)], -1),
                     dtype=torch.float32)

    def mean_rad(elev, sun_scale=1.0):
        sd = torch.stack([torch.cos(elev), torch.zeros_like(elev),
                          torch.sin(elev)])
        p = TM.make_params(turbidity=3.0, albedo=0.3, sun_direction=sd,
                           sun_scale=sun_scale, device="cpu")
        return TM._eval_rgb_plain(TM.precompute(torch_tables, p), d).mean()

    elev = torch.tensor(el0, dtype=torch.float32, requires_grad=True)
    (g_ad,) = torch.autograd.grad(mean_rad(elev), elev)
    h = 2e-4
    with torch.no_grad():
        g_fd = (float(mean_rad(elev + h)) - float(mean_rad(elev - h))) / (2 * h)
    g_ad = float(g_ad)
    assert abs(g_ad - g_fd) <= 0.12 * abs(g_fd) + 1e-3, (g_ad, g_fd)
    (g_sky,) = torch.autograd.grad(mean_rad(elev, sun_scale=0.0), elev)
    assert abs(g_ad) > 10 * abs(float(g_sky)), (g_ad, float(g_sky))


# ---------------------------------------------------------------------------
# the render's gradient (bench.py::bench_grad's loss at 32x32x4)
# ---------------------------------------------------------------------------

H = W = 32
SPP = 4
KEY = jax.random.PRNGKey(7)
SEED = int(np.asarray(jax.random.key_data(KEY))[-1])    # == 7


def _three_shapes():
    """The three-shape scene of tests/test_torch_render.py."""
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    sphere = np.eye(4, dtype=np.float32)
    sphere[2, 3] = 1.0
    disk = np.eye(4, dtype=np.float32)
    disk[0, 3] = 2.5
    disk[2, 3] = 0.05
    return [dict(kind=1, to_world=ground, bsdf_idx=0),
            dict(kind=0, to_world=sphere, bsdf_idx=1),
            dict(kind=2, to_world=disk, bsdf_idx=1)]


ALBEDOS = [[0.4, 0.4, 0.4], [0.6, 0.2, 0.2]]


def test_render_gradient_matches_jax(jax_tables, torch_tables):
    """d mean(img^2) / d (turbidity, albedo, sun_direction, the sphere's
    material albedo) through render_rows: within 1e-3 of jax.grad for the
    turbidity and the albedos, 3e-2 for the sun (its cotangent sums
    disc-ramp lanes of the NEE samples, see _check_fields)."""
    sc_j = jax_make_scene(shapes=_three_shapes(), bsdf_albedos=ALBEDOS)
    sensor_j = JS.make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45)
    kinds = table_kinds(sc_j.bsdfs)
    film_j = JF.Film(H, W, 3)

    @jax.jit
    def grad_j(t, alb, sd, mat):
        def loss(t, alb, sd, mat):
            p = ts.make_params(turbidity=t, albedo=alb, sun_direction=sd)
            env = JM.precompute(jax_tables, p, "rgb")
            sc = sc_j._replace(env=env, bsdfs=sc_j.bsdfs._replace(
                albedo=sc_j.bsdfs.albedo.at[1].set(mat)))
            img = JF.develop(JI.render_rows(sc, sensor_j, film_j, KEY, SPP, 2,
                                            1000, "rgb", 0, H, kinds=kinds))
            return jnp.mean(img ** 2)
        return jax.grad(loss, argnums=(0, 1, 2, 3))(t, alb, sd, mat)

    sd0 = np.asarray(SUN, np.float32)
    g_j = [np.asarray(g) for g in grad_j(
        jnp.float32(3.0), jnp.full((3,), 0.3, jnp.float32), jnp.asarray(sd0),
        jnp.asarray(ALBEDOS[1], jnp.float32))]

    sc_t = TSC.make_scene(shapes=_three_shapes(), bsdf_albedos=ALBEDOS,
                          device="cpu")
    sensor_t = convert.perspective(jax.tree.map(np.asarray, sensor_j),
                                   device="cpu")
    t = torch.tensor(3.0, requires_grad=True)
    alb = torch.full((3,), 0.3, requires_grad=True)
    sd = torch.tensor(sd0, requires_grad=True)
    mat = torch.tensor(ALBEDOS[1], requires_grad=True)
    p = TM.make_params(turbidity=t, albedo=alb, sun_direction=sd,
                       device="cpu")
    albedo = torch.cat([sc_t.bsdfs.albedo[:1], mat[None]])
    sc = sc_t._replace(env=TM.precompute(torch_tables, p),
                       bsdfs=sc_t.bsdfs._replace(albedo=albedo))
    img = TF.develop(TI.render_rows(sc, sensor_t, TF.Film(H, W, 3), SEED,
                                    SPP, 2, 1000, "rgb", 0, H))
    g_t = [g.numpy() for g in torch.autograd.grad((img ** 2).mean(),
                                                  [t, alb, sd, mat])]
    for name, a, b, tol in zip(("turbidity", "albedo", "sun", "material"),
                               g_t, g_j, (1e-3, 1e-3, 3e-2, 1e-3)):
        assert _rel_max(a, b) <= tol, (name, _rel_max(a, b))
    assert np.abs(g_j[2]).max() > 0 and np.abs(g_j[0]) > 0


def test_cpu_render_impl_gradient_is_the_wavefront(torch_tables):
    """On the CPU `render()` is the wavefront path under autograd: the same
    gradient as `render_rows`, up to the order of autograd's scatter-adds
    on the CPU (repeated runs of one call differ by ~1e-5)."""
    sc_t = TSC.make_scene(shapes=_three_shapes(), bsdf_albedos=ALBEDOS,
                          device="cpu")
    sensor = TS.make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45,
                                 device="cpu")
    film = TF.Film(16, 16, 3)

    def grad_of(render):
        t = torch.tensor(3.5, requires_grad=True)
        p = TM.make_params(turbidity=t, sun_direction=SUN, device="cpu")
        sc = sc_t._replace(env=TM.precompute(torch_tables, p))
        return torch.autograd.grad((render(sc) ** 2).mean(), t)[0]
    g_render = grad_of(lambda sc: TI.render(sc, sensor, film, SEED, spp=2))
    g_rows = grad_of(lambda sc: TF.develop(TI.render_rows(
        sc, sensor, film, SEED, 2, 2, 1000, "rgb", 0, 16)))
    assert abs(float(g_render - g_rows)) <= 1e-4 * abs(float(g_rows))
    assert float(g_rows) != 0.0


def test_megakernel_flatten_roundtrip():
    """`_Megakernel` passes the scene and sensor to autograd as flat
    tensors; they come back as the same objects."""
    state = TM.precompute(TT.load_tables("rgb", device="cpu"),
                          TM.make_params(device="cpu"))
    sc = TSC.make_scene(shapes=_three_shapes(), bsdf_albedos=ALBEDOS,
                        env=state, device="cpu")
    sensor = TS.make_perspective([4, -4, 2.0], [0, 0, 1.0], device="cpu")
    leaves = []
    struct = (TI._flatten(sc, leaves), TI._flatten(sensor, leaves))
    assert all(isinstance(t, torch.Tensor) for t in leaves)
    sc2, sensor2 = TI._unflatten(struct, leaves)
    assert sc2.shapes.kind == sc.shapes.kind
    assert sc2.env.sun_ld is None and sc2.env.params is not None
    flat2 = []
    TI._flatten(sc2, flat2)
    TI._flatten(sensor2, flat2)
    assert len(flat2) == len(leaves)
    assert all(a is b for a, b in zip(leaves, flat2))


# ---------------------------------------------------------------------------
# entry points run on the card unless asked for the CPU
# ---------------------------------------------------------------------------

_ENTRY_POINTS = [TM.make_params, TT.load_tables, TSC.make_scene,
                 TS.make_perspective, TSH.make_shape_table,
                 TB.make_material_table, TB.make_diffuse_table,
                 convert.sunsky_params, convert.discrete_distribution,
                 convert.sunsky_state, convert.shape_table,
                 convert.material_table, convert.scene, convert.perspective,
                 convert.adam_state, convert.sgd_state]


@pytest.mark.parametrize("fn", _ENTRY_POINTS, ids=lambda f: f.__qualname__)
def test_entry_point_device_defaults_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_entry_points_without_a_device_need_the_card():
    """Without a card, an entry point called without `device` raises (no
    fallback to the CPU); with one, it lands on the card."""
    if torch.cuda.is_available():
        assert tt.make_params().turbidity.device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        tt.make_params()
    with pytest.raises((RuntimeError, AssertionError)):
        TT.load_tables("rgb")
    with pytest.raises((RuntimeError, AssertionError)):
        TS.make_perspective([4, -4, 2.0], [0, 0, 1.0])
