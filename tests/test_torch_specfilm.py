"""The port's specfilm, spectral emitters, sensors, samplers and filters
in a render, lane by lane against the JAX package at 16x16x2 on the CPU.

The JAX side is the package's own `_render_rows_chunk` with its splat
taken out (`jax_chunk_lanes`), so the lens sample and the rgb2spec
emitters are the reference's code, and for the two specfilms the body of
that function over one trace of the path (`_jax_specfilm_lanes`); the
port runs `_lane_radiance`, its plain path on the CPU. The bars are those of
tests/test_torch_render.py: >= 99.9% of lanes within 1e-3 relative
(floor 1e-3).

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky.tables import load_tables as jax_load_tables
from tpusky.ops import spectrum as JSP
from tpusky.render import emitters as JE
from tpusky.render import film as JF
from tpusky.render import integrator as JI
from tpusky.render import sensors as JS
from tpusky.render import spectra as JSR
from tpusky.render.bsdf import table_kinds
from tpusky.render.scene import make_scene

from tpusky_torch import convert
from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

H = W = 16
SPP = 2
KEY = jax.random.PRNGKey(7)
WORDS = np.asarray(jax.random.key_data(KEY))
GROUND = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
# four smooth regular sensor responses over 400-700 nm
SRFS = tuple((400.0, 700.0, tuple(float(v) for v in np.exp(
    -0.5 * ((np.linspace(400.0, 700.0, 31) - c) / 40.0) ** 2)))
    for c in (450.0, 520.0, 590.0, 650.0))
BANDS = (400.0, 480.0, 560.0, 630.0, 700.0)


@contextlib.contextmanager
def _splat_taken_out():
    """The JAX film's splats return what they were given: the lanes'
    radiance (box), or their film positions beside it (other filters)."""
    saved = JF.splat_ordered, JF.splat
    JF.splat_ordered = lambda film, radiance, spp: radiance
    JF.splat = lambda film, uv, radiance: jnp.concatenate([uv, radiance],
                                                         -1)
    try:
        yield
    finally:
        JF.splat_ordered, JF.splat = saved


def jax_chunk_lanes(scenes, films, depth, mode,
                    sampler_kind="independent"):
    """Per-lane output of JAX's `_render_rows_chunk` (H rows, all spp)
    for each (scene, sensor) and film, one jitted program -> numpy."""
    kinds = [table_kinds(sc.bsdfs) for sc, _ in scenes]

    @jax.jit
    def run(scenes, key):
        return [JI._render_rows_chunk(
            sc, se, film, key, SPP, 0, SPP, depth, 1000, mode, 0, H,
            sampler_kind=sampler_kind, kinds=k)
            for (sc, se), film, k in zip(scenes, films, kinds)]
    with _splat_taken_out():
        return [np.asarray(x) for x in run(scenes, KEY)]


def port_lanes(sc, sensor, film, depth, mode, sampler_kind="independent",
               film_uv=False):
    """The port's per-lane output for the JAX scene and sensor carried
    over by `convert`; with `film_uv`, the lanes' film positions too."""
    sc_t = convert.scene(jax.tree.map(np.asarray, sc), device="cpu")
    se_t = convert.sensor(jax.tree.map(np.asarray, sensor), device="cpu")
    out = TI._lane_radiance(
        sc_t, se_t, film, WORDS, SPP, 0, SPP, depth, 1000, mode, 0, H,
        sampler_kind, TB.table_kinds(sc_t.bsdfs), film_uv=film_uv)
    return sc_t, se_t, (tuple(x.numpy() for x in out) if film_uv
                        else out.numpy())


def share_outside(a, b, bar=1e-3):
    rel = (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max(-1)
    return float((rel > bar).mean())


def _panel_scene(env, **kw):
    """A diffuse ground and sphere, and a rectangle area panel facing
    down (radiance (6, 5, 4)), under `env`."""
    sph = np.diag([0.7, 0.7, 0.7, 1.0]).astype(np.float32)
    sph[2, 3] = 0.9
    pan = np.diag([0.6, 0.6, 1.0, 1.0]).astype(np.float32)
    pan[:3, :3] = pan[:3, :3] @ np.diag([1.0, -1.0, -1.0])
    pan[:3, 3] = [0.0, -1.0, 2.8]
    rad = np.zeros((3, 3), np.float32)
    rad[2] = [6.0, 5.0, 4.0]
    return make_scene(
        shapes=[dict(kind=1, to_world=GROUND, bsdf_idx=0),
                dict(kind=0, to_world=sph, bsdf_idx=1),
                dict(kind=1, to_world=pan, bsdf_idx=0, emitter_idx=0)],
        bsdf_albedos=[[0.5, 0.4, 0.3], [0.7, 0.7, 0.7]], area_radiance=rad,
        env=env, **kw)


def _camera():
    return JS.make_perspective([4.0, -4.0, 2.2], [0.0, 0.0, 0.8],
                               fov_x_deg=50)


def _jax_specfilm_lanes(sc, sensor):
    """Per-lane channels of JAX's SRF and band specfilms: the body of its
    `_render_rows_chunk` (integrator.py:804-861) for both branches over
    one trace of `_path_sample` (the lanes twice, the first copy at the
    SRF film's wavelengths, the second at the band film's; the sampler
    is keyed on the lane, so both copies draw the same uniforms)."""
    kinds = table_kinds(sc.bsdfs)
    lo, hi = BANDS[0], BANDS[-1]

    @jax.jit
    def run(sc, sensor, key):
        n = H * W * SPP
        lane = jnp.arange(n, dtype=jnp.uint32)
        pixel, sample = lane // SPP, lane % SPP
        smp = JI._SamplerCtx("independent", key, pixel, sample, SPP)
        u = smp.next(10_000, 2)
        uv = jnp.stack([((pixel % W).astype(jnp.float32) + u[:, 0]) / W,
                        ((pixel // W).astype(jnp.float32) + u[:, 1]) / H],
                       -1)
        o, d = JS.sample_ray(sensor, uv, smp.next(10_001, 2))
        u_wl = smp.next(20_000, 1)[..., 0]
        wl_s, pdf_s = JSR.srf_sample_wavelengths(SRFS, u_wl, 4)
        wl_b = lo + (hi - lo) * JSP.sample_shifted(u_wl, 4)
        both = JI._SamplerCtx("independent", key, jnp.tile(pixel, 2),
                              jnp.tile(sample, 2), SPP)
        spec = JI._path_sample(sc, jnp.tile(o, (2, 1)), jnp.tile(d, (2, 1)),
                               both, 2, 1000, "spectral",
                               jnp.concatenate([wl_s, wl_b]), kinds=kinds)
        edges = jnp.asarray(BANDS)
        out = (JSR.srf_accumulate(SRFS, wl_s,
                                  spec[:n] / jnp.maximum(pdf_s, 1e-12)),
               JF.spectral_band_accumulate(wl_b, spec[n:] * (hi - lo), edges)
               / (edges[1:] - edges[:-1]))
        return [jnp.where(jnp.isfinite(r), r, 0.0) for r in out]
    return [np.asarray(x) for x in run(sc, sensor, KEY)]


def test_specfilms_under_the_sunsky_with_rgb2spec_emitters():
    """An SRF specfilm (four smooth responses) and a band specfilm (four
    bands) under the spectral sunsky, with the area panel, a point and a
    spot light, each upsampled by rgb2spec; depth 2."""
    state = jax.jit(lambda p: JM.precompute(
        jax_load_tables("spectral"), p, "spectral"))(ts.make_params(
            turbidity=3.0, albedo=0.3, sun_direction=[0.3, 0.2, 0.93],
            mode="spectral"))
    sc = _panel_scene(state, point_lights=[[1.5, -1.5, 2.5, 8.0, 6.0, 4.0]],
                      spot_lights=[JE.make_spot(
                          [-2.0, -2.0, 3.5], [0.45, 0.45, -0.77],
                          [40.0, 36.0, 32.0], cutoff_angle_deg=25.0)])
    cam = _camera()
    films = (TF.Film(H, W, 4, srfs=SRFS), TF.Film(H, W, 4, bands=BANDS))
    for film, ref in zip(films, _jax_specfilm_lanes(sc, cam)):
        lanes = port_lanes(sc, cam, film, 2, "spectral")[2]
        assert lanes.shape == ref.shape == (H * W * SPP, 4)
        assert share_outside(lanes, ref) <= 1e-3
        assert (ref > 0).mean() > 0.5


def test_spectral_constant_env_and_envmap_and_emitter_gradient():
    """A spectral ConstantEnv (rgb2spec of its colour, fitted on the
    device) and a spectral envmap (each texel's host fit, nearest-texel
    lookup) over the area-lit scene; depth 2, sRGB film. Under the
    ConstantEnv, d mean(img^2) / d area_radiance (every shape's RGB row,
    through the emitters' fit and its one differentiable Newton step)
    within 1e-3 of jax.grad of render_rows (one spp chunk: its
    `_render_rows_chunk` and box splat), the bar of
    tests/test_torch_spectral_render_grad.py for the turbidity."""
    rng = np.random.default_rng(6)
    bitmap = (2.0 * rng.random((8, 16, 3))).astype(np.float32)
    cam = _camera()
    scenes = [_panel_scene(JE.ConstantEnv(jnp.asarray([0.6, 0.7, 0.9]))),
              _panel_scene(JE.make_envmap(bitmap, spectral=True))]
    kinds = table_kinds(scenes[0].bsdfs)
    film = JF.Film(H, W, 3)
    splat_ordered = JF.splat_ordered

    @jax.jit
    def run(scenes, key):
        def chunk(sc):
            return JI._render_rows_chunk(sc, cam, film, key, SPP, 0, SPP, 2,
                                         1000, "spectral", 0, H, kinds=kinds)

        def loss(rad):
            lanes = chunk(scenes[0]._replace(area_radiance=rad))
            img = JF.develop(splat_ordered(film, lanes, SPP))
            return jnp.mean(img ** 2), lanes
        grad, lanes_c = jax.grad(loss, has_aux=True)(
            scenes[0].area_radiance)
        return lanes_c, chunk(scenes[1]), grad
    with _splat_taken_out():
        *refs, g_j = (np.asarray(x) for x in run(scenes, KEY))
    for sc, ref in zip(scenes, refs):
        sc_t, se_t, lanes = port_lanes(sc, cam, TF.Film(H, W, 3), 2,
                                       "spectral")
        assert share_outside(lanes, ref) <= 1e-3
        assert ref.mean() > 0.05
    np.testing.assert_allclose(sc_t.env.coeff.numpy(),
                               np.asarray(scenes[1].env.coeff), atol=1e-6)

    sc_t = convert.scene(jax.tree.map(np.asarray, scenes[0]), device="cpu")
    rad = sc_t.area_radiance.clone().requires_grad_()
    img = TF.develop(TI.render_rows(
        sc_t._replace(area_radiance=rad), se_t, TF.Film(H, W, 3), WORDS,
        SPP, 2, 1000, "spectral", 0, H, kinds=TB.table_kinds(sc_t.bsdfs)))
    (g_t,) = torch.autograd.grad((img ** 2).mean(), [rad])
    assert np.abs(g_j[2]).min() > 0
    err = np.abs(g_t.numpy() - g_j).max() / np.abs(g_j).max()
    assert err <= 1e-3, err


def test_thin_lens_mitchell_multijitter():
    """A thin lens (aperture 0.15, focused at the sphere) with the
    mitchell filter and the multijitter sampler at spp 4 in RGB under a
    ConstantEnv: the film positions within 1e-6 of the reference's, the
    lanes as the reference's, and the splatted accumulation within 1e-3 of
    the largest value of the reference's splat of the reference's lanes
    (1e-3 because a lane may differ from the reference's by 1e-3, the
    lanes' own bar)."""
    global SPP
    spp, SPP = SPP, 4
    try:
        sc = _panel_scene(JE.ConstantEnv(jnp.asarray([0.6, 0.7, 0.9])))
        cam = _camera()
        lens = JS.ThinLens(cam.to_world, cam.fov_x_deg, cam.aspect,
                           jnp.float32(0.15), jnp.float32(5.6))
        jfilm = JF.Film(H, W, 3, "mitchell")
        (ref,) = jax_chunk_lanes([(sc, lens)], [jfilm], 3, "rgb",
                                 "multijitter")
        film = TF.Film(H, W, 3, "mitchell")
        sc_t, se_t, (lanes, uv) = port_lanes(sc, lens, film, 3, "rgb",
                                             "multijitter", film_uv=True)
        np.testing.assert_allclose(uv, ref[:, :2], rtol=0, atol=1e-6)
        assert share_outside(lanes, ref[:, 2:]) <= 1e-3
        accum = TI.render_rows(sc_t, se_t, film, WORDS, SPP, 3, 1000, "rgb",
                               0, H, sampler_kind="multijitter").numpy()
    finally:
        SPP = spp
    want = np.asarray(JF.splat(jfilm, jnp.asarray(ref[:, :2]),
                               jnp.asarray(ref[:, 2:])))
    assert accum.shape == want.shape == (H, W, 4)
    assert np.abs(accum - want).max() <= 1e-3 * np.abs(want).max()
