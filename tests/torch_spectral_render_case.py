"""Shared by the port's lane-by-lane tests of `bench.py`'s spectral
scenes (`test_torch_spectral_render_bench.py`, bench_spectral's rough
conductor at depth 4, and `test_torch_spectral_render_grad_scene.py`,
bench_spectral_grad's diffuse ground at depth 2): the scenes, the JAX
lanes, and the three tests each of those files runs on its scene's
`renders` fixture (`build_renders`).

The `independent` sampler is a counter hash, so both sides draw bitwise
the same uniforms, hero wavelengths included, and a render compares lane
by lane (as in tests/test_torch_render.py). The JAX side runs its jnp
wavefront path; the port runs its plain PyTorch path, which is what it
runs for CPU tensors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky.tables import load_tables as jax_load_tables
from tpusky.ops import spectrum as JSP
from tpusky.render import bsdf as JB
from tpusky.render import film as JF
from tpusky.render import integrator as JI
from tpusky.render import sensors as JS
from tpusky.render.scene import make_scene as jax_make_scene

from tpusky_torch import convert
from tpusky_torch.ops.cuda import build
from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI

H = W = 16
SPP = 2
KEY = jax.random.PRNGKey(11)
SEED = int(np.asarray(jax.random.key_data(KEY))[-1])    # == 11
SUN = [0.3, 0.2, 0.93]


@functools.lru_cache(maxsize=None)
def _spectral_state():
    """The spectral sunsky both scenes share (compiled once a module)."""
    return jax.jit(lambda p: JM.precompute(jax_load_tables("spectral"), p,
                                           "spectral"))(
        ts.make_params(turbidity=3.0, albedo=0.3, sun_direction=SUN,
                       mode="spectral"))


@functools.lru_cache(maxsize=None)
def _rgb_state():
    """An RGB sunsky state, for the mismatched-state refusals."""
    return convert.sunsky_state(jax.tree.map(np.asarray, jax.jit(
        lambda p: JM.precompute(jax_load_tables("rgb"), p, "rgb"))(
            ts.make_params(sun_direction=SUN))), device="cpu")


def _spectral_scene(kind):
    """bench.py::bench_spectral's scene (kind 1: a rough-conductor ground,
    alpha 0.2) or bench_spectral_grad's (kind 0: a diffuse ground), under
    the spectral sunsky; camera at [4,-4,2] looking at [0,0,0.5]."""
    state = _spectral_state()
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    kw = dict(bsdf_kinds=[1], bsdf_alphas=[0.2]) if kind == 1 else {}
    sc = jax_make_scene(shapes=[dict(kind=1, to_world=ground, bsdf_idx=0)],
                        bsdf_albedos=[[0.5, 0.5, 0.5]], env=state, **kw)
    sensor = JS.make_perspective([4, -4, 2.0], [0, 0, 0.5], fov_x_deg=45)
    return sc, sensor


def _jax_lanes(sc, sensor, key, depth):
    """Per-lane sRGB radiance of JAX's spectral render_rows before the
    splat: the body of `integrator._render_rows_chunk`
    (integrator.py:804-826, 862-881)."""
    n = H * W * SPP
    lane = jnp.arange(n, dtype=jnp.uint32)
    pixel = lane // SPP
    smp = JI._SamplerCtx("independent", key, pixel, lane % SPP, SPP)
    u = smp.next(10_000, 2)
    uv = jnp.stack([((pixel % W).astype(jnp.float32) + u[:, 0]) / W,
                    ((pixel // W).astype(jnp.float32) + u[:, 1]) / H], -1)
    o, d = JS.sample_ray(sensor, uv)
    u_wl = smp.next(20_000, 1)[..., 0]
    wl, wl_w = JSP.sample_rgb_spectrum(JSP.sample_shifted(u_wl, 4))
    r = JI._path_sample(sc, o, d, smp, depth, 1000, "spectral", wl,
                        kinds=JB.table_kinds(sc.bsdfs))
    r = JSP.spectrum_to_srgb(r * wl_w, wl)
    return jnp.where(jnp.isfinite(r), r, 0.0)


_CASES = {"bench_spectral": (1, 4), "bench_spectral_grad": (0, 2)}


def build_renders(case):
    """(case, depth, JAX lanes and image, port lanes and image, port scene
    and sensor): what a scene's module fixture `renders` returns."""
    kind, depth = _CASES[case]
    sc, sensor = _spectral_scene(kind)
    film = JF.Film(H, W, 3)

    @jax.jit
    def run(sc, sensor, key):
        # render_rows' own splat of these lanes (one spp chunk): one trace
        # of the depth-4 path instead of two keeps the file's compile short
        lanes = _jax_lanes(sc, sensor, key, depth)
        return lanes, JF.develop(JF.splat_ordered(film, lanes, SPP))
    lanes_j, img_j = (np.asarray(x) for x in run(sc, sensor, KEY))
    sc_t = convert.scene(jax.tree.map(np.asarray, sc), device="cpu")
    sensor_t = convert.perspective(jax.tree.map(np.asarray, sensor),
                                   device="cpu")
    tfilm = TF.Film(H, W, 3)
    lanes = TI._lane_radiance(sc_t, sensor_t, tfilm, SEED, SPP, 0, SPP,
                              depth, 1000, "spectral", 0, H,
                              kinds=TB.table_kinds(sc_t.bsdfs)).numpy()
    img = TI.render(sc_t, sensor_t, tfilm, SEED, spp=SPP, max_depth=depth,
                    mode="spectral").numpy()
    return (case, depth, (lanes_j, img_j), (lanes, img), (sc_t, sensor_t))


def _lane_rel(a, b):
    return (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max(-1)


def test_spectral_render_matches_jax(renders):
    """Same seed, same estimator, same hero wavelengths: per lane before
    the splat >= 99.9% of lanes within 1e-3 relative (floor 1e-3), and
    per developed image within 1e-3 of its scale (the bars of
    tests/test_torch_render.py:211-221); the image is the box splat of
    JAX's lanes, which is what its render_rows develops."""
    _, _, (lanes_j, img_j), (lanes, img), _ = renders
    assert lanes.shape == lanes_j.shape == (H * W * SPP, 3)
    assert (_lane_rel(lanes, lanes_j) > 1e-3).mean() <= 1e-3
    assert np.abs(img - img_j).max() < 1e-3 * max(img_j.max(), 1.0)
    assert img_j.max() > 0.05 and (img_j > 0).mean() > 0.5


def test_spectral_render_on_cpu_is_plain(renders):
    """On the CPU `render(mode="spectral")` takes the wavefront path with
    the plain versions: it equals `render_rows(plain=True)` and launches
    nothing."""
    _, depth, _, (_, img), (sc, sensor) = renders
    film = TF.Film(H, W, 3)
    build.reset_launches()
    kinds = TB.table_kinds(sc.bsdfs)
    assert not TI._megakernel_ok(sc, sensor, film, SPP, depth, "spectral",
                                 "independent", kinds)
    plain = TF.develop(TI.render_rows(sc, sensor, film, SEED, SPP, depth,
                                      1000, "spectral", 0, H, kinds=kinds,
                                      plain=True))
    np.testing.assert_array_equal(plain.numpy(), img)
    assert all(v == 0 for v in build.launches.values())


def test_spectral_render_refuses_a_mismatched_state(renders):
    """A spectral render needs a spectral sunsky state, and an RGB render
    an RGB one."""
    _, _, _, _, (sc, sensor) = renders
    film = TF.Film(4, 4, 3)
    with pytest.raises(ValueError, match="precomputed in rgb"):
        TI.render(sc, sensor, film, SEED, spp=1, mode="rgb")
    rgb = _rgb_state()
    with pytest.raises(ValueError, match="precomputed in spectral"):
        TI.render(sc._replace(env=rgb), sensor, film, SEED, spp=1,
                  mode="spectral")
