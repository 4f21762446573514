"""The port's render slice (`tpusky_torch.render`) against the JAX package.

The `independent` sampler is a pure counter hash, so the JAX path and the
port draw bitwise the same uniforms from the same integer seed, and a
render can be compared lane by lane, not only by a statistical test. The
JAX side runs its jnp wavefront path, and its megakernel in interpret
mode (as tests/test_megakernel.py does); the port runs its plain PyTorch
path, which is what it runs for CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky.tables import load_tables as jax_load_tables
from tpusky.ops.pallas.megakernel import direct_rgb_megakernel
from tpusky.render import film as JF
from tpusky.render import integrator as JI
from tpusky.render import sampler as JSM
from tpusky.render import sensors as JS
from tpusky.render import shapes as JSH
from tpusky.render.bsdf import table_kinds
from tpusky.render.scene import make_scene as jax_make_scene

from tpusky_torch import convert
from tpusky_torch.ops.cuda import build
from tpusky_torch.ops.cuda import megakernel as TMK
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.render import sampler as TSM
from tpusky_torch.render import sensors as TS
from tpusky_torch.render import shapes as TSH

H = W = 32
SPP = 4
KEY = jax.random.PRNGKey(7)
SEED = int(np.asarray(jax.random.key_data(KEY))[-1])    # == 7


def _jax_scene():
    """The three-shape scene of tests/test_megakernel.py:33-50."""
    state = jax.jit(lambda p: JM.precompute(jax_load_tables("rgb"), p,
                                            "rgb"))(
        ts.make_params(turbidity=3.0, albedo=0.3, sun_direction=[0.3, 0.2,
                                                                  0.93]))
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    sphere = np.eye(4, dtype=np.float32)
    sphere[2, 3] = 1.0
    disk = np.eye(4, dtype=np.float32)
    disk[0, 3] = 2.5
    disk[2, 3] = 0.05
    sc = jax_make_scene(
        shapes=[dict(kind=1, to_world=ground, bsdf_idx=0),
                dict(kind=0, to_world=sphere, bsdf_idx=1),
                dict(kind=2, to_world=disk, bsdf_idx=1)],
        bsdf_albedos=[[0.4, 0.4, 0.4], [0.6, 0.2, 0.2]], env=state)
    sensor = JS.make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45)
    return sc, sensor


@pytest.fixture(scope="module")
def scenes():
    sc, sensor = _jax_scene()
    return ((sc, sensor),
            (convert.scene(jax.tree.map(np.asarray, sc), device="cpu"),
             convert.perspective(jax.tree.map(np.asarray, sensor),
                                 device="cpu")))


def _jax_lanes(sc, sensor, key):
    """Per-lane radiance of JAX's render_rows before the splat: the body
    of `integrator._render_rows_chunk` (integrator.py:804-826, 878-881)."""
    n = H * W * SPP
    lane = jnp.arange(n, dtype=jnp.uint32)
    pixel = lane // SPP
    smp = JI._SamplerCtx("independent", key, pixel, lane % SPP, SPP)
    u = smp.next(10_000, 2)
    uv = jnp.stack([((pixel % W).astype(jnp.float32) + u[:, 0]) / W,
                    ((pixel // W).astype(jnp.float32) + u[:, 1]) / H], -1)
    o, d = JS.sample_ray(sensor, uv)
    r = JI._path_sample(sc, o, d, smp, 2, 1000, "rgb", None,
                        kinds=table_kinds(sc.bsdfs))
    return jnp.where(jnp.isfinite(r), r, 0.0)


@pytest.fixture(scope="module")
def jax_wavefront(scenes):
    """(per-lane radiance, developed image) of JAX's wavefront path."""
    sc, sensor = scenes[0]
    film = JF.Film(H, W, 3)

    @jax.jit
    def run(sc, sensor, key):
        img = JF.develop(JI.render_rows(sc, sensor, film, key, SPP, 2, 1000,
                                        "rgb", 0, H,
                                        kinds=table_kinds(sc.bsdfs)))
        return _jax_lanes(sc, sensor, key), img
    return tuple(np.asarray(x) for x in run(sc, sensor, KEY))


@pytest.fixture(scope="module")
def jax_megakernel(scenes):
    """(per-lane radiance, developed image) of JAX's `_render_impl` with
    the megakernel in interpret mode. The raw `_render_impl` is traced
    under a jit of its own so that no other test sees this trace."""
    sc, sensor = scenes[0]
    film = JF.Film(H, W, 3)
    kinds = table_kinds(sc.bsdfs)

    @jax.jit
    def run(sc, sensor, key):
        img = JF.develop(JI._render_impl.__wrapped__(
            sc, sensor, film, key, SPP, 2, 1000, "rgb", kinds=kinds))
        return direct_rgb_megakernel(sc, sensor, sc.env, key, SPP, W, H,
                                     interpret=True), img
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUSKY_MEGAKERNEL_INTERPRET", "1")
        mp.delenv("TPUSKY_DISABLE_PALLAS", raising=False)
        assert JI._megakernel_ok(sc, sensor, film, SPP, 2, "rgb",
                                 "independent", kinds)
        return tuple(np.asarray(x) for x in run(sc, sensor, KEY))


@pytest.fixture(scope="module")
def port_render(scenes):
    sc, sensor = scenes[1]
    film = TF.Film(H, W, 3)
    lanes = TI._lane_radiance(sc, sensor, film, SEED, SPP, 0, SPP, 2, 1000,
                              "rgb", 0, H).numpy()
    img = TF.develop(TI.render_rows(sc, sensor, film, SEED, SPP, 2, 1000,
                                    "rgb", 0, H)).numpy()
    return lanes, img


def _lane_rel(a, b):
    return (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max(-1)


@pytest.mark.parametrize("dim", [0, 1, 2, 3, 10_000, 100_001])
def test_lane_samples_bitwise(dim):
    rng = np.random.default_rng(dim)
    pixel = rng.integers(0, 2 ** 31, 4096, dtype=np.int64)
    pixel[:16] = np.arange(16)
    sample = rng.integers(0, 64, 4096, dtype=np.int64)
    for key in (KEY, jax.random.PRNGKey(123456789)):
        seed = int(np.asarray(jax.random.key_data(key))[-1])
        ref = np.asarray(jax.jit(
            lambda k, p, s: JSM.lane_samples("independent", k, p, s, 64, dim,
                                             3))(
            key, pixel.astype(np.uint32), sample.astype(np.uint32)))
        out = TSM.lane_samples("independent", seed, torch.tensor(pixel),
                               torch.tensor(sample), 64, dim, 3)
        assert out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(), ref)


def test_lane_samples_refuses_other_kinds():
    with pytest.raises(NotImplementedError):
        TSM.lane_samples("stratified", 0, torch.zeros(4, dtype=torch.long),
                         torch.zeros(4, dtype=torch.long), 4, 0, 2)


def test_sample_ray_matches_jax(scenes):
    sensor_j, sensor_t = scenes[0][1], scenes[1][1]
    uv = np.random.default_rng(3).random((4096, 2), dtype=np.float32)
    o_j, d_j = (np.asarray(x) for x in jax.jit(JS.sample_ray)(sensor_j, uv))
    o_t, d_t = TS.sample_ray(sensor_t, torch.tensor(uv))
    assert np.abs(o_t.numpy() - o_j).max() <= 1e-6
    assert np.abs(d_t.numpy() - d_j).max() <= 1e-6


@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (1, 0, 2)])
def test_ray_intersect_and_test_match_jax(kinds):
    rng = np.random.default_rng(sum(kinds) + len(kinds))
    shapes = []
    for i, k in enumerate(kinds):
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] *= rng.uniform(0.5, 2.0, 3) if k else rng.uniform(0.5, 2)
        m[:3, 3] = rng.uniform(-1, 1, 3)
        shapes.append(dict(kind=k, to_world=m, bsdf_idx=i))
    table_j = JSH.make_shape_table(shapes)
    table_t = convert.shape_table(jax.tree.map(np.asarray, table_j),
                                  device="cpu")
    o = rng.uniform(-4, 4, (4096, 3)).astype(np.float32)
    d = (rng.uniform(-1.5, 1.5, (4096, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    maxt = rng.uniform(0.5, 8.0, 4096).astype(np.float32)

    t_j, p_j, n_j, _uv, idx_j, hit_j = (np.asarray(x) for x in jax.jit(
        JSH.ray_intersect)(table_j, o, d))
    t_t, p_t, n_t, idx_t, hit_t = (x.numpy() for x in TSH.ray_intersect(
        table_t, torch.tensor(o), torch.tensor(d)))
    np.testing.assert_array_equal(hit_t, hit_j)
    np.testing.assert_array_equal(idx_t, idx_j)
    assert hit_t.mean() > 0.1
    # near-grazing sphere hits amplify f32 round-off (dt ~ 1/sqrt(disc))
    np.testing.assert_allclose(t_t[hit_t], t_j[hit_j], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p_t, p_j, atol=1e-4)
    np.testing.assert_allclose(n_t, n_j, atol=1e-4)

    occ_j = np.asarray(jax.jit(JSH.ray_test)(table_j, o, d, maxt))
    occ_t = TSH.ray_test(table_t, torch.tensor(o), torch.tensor(d),
                         torch.tensor(maxt)).numpy()
    np.testing.assert_array_equal(occ_t, occ_j)


def test_render_rows_matches_jax(port_render, jax_wavefront):
    """Same seed, same estimator: per lane before the splat, >= 99.9% of
    lanes within 1e-3 relative (floor 1e-3); the allowance is for a branch
    flip at a discrete pick (TGMM component, sky/sun strategy) on a
    one-ulp difference. Per developed image, test_megakernel.py:68's bar."""
    lanes, img = port_render
    lanes_j, img_j = jax_wavefront
    assert lanes.shape == lanes_j.shape == (H * W * SPP, 3)
    assert (_lane_rel(lanes, lanes_j) > 1e-3).mean() <= 1e-3
    assert np.abs(img - img_j).max() < 1e-3 * max(img_j.max(), 1.0)
    assert img_j.max() > 0.1


def test_render_rows_matches_jax_megakernel(port_render, jax_megakernel):
    """Against JAX's `_render_impl` through its megakernel. That kernel
    evaluates asin/acos/atan2/erfinv with the TPU polynomials of
    ops/pallas/trig.py, whose error at the sun's limb reaches ~5e-3
    (test_pallas.py:124-132), so per lane: >= 99.9% within 5e-3 and all
    within 1e-2. Per image, the bar of test_megakernel.py:68."""
    lanes, img = port_render
    lanes_m, img_m = jax_megakernel
    rel = _lane_rel(lanes, lanes_m)
    assert (rel > 5e-3).mean() <= 1e-3
    assert rel.max() <= 1e-2
    assert np.abs(img - img_m).max() < 1e-3 * max(img_m.max(), 1.0)


def test_render_rows_depth3_matches_jax(scenes):
    """The bounce loop past direct illumination (one diffuse
    interreflection), per developed image."""
    (sc_j, sensor_j), (sc_t, sensor_t) = scenes
    img_j = np.asarray(jax.jit(lambda sc, se, k: JF.develop(JI.render_rows(
        sc, se, JF.Film(16, 16, 3), k, 2, 3, 1000, "rgb", 0, 16,
        kinds=table_kinds(sc.bsdfs))))(sc_j, sensor_j, KEY))
    img_t = TF.develop(TI.render_rows(sc_t, sensor_t, TF.Film(16, 16, 3),
                                      SEED, 2, 3, 1000, "rgb", 0, 16))
    assert np.abs(img_t.numpy() - img_j).max() < 1e-3 * max(img_j.max(),
                                                            1.0)


def test_cpu_render_impl_is_plain(scenes, port_render):
    """On the CPU `_render_impl` takes the wavefront path with the plain
    sunsky functions, and K4's wrapper returns its plain version: no
    kernel is built or launched."""
    sc, sensor = scenes[1]
    film = TF.Film(H, W, 3)
    kinds = ((0,), False)
    build.reset_launches()
    assert not TI._megakernel_ok(sc, sensor, film, SPP, 2, "rgb",
                                 "independent", kinds)
    acc = TI._render_impl(sc, sensor, film, SEED, SPP, 2, 1000, "rgb",
                          kinds=kinds)
    plain = TI.render_rows(sc, sensor, film, SEED, SPP, 2, 1000, "rgb", 0, H,
                           plain=True)
    assert torch.equal(acc, plain)
    np.testing.assert_array_equal(TF.develop(acc).numpy(), port_render[1])
    np.testing.assert_array_equal(
        TI.render(sc, sensor, film, SEED, spp=SPP).numpy(), port_render[1])
    lanes = TMK.megakernel_lanes(sc, sensor, sc.env, SEED, SPP, W, H)
    np.testing.assert_array_equal(lanes.numpy(), port_render[0])
    assert torch.equal(TMK.direct_rgb_megakernel(sc, sensor, sc.env, SEED,
                                                 SPP, W, H), acc)
    assert all(v == 0 for v in build.launches.values())
    assert build.library.cache_info().currsize == 0


def test_render_rows_is_invariant_to_spp_chunking(scenes, port_render):
    sc, sensor = scenes[1]
    acc = TI.render_rows(sc, sensor, TF.Film(H, W, 3), SEED, SPP, 2, 1000,
                         "rgb", 0, H, max_lanes=H * W)       # spp chunks of 1
    np.testing.assert_allclose(TF.develop(acc).numpy(), port_render[1],
                               rtol=1e-6, atol=1e-7)


def test_megakernel_rules_match_jax(scenes):
    """The static eligibility rules are the reference package's."""
    sc, sensor = scenes[1]
    film = TF.Film(64, 64, 3)
    rules = TI._megakernel_rules
    kinds = ((0,), False)
    assert rules(sc, sensor, film, 4, 2, "rgb", "independent", kinds, 1000)
    assert not rules(sc, sensor, film, 4, 3, "rgb", "independent", kinds,
                     1000)
    assert not rules(sc, sensor, film, 4, 2, "spectral", "independent",
                     kinds, 1000)
    assert not rules(sc, sensor, film, 4, 2, "rgb", "stratified", kinds,
                     1000)
    assert not rules(sc, sensor, film, 3, 2, "rgb", "independent", kinds,
                     1000)
    assert not rules(sc, sensor, film, 4, 2, "rgb", "independent", kinds, 1)
    assert not rules(sc._replace(env=None), sensor, film, 4, 2, "rgb",
                     "independent", kinds, 1000)
    assert not rules(sc, sensor, TF.Film(64, 64, 3, "gaussian"), 4, 2, "rgb",
                     "independent", kinds, 1000)
    assert not rules(sc, sensor, film, 4, 2, "rgb", "independent",
                     ((0, 1), False), 1000)


def test_path_sample_refuses_what_is_not_ported(scenes):
    sc, sensor = scenes[1]
    film = TF.Film(8, 8, 3)
    with pytest.raises(NotImplementedError):      # Russian roulette
        TI.render(sc, sensor, film, SEED, spp=1, max_depth=3, rr_depth=1)
    with pytest.raises(NotImplementedError):
        TI.render(sc, sensor, film, SEED, spp=1, mode="spectral")
    with pytest.raises(NotImplementedError):
        TI.render(sc, sensor, film, SEED, spp=1, sampler_kind="stratified")
    with pytest.raises(NotImplementedError):
        TI.render(sc._replace(env=None), sensor, film, SEED, spp=1)
