"""The port's render slice (`tpusky_torch.render`) against the JAX package
(its render lane by lane against JAX's wavefront and megakernel is in
tests/test_torch_render_wavefront.py, a file of 2 items).

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
from tpusky.ops.pallas.megakernel import _shape_rows as _jax_shape_rows
from tpusky.render import sampler as JSM
from tpusky.render import sensors as JS
from tpusky.render import shapes as JSH
from tpusky.render.scene import make_scene as jax_make_scene

from tpusky_torch import convert
from tpusky_torch.ops.cuda import build
from tpusky_torch.ops.cuda import megakernel as TMK
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.render import sampler as TSM
from tpusky_torch.render import sensors as TS
from tpusky_torch.render import shapes as TSH

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

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
    """Every kind of the reference is ported; a kind the reference does
    not have raises ValueError, as its lane_samples does (sampler.py:252).
    """
    with pytest.raises(ValueError, match="unknown sampler"):
        TSM.lane_samples("sobol", 0, torch.zeros(4, dtype=torch.long),
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


@pytest.mark.parametrize("rotated", [False, True])
def test_megakernel_rows_match_jax(scenes, rotated):
    """The rows K4 stages, by their plain version `scene_rows` (the one
    chip_smoke.py holds the kernel's staged copy against), equal the JAX
    megakernel's to 1e-6: the shape rows `_shape_rows(shapes, env_rot)`,
    the camera and material rows its wrapper builds inline
    (tpusky/ops/pallas/megakernel.py:452-465), recomputed in numpy; under
    an identity and a rotated environment, with a two-sided material."""
    (sc_j, sensor_j), (sc_t, sensor_t) = scenes
    e = np.eye(3, dtype=np.float32)
    if rotated:
        c, s = np.cos(0.7), np.sin(0.7)
        e = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                     np.float32) @ np.array([[c, -s, 0.0], [s, c, 0.0],
                                             [0.0, 0.0, 1.0]], np.float32)
    twosided = np.array([False, True])
    sc_t = sc_t._replace(env_to_world=torch.tensor(e),
                         bsdfs=sc_t.bsdfs._replace(
                             twosided=torch.tensor(twosided)))
    cam, shp, mat = TMK.scene_rows(sc_t, sensor_t)
    shp_j = np.asarray(_jax_shape_rows(sc_j.shapes, jnp.asarray(e)))
    np.testing.assert_allclose(shp.numpy(), shp_j[:, :12], rtol=0, atol=1e-6)
    r = np.asarray(sensor_j.to_world)
    cam_j = np.zeros(16, np.float32)
    cam_j[0:9] = (e.T @ r[:3, :3]).reshape(-1)
    cam_j[9:12] = e.T @ r[:3, 3]
    cam_j[12] = np.tan(0.5 * np.deg2rad(np.asarray(sensor_j.fov_x_deg)))
    cam_j[13] = np.asarray(sensor_j.aspect)
    np.testing.assert_allclose(cam.numpy(), cam_j, rtol=0, atol=1e-6)
    idx = np.asarray(sc_j.shapes.bsdf_idx)
    mat_j = np.concatenate([np.asarray(sc_j.bsdfs.albedo)[idx],
                            twosided.astype(np.float32)[idx, None]], 1)
    np.testing.assert_allclose(mat.numpy(), mat_j, rtol=0, atol=1e-6)


def test_megakernel_pack_takes_the_raw_tensors(scenes):
    """K4's inputs are the scene's, the camera's and the state's own
    tensors, not copies, so a frame builds no table on the host (the
    kernel builds its rows in its staging); a state not in RGB mode, and
    an input that requires grad, are refused."""
    sc, sensor = scenes[1]
    st = sc.env
    packed = TMK.pack(sc, sensor, st)
    for a, b in zip((packed.to_world, packed.to_object, packed.albedo,
                     *packed.state),
                    (sensor.to_world, sc.shapes.to_object, sc.bsdfs.albedo,
                     *TMK._state_fields(st))):
        assert a.data_ptr() == b.data_ptr()
    assert packed.kind.tolist() == list(sc.shapes.kind)
    with pytest.raises(ValueError, match="RGB mode"):
        TMK.pack(sc, sensor, st._replace(sky_params=torch.zeros(11, 9)))
    with pytest.raises(ValueError, match="no adjoint"):
        TMK.pack(sc, sensor, st._replace(
            gaussians=st.gaussians.clone().requires_grad_()))


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
    with pytest.raises(NotImplementedError):      # not a kind
        TI.render(sc._replace(bsdfs=sc.bsdfs._replace(host_kind=(0, 19))),
                  sensor, film, SEED, spp=1)
    # the polarized kinds' and hair's lobes are ported: with them in the
    # descriptor the frame (no lane of theirs) is the same
    assert torch.equal(
        TI.render(sc._replace(bsdfs=sc.bsdfs._replace(
            host_kind=(0, 11, 12, 13, 14, 16))), sensor, film, SEED, spp=1),
        TI.render(sc, sensor, film, SEED, spp=1))
    with pytest.raises(NotImplementedError):
        TI.render(sc, sensor, film, SEED, spp=1, mode="polarized")
    with pytest.raises(ValueError, match="unknown sampler"):
        TI.render(sc, sensor, film, SEED, spp=1, sampler_kind="sobol")
    with pytest.raises(TypeError, match="unknown sensor"):
        TI.render(sc, object(), film, SEED, spp=1)
    with pytest.raises(NotImplementedError):      # an environment map
        TI.render(sc._replace(env=object()), sensor, film, SEED, spp=1)
