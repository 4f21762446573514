"""The port's mesh scene (`tools/gen_scene_goldens.py::scene_mesh_gi`)
against the JAX package on the CPU.

An icosphere with vertex normals at (0, 0, 1) on a 20x20 diffuse ground
under the RGB sunsky (turbidity 3, albedo 0.3), depth 3: camera, shadow
and bounce rays all query the mesh. Lane by lane against JAX's wavefront
at 320 and 1,280 triangles (the `independent` sampler draws bitwise the
same uniforms in both), and the port's 48x48 render by per-pixel Z-test
against the stored golden, as tests/test_render_regression.py does.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky.tables import load_tables as jax_load_tables
from tpusky.render import integrator as JI
from tpusky.render import sensors as JS
from tpusky.render.bsdf import table_kinds
from tpusky.render.scene import make_scene as jax_make_scene
from tpusky.utils.ztest import z_test

import tpusky_torch as tt
from tpusky_torch import convert
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.render.scene import make_scene
from tpusky_torch.render.sensors import make_perspective
from tpusky_torch.utils.meshio import icosphere

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

H = W = 16
SPP = 2
DEPTH = 3
KEY = jax.random.PRNGKey(7)
SEED = int(np.asarray(jax.random.key_data(KEY))[-1])    # == 7
SUN = [0.3, 0.2, 0.93]
# JAX's dense mesh path at 16x16x2 lanes; both meshes are padded to this
# many rows, so its path is traced and compiled once for both
_JAX_ROWS = 1280


def _meshes(n_subdiv):
    pos, idx = icosphere(n_subdiv)
    t2w = np.eye(4, dtype=np.float32)
    t2w[2, 3] = 1.0
    return [dict(positions=pos, indices=idx, normals=pos.copy(),
                 to_world=t2w, bsdf_idx=1)]


_GROUND = [dict(kind=1, to_world=np.diag([10.0, 10.0, 1.0, 1.0]).astype(
    np.float32), bsdf_idx=0)]
_ALBEDOS = [[0.5, 0.5, 0.5], [0.3, 0.5, 0.7]]
_EYE, _TARGET = [3.5, -3.5, 2.0], [0, 0, 1.0]


def _jax_scene(state, n_subdiv):
    sc = jax_make_scene(shapes=_GROUND, bsdf_albedos=_ALBEDOS,
                        meshes=_meshes(n_subdiv), env=state)
    pad = _JAX_ROWS - sc.mesh.v0.shape[0]
    mesh = type(sc.mesh)(*(
        None if a is None else jnp.concatenate(
            [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
        for a in sc.mesh))
    return sc._replace(mesh=mesh)


def _port_scene(state, n_subdiv, device="cpu"):
    return (make_scene(shapes=_GROUND, bsdf_albedos=_ALBEDOS,
                       meshes=_meshes(n_subdiv), env=state, device=device),
            make_perspective(_EYE, _TARGET, fov_x_deg=45, device=device))


def _jax_lanes(sc, sensor, key):
    """Per-lane radiance of JAX's render_rows before the splat (the body
    of `integrator._render_rows_chunk`, as tests/test_torch_render.py)."""
    n = H * W * SPP
    lane = jnp.arange(n, dtype=jnp.uint32)
    pixel = lane // SPP
    smp = JI._SamplerCtx("independent", key, pixel, lane % SPP, SPP)
    u = smp.next(10_000, 2)
    uv = jnp.stack([((pixel % W).astype(jnp.float32) + u[:, 0]) / W,
                    ((pixel // W).astype(jnp.float32) + u[:, 1]) / H], -1)
    o, d = JS.sample_ray(sensor, uv)
    r = JI._path_sample(sc, o, d, smp, DEPTH, 1000, "rgb", None,
                        kinds=table_kinds(sc.bsdfs))
    return jnp.where(jnp.isfinite(r), r, 0.0)


@pytest.fixture(scope="module")
def states():
    params = dict(turbidity=3.0, albedo=0.3, sun_direction=SUN)
    jax_state = jax.jit(lambda p: JM.precompute(jax_load_tables("rgb"), p,
                                                "rgb"))(ts.make_params(**params))
    return jax_state, tt.sunsky_precompute(tt.make_params(**params,
                                                          device="cpu"))


@pytest.fixture(scope="module")
def jax_lanes_fn():
    return jax.jit(_jax_lanes)


def _lane_rel(a, b):
    return (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max(-1)


@pytest.mark.parametrize("n_subdiv", [2, 3], ids=["320", "1280"])
def test_mesh_gi_lanes_match_jax(states, jax_lanes_fn, n_subdiv):
    """Per lane, >= 99.9% within 1e-3 relative (floor 1e-3), and per
    image within 1e-3 of its scale: the bars of
    tests/test_torch_render.py. The port's scene comes from its own
    make_scene; the JAX scene, its mesh table padded with invalid rows,
    runs JAX's dense scan."""
    sensor_j = JS.make_perspective(_EYE, _TARGET, fov_x_deg=45)
    lanes_j = np.asarray(jax_lanes_fn(_jax_scene(states[0], n_subdiv),
                                      sensor_j, KEY))
    sc, sensor = _port_scene(states[1], n_subdiv)
    film = TF.Film(H, W, 3)
    lanes = TI._lane_radiance(sc, sensor, film, SEED, SPP, 0, SPP, DEPTH,
                              1000, "rgb", 0, H).numpy()
    assert lanes.shape == lanes_j.shape == (H * W * SPP, 3)
    assert (_lane_rel(lanes, lanes_j) > 1e-3).mean() <= 1e-3
    img = TF.develop(TI.render_rows(sc, sensor, film, SEED, SPP, DEPTH, 1000,
                                    "rgb", 0, H)).numpy()
    img_j = lanes_j.reshape(H, W, SPP, 3).mean(2)
    assert np.abs(img - img_j).max() < 1e-3 * max(img_j.max(), 1.0)
    assert img_j.max() > 0.1
    # a mesh hit replaces the shapes' hit point, normal and material
    o, d = (torch.tensor(x) for x in (np.array([[3.5, -3.5, 1.0]]),
                                      np.array([[-1.0, 1.0, 0.0]])))
    d = d.float() / np.sqrt(2.0)
    t, p, ng, mat, hit = TI._scene_intersect(sc, o.float(), d, plain=False)
    assert bool(hit[0]) and int(mat[0]) == 1
    # within the facets of icosphere(2)
    assert abs(float(t[0]) - (np.hypot(3.5, 3.5) - 1.0)) < 5e-2
    assert abs(float(ng[0, 0]) - 0.7071) < 1e-2


def test_mesh_gi_passes_golden_ztest(states):
    """The port's 48x48 render of scene_mesh_gi (320 triangles) at 64 spp,
    seed 1234, passes the per-pixel Z-test against the stored golden
    (tests/test_render_regression.py:41-52)."""
    path = os.path.join(os.path.dirname(__file__), "golden",
                        "scene_goldens.npz")
    with np.load(path) as z:
        size = int(z["size"])
        mean, var = z["mesh_gi_mean"], z["mesh_gi_var"]
        assert int(z["mesh_gi_depth"]) == DEPTH
    sc, sensor = _port_scene(states[1], 2)
    img = TI.render(sc, sensor, TF.Film(size, size, 3), 1234, spp=64,
                    max_depth=DEPTH).numpy()
    ok, n_failed, min_p, alpha = z_test(img, 64, mean, var)
    assert ok, (f"{n_failed} pixels failed the Z-test (min p={min_p:.3g}, "
                f"alpha_corr={alpha:.3g})")


def test_megakernel_refuses_a_mesh_scene(states):
    """K4 intersects analytic shapes only, so a mesh scene never takes
    it, whatever else it meets (`tpusky/render/integrator.py:955`)."""
    sc, sensor = _port_scene(states[1], 1)
    film = TF.Film(64, 64, 3)
    kinds = ((0,), False)
    args = (sensor, film, 4, 2, "rgb", "independent", kinds, 1000)
    assert TI._megakernel_rules(sc._replace(mesh=None), *args)
    assert not TI._megakernel_rules(sc, *args)
