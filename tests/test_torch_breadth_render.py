"""The port's path-tracer breadth against the JAX package, lane by lane
at 16x16x2 on the CPU: Russian roulette, the cube and the cylinder, the
conductor, dielectric and thin-dielectric materials, area emitters (NEE
and hits), point, directional and spot lights (each connected, and one
sampled a vertex by weight), a constant environment and none.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusky.render import bsdf as JB
from tpusky.render.emitters import ConstantEnv, make_spot
from tpusky.render.scene import make_scene

from torch_breadth_case import (camera, jax_lanes, panel, port, port_lanes,
                                share_outside, sunsky_state, translate)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

GROUND = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)


def _rot_x(m, a):
    c, s = np.cos(a), np.sin(a)
    m = np.asarray(m, np.float32).copy()
    m[:3, :3] = np.array([[1, 0, 0], [0, c, -s], [0, s, c]],
                         np.float32) @ m[:3, :3]
    return m


def _roulette_scene():
    """Under the sunsky: a dielectric sphere, a diffuse cube, a
    rough-conductor cylinder, a mirror disk, a thin-dielectric sheet, an
    area panel and three delta lights (one sampled a vertex by weight);
    depth 6, Russian roulette from depth 2."""
    shapes = [
        dict(kind=1, to_world=GROUND, bsdf_idx=0),
        dict(kind=0, to_world=translate(np.diag([0.7, 0.7, 0.7, 1.0]),
                                        [0.0, 0.0, 0.9]), bsdf_idx=1),
        dict(kind=3, to_world=translate(np.diag([0.4, 0.4, 0.4, 1.0]),
                                        [1.4, 0.6, 0.4]), bsdf_idx=2),
        dict(kind=4, to_world=translate(np.diag([0.35, 0.35, 1.2, 1.0]),
                                        [-1.2, 0.8, 0.0]), bsdf_idx=3),
        dict(kind=2, to_world=_rot_x(np.diag([0.6, 0.6, 1.0, 1.0]), 1.2)
             @ np.eye(4, dtype=np.float32), bsdf_idx=4),
        dict(kind=1, to_world=_rot_x(np.diag([0.5, 0.5, 1.0, 1.0]), 1.4),
             bsdf_idx=5),
        dict(kind=1, to_world=panel(0.6, 2.8), bsdf_idx=6, emitter_idx=0),
    ]
    shapes[4]["to_world"][:3, 3] = [0.5, 1.8, 0.8]
    shapes[5]["to_world"][:3, 3] = [-0.6, -1.2, 0.6]
    rad = np.zeros((len(shapes), 3), np.float32)
    rad[6] = [6.0, 5.0, 4.0]
    sc = make_scene(
        shapes=shapes,
        bsdf_albedos=[[0.5, 0.5, 0.5], [1.0, 1.0, 1.0], [0.7, 0.3, 0.2],
                      [0.9, 0.7, 0.4], [0.9, 0.9, 0.9], [1.0, 1.0, 1.0],
                      [0.0, 0.0, 0.0]],
        bsdf_kinds=[JB.DIFFUSE, JB.DIELECTRIC, JB.DIFFUSE,
                    JB.ROUGH_CONDUCTOR, JB.CONDUCTOR, JB.THIN_DIELECTRIC,
                    JB.DIFFUSE],
        bsdf_alphas=[0.1, 0.1, 0.1, 0.2, 0.1, 0.1, 0.1],
        bsdf_iors=[1.5, 1.5, 1.5, 1.5, 1.5, 1.33, 1.5],
        area_radiance=rad, env=sunsky_state(),
        point_lights=[[1.0, -1.0, 2.5, 4.0, 4.0, 4.0]],
        directional_lights=[[-0.3, 0.4, -0.85, 1.5, 1.4, 1.2]],
        spot_lights=[make_spot([-1.5, -1.5, 3.0], [0.4, 0.4, -0.8],
                               [20.0, 18.0, 16.0], cutoff_angle_deg=25.0)],
        delta_light_weights=[1.0, 2.0, 1.5])
    return sc, camera(), 6, 2


def _unrolled_scene():
    """Under a ConstantEnv: two delta lights, a point light and a spot
    light with a projected texture, each connected at every vertex; a
    twosided cube turned about x, a diffuse cylinder; depth 3."""
    tex = np.random.default_rng(5).random((6, 8, 3)).astype(np.float32)
    sc = make_scene(
        shapes=[dict(kind=1, to_world=GROUND, bsdf_idx=0),
                dict(kind=0, to_world=translate(np.eye(4), [0, 0, 1.0]),
                     bsdf_idx=1),
                dict(kind=3, to_world=translate(
                    _rot_x(np.diag([0.5, 0.5, 0.5, 1.0]), 0.5),
                    [1.3, 1.0, 0.6]), bsdf_idx=2),
                dict(kind=4, to_world=translate(
                    np.diag([0.4, 0.4, 1.5, 1.0]), [-1.3, 0.6, 0.0]),
                    bsdf_idx=1)],
        bsdf_albedos=[[0.5, 0.5, 0.5], [0.6, 0.2, 0.2], [0.2, 0.5, 0.7]],
        bsdf_twosided=[False, False, True],
        env=ConstantEnv(jnp.asarray([0.6, 0.7, 0.8])),
        point_lights=[[1.5, -1.5, 3.0, 6.0, 5.0, 4.0]],
        spot_lights=[make_spot([-1.0, -2.0, 3.5], [0.2, 0.5, -0.8],
                               [30.0, 30.0, 30.0], cutoff_angle_deg=30.0,
                               texture=tex)])
    return sc, camera(), 3, 1000


def _area_scene():
    """No environment: a rectangle, a disk and a sphere emitter over a
    diffuse sphere and ground; depth 3."""
    disk = translate(np.diag([0.5, 0.5, 1.0, 1.0]), [1.5, 1.0, 2.0])
    disk[:3, :3] = disk[:3, :3] @ np.diag([1.0, -1.0, -1.0])
    rad = np.zeros((5, 3), np.float32)
    rad[2] = [8.0, 7.0, 6.0]
    rad[3] = [2.0, 4.0, 6.0]
    rad[4] = [5.0, 2.0, 1.0]
    sc = make_scene(
        shapes=[dict(kind=1, to_world=GROUND, bsdf_idx=0),
                dict(kind=0, to_world=translate(np.eye(4), [0, 0, 1.0]),
                     bsdf_idx=1),
                dict(kind=1, to_world=panel(0.8, 2.6), bsdf_idx=2,
                     emitter_idx=0),
                dict(kind=2, to_world=disk, bsdf_idx=2, emitter_idx=1),
                dict(kind=0, to_world=translate(
                    np.diag([0.2, 0.2, 0.2, 1.0]), [-1.5, -0.5, 1.8]),
                    bsdf_idx=2, emitter_idx=2)],
        bsdf_albedos=[[0.5, 0.5, 0.5], [0.6, 0.6, 0.3], [0.0, 0.0, 0.0]],
        area_radiance=rad, env=None)
    return sc, camera(), 3, 1000


_CASES = {"roulette_single_sample": _roulette_scene,
          "unrolled_constant_env": _unrolled_scene,
          "area_emitters": _area_scene}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_breadth_lanes_match_jax(case):
    """Same seed, same estimator: per lane >= 99.9% of lanes within 1e-3
    relative (floor 1e-3), the bar of tests/test_torch_render.py; the
    lanes lit."""
    sc_j, sensor_j, depth, rr_depth = _CASES[case]()
    lanes_j = jax_lanes(sc_j, sensor_j, depth, rr_depth)
    sc, sensor = port(sc_j, sensor_j)
    lanes = port_lanes(sc, sensor, depth, rr_depth)
    assert lanes.shape == lanes_j.shape
    assert (lanes_j.max(-1) > 0).mean() > 0.25
    assert share_outside(lanes, lanes_j) <= 1e-3, (
        share_outside(lanes, lanes_j),
        np.abs(lanes - lanes_j).max())
