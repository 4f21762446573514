"""The port's material breadth and bitmap environment in whole renders,
lane by lane against the JAX package at 16x16x2 on the CPU: under the
sunsky a rough-dielectric sphere, a plastic cube behind an opacity mask
of 0.5, a rough-plastic cylinder, a principled sphere inside a null
sphere, a principledthin disk and a blend rectangle (depth 6, Russian
roulette from depth 2); and `envmap_lit`'s bitmap sky
(tools/gen_scene_goldens.py:207-227) in RGB and spectral mode.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import numpy as np
import pytest
import torch

from tools.gen_scene_goldens import scene_envmap_lit
from tpusky.render import bsdf as JB
from tpusky.render.scene import make_scene

from torch_breadth_case import (camera, jax_lanes, port, port_lanes,
                                share_outside, sunsky_state, translate)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[1:3, 1:3] = [[c, -s], [s, c]]
    return m


def material_scene():
    """Every ported non-delta kind but the conductors, the plastic's delta
    coat, a null sphere and a mask, under the headline sunsky."""
    def at(scale, xyz, rot=None):
        m = np.diag(list(scale) + [1.0]).astype(np.float32)
        if rot is not None:
            m = rot @ m
        return translate(m, xyz)
    shapes = [
        dict(kind=1, to_world=at([10.0, 10.0, 1.0], [0, 0, 0]), bsdf_idx=0),
        dict(kind=0, to_world=at([0.7] * 3, [0.0, 0.0, 0.8]), bsdf_idx=1),
        dict(kind=3, to_world=at([0.45] * 3, [1.5, 0.7, 0.45]), bsdf_idx=2),
        dict(kind=4, to_world=at([0.4, 0.4, 1.4], [-1.5, 0.9, 0.0]),
             bsdf_idx=3),
        dict(kind=0, to_world=at([0.45] * 3, [0.6, -1.3, 0.45]), bsdf_idx=4),
        dict(kind=0, to_world=at([0.7] * 3, [0.6, -1.3, 0.45]), bsdf_idx=5),
        dict(kind=2, to_world=at([0.5, 0.5, 1.0], [-0.8, -1.4, 0.9],
                                 _rot_x(1.2)), bsdf_idx=6),
        dict(kind=1, to_world=at([0.5, 0.5, 1.0], [1.8, -0.6, 0.8],
                                 _rot_x(1.4)), bsdf_idx=7),
    ]
    kinds = [JB.DIFFUSE, JB.ROUGH_DIELECTRIC, JB.PLASTIC, JB.ROUGH_PLASTIC,
             JB.PRINCIPLED, JB.NULL_BSDF, JB.PRINCIPLED_THIN, JB.BLEND,
             JB.DIFFUSE, JB.ROUGH_CONDUCTOR]
    extras = np.zeros((len(kinds), 8), np.float32)
    extras[:, 1] = 0.5
    extras[4] = [0.3, 0.5, 0.2, 0.3, 1.0, 0.6, 0.1, 0.0]
    extras[6] = [0.4, 0.3, 0.2, 0.3, 0.2, 0.3, 0.0, 0.0]
    children = np.zeros((len(kinds), 2), np.int32)
    children[7] = [8, 9]
    weights = np.zeros((len(kinds),), np.float32)
    weights[7] = 0.4
    opacities = np.ones((len(kinds),), np.float32)
    opacities[2] = 0.5
    sc = make_scene(
        shapes=shapes,
        bsdf_albedos=[[0.4, 0.4, 0.4], [1.0, 1.0, 1.0], [0.7, 0.3, 0.2],
                      [0.2, 0.5, 0.7], [0.8, 0.6, 0.3], [1.0, 1.0, 1.0],
                      [0.6, 0.7, 0.5], [0.5, 0.5, 0.5], [0.3, 0.6, 0.3],
                      [0.9, 0.7, 0.4]],
        bsdf_kinds=kinds, bsdf_alphas=[0.1, 0.2, 0.1, 0.3, 0.35, 0.1, 0.3,
                                       0.1, 0.1, 0.25],
        bsdf_iors=[1.5, 1.5, 1.5, 1.5, 1.5, 1.0, 1.45, 1.5, 1.5, 1.5],
        bsdf_twosided=[False, False, False, False, False, False, False,
                       True, True, True],
        bsdf_extras=extras, bsdf_blend_children=children,
        bsdf_blend_weights=weights, bsdf_opacities=opacities,
        env=sunsky_state())
    return sc, camera()


def test_material_breadth_lanes_match_jax():
    """Depth 6, Russian roulette from depth 2: >= 99.9% of lanes within
    1e-3 relative (floor 1e-3), the bar of tests/test_torch_render.py;
    the lanes lit."""
    sc_j, sensor_j = material_scene()
    lanes_j = jax_lanes(sc_j, sensor_j, 6, 2)
    sc, sensor = port(sc_j, sensor_j)
    assert sc.bsdfs.host_mask
    lanes = port_lanes(sc, sensor, 6, 2)
    assert (lanes_j.max(-1) > 0).mean() > 0.5
    assert share_outside(lanes, lanes_j) <= 1e-3, (
        share_outside(lanes, lanes_j), np.abs(lanes - lanes_j).max())


@pytest.mark.parametrize("mode", ["rgb", "spectral"])
def test_envmap_lanes_match_jax(mode):
    """`envmap_lit` (depth 2): the envmap's NEE, its hits with MIS, and in
    spectral mode the channels' mean at every hero wavelength; the same
    bar."""
    sc_j, sensor_j, depth = scene_envmap_lit()
    lanes_j = jax_lanes(sc_j, sensor_j, depth, 1000, mode)
    sc, sensor = port(sc_j, sensor_j)
    lanes = port_lanes(sc, sensor, depth, 1000, mode)
    assert (lanes_j.max(-1) > 0).mean() > 0.5
    assert share_outside(lanes, lanes_j) <= 1e-3, (
        share_outside(lanes, lanes_j), np.abs(lanes - lanes_j).max())
