"""The port's path tracer on a scene of the new geometry and materials,
lane by lane against the JAX package's `_path_sample` on the CPU: an SDF
torus of the RGL measured BRDF (kind 17), a tuft of B-spline hair strands
(kind 16) and a diffuse ground under the sunsky, at 16x16x2, depth 3, RGB
and spectral.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import numpy as np
import pytest
import torch

import torch_geometry_case as G
from torch_breadth_case import (H, SEED, W, jax_lanes, port, port_lanes,
                                share_outside)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

DEPTH = 3


@pytest.mark.parametrize("mode", ["rgb", "spectral"])
def test_geometry_lanes_match_jax(mode):
    """At 16x16x2, depth 3 (camera rays on the torus, the strands, the
    ground and the sky; hair shaded in the fiber frame of the winning
    segment; shadow rays against both), the lanes whose camera ray misses
    the strands within 1e-3 relative (floor 1e-3) of the reference's but
    a 1e-3 share of them. A lane whose camera ray meets a strand within
    5e-2, and within 1e-3 but on 10% of them: the reference's curve walk
    is a compiled scan whose contracted roundings move t by ~1e-4 from
    its own op-by-op arithmetic (which the port's equals bitwise,
    tests/test_torch_sdf_curve.py), a normal by that over the 0.03 radius,
    and hair's peaked lobes carry that into 1e-3-1e-2 of radiance. In
    spectral mode the measured file is spectral and hair's sigma_a a
    spectrum."""
    sc_j, cam = G.geometry_scene(mode), G.camera()
    ref = jax_lanes(sc_j, cam, DEPTH, 1000, mode)
    sc, sensor = port(sc_j, cam)
    lanes = port_lanes(sc, sensor, DEPTH, 1000, mode)
    assert lanes.shape == ref.shape == (H * W * 2, 3)
    first = G.primary_shape(sc, sensor, H, W, 2, SEED)
    strand = first == -4
    assert {-4, -3, -1, 0} <= set(first.tolist()) and strand.sum() >= 40
    assert share_outside(lanes[~strand], ref[~strand]) <= 1e-3
    assert share_outside(lanes[strand], ref[strand]) <= 0.1
    assert share_outside(lanes[strand], ref[strand], 5e-2) == 0.0
    assert ref.mean() > 0.05
