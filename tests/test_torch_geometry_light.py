"""The new geometry and materials through the port's other paths against
the JAX package on the CPU: the particle tracer on an SDF scene, the
Stokes path on the measured pBRDF (kind 18), and `render_aovs` of the
SDF, curve and measured scene (`torch_geometry_case.geometry_scene`).

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import jax
import numpy as np
import torch

from tpusky.render import measured as JM
from tpusky.render import sdf as JS
from tpusky.render.aov import render_aovs as jax_render_aovs
from tpusky.render.film import Film as JFilm
from tpusky.render.ptracer import render_ptracer as jax_render_ptracer
from tpusky.render.scene import make_scene

from tpusky_torch.render import film as TF
from tpusky_torch.render import ptracer as TP
from tpusky_torch.render.aov import render_aovs

import torch_geometry_case as G
from torch_breadth_case import H, KEY, SEED, W, port, sunsky_state
from torch_polarized_case import (jax_stokes_lanes, port_stokes_lanes,
                                  stokes_flips)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

WORDS = np.asarray(jax.random.key_data(KEY))


def _sdf_scene(albedo=(0.6, 0.3, 0.2)):
    """The diffuse ground and a diffuse 12^3 SDF torus under the sunsky."""
    return make_scene(shapes=[G.ground()], env=sunsky_state(),
                      bsdf_albedos=[[0.4] * 3, list(albedo)],
                      sdf=JS.make_sdf_grid(G.torus_grid(12),
                                           G.torus_to_world(), 1))


def test_ptracer_sdf_matches_jax():
    """`render_ptracer` of the SDF scene at 8x8 with 4,096 sunsky
    particles, depth 3, the same key: every pixel within 1e-4 relative
    (floor 1e-3 of the image's scale) of the reference's image but 2 of
    the 64 (a particle whose march ends a step apart), all within 2e-2;
    the torus is lit and seen."""
    sc_j, cam = _sdf_scene(), G.camera()
    ref = np.asarray(jax_render_ptracer(sc_j, cam, JFilm(8, 8, 3), KEY,
                                        n_particles=4096, max_depth=3))
    sc, sensor = port(sc_j, cam)
    img = TP.render_ptracer(sc, sensor, TF.Film(8, 8, 3), WORDS,
                            n_particles=4096, max_depth=3).numpy()
    scale = np.abs(ref).max()
    err = (np.abs(img - ref) / np.maximum(np.abs(ref), 1e-3 * scale)).max(-1)
    assert ref.mean() > 0.01 and (err > 1e-4).sum() <= 2, err.max()
    assert err.max() <= 2e-2
    first = G.primary_shape(sc, sensor, 8, 8, 1, SEED)
    assert (first == -3).any()


def test_stokes_measured_pbrdf_matches_jax():
    """`render_stokes`' lanes of a measured-pBRDF sphere (kind 18, alpha
    0.3) on the diffuse ground under the sunsky, 16x16x2, depth 3: every
    lane's Stokes vector within 1e-3 of the reference's S0 there (floor
    1e-3) but a 1e-3 share; the pBRDF polarizes (the largest degree of
    polarization above 0.1) and no lane exceeds 1 by more than 1e-3."""
    sphere = np.diag([0.7, 0.7, 0.7, 1.0]).astype(np.float32)
    sphere[2, 3] = 0.8
    sc_j = make_scene(
        shapes=[G.ground(), dict(kind=0, to_world=sphere, bsdf_idx=1)],
        env=sunsky_state(), bsdf_kinds=[0, 18],
        bsdf_albedos=[[0.4] * 3, [1.0] * 3],
        measured_pol=JM.load_measured_polarized(G.pbsdf_fields(),
                                                alpha_sample=0.3))
    cam = G.camera()
    ref = jax_stokes_lanes(sc_j, cam, 3)
    sc, sensor = port(sc_j, cam)
    lanes = port_stokes_lanes(sc, sensor, 3)
    assert lanes.shape == ref.shape
    assert stokes_flips(lanes, ref, 1e-3).mean() <= 1e-3
    dop = (np.linalg.norm(lanes[..., 1:], axis=-1)
           / np.maximum(lanes[..., 0], 1e-6))
    assert 0.1 < float(dop.max()) <= 1.0 + 1e-3


def test_geometry_aovs_match_jax():
    """`render_aovs`' depth, position and normals within 1e-3, albedo,
    shape index (-3 on the SDF, -4 on a curve) and uv equal on >= 99% of
    the pixels of the reference's at 16x16."""
    sc_j, cam = G.geometry_scene("rgb"), G.camera()
    ref = {k: np.asarray(v) for k, v in jax_render_aovs(
        sc_j, cam, H, W).items() if k in ("depth", "position", "normal",
                                           "geo_normal", "albedo",
                                           "shape_idx", "uv")}
    sc, sensor = port(sc_j, cam)
    out = {k: v.numpy() for k, v in render_aovs(sc, sensor, H, W).items()}
    assert {-4, -3, 0, -1} <= set(np.unique(ref["shape_idx"]).tolist())
    assert (out["shape_idx"] == ref["shape_idx"]).mean() >= 0.99
    for k in ("depth", "position", "normal", "geo_normal", "albedo", "uv"):
        err = np.abs(out[k] - ref[k]).reshape(H * W, -1).max(-1)
        assert (err <= 1e-3).mean() >= 0.99, k
