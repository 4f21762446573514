"""The port's particle tracer (`tpusky_torch/render/ptracer.py`) against
the JAX package's `render_ptracer` at 8x8 with 4,096 particles and the
same key on the CPU, RGB and spectral, on a scene with every strategy: an
area panel, a point light, a spot light, a directional-area sphere and
the sunsky (its particles launched from the bounding sphere). Then the
deterministic splat and the R15 refusal.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import jax
import numpy as np
import pytest
import torch

from tpusky.render.emitters import make_spot
from tpusky.render.film import Film as JFilm
from tpusky.render.ptracer import render_ptracer as jax_render_ptracer
from tpusky.render.scene import make_scene

from tpusky_torch.render import medium as TMD
from tpusky_torch.render import ptracer as TP
from tpusky_torch.render.film import Film
from tpusky_torch.render.sensors import make_spherical

from torch_breadth_case import KEY, camera, panel, port, sunsky_state, \
    translate
from torch_medium_case import GROUND, WORDS

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

SIZE = 8
PARTICLES = 4096
DEPTH = 4


def _scene(mode):
    rad = np.zeros((3, 3), np.float32)
    rad[2] = [6.0, 5.0, 4.0]
    dar = np.zeros((3, 3), np.float32)
    dar[1] = [1.0, 0.8, 0.6]
    return make_scene(
        shapes=[dict(kind=1, to_world=GROUND, bsdf_idx=0),
                dict(kind=0, to_world=translate(np.eye(4), [0, 0, 1.0]),
                     bsdf_idx=1),
                dict(kind=1, to_world=panel(0.6, 2.8), bsdf_idx=2,
                     emitter_idx=0)],
        bsdf_albedos=[[0.5, 0.5, 0.5], [0.6, 0.2, 0.2], [0.0, 0.0, 0.0]],
        area_radiance=rad, dir_area_radiance=dar, env=sunsky_state(mode),
        point_lights=[[1.0, -1.0, 2.5, 4.0, 4.0, 4.0]],
        spot_lights=[make_spot([-1.5, -1.5, 3.0], [0.4, 0.4, -0.8],
                               [20.0, 18.0, 16.0], cutoff_angle_deg=25.0)])


@pytest.mark.parametrize("mode,sampler_kind", [("rgb", "independent"),
                                               ("spectral", "stratified")])
def test_ptracer_matches_jax(mode, sampler_kind):
    """Every pixel within 1e-4 relative (floor 1e-3 of the image's
    scale) of the reference's image for the same key: RGB under the
    independent sampler, spectral (the sunsky's particles' wavelengths
    from its spectral distribution) under stratified."""
    sc_j, cam = _scene(mode), camera()
    ref = np.asarray(jax_render_ptracer(
        sc_j, cam, JFilm(SIZE, SIZE, 3), KEY, n_particles=PARTICLES,
        max_depth=DEPTH, sampler_kind=sampler_kind, mode=mode))
    sc_t, cam_t = port(sc_j, cam)
    assert TP._strategies(sc_t) == ("area", "point", "spot", "dir_area",
                                    "env")
    img = TP.render_ptracer(sc_t, cam_t, Film(SIZE, SIZE, 3), WORDS,
                            n_particles=PARTICLES, max_depth=DEPTH,
                            sampler_kind=sampler_kind, mode=mode).numpy()
    scale = np.abs(ref).max()
    err = np.abs(img - ref) / np.maximum(np.abs(ref), 1e-3 * scale)
    assert ref.mean() > 0.05 and err.max() <= 1e-4, err.max()


def test_splat_deterministic_and_refusals():
    """`_segment_sum` equals float64 per-segment sums within float32
    rounding and repeats bitwise; an empty strategy list renders black;
    textures or a medium raise naming R15; a non-perspective sensor
    raises TypeError."""
    rng = np.random.default_rng(8)
    seg = torch.tensor(rng.integers(0, 50, 5000))
    vals = torch.tensor(rng.normal(size=(5000, 3)).astype(np.float32))
    out = TP._segment_sum(vals, seg, 64)
    ref = np.zeros((64, 3))
    np.add.at(ref, seg.numpy(), vals.numpy().astype(np.float64))
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert torch.equal(out, TP._segment_sum(vals, seg, 64))
    assert not out[50:].any()

    sc_t, cam_t = port(make_scene(
        shapes=[dict(kind=1, to_world=GROUND, bsdf_idx=0)]), camera())
    film = Film(4, 4, 3)
    assert not TP.render_ptracer(sc_t, cam_t, film, 1, 64).any()
    sc_m = sc_t._replace(medium=TMD.make_medium([0.5], [0.8],
                                                kind="global",
                                                device="cpu"))
    with pytest.raises(NotImplementedError, match="R15"):
        TP.render_ptracer(sc_m, cam_t, film, 1, 64)
    with pytest.raises(NotImplementedError, match="R15"):
        TP.render_ptracer(sc_t._replace(textures=object()), cam_t, film, 1,
                          64)
    with pytest.raises(TypeError):
        TP.render_ptracer(sc_t, make_spherical(device="cpu"), film, 1, 64)
