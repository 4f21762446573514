"""The port's `render_stokes` (RGB) against the JAX package's Stokes path
on the CPU, lane by lane at 16x16x2, depth 4, on the scene of
`torch_polarized_case` (kinds 1, 2, 3, 11-14, an area panel, a point
light, a mesh under the sunsky); its S0 against the scalar path on a
depolarizing scene; and its refusals (R16, R18, kind 18).

A lane's error is taken per channel relative to the reference's S0 there
(floor 1e-3): |S1..S3| <= S0, so S0 is the lane's scale.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusky.render import bsdf as JB
from tpusky.render import polarized as JP

from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import curve as TCV
from tpusky_torch.render import emitters as TE
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.render import medium as TMD
from tpusky_torch.render import polarized as TP
from tpusky_torch.render import sdf as TSD
from tpusky_torch.render.sampler import fold_in

from torch_polarized_case import (H, SPP, W, WORDS, case, jax_stokes_lanes,
                                  port_stokes_lanes, stokes_flips)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


def test_stokes_lanes_match_jax():
    """At most 0.1% of the lanes outside 1e-3 of the reference's; the
    image of `render_stokes` (two spp chunks) is the lanes' per-pixel mean,
    polarized (largest degree of polarization above 0.1) and physical (at
    most 1 + 1e-4 where S0 > 1e-3)."""
    sc, cam, sc_t, cam_t = case("rgb")
    ref = jax_stokes_lanes(sc, cam, 4)
    lanes = port_stokes_lanes(sc_t, cam_t, 4)
    assert lanes.shape == (H * W * SPP, 3, 4) and np.isfinite(lanes).all()
    flip = stokes_flips(lanes, ref, 1e-3)
    assert flip.mean() <= 1e-3, (int(flip.sum()), np.abs(lanes - ref).max())
    img = TP.render_stokes(sc_t, cam_t, TF.Film(H, W, 3), WORDS, spp=SPP,
                           max_depth=4, max_lanes=H * W).numpy()
    assert img.shape == (H, W, 4, 3)
    # render_stokes keys its one pass on fold_in(key, 0), as the reference
    folded = port_stokes_lanes(sc_t, cam_t, 4, seed=fold_in(WORDS, 0))
    mean = folded.reshape(H, W, SPP, 3, 4).mean(2).transpose(0, 1, 3, 2)
    np.testing.assert_allclose(img, mean, rtol=1e-5, atol=1e-6)
    s0 = img[:, :, 0]
    dop = np.linalg.norm(img[:, :, 1:], axis=2) / np.maximum(s0, 1e-6)
    lit = s0 > 1e-3
    assert dop[lit].max() <= 1.0 + 1e-4 and dop[lit].max() > 0.1


def test_s0_equals_scalar_render():
    """On a depolarizing scene (every material diffuse, no filters, no
    point light) S0 equals the scalar path's lanes (the same K2/K3/K14
    lookups and estimators; within 1e-6 relative, floor 1e-3) and S1..S3
    are exactly 0."""
    _, _, sc_t, cam_t = case("rgb", depolarizing=True)
    lanes = port_stokes_lanes(sc_t, cam_t, 4)
    scalar = TI._lane_radiance(sc_t, cam_t, TF.Film(H, W, 3), WORDS, SPP, 0,
                               SPP, 4, 1000, "rgb", 0, H,
                               kinds=TB.table_kinds(sc_t.bsdfs)).numpy()
    assert scalar.max() > 0
    err = np.abs(lanes[..., 0] - scalar) / np.maximum(np.abs(scalar), 1e-3)
    assert err.max() <= 1e-6, err.max()
    assert (lanes[..., 1:] == 0).all()


def test_render_stokes_refuses_what_the_reference_drops():
    """R16: directional lights, spot lights, directional-area emitters,
    media, an SDF grid and curves; R18: an opacity below 1 and the null
    kind; a normal map. Each raises NotImplementedError naming its cause;
    a kind-18 row without its dataset raises ValueError; the scene itself
    renders. R18 is shown in the reference's own weights."""
    _, _, sc, cam = case("rgb")
    film = TF.Film(4, 4, 3)
    kw = dict(spp=1, max_depth=2)
    TP.render_stokes(sc, cam, film, 1, **kw)
    spot = TE.make_spot([0.0, 0.0, 3.0], [0.0, 0.0, -1.0], [1.0] * 3,
                        device="cpu")
    fog = TMD.make_medium([0.5, 0.5, 0.5], [0.8, 0.8, 0.8], device="cpu")
    n_shapes = sc.shapes.to_world.shape[0]
    for cause, bad in (
            ("directional", sc._replace(directional_lights=torch.tensor(
                [[0.0, 0.0, -1.0, 1.0, 1.0, 1.0]]))),
            ("spot", sc._replace(spot_lights=(spot,))),
            ("directional-area", sc._replace(
                dir_area_radiance=torch.ones((n_shapes, 3)),
                dir_area_lit=True)),
            ("medium", sc._replace(medium=fog)),
            ("SDF", sc._replace(sdf=TSD.make_sdf_grid(
                TSD.sphere_sdf_grid(8, 0.3), device="cpu"))),
            ("curves", sc._replace(curve=TCV.make_curve_table([dict(
                points=[[0, 0, 0.5], [0, 1, 0.5]], kind="linear")],
                device="cpu")))):
        with pytest.raises(NotImplementedError, match=f"R16.*{cause}"):
            TP.render_stokes(bad, cam, film, 1, **kw)
    b = sc.bsdfs
    for bad in (b._replace(opacity=b.opacity * 0.5, host_mask=True),
                b._replace(host_kind=b.host_kind + (6,))):
        with pytest.raises(NotImplementedError, match="R18"):
            TP.render_stokes(sc._replace(bsdfs=bad), cam, film, 1, **kw)
    with pytest.raises(ValueError, match="measured_pol dataset"):
        TP.render_stokes(sc._replace(bsdfs=b._replace(
            host_kind=b.host_kind + (18,))), cam, film, 1, **kw)
    with pytest.raises(NotImplementedError, match="normal-mapped"):
        TP.render_stokes(sc._replace(
            textures=object(), bsdfs=b._replace(host_normal_maps=True)),
            cam, film, 1, **kw)
    with pytest.raises(NotImplementedError, match="R18"):
        TP.stokes_lanes(sc._replace(bsdfs=b._replace(host_mask=True)), cam,
                        TF.Film(4, 4, 12), 1, 1, 0, 1, 2, 1000)
    # R18 in the reference: a lane passing straight through a mask of
    # opacity 0.5 (sample1 0.9) keeps scalar weight 1, but its Mueller
    # weight is pplastic's all zeros, the conductor's reflection Fresnel
    # (off-diagonal 0.90) and diffuse's depolarizer, not the identity
    wi = jnp.asarray([[0.3, 0.1, 0.95]])
    wi = wi / jnp.linalg.norm(wi)
    got = {}
    for kind in (11, 2, 0):
        t = JB.make_material_table(kinds=[kind], albedos=[[0.5] * 3],
                                   opacities=[0.5])
        kinds = JB.table_kinds(t)
        idx = jnp.zeros((1,), jnp.int32)

        # one program a kind: op by op, the first kind's dispatch alone
        # compiled for ~9 s
        @jax.jit
        def sample_weight(t, idx, wi):
            wo, w, pdf, _ = JB.sample(t, idx, wi, jnp.asarray([[0.3, 0.6]]),
                                      jnp.asarray([0.9]), None, kinds=kinds)
            return wo, w, JP._pol_weight_sample(t, idx, wi, wo, w, pdf, kinds)
        wo, w, m = sample_weight(t, idx, wi)
        np.testing.assert_allclose(np.asarray(wo), -np.asarray(wi),
                                   rtol=1e-6)
        assert (np.asarray(w) == 1.0).all()
        got[kind] = np.asarray(m)[0, 0]
    assert (got[11] == 0).all()
    off = got[2] - np.diag(np.diag(got[2]))
    assert got[2][0, 0] == pytest.approx(1.0) and np.abs(off).max() > 0.89
    assert got[0][0, 0] == 1.0 and (got[0][1:, 1:] == 0).all()
