"""What the path tracer's breadth may not reach: the megakernel K4's gate
refuses every new feature (the reference's rules,
tpusky/render/integrator.py:955-968, with the shape kinds pinned to the
sphere, rectangle and disk), and spectral mode renders the emitters that
need the reference's rgb2spec upsampling and refuses what is not ported.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import numpy as np
import pytest
import torch

import tpusky_torch as tt
from tpusky_torch.render import emitters as TE
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.render.scene import make_scene, with_emitter_coeffs
from tpusky_torch.render.sensors import make_perspective

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

SHAPES = [dict(kind=1, to_world=np.diag([10.0, 10.0, 1.0, 1.0]),
               bsdf_idx=0),
          dict(kind=0, to_world=np.eye(4), bsdf_idx=0),
          dict(kind=2, to_world=np.eye(4), bsdf_idx=0)]


def _scene(env, shapes=SHAPES, **kw):
    return make_scene(shapes=shapes, env=env, device="cpu", **kw)


def test_megakernel_rules_refuse_breadth():
    """The headline-like scene is eligible; a cube, a cylinder, an area
    emitter, shapes that emit, a point, a directional or a spot light, a
    constant, uniform or no environment each make it ineligible."""
    state = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=[0.3, 0.2, 0.93],
        device="cpu"))
    sensor = make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device="cpu")
    film = TF.Film(64, 64, 3)

    def eligible(scene):
        return TI._megakernel_rules(scene, sensor, film, 4, 2, "rgb",
                                    "independent", ((0,), False), 1000)
    assert eligible(_scene(state))
    rad = np.zeros((4, 3), np.float32)
    rad[3] = 5.0
    panel = dict(kind=1, to_world=np.eye(4), bsdf_idx=0, emitter_idx=0)
    refused = {
        "cube": _scene(state, SHAPES + [dict(kind=3, bsdf_idx=0)]),
        "cylinder": _scene(state, SHAPES + [dict(kind=4, bsdf_idx=0)]),
        "area emitter": _scene(state, SHAPES + [panel], area_radiance=rad),
        "emitting shape": _scene(state, SHAPES + [dict(kind=1, bsdf_idx=0)],
                                 area_radiance=rad),
        "point light": _scene(state, point_lights=[[0, 0, 3, 1, 1, 1]]),
        "directional light": _scene(state,
                                    directional_lights=[[0, 0, -1, 1, 1, 1]]),
        "spot light": _scene(state, spot_lights=[TE.make_spot(
            [0, 0, 3], [0, 0, -1], [1, 1, 1], device="cpu")]),
        "constant env": _scene(TE.ConstantEnv(torch.ones(3))),
        "uniform env": _scene(TE.UniformEnv(torch.ones(3))),
        "no env": _scene(None),
    }
    assert [k for k, sc in refused.items() if eligible(sc)] == []


def test_spectral_refuses_rgb2spec_emitters():
    """A ConstantEnv, area emitters and delta lights render in spectral
    mode, upsampled by rgb2spec (once a render: `with_emitter_coeffs`),
    as do a UniformEnv and no environment; the fitted coefficients follow
    the emitters they were fitted from (refitted after an emitter tensor
    is replaced or changed in place); what spectral mode still refuses is
    a kind the reference does not have (NotImplementedError) and an
    unknown sensor (TypeError), while the polarized kinds 11-14 and hair
    render."""
    sensor = make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device="cpu")
    film = TF.Film(4, 4, 3)
    rad = np.zeros((4, 3), np.float32)
    rad[3] = 5.0
    panel = dict(kind=1, to_world=np.eye(4), bsdf_idx=0, emitter_idx=0)
    for scene in (_scene(TE.ConstantEnv(torch.ones(3))),
                  _scene(None, SHAPES + [panel], area_radiance=rad),
                  _scene(None, point_lights=[[0, 0, 3, 1, 1, 1]]),
                  _scene(TE.UniformEnv(torch.ones(3))), _scene(None)):
        img = TI.render(scene, sensor, film, 1, spp=1, mode="spectral")
        assert bool(torch.isfinite(img).all())
    sc = _scene(None, point_lights=[[0, 0, 3, 1, 1, 1]])
    white = TE.ConstantEnv(torch.ones(3))
    fit = with_emitter_coeffs(sc._replace(
        env=white, point_lights=sc.point_lights.clone()))
    assert with_emitter_coeffs(fit) is fit
    red = torch.tensor([[0, 0, 3, 2.0, 0.2, 0.1]])
    want = with_emitter_coeffs(sc._replace(env=white, point_lights=red))
    assert not torch.equal(want.emitter_coeffs.point, fit.emitter_coeffs.point)
    replaced = fit._replace(point_lights=red.clone())
    fit.point_lights.copy_(red)                 # changed in place
    for stale in (replaced, fit):
        assert torch.equal(with_emitter_coeffs(stale).emitter_coeffs.point,
                           want.emitter_coeffs.point)
    with torch.inference_mode():
        frozen = with_emitter_coeffs(_scene(
            None, point_lights=[[0, 0, 3, 1, 1, 1]]))
        assert with_emitter_coeffs(frozen) is frozen
    blue = fit._replace(env=fit.env._replace(radiance=torch.tensor(
        [0.1, 0.2, 2.0])))
    assert not torch.equal(with_emitter_coeffs(blue).env.coeff,
                           fit.env.coeff)
    with pytest.raises(NotImplementedError):
        TI.render(sc._replace(bsdfs=sc.bsdfs._replace(host_kind=(0, 19))),
                  sensor, film, 1, spp=1, mode="spectral")
    img = TI.render(sc._replace(bsdfs=sc.bsdfs._replace(
        host_kind=(0, 11, 12, 13, 14, 16))), sensor, film, 1, spp=1,
        mode="spectral")
    assert bool(torch.isfinite(img).all())
    with pytest.raises(TypeError, match="unknown sensor"):
        TI.render(sc, object(), film, 1, spp=1, mode="spectral")
