"""The port's media: the `medium_sphere` scene golden Z-tested on the CPU
against tests/golden/scene_goldens.npz (as tests/test_render_regression.py
holds the reference), a fog scene carried over by `convert.scene`, and
the refusals: R13 (a medium beside area or delta lights), R14 (a
spectral render of a medium of more than one channel) and K4's gate.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import jax
import numpy as np
import pytest
import torch

from tpusky.render.scene import make_scene as jax_make_scene

from tools.torch_scene_goldens import build, golden
import tpusky_torch as tt
from tpusky_torch import convert
from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.render import medium as TMD
from tpusky_torch.render.scene import make_scene
from tpusky_torch.utils import ztest as TZ

from torch_breadth_case import camera, port
from torch_medium_case import GROUND, fog_scene

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

SPP = 16
SEED = 1234


def test_medium_sphere_golden_ztest():
    """48x48 at 16 spp, depth 6, the Z-test at the reference's alpha with
    the Sidak correction; the image lit and finite."""
    scene, sensor, depth, mode = build("medium_sphere", device="cpu")
    mean, var, size, golden_depth = golden("medium_sphere")
    assert golden_depth == depth
    img = TI.render(scene, sensor, TF.Film(size, size, 3), SEED, spp=SPP,
                    max_depth=depth, mode=mode).numpy()
    assert img.shape == (size, size, 3) and img.mean() > 0.01
    ok, n_failed, min_p, alpha = TZ.z_test(img, SPP, mean, var)
    assert ok, (f"medium_sphere: {n_failed} pixels failed the Z-test (min "
                f"p={min_p:.3g}, alpha_corr={alpha:.3g})")


def test_convert_carries_media_and_bounds():
    """`convert.scene` of the fog scene: both regions with their static
    fields and tensors, the bounding sphere, and a directional-area
    radiance with its host flag; `make_scene`'s bounding sphere is the
    reference's."""
    sc_j = fog_scene()
    sc_t, _ = port(sc_j, camera())
    assert isinstance(sc_t.medium, tuple) and len(sc_t.medium) == 2
    for mj, mt in zip(sc_j.medium, sc_t.medium):
        assert (mt.kind, mt.n_steps, mt.phase, mt.channel_mis) == (
            mj.kind, mj.n_steps, mj.phase, mj.channel_mis)
        for f in TMD.Medium._fields[:9]:
            a, b = getattr(mt, f), getattr(mj, f)
            assert (a is None) == (b is None), f
            if a is not None:
                assert np.array_equal(a.numpy(), np.asarray(b)), f
    assert np.array_equal(sc_t.bsphere_center.numpy(),
                          np.asarray(sc_j.bsphere_center))
    assert float(sc_t.bsphere_radius) == float(sc_j.bsphere_radius)
    assert sc_t.dir_area_radiance is None and not sc_t.dir_area_lit
    shapes = [dict(kind=1, to_world=GROUND, bsdf_idx=0),
              dict(kind=0, to_world=np.eye(4), bsdf_idx=0)]
    dar = np.zeros((2, 3), np.float32)
    dar[1] = [1.0, 0.5, 0.2]
    sc_j = jax_make_scene(shapes=shapes, dir_area_radiance=dar)
    sc_t = convert.scene(jax.tree.map(np.asarray, sc_j), device="cpu")
    own = make_scene(shapes=shapes, dir_area_radiance=dar, device="cpu")
    for s in (sc_t, own):
        assert s.dir_area_lit and np.array_equal(s.dir_area_radiance.numpy(),
                                                 dar)
        assert np.array_equal(s.bsphere_center.numpy(),
                              np.asarray(sc_j.bsphere_center))
        assert float(s.bsphere_radius) == float(sc_j.bsphere_radius)


def test_media_refusals():
    """R13: a medium beside an area emitter or any delta light raises
    NotImplementedError naming R13; R14: a spectral render of a
    three-channel medium names R14 (one channel renders); K4's gate
    refuses a medium scene that it takes without the medium."""
    med = TMD.make_medium([0.5], [0.8], kind="global", device="cpu")
    sensor = convert.perspective(jax.tree.map(np.asarray, camera()),
                                 device="cpu")
    film = TF.Film(4, 4, 3)
    rad = np.zeros((2, 3), np.float32)
    rad[1] = 5.0
    panel = np.diag([0.5, 0.5, 1.0, 1.0]).astype(np.float32)
    panel[2, 3] = 3.0
    lights = [dict(area_radiance=rad), dict(point_lights=[[0, 0, 3, 1, 1, 1]]),
              dict(directional_lights=[[0, 0, -1, 1, 1, 1]])]
    for kw in lights:
        shapes = [dict(kind=1, to_world=GROUND, bsdf_idx=0),
                  dict(kind=1, to_world=panel, bsdf_idx=0,
                       emitter_idx=0 if "area_radiance" in kw else -1)]
        sc = make_scene(shapes=shapes, medium=med, device="cpu", **kw)
        with pytest.raises(NotImplementedError, match="R13"):
            TI.render(sc, sensor, film, 1, spp=1, max_depth=2)
        TI.render(sc._replace(medium=None), sensor, film, 1, spp=1,
                  max_depth=2)
    state = tt.sunsky_precompute(tt.make_params(
        mode="spectral", device="cpu"), mode="spectral")
    sc = make_scene(shapes=[dict(kind=1, to_world=GROUND, bsdf_idx=0)],
                    env=state, device="cpu",
                    medium=TMD.make_medium([0.5, 0.6, 0.7], [0.8] * 3,
                                           kind="global", device="cpu"))
    with pytest.raises(NotImplementedError, match="R14"):
        TI.render(sc, sensor, film, 1, spp=1, max_depth=2, mode="spectral")
    img = TI.render(sc._replace(medium=med), sensor, film, 1, spp=1,
                    max_depth=2, mode="spectral")
    assert torch.isfinite(img).all()

    state = tt.sunsky_precompute(tt.make_params(device="cpu"))
    sc = make_scene(shapes=[dict(kind=1, to_world=GROUND, bsdf_idx=0)],
                    env=state, device="cpu")
    args = (sensor, TF.Film(8, 8, 3), 4, 2, "rgb", "independent",
            TB.table_kinds(sc.bsdfs), 1000)
    assert TI._megakernel_rules(sc, *args)
    assert not TI._megakernel_rules(sc._replace(medium=med), *args)
    assert not TI._megakernel_rules(sc._replace(medium=(med, med)), *args)
