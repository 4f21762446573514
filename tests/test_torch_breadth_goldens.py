"""The port renders the three scene goldens that need the path tracer's
breadth, Z-tested on the CPU against tests/golden/scene_goldens.npz (as
tests/test_render_regression.py holds the reference): `constant_cube_gi`
(a cube under a ConstantEnv, depth 4), `area_light` (a rectangle area
emitter, no environment) and `dielectric_sphere` (a smooth dielectric
under an area panel, depth 6), built by tools/torch_scene_goldens.py.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import pytest
import torch

from tools.torch_scene_goldens import build, golden
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.utils import ztest as TZ

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

SPP = 16
SEED = 1234


@pytest.mark.parametrize("name", ["constant_cube_gi", "area_light",
                                  "dielectric_sphere"])
def test_breadth_golden_ztest(name):
    """48x48 at 16 spp, the Z-test at the reference's alpha with the
    Sidak correction; the image lit and finite."""
    scene, sensor, depth, mode = build(name, device="cpu")
    mean, var, size, golden_depth = golden(name)
    assert golden_depth == depth
    img = TI.render(scene, sensor, TF.Film(size, size, 3), SEED, spp=SPP,
                    max_depth=depth, mode=mode).numpy()
    assert img.shape == (size, size, 3) and img.mean() > 0.01
    ok, n_failed, min_p, alpha = TZ.z_test(img, SPP, mean, var)
    assert ok, (f"{name}: {n_failed} pixels failed the Z-test (min "
                f"p={min_p:.3g}, alpha_corr={alpha:.3g})")
