"""`envmap_lit` (tools/gen_scene_goldens.py:207-227: a 16x32 bitmap sky
lighting a sphere, depth 2) rendered by the port at 48x48x16 and
Z-tested on the CPU against tests/golden/scene_goldens.npz, as
tests/test_render_regression.py holds the reference; and the megakernel
K4's gate, which refuses the envmap, every material kind this slice
adds and an opacity mask.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import numpy as np
import torch

import tpusky_torch as tt
from tools.torch_scene_goldens import build, envmap_lit_bitmap, golden
from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import emitters as TE
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.render.scene import make_scene
from tpusky_torch.render.sensors import make_perspective
from tpusky_torch.utils import ztest as TZ

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


def test_envmap_lit_golden_ztest():
    """48x48 at 16 spp, the Z-test at the reference's alpha with the
    Sidak correction; the image lit and finite."""
    scene, sensor, depth, mode = build("envmap_lit", device="cpu")
    mean, var, size, golden_depth = golden("envmap_lit")
    assert golden_depth == depth
    img = TI.render(scene, sensor, TF.Film(size, size, 3), 1234, spp=16,
                    max_depth=depth, mode=mode).numpy()
    assert img.shape == (size, size, 3) and img.mean() > 0.01
    ok, n_failed, min_p, alpha = TZ.z_test(img, 16, mean, var)
    assert ok, (f"{n_failed} pixels failed the Z-test (min p={min_p:.3g}, "
                f"alpha_corr={alpha:.3g})")


def test_megakernel_rules_refuse_envmap_kinds_and_masks():
    """The headline-like diffuse scene is eligible; the envmap, each kind
    of 4, 5, 6, 8, 9, 10 and 15, and a mask of opacity 0.5 on the diffuse
    row each make it ineligible (the gate compares `table_kinds` with
    ((0,), False))."""
    state = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=[0.3, 0.2, 0.93],
        device="cpu"))
    sensor = make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device="cpu")
    shapes = [dict(kind=1, to_world=np.diag([10.0, 10.0, 1.0, 1.0]),
                   bsdf_idx=0),
              dict(kind=0, to_world=np.eye(4), bsdf_idx=1)]

    def eligible(env=state, **kw):
        scene = make_scene(shapes=shapes, env=env,
                           bsdf_albedos=[[0.5] * 3] * 2, device="cpu", **kw)
        return TI._megakernel_rules(scene, sensor, TF.Film(64, 64, 3), 4, 2,
                                    "rgb", "independent",
                                    TB.table_kinds(scene.bsdfs), 1000)
    assert eligible()
    refused = {"envmap": eligible(TE.make_envmap(envmap_lit_bitmap(),
                                                 device="cpu")),
               "mask": eligible(bsdf_opacities=[1.0, 0.5])}
    for kind in (4, 5, 6, 8, 9, 10, 15):
        refused[f"kind {kind}"] = eligible(
            bsdf_kinds=[0, kind], bsdf_blend_children=[[0, 0], [0, 0]])
    assert [k for k, ok in refused.items() if ok] == []
