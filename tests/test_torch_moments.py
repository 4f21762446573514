"""The port's moment integrator and Z-test against the JAX package.

`tpusky_torch.render.integrator.render_moments` beside
`tpusky.render.integrator.render_moments` on `sunsky_sphere`
(`tools/gen_scene_goldens.py:55`, built by the port's own constructors in
`tools/torch_scene_goldens.py`) at 8x8x4, depth 2: the `independent`
sampler draws bitwise the same uniforms in both from the same seed, so
the two mean images agree per pixel. The port's `z_test` is a copy of the
reference's; its 48x48 render of the scene passes the Z-test against the
stored golden. The other goldens are Z-tested on the card (chip_smoke.py).
"""

import jax
import numpy as np
import pytest
import torch

import tpusky as ts
from tools.torch_scene_goldens import build, golden
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky.tables import load_tables as jax_load_tables
from tpusky.render import film as JF
from tpusky.render import integrator as JI
from tpusky.render import sensors as JS
from tpusky.render.scene import make_scene as jax_make_scene
from tpusky.utils import ztest as JZ

from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.utils import ztest as TZ

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

H = W = 8
SPP = 4
KEY = jax.random.PRNGKey(3)
# JAX's render_moments samples with fold_in(key, 0) (integrator.py:1082)
SEED = int(np.asarray(jax.random.key_data(jax.random.fold_in(KEY, 0)))[-1])


@pytest.fixture(scope="module")
def port_scene():
    return build("sunsky_sphere", device="cpu")


@pytest.fixture(scope="module")
def jax_moments():
    """JAX's moments of `tools/gen_scene_goldens.py::scene_sunsky_sphere`,
    its sunsky precomputed under jit (eagerly it takes seconds)."""
    env = jax.jit(lambda p: JM.precompute(jax_load_tables("rgb"), p, "rgb"))(
        ts.make_params(turbidity=3.0, albedo=0.3,
                       sun_direction=[0.3, 0.2, 0.93]))
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    sphere = np.eye(4, dtype=np.float32)
    sphere[2, 3] = 1.0
    scene = jax_make_scene(
        shapes=[dict(kind=1, to_world=ground, bsdf_idx=0),
                dict(kind=0, to_world=sphere, bsdf_idx=1)],
        bsdf_albedos=[[0.4, 0.4, 0.4], [0.6, 0.2, 0.2]], env=env)
    sensor = JS.make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45)
    mean, m2 = JI.render_moments(scene, sensor, JF.Film(H, W, 3), KEY,
                                 spp=SPP, max_depth=2)
    return np.asarray(mean), np.asarray(m2)


def test_render_moments_matches_jax(port_scene, jax_moments):
    """The mean within test_torch_render.py's bars (per pixel 1e-3
    relative, floor 1e-3, on all but 1e-3 of the pixels; the image 1e-3 of
    its scale), the second moment within 1e-3 of its scale."""
    scene, sensor, depth, mode = port_scene
    mean, m2 = TI.render_moments(scene, sensor, TF.Film(H, W, 3), SEED,
                                 spp=SPP, max_depth=depth, mode=mode)
    mean_j, m2_j = jax_moments
    assert mean.shape == m2.shape == (H, W, 3)
    rel = (np.abs(mean.numpy() - mean_j)
           / np.maximum(np.abs(mean_j), 1e-3)).max(-1)
    assert (rel > 1e-3).mean() <= 1e-3
    assert np.abs(mean.numpy() - mean_j).max() < 1e-3 * max(mean_j.max(), 1)
    assert np.abs(m2.numpy() - m2_j).max() <= 1e-3 * m2_j.max()
    assert mean_j.max() > 0.1
    # E[x^2] >= E[x]^2 per pixel
    assert bool((m2 >= mean * mean * (1 - 1e-6)).all())


@pytest.mark.parametrize("spp_chunk", [None, 2])
def test_render_moments_mean_is_render_rows(port_scene, spp_chunk,
                                            monkeypatch):
    """The mean is bitwise the developed `render_rows` image at the same
    seed, in one spp chunk or (both made to take chunks of 2) in two."""
    if spp_chunk is not None:
        monkeypatch.setattr(TI, "_spp_chunk", lambda *a: spp_chunk)
    scene, sensor, depth, mode = port_scene
    film = TF.Film(H, W, 3)
    mean, _ = TI.render_moments(scene, sensor, film, SEED, spp=SPP,
                                max_depth=depth, mode=mode)
    img = TF.develop(TI.render_rows(scene, sensor, film, SEED, SPP, depth,
                                    1000, mode, 0, H))
    assert torch.equal(mean, img)


@pytest.mark.parametrize("case", range(4))
def test_z_test_is_the_reference(case):
    """The port's numpy copy returns the reference's results: 3-D and 2-D
    images, with and without the boundary model, passing and failing."""
    rng = np.random.default_rng(case)
    shape = (12, 10, 3) if case < 3 else (12, 10)
    ref = rng.gamma(2.0, 0.5, size=shape)
    var = rng.gamma(1.0, 0.3, size=shape) * (rng.random(shape) > 0.2)
    spp = 16
    img = ref + rng.normal(size=shape) * np.sqrt(var / spp)
    if case == 2:
        img[3, 4] += 5.0           # a biased pixel, and a few more
        img[:2] *= 1.5
    kw = {"boundary_model": case != 1}
    assert TZ.z_test(img, spp, ref, var, **kw) == JZ.z_test(img, spp, ref,
                                                            var, **kw)


def test_sunsky_sphere_passes_golden_ztest(port_scene):
    """The port's 48x48 render at 16 spp, seed 1234, against the stored
    golden (tests/test_render_regression.py)."""
    scene, sensor, depth, mode = port_scene
    mean, var, size, golden_depth = golden("sunsky_sphere")
    assert golden_depth == depth
    img = TI.render(scene, sensor, TF.Film(size, size, 3), 1234, spp=16,
                    max_depth=depth, mode=mode).numpy()
    ok, n_failed, min_p, alpha = TZ.z_test(img, 16, mean, var)
    assert ok, (f"{n_failed} pixels failed the Z-test (min p={min_p:.3g}, "
                f"alpha_corr={alpha:.3g})")
