"""The port's sensors (`tpusky_torch.render.sensors`) against the JAX
package's: every kind's rays on 4,096 film and lens samples, a batch of
three mixed sub-sensors among them, and the constructors.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusky.render import sensors as JS

from tpusky_torch import convert
from tpusky_torch.render import sensors as TS

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

N = 4096


def _jax_sensors():
    """One sensor of each kind, built by the JAX package."""
    persp = JS.make_perspective([4.0, -4.0, 2.0], [0.0, 0.0, 0.5],
                                fov_x_deg=50, aspect=1.5)
    thin = JS.ThinLens(persp.to_world, persp.fov_x_deg, persp.aspect,
                       jnp.float32(0.15), jnp.float32(5.5))
    ortho = JS.Orthographic(persp.to_world, jnp.float32(2.5))
    sph = JS.make_spherical([0.1, -0.2, 1.0])
    dist = JS.make_distant([0.3, -0.2, -0.9], center=[0.0, 0.5, 0.2],
                           radius=3.0, extent=2.0)
    meter = JS.RadianceMeter(jnp.asarray([0.0, 0.0, 2.0], jnp.float32),
                             jnp.asarray([0.0, 0.6, -0.8], jnp.float32))
    irr = JS.make_irradiancemeter([0.0, 0.0, 0.01], [0.1, 0.2, 0.97],
                                  half_extent=0.5)
    return {"perspective": persp, "thinlens": thin, "orthographic": ortho,
            "spherical": sph, "distant": dist, "radiancemeter": meter,
            "irradiancemeter": irr,
            "batch": JS.Batch((thin, sph, irr))}


def test_every_sensor_matches_jax():
    """Each kind's (origin, direction) within 1e-6 absolute of the JAX
    package's, with lens samples and without them (the lens centre);
    `takes_lens_sample` holds for the thin lens, the irradiance meter and
    the batch holding them, and the reference's rays of every other kind
    ignore the lens sample, so the renderer may skip its draw."""
    rng = np.random.default_rng(2)
    uv = rng.random((N, 2), dtype=np.float32)
    lens = rng.random((N, 2), dtype=np.float32)
    sensors = _jax_sensors()
    refs = jax.jit(lambda ss, uv, lens: {
        name: (JS.sample_ray(s, uv, lens), JS.sample_ray(s, uv))
        for name, s in ss.items()})(sensors, uv, lens)
    for name, js in sensors.items():
        ts = convert.sensor(jax.tree.map(np.asarray, js), device="cpu")
        takes = TS.takes_lens_sample(ts)
        assert takes == (name in ("thinlens", "irradiancemeter", "batch"))
        if not takes:
            for a, b in zip(*refs[name]):
                assert np.array_equal(np.asarray(a), np.asarray(b)), name
        for lens_uv, ref in zip((lens, None), refs[name]):
            out = TS.sample_ray(ts, torch.tensor(uv),
                                None if lens_uv is None
                                else torch.tensor(lens_uv))
            for a, b in zip(out, ref):
                assert a.shape == (N, 3), name
                err = np.abs(a.numpy() - np.asarray(b)).max()
                assert err <= 1e-6, (name, lens_uv is None, err)


def test_constructors_match_jax():
    """The host constructors build the reference's float32 frames:
    convert.sensor of each JAX sensor equals the port's make_* of the
    same arguments, field for field."""
    pairs = [
        (JS.make_perspective([1, 2, 3], [0, 0, 0.5], fov_x_deg=30,
                             aspect=2.0),
         TS.make_perspective([1, 2, 3], [0, 0, 0.5], fov_x_deg=30,
                             aspect=2.0, device="cpu")),
        (JS.make_spherical([0.5, 0.0, 1.0]),
         TS.make_spherical([0.5, 0.0, 1.0], device="cpu")),
        (JS.make_distant([0.0, 0.0, -1.0], center=[1, 0, 0], radius=2.0),
         TS.make_distant([0.0, 0.0, -1.0], center=[1, 0, 0], radius=2.0,
                         device="cpu")),
        (JS.make_distant([0.2, 0.5, -0.6], extent=3.0),
         TS.make_distant([0.2, 0.5, -0.6], extent=3.0, device="cpu")),
        (JS.make_irradiancemeter([0, 1, 0], [0, 0, 1], half_extent=2.0),
         TS.make_irradiancemeter([0, 1, 0], [0, 0, 1], half_extent=2.0,
                                 device="cpu")),
    ]
    for js, ts in pairs:
        conv = convert.sensor(jax.tree.map(np.asarray, js), device="cpu")
        assert type(conv) is type(ts)
        for f in ts._fields:
            np.testing.assert_array_equal(getattr(conv, f).numpy(),
                                          getattr(ts, f).numpy(),
                                          err_msg=f"{type(ts).__name__}.{f}")
    with pytest.raises(TypeError, match="unknown sensor"):
        TS.sample_ray(object(), torch.zeros(4, 2))
