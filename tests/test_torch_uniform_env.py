"""The port's environments against the JAX package on the CPU: a
UniformEnv lighting the wavefront, lane by lane at 16x16x2, in RGB and
in spectral mode (a flat spectrum: the channels' mean at every hero
wavelength, with no rgb2spec upsampling); and the environment functions
of the sunsky, a ConstantEnv and a UniformEnv.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusky.render import bsdf as JB
from tpusky.render import emitters as JE
from tpusky.render.emitters import ConstantEnv, UniformEnv
from tpusky.render.scene import make_scene

from torch_breadth_case import (camera, jax_lanes, port, port_lanes,
                                share_outside, sunsky_state, translate)
from tpusky_torch import convert
from tpusky_torch.render import emitters as TE

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["rgb", "spectral"])
def test_uniform_env_lanes_match_jax(mode):
    """A rough-conductor sphere and a diffuse cube on a diffuse ground
    under UniformEnv(0.8), depth 3: >= 99.9% of lanes within 1e-3
    relative (floor 1e-3), the bar of tests/test_torch_render.py."""
    sc_j = make_scene(
        shapes=[dict(kind=1, to_world=np.diag([10.0, 10.0, 1.0, 1.0]),
                     bsdf_idx=0),
                dict(kind=0, to_world=translate(np.eye(4), [0, 0, 1.0]),
                     bsdf_idx=1),
                dict(kind=3, to_world=translate(
                    np.diag([0.5, 0.5, 0.5, 1.0]), [1.3, 1.0, 0.5]),
                    bsdf_idx=0)],
        bsdf_albedos=[[0.5, 0.5, 0.5], [0.9, 0.7, 0.4]],
        bsdf_kinds=[JB.DIFFUSE, JB.ROUGH_CONDUCTOR], bsdf_alphas=[0.1, 0.2],
        env=UniformEnv(jnp.asarray([0.8, 0.8, 0.8])))
    sensor_j = camera()
    lanes_j = jax_lanes(sc_j, sensor_j, 3, 1000, mode)
    sc, sensor = port(sc_j, sensor_j)
    lanes = port_lanes(sc, sensor, 3, 1000, mode)
    assert (lanes_j.max(-1) > 0.05).mean() > 0.9
    assert share_outside(lanes, lanes_j) <= 1e-3


def test_environments_match_jax():
    """`env_eval`, `env_eval_pdf`, `env_sample_direction`,
    `env_pdf_direction` and `env_sample_eval` of a sunsky (under a rotated
    env_to_world), a ConstantEnv and a UniformEnv, against the reference's
    on 4,096 directions and uniforms. The constant ones within 1e-6; the
    sunsky at the bars of tests/test_torch_sunsky.py: directions within
    1e-5 but where a discrete pick flips on an ulp (at most 4 lanes),
    radiance within 1e-4 and pdfs within 1e-3 relative (floor 1e-3) on
    the other lanes."""
    rng = np.random.default_rng(2)
    c, s = np.cos(0.4), np.sin(0.4)
    e2w = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    u2 = rng.random((4096, 2), dtype=np.float32)
    rad = jnp.asarray([0.3, 0.6, 0.9])
    dt, ut, et = torch.tensor(d), torch.tensor(u2), torch.tensor(e2w)
    for env_j in (sunsky_state(), ConstantEnv(rad), UniformEnv(rad)):
        env_t = convert.environment(jax.tree.map(np.asarray, env_j),
                                    device="cpu")
        assert type(env_t).__name__ == type(env_j).__name__
        flat = not isinstance(env_j, JE.sunsky.SunskyState)
        ref = [np.asarray(x) for x in (
            JE.env_eval(env_j, d, e2w), *JE.env_eval_pdf(env_j, d, e2w),
            JE.env_pdf_direction(env_j, e2w, d),
            *JE.env_sample_direction(env_j, e2w, u2),
            *JE.env_sample_eval(env_j, e2w, u2))]
        out = [x.numpy() for x in (
            TE.env_eval(env_t, dt, et), *TE.env_eval_pdf(env_t, dt, et),
            TE.env_pdf_direction(env_t, et, dt),
            *TE.env_sample_direction(env_t, et, ut),
            *TE.env_sample_eval(env_t, et, ut))]
        far = (np.abs(out[4] - ref[4]).max(-1) > 1e-5) | \
            (np.abs(out[6] - ref[6]).max(-1) > 1e-5)
        assert far.sum() <= (0 if flat else 4)
        # radiance, pdf, pdf, direction, pdf, direction, radiance, pdf
        # directions absolute, the rest relative to max(|ref|, 1e-3)
        for i, (a, b, tol) in enumerate(zip(out, ref, (
                1e-4, 1e-4, 1e-3, 1e-3, 1e-5, 1e-3, 1e-5, 1e-4, 1e-3))):
            b = np.broadcast_to(b, a.shape)[~far]
            err = np.abs(a[~far] - b)
            if i not in (4, 6):
                err = err / np.maximum(np.abs(b), 1e-3)
            assert err.max() <= (1e-6 if flat else tol), i
