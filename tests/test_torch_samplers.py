"""The port's samplers (`tpusky_torch.render.sampler`) against the JAX
package's, bitwise: every kind, threefry included, at spp 8, 9 and 6
(so that multijitter and orthogonal fall back to stratified where they
must), at the dims the renderer draws first (10_000 the pixel position,
10_001 the lens, 20_000 the wavelength).

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusky.render import sampler as JSM

from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.render import sampler as TSM
from tpusky_torch.render.scene import make_scene
from tpusky_torch.render.sensors import make_perspective
from tpusky_torch.render.emitters import ConstantEnv

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

KEY = jax.random.PRNGKey(7)
WORDS = np.asarray(jax.random.key_data(KEY))
N = 4096
SPPS = (8, 9, 6)
DIMS = ((10_000, 2), (10_001, 2), (20_000, 1))


def test_every_kind_bitwise_equal_to_jax():
    """All of VALID_KINDS at each spp and dim, one jitted JAX program for
    the whole sweep (XLA's compile of the reference: its divisions by a
    constant become products by the reciprocal, and orthogonal's
    strata a fused multiply-add, which the port reproduces)."""
    assert TSM.VALID_KINDS == JSM.VALID_KINDS
    rng = np.random.default_rng(5)
    pixel = rng.integers(0, 2 ** 31, N, dtype=np.int64)
    pixel[:16] = np.arange(16)
    cases = [(kind, spp, dim, n) for kind in JSM.VALID_KINDS
             for spp in SPPS for dim, n in DIMS]

    @jax.jit
    def ref(key, p):
        return [JSM.lane_samples(kind, key, p, p % jnp.uint32(spp), spp,
                                 dim, n) for kind, spp, dim, n in cases]
    refs = ref(KEY, pixel.astype(np.uint32))
    p = torch.tensor(pixel)
    for (kind, spp, dim, n), r in zip(cases, refs):
        out = TSM.lane_samples(kind, WORDS, p, p % spp, spp, dim, n)
        assert out.dtype == torch.float32 and out.shape == (N, n)
        np.testing.assert_array_equal(out.numpy(), np.asarray(r),
                                      err_msg=f"{kind} spp {spp} dim {dim}")


def test_no_stream_collision_across_adjacent_dims():
    """As tests/test_sampler.py:153: the streams of dim d, channel c never
    alias those of dim d + 1 (the port's draws are the reference's)."""
    pix = torch.arange(256)
    smp = torch.zeros(256, dtype=torch.int64)
    for kind in ("independent", "stratified", "qmc"):
        a = TSM.lane_samples(kind, WORDS, pix, smp, 4, 100_000, 3)
        b = TSM.lane_samples(kind, WORDS, pix, smp, 4, 100_001, 2)
        for ca in range(3):
            for cb in range(2):
                assert not torch.equal(a[:, ca], b[:, cb]), (kind, ca, cb)


def test_render_takes_every_kind_and_refuses_others():
    """render() runs every kind of VALID_KINDS (threefry with the key's
    words); an unknown kind raises ValueError, as the reference's
    lane_samples does (sampler.py:252), and threefry with an integer
    seed raises ValueError, since JAX's streams need the key's words."""
    scene = make_scene(shapes=[dict(kind=1, to_world=np.diag(
        [10.0, 10.0, 1.0, 1.0]), bsdf_idx=0)], env=ConstantEnv(
            torch.tensor([0.6, 0.7, 0.9])), device="cpu")
    sensor = make_perspective([0, -3, 2.0], [0, 0, 0.0], device="cpu")
    film = TF.Film(4, 4, 3)
    for kind in TSM.VALID_KINDS:
        img = TI.render(scene, sensor, film, WORDS, spp=4,
                        sampler_kind=kind)
        assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())
        assert float(img.mean()) > 0.0, kind
    with pytest.raises(ValueError, match="unknown sampler"):
        TI.render(scene, sensor, film, 1, spp=4, sampler_kind="sobol")
    with pytest.raises(ValueError, match="two uint32 words"):
        TI.render(scene, sensor, film, 1, spp=4, sampler_kind="threefry")
    with pytest.raises(ValueError, match="unknown sampler"):
        TSM.lane_samples("halton", 1, torch.zeros(4, dtype=torch.int64),
                         torch.zeros(4, dtype=torch.int64), 4, 0, 2)
