"""The port's chi-square adapters (`tpusky_torch/utils/chi2.py`:
`EmitterAdapter`, `BSDFAdapter`) on the CPU, as the reference's
tests/test_distr2d.py runs its own: an environment's and a material's
sampling against their pdfs, each p >= 0.01.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import numpy as np
import torch

from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import emitters as TE
from tpusky_torch.utils.chi2 import BSDFAdapter, EmitterAdapter

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


def test_emitter_adapter():
    """A ConstantEnv (the uniform sphere) and a 16x32 envmap with a
    bright patch under a rotated frame, at N = 5e5 over the sphere."""
    bm = np.random.default_rng(1).uniform(0.0, 2.0, (16, 32, 3))
    bm[4:6, 20:23] = 40.0
    rot = np.array([[0.0, -1.0, 0.0], [0.6, 0.0, -0.8], [0.8, 0.0, 0.6]])
    for env, e2w in ((TE.ConstantEnv(torch.ones(3)), None),
                     (TE.make_envmap(bm, device="cpu"), rot)):
        p, ok, info = EmitterAdapter(env, e2w).run(
            seed=1, sample_count=500_000, batch=250_000)
        assert ok and abs(info["integral"] - 1.0) < 2e-3, (p, info)


def test_bsdf_adapter():
    """A diffuse row and a principled row (metallic 0.3, clearcoat 1) at
    an oblique wi, at N = 5e5 over the upper hemisphere; then the
    plastic's base, whose delta coat the adapter counts outside the
    domain: the histogram holds the base, and the pdf integrates to its
    share."""
    extras = [[0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
              [0.3, 0.5, 0.2, 0.3, 1.0, 0.6, 0.1, 0.0],
              [0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]]
    table = TB.make_material_table(
        kinds=[TB.DIFFUSE, TB.PRINCIPLED, TB.PLASTIC],
        albedos=[[0.8, 0.8, 0.8], [0.8, 0.6, 0.3], [0.5, 0.3, 0.2]],
        alphas=[0.1, 0.4, 0.1], extras=extras, device="cpu")
    wi = [0.3, 0.1, 0.95]
    for row in (0, 1, 2):
        p, ok, info = BSDFAdapter(table, row, wi).run(
            seed=2, sample_count=500_000, batch=250_000)
        assert ok, (row, p, info)
    # the coat takes F(cos_i) ~ 4% of the plastic's samples
    assert info["miss_frac"] > 0.02
    assert abs(info["integral"] - (1.0 - info["miss_frac"])) < 2e-3, info
