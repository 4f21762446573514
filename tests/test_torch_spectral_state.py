"""The port's spectral state against the JAX package's: the mode it
infers, the kernels' table packing, and K9-K11's wrappers taking their
plain versions for CPU tensors.

Both run on the CPU from the same numpy-seeded inputs (split from
tests/test_torch_spectral.py; shared code in `torch_spectral_case.py`).
At most 3 items, so that pytest-xdist's `--dist loadfile` hands this file
out after tests/test_multihost.py.
"""

import numpy as np
import torch

import tpusky_torch as tt
from tpusky.ops.pallas import sunsky_kernel as JK
from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.ops.cuda import build
from tpusky_torch.ops.cuda import sunsky_kernel as TK

from torch_spectral_case import (  # noqa: F401 (shared names, fixtures)
    SUN, _STATE_FIELDS, _lanes, _leaves, jax_precompute, states)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


def test_precompute_infers_spectral_mode(states):
    """`sunsky_precompute` without a mode takes the one the params were
    built for, as the reference package's does (an 11-channel albedo means
    spectral): leaf for leaf the call with mode="spectral", and within the
    bar of test_precompute_spectral_matches_jax of JAX's state; RGB params
    still give the RGB state."""
    _, conv = states
    kw = dict(turbidity=5.2, albedo=0.25, sun_direction=SUN, device="cpu")
    params = tt.make_params(**kw, mode="spectral")
    st = tt.sunsky_precompute(params)
    for a, b in zip(_leaves(st), _leaves(tt.sunsky_precompute(
            params, mode="spectral")), strict=True):
        assert (a is None and b is None) or torch.equal(a, b)
    for f in _STATE_FIELDS:
        a, b = getattr(st, f).numpy(), getattr(conv, f).numpy()
        assert a.shape == b.shape, f
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), f
    rgb_params = tt.make_params(**kw)
    rgb = tt.sunsky_precompute(rgb_params)
    assert rgb.sun_ld is None and tuple(rgb.sky_params.shape) == (3, 9)
    for a, b in zip(_leaves(rgb), _leaves(tt.sunsky_precompute(
            rgb_params, mode="rgb")), strict=True):
        assert (a is None and b is None) or torch.equal(a, b)


def test_kernel_table_packing_matches_jax(states):
    js, st = states
    np.testing.assert_allclose(TK._misc_row_spec(st).numpy(),
                               np.asarray(JK._misc_row_spec(js))[0],
                               rtol=1e-6, atol=1e-7)
    tables = TK.pack_tables_spec(st, torch.device("cpu"))
    assert [tuple(t.shape) for t in tables] == [
        (11, 9), (11,), (45, 44), (11, 6), (16,), (14, 20)]


def test_spectral_wrappers_take_plain_versions_on_cpu(states):
    _, st = states
    d, wl = (torch.tensor(x) for x in _lanes(np.asarray(st.sun_frame_n), 4,
                                             7))
    u2 = torch.rand(64, 2, generator=torch.Generator().manual_seed(0))
    build.reset_launches()
    assert torch.equal(TK.sunsky_eval_spec(st, d, wl),
                       TM._eval_spec_plain(st, d, wl))
    for a, b in zip(TK.sunsky_hit_spec(st, d, wl),
                    TM._hit_spec_plain(st, d, wl)):
        assert torch.equal(a, b)
    for a, b in zip(TK.sunsky_nee_spec(st, u2, wl[:64]),
                    TM._sample_eval_spec_plain(st, u2, wl[:64])):
        assert torch.equal(a, b)
    assert all(v == 0 for v in build.launches.values())
    assert build.library.cache_info().currsize == 0
