"""The port's spectral sunsky (`tpusky_torch`) against the JAX package:
the tables, the goldens of tests/test_sunsky_golden.py and the entry
points' devices. The tests that compile JAX programs are in files of at
most 3 items beside it, which pytest-xdist's `--dist loadfile` hands out
after tests/test_multihost.py: tests/test_torch_spectral_{eval_hit,
sample_eval}.py (K9-K11's plain versions), test_torch_spectral_{distr,
state,wrappers,precompute_t30,precompute_t35}.py and
test_torch_spectrum_{cie,colour,srgb,sampling}.py, with the shared code in
`torch_spectral_case.py`.

Both run on the CPU from the same numpy-seeded inputs; the port runs its
plain PyTorch versions, which the kernel wrappers take for CPU tensors.
"""

import jax
import numpy as np
import pytest
import torch

from tpusky.models.sunsky import tables as JT

import tpusky_torch as tt
from tpusky_torch import convert
from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.models.sunsky import tables as TT

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


def test_load_tables_spectral_bitwise():
    j = JT.load_tables("spectral")
    t = TT.load_tables("spectral", device="cpu")
    for f in ("sky_params", "sky_rad", "sun_rad", "sun_ld", "tgmm"):
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    assert tuple(t.sun_rad.shape) == (10, 45, 11, 4)
    assert tuple(t.sun_ld.shape) == (11, 6)
    conv = convert.sunsky_tables(jax.tree.map(np.asarray, j), device="cpu")
    for f in TT.SunskyTables._fields:
        assert torch.equal(getattr(conv, f), getattr(t, f))
    with pytest.raises(ValueError):
        TT.load_tables("bands", device="cpu")


# ---------------------------------------------------------------------------
# goldens (the bars of tests/test_sunsky_golden.py)
# ---------------------------------------------------------------------------

_H, _W = 32, 64
_SPEC_WL = np.broadcast_to(np.array([360 + 47 / 2 + i * 47 for i in range(10)],
                                    np.float32), (_H, _W, 10))


def _golden_directions():
    pg, tg = np.meshgrid(np.linspace(0, 2 * np.pi, _W),
                         np.linspace(np.pi, 0, _H))
    v = np.stack([np.cos(pg) * np.sin(tg), np.sin(pg) * np.sin(tg),
                  np.cos(tg)], -1).astype(np.float32)
    return torch.tensor(-v)


def _mean_rel_err(img, ref):
    return float(np.mean(np.abs(img - ref) / (np.abs(ref) + 0.001)))


def _sky(turbidity, albedo, sun):
    params = tt.make_params(turbidity=turbidity, albedo=albedo,
                            sun_direction=sun, sun_scale=0.0,
                            mode="spectral", device="cpu")
    state = tt.sunsky_precompute(params, mode="spectral")
    return tt.sunsky_eval(state, _golden_directions(), mode="spectral",
                          wavelengths=torch.tensor(_SPEC_WL)).numpy()


@pytest.mark.parametrize("eta,turb,key", [
    (np.deg2rad(2), 2, "sky_spec_eta0.035_t2.000_a0.000"),
    (np.deg2rad(20), 5.2, "sky_spec_eta0.349_t5.200_a0.000"),
    (np.deg2rad(45), 9.8, "sky_spec_eta0.785_t9.800_a0.000"),
])
def test_sky_radiance_spectral_golden(golden, eta, turb, key):
    st = np.pi / 2 - eta
    img = _sky(turb, 0.0, [np.sin(st), 0.0, np.cos(st)])
    assert _mean_rel_err(img, golden[key]) <= 0.037


def test_sky_radiance_spectral_irregular_albedo_golden(golden):
    albedo = np.array([0.56, 0.21, 0.58, 0.24, 0.92, 0.42, 0.53, 0.75,
                       0.54, 0.20, 0.46], np.float32)
    eta = np.deg2rad(60)
    img = _sky(4.2, albedo, [np.sin(np.pi / 2 - eta), 0.0,
                             np.cos(np.pi / 2 - eta)])
    assert _mean_rel_err(img, golden["sky_spectrum_special"]) <= 0.03


def test_sun_radiance_spectral_golden(golden):
    """All 80 golden sun spectra (5 turbidities x 4 elevations x 4 gammas)
    at test_sunsky_golden.py:92-126's bar."""
    eps = 1e-4
    half_ap = np.deg2rad(0.5388 / 2.0)
    wavelengths = torch.tensor(np.linspace(310, 800, 15).astype(np.float32))
    tables = TT.load_tables("spectral", device="cpu")
    worst = 0.0
    for turb in np.linspace(1, 10, 5):
        for eta_ray in np.linspace(eps, np.pi / 2 - eps, 4):
            for gamma in np.linspace(0, half_ap - eps, 4):
                phi = np.pi / 5
                theta_ray = np.pi / 2 - eta_ray
                sun_theta = theta_ray - gamma
                if sun_theta < 0:
                    sun_theta = theta_ray + gamma
                sd = [np.cos(phi) * np.sin(sun_theta),
                      np.sin(phi) * np.sin(sun_theta), np.cos(sun_theta)]
                params = TM.make_params(turbidity=turb, albedo=0.0,
                                        sun_direction=sd, sky_scale=0.0,
                                        mode="spectral", device="cpu")
                state = TM.precompute(tables, params, "spectral")
                d = torch.tensor([np.cos(phi) * np.sin(theta_ray),
                                  np.sin(phi) * np.sin(theta_ray),
                                  np.cos(theta_ray)], dtype=torch.float32)
                res = TM.eval(state, d, mode="spectral",
                              wavelengths=wavelengths).numpy()
                key = (f"sun_spectrum_t{turb:.1f}_eta{eta_ray:.2f}"
                       f"_gamma{gamma:.3e}")
                rel = np.mean(np.abs(res - golden[key])
                              / (golden[key] + 1e-6))
                worst = max(worst, rel)
    assert worst <= 1e-2, f"worst mean rel err {worst}"


_ENTRY_POINTS = [convert.sunsky_tables, convert.continuous_distribution]


@pytest.mark.parametrize("fn", _ENTRY_POINTS, ids=lambda f: f.__qualname__)
def test_new_entry_points_default_to_the_card(fn):
    import inspect
    assert inspect.signature(fn).parameters["device"].default == "cuda"
