"""The port's `render_stokes` in spectral mode (4 hero wavelengths)
against the JAX package's on the CPU, lane by lane at 16x16x2, depth 4,
on the scene of `torch_polarized_case`; and S0 against the port's scalar
spectral path with a coloured area panel (R17).

Emitter spectra: the reference grays an RGB area or point emitter to its
channel mean, a flat spectrum (tpusky/render/polarized.py:425-428,
493-495, 537-538, R17). The port upsamples it with rgb2spec as its
scalar spectral path does, under the `srgb_d65` emitter convention:
reflectance fit times the normalised D65 illuminant, which is not flat
even for a gray emitter. So the lane-by-lane test holds the transport
with the emitter spectrum taken flat on the port's side too, as the
reference takes it (the scale column of a gray row's fit is its value);
the R17 test holds the port's own emitter spectra against its scalar
spectral path.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import numpy as np
import torch

from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.render import polarized as TP
from tpusky_torch.render.scene import with_emitter_coeffs

from torch_polarized_case import (H, SPP, W, WORDS, case, jax_stokes_lanes,
                                  port_stokes_lanes, stokes_flips)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


def _flat(coeffs, wavelengths):
    """A flat emitter spectrum at the fit's scale column (a gray row's
    value): the reference's channel mean of a gray emitter."""
    return coeffs[..., 3:4] * torch.ones_like(wavelengths)


def test_spectral_stokes_lanes_match_jax(monkeypatch):
    """Gray emitters taken flat as the reference's: at most 0.1% of the
    lanes outside 1e-3 of the reference's (per channel, relative to its S0,
    floor 1e-3); the lanes are polarized."""
    sc, cam, sc_t, cam_t = case("spectral")
    gray = sc_t.area_radiance[sc_t.area_emitter_shapes]
    assert (gray == gray[:, :1]).all()
    assert (sc_t.point_lights[:, 3:] == sc_t.point_lights[:, 3:4]).all()
    monkeypatch.setattr(TP, "eval_emitter_coeff_spectrum", _flat)
    ref = jax_stokes_lanes(sc, cam, 4, mode="spectral")
    lanes = port_stokes_lanes(sc_t, cam_t, 4, mode="spectral")
    assert lanes.shape == (H * W * SPP, 3, 4) and np.isfinite(lanes).all()
    flip = stokes_flips(lanes, ref, 1e-3)
    assert flip.mean() <= 1e-3, (int(flip.sum()), np.abs(lanes - ref).max())
    assert np.abs(lanes[..., 1:]).max() > 1e-2


def test_spectral_s0_equals_scalar_with_coloured_emitter(monkeypatch):
    """R17: on the depolarizing scene with an area panel of RGB [5, 4, 3],
    S0 equals the port's scalar spectral lanes (rgb2spec spectra on both,
    within 1e-5 relative, floor 1e-3) and S1..S3 are exactly 0, where the
    reference's gray channel mean moves S0 by more than 1% on the lanes
    that see the panel's light."""
    _, _, sc_t, cam_t = case("spectral", colored=True, depolarizing=True)
    lanes = port_stokes_lanes(sc_t, cam_t, 4, mode="spectral")
    scalar = TI._lane_radiance(sc_t, cam_t, TF.Film(H, W, 3), WORDS, SPP, 0,
                               SPP, 4, 1000, "spectral", 0, H,
                               kinds=TB.table_kinds(sc_t.bsdfs)).numpy()
    assert scalar.max() > 0
    err = np.abs(lanes[..., 0] - scalar) / np.maximum(np.abs(scalar), 1e-3)
    assert err.max() <= 1e-5, err.max()
    assert (lanes[..., 1:] == 0).all()
    # the reference's convention: the panel gray at its channel mean
    fit = with_emitter_coeffs(sc_t)
    area = fit.emitter_coeffs.area.clone()
    area[:, 3] = fit.area_radiance.mean(-1)
    gray = fit._replace(emitter_coeffs=fit.emitter_coeffs._replace(
        area=area))
    monkeypatch.setattr(TP, "eval_emitter_coeff_spectrum", _flat)
    grayed = port_stokes_lanes(gray, cam_t, 4, mode="spectral")
    moved = (np.abs(grayed[..., 0] - scalar)
             / np.maximum(np.abs(scalar), 1e-3)).max(-1)
    assert (moved > 1e-2).mean() > 0.05, (moved > 1e-2).mean()
