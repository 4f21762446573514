"""Shared by the port's SDF, curve, hair and measured tests: a scene of an
SDF torus shaded by the RGL measured BRDF (kind 17), a tuft of B-spline
hair strands (kind 16) and a diffuse ground under the sunsky, built with
the JAX package's constructors from numpy seeds, and the synthetic RGL
and pBSDF tables of tests/test_measured.py, with a spectral variant."""

import numpy as np

from test_measured import _synthetic_fields, _synthetic_pbsdf

TILT = 2.0


def spectral_fields(jacobian=0):
    """`_synthetic_fields` as a spectral file: 8 wavelengths over
    360-830 nm, each plane a smooth function of the wavelength and u."""
    f = _synthetic_fields(jacobian=jacobian)
    rgb = f.pop("rgb")
    wl = np.linspace(360.0, 830.0, 8).astype(np.float32)
    ut = np.linspace(0.0, 1.0, rgb.shape[-1])
    sp = np.zeros(rgb.shape[:2] + (8,) + rgb.shape[3:], np.float32)
    for i in range(8):
        sp[:, :, i] = 0.3 + 0.5 * np.sin(0.7 * i) ** 2 + 0.1 * ut
    f["spectra"], f["wavelengths"] = sp, wl
    return f


def anisotropic_fields():
    """Four phi_i slices over a quarter turn (reduction 4, the sign
    folding of `measured.cpp:246-252`)."""
    f = _synthetic_fields(P=4)
    f["phi_i"] = np.linspace(0.0, np.pi / 2, 4).astype(np.float32)
    return f


def pbsdf_fields():
    return _synthetic_pbsdf()


def torus_grid(res, major=0.3, minor=0.12):
    """A torus about the cube's centre, in the z = 0.5 plane, baked onto a
    res^3 grid over [0, 1]^3."""
    g = np.arange(res) / (res - 1) - 0.5
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    q = np.sqrt(x ** 2 + y ** 2) - major
    return (np.sqrt(q ** 2 + z ** 2) - minor).astype(np.float32)


def torus_to_world(scale=2.0, center=(0.0, 0.0, 1.0)):
    m = np.diag([scale, scale, scale, 1.0]).astype(np.float32)
    m[:3, 3] = np.asarray(center, np.float32) - 0.5 * scale
    return m


def tuft(n_strands, n_points=6, radius=0.03, seed=3, center=(0.9, -0.6),
         height=1.2, bsdf_idx=2):
    """n_strands B-spline strands rising from a disc about `center`, each
    with n_points control points, swaying by a seeded phase."""
    rng = np.random.default_rng(seed)
    strands = []
    for _ in range(n_strands):
        r, a = 0.25 * np.sqrt(rng.random()), 2 * np.pi * rng.random()
        base = np.asarray(center) + r * np.array([np.cos(a), np.sin(a)])
        phase, sway = 2 * np.pi * rng.random(), 0.1 + 0.1 * rng.random()
        k = np.arange(n_points)
        pts = np.stack([base[0] + sway * np.sin(0.8 * k + phase),
                        base[1] + sway * np.cos(0.6 * k + phase),
                        height * k / (n_points - 1)], -1)
        strands.append(dict(points=pts.astype(np.float32), radius=radius,
                            kind="bspline", bsdf_idx=bsdf_idx))
    return strands


def material_columns():
    """Rows: 0 the diffuse ground, 1 the measured torus, 2 hair (sigma_a
    [0.2, 0.4, 0.8], beta_m 0.3, beta_n 0.3, tilt 2 deg, eta 1.55), 3 the
    measured pBRDF."""
    extras = np.zeros((4, 8), np.float32)
    extras[:, 1] = 0.5
    extras[2, :2] = (0.3, TILT)
    return dict(bsdf_kinds=[0, 17, 16, 18],
                bsdf_albedos=[[0.4, 0.4, 0.4], [1.0, 1.0, 1.0],
                              [0.2, 0.4, 0.8], [1.0, 1.0, 1.0]],
                bsdf_alphas=[0.1, 0.1, 0.3, 0.1],
                bsdf_iors=[1.5046, 1.5046, 1.55, 1.5046],
                bsdf_extras=extras,
                bsdf_spectral_albedos=np.concatenate([
                    np.full((1, 11), 0.4), np.ones((1, 11)),
                    np.linspace(0.8, 0.2, 11)[None], np.ones((1, 11))]))


def ground():
    m = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    return dict(kind=1, to_world=m, bsdf_idx=0)


def camera():
    """The JAX package's perspective camera on the torus and the tuft."""
    from tpusky.render.sensors import make_perspective
    return make_perspective([1.8, -2.4, 1.5], [0.45, -0.3, 0.8],
                            fov_x_deg=45)


def primary_shape(sc, sensor, h, w, spp, seed):
    """The shape index each lane's camera ray hits (-4 a curve, -3 the
    SDF, -1 none), the lanes drawn as `torch_breadth_case.jax_lanes` and
    the port's `_lane_radiance` draw them."""
    import torch
    from tpusky_torch.render import integrator as TI
    from tpusky_torch.render import sensors as TSe
    lane = torch.arange(h * w * spp)
    pixel = lane // spp
    u = TI._SamplerCtx("independent", seed, pixel, lane % spp,
                       spp).next(10_000, 2)
    uv = torch.stack([((pixel % w).float() + u[:, 0]) / w,
                      ((pixel // w).float() + u[:, 1]) / h], -1)
    o, d = TSe.sample_ray(sensor, uv)
    return TI._scene_hit(sc, o, d, True)[3].numpy()


def geometry_scene(mode):
    """The JAX scene of the geometry tests: the ground, a 12^3 SDF torus
    of kind 17 (a spectral file in spectral mode), a tuft of 12 strands
    of hair and a kind-18 row, under the sunsky of `mode`."""
    from tpusky.render import measured as JM
    from tpusky.render import sdf as JS
    from tpusky.render.scene import make_scene
    from torch_breadth_case import sunsky_state
    fields = (spectral_fields() if mode == "spectral"
              else _synthetic_fields(jacobian=1))
    return make_scene(
        shapes=[ground()], env=sunsky_state(mode),
        sdf=JS.make_sdf_grid(torus_grid(12), torus_to_world(), 1),
        curves=tuft(12), measured=JM.load_measured(fields),
        measured_pol=JM.load_measured_polarized(pbsdf_fields()),
        **material_columns())
