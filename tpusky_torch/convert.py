"""Carry objects of the JAX package `tpusky` over into this port.

Each function takes a `tpusky` object whose array leaves have been
turned into numpy arrays (for example `jax.tree.map(np.asarray, state)`)
and returns the port's counterpart as float32/int64 tensors on `device`
(the card unless the caller names another device).
Nothing here imports jax or tpusky: the objects are read by field name
(and an environment by its type's name). The polarized material kinds
11-14 come over with their `extra` columns (theta, delta, left-handed;
`render/polarized.py` renders them in Stokes vectors), hair (16) with
its sigma_a, beta_m, eta, beta_n and tilt in the reference's columns,
and the measured kinds 17 and 18 with the table's datasets. A medium
(one region or a tuple), an SDF grid and a curve table come over with
their static fields as they are. An area emitter on a cube raises
NotImplementedError (R8).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.sunsky.model import SunskyParams, SunskyState
from .models.sunsky.tables import SunskyTables
from .ops.distr import ContinuousDistribution, DiscreteDistribution
from .ops.distr2d import Bilinear2D
from .render.bsdf import MaterialTable, check_datasets, check_kinds
from .render.curve import CurveTable
from .render.emitters import ConstantEnv, EnvMapState, SpotLight, UniformEnv
from .render.measured import MeasuredBRDF, MeasuredPolarized, ParamWarp2D
from .render.medium import Medium
from .render.mesh import MeshTable
from .render.scene import Scene
from .render.sdf import SDFGrid
from .render import sensors as sensors_mod
from .render.sensors import Perspective
from .render.shapes import KINDS, ShapeTable, check_emitters
from .render.texture import TextureTable

_TEXTURE_INTS = ("kind", "wrap", "offset", "width", "height", "depth")


_SENSORS = {k.__name__: k for k in (
    sensors_mod.Perspective, sensors_mod.Spherical, sensors_mod.ThinLens,
    sensors_mod.Orthographic, sensors_mod.Distant, sensors_mod.RadianceMeter,
    sensors_mod.IrradianceMeter)}


def _f32(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _i64(a, device):
    return torch.tensor(np.asarray(a, np.int64), device=device)


def _none_or_empty(a) -> bool:
    return a is None or np.asarray(a).size == 0


def sunsky_params(p, device="cuda") -> SunskyParams:
    return SunskyParams(*(_f32(getattr(p, f), device)
                          for f in SunskyParams._fields))


def discrete_distribution(d, device="cuda") -> DiscreteDistribution:
    return DiscreteDistribution(_f32(d.pmf, device), _f32(d.cdf, device),
                                _f32(d.total, device))


def continuous_distribution(d, device="cuda") -> ContinuousDistribution:
    return ContinuousDistribution(*(_f32(getattr(d, f), device)
                                    for f in ContinuousDistribution._fields))


def sunsky_tables(t, device="cuda") -> SunskyTables:
    """`tpusky` SunskyTables (RGB or spectral) -> SunskyTables."""
    return SunskyTables(*(None if getattr(t, f) is None
                          else _f32(getattr(t, f), device)
                          for f in SunskyTables._fields))


def sunsky_state(s, device="cuda") -> SunskyState:
    """A `tpusky` SunskyState (RGB or spectral) -> SunskyState, including
    the distributions it holds."""
    f = {name: _f32(getattr(s, name), device)
         for name in ("sun_angles", "sun_frame_s", "sun_frame_t",
                      "sun_frame_n", "sky_params", "sky_radiance",
                      "sun_radiance", "gaussians", "sky_sampling_w")}
    return SunskyState(
        params=sunsky_params(s.params, device),
        sun_ld=None if s.sun_ld is None else _f32(s.sun_ld, device),
        gaussian_distr=discrete_distribution(s.gaussian_distr, device),
        spectral_distr=(None if s.spectral_distr is None else
                        continuous_distribution(s.spectral_distr, device)),
        **f)


def shape_table(t, device="cuda") -> ShapeTable:
    kinds = tuple(int(k) for k in t.kind)
    if any(k not in KINDS for k in kinds):
        raise NotImplementedError(f"shape kinds {kinds}")
    check_emitters(kinds, t.emitter_idx)
    return ShapeTable(kinds, _f32(t.to_world, device),
                      _f32(t.to_object, device), _i64(t.bsdf_idx, device),
                      _i64(t.emitter_idx, device), _f32(t.area, device))


def measured_brdf(m, device="cuda") -> MeasuredBRDF:
    """A `tpusky` MeasuredBRDF -> MeasuredBRDF, its warps' tables as the
    reference built them."""
    def warp(w):
        return ParamWarp2D(*(_f32(getattr(w, f), device)
                             for f in ParamWarp2D._fields))
    return MeasuredBRDF(*(_f32(getattr(m, f), device) for f in (
        "phi_i", "theta_i", "wavelengths", "ndf", "sigma")),
        warp(m.vndf), warp(m.luminance), _f32(m.spectra, device),
        bool(m.isotropic), bool(m.jacobian), int(m.reduction))


def measured_polarized(m, device="cuda") -> MeasuredPolarized:
    """A `tpusky` MeasuredPolarized -> MeasuredPolarized."""
    return MeasuredPolarized(*(_f32(getattr(m, f), device) for f in (
        "phi_d", "theta_d", "theta_h", "wvls", "m_data")),
        float(m.alpha_sample), float(m.wavelength))


def sdf_grid(g, device="cuda") -> SDFGrid:
    """A `tpusky` SDFGrid -> SDFGrid (its material row a Python int)."""
    return SDFGrid(_f32(g.values, device), _f32(g.to_local, device),
                   _f32(g.to_world, device), int(np.asarray(g.bsdf_idx)))


def curve_table(c, device="cuda") -> CurveTable:
    """A `tpusky` CurveTable -> CurveTable (material rows as int64)."""
    return CurveTable(_f32(c.pa, device), _f32(c.pb, device),
                      _f32(c.ra, device), _f32(c.rb, device),
                      _i64(c.bsdf_idx, device),
                      torch.tensor(np.asarray(c.valid, bool), device=device))


def material_table(t, device="cuda") -> MaterialTable:
    """A `tpusky` MaterialTable -> MaterialTable, its blend children as
    int64, with the measured datasets it holds."""
    kinds = np.asarray(t.kind)
    check_kinds(kinds)
    check_datasets(kinds, t.measured, t.measured_pol)
    m = kinds.shape[0]

    def column(idx):
        return np.full((m,), -1) if idx is None else np.asarray(idx)
    tex_idx, nrm_idx = column(t.tex_idx), column(t.normal_tex_idx)
    opacity = np.asarray(t.opacity, np.float32)
    return MaterialTable(_i64(kinds, device), _f32(t.albedo, device),
                         torch.tensor(np.asarray(t.twosided, bool),
                                      device=device),
                         *(_f32(getattr(t, f), device)
                           for f in ("albedo_spec", "alpha", "eta", "k",
                                     "ior", "opacity", "extra")),
                         _i64(t.blend_a, device), _i64(t.blend_b, device),
                         _f32(t.blend_w, device),
                         tuple(int(k) for k in kinds),
                         bool((opacity < 1.0).any()), _i64(tex_idx, device),
                         _i64(nrm_idx, device), bool((nrm_idx >= 0).any()),
                         (None if t.measured is None
                          else measured_brdf(t.measured, device)),
                         (None if t.measured_pol is None
                          else measured_polarized(t.measured_pol, device)))


def texture_table(t, device="cuda") -> TextureTable:
    """A `tpusky` TextureTable -> TextureTable (indices as int64), its
    spectral coefficients as the reference fitted them."""
    return TextureTable(*(
        (_i64 if f in _TEXTURE_INTS else _f32)(getattr(t, f), device)
        for f in TextureTable._fields[:-1]),
        tuple(int(k) for k in np.asarray(t.kind)))


def mesh_table(m, device="cuda") -> MeshTable:
    """A `tpusky` MeshTable -> MeshTable (material indices as int64)."""
    return MeshTable(*(_f32(getattr(m, f), device)
                       for f in ("v0", "e1", "e2", "n0", "n1", "n2")),
                     _i64(m.bsdf_idx, device),
                     torch.tensor(np.asarray(m.valid, bool), device=device),
                     _f32(m.uv, device),
                     None if m.col is None else _f32(m.col, device))


def environment(env, device="cuda"):
    """A `tpusky` environment (SunskyState, ConstantEnv, UniformEnv,
    EnvMapState or None) -> the port's. ConstantEnv and UniformEnv have
    the same field, so they are told apart by their type's name; an
    envmap brings its bitmap, its Bilinear2D tables and its scale."""
    if env is None:
        return None
    name = type(env).__name__
    if name in ("ConstantEnv", "UniformEnv"):
        kind = ConstantEnv if name == "ConstantEnv" else UniformEnv
        return kind(_f32(env.radiance, device))
    if name == "EnvMapState":
        return EnvMapState(_f32(env.bitmap, device),
                           Bilinear2D(*(_f32(getattr(env.warp, f), device)
                                        for f in Bilinear2D._fields)),
                           _f32(env.scale, device),
                           None if env.coeff is None
                           else _f32(env.coeff, device))
    if hasattr(env, "gaussian_distr"):
        return sunsky_state(env, device)
    raise NotImplementedError(f"environment {name}")


def spot_light(light, device="cuda") -> SpotLight:
    return SpotLight(*(None if getattr(light, f) is None
                       else _f32(getattr(light, f), device)
                       for f in SpotLight._fields))


_MEDIUM_TENSORS = Medium._fields[:9]


def medium(m, device="cuda"):
    """A `tpusky` Medium, or a tuple of them (regions) -> the port's, its
    kind, march steps, phase and channel_mis as they are."""
    if m is None:
        return None
    if type(m).__name__ != "Medium":
        return tuple(medium(r, device) for r in m)
    return Medium(*(None if getattr(m, f) is None
                    else _f32(getattr(m, f), device)
                    for f in _MEDIUM_TENSORS),
                  int(m.kind), int(m.n_steps),
                  tuple(m.phase) if isinstance(m.phase, (tuple, list))
                  else m.phase, bool(m.channel_mis))


def scene(sc, device="cuda") -> Scene:
    """A `tpusky` Scene of analytic shapes, triangle meshes, an SDF grid,
    curves, materials with their textures and measured datasets, a
    sunsky, constant, uniform, envmap or no environment, area, point,
    directional, spot and directional-area emitters and media -> Scene,
    with its bounding sphere. Where no shape emits and none is an
    emitter, `area_radiance` is None; empty light tables are None, and so
    is an all-zero `dir_area_radiance`."""

    def rows(a):
        return None if _none_or_empty(a) else _f32(a, device)
    area = np.asarray(sc.area_radiance)
    dir_area = (None if sc.dir_area_radiance is None
                else np.asarray(sc.dir_area_radiance, np.float32))
    dir_lit = bool(dir_area is not None and (dir_area > 0).any())
    emitters = (np.zeros((0,), np.int64) if sc.area_emitter_shapes is None
                else np.asarray(sc.area_emitter_shapes).reshape(-1))
    return Scene(shape_table(sc.shapes, device),
                 material_table(sc.bsdfs, device),
                 environment(sc.env, device), _f32(sc.env_to_world, device),
                 None if sc.mesh is None else mesh_table(sc.mesh, device),
                 None,
                 (_f32(area, device) if (area != 0).any() or emitters.size
                  else None),
                 _i64(emitters, device),
                 rows(sc.point_lights), rows(sc.directional_lights),
                 tuple(spot_light(s, device) for s in sc.spot_lights),
                 (None if sc.delta_light_weights is None
                  else _f32(sc.delta_light_weights, device)),
                 (None if sc.textures is None
                  else texture_table(sc.textures, device)),
                 medium(sc.medium, device), _f32(sc.bsphere_center, device),
                 _f32(sc.bsphere_radius, device),
                 _f32(dir_area, device) if dir_lit else None, dir_lit, None,
                 None if sc.sdf is None else sdf_grid(sc.sdf, device),
                 None if sc.curve is None else curve_table(sc.curve, device))


def perspective(s, device="cuda") -> Perspective:
    return Perspective(_f32(s.to_world, device), _f32(s.fov_x_deg, device),
                       _f32(s.aspect, device), _f32(s.near, device))


def sensor(s, device="cuda"):
    """A `tpusky` sensor of any kind -> the port's, told apart by its
    type's name; a Batch's sub-sensors converted in turn."""
    name = type(s).__name__
    if name == "Batch":
        return sensors_mod.Batch(tuple(sensor(x, device) for x in s.sensors))
    kind = _SENSORS.get(name)
    if kind is None:
        raise TypeError(f"unknown sensor {name}")
    return kind(*(_f32(getattr(s, f), device) for f in kind._fields))


def adam_state(s, device="cuda") -> dict:
    """A `tpusky.ad.optimizers.Adam` state over a dict of parameters (per
    name an (m, v, t) tuple) -> the port's Adam state."""
    return {k: tuple(_f32(x, device) for x in v) for k, v in s.items()}


def sgd_state(s, device="cuda") -> dict:
    """A `tpusky.ad.optimizers.SGD` state over a dict of parameters (per
    name the momentum buffer) -> the port's SGD state."""
    return {k: _f32(v, device) for k, v in s.items()}
