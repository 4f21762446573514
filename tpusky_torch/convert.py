"""Carry objects of the JAX package `tpusky` over into this port.

Each function takes a `tpusky` object whose array leaves have been
turned into numpy arrays (for example `jax.tree.map(np.asarray, state)`)
and returns the port's counterpart as float32/int64 tensors on `device`
(the card unless the caller names another device).
Nothing here imports jax or tpusky: the objects are read by field name
(and an environment by its type's name). Parts the port does not have
yet raise NotImplementedError: the polarized, hair and measured material
kinds, textures, media, SDFs, curves, an envmap with rgb2spec spectra,
and an area emitter on a cube (R8).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.sunsky.model import SunskyParams, SunskyState
from .models.sunsky.tables import SunskyTables
from .ops.distr import ContinuousDistribution, DiscreteDistribution
from .ops.distr2d import Bilinear2D
from .render.bsdf import MaterialTable, check_kinds
from .render.emitters import ConstantEnv, EnvMapState, SpotLight, UniformEnv
from .render.mesh import MeshTable
from .render.scene import Scene
from .render.sensors import Perspective
from .render.shapes import KINDS, ShapeTable, check_emitters


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


def material_table(t, device="cuda") -> MaterialTable:
    """A `tpusky` MaterialTable -> MaterialTable, its blend children as
    int64."""
    kinds = np.asarray(t.kind)
    check_kinds(kinds)
    for field in ("tex_idx", "normal_tex_idx"):
        idx = getattr(t, field)
        if idx is not None and (np.asarray(idx) >= 0).any():
            raise NotImplementedError("textured materials need "
                                      "render/texture.py, not ported yet")
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
                         bool((opacity < 1.0).any()))


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
        if env.coeff is not None:
            raise NotImplementedError("an envmap's rgb2spec spectra need "
                                      "ops/rgb2spec.py, not ported yet")
        return EnvMapState(_f32(env.bitmap, device),
                           Bilinear2D(*(_f32(getattr(env.warp, f), device)
                                        for f in Bilinear2D._fields)),
                           _f32(env.scale, device))
    if hasattr(env, "gaussian_distr"):
        return sunsky_state(env, device)
    raise NotImplementedError(f"environment {name}")


def spot_light(light, device="cuda") -> SpotLight:
    return SpotLight(*(None if getattr(light, f) is None
                       else _f32(getattr(light, f), device)
                       for f in SpotLight._fields))


def scene(sc, device="cuda") -> Scene:
    """A `tpusky` Scene of analytic shapes, triangle meshes, the ported
    materials, a sunsky, constant, uniform, envmap or no environment and
    area, point, directional and spot emitters -> Scene. Where no shape
    emits and none is an emitter, `area_radiance` is None; empty light
    tables are None."""
    for field in ("textures", "medium", "sdf", "curve"):
        if getattr(sc, field) is not None:
            raise NotImplementedError(f"scene.{field}")

    def rows(a):
        return None if _none_or_empty(a) else _f32(a, device)
    area = np.asarray(sc.area_radiance)
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
                  else _f32(sc.delta_light_weights, device)))


def perspective(s, device="cuda") -> Perspective:
    return Perspective(_f32(s.to_world, device), _f32(s.fov_x_deg, device),
                       _f32(s.aspect, device), _f32(s.near, device))


def adam_state(s, device="cuda") -> dict:
    """A `tpusky.ad.optimizers.Adam` state over a dict of parameters (per
    name an (m, v, t) tuple) -> the port's Adam state."""
    return {k: tuple(_f32(x, device) for x in v) for k, v in s.items()}


def sgd_state(s, device="cuda") -> dict:
    """A `tpusky.ad.optimizers.SGD` state over a dict of parameters (per
    name the momentum buffer) -> the port's SGD state."""
    return {k: _f32(v, device) for k, v in s.items()}
