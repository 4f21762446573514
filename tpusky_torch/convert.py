"""Carry objects of the JAX package `tpusky` over into this port.

Each function takes a `tpusky` object whose array leaves have been
turned into numpy arrays (for example `jax.tree.map(np.asarray, state)`)
and returns the port's counterpart as float32/int64 tensors on `device`.
Nothing here imports jax or tpusky: the objects are read by field name.
Parts the port does not have yet (spectral state, area/delta lights,
meshes, other materials) raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.sunsky.model import SunskyParams, SunskyState
from .ops.distr import DiscreteDistribution
from .render.bsdf import DIFFUSE, MaterialTable
from .render.scene import Scene
from .render.sensors import Perspective
from .render.shapes import KINDS, ShapeTable


def _f32(a, device):
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _i64(a, device):
    return torch.tensor(np.asarray(a, np.int64), device=device)


def _none_or_empty(a) -> bool:
    return a is None or np.asarray(a).size == 0


def sunsky_params(p, device=None) -> SunskyParams:
    return SunskyParams(*(_f32(getattr(p, f), device)
                          for f in SunskyParams._fields))


def discrete_distribution(d, device=None) -> DiscreteDistribution:
    return DiscreteDistribution(_f32(d.pmf, device), _f32(d.cdf, device),
                                _f32(d.total, device))


def sunsky_state(s, device=None) -> SunskyState:
    """A `tpusky` SunskyState (RGB) -> SunskyState, including the
    gaussian distribution it holds."""
    if s.sun_ld is not None or s.spectral_distr is not None:
        raise NotImplementedError("spectral sunsky state")
    f = {name: _f32(getattr(s, name), device)
         for name in ("sun_angles", "sun_frame_s", "sun_frame_t",
                      "sun_frame_n", "sky_params", "sky_radiance",
                      "sun_radiance", "gaussians", "sky_sampling_w")}
    return SunskyState(params=sunsky_params(s.params, device), sun_ld=None,
                       gaussian_distr=discrete_distribution(s.gaussian_distr,
                                                            device),
                       spectral_distr=None, **f)


def shape_table(t, device=None) -> ShapeTable:
    kinds = tuple(int(k) for k in t.kind)
    if any(k not in KINDS for k in kinds):
        raise NotImplementedError(f"shape kinds {kinds}")
    if (np.asarray(t.emitter_idx) >= 0).any():
        raise NotImplementedError("area emitters")
    return ShapeTable(kinds, _f32(t.to_world, device),
                      _f32(t.to_object, device), _i64(t.bsdf_idx, device))


def material_table(t, device=None) -> MaterialTable:
    kinds = np.asarray(t.kind)
    if (kinds != DIFFUSE).any():
        raise NotImplementedError(f"material kinds {sorted(set(kinds))}")
    if t.opacity is not None and (np.asarray(t.opacity) < 1.0).any():
        raise NotImplementedError("opacity masks")
    for field in ("tex_idx", "normal_tex_idx"):
        idx = getattr(t, field)
        if idx is not None and (np.asarray(idx) >= 0).any():
            raise NotImplementedError("textured materials")
    return MaterialTable(_i64(kinds, device), _f32(t.albedo, device),
                         torch.tensor(np.asarray(t.twosided, bool),
                                      device=device))


def scene(sc, device=None) -> Scene:
    """A `tpusky` Scene of analytic shapes, diffuse materials and a sunsky
    (or no) environment -> Scene."""
    for field in ("area_emitter_shapes", "point_lights",
                  "directional_lights"):
        if not _none_or_empty(getattr(sc, field)):
            raise NotImplementedError(f"scene.{field}")
    for field in ("mesh", "textures", "medium", "sdf", "curve"):
        if getattr(sc, field) is not None:
            raise NotImplementedError(f"scene.{field}")
    if sc.spot_lights:
        raise NotImplementedError("scene.spot_lights")
    env = sc.env
    if env is not None:
        if not hasattr(env, "gaussian_distr"):
            raise NotImplementedError(f"environment {type(env).__name__}")
        env = sunsky_state(env, device)
    return Scene(shape_table(sc.shapes, device),
                 material_table(sc.bsdfs, device), env,
                 _f32(sc.env_to_world, device))


def perspective(s, device=None) -> Perspective:
    return Perspective(_f32(s.to_world, device), _f32(s.fov_x_deg, device),
                       _f32(s.aspect, device), _f32(s.near, device))
