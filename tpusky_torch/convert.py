"""Carry objects of the JAX package `tpusky` over into this port.

Each function takes a `tpusky` object whose array leaves have been
turned into numpy arrays (for example `jax.tree.map(np.asarray, state)`)
and returns the port's counterpart as float32/int64 tensors on `device`
(the card unless the caller names another device).
Nothing here imports jax or tpusky: the objects are read by field name.
Parts the port does not have yet (area/delta lights, material kinds
other than diffuse and rough conductor) raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.sunsky.model import SunskyParams, SunskyState
from .models.sunsky.tables import SunskyTables
from .ops.distr import ContinuousDistribution, DiscreteDistribution
from .render.bsdf import KINDS as BSDF_KINDS
from .render.bsdf import MaterialTable
from .render.mesh import MeshTable
from .render.scene import Scene
from .render.sensors import Perspective
from .render.shapes import KINDS, ShapeTable


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
    if (np.asarray(t.emitter_idx) >= 0).any():
        raise NotImplementedError("area emitters")
    return ShapeTable(kinds, _f32(t.to_world, device),
                      _f32(t.to_object, device), _i64(t.bsdf_idx, device))


def material_table(t, device="cuda") -> MaterialTable:
    kinds = np.asarray(t.kind)
    if not np.isin(kinds, BSDF_KINDS).all():
        raise NotImplementedError(f"material kinds {sorted(set(kinds))}")
    if t.opacity is not None and (np.asarray(t.opacity) < 1.0).any():
        raise NotImplementedError("opacity masks")
    for field in ("tex_idx", "normal_tex_idx"):
        idx = getattr(t, field)
        if idx is not None and (np.asarray(idx) >= 0).any():
            raise NotImplementedError("textured materials")
    return MaterialTable(_i64(kinds, device), _f32(t.albedo, device),
                         torch.tensor(np.asarray(t.twosided, bool),
                                      device=device),
                         *(_f32(getattr(t, f), device)
                           for f in ("albedo_spec", "alpha", "eta", "k")),
                         tuple(int(k) for k in kinds))


def mesh_table(m, device="cuda") -> MeshTable:
    """A `tpusky` MeshTable -> MeshTable (material indices as int64)."""
    return MeshTable(*(_f32(getattr(m, f), device)
                       for f in ("v0", "e1", "e2", "n0", "n1", "n2")),
                     _i64(m.bsdf_idx, device),
                     torch.tensor(np.asarray(m.valid, bool), device=device),
                     _f32(m.uv, device),
                     None if m.col is None else _f32(m.col, device))


def scene(sc, device="cuda") -> Scene:
    """A `tpusky` Scene of analytic shapes, triangle meshes, diffuse and
    rough-conductor materials and a sunsky (or no) environment -> Scene."""
    for field in ("area_emitter_shapes", "point_lights",
                  "directional_lights"):
        if not _none_or_empty(getattr(sc, field)):
            raise NotImplementedError(f"scene.{field}")
    for field in ("textures", "medium", "sdf", "curve"):
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
                 _f32(sc.env_to_world, device),
                 None if sc.mesh is None else mesh_table(sc.mesh, device))


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
