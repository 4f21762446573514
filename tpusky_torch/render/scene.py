"""Scene: analytic shapes, triangle meshes, an SDF grid, curves, a
material table with its textures and measured datasets, the environment
(sunsky, constant, uniform, envmap or none), the area, point,
directional, spot and directional-area emitters and participating media
(`tpusky/render/scene.py`).

An emitter field left None holds no emitter; `textures` None, no texture
(the material table's texture columns are then not read); `medium` None,
a vacuum; `sdf` and `curve` None, neither. Media do not occlude:
`scene_occluded` tests the geometry alone.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..ops.rgb2spec import fit_sigmoid_coeffs_torch
from .bsdf import MaterialTable, make_material_table
from .curve import CurveTable, curve_test, make_curve_table
from .emitters import ConstantEnv
from .mesh import MeshTable, make_mesh_table, mesh_test
from .sdf import SDFGrid, sdf_test
from .shapes import ShapeTable, make_shape_table, ray_test
from .texture import make_texture_table


class Scene(NamedTuple):
    shapes: ShapeTable
    bsdfs: MaterialTable
    env: Any    # SunskyState | ConstantEnv | UniformEnv | EnvMapState | None
    env_to_world: torch.Tensor       # (3, 3) env local -> world rotation
    mesh: Optional[MeshTable] = None  # every mesh's triangles, or None
    # K14's tables of `mesh` (ops/cuda/mesh_kernel.py::MeshTables), built
    # once per render on the card by `with_mesh_tables`
    mesh_tables: Any = None
    # (n_shapes, C) radiance a hit on each shape emits; None: none emits
    area_radiance: Optional[torch.Tensor] = None
    area_emitter_shapes: Optional[torch.Tensor] = None  # (n_area,) int64
    point_lights: Optional[torch.Tensor] = None   # (Np, 6) [pos, intensity]
    directional_lights: Optional[torch.Tensor] = None  # (Nd, 6) [dir, irr.]
    spot_lights: tuple = ()                       # emitters.SpotLight each
    # (Np + Nd + Nspot,) each delta light's sampling weight
    # (`scene.cpp:100-119`); None: uniform
    delta_light_weights: Optional[torch.Tensor] = None
    textures: Any = None        # texture.TextureTable | None
    # medium.Medium, a tuple of them (regions, `medium.as_stack`) or None
    medium: Any = None
    # the scene's bounding sphere, where environment particles start
    # (`sunsky.cpp:287-301`): (3,) centre and () radius
    bsphere_center: Optional[torch.Tensor] = None
    bsphere_radius: Optional[torch.Tensor] = None
    # (n_shapes, C) directional-area radiance (`directionalarea.cpp`; only
    # the particle tracer sees it) and whether any of it is positive, a
    # host flag set where the table is built, so no render reads it back
    dir_area_radiance: Optional[torch.Tensor] = None
    dir_area_lit: bool = False
    # internal: the RGB emitters' rgb2spec coefficients for spectral mode,
    # set by `with_emitter_coeffs`
    emitter_coeffs: Optional["EmitterCoeffs"] = None
    sdf: Optional[SDFGrid] = None        # one SDF grid (`render/sdf.py`)
    curve: Optional[CurveTable] = None   # every curve (`render/curve.py`)


class EmitterCoeffs(NamedTuple):
    """rgb2spec coefficients (c0, c1, c2, scale) of a scene's RGB
    emitters, one (N, 4) table a kind (None where the scene has none):
    every shape's area radiance (where some shape is an area emitter),
    the point and directional lights and the spot lights. `sources`
    stamps what they were fitted from (`_emitter_stamp`)."""
    area: Optional[torch.Tensor]
    point: Optional[torch.Tensor]
    directional: Optional[torch.Tensor]
    spot: Optional[torch.Tensor]
    sources: tuple = ()


def table_len(x) -> int:
    """Rows of an optional emitter table (0 for None)."""
    return 0 if x is None else x.shape[0]


def n_delta_lights(scene: Scene) -> int:
    return (table_len(scene.point_lights)
            + table_len(scene.directional_lights) + len(scene.spot_lights))


def with_mesh_tables(scene: Scene, plain: bool = False) -> Scene:
    """The scene with K14's tables of its mesh, for a render that queries
    the mesh many times: built here when the mesh lies on the card and the
    kernel will run (not `plain`), else the scene as it is."""
    if (scene.mesh is None or scene.mesh_tables is not None or plain
            or scene.mesh.v0.device.type != "cuda"):
        return scene
    from ..ops.cuda.mesh_kernel import mesh_tables
    return scene._replace(mesh_tables=mesh_tables(scene.mesh))


def _version(o):
    """A tensor's version counter, which an in-place change moves; None
    for anything else and for an inference tensor, which keeps none (so
    only its replacement is seen)."""
    if isinstance(o, torch.Tensor) and not o.is_inference():
        return o._version
    return None


def _emitter_stamp(scene: Scene) -> tuple:
    """What the emitter fit reads, each object with its `_version`: the
    area radiance and emitter shapes, the point and directional lights,
    each spot's intensity, and the environment with a ConstantEnv's
    radiance."""
    env = scene.env
    objs = (scene.area_radiance, scene.area_emitter_shapes,
            scene.point_lights, scene.directional_lights,
            *(s.intensity for s in scene.spot_lights), env,
            env.radiance if isinstance(env, ConstantEnv) else None)
    return tuple((o, _version(o)) for o in objs)


def _coeffs_current(scene: Scene) -> bool:
    """Whether the scene's coefficients were fitted from its emitters as
    they stand: the same objects, no tensor changed in place since."""
    cf = scene.emitter_coeffs
    if cf is None:
        return False
    now = _emitter_stamp(scene)
    return len(now) == len(cf.sources) and all(
        a is b and va == vb for (a, va), (b, vb) in zip(now, cf.sources))


def with_emitter_coeffs(scene: Scene) -> Scene:
    """The scene with its RGB emitters' rgb2spec coefficients for a
    spectral render: every RGB row (area radiance, point, directional and
    spot intensities, a ConstantEnv's radiance) fitted in one batch, each
    row alone (`ops/rgb2spec.fit_sigmoid_coeffs_torch`). The scene as it
    is if its coefficients were fitted from its emitters as they stand;
    refitted if an emitter tensor was replaced or changed in place since.
    The reference fits each group inside every trace
    (`tpusky/render/integrator.py:238-254`)."""
    if _coeffs_current(scene):
        return scene
    env = scene.env
    fit_env = isinstance(env, ConstantEnv)
    groups = [scene.area_radiance if table_len(scene.area_emitter_shapes)
              else None,
              (None if scene.point_lights is None
               else scene.point_lights[:, 3:]),
              (None if scene.directional_lights is None
               else scene.directional_lights[:, 3:]),
              (torch.stack([s.intensity.reshape(-1).expand(3)
                            for s in scene.spot_lights])
               if scene.spot_lights else None),
              env.radiance.reshape(1, 3) if fit_env else None]
    rows = [g for g in groups if g is not None]
    fitted = iter(fit_sigmoid_coeffs_torch(torch.cat(rows, 0)).split(
        [r.shape[0] for r in rows], 0) if rows else ())
    area, point, directional, spot, env_cf = (
        None if g is None else next(fitted) for g in groups)
    if fit_env:
        env = env._replace(coeff=env_cf[0])
    scene = scene._replace(env=env)
    return scene._replace(emitter_coeffs=EmitterCoeffs(
        area, point, directional, spot, _emitter_stamp(scene)))


def scene_occluded(scene: Scene, o, d, maxt, plain: bool = False):
    """Shadow-ray predicate over the scene's geometry (analytic shapes,
    triangle meshes, the SDF grid and the curves; `tpusky/render/scene.py:
    50-65`); `plain` runs the meshes' plain version on any device."""
    occ = ray_test(scene.shapes, o, d, maxt)
    if scene.mesh is not None:
        occ = occ | mesh_test(scene.mesh, o, d, maxt, plain=plain,
                              tables=scene.mesh_tables)
    if scene.sdf is not None:
        occ = occ | sdf_test(scene.sdf, o, d, maxt)
    if scene.curve is not None:
        occ = occ | curve_test(scene.curve, o, d, maxt)
    return occ


def make_scene(shapes=(), bsdf_albedos=((0.5, 0.5, 0.5),), env=None,
               env_to_world=None, bsdf_twosided=None, bsdf_kinds=None,
               bsdf_alphas=None, bsdf_etas=None, bsdf_ks=None,
               bsdf_spectral_albedos=None, meshes=None, area_radiance=None,
               point_lights=None, directional_lights=None, spot_lights=(),
               delta_light_weights=None, bsdf_iors=None,
               bsdf_opacities=None, bsdf_extras=None,
               bsdf_blend_children=None, bsdf_blend_weights=None,
               bsdf_tex_indices=None, bsdf_normal_tex_indices=None,
               textures=None, spectral_textures=False, medium=None,
               dir_area_radiance=None, sdf=None, curves=None,
               measured=None, measured_pol=None,
               device="cuda") -> Scene:
    """Assemble a scene from host-side descriptions: shapes are dicts
    accepted by `make_shape_table`; the bsdf_* lists are the columns of
    `make_material_table` (the reference package's keyword names); meshes
    are dicts accepted by `make_mesh_table`, all baked into one table.
    `area_radiance` (n_shapes, 3) is what a hit on each shape emits, a
    shape with `emitter_idx >= 0` being sampled by NEE; point and
    directional lights are (N, 6) rows [position or direction,
    intensity or irradiance]; `spot_lights` are `emitters.SpotLight`s.
    `textures` is a list of dicts accepted by `make_texture_table` (its
    texels' spectra fitted when `spectral_textures`), indexed by the
    bsdf_tex_indices (reflectance) and bsdf_normal_tex_indices (normal
    map) columns, -1 for none. `medium` is a `medium.Medium` or a tuple
    of them; `dir_area_radiance` (n_shapes, 3) each shape's
    directional-area radiance. `sdf` is an `sdf.SDFGrid`; `curves` a list
    of dicts accepted by `curve.make_curve_table` (subdivision 8);
    `measured` and `measured_pol` the datasets of the kind-17 and kind-18
    rows (`render/measured.py`). The bounding sphere is estimated from the
    shapes' transforms, as the reference's."""
    if len(shapes) == 0:
        # a never-hit placeholder keeps the table non-empty
        ph = np.eye(4)
        ph[:3, 3] = 3e4
        shapes = [dict(kind=0, to_world=ph, bsdf_idx=0)]
    if env_to_world is None:
        env_to_world = np.eye(3, dtype=np.float32)

    def f32(x, cols=None):
        a = np.asarray(x, np.float32)
        return torch.tensor(a if cols is None else a.reshape(-1, cols),
                            device=device)
    area_ids = [i for i, s in enumerate(shapes)
                if s.get("emitter_idx", -1) >= 0]
    center, radius = bounding_sphere(
        np.stack([np.asarray(s.get("to_world", np.eye(4)), np.float32)
                  for s in shapes]))
    dir_area = (None if dir_area_radiance is None
                else np.asarray(dir_area_radiance, np.float32))
    if area_ids and area_radiance is None:
        area_radiance = np.zeros((len(shapes), 3), np.float32)
    return Scene(make_shape_table(shapes, device=device),
                 make_material_table(
                     kinds=bsdf_kinds, albedos=bsdf_albedos,
                     twosided=bsdf_twosided,
                     spectral_albedos=bsdf_spectral_albedos,
                     alphas=bsdf_alphas, etas=bsdf_etas, ks=bsdf_ks,
                     iors=bsdf_iors, opacities=bsdf_opacities,
                     extras=bsdf_extras, blend_children=bsdf_blend_children,
                     blend_weights=bsdf_blend_weights,
                     tex_indices=bsdf_tex_indices,
                     normal_tex_indices=bsdf_normal_tex_indices,
                     measured=measured, measured_pol=measured_pol,
                     device=device),
                 env, f32(env_to_world),
                 make_mesh_table(meshes, device=device) if meshes else None,
                 None,
                 None if area_radiance is None else f32(area_radiance),
                 torch.tensor(area_ids, dtype=torch.int64, device=device),
                 None if point_lights is None else f32(point_lights, 6),
                 (None if directional_lights is None
                  else f32(directional_lights, 6)),
                 tuple(spot_lights),
                 (None if delta_light_weights is None
                  else f32(delta_light_weights)),
                 (make_texture_table(textures, spectral_textures, device)
                  if textures else None),
                 medium, f32(center), f32(radius),
                 None if dir_area is None else f32(dir_area, 3),
                 bool(dir_area is not None and (dir_area > 0).any()), None,
                 sdf, make_curve_table(curves, device=device) if curves
                 else None)


def bounding_sphere(to_world):
    """(centre (3,), radius) of the reference's bounding sphere over
    (n, 4, 4) shape transforms: the mean of their origins, the largest
    origin distance plus the linear part's Frobenius norm, enlarged by
    1e-3 (float32, `tpusky/render/scene.py:117-124`)."""
    t2w = np.asarray(to_world, np.float32)
    centers = t2w[:, :3, 3]
    scales = np.linalg.norm(t2w[:, :3, :3], axis=(1, 2))
    center = centers.mean(axis=0) if len(centers) else np.zeros(3)
    radius = float(np.max(np.linalg.norm(centers - center, axis=-1) + scales,
                          initial=1e-4))
    return center, np.float32(radius * (1.0 + 1e-3))
