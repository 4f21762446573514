"""Scene-dictionary loader, the `mi.load_dict` equivalent
(`tpusky/render/loader.py`).

Takes a Mitsuba-3-style nested dict and assembles a `SceneBundle` whose
tensors lie on `device` (the card unless the caller names another). The
parse is the reference's, step for step, on the host in numpy; the tables
are built by the port's constructors (`scene.make_scene`,
`medium.make_medium`, `sdf.make_sdf_grid`, `emitters.make_spot`,
`emitters.make_envmap`, the sensors' `make_*`). Register custom plugins
with `register_plugin(kind, name, builder)`.

Supported types (those the port renders):
  integrators: path, direct, depth, aov, moment, ptracer, stokes,
               volpath, volpathmis, prbvolpath and the AD aliases
  sensors:     perspective, orthographic, spherical, thinlens, distant,
               radiancemeter, irradiancemeter, batch
  film:        hdrfilm, specfilm (rfilter box/gaussian/tent/lanczos/
               mitchell/catmullrom)
  sampler:     independent, stratified, multijitter, orthogonal, sobol,
               ldsampler
  shapes:      rectangle, sphere, disk, cube, cylinder, obj, ply,
               serialized, sdfgrid, linearcurve, bsplinecurve,
               instance/shapegroup, merge
  bsdfs:       every kind of `render/bsdf.py`, blendbsdf, and the
               twosided, mask, normalmap and bumpmap wrappers (a bump map
               becomes a normal map here)
  emitters:    sunsky, constant, envmap, area (on shapes), point,
               directional, spot, projector, directionalarea
  media:       homogeneous, heterogeneous (gridvolume); every phase
  textures:    bitmap (EXR/PNG/inline), checkerboard, volume,
               mesh_attribute

What the port refuses it refuses here too, with the same
NotImplementedError: R8 (an area emitter on a cube) when the scene is
built, R13-R16, R18 and R19 when it is rendered.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..config import Variant, resolve
from ..models.sunsky import constants as skyC
from ..models.sunsky import model as sunsky_model
from ..models.sunsky.astronomy import DateTimeRecord, LocationRecord
from ..models.sunsky.astronomy import sun_direction as astro_sun_direction
from ..models.sunsky.tables import load_tables
from ..utils import transform as T
from . import integrator as integrator_mod
from .emitters import ConstantEnv, UniformEnv
from .film import Film
from .scene import make_scene
from .sensors import Orthographic, Perspective, make_spherical
from .shapes import CUBE, CYLINDER, DISK, RECTANGLE, SPHERE, world_area

_SHAPE_KINDS = {"rectangle": RECTANGLE, "sphere": SPHERE, "disk": DISK,
                "cube": CUBE, "cylinder": CYLINDER}

# AD-integrator plugin name -> (engine integrator, forced max_depth or
# None), `tpusky/ad/integrators.py:50-63`: the bounce loop's backward is
# already a replay, and the medium-aware loop is gated on scene.medium.
AD_INTEGRATOR_ALIASES = {
    "prb": ("path", None),
    "prb_basic": ("path", 2),
    "direct_projective": ("direct", None),
    "prb_projective": ("path", None),
    "volpath": ("path", None),
    "volpathmis": ("path", None),
    "prbvolpath": ("path", None),
}

_PLUGIN_REGISTRY: Dict[str, Dict[str, Callable]] = {}


def register_plugin(kind: str, name: str, builder: Callable) -> None:
    """Register a custom builder, e.g. register_plugin('any', 'fisheye',
    fn); `load_dict` calls fn(description) for each plugin of that type
    it does not know (`mi.register_*`)."""
    _PLUGIN_REGISTRY.setdefault(kind, {})[name] = builder


def prng_key(seed: int) -> np.ndarray:
    """The two uint32 words of the reference's `jax.random.PRNGKey(seed)`
    (`[0, seed]` for a seed below 2^32), which the port's renderers take
    as their key."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


# ---------------------------------------------------------------------------
# Spectrum parsing
# ---------------------------------------------------------------------------


def _parse_number_list(v):
    if isinstance(v, str):
        return np.array([float(x) for x in v.replace(",", " ").split()])
    return np.asarray(v, np.float64)


def _upsample(rgb):
    from ..ops.rgb2spec import upsample_rgb
    return upsample_rgb(rgb, skyC.WAVELENGTHS)[0]


def spectrum_to_channels(value, mode: str) -> np.ndarray:
    """Evaluate a spectrum description at the model's channels: RGB mode
    -> (3,); spectral mode -> (11,) at 320..720 nm step 40 (the sunsky
    datasets' wavelengths). Handles the reference's uniform, rgb/srgb
    (rgb2spec upsampling in spectral mode), irregular, regular, blackbody
    and d65 spectra (`src/spectra/`)."""
    wl = skyC.WAVELENGTHS
    if isinstance(value, (int, float)):
        return np.full(3 if mode == "rgb" else 11, float(value))
    if isinstance(value, (list, tuple, np.ndarray)):
        arr = np.asarray(value, np.float64)
        if mode == "rgb":
            return np.broadcast_to(arr, (3,)).copy()
        return _upsample(np.broadcast_to(arr, (3,)))
    if isinstance(value, dict):
        t = value["type"]
        if t == "uniform":
            return np.full(3 if mode == "rgb" else 11,
                           float(value.get("value", 1.0)))
        if t in ("rgb", "srgb"):
            arr = np.broadcast_to(
                np.asarray(value.get("value", value.get("color", 1.0)),
                           np.float64), (3,))
            return arr.copy() if mode == "rgb" else _upsample(arr)
        if t == "irregular":
            w = _parse_number_list(value["wavelengths"])
            v = _parse_number_list(value["values"])
            if mode == "rgb":
                return np.full(3, np.interp([600, 550, 450], w, v).mean())
            return np.interp(wl, w, v)
        if t == "blackbody":
            # Planck spectral radiance (W / m^2 / sr / nm), `blackbody.cpp`
            temp = float(value.get("temperature", 5778.0))
            h_pl, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
            lam = (np.array([600, 550, 450.0]) if mode == "rgb"
                   else wl) * 1e-9
            rad = (2 * h_pl * c * c / lam ** 5
                   / (np.exp(h_pl * c / (lam * kb * temp)) - 1.0)) * 1e-9
            return rad * float(value.get("scale", 1.0))
        if t == "d65":
            from ..ops.spectrum import cie_d65
            lam = np.array([600, 550, 450.0]) if mode == "rgb" else wl
            d65 = cie_d65(torch.tensor(lam, dtype=torch.float32)).numpy()
            return d65 * float(value.get("scale", 1.0))
        if t == "regular":
            lo = float(value.get("lambda_min",
                                 value.get("wavelength_min", 360.0)))
            hi = float(value.get("lambda_max",
                                 value.get("wavelength_max", 830.0)))
            v = _parse_number_list(value["values"])
            if mode == "rgb":
                return np.full(3, v.mean())
            return np.interp(wl, np.linspace(lo, hi, len(v)), v)
    raise ValueError(f"cannot parse spectrum {value!r}")


# ---------------------------------------------------------------------------
# Bundle
# ---------------------------------------------------------------------------


def _medium_replace(med, idx, **kw):
    """Replace fields of region `idx` of `scene.medium` (one Medium or a
    tuple of regions)."""
    from .medium import Medium
    if isinstance(med, Medium):
        return med._replace(**kw)
    lst = list(med)
    lst[idx] = lst[idx]._replace(**kw)
    return tuple(lst)


def _set_row(t, i: int, v):
    """t with row i replaced by v, out of place and differentiable in v,
    without a host-to-device copy."""
    v = v.to(device=t.device, dtype=t.dtype).reshape(t.shape[1:])
    return torch.cat([t[:i], v[None], t[i + 1:]], 0)


def _leaf(v, device):
    """A traverse() value given back: a tensor as it is (its gradient
    kept), anything else as a float32 tensor on `device`."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


@dataclass
class SceneBundle:
    """Everything a render needs: the scene, the sensor, the film and the
    configuration (`tpusky/render/loader.py::SceneBundle`).

    `params` are the emitter's parameters; `traverse()` the scene-wide
    differentiable parameters (`mi.traverse`), as fresh tensors: set
    `requires_grad` on any of them, change them, and pass the dict to
    `render(params=...)`, which re-derives the scene (the sunsky
    precompute included) from them out of place, so the gradient reaches
    them. Without overrides the scene built at load time is rendered."""
    sensor: Any
    film: Film
    integrator: str
    max_depth: int
    rr_depth: int
    spp: int
    mode: str
    sampler_kind: str
    env_kind: Optional[str]
    env_params: Any                  # SunskyParams | ConstantEnv | ... | None
    scene_desc: dict = field(default_factory=dict)
    _scene_static: Any = None
    param_map: dict = field(default_factory=dict)
    variant: Variant = field(default_factory=Variant)
    device: Any = "cuda"
    _built: Any = None               # the scene as loaded, precomputed

    @property
    def params(self):
        return self.env_params

    def traverse(self):
        """Flat {path: tensor} over the emitter's parameters, each shape's
        `to_world`, each BSDF's reflectance and alpha, area-emitter
        radiance, bitmap reflectance data and medium extinction and
        albedo, with the reference's key names (e.g.
        `'ground.bsdf.reflectance.value'`); each a detached copy."""
        out = {}
        if self.env_params is not None:
            if hasattr(self.env_params, "_fields"):
                out.update({f"emitter.{k}": v for k, v in
                            zip(self.env_params._fields, self.env_params)
                            if isinstance(v, torch.Tensor)})
        sc = self._scene_static
        for name, info in self.param_map.items():
            if info.get("shape") is not None:
                j = info["shape"]
                out[f"{name}.to_world"] = sc.shapes.to_world[j]
                if info.get("emitter") is not None:
                    out[f"{name}.emitter.radiance.value"] = \
                        sc.area_radiance[j]
            if info.get("bsdf") is not None:
                b = info["bsdf"]
                out[f"{name}.bsdf.reflectance.value"] = sc.bsdfs.albedo[b]
                out[f"{name}.bsdf.alpha.value"] = sc.bsdfs.alpha[b]
                tex = int(info.get("mat", {}).get("tex_idx", -1))
                if tex >= 0 and sc.textures is not None:
                    t = sc.textures
                    off = int(t.offset[tex])
                    wd, hg = int(t.width[tex]), int(t.height[tex])
                    out[f"{name}.bsdf.reflectance.data"] = \
                        t.atlas[off:off + wd * hg, :3].reshape(hg, wd, 3)
            if info.get("medium") is not None:
                from .medium import Medium
                mi = (sc.medium if isinstance(sc.medium, Medium)
                      else sc.medium[info["medium"]])
                out[f"{name}.sigma_t"] = mi.sigma_t
                out[f"{name}.albedo"] = mi.albedo
        return {k: v.detach().clone() for k, v in out.items()}

    def _apply_params(self, scene, overrides):
        """Apply a (changed) `traverse()` dict to the scene out of place:
        a shape's new `to_world` re-derives its `to_object`
        (`torch.linalg.inv`) and area (`shapes.world_area`)
        differentiably; a reflectance in spectral mode is upsampled on
        the tensors (`rgb2spec.upsample_rgb_torch`)."""
        shapes, bsdfs = scene.shapes, scene.bsdfs
        tex, med = scene.textures, scene.medium
        area_rad = scene.area_radiance
        for key, v in overrides.items():
            if key.startswith("emitter."):
                continue                       # handled in build_scene
            # the longest object name the key starts with: an instanced
            # shape's name holds dots ('i1.a.0.to_world')
            name = max((n for n in self.param_map
                        if key.startswith(n + ".")), key=len, default=None)
            if name is None:
                raise KeyError(f"unknown scene parameter {key!r}")
            info, rest = self.param_map[name], key[len(name) + 1:]
            v = _leaf(v, self.device)
            if rest == "to_world":
                j = info["shape"]
                shapes = shapes._replace(
                    to_world=_set_row(shapes.to_world, j, v),
                    to_object=_set_row(shapes.to_object, j,
                                       torch.linalg.inv(v)),
                    area=_set_row(shapes.area, j,
                                  world_area(shapes.kind[j], v)))
            elif rest == "bsdf.reflectance.value":
                b = info["bsdf"]
                bsdfs = bsdfs._replace(albedo=_set_row(bsdfs.albedo, b, v))
                if self.mode == "spectral":
                    from ..ops.rgb2spec import upsample_rgb_torch
                    wl = torch.tensor(skyC.WAVELENGTHS, dtype=torch.float32,
                                      device=v.device)
                    bsdfs = bsdfs._replace(albedo_spec=_set_row(
                        bsdfs.albedo_spec, b, upsample_rgb_torch(v, wl)))
            elif rest == "bsdf.alpha.value":
                bsdfs = bsdfs._replace(
                    alpha=_set_row(bsdfs.alpha, info["bsdf"], v))
            elif rest == "bsdf.reflectance.data":
                t_i = int(info["mat"]["tex_idx"])
                off = int(tex.offset[t_i])
                flat = v.reshape(-1, 3)
                n = flat.shape[0]
                block = torch.cat([flat, tex.atlas[off:off + n, 3:]], -1)
                tex = tex._replace(atlas=torch.cat(
                    [tex.atlas[:off], block, tex.atlas[off + n:]], 0))
            elif rest == "emitter.radiance.value":
                area_rad = _set_row(area_rad, info["shape"], v)
            elif rest == "sigma_t" and info.get("medium") is not None:
                med = _medium_replace(med, info["medium"], sigma_t=v)
            elif rest == "albedo" and info.get("medium") is not None:
                med = _medium_replace(med, info["medium"], albedo=v)
            else:
                raise KeyError(f"unknown scene parameter {key!r}")
        return scene._replace(shapes=shapes, bsdfs=bsdfs, textures=tex,
                              medium=med, area_radiance=area_rad)

    def _derive(self, env_params):
        if self.env_kind == "sunsky":
            tables = load_tables(self.mode, device=self.device)
            env = sunsky_model.precompute(tables, env_params, self.mode)
        elif self.env_kind == "constant":
            env = env_params
        else:
            env = None
        return self._scene_static._replace(env=env)

    def build_scene(self, env_params=None, params=None):
        """The scene to render: the one built at load time without
        overrides, else re-derived from `env_params` and the emitter
        entries of `params` (precompute included) with the other entries
        of `params` applied."""
        if env_params is None and not params:
            if self._built is None:
                self._built = self._derive(self.env_params)
            return self._built
        env_params = self.env_params if env_params is None else env_params
        if params:
            em = {k.split(".", 1)[1]: _leaf(v, self.device)
                  for k, v in params.items() if k.startswith("emitter.")}
            if em and hasattr(env_params, "_replace"):
                env_params = env_params._replace(**em)
        scene = self._derive(env_params)
        if params:
            scene = self._apply_params(scene, params)
        return scene

    def render(self, seed: int = 0, spp: Optional[int] = None,
               env_params=None, params=None):
        """Render the bundle as the reference's `SceneBundle.render` does,
        keyed on `PRNGKey(seed)`'s two words, so a frame is the
        reference's lane for lane: through `render_aovs` (aov, depth),
        `render_moments`, `render_ptracer`, `render_stokes` or
        `integrator.render`. A float64 or mono variant raises
        NotImplementedError."""
        self.variant.check_renders()
        scene = self.build_scene(env_params, params)
        key = prng_key(seed)
        spp = spp or self.spp
        if self.integrator in ("aov", "depth"):
            from .aov import render_aovs
            idesc = next((v for v in self.scene_desc.values()
                          if isinstance(v, dict)
                          and v.get("type") in ("aov", "depth")), {})
            child_desc = next((v for v in idesc.values()
                               if isinstance(v, dict)
                               and v.get("type") in ("path", "direct")),
                              None)
            child = child_kw = None
            if child_desc is not None:      # nested integrator, aov.cpp:126
                child = child_desc["type"]
                child_kw = dict(spp=spp, max_depth=int(child_desc.get(
                    "max_depth", 2)), mode=self.mode)
            # the child renders at the bundle's key, whose seed 0 is the
            # reference's fixed PRNGKey(0) (R2)
            aovs = render_aovs(scene, self.sensor, self.film.height,
                               self.film.width, aovs=idesc.get("aovs"),
                               child=child, child_kwargs=child_kw,
                               child_seed=key)
            return aovs["depth"] if self.integrator == "depth" else aovs
        if self.integrator == "moment":
            return integrator_mod.render_moments(
                scene, self.sensor, self.film, key, spp=spp,
                max_depth=self.max_depth, rr_depth=self.rr_depth,
                mode=self.mode, sampler_kind=self.sampler_kind)
        if self.integrator == "ptracer":
            from .ptracer import render_ptracer
            return render_ptracer(
                scene, self.sensor, self.film, key,
                n_particles=self.film.height * self.film.width * spp,
                max_depth=self.max_depth, sampler_kind=self.sampler_kind,
                mode=self.mode)
        if self.integrator == "stokes":
            from .polarized import render_stokes
            return render_stokes(scene, self.sensor, self.film, key,
                                 spp=spp, max_depth=self.max_depth,
                                 rr_depth=self.rr_depth,
                                 sampler_kind=self.sampler_kind,
                                 mode=self.mode)
        return integrator_mod.render(
            scene, self.sensor, self.film, key, spp=spp,
            max_depth=self.max_depth, rr_depth=self.rr_depth,
            mode=self.mode, sampler_kind=self.sampler_kind)


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------


def _one_transform(op: str, arg) -> np.ndarray:
    if op == "translate":
        return T.translate(arg)
    if op == "scale":
        return T.scale(arg)
    if op == "rotate":
        if isinstance(arg, dict):
            return T.rotate(arg["axis"], float(arg["angle"]))
        arg = np.asarray(arg, np.float64)
        return T.rotate(arg[:3], float(arg[3]))
    if op in ("look_at", "lookat"):
        return T.look_at(arg["origin"], arg["target"],
                         arg.get("up", (0, 0, 1)))
    if op == "matrix":
        return np.asarray(arg, np.float32).reshape(4, 4)
    raise ValueError(f"unsupported transform op {op!r}")


def _parse_to_world(v) -> np.ndarray:
    """4x4 float32 from: None, a (4, 4) array, {'type': 'look_at', ...},
    {'look_at': {...}}, {'matrix': ...}, or a chain {'transforms': [{op:
    arg}, ...]} applied first to last (XML `<transform>` semantics)."""
    if v is None:
        return np.eye(4, dtype=np.float32)
    if isinstance(v, dict):
        if v.get("type") in ("look_at", "lookat"):
            return T.look_at(v["origin"], v["target"], v.get("up", (0, 0, 1)))
        if "transforms" in v:
            m = np.eye(4, dtype=np.float32)
            for step in v["transforms"]:
                (op, arg), = step.items()
                m = _one_transform(op, arg).astype(np.float32) @ m
            return m
        if set(v) == {"type", "value"}:
            return _one_transform(v["type"], v["value"]).astype(np.float32)
        if len(v) == 1:
            (op, arg), = v.items()
            return _one_transform(op, arg).astype(np.float32)
        raise ValueError(f"unsupported transform dict {v}")
    arr = np.asarray(v, np.float32)
    if arr.shape != (4, 4):
        raise ValueError(f"to_world must be 4x4, got {arr.shape}")
    return arr


# Named conductor IORs at RGB primaries (`data/ior/*.spd` in Mitsuba)
_CONDUCTOR_IOR = {
    "Au": ([0.143, 0.375, 1.442], [3.983, 2.386, 1.603]),
    "Ag": ([0.155, 0.116, 0.138], [4.828, 3.122, 2.146]),
    "Cu": ([0.200, 0.924, 1.102], [3.912, 2.448, 2.167]),
    "Al": ([1.345, 0.965, 0.617], [7.475, 6.400, 5.303]),
    "none": ([0.0, 0.0, 0.0], [1e4, 1e4, 1e4]),  # perfect mirror
}


def _parse_to_uv(v):
    """3x3 uv transform from None, a (3, 3) array, {'scale': s|[sx, sy]},
    {'translate': [tx, ty]}, {'rotate': deg}, {'matrix': ...} or
    {'transforms': [...]} (Mitsuba's `to_uv`)."""
    if v is None:
        return None

    def one(op, arg):
        m = np.eye(3, dtype=np.float32)
        if op == "scale":
            s = np.broadcast_to(np.asarray(arg, np.float32), (2,)) \
                if np.ndim(arg) else np.array([arg, arg], np.float32)
            m[0, 0], m[1, 1] = float(np.atleast_1d(s)[0]), \
                float(np.atleast_1d(s)[-1])
        elif op == "translate":
            t = np.atleast_1d(np.asarray(arg, np.float32))
            m[0, 2], m[1, 2] = float(t[0]), float(t[-1])
        elif op == "rotate":
            a = np.deg2rad(float(arg))
            m[0, 0] = m[1, 1] = np.cos(a)
            m[0, 1], m[1, 0] = -np.sin(a), np.sin(a)
        elif op == "matrix":
            m = np.asarray(arg, np.float32).reshape(3, 3)
        else:
            raise ValueError(f"unsupported to_uv op {op!r}")
        return m

    if isinstance(v, dict):
        m = np.eye(3, dtype=np.float32)
        steps = (v["transforms"] if "transforms" in v
                 else [{op: arg} for op, arg in v.items()])
        for step in steps:
            (op, arg), = step.items()
            m = one(op, arg) @ m
        return m
    return np.asarray(v, np.float32).reshape(3, 3)


def _load_bitmap(desc):
    """(H, W, C) float32 linear image from an inline array or a file (EXR
    as stored, RGB order; PNG sRGB-decoded unless `raw`)."""
    if "data" in desc or "bitmap" in desc:
        return np.asarray(desc.get("data", desc.get("bitmap")), np.float32)
    fn = desc["filename"]
    if fn.lower().endswith(".exr"):
        from ..utils.io import read_exr
        img, names = read_exr(fn)
        return np.ascontiguousarray(
            img[..., ::-1] if names[:3] == ["B", "G", "R"] else img)
    if fn.lower().endswith(".png"):
        from ..utils.io import read_png
        img = read_png(fn)
        if not desc.get("raw", False):   # sRGB -> linear (`bitmap.cpp`)
            img = np.where(img <= 0.04045, img / 12.92,
                           ((img + 0.055) / 1.055) ** 2.4)
        return img.astype(np.float32)
    raise ValueError(f"unsupported bitmap format: {fn!r}")


def _parse_texture(desc, textures):
    """Append a texture description; return its index."""
    t = desc["type"]
    if t == "checkerboard":
        textures.append(dict(
            kind="checkerboard",
            color0=spectrum_to_channels(desc.get("color0", 0.4), "rgb"),
            color1=spectrum_to_channels(desc.get("color1", 0.2), "rgb"),
            to_uv=_parse_to_uv(desc.get("to_uv"))))
    elif t == "bitmap":
        textures.append(dict(kind="bitmap", data=_load_bitmap(desc),
                             to_uv=_parse_to_uv(desc.get("to_uv")),
                             wrap=desc.get("wrap_mode", "repeat")))
    elif t == "volume":
        # 3D texture (`volume.cpp`) over a gridvolume / constvolume /
        # inline grid, evaluated at the world-space hit position
        vol = next((v for v in desc.values()
                    if isinstance(v, dict) and v.get("type")
                    in ("gridvolume", "constvolume")), desc)
        to_world = _parse_to_world(vol.get("to_world",
                                           desc.get("to_world")))
        if vol.get("type") == "gridvolume":
            from ..utils.io import read_vol
            grid, bmin, bmax = read_vol(vol["filename"])
            # the bbox -> unit-cube mapping baked into to_world
            bbox_m = np.eye(4, dtype=np.float32)
            bbox_m[:3, :3] = np.diag(np.maximum(bmax - bmin, 1e-9))
            bbox_m[:3, 3] = bmin
            to_world = to_world @ bbox_m
        elif vol.get("type") == "constvolume":
            grid = np.broadcast_to(
                spectrum_to_channels(vol.get("value", 1.0), "rgb"),
                (1, 1, 1, 3)).astype(np.float32)
        else:
            grid = np.asarray(desc["grid"], np.float32)
        textures.append(dict(kind="volume", grid=grid, to_world=to_world))
    elif t == "mesh_attribute":
        name = desc.get("name", "vertex_color")
        if name != "vertex_color":
            raise ValueError("only the 'vertex_color' mesh attribute is "
                             f"supported, got {name!r}")
        textures.append(dict(kind="mesh_attribute",
                             scale=float(desc.get("scale", 1.0))))
    else:
        raise ValueError(f"unsupported texture type {t!r}")
    return len(textures) - 1


def _bump_to_normal(desc, textures):
    """`bumpmap.cpp`: a height field turned into a tangent-space normal
    map at load time, by central differences (one-sided at the borders)
    in uv units, v growing down the rows; appended as a bitmap, its
    index returned."""
    bm = desc.get("bump_texture", desc.get("texture"))
    height = _load_bitmap(dict(bm, raw=True))
    if height.ndim == 3:
        height = height.mean(-1)
    s = float(desc.get("scale", 1.0))
    h_img, w_img = height.shape
    dhdv, dhdu = np.gradient(height)
    dhdu = dhdu * w_img
    dhdv = dhdv * h_img
    nrm = np.stack([-s * dhdu, -s * dhdv, np.ones_like(height)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    textures.append(dict(kind="bitmap",
                         data=(nrm * 0.5 + 0.5).astype(np.float32),
                         to_uv=_parse_to_uv(bm.get("to_uv")),
                         wrap=bm.get("wrap_mode", "repeat")))
    return len(textures) - 1


_WRAPPERS = ("twosided", "mask", "normalmap", "bumpmap")


def _build_bsdf(desc, mode, textures=None, materials=None):
    """-> material dict {kind, rgb, spec, twosided, alpha, eta, k, ior,
    opacity, tex_idx, normal_tex_idx, extra, blend_a, blend_b, blend_w}.

    A `blendbsdf` appends its two children to `materials` and returns a
    kind-10 row referencing them; the blend's twosided, opacity and
    normal-map wrappers are pushed down onto the children."""
    from .bsdf import (BLEND, CIRCULAR, CONDUCTOR, DIELECTRIC, DIFFUSE,
                       HAIR, MEASURED, MEASURED_POL, NULL_BSDF, PLASTIC,
                       POLARIZER, PPLASTIC, PRINCIPLED, PRINCIPLED_THIN,
                       RETARDER, ROUGH_CONDUCTOR, ROUGH_DIELECTRIC,
                       ROUGH_PLASTIC, THIN_DIELECTRIC)
    twosided = False
    opacity = 1.0
    normal_tex_idx = -1
    while desc.get("type") in _WRAPPERS:
        t_w = desc.get("type")
        if t_w == "twosided":
            twosided = True
        elif t_w == "mask":   # `mask.cpp`: scalar opacity + nested BSDF
            op = desc.get("opacity", 0.5)
            opacity = float(np.mean(spectrum_to_channels(op, "rgb")))
        elif textures is None:
            raise ValueError(f"{t_w} not supported here")
        elif t_w == "normalmap":   # `normalmap.cpp`: tangent-space map
            nm = desc.get("normalmap")
            textures.append(dict(kind="bitmap",
                                 data=_load_bitmap(dict(nm, raw=True)),
                                 to_uv=_parse_to_uv(nm.get("to_uv")),
                                 wrap=nm.get("wrap_mode", "repeat")))
            normal_tex_idx = len(textures) - 1
        else:
            normal_tex_idx = _bump_to_normal(desc, textures)
        inner = [v for v in desc.values() if isinstance(v, dict)
                 and v.get("type") not in (None, "checkerboard", "bitmap")
                 and v.get("type") not in _WRAPPERS]
        nested = [v for v in desc.values() if isinstance(v, dict)
                  and v.get("type") in _WRAPPERS]
        desc = (inner[0] if inner else
                nested[0] if nested else {"type": "diffuse"})
    t = desc.get("type", "diffuse")
    mat = dict(kind=DIFFUSE, rgb=np.full(3, 0.5), spec=np.full(11, 0.5),
               twosided=twosided, alpha=0.1,
               eta=np.array(_CONDUCTOR_IOR["Au"][0]),
               k=np.array(_CONDUCTOR_IOR["Au"][1]), ior=1.5046,
               opacity=opacity, tex_idx=-1, normal_tex_idx=normal_tex_idx,
               extra=np.array([0, 0.5, 0, 0, 0, 0, 0, 0], np.float64),
               blend_a=0, blend_b=0, blend_w=0.0)

    if t == "blendbsdf":
        if materials is None:
            raise ValueError("blendbsdf not supported here")
        children = [v for v in desc.values() if isinstance(v, dict)
                    and "type" in v
                    and v.get("type") not in ("checkerboard", "bitmap")]
        if len(children) != 2:
            raise ValueError("blendbsdf needs exactly two nested BSDFs")
        w = desc.get("weight", 0.5)
        if isinstance(w, dict):
            raise ValueError("blendbsdf: textured weight not supported")
        idx = []
        for child in children:
            cm = _build_bsdf(child, mode, textures, materials)
            if cm["kind"] == BLEND:
                raise ValueError("blendbsdf: nested blends not supported")
            cm["twosided"] = cm["twosided"] or twosided
            cm["opacity"] = cm["opacity"] * opacity
            if normal_tex_idx >= 0 and cm["normal_tex_idx"] < 0:
                cm["normal_tex_idx"] = normal_tex_idx
            idx.append(len(materials))
            materials.append(cm)
        mat.update(kind=BLEND, blend_a=idx[0], blend_b=idx[1],
                   blend_w=float(w), twosided=twosided, opacity=opacity)
        return mat

    def _refl(value):
        """Constant spectrum or nested texture plugin."""
        if (isinstance(value, dict)
                and value.get("type") in ("checkerboard", "bitmap",
                                          "volume", "mesh_attribute")):
            if textures is None:
                raise ValueError("textured reflectance not supported here")
            mat["tex_idx"] = _parse_texture(value, textures)
            return
        _spectrum(value)

    def _spectrum(value):
        mat["rgb"] = spectrum_to_channels(value, "rgb")
        mat["spec"] = spectrum_to_channels(value, "spectral")

    def _ior(default_int):
        return (float(desc.get("int_ior", default_int))
                / float(desc.get("ext_ior", 1.000277)))

    if t == "diffuse":
        _refl(desc.get("reflectance", 0.5))
    elif t in ("roughconductor", "conductor"):
        mat["kind"] = ROUGH_CONDUCTOR if t == "roughconductor" else CONDUCTOR
        material = desc.get("material", "Au")
        if material not in _CONDUCTOR_IOR:
            raise ValueError(f"unknown conductor material {material!r}")
        mat["eta"] = np.asarray(desc.get("eta",
                                         _CONDUCTOR_IOR[material][0]))
        mat["k"] = np.asarray(desc.get("k", _CONDUCTOR_IOR[material][1]))
        mat["alpha"] = float(desc.get("alpha", 0.1))
        _spectrum(desc.get("specular_reflectance", 1.0))
    elif t in ("dielectric", "roughdielectric", "thindielectric"):
        mat["kind"] = {"dielectric": DIELECTRIC,
                       "roughdielectric": ROUGH_DIELECTRIC,
                       "thindielectric": THIN_DIELECTRIC}[t]
        mat["ior"] = _ior(1.5046)
        mat["alpha"] = float(desc.get("alpha", 0.1))
        mat["rgb"] = np.ones(3)
        mat["spec"] = np.ones(11)
    elif t in ("plastic", "roughplastic"):
        mat["kind"] = PLASTIC if t == "plastic" else ROUGH_PLASTIC
        _refl(desc.get("diffuse_reflectance", 0.5))
        mat["ior"] = _ior(1.49)
        mat["alpha"] = float(desc.get("alpha", 0.1))
    elif t == "principled":
        mat["kind"] = PRINCIPLED
        _refl(desc.get("base_color", 0.5))
        mat["alpha"] = float(desc.get("roughness", 0.5))
        # eta <-> specular correspondence (`principled.cpp:214-228`)
        if "eta" in desc and "specular" in desc:
            raise ValueError("principled: give either eta or specular")
        if "eta" in desc:
            e = float(desc["eta"])
            spec = ((e - 1.0) / (e + 1.0)) ** 2 / 0.08
        else:
            spec = float(desc.get("specular", 0.5))
        mat["extra"] = np.array([
            float(desc.get("metallic", 0.0)), spec,
            float(desc.get("sheen", 0.0)),
            float(desc.get("sheen_tint", 0.0)),
            float(desc.get("clearcoat", 0.0)),
            float(desc.get("clearcoat_gloss", 0.0)),
            float(desc.get("spec_tint", 0.0)), 0.0], np.float64)
    elif t == "principledthin":
        mat["kind"] = PRINCIPLED_THIN
        _refl(desc.get("base_color", 0.5))
        mat["alpha"] = float(desc.get("roughness", 0.5))
        mat["ior"] = float(desc.get("eta", 1.5))
        mat["extra"] = np.array([
            float(desc.get("spec_trans", 0.0)),
            # diff_trans has range [0, 2] (`principledthin.cpp:283`);
            # stored normalised to [0, 1]
            float(desc.get("diff_trans", 0.0)) / 2.0,
            float(desc.get("sheen", 0.0)),
            float(desc.get("sheen_tint", 0.0)),
            float(desc.get("flatness", 0.0)),
            float(desc.get("spec_tint", 0.0)), 0.0, 0.0], np.float64)
    elif t == "measured":
        mat["kind"] = MEASURED
        # one dataset a scene, attached by `load_dict` from this marker
        mat["measured_file"] = desc["filename"]
    elif t == "measured_polarized":
        mat["kind"] = MEASURED_POL
        mat["measured_pol_file"] = (
            desc["filename"], float(desc.get("alpha_sample", 0.1)),
            float(desc.get("wavelength", -1.0)))
    elif t == "hair":
        mat["kind"] = HAIR
        if "sigma_a" in desc and ("eumelanin" in desc
                                  or "pheomelanin" in desc):
            raise ValueError("hair: give either sigma_a or pigmentation, "
                             "not both")
        if "sigma_a" in desc:
            _spectrum(desc["sigma_a"])
        else:
            # pigmentation -> absorption, d'Eon et al. 2011 coefficients
            # (`hair.cpp:485-492`)
            eu = float(desc.get("eumelanin", 1.3))
            ph = float(desc.get("pheomelanin", 0.2))
            sig = (eu * np.array([0.419, 0.697, 1.37])
                   + ph * np.array([0.187, 0.4, 1.05]))
            mat["rgb"] = sig
            peak = max(float(sig.max()), 1.0)
            mat["spec"] = _upsample(sig / peak) * peak
        scale = float(desc.get("scale", 1.0))
        mat["rgb"] = np.asarray(mat["rgb"]) * scale
        mat["spec"] = np.asarray(mat["spec"]) * scale
        mat["alpha"] = float(desc.get("longitudinal_roughness", 0.3))
        mat["ior"] = _ior(1.55)                            # amber
        mat["extra"] = np.array([
            float(desc.get("azimuthal_roughness", 0.3)),
            float(desc.get("scale_tilt", 2.0)),
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0], np.float64)
    elif t == "pplastic":
        mat["kind"] = PPLASTIC
        _refl(desc.get("diffuse_reflectance", 0.5))
        mat["ior"] = _ior(1.49)                            # polypropylene
        mat["alpha"] = float(desc.get("alpha", 0.1))
    elif t in ("polarizer", "retarder", "circular"):
        mat["kind"] = {"polarizer": POLARIZER, "retarder": RETARDER,
                       "circular": CIRCULAR}[t]
        _spectrum(desc.get("transmittance", 1.0))
        mat["extra"] = np.array([
            float(desc.get("theta", 0.0)),
            float(desc.get("delta", 90.0)),
            1.0 if desc.get("left_handed", False) else 0.0,
            0.0, 0.0, 0.0, 0.0, 0.0], np.float64)
    elif t == "null":
        mat["kind"] = NULL_BSDF
    else:
        raise ValueError(f"unsupported bsdf {t!r}")
    return mat


def _phase_child_kind(desc, slot, out):
    """One non-blend phase child -> 'hg' | 'hg2' | 'rayleigh' | 'tab' |
    'sggx'; fills the matching `make_medium` arguments of `out`."""
    t = desc.get("type", "isotropic")
    if t in ("isotropic", "hg"):
        g = float(desc.get("g", 0.0)) if t == "hg" else 0.0
        if slot == 0:
            out["g"] = g
            return "hg"
        out["g2"] = g
        return "hg2"
    if t == "rayleigh":
        return "rayleigh"
    if t == "tabphase":
        out["phase_tab"] = _parse_number_list(desc["values"])
        return "tab"
    if t == "sggx":
        s = desc.get("S", desc.get("s"))
        if isinstance(s, dict):   # constvolume with six values (`sggx.cpp`)
            if s.get("type") != "constvolume":
                raise ValueError("sggx: only a constvolume S is supported")
            s = s.get("value")
        out["sggx_s"] = np.asarray(s, np.float32).reshape(6)
        return "sggx"
    raise ValueError(f"unknown phase {t!r}")


def _parse_phase(desc) -> dict:
    """Phase-function description -> `make_medium` arguments (Mitsuba's
    isotropic, hg, rayleigh, tabphase, sggx and blendphase)."""
    out = {}
    if desc.get("type") == "blendphase":
        children = [v for v in desc.values()
                    if isinstance(v, dict) and v.get("type") not in
                    ("constvolume", "gridvolume", None)]
        if len(children) != 2:
            raise ValueError("blendphase needs exactly two children")
        w = desc.get("weight", 0.5)
        if isinstance(w, dict):
            w = w.get("value", 0.5)
        ka = _phase_child_kind(children[0], 0, out)
        kb = _phase_child_kind(children[1], 1 if ka in ("hg", "hg2") else 0,
                               out)
        if ka == kb and ka not in ("hg", "hg2"):
            raise ValueError("blendphase children must differ in type "
                             "(or both be hg)")
        # the SECOND child is picked with probability `weight`
        # (`blendphase.cpp:138-144`)
        out["phase_w"] = float(w)
        out["phase"] = ("blend", ka, kb)
        return out
    out["phase"] = _phase_child_kind(desc, 0, out)
    return out


_SUB_SENSORS = ("perspective", "orthographic", "spherical", "thinlens",
                "distant", "radiancemeter", "irradiancemeter")


def _build_sensor(sensor_desc, w, h, device):
    """A sensor from a Mitsuba-style description, on `device`."""
    from .sensors import (Batch, RadianceMeter, ThinLens, make_distant,
                          make_irradiancemeter)

    def f32(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)
    st = sensor_desc["type"]
    to_world = _parse_to_world(sensor_desc.get("to_world"))
    fov = float(sensor_desc.get("fov", 45.0))
    if st == "thinlens":
        return ThinLens(f32(to_world), f32(fov), f32(w / h),
                        f32(float(sensor_desc.get("aperture_radius", 0.1))),
                        f32(float(sensor_desc.get("focus_distance", 5.0))))
    if st == "perspective":
        return Perspective(f32(to_world), f32(fov), f32(w / h), f32(1e-2))
    if st == "orthographic":
        return Orthographic(f32(to_world), f32(1.0))
    if st == "distant":
        return make_distant(
            sensor_desc.get("direction", tuple(-to_world[:3, 2])),
            center=sensor_desc.get("center", (0.0, 0.0, 0.0)),
            radius=float(sensor_desc.get("radius", 1.0)),
            extent=sensor_desc.get("extent"), device=device)
    if st == "radiancemeter":
        o = np.asarray(sensor_desc.get("origin", to_world[:3, 3]),
                       np.float32)
        dr = np.asarray(sensor_desc.get("direction", to_world[:3, 2]),
                        np.float32)
        return RadianceMeter(f32(o), f32(dr / np.linalg.norm(dr)))
    if st == "irradiancemeter":
        return make_irradiancemeter(
            sensor_desc.get("origin", tuple(to_world[:3, 3])),
            sensor_desc.get("normal", tuple(to_world[:3, 2])),
            float(sensor_desc.get("half_extent", 1.0)), device=device)
    if st == "batch":
        subs = [v for v in sensor_desc.values() if isinstance(v, dict)
                and v.get("type") in _SUB_SENSORS]
        k = max(len(subs), 1)
        return Batch(tuple(_build_sensor(s, w // k, h, device)
                           for s in subs))
    return make_spherical(tuple(to_world[:3, 3]), device=device)


def _group_children(v):
    return {k: c for k, c in v.items() if isinstance(c, dict) and "type" in c}


def _expand_instances(d: dict) -> dict:
    """Flatten shapegroup/instance pairs (`shapegroup.cpp`,
    `instance.cpp`) into plain shapes with composed transforms: each
    instance contributes copies of its group's children with
    `instance.to_world @ child.to_world`."""
    groups, rest = {}, {}
    for k, v in d.items():
        if isinstance(v, dict) and v.get("type") == "shapegroup":
            groups[k] = _group_children(v)
        else:
            rest[k] = v
    if not groups and not any(isinstance(v, dict)
                              and v.get("type") == "instance"
                              for v in rest.values()):
        return d
    out = {}
    uid = 0
    for k, v in rest.items():
        if not (isinstance(v, dict) and v.get("type") == "instance"):
            out[k] = v
            continue
        ref = None
        for vv in v.values():
            if isinstance(vv, str) and vv in groups:
                ref = groups[vv]
            elif isinstance(vv, dict) and vv.get("type") == "shapegroup":
                ref = _group_children(vv)
            elif isinstance(vv, dict) and vv.get("type") == "ref":
                ref = groups.get(vv.get("id"))
        if ref is None:
            raise ValueError(f"instance {k!r} references no shapegroup")
        m_inst = _parse_to_world(v.get("to_world"))
        for ck, cv in ref.items():
            child = dict(cv)
            child["to_world"] = (
                m_inst @ _parse_to_world(child.get("to_world")))
            out[f"{k}.{ck}.{uid}"] = child
            uid += 1
    return out


def _expand_merge(d: dict) -> dict:
    """Hoist the children of `merge` shapes (`merge.cpp`): the scene is
    already one fused table, so merging is flattening the container."""
    if not any(isinstance(v, dict) and v.get("type") == "merge"
               for v in d.values()):
        return d
    out, uid = {}, 0
    for k, v in d.items():
        if not (isinstance(v, dict) and v.get("type") == "merge"):
            out[k] = v
            continue
        m_outer = v.get("to_world")
        for ck, cv in _group_children(v).items():
            child = dict(cv)
            if m_outer is not None:
                child["to_world"] = (
                    _parse_to_world(m_outer)
                    @ _parse_to_world(child.get("to_world")))
            out[f"{k}.{ck}.{uid}"] = child
            uid += 1
    return out


def _volume(x):
    """gridvolume (`grid.cpp`) / constvolume (`const.cpp`) / a plain or
    XML rgb value -> (scalar value or None, (D, H, W) grid or None)."""
    if not isinstance(x, dict) or x.get("type") in ("rgb", None):
        return (x.get("value") if isinstance(x, dict) else x), None
    if x.get("type") == "constvolume":
        return x.get("value", 1.0), None
    if x.get("type") != "gridvolume":
        raise ValueError(f"expected gridvolume, got {x.get('type')!r}")
    if "grid" in x:
        grid = np.asarray(x["grid"], np.float32)
    else:
        from ..utils.io import read_vol
        grid = read_vol(x["filename"])[0]
    if grid.ndim == 4:
        grid = grid.mean(-1)
    return None, grid


def _interior_medium(t, value, mode, device):
    """The participating medium bound to a sphere's or a cube's interior
    (shape `interior` refs, `homogeneous.cpp`/`heterogeneous.cpp`); the
    boundary is index-matched, so the shape joins no surface table."""
    from .medium import make_medium
    if t not in ("sphere", "cube"):
        raise ValueError("interior media require a convex sphere/cube "
                         "boundary, got " + t)
    idesc = value["interior"]
    mtype = idesc.get("type", "homogeneous")
    if mtype not in ("homogeneous", "heterogeneous"):
        raise ValueError(f"unsupported medium type {mtype!r}")
    phase_kwargs = _parse_phase(idesc.get("phase", {"type": "isotropic"}))

    def num(x):   # unwrap XML {"type": "rgb", "value": [...]}
        return x["value"] if isinstance(x, dict) else x
    density = None
    if mtype == "heterogeneous":
        if t != "cube":
            raise ValueError("heterogeneous media require a cube boundary "
                             "(gridvolume bbox)")
        sig_v, density = _volume(idesc.get("sigma_t", 1.0))
        if density is None:   # constant sigma_t, still allowed
            density = np.ones((2, 2, 2), np.float32)
            sig = np.atleast_1d(np.asarray(sig_v, np.float32))
        else:
            sig = np.ones(1, np.float32)
        sig = sig * float(idesc.get("scale", 1.0))
    else:
        sig = np.atleast_1d(np.asarray(num(idesc.get("sigma_t", 1.0)),
                                       np.float32))
    alb = np.atleast_1d(np.asarray(num(idesc.get("albedo", 0.75)),
                                   np.float32))
    if mode == "spectral":
        sig, alb = sig.mean(None)[None], alb.mean(None)[None]
    return make_medium(sig, alb, to_world=_parse_to_world(
        value.get("to_world")), kind=t, density=density,
        n_steps=int(idesc.get("n_steps", 64)),
        channel_mis=bool(idesc.get("channel_mis", False)),
        device=device, **phase_kwargs)


def _cylinder_frame(value):
    """`cylinder.cpp`'s p0, p1 and radius as a frame composed with
    to_world (the canonical cylinder is z in [0, 1], radius 1)."""
    p0 = np.asarray(value.get("p0", [0, 0, 0]), np.float64)
    p1 = np.asarray(value.get("p1", [0, 0, 1]), np.float64)
    r = float(value.get("radius", 1.0))
    axis = p1 - p0
    length = np.linalg.norm(axis)
    zl = axis / max(length, 1e-12)
    up = (np.array([0.0, 0.0, 1.0]) if abs(zl[2]) < 0.9
          else np.array([1.0, 0.0, 0.0]))
    xl = np.cross(up, zl)
    xl /= np.linalg.norm(xl)
    yl = np.cross(zl, xl)
    frame = np.eye(4)
    frame[:3, 0] = xl * r
    frame[:3, 1] = yl * r
    frame[:3, 2] = zl * length
    frame[:3, 3] = p0
    return frame.astype(np.float32)


def _read_mesh(t, value):
    """(positions, normals, indices, uvs, colours or None) of an obj, ply
    or serialized shape (the OBJ through the native parser where it runs,
    `utils/native.py`)."""
    if t == "obj":
        from ..utils.native import load_obj
        pos, nrm, idx, uvs = load_obj(value["filename"])
        vcols = None
    elif t == "ply":
        from ..utils.meshio import read_ply
        pos, nrm, idx, uvs, vcols = read_ply(value["filename"])
    else:
        from ..utils.meshio import read_serialized
        pos, nrm, idx, uvs = read_serialized(
            value["filename"], shape_index=int(value.get("shape_index", 0)),
            face_normals=bool(value.get("face_normals", False)))
        vcols = None
    if value.get("face_normals"):
        nrm = np.zeros_like(pos)     # geometric normals at hit time
    return pos, nrm, idx, uvs, vcols


_INTEGRATORS = ("path", "direct", "depth", "aov", "moment", "ptracer",
                "prb", "prb_basic", "direct_projective", "prb_projective",
                "volpath", "volpathmis", "prbvolpath")
_SENSORS = _SUB_SENSORS + ("batch",)
_DECLARATIONS = ("diffuse", "conductor", "roughconductor", "dielectric",
                 "roughdielectric", "plastic", "null", "mask", "twosided",
                 "blendbsdf", "box", "gaussian", "tent", "lanczos",
                 "mitchell", "catmullrom")
_SAMPLERS = {"independent": "independent", "stratified": "stratified",
             "multijitter": "multijitter", "orthogonal": "orthogonal",
             "ldsampler": "qmc", "sobol": "qmc"}


def _film(film_desc):
    """The Film of a film description (hdrfilm or specfilm, its filter
    and crop window)."""
    h = int(film_desc.get("height", 256))
    w = int(film_desc.get("width", 256))
    rf = film_desc.get("rfilter")
    rfilter = rf.get("type", "box") if isinstance(rf, dict) else "box"
    if rfilter not in ("box", "gaussian", "tent", "mitchell", "lanczos",
                       "catmullrom"):
        rfilter = "box"
    # crop window (`hdrfilm.cpp:46`)
    crop_offset = crop_size = None
    if "crop_width" in film_desc or "crop_height" in film_desc:
        cw = int(film_desc.get("crop_width", w))
        ch = int(film_desc.get("crop_height", h))
        cx = int(film_desc.get("crop_offset_x", 0))
        cy = int(film_desc.get("crop_offset_y", 0))
        if not (0 <= cx and cx + cw <= w and 0 <= cy and cy + ch <= h):
            raise ValueError("crop window exceeds the film")
        crop_offset, crop_size = (cx, cy), (cw, ch)
    if film_desc.get("type") != "specfilm":
        return Film(h, w, 3, rfilter, None, crop_offset, crop_size)
    # spectral band film (`specfilm.cpp`): sensor response functions from
    # an explicit `srfs` list or the nested regular/irregular spectra,
    # one channel each ordered by key name; else wavelength bands
    srf_descs = None
    if "srfs" in film_desc:
        srf_descs = list(film_desc["srfs"])
    else:
        named = [v for k, v in sorted(film_desc.items())
                 if isinstance(v, dict)
                 and v.get("type") in ("regular", "irregular")
                 and k != "rfilter"]
        srf_descs = named or None
    if srf_descs is not None:
        from .spectra import parse_srf
        srfs = tuple(parse_srf(s) for s in srf_descs)
        lo = min(s[0] for s in srfs)
        hi = max(s[1] for s in srfs)
        bands = tuple(lo + (hi - lo) * i / len(srfs)
                      for i in range(len(srfs) + 1))
        return Film(h, w, len(srfs), rfilter, bands, crop_offset,
                    crop_size, srfs)
    if "bands" in film_desc:
        bands = tuple(float(b) for b in film_desc["bands"])
    else:
        nb = int(film_desc.get("n_bands", 4))
        lo = float(film_desc.get("lambda_min", 360.0))
        hi = float(film_desc.get("lambda_max", 720.0))
        bands = tuple(lo + (hi - lo) * i / nb for i in range(nb + 1))
    return Film(h, w, len(bands) - 1, rfilter, bands, crop_offset, crop_size)


def _environment(env_desc, mode, device):
    """(env_kind, env_params, env_to_world rotation or None)."""
    env_rot = None
    if "to_world" in env_desc:
        env_rot = _parse_to_world(env_desc["to_world"])[:3, :3]
    t = env_desc["type"]
    if t == "sunsky":
        return "sunsky", _sunsky_params_from_props(env_desc, mode,
                                                   device), env_rot
    if t == "constant":
        rad_prop = env_desc.get("radiance", 1.0)
        # a scalar / uniform property is a FLAT spectrum (uniform.cpp),
        # not an RGB colour: spectral mode does not upsample it
        is_uniform = (isinstance(rad_prop, (int, float))
                      or (isinstance(rad_prop, dict)
                          and rad_prop.get("type") == "uniform"))
        cls = UniformEnv if is_uniform else ConstantEnv
        return "constant", cls(torch.tensor(
            spectrum_to_channels(rad_prop, "rgb").astype(np.float32),
            device=device)), env_rot
    if t == "envmap":
        from ..utils.io import read_exr
        from .emitters import make_envmap
        if "bitmap" in env_desc:
            bm = np.asarray(env_desc["bitmap"], np.float32)
        else:
            img, names = read_exr(env_desc["filename"])
            bm = np.ascontiguousarray(
                img[..., ::-1] if names[:3] == ["B", "G", "R"] else img)
        # a precomputed state, not re-derived from parameters
        return "constant", make_envmap(
            bm, float(env_desc.get("scale", 1.0)),
            spectral=(mode == "spectral"), device=device), env_rot
    raise ValueError(f"unsupported environment {t!r}")


def _measured_datasets(materials, device):
    """(kind-17 dataset, kind-18 dataset), each None or the one file the
    materials name (markers popped)."""
    from ..ops.tensorfile import read_tensor_file
    from .measured import load_measured, load_measured_polarized
    files = {m.pop("measured_file") for m in materials
             if "measured_file" in m}
    pol = {m.pop("measured_pol_file") for m in materials
           if "measured_pol_file" in m}
    if len(files) > 1:
        raise ValueError("only one measured BRDF dataset per scene is "
                         "supported")
    if len(pol) > 1:
        raise ValueError("only one measured_polarized dataset per scene is "
                         "supported")
    measured = (load_measured(read_tensor_file(files.pop()), device=device)
                if files else None)
    measured_pol = None
    if pol:
        fn, a_s, wl = pol.pop()
        measured_pol = load_measured_polarized(read_tensor_file(fn), a_s, wl,
                                               device=device)
    return measured, measured_pol


def load_dict(d: dict, mode="rgb", device="cuda") -> SceneBundle:
    """Assemble a renderable bundle from a Mitsuba-style scene dict, its
    tensors on `device`. `mode` is "rgb", "spectral", a Mitsuba variant
    name or a `config.Variant`: a polarized variant turns the path and
    direct integrators into the Stokes one (`stokes.cpp`), as the
    reference's `tpusky.load_dict` does; a float64 or mono variant loads
    and refuses to render."""
    variant = resolve(mode)
    mode = "spectral" if variant.mode == "spectral" else "rgb"
    if d.get("type") != "scene":
        raise ValueError("top-level dict must have type='scene'")
    d = _expand_merge(_expand_instances(d))

    integrator = {"type": "path"}
    top_level_sampler = None
    sensor_desc = None
    env_desc = None
    shapes, materials, areas, meshes = [], [], [], []
    curves, textures = [], []
    point_lights, directional_lights, spot_lights = [], [], []
    point_weights, dir_weights, spot_weights = [], [], []
    dir_areas = {}   # shape index -> radiance (directionalarea)
    media_list = []  # per-shape participating media (render/medium.py)
    sdf_grid = None
    param_map = {}   # scene-dict key -> {"shape"/"bsdf"/"mesh"/...: row}

    for key, value in d.items():
        if key == "type" or not isinstance(value, dict):
            continue
        t = value.get("type")
        if t in _INTEGRATORS:
            integrator = value
        elif t == "stokes":
            # `stokes.cpp` wraps a nested sampling integrator, whose depth
            # and roulette settings it takes
            nested = next((v for v in value.values()
                           if isinstance(v, dict) and "type" in v), {})
            integrator = dict(nested, type="stokes")
        elif t in _SENSORS:
            sensor_desc = value
        elif t in ("sunsky", "constant", "envmap"):
            env_desc = value
        elif t in ("linearcurve", "bsplinecurve"):
            # curves (`linearcurve.cpp`, `bsplinecurve.cpp`): a file in
            # Mitsuba's ASCII format, or inline points and radii
            mat = _build_bsdf(value.get("bsdf", {"type": "diffuse"}), mode,
                              textures, materials)
            if "filename" in value:
                from .curve import read_curve_file
                parsed = read_curve_file(value["filename"])
            else:
                pts = np.asarray(value["points"], np.float32)
                radii = value.get("radii")
                radii = (np.full((len(pts),), float(value.get("radius", 0.1)),
                                 np.float32) if radii is None
                         else np.asarray(radii, np.float32))
                parsed = [(pts, radii)]
            for pts_c, radii_c in parsed:
                curves.append(dict(
                    points=pts_c, radii=radii_c,
                    kind="linear" if t == "linearcurve" else "bspline",
                    to_world=_parse_to_world(value.get("to_world")),
                    bsdf_idx=len(materials)))
            materials.append(mat)
        elif t in ("obj", "ply", "serialized"):
            pos, nrm, idx, uvs, vcols = _read_mesh(t, value)
            mat = _build_bsdf(value.get("bsdf", {"type": "diffuse"}), mode,
                              textures, materials)
            param_map[key] = {"mesh": len(meshes), "bsdf": len(materials),
                              "mat": mat}
            meshes.append(dict(positions=pos, normals=nrm, indices=idx,
                               uvs=uvs, colors=vcols,
                               to_world=_parse_to_world(value.get("to_world")),
                               bsdf_idx=len(materials)))
            materials.append(mat)
        elif t == "point":
            point_lights.append(np.concatenate([
                np.asarray(value.get("position", [0, 0, 0]), np.float32),
                spectrum_to_channels(value.get("intensity", 1.0), "rgb")]))
            point_weights.append(float(value.get("sampling_weight", 1.0)))
        elif t == "directional":
            directional_lights.append(np.concatenate([
                np.asarray(value.get("direction", [0, 0, -1]), np.float32),
                spectrum_to_channels(value.get("irradiance", 1.0), "rgb")]))
            dir_weights.append(float(value.get("sampling_weight", 1.0)))
        elif t in ("spot", "projector"):
            spot_lights.append(_spot(t, value, device))
            spot_weights.append(float(value.get("sampling_weight", 1.0)))
        elif t == "sdfgrid":
            if sdf_grid is not None:
                raise ValueError("only one sdfgrid per scene is supported")
            sdf_grid = _sdf(value, mode, textures, materials, device)
        elif t in _SHAPE_KINDS:
            if "interior" in value:
                media_list.append(_interior_medium(t, value, mode, device))
                param_map[key] = {"medium": len(media_list) - 1}
                continue
            mat = _build_bsdf(value.get("bsdf", {"type": "diffuse"}), mode,
                              textures, materials)
            emitter = value.get("emitter")
            is_dir_area = (emitter or {}).get("type") == "directionalarea"
            radiance = (spectrum_to_channels(emitter["radiance"], "rgb")
                        if emitter else np.zeros(3))
            to_world = _parse_to_world(value.get("to_world"))
            if t == "cylinder":
                to_world = to_world @ _cylinder_frame(value)
            area_idx = len(areas) if emitter and not is_dir_area else None
            param_map[key] = {"shape": len(shapes), "bsdf": len(materials),
                              "mat": mat, "emitter": area_idx}
            shapes.append(dict(kind=_SHAPE_KINDS[t], to_world=to_world,
                               bsdf_idx=len(materials),
                               emitter_idx=-1 if area_idx is None
                               else area_idx))
            materials.append(mat)
            if is_dir_area:
                dir_areas[len(shapes) - 1] = radiance
            elif emitter:
                areas.append(radiance)
        elif t in _DECLARATIONS:
            # a standalone BSDF/rfilter declaration (XML `id=` + `<ref>`):
            # the shapes hold resolved copies
            continue
        elif t in _SAMPLERS or t == "orthogonal_array":
            # a top-level <sampler> outside the sensor
            top_level_sampler = value
        elif t == "blender":
            # `blender.cpp` builds a mesh from pointers into the Blender
            # process's memory; nothing here can read it
            raise NotImplementedError(
                "'blender' shapes reference in-process Blender memory; "
                "export the mesh to PLY/OBJ instead")
        else:
            custom = _PLUGIN_REGISTRY.get("any", {}).get(t)
            if custom is None:
                raise ValueError(f"unknown plugin type {t!r} (key {key!r})")
            custom(value)

    # ---- sensor + film + sampler ----
    sensor_desc = sensor_desc or {"type": "perspective"}
    film = _film(sensor_desc.get("film", {}))
    sampler_desc = sensor_desc.get("sampler", top_level_sampler or {})
    spp = int(sampler_desc.get("sample_count", 16))
    sampler_kind = _SAMPLERS.get(sampler_desc.get("type", "independent"),
                                 "independent")
    sensor = _build_sensor(sensor_desc, film.width, film.height, device)

    env_kind = env_params = env_rot = None
    if env_desc is not None:
        env_kind, env_params, env_rot = _environment(env_desc, mode, device)

    area_radiance = None
    if areas:
        area_radiance = np.zeros((max(len(shapes), 1), 3), np.float32)
        for i, s in enumerate(shapes):
            if s["emitter_idx"] >= 0:
                area_radiance[i] = areas[s["emitter_idx"]]
    if not materials:
        materials = [_build_bsdf({"type": "diffuse"}, mode)]
    measured, measured_pol = _measured_datasets(materials, device)
    dir_area_radiance = None
    if dir_areas:
        dir_area_radiance = np.zeros((max(len(shapes), 1), 3), np.float32)
        for si, rad in dir_areas.items():
            dir_area_radiance[si] = rad
    delta_weights = point_weights + dir_weights + spot_weights
    scene_static = make_scene(
        shapes=shapes,
        bsdf_albedos=[m["rgb"] for m in materials],
        bsdf_twosided=[m["twosided"] for m in materials],
        bsdf_spectral_albedos=[m["spec"] for m in materials],
        bsdf_kinds=[m["kind"] for m in materials],
        bsdf_alphas=[m["alpha"] for m in materials],
        bsdf_etas=[m["eta"] for m in materials],
        bsdf_ks=[m["k"] for m in materials],
        bsdf_iors=[m["ior"] for m in materials],
        bsdf_opacities=[m["opacity"] for m in materials],
        bsdf_tex_indices=[m["tex_idx"] for m in materials],
        bsdf_normal_tex_indices=[m["normal_tex_idx"] for m in materials],
        bsdf_extras=[m["extra"] for m in materials],
        bsdf_blend_children=[(m["blend_a"], m["blend_b"])
                             for m in materials],
        bsdf_blend_weights=[m["blend_w"] for m in materials],
        measured=measured, measured_pol=measured_pol,
        env_to_world=env_rot, textures=textures or None,
        spectral_textures=(mode == "spectral"),
        area_radiance=area_radiance,
        point_lights=point_lights or None,
        directional_lights=directional_lights or None,
        spot_lights=tuple(spot_lights),
        delta_light_weights=delta_weights or None,
        dir_area_radiance=dir_area_radiance, meshes=meshes or None,
        medium=(None if not media_list else media_list[0]
                if len(media_list) == 1 else tuple(media_list)),
        sdf=sdf_grid, curves=curves or None, env=None, device=device)

    itype = integrator.get("type", "path")
    forced_depth = None
    if itype in AD_INTEGRATOR_ALIASES:
        itype, forced_depth = AD_INTEGRATOR_ALIASES[itype]
    max_depth = int(integrator.get("max_depth", 2 if itype == "direct" else 6))
    if itype == "direct":
        max_depth = 2
    if forced_depth is not None:
        max_depth = forced_depth
    if variant.polarized and itype in ("path", "direct"):
        itype = "stokes"
    return SceneBundle(sensor=sensor, film=film, integrator=itype,
                       max_depth=max_depth,
                       rr_depth=int(integrator.get("rr_depth", 5)), spp=spp,
                       mode=mode, sampler_kind=sampler_kind,
                       env_kind=env_kind, env_params=env_params,
                       scene_desc=d, _scene_static=scene_static,
                       param_map=param_map, variant=variant, device=device)


def _spot(t, value, device):
    """A spot or projector light (`spot.cpp`, `projector.cpp`), placed by
    its to_world or its position and direction."""
    from .emitters import make_spot
    tex = value.get("texture")
    if isinstance(tex, dict):   # inline bitmap only
        tex = np.asarray(tex.get("bitmap"), np.float32)
    to_world = value.get("to_world")
    if to_world is not None:
        m = _parse_to_world(to_world)
        position, direction = m[:3, 3], m[:3, 2]
    else:
        position = value.get("position", [0, 0, 0])
        direction = value.get("direction", [0, 0, -1])
    if t == "projector":
        half = float(value.get("fov", 45.0)) / 2.0
        return make_spot(position, direction, spectrum_to_channels(
            value.get("irradiance", 1.0), "rgb"), cutoff_angle_deg=half,
            beam_width_deg=half, texture=tex, device=device)
    cutoff = float(value.get("cutoff_angle", 20.0))
    return make_spot(position, direction, spectrum_to_channels(
        value.get("intensity", 1.0), "rgb"), cutoff_angle_deg=cutoff,
        beam_width_deg=float(value.get("beam_width", cutoff * 0.75)),
        texture=tex, device=device)


def _sdf(value, mode, textures, materials, device):
    """An SDF grid shape (`sdfgrid.cpp`): values from an inline array, a
    .npy file or a Mitsuba .vol file; its material appended."""
    from .sdf import make_sdf_grid
    if "interior" in value:
        raise ValueError("sdfgrid does not support interior media")
    if "grid" in value:
        vals = np.asarray(value["grid"], np.float32)
    elif "filename" in value:
        fn = value["filename"]
        if fn.endswith(".vol"):
            from ..utils.io import read_vol
            vals = read_vol(fn)[0][..., 0]
        else:
            vals = np.load(fn).astype(np.float32)
    else:
        raise ValueError("sdfgrid needs 'grid' or 'filename'")
    mat = _build_bsdf(value.get("bsdf", {"type": "diffuse"}), mode,
                      textures, materials)
    grid = make_sdf_grid(vals, to_world=_parse_to_world(value.get("to_world")),
                         bsdf_idx=len(materials), device=device)
    materials.append(mat)
    return grid


def _sunsky_params_from_props(props: dict, mode: str, device="cuda"):
    """Sunsky properties as Mitsuba parses them (`sunsky.cpp:889-948`),
    with their range checks; the sun from the date, time and place
    through the port's float64 astronomy (R7)."""
    turbidity = float(props.get("turbidity", 3.0))
    if not 1.0 <= turbidity <= 10.0:
        raise ValueError(f"turbidity {turbidity} out of range [1, 10]")
    albedo = spectrum_to_channels(props.get("albedo", 0.3), mode)
    if np.any(albedo < 0) or np.any(albedo > 1):
        raise ValueError(f"albedo must be in [0, 1], got {albedo}")
    time_keys = ("latitude", "longitude", "timezone", "year", "month", "day",
                 "hour", "minute", "second")
    if "sun_direction" in props:
        if any(k in props for k in time_keys):
            raise ValueError("give either sun_direction or time/location, "
                             "not both")
        sd = np.asarray(props["sun_direction"], np.float64)
        sd = sd / np.linalg.norm(sd)
    else:
        dt = DateTimeRecord(year=int(props.get("year", 2010)),
                            month=int(props.get("month", 7)),
                            day=int(props.get("day", 10)),
                            hour=float(props.get("hour", 15.0)),
                            minute=float(props.get("minute", 0.0)),
                            second=float(props.get("second", 0.0)))
        loc = LocationRecord(latitude=float(props.get("latitude", 35.6894)),
                             longitude=float(props.get("longitude",
                                                       139.6917)),
                             timezone=float(props.get("timezone", 9.0)))
        sd = astro_sun_direction(dt, loc).numpy()
    return sunsky_model.make_params(
        turbidity=turbidity, albedo=albedo, sun_direction=sd,
        sky_scale=float(props.get("sky_scale", 1.0)),
        sun_scale=float(props.get("sun_scale", 1.0)),
        sun_aperture_deg=float(props.get("sun_aperture",
                                         skyC.SUN_APERTURE_DEG)),
        mode=mode, device=device)
