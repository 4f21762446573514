"""Shared by the port's loader tests: scene dictionaries, one a group of
plugin types the port renders, over small asset files written from numpy
seeds (an OBJ with texcoords, a .serialized mesh, a PLY with vertex
colours, an EXR envmap, a PNG height map, .vol grids and measured BRDF
tensor files), and the field-by-field comparison of a port bundle with
the JAX package's, carried over by `tpusky_torch.convert`."""

import os

import jax
import numpy as np
import torch

from tpusky.render import loader as JL
from tpusky_torch import convert
from tpusky_torch.ops.tensorfile import write_tensor_file
from tpusky_torch.render import loader as TL
from tpusky_torch.utils import io as TIO
from tpusky_torch.utils.meshio import icosphere, write_serialized
from tpusky_torch.utils.transform import look_at, rotate, scale, translate

from test_measured import _synthetic_fields, _synthetic_pbsdf

SUN = [0.3, 0.2, 0.93]
H = W = 16
SPP = 2


def write_obj(path, pos, idx, uvs=None):
    """An OBJ of float32 positions (shortest round-trip decimals), optional
    texcoords (`f v/vt`), no normals."""
    with open(path, "w") as f:
        for p in pos:
            f.write("v " + " ".join(repr(float(x)) for x in p) + "\n")
        if uvs is not None:
            for t in uvs:
                f.write("vt " + " ".join(repr(float(x)) for x in t) + "\n")
        for tri in idx + 1:
            f.write("f " + " ".join(f"{i}/{i}" if uvs is not None else str(i)
                                    for i in tri) + "\n")


def _write_ply(path, pos, idx, cols):
    """An ASCII PLY with per-vertex uchar colours."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pos)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        f.write(f"element face {len(idx)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for p, c in zip(pos, cols):
            f.write(" ".join(repr(float(x)) for x in p) + " "
                    + " ".join(str(int(x)) for x in c) + "\n")
        for tri in idx:
            f.write("3 " + " ".join(str(int(i)) for i in tri) + "\n")


def assets(tmp):
    """Write the asset files under `tmp` -> {name: path}."""
    rng = np.random.default_rng(20)
    tmp = str(tmp)
    p = {k: os.path.join(tmp, v) for k, v in (
        ("obj", "ico.obj"), ("serialized", "ico.serialized"),
        ("ply", "ico.ply"), ("exr", "sky.exr"), ("png", "height.png"),
        ("vol", "grid.vol"), ("sdf", "sdf.vol"), ("measured", "rgl.bsdf"),
        ("pbsdf", "pol.pbsdf"))}
    pos, idx = icosphere(1)
    uv = np.stack([np.arctan2(pos[:, 1], pos[:, 0]) / (2 * np.pi) + 0.5,
                   0.5 + 0.5 * pos[:, 2]], -1).astype(np.float32)
    write_obj(p["obj"], pos, idx, uv)
    write_serialized(p["serialized"], pos, idx, normals=pos, uvs=uv)
    _write_ply(p["ply"], pos, idx, rng.integers(0, 256, (len(pos), 3)))
    TIO.write_exr(p["exr"], (0.2 + rng.random((8, 16, 3))).astype(
        np.float32), ["R", "G", "B"])
    yy, xx = np.mgrid[0:8, 0:8]
    TIO.write_png(p["png"], (0.5 + 0.4 * np.sin(xx * 0.9) * np.cos(yy * 0.7)
                             )[..., None].repeat(3, -1))
    TIO.write_vol(p["vol"], rng.random((4, 4, 4, 3)).astype(np.float32),
                  (-1, -1, -1), (1, 1, 1))
    g = np.linspace(-1.0, 1.0, 8)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    TIO.write_vol(p["sdf"], (np.sqrt(x * x + y * y + z * z) - 0.6)
                  .astype(np.float32))
    write_tensor_file(p["measured"], _synthetic_fields())
    write_tensor_file(p["pbsdf"], _synthetic_pbsdf())
    return p


def _sensor(**over):
    s = {"type": "perspective", "fov": 45,
         "to_world": look_at([4, -4, 2], [0, 0, 1]),
         "film": {"type": "hdrfilm", "width": W, "height": H},
         "sampler": {"type": "independent", "sample_count": SPP}}
    s.update(over)
    return s


def _sky(**over):
    e = {"type": "sunsky", "turbidity": 3.0, "albedo": 0.3,
         "sun_direction": SUN}
    e.update(over)
    return e


def _ground(bsdf=None):
    return {"type": "rectangle", "to_world": scale([10, 10, 1]),
            "bsdf": bsdf or {"type": "diffuse",
                             "reflectance": [0.4, 0.4, 0.4]}}


def headline():
    """bench.py's headline scene as a dict: a diffuse sphere on a diffuse
    ground under the sunsky."""
    return {"type": "scene",
            "integrator": {"type": "path", "max_depth": 3},
            "sensor": _sensor(), "emitter": _sky(), "ground": _ground(),
            "sphere": {"type": "sphere", "to_world": translate([0, 0, 1]),
                       "bsdf": {"type": "diffuse",
                                "reflectance": [0.6, 0.2, 0.2]}}}


def render_scene(p):
    """The render tests' scene: a bump-mapped ground, a rough gold sphere,
    a checkered plastic cube, an OBJ icosphere of rough plastic, a point
    light, the sunsky; 16x16x2, depth 3."""
    return {"type": "scene",
            "integrator": {"type": "path", "max_depth": 3},
            "sensor": _sensor(),
            "emitter": _sky(),
            "ground": _ground({"type": "bumpmap", "scale": 0.02,
                               "texture": {"type": "bitmap",
                                           "filename": p["png"]},
                               "bsdf": {"type": "diffuse",
                                        "reflectance": [0.5, 0.45, 0.4]}}),
            "gold": {"type": "sphere",
                     "to_world": translate([0, 0, 1]) @ scale(0.8),
                     "bsdf": {"type": "roughconductor", "material": "Au",
                              "alpha": 0.2}},
            "box": {"type": "cube",
                    "to_world": translate([1.6, 1.0, 0.5]) @ scale(0.5),
                    "bsdf": {"type": "plastic", "diffuse_reflectance": {
                        "type": "checkerboard", "color0": [0.8, 0.2, 0.1],
                        "color1": [0.1, 0.3, 0.7]}}},
            "ico": {"type": "obj", "filename": p["obj"],
                    "to_world": translate([-1.4, 0.8, 0.6]) @ scale(0.6),
                    "bsdf": {"type": "roughplastic", "alpha": 0.3,
                             "diffuse_reflectance": [0.2, 0.6, 0.3]}},
            "lamp": {"type": "point", "position": [1.0, -2.0, 3.0],
                     "intensity": [8.0, 7.0, 6.0]}}


def table_scenes(p):
    """{name: scene dict}, one a group of plugin types the port renders."""
    base = {"type": "scene", "sensor": _sensor(), "emitter": _sky()}

    def scene(**kw):
        return dict(base, **kw)
    hair_curve = {"points": [[0.0, 0.0, 0.0], [0.1, 0.0, 0.4],
                             [0.0, 0.1, 0.8], [0.1, 0.1, 1.2]],
                  "radius": 0.05}
    return {
        "hour": scene(emitter={"type": "sunsky", "turbidity": 4.0,
                               "albedo": 0.3, "hour": 10.5},
                      integrator={"type": "direct"}, ground=_ground(),
                      ball={"type": "sphere", "to_world": translate([0, 0, 1]),
                            "bsdf": {"type": "twosided", "nested": {
                                "type": "diffuse",
                                "reflectance": [0.6, 0.2, 0.2]}}}),
        "materials": scene(
            integrator={"type": "path", "max_depth": 4, "rr_depth": 3},
            a={"type": "sphere", "bsdf": {"type": "conductor"}},
            b={"type": "sphere", "bsdf": {
                "type": "roughconductor", "material": "Cu", "alpha": 0.3,
                "specular_reflectance": {"type": "rgb",
                                         "value": [0.9, 0.8, 0.7]}}},
            c={"type": "sphere", "bsdf": {"type": "dielectric",
                                          "int_ior": 1.33}},
            d={"type": "sphere", "bsdf": {"type": "roughdielectric",
                                          "alpha": 0.25}},
            e={"type": "disk", "bsdf": {"type": "thindielectric"}},
            f={"type": "sphere", "bsdf": {"type": "plastic",
                                          "diffuse_reflectance": 0.3}},
            g={"type": "sphere", "bsdf": {"type": "roughplastic",
                                          "alpha": 0.2}},
            h={"type": "sphere", "bsdf": {"type": "principled", "eta": 1.4,
                                          "metallic": 0.3, "sheen": 0.2,
                                          "base_color": [0.7, 0.5, 0.2]}},
            i={"type": "sphere", "bsdf": {"type": "principledthin",
                                          "diff_trans": 0.8,
                                          "spec_trans": 0.3}},
            j={"type": "rectangle", "bsdf": {"type": "pplastic",
                                             "alpha": 0.15}},
            k={"type": "rectangle", "bsdf": {"type": "polarizer",
                                             "theta": 30.0}},
            l={"type": "rectangle", "bsdf": {"type": "retarder",
                                             "delta": 90.0}},
            m={"type": "rectangle", "bsdf": {"type": "circular",
                                             "left_handed": True}},
            n={"type": "sphere", "bsdf": {"type": "null"}},
            o={"type": "sphere", "bsdf": {"type": "mask", "opacity": 0.4,
                                          "bsdf": {"type": "plastic"}}},
            q={"type": "sphere", "bsdf": {
                "type": "twosided", "bsdf": {
                    "type": "blendbsdf", "weight": 0.3,
                    "a": {"type": "diffuse", "reflectance": [0.2, 0.3, 0.4]},
                    "b": {"type": "roughconductor", "alpha": 0.3}}}},
            r={"type": "sphere", "bsdf": {"type": "hair",
                                          "sigma_a": [0.2, 0.4, 0.8],
                                          "scale_tilt": 3.0}},
            s={"type": "sphere", "bsdf": {"type": "hair", "eumelanin": 0.8,
                                          "pheomelanin": 0.5,
                                          "azimuthal_roughness": 0.4}},
            t={"type": "sphere", "bsdf": {"type": "diffuse", "reflectance": {
                "type": "irregular", "wavelengths": "400, 550, 700",
                "values": "0.2, 0.6, 0.4"}}},
            u={"type": "sphere", "bsdf": {"type": "diffuse", "reflectance": {
                "type": "regular", "lambda_min": 360, "lambda_max": 830,
                "values": [0.3, 0.5, 0.7]}}}),
        "textures": scene(
            ground=_ground({"type": "bumpmap", "scale": 0.5, "texture": {
                "type": "bitmap", "filename": p["png"],
                "to_uv": {"scale": [2, 3]}}, "bsdf": {
                "type": "diffuse", "reflectance": {
                    "type": "checkerboard", "to_uv": {"transforms": [
                        {"scale": 4}, {"rotate": 30.0}]}}}}),
            a={"type": "sphere", "bsdf": {"type": "normalmap", "normalmap": {
                "type": "bitmap", "data": np.full((4, 4, 3), 0.5, np.float32)
                + np.linspace(0, 0.3, 4)[:, None, None]},
                "bsdf": {"type": "roughplastic", "diffuse_reflectance": {
                    "type": "bitmap", "filename": p["png"],
                    "wrap_mode": "mirror"}}}},
            b={"type": "sphere", "bsdf": {"type": "principled", "base_color": {
                "type": "volume", "volume": {"type": "gridvolume",
                                             "filename": p["vol"]}}}},
            c={"type": "ply", "filename": p["ply"], "bsdf": {
                "type": "diffuse", "reflectance": {
                    "type": "mesh_attribute", "name": "vertex_color",
                    "scale": 0.9}}}),
        "emitters": scene(
            emitter={"type": "constant",
                     "radiance": {"type": "rgb", "value": [0.3, 0.4, 0.5]}},
            panel={"type": "rectangle", "to_world": translate([0, 0, 3]),
                   "emitter": {"type": "area", "radiance": {
                       "type": "rgb", "value": [4, 3, 2]}}},
            bulb={"type": "sphere", "to_world": translate([1, 1, 2]),
                  "emitter": {"type": "area", "radiance": 2.0}},
            sun={"type": "disk", "to_world": translate([0, 2, 4]),
                 "emitter": {"type": "directionalarea", "radiance": 1.5}},
            p1={"type": "point", "position": [1, 2, 3], "intensity": 5.0,
                "sampling_weight": 2.0},
            d1={"type": "directional", "direction": [0, 1, -1],
                "irradiance": {"type": "rgb", "value": [1, 2, 3]}},
            s1={"type": "spot",
                "to_world": look_at([0, 0, 4], [0, 0, 0], [0, 1, 0]),
                "intensity": 3.0, "cutoff_angle": 30.0},
            s2={"type": "projector", "position": [1, 0, 4],
                "direction": [0, 0, -1], "fov": 40.0,
                "texture": {"type": "bitmap",
                            "bitmap": np.eye(3, dtype=np.float32)[:, :, None]
                            .repeat(3, -1)}},
            ground=_ground()),
        "envmap": scene(emitter={"type": "envmap", "filename": p["exr"],
                                 "scale": 1.5,
                                 "to_world": rotate([1, 0, 0], -90)},
                        ground=_ground()),
        "uniform": scene(emitter={"type": "constant", "radiance": 0.7},
                         ground=_ground()),
        "media": scene(
            integrator={"type": "volpath", "max_depth": 6},
            fog={"type": "sphere", "to_world": scale(1.5), "interior": {
                "type": "homogeneous", "sigma_t": 0.5,
                "albedo": {"type": "rgb", "value": [0.8, 0.7, 0.6]},
                "phase": {"type": "tabphase",
                          "values": "0.5, 1.0, 2.0, 1.0"}}},
            box={"type": "cube", "to_world": translate([2, 0, 1]),
                 "interior": {"type": "heterogeneous", "scale": 2.0,
                              "n_steps": 16, "channel_mis": True,
                              "sigma_t": {"type": "gridvolume",
                                          "filename": p["vol"]},
                              "phase": {"type": "blendphase", "weight": 0.3,
                                        "a": {"type": "hg", "g": 0.4},
                                        "b": {"type": "rayleigh"}}}},
            cloud={"type": "sphere", "to_world": translate([-2, 0, 1]),
                   "interior": {"type": "homogeneous", "sigma_t": 0.2,
                                "phase": {"type": "sggx", "S": {
                                    "type": "constvolume",
                                    "value": [1, 1, 0.5, 0.1, 0, 0]}}}},
            ground=_ground()),
        "geometry": scene(
            sdf={"type": "sdfgrid", "filename": p["sdf"],
                 "to_world": translate([0, 0, 1]),
                 "bsdf": {"type": "roughconductor"}},
            strand={"type": "bsplinecurve", **hair_curve,
                    "bsdf": {"type": "hair", "eumelanin": 1.1}},
            wire={"type": "linearcurve", **hair_curve,
                  "radii": [0.02, 0.03, 0.04, 0.05],
                  "to_world": translate([1, 0, 0])},
            tube={"type": "cylinder", "p0": [0, 0, 0], "p1": [1, 1, 2],
                  "radius": 0.3},
            lid={"type": "disk", "to_world": translate([0, 0, 2])},
            block={"type": "cube", "to_world": scale([0.5, 1.0, 0.25])},
            ground=_ground()),
        "meshes": scene(
            o={"type": "obj", "filename": p["obj"],
               "to_world": translate([0, 0, 1])},
            s={"type": "serialized", "filename": p["serialized"],
               "bsdf": {"type": "plastic"}},
            f={"type": "serialized", "filename": p["serialized"],
               "face_normals": True, "to_world": translate([2, 0, 1])},
            y={"type": "ply", "filename": p["ply"],
               "to_world": translate([-2, 0, 1])},
            ground=_ground()),
        "instances": scene(
            pair={"type": "shapegroup",
                  "a": {"type": "sphere",
                        "bsdf": {"type": "diffuse", "reflectance": 0.5}},
                  "b": {"type": "cube",
                        "to_world": {"transforms": [{"scale": 0.5},
                                                    {"translate": [2, 0, 0]}]},
                        "bsdf": {"type": "diffuse", "reflectance": 0.3}}},
            i1={"type": "instance", "group": "pair"},
            i2={"type": "instance", "group": "pair",
                "to_world": {"transforms": [{"translate": [-4, 0, 0]}]}},
            m={"type": "merge", "to_world": translate([0, 3, 0]),
               "x": {"type": "disk"}, "z": {"type": "rectangle",
                                            "to_world": scale(0.5)}}),
        "measured": scene(
            a={"type": "sphere", "bsdf": {"type": "measured",
                                          "filename": p["measured"]}},
            b={"type": "sphere", "bsdf": {"type": "measured_polarized",
                                          "filename": p["pbsdf"],
                                          "alpha_sample": 0.2}},
            ground=_ground()),
        "specfilm": scene(
            sensor=_sensor(type="thinlens", aperture_radius=0.05,
                           focus_distance=4.0,
                           film={"type": "specfilm", "width": 12,
                                 "height": 8, "rfilter": {"type": "mitchell"},
                                 "band_a": {"type": "regular",
                                            "lambda_min": 400,
                                            "lambda_max": 500,
                                            "values": [0.5, 1.0, 0.5]},
                                 "band_b": {"type": "irregular",
                                            "wavelengths": "500, 600, 700",
                                            "values": "0.2, 1.0, 0.2"}},
                           sampler={"type": "multijitter",
                                    "sample_count": 4}),
            ground=_ground()),
        "bands": scene(
            sensor=_sensor(type="orthographic",
                           film={"type": "specfilm", "width": 8,
                                 "height": 8, "n_bands": 3,
                                 "lambda_min": 400, "lambda_max": 700,
                                 "crop_offset_x": 2, "crop_offset_y": 1,
                                 "crop_width": 4, "crop_height": 5,
                                 "rfilter": {"type": "gaussian"}},
                           sampler={"type": "orthogonal",
                                    "sample_count": 4}),
            ground=_ground()),
        "batch": scene(
            sensor={"type": "batch", "film": {"width": 16, "height": 8},
                    "a": {"type": "perspective", "fov": 30},
                    "b": {"type": "spherical"},
                    "sampler": {"type": "stratified", "sample_count": 4}},
            ground=_ground()),
        "meters": scene(
            sensor={"type": "radiancemeter", "origin": [0, 0, 1],
                    "direction": [0, 1, 1]},
            ground=_ground()),
        "irradiance": scene(
            sensor={"type": "irradiancemeter", "origin": [0, 0, 0.01],
                    "normal": [0, 0, 1], "half_extent": 0.5},
            ldsampler={"type": "ldsampler", "sample_count": 8},
            ground=_ground()),
        "distant": scene(
            sensor={"type": "distant", "direction": [0, 0, -1],
                    "radius": 3.0},
            integrator={"type": "aov", "aovs": "dd:depth,nn:sh_normal",
                        "child": {"type": "path", "max_depth": 3}},
            ground=_ground()),
        "stokes": scene(integrator={"type": "stokes", "inner": {
            "type": "path", "max_depth": 5, "rr_depth": 2}},
            ground=_ground({"type": "pplastic"})),
        "ptracer": scene(integrator={"type": "ptracer", "max_depth": 3},
                         ground=_ground()),
        "moment": scene(integrator={"type": "moment", "max_depth": 4},
                        ground=_ground()),
        "prb_basic": scene(integrator={"type": "prb_basic", "max_depth": 7},
                           ground=_ground()),
    }


BAD_SCENES = {
    "unknown plugin": {"type": "scene", "x": {"type": "unobtanium"}},
    "turbidity": {"type": "scene",
                  "emitter": {"type": "sunsky", "turbidity": 12}},
    "albedo": {"type": "scene",
               "emitter": {"type": "sunsky", "albedo": 1.5}},
    "sun twice": {"type": "scene",
                  "emitter": {"type": "sunsky", "hour": 10,
                              "sun_direction": [0, 0, 1]}},
    "blender": {"type": "scene", "b": {"type": "blender"}},
    "conductor": {"type": "scene",
                  "s": {"type": "sphere",
                        "bsdf": {"type": "conductor", "material": "Zz"}}},
    "hair twice": {"type": "scene",
                   "s": {"type": "sphere",
                         "bsdf": {"type": "hair", "sigma_a": 0.5,
                                  "eumelanin": 1.0}}},
    "crop": {"type": "scene",
             "sensor": {"type": "perspective",
                        "film": {"width": 8, "height": 8,
                                 "crop_width": 9}}},
}


def jax_bundle(d, mode="rgb"):
    return JL.load_dict(d, mode=mode)


def port_bundle(d, mode="rgb"):
    return TL.load_dict(d, mode=mode, device="cpu")


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


def compare(a, b, path, out, rtol=1e-6, atol=1e-7):
    """Walk the port's object `a` and the converted reference `b` field by
    field; append (path, max abs error, bitwise) of every tensor to
    `out`; raise on a structural difference or an error beyond
    rtol * |b| + atol."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        x, y = _np(a), _np(b)
        assert x.shape == y.shape, (path, x.shape, y.shape)
        if x.dtype == bool or np.issubdtype(x.dtype, np.integer):
            assert np.array_equal(x, y), path
            out.append((path, 0.0, True))
            return
        err = np.abs(x.astype(np.float64) - y.astype(np.float64))
        worst = float(err.max(initial=0.0))
        assert np.all(err <= rtol * np.abs(y) + atol), (path, worst)
        out.append((path, worst, bool(np.array_equal(x, y))))
        return
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        assert type(a).__name__ == type(b).__name__, (path, type(b))
        for f in a._fields:
            compare(getattr(a, f), getattr(b, f), f"{path}.{f}", out, rtol,
                    atol)
        return
    if isinstance(a, tuple) and isinstance(b, tuple):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            compare(x, y, f"{path}[{i}]", out, rtol, atol)
        return
    assert a == b, (path, a, b)


def compare_bundles(tb, jb, rtol=1e-6, atol=1e-7, params_tol=None):
    """Hold a port bundle against the reference's, field by field: the
    scene tables (`convert.scene` of the reference's), the sensor, the
    film, the environment's parameters and the bundle's configuration.
    -> [(path, max abs error, bitwise)]."""
    out = []
    ref = jax.tree.map(np.asarray, jb._scene_static)
    compare(tb._scene_static, convert.scene(ref, device="cpu"), "scene",
            out, rtol, atol)
    compare(tb.sensor, convert.sensor(jax.tree.map(np.asarray, jb.sensor),
                                      device="cpu"), "sensor", out, rtol,
            atol)
    assert tuple(tb.film) == tuple(getattr(jb.film, f)
                                   for f in tb.film._fields), "film"
    for f in ("integrator", "max_depth", "rr_depth", "spp", "mode",
              "sampler_kind", "env_kind"):
        assert getattr(tb, f) == getattr(jb, f), f
    assert list(tb.param_map) == list(jb.param_map)
    for k, v in tb.param_map.items():
        assert {x: y for x, y in v.items() if x != "mat"} == \
            {x: y for x, y in jb.param_map[k].items() if x != "mat"}, k
    if tb.env_kind == "sunsky":
        ref_p = convert.sunsky_params(jax.tree.map(np.asarray,
                                                   jb.env_params), "cpu")
        rt, at = params_tol or (rtol, atol)
        compare(tb.env_params, ref_p, "emitter", out, rt, at)
    elif tb.env_kind is not None:
        compare(tb.env_params, convert.environment(
            jax.tree.map(np.asarray, jb.env_params), "cpu"), "emitter", out,
            rtol, atol)
    return out
