"""Mitsuba-XML scene writer (scene dict -> .xml), the reference
package's `tpusky/render/xml_writer.py`: the same text for the same
dictionary.

Reference parity for ``src/python/python/xml.py`` (``mi.xml.dict_to_xml``,
the save-back path behind ``mitsuba -u``): serializes the plain scene
dictionary used by :func:`tpusky_torch.render.loader.load_dict` into the XML
grammar that :mod:`tpusky_torch.render.xml_loader` (and Mitsuba itself) parses —
so `load_file(write_xml(d)) == load_dict(d)`.

Emitted property forms match `xml.cpp`'s parser: ``float``/``integer``/
``boolean``/``string`` scalars, ``rgb`` triples for radiance-like keys,
``vector`` otherwise, and 4x4 ``to_world`` matrices as
``<transform><matrix value="..."/></transform>``.
"""

from __future__ import annotations

import numbers
from xml.sax.saxutils import quoteattr

import numpy as np

from .xml_loader import _TYPE_TO_CATEGORY

__all__ = ["dict_to_xml", "write_xml"]

_SHAPE_TYPES = {"sphere", "rectangle", "disk", "cube", "cylinder", "obj",
                "ply", "serialized", "shapegroup", "instance"}
_SENSOR_TYPES = {"perspective", "orthographic", "spherical", "thinlens",
                 "distant", "radiancemeter", "irradiancemeter", "batch"}
_INTEGRATOR_TYPES = {"path", "direct", "depth", "aov", "moment", "ptracer",
                     "prb", "prb_basic", "prbvolpath", "volpath",
                     "volpathmis", "direct_projective", "prb_projective"}
_TEXTURE_TYPES = {"checkerboard", "bitmap"}
_MEDIUM_KEYS = {"interior", "exterior"}
_RGB_KEYS = {"radiance", "intensity", "irradiance", "reflectance",
             "albedo", "sigma_t", "eta", "k", "specular_reflectance",
             "specular_transmittance", "diffuse_reflectance",
             "base_color", "color0", "color1"}
_INT_KEYS = {"width", "height", "sample_count", "max_depth", "rr_depth",
             "seed"}


def _tag_for(key: str, value: dict) -> str:
    t = value.get("type", "")
    if t in _SHAPE_TYPES:
        return "shape"
    if t in _SENSOR_TYPES:
        return "sensor"
    if t in _INTEGRATOR_TYPES:
        return "integrator"
    if t in _TEXTURE_TYPES:
        return "texture"
    if key in _MEDIUM_KEYS or t == "homogeneous":
        return "medium"
    if key in ("film", "sampler", "rfilter", "phase"):
        return key
    return _TYPE_TO_CATEGORY.get(t, "bsdf" if key == "bsdf" else key)


def _fmt_num(x) -> str:
    x = float(x)
    return repr(int(x)) if x == int(x) and abs(x) < 1e15 else repr(x)


def _emit_prop(lines, indent, name, v):
    pad = "    " * indent
    nm = quoteattr(name)
    if isinstance(v, bool):
        lines.append(f'{pad}<boolean name={nm} value="{str(v).lower()}"/>')
    elif isinstance(v, numbers.Integral) or name in _INT_KEYS:
        lines.append(f'{pad}<integer name={nm} value="{int(v)}"/>')
    elif isinstance(v, numbers.Real):
        lines.append(f'{pad}<float name={nm} value="{_fmt_num(v)}"/>')
    elif isinstance(v, str):
        lines.append(f'{pad}<string name={nm} value={quoteattr(v)}/>')
    else:
        arr = np.asarray(v, np.float64)
        if arr.shape == (4, 4):
            flat = " ".join(_fmt_num(x) for x in arr.ravel())
            lines.append(f'{pad}<transform name={nm}>')
            lines.append(f'{pad}    <matrix value="{flat}"/>')
            lines.append(f'{pad}</transform>')
        elif arr.shape == (3,):
            val = " ".join(_fmt_num(x) for x in arr)
            tag = "rgb" if name in _RGB_KEYS else "vector"
            lines.append(f'{pad}<{tag} name={nm} value="{val}"/>')
        elif arr.ndim == 1:
            # wavelength/value pair lists etc -> spectrum string form
            val = ", ".join(_fmt_num(x) for x in arr)
            lines.append(f'{pad}<spectrum name={nm} value="{val}"/>')
        else:
            raise ValueError(f"cannot serialize property {name!r} of "
                             f"shape {arr.shape}")


def _emit_object(lines, indent, key, value, nested=False):
    """One object: a top-level one keeps its key as `id=`, one nested in a
    property slot (a texture as `reflectance`) names the slot with `name=`,
    as Mitsuba writes it and `xml_loader` keys it."""
    tag = _tag_for(key, value)
    t = value.get("type", "")
    pad = "    " * indent
    head = f'{pad}<{tag} type={quoteattr(t)}'
    if tag in ("shape", "sensor", "bsdf", "emitter", "texture") \
            and key not in (tag, "bsdf", "emitter"):
        head += f' {"name" if nested else "id"}={quoteattr(str(key))}'
    body_start = len(lines)
    lines.append(head + ">")
    for k, v in value.items():
        if k == "type":
            continue
        if isinstance(v, dict):
            name_attr = k if k in _MEDIUM_KEYS else None
            sub = len(lines)
            _emit_object(lines, indent + 1, k, v, nested=True)
            if name_attr:  # media need their role attached (interior=...)
                lines[sub] = lines[sub].replace(
                    ">", f' name={quoteattr(name_attr)}>', 1)
        else:
            _emit_prop(lines, indent + 1, k, v)
    if len(lines) == body_start + 1:   # empty body -> self-closing
        lines[body_start] = head + "/>"
    else:
        lines.append(f"{pad}</{tag}>")


def dict_to_xml(d: dict) -> str:
    """Serialize a `load_dict`-style scene dictionary to Mitsuba XML."""
    lines = ['<?xml version="1.0" encoding="utf-8"?>',
             '<scene version="3.6.0">']
    for key, value in d.items():
        if key == "type":
            continue
        if isinstance(value, dict):
            _emit_object(lines, 1, key, value)
        else:
            _emit_prop(lines, 1, key, value)
    lines.append("</scene>")
    return "\n".join(lines) + "\n"


def write_xml(path: str, d: dict) -> None:
    with open(path, "w") as f:
        f.write(dict_to_xml(d))
