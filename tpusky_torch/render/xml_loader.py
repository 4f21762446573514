"""Mitsuba-XML scene file loader (`tpusky/render/xml_loader.py`; pure
Python, the same dictionaries as the reference's for the same text).

Parses the reference's XML scene format (reference: ``src/core/xml.cpp``,
1,407 LoC; grammar documented in the Mitsuba 3 docs) into the plain scene
dictionary consumed by :func:`tpusky_torch.render.loader.load_dict`.  Supported:

- property tags: ``float integer boolean string vector point rgb spectrum``
- ``<transform name="to_world">`` chains: translate/rotate/scale/lookat/
  matrix (composed first-to-last like the reference)
- nested objects: bsdf/emitter/shape/sensor/film/sampler/integrator/texture
- ``<default name value>`` declarations and ``$var`` substitution
  (``xml.cpp`` parameter mechanism; CLI ``-D key=value`` overrides win)
- ``<ref id>`` to objects declared with ``id=`` (resolved by copying — the
  scene is a tree of values, not a shared-pointer graph)
- ``<include filename>`` (relative to the including file)
- ``<alias id as>``

Shape-bound ``<medium name="interior">`` declarations map to the
homogeneous-medium path (render/medium.py). Out of scope: polarized
plugins. The inverse direction (dict -> XML save-back, `mitsuba -u`)
lives in :mod:`tpusky_torch.render.xml_writer`.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET

import numpy as np

_OBJECT_TAGS = {"bsdf", "emitter", "shape", "sensor", "film", "sampler",
                "integrator", "texture", "rfilter", "phase", "medium",
                "spectrum"}

_NUM_SPLIT = re.compile(r"[,\s]+")

_CATEGORY = {
    "bsdf": ("diffuse", "conductor", "roughconductor", "dielectric",
             "roughdielectric", "plastic", "roughplastic", "null", "mask",
             "twosided", "principled", "blendbsdf"),
    "emitter": ("area", "sunsky", "constant", "envmap", "point",
                "directional", "directionalarea", "spot", "projector"),
    "film": ("hdrfilm", "specfilm"),
    "sampler": ("independent", "stratified", "multijitter", "orthogonal",
                "ldsampler", "sobol"),
    "rfilter": ("box", "gaussian", "tent", "lanczos", "mitchell",
                "catmullrom"),
}
_TYPE_TO_CATEGORY = {t: c for c, ts in _CATEGORY.items() for t in ts}


def _category_of(plugin_type: str) -> str:
    """Canonical child key for an unnamed <ref>: 'bsdf' for BSDF types,
    'emitter' for emitters, ... — matches the keys `load_dict` reads."""
    return _TYPE_TO_CATEGORY.get(plugin_type, "bsdf")


def _subst(s: str, params: dict) -> str:
    """``$name`` substitution (longest names first to avoid prefix bites)."""
    if "$" not in s:
        return s
    for k in sorted(params, key=len, reverse=True):
        s = s.replace("$" + k, str(params[k]))
    if "$" in s:
        raise ValueError(f"unresolved scene parameter in {s!r}")
    return s


def _floats(s: str):
    return [float(x) for x in _NUM_SPLIT.split(s.strip()) if x]


def _vec3(node, params, default=0.0):
    v = node.get("value")
    if v is not None:
        arr = _floats(_subst(v, params))
        if len(arr) == 1:
            arr = arr * 3
        return arr
    return [float(_subst(node.get(ax, str(default)), params))
            for ax in ("x", "y", "z")]


def _parse_transform(node, params):
    """<transform> -> {'transforms': [{op: arg}, ...]}."""
    steps = []
    for ch in node:
        tag = ch.tag.lower()
        if tag == "translate":
            steps.append({"translate": _vec3(ch, params, 0.0)})
        elif tag == "scale":
            steps.append({"scale": _vec3(ch, params, 1.0)})
        elif tag == "rotate":
            steps.append({"rotate": {
                "axis": _vec3(ch, params, 0.0),
                "angle": float(_subst(ch.get("angle", "0"), params))}})
        elif tag in ("lookat", "look_at"):
            steps.append({"look_at": {
                "origin": _floats(_subst(ch.get("origin"), params)),
                "target": _floats(_subst(ch.get("target"), params)),
                "up": _floats(_subst(ch.get("up", "0, 0, 1"), params))}})
        elif tag == "matrix":
            steps.append({"matrix": _floats(_subst(ch.get("value"), params))})
        else:
            raise ValueError(f"unsupported transform child <{tag}>")
    return {"transforms": steps}


def _parse_spectrum_value(s: str):
    """'400:0.1, 500:0.2' -> irregular; '0.5' -> uniform."""
    if ":" in s:
        pairs = [p for p in _NUM_SPLIT.split(s.strip()) if p]
        wl, vals = [], []
        for p in pairs:
            a, b = p.split(":")
            wl.append(float(a))
            vals.append(float(b))
        return {"type": "irregular", "wavelengths": wl, "values": vals}
    vals = _floats(s)
    if len(vals) == 1:
        return {"type": "uniform", "value": vals[0]}
    return {"type": "regular", "values": vals}


def _parse_object(node, params, ids, base_dir):
    """An object element -> plugin dict; registers ``id=`` in ``ids``."""
    d = {"type": _subst(node.get("type", ""), params)}
    anon = 0
    for ch in node:
        tag = ch.tag.lower()
        name = ch.get("name")
        if name is not None:
            name = _subst(name, params)
        if tag in ("float", "integer"):
            val = _subst(ch.get("value"), params)
            d[name] = int(val) if tag == "integer" else float(val)
        elif tag == "boolean":
            d[name] = _subst(ch.get("value"), params).lower() == "true"
        elif tag == "string":
            val = _subst(ch.get("value"), params)
            if name == "filename" and base_dir and not os.path.isabs(val):
                val = os.path.join(base_dir, val)
            d[name] = val
        elif tag in ("vector", "point"):
            d[name] = _vec3(ch, params)
        elif tag == "rgb":
            d[name] = {"type": "rgb",
                       "value": _floats(_subst(ch.get("value"), params))}
        elif tag == "spectrum" and ch.get("value") is not None:
            d[name] = _parse_spectrum_value(_subst(ch.get("value"), params))
        elif tag == "transform":
            d[name or "to_world"] = _parse_transform(ch, params)
        elif tag == "ref":
            ref_id = _subst(ch.get("id"), params)
            if ref_id not in ids:
                raise ValueError(f"<ref id={ref_id!r}> not declared")
            key = name or _category_of(ids[ref_id].get("type", ""))
            if key in d:
                key = f"{key}_{anon}"
            d[key] = ids[ref_id]
            anon += 1
        elif tag in _OBJECT_TAGS:
            sub = _parse_object(ch, params, ids, base_dir)
            key = name or tag
            if key in d:
                key = f"{key}_{anon}"
            d[key] = sub
            anon += 1
        elif tag == "default":
            params.setdefault(_subst(ch.get("name"), params),
                              ch.get("value"))
        else:
            raise ValueError(f"unsupported element <{tag}> in "
                             f"<{node.tag} type={d['type']!r}>")
    obj_id = node.get("id")
    if obj_id is not None:
        ids[_subst(obj_id, params)] = d
    return d


def xml_to_dict(source: str, parameters: dict | None = None,
                base_dir: str | None = None) -> dict:
    """Parse Mitsuba scene XML (a path or an XML string) to a scene dict."""
    params = dict(parameters or {})
    if os.path.exists(source):
        base_dir = base_dir or os.path.dirname(os.path.abspath(source))
        tree = ET.parse(source)
        root = tree.getroot()
    else:
        root = ET.fromstring(source)
    if root.tag != "scene":
        raise ValueError(f"expected <scene>, got <{root.tag}>")

    scene = {"type": "scene"}
    ids: dict = {}
    counters: dict = {}
    for ch in root:
        tag = ch.tag.lower()
        if tag == "default":
            params.setdefault(ch.get("name"), ch.get("value"))
            continue
        if tag == "alias":
            ids[_subst(ch.get("as"), params)] = \
                ids[_subst(ch.get("id"), params)]
            continue
        if tag == "include":
            fn = _subst(ch.get("filename"), params)
            if base_dir and not os.path.isabs(fn):
                fn = os.path.join(base_dir, fn)
            sub = xml_to_dict(fn, params)
            for k, v in sub.items():
                if k != "type":
                    scene[k] = v
            continue
        if tag not in _OBJECT_TAGS:
            raise ValueError(f"unsupported top-level element <{tag}>")
        obj = _parse_object(ch, params, ids, base_dir)
        key = ch.get("id")
        if key is None:
            n = counters.get(tag, 0)
            counters[tag] = n + 1
            key = tag if n == 0 else f"{tag}_{n}"
        scene[_subst(key, params)] = obj
    return scene


def load_file(path: str, mode: str = "rgb", parameters: dict | None = None,
              device="cuda"):
    """``mi.load_file`` equivalent: XML or JSON scene -> SceneBundle, its
    tensors on `device` (the card unless the caller names another).
    `mode` as `load_dict`'s, so a polarized variant renders Stokes vectors
    here too (the reference's `tpusky.load_file` drops the variant's
    polarization, R21)."""
    from .loader import load_dict
    if path.endswith(".xml"):
        return load_dict(xml_to_dict(path, parameters), mode=mode,
                         device=device)
    import json
    with open(path) as f:
        return load_dict(json.load(f), mode=mode, device=device)
