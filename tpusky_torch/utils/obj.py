"""Wavefront OBJ reader (host-side, pure Python).

A copy of the reference package's pure-Python parser
(`tpusky/utils/native.py::_load_obj_py`); `utils/native.py::load_obj`
runs the native one where it runs, and this one otherwise.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Read an OBJ mesh -> (positions (V,3) f32, normals (V,3) f32 zeros,
    indices (T,3) i32, uvs (V,2) f32): positions, texcoords and
    fan-triangulated faces, a vertex's uv taken from its first face
    corner that names one."""
    positions, texcoords, faces, tfaces = [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                positions.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                texcoords.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                verts, tex = [], []
                for tok in line.split()[1:]:
                    parts = tok.split("/")
                    i = int(parts[0])
                    verts.append(i - 1 if i > 0 else len(positions) + i)
                    t = (int(parts[1]) if len(parts) > 1 and parts[1]
                         else 0)
                    tex.append(t - 1 if t > 0
                               else (len(texcoords) + t if t < 0 else -1))
                for k in range(2, len(verts)):
                    faces.append([verts[0], verts[k - 1], verts[k]])
                    tfaces.append([tex[0], tex[k - 1], tex[k]])
    pos = np.asarray(positions, np.float32)
    idx = np.asarray(faces, np.int32).reshape(-1, 3)
    uv = np.zeros((len(positions), 2), np.float32)
    if texcoords:
        tc = np.asarray(texcoords, np.float32)
        ti = np.asarray(tfaces, np.int32).reshape(-1, 3)
        ok = ti >= 0
        uv[idx[ok]] = tc[ti[ok]]
    return pos, np.zeros_like(pos), idx, uv
