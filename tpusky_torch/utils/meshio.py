"""Mesh file readers: PLY (ascii + binary) and Mitsuba `.serialized`.

A copy of `tpusky/utils/meshio.py`. Host-side NumPy only (runs once at
scene build). Counterparts of the
reference's mesh shape plugins (SURVEY.md H20): `src/shapes/ply.cpp`
(PLY grammar) and `src/shapes/serialized.cpp:196-410` (format: u16 magic
0x041C, u16 version 3/4, zlib stream of [u32 flags, v4: cstring name,
u64 vertex_count, u64 face_count, positions, normals?, texcoords?,
colors?, u32 faces], trailing u64 offset table + u32 mesh count).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# serialized-format flags (`serialized.cpp:220-228`)
_HAS_NORMALS = 0x0001
_HAS_TEXCOORDS = 0x0002
_HAS_COLORS = 0x0008
_FACE_NORMALS = 0x0010
_SINGLE = 0x1000
_DOUBLE = 0x2000

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(path: str):
    """Read a PLY mesh -> (positions (V,3) f32, normals (V,3) f32,
    indices (T,3) i32, uvs (V,2) f32). Normals/uvs zero when absent.

    Handles format ascii / binary_little_endian / binary_big_endian 1.0,
    arbitrary extra vertex properties (skipped), and list-typed face
    properties (fan-triangulated).
    """
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"ply"):
        raise ValueError(f"{path}: not a PLY file")
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", "replace").splitlines()
    body = data[end:]

    fmt = None
    elements = []          # (name, count, [(prop_name, dtype, is_list,
    #                         count_dtype, item_dtype)])
    for line in header[1:]:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append((tok[4], None, True,
                                        _PLY_TYPES[tok[2]],
                                        _PLY_TYPES[tok[3]]))
            else:
                elements[-1][2].append((tok[2], _PLY_TYPES[tok[1]], False,
                                        None, None))
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported PLY format {fmt!r}")
    bo = "<" if fmt != "binary_big_endian" else ">"

    verts = {}
    faces = []
    if fmt == "ascii":
        lines = body.decode("ascii").split("\n")
        li = 0
        for name, count, props in elements:
            rows = []
            for _ in range(count):
                vals = lines[li].split()
                li += 1
                if any(p[2] for p in props):     # list property (faces)
                    n = int(vals[0])
                    idxs = [int(v) for v in vals[1:1 + n]]
                    for k in range(2, n):
                        faces.append([idxs[0], idxs[k - 1], idxs[k]])
                else:
                    rows.append([float(v) for v in vals[:len(props)]])
            if name == "vertex":
                arr = np.asarray(rows, np.float64)
                for ci, (pname, *_rest) in enumerate(props):
                    verts[pname] = arr[:, ci]
    else:
        off = 0
        for name, count, props in elements:
            if not any(p[2] for p in props):
                dt = np.dtype([(p[0], bo + p[1]) for p in props])
                arr = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
                if name == "vertex":
                    for pname, *_rest in props:
                        verts[pname] = arr[pname].astype(np.float64)
            else:
                # list property: parse row by row (counts may vary)
                scal = [p for p in props if not p[2]]
                lst = [p for p in props if p[2]][0]
                cdt = np.dtype(bo + lst[3])
                idt = np.dtype(bo + lst[4])
                sdt_size = sum(np.dtype(bo + p[1]).itemsize for p in scal)
                for _ in range(count):
                    n = int(np.frombuffer(body, cdt, 1, off)[0])
                    off += cdt.itemsize
                    idxs = np.frombuffer(body, idt, n, off)
                    off += idt.itemsize * n + sdt_size
                    for k in range(2, n):
                        faces.append([idxs[0], idxs[k - 1], idxs[k]])

    nv = len(verts.get("x", ()))
    pos = np.stack([verts.get(c, np.zeros(nv)) for c in "xyz"],
                   -1).astype(np.float32)
    nrm = np.stack([verts.get("n" + c, np.zeros(nv)) for c in "xyz"],
                   -1).astype(np.float32)
    uk = ("u", "v") if "u" in verts else ("s", "t")
    uv = np.stack([verts.get(uk[0], np.zeros(nv)),
                   verts.get(uk[1], np.zeros(nv))], -1).astype(np.float32)
    # vertex colors (for the `mesh_attribute` texture, reference
    # `mesh_attribute.cpp`); uchar-encoded colors are normalised to [0,1]
    col = None
    if "red" in verts:
        col = np.stack([verts["red"], verts.get("green", verts["red"]),
                        verts.get("blue", verts["red"])],
                       -1).astype(np.float32)
        if col.max(initial=0.0) > 1.0:
            col = col / 255.0
    idx = (np.asarray(faces, np.int64).astype(np.int32).reshape(-1, 3)
           if faces else np.zeros((0, 3), np.int32))
    return pos, nrm, idx, uv, col


def read_serialized(path: str, shape_index: int = 0,
                    face_normals: bool = False):
    """Read mesh `shape_index` from a Mitsuba `.serialized` file ->
    (positions (V,3) f32, normals (V,3) f32, indices (T,3) i32,
    uvs (V,2) f32). Normals zeroed when `face_normals` or absent."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<HH", data, 0)
    if magic != 0x041C:
        raise ValueError(f"{path}: bad serialized magic {magic:#x}")
    if version not in (3, 4):
        raise ValueError(f"{path}: unsupported version {version}")
    (count,) = struct.unpack_from("<I", data, len(data) - 4)
    if not 0 <= shape_index < count:
        raise ValueError(f"shape_index {shape_index} out of range "
                         f"(file holds {count})")
    osz = 8 if version == 4 else 4
    table = len(data) - 4 - osz * count
    (offset,) = struct.unpack_from("<Q" if version == 4 else "<I", data,
                                   table + osz * shape_index)
    # each mesh blob: u16 magic, u16 version, zlib stream
    payload = zlib.decompressobj().decompress(data[offset + 4:])
    pos_b = 0

    def take(fmt):
        nonlocal pos_b
        out = struct.unpack_from("<" + fmt, payload, pos_b)
        pos_b += struct.calcsize("<" + fmt)
        return out

    (flags,) = take("I")
    if version == 4:
        z = payload.index(b"\x00", pos_b)
        pos_b = z + 1
    nv, nf = take("QQ")
    fdt = np.float64 if (flags & _DOUBLE) else np.float32

    def arr(n, dim, dt):
        nonlocal pos_b
        a = np.frombuffer(payload, dt, n * dim, pos_b).reshape(n, dim)
        pos_b += a.nbytes
        return a

    pos = arr(nv, 3, fdt).astype(np.float32)
    nrm = np.zeros((nv, 3), np.float32)
    if flags & _HAS_NORMALS:
        n_raw = arr(nv, 3, fdt)
        if not (face_normals or (flags & _FACE_NORMALS)):
            nrm = n_raw.astype(np.float32)
    uv = np.zeros((nv, 2), np.float32)
    if flags & _HAS_TEXCOORDS:
        uv = arr(nv, 2, fdt).astype(np.float32)
    if flags & _HAS_COLORS:
        arr(nv, 3, fdt)                      # skipped, like the reference
    idx = arr(nf, 3, np.uint32).astype(np.int32)
    return pos, nrm, idx, uv


def write_serialized(path: str, positions, indices, normals=None,
                     uvs=None) -> None:
    """Write a single-mesh v4 `.serialized` file (test/tooling helper)."""
    pos = np.asarray(positions, np.float32)
    idx = np.asarray(indices, np.uint32)
    flags = _SINGLE
    body = [struct.pack("<I", 0), b"mesh\x00"]
    parts = [pos.tobytes()]
    if normals is not None:
        flags |= _HAS_NORMALS
        parts.append(np.asarray(normals, np.float32).tobytes())
    if uvs is not None:
        flags |= _HAS_TEXCOORDS
        parts.append(np.asarray(uvs, np.float32).tobytes())
    parts.append(idx.tobytes())
    body[0] = struct.pack("<I", flags)
    payload = (b"".join(body)
               + struct.pack("<QQ", len(pos), len(idx))
               + b"".join(parts))
    blob = struct.pack("<HH", 0x041C, 4) + zlib.compress(payload)
    with open(path, "wb") as f:
        f.write(blob)
        f.write(struct.pack("<Q", 0))        # offset of mesh 0
        f.write(struct.pack("<I", 1))        # mesh count


def icosphere(n_subdiv: int):
    """Unit icosphere: a subdivided icosahedron -> (positions (V,3) f32,
    indices (T,3) i32) with 20 * 4^n_subdiv triangles. A copy of the
    reference repository's benchmark mesh (`tools/bench_mesh.py:32-64`)."""
    t = (1.0 + 5 ** 0.5) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10],
                  [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                  [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                  [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5],
                  [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int32)
    for _ in range(n_subdiv):
        cache = {}
        verts = list(v)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (verts[a] + verts[b]) / 2.0
                m /= np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(m)
            return cache[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(verts)
        f = np.asarray(nf, np.int32)
    return v.astype(np.float32), f
