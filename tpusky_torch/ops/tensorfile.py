"""Dupuy/Jakob `tensor_file` container I/O (the RGL measured-BRDF
".bsdf" and ".pbsdf" format; Mitsuba's `src/core/tensor.cpp:10-52`), a
numpy-only copy of `tpusky/ops/tensorfile.py` for the port.

Layout: 12-byte magic "tensor_file\\0", u8 version[2] = {1, 0}, u32
field count; per field: u16 name length, name bytes, u16 ndim, u8 dtype
(mitsuba `Struct::Type`: UInt8 = 1, Float32 = 10), u64 data offset, u64
shape[ndim]; raw data blobs at the recorded offsets.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = b"tensor_file\x00"
_DTYPES = {1: np.uint8, 3: np.uint16, 5: np.uint32, 7: np.uint64,
           2: np.int8, 4: np.int16, 6: np.int32, 8: np.int64,
           9: np.float16, 10: np.float32, 11: np.float64}
_DTYPE_IDS = {np.dtype(v): k for k, v in _DTYPES.items()}


def read_tensor_file(path: str) -> dict:
    """-> {field name: np.ndarray}."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:12] != _MAGIC:
        raise ValueError(f"{path}: not a tensor_file")
    if data[13] != 0:
        raise ValueError(f"{path}: unknown tensor_file version")
    (n_fields,) = struct.unpack_from("<I", data, 14)
    pos = 18
    out = {}
    for _ in range(n_fields):
        (name_len,) = struct.unpack_from("<H", data, pos)
        pos += 2
        name = data[pos:pos + name_len].decode("utf-8")
        pos += name_len
        ndim, dtype = struct.unpack_from("<HB", data, pos)
        pos += 3
        (offset,) = struct.unpack_from("<Q", data, pos)
        pos += 8
        shape = struct.unpack_from(f"<{ndim}Q", data, pos)
        pos += 8 * ndim
        if dtype not in _DTYPES:
            raise ValueError(f"{path}: field {name!r} has unknown dtype "
                             f"{dtype}")
        np_dtype = np.dtype(_DTYPES[dtype]).newbyteorder("<")
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(data, np_dtype, count, offset).reshape(shape)
        out[name] = arr.astype(arr.dtype.newbyteorder("="))
    return out


def write_tensor_file(path: str, fields: dict) -> None:
    """Write {name: array} in the same layout (for tests / converters)."""
    entries = [(k.encode("utf-8"), np.ascontiguousarray(v))
               for k, v in fields.items()]
    header_size = 18 + sum(2 + len(nb) + 3 + 8 + 8 * a.ndim
                           for nb, a in entries)
    header = bytearray(_MAGIC + bytes([1, 0])
                       + struct.pack("<I", len(entries)))
    offset = header_size
    blobs = []
    for nb, a in entries:
        if a.dtype not in _DTYPE_IDS:
            raise ValueError(f"unsupported dtype {a.dtype}")
        header += struct.pack("<H", len(nb)) + nb
        header += struct.pack("<HB", a.ndim, _DTYPE_IDS[a.dtype])
        header += struct.pack("<Q", offset)
        header += struct.pack(f"<{a.ndim}Q", *a.shape)
        blobs.append(a.tobytes())
        offset += len(blobs[-1])
    assert len(header) == header_size
    with open(path, "wb") as f:
        f.write(header)
        for b in blobs:
            f.write(b)
