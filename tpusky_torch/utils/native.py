"""ctypes binding of the native support library (`native/tpusky_native.cpp`;
the reference package's `tpusky/utils/native.py`): the OBJ parser and the
PCG32 stream.

The committed `native/libtpusky_native.so` is used when it loads and runs
on this host: it was built with `-march=native`, so it is first tried in
a child process on a two-triangle OBJ, and a library whose instructions
this CPU lacks fails there rather than here. Otherwise the library is
built from the source with g++ (portable flags) into the git-ignored
`build/native/` at the repository root and tried the same way; nothing
is written into `native/`. Without either, every entry point runs its
pure-Python path (`utils/obj.py`), and `have_native()` says which one
ran.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from functools import lru_cache

import numpy as np

from .obj import load_obj as _load_obj_py

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
_SOURCE = os.path.join(_ROOT, "native", "tpusky_native.cpp")
_COMMITTED = os.path.join(_ROOT, "native", "libtpusky_native.so")
_BUILT = os.path.join(_ROOT, "build", "native", "libtpusky_native.so")

# run in a child process: parse a two-triangle OBJ and draw from PCG32
_PROBE = r"""
import ctypes, sys
lib = ctypes.CDLL(sys.argv[1])
if lib.obj_parse(sys.argv[2].encode()) != 0:
    raise SystemExit(1)
n = (ctypes.c_int64 * 2)()
lib.obj_counts(ctypes.byref(n, 0), ctypes.byref(n, 8))
out = (ctypes.c_float * 9)()
lib.obj_free()
lib.pcg32_fill_float(ctypes.c_uint64(1), ctypes.c_uint64(2),
                     ctypes.c_uint64(0), out, ctypes.c_int64(9))
raise SystemExit(0 if (n[0], n[1]) == (4, 2) else 1)
"""
_PROBE_OBJ = "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n"


def _runs(path: str) -> bool:
    """Whether the library at `path` loads and runs, tried in a child
    process (an illegal instruction ends the child, not this process)."""
    if not os.path.exists(path):
        return False
    with tempfile.TemporaryDirectory() as tmp:
        obj = os.path.join(tmp, "probe.obj")
        with open(obj, "w") as f:
            f.write(_PROBE_OBJ)
        try:
            r = subprocess.run([sys.executable, "-I", "-S", "-c", _PROBE, path,
                                obj],
                               capture_output=True, timeout=60)
        except (OSError, subprocess.TimeoutExpired):
            return False
    return r.returncode == 0


def _build() -> bool:
    """Compile the source into build/native/ with portable flags."""
    os.makedirs(os.path.dirname(_BUILT), exist_ok=True)
    tmp = f"{_BUILT}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp,
                        _SOURCE], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, _BUILT)
    except (OSError, subprocess.SubprocessError):
        return False
    return True


@lru_cache(maxsize=1)
def _lib():
    if _runs(_COMMITTED):
        path = _COMMITTED
    elif _runs(_BUILT) or (_build() and _runs(_BUILT)):
        path = _BUILT
    else:
        return None
    lib = ctypes.CDLL(path)
    f32, i64 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)
    for name, args, res in (
            ("obj_parse", [ctypes.c_char_p], ctypes.c_int),
            ("obj_counts", [i64, i64], None),
            ("obj_copy", [f32, f32, ctypes.POINTER(ctypes.c_int32)], None),
            ("obj_copy_uvs", [f32], None),
            ("obj_free", [], None),
            ("pcg32_fill_float", [ctypes.c_uint64] * 3 + [f32,
                                                         ctypes.c_int64],
             None)):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = res
    lib.path = path
    return lib


def have_native() -> bool:
    """Whether the native library runs here (else the Python paths)."""
    return _lib() is not None


def native_path():
    """The library in use (the committed one or build/'s), or None."""
    lib = _lib()
    return None if lib is None else os.path.normpath(lib.path)


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def load_obj(path: str):
    """Parse an OBJ file -> (positions (V,3) f32, normals (V,3) f32,
    indices (T,3) i32, uvs (V,2) f32), through the native parser when it
    runs here (which also reads `vn` normals, first one a vertex wins)
    and `utils/obj.py` otherwise (normals zero)."""
    lib = _lib()
    if lib is None:
        return _load_obj_py(path)
    if lib.obj_parse(path.encode()) != 0:
        raise FileNotFoundError(path)
    nv = ctypes.c_int64()
    nt = ctypes.c_int64()
    lib.obj_counts(ctypes.byref(nv), ctypes.byref(nt))
    pos = np.zeros((nv.value, 3), np.float32)
    nrm = np.zeros((nv.value, 3), np.float32)
    idx = np.zeros((nt.value, 3), np.int32)
    uv = np.zeros((nv.value, 2), np.float32)
    lib.obj_copy(_ptr(pos, ctypes.c_float), _ptr(nrm, ctypes.c_float),
                 _ptr(idx, ctypes.c_int32))
    lib.obj_copy_uvs(_ptr(uv, ctypes.c_float))
    lib.obj_free()
    return pos, nrm, idx, uv


def pcg32_uniform(initstate: int, initseq: int, n: int, skip: int = 0):
    """n uniform float32 in [0, 1) from a PCG32 stream, skipping `skip`
    draws (the reference's sampler RNG), natively when it runs here."""
    out = np.zeros((n,), np.float32)
    lib = _lib()
    if lib is not None:
        lib.pcg32_fill_float(initstate, initseq, skip,
                             _ptr(out, ctypes.c_float), n)
        return out
    mask = 0xFFFFFFFFFFFFFFFF
    state = 0
    inc = ((initseq << 1) | 1) & mask

    def nxt():
        nonlocal state
        old = state
        state = (old * 6364136223846793005 + inc) & mask
        xorshifted = (((old >> 18) ^ old) >> 27) & 0xFFFFFFFF
        rot = old >> 59
        return ((xorshifted >> rot) | (xorshifted << ((-rot) & 31))) \
            & 0xFFFFFFFF

    nxt()
    state = (state + initstate) & mask
    nxt()
    for _ in range(skip):
        nxt()
    bits = np.array([(nxt() >> 9) | 0x3F800000 for _ in range(n)],
                    np.uint32)
    out[:] = bits.view(np.float32) - np.float32(1.0)
    return out
