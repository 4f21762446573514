"""Build and load the port's CUDA kernels.

`library()` compiles every source in `tpusky_torch/csrc` with nvcc into
one shared library with a plain C interface, at first use, and loads it
with ctypes. The library lives in `build/tpusky_torch/` at the repository
root under a name keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once. nvcc's `-Xptxas -v`
report (registers, spills per kernel) is kept beside it as `<name>.log`.

Every kernel wrapper counts its launches in `launches`, a plain dict of
ints, so a run can show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

_CSRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "build", "tpusky_torch")
_SOURCES = ("sunsky_kernels.cu", "megakernel.cu")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = {"sunsky_eval_rgb": 0, "sunsky_hit_rgb": 0, "sunsky_nee_rgb": 0,
            "direct_rgb_megakernel": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # d, n, skyp, skyr, sun, misc, out, stream
    "tsk_sunsky_eval_rgb": (_P, _I, _P, _P, _P, _P, _P, _P),
    # d, n, skyp, skyr, sun, misc, gauss, rad, pdf, stream
    "tsk_sunsky_hit_rgb": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P),
    # u, n, skyp, skyr, sun, misc, gauss, d, rad, pdf, stream
    "tsk_sunsky_nee_rgb": (_P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    # cam, shp, mat, kind, n_shapes, seed, spp, width, height,
    # skyp, skyr, sun, misc, gauss, out, stream
    "tsk_direct_rgb_megakernel": (_P, _P, _P, _P, _I, ctypes.c_uint, _I, _I,
                                  _I, _P, _P, _P, _P, _P, _P, _P),
}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or nvcc on PATH)")
    return found


def _source_hash():
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in sorted(os.listdir(_CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(_CSRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if needed; return the path of the library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out = os.path.abspath(os.path.join(
        _BUILD_DIR, f"libtpusky_torch_{_source_hash()}.so"))
    if os.path.exists(out):
        return out
    srcs = [os.path.join(_CSRC, s) for s in _SOURCES]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_nvcc(), *_FLAGS, "-o", tmp, *srcs],
                          capture_output=True, text=True)
    with open(out[:-3] + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str):
    """Raise if a launcher returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
