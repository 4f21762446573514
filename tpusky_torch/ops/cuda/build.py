"""Build and load the port's CUDA kernels.

`library()` compiles every source in `tpusky_torch/csrc` with nvcc into
one shared library with a plain C interface, at first use, and loads it
with ctypes: one nvcc per source, all started together, then one link.
The library lives in `build/tpusky_torch/` at the repository root under a
name keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads at once. nvcc's `-Xptxas -v` report
(registers, spills per kernel) is kept beside it as `<name>.log`;
`ptxas_report()` reads it.

Every kernel wrapper counts its launches in `launches`, a plain dict of
ints, so a run can show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile

_CSRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "build", "tpusky_torch")
_SOURCES = ("sunsky_kernels.cu", "megakernel.cu", "sunsky_adjoint.cu",
            "sunsky_spectral.cu", "sunsky_spectral_adjoint.cu",
            "mesh_kernel.cu")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = {"sunsky_eval_rgb": 0, "sunsky_hit_rgb": 0, "sunsky_nee_rgb": 0,
            "direct_rgb_megakernel": 0, "sunsky_eval_rgb_bwd": 0,
            "sunsky_nee_rgb_bwd": 0, "sunsky_hit_rgb_bwd": 0,
            "sunsky_nee_rgb_pdf_bwd": 0, "sunsky_eval_spec": 0,
            "sunsky_hit_spec": 0, "sunsky_nee_spec": 0,
            "sunsky_hit_spec_bwd": 0, "sunsky_nee_spec_bwd": 0,
            "mesh_intersect": 0}

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
    # n -> rows of block-partial scratch K12/K13 need
    "tsk_adjoint_rows": (_I,),
    # n, k -> rows of block-partial scratch K5-K8 (k = 5-8) need
    "tsk_adjoint_rgb_rows": (_I, _I),
    # d, g, n, skyp, skyr, sun, misc, dd, partial, out, stream
    "tsk_sunsky_eval_rgb_bwd": (_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P),
    # u, g, n, skyp, skyr, sun, misc, gauss, partial, out, stream
    "tsk_sunsky_nee_rgb_bwd": (_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P),
    # d, g, g_pdf, n, skyp, skyr, sun, misc, gauss, dd, partial, out, stream
    "tsk_sunsky_hit_rgb_bwd": (_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P),
    # u, g, g_pdf, n, skyp, skyr, sun, misc, gauss, partial, out, stream
    "tsk_sunsky_nee_rgb_pdf_bwd": (_P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                                   _P, _P),
    # d, wl, n, w, skyp, skyr, sun, ld, misc, out, stream
    "tsk_sunsky_eval_spec": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    # d, wl, n, w, skyp, skyr, sun, ld, misc, gauss, rad, pdf, stream
    "tsk_sunsky_hit_spec": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P),
    # u, wl, n, w, skyp, skyr, sun, ld, misc, gauss, d, rad, pdf, stream
    "tsk_sunsky_nee_spec": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _P),
    # d, wl, g, g_pdf (or null), n, w, skyp, skyr, sun, ld, misc, gauss,
    # dd, dwl (each or null), partial, out, stream
    "tsk_sunsky_hit_spec_bwd": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                                _P, _P, _P, _P, _P, _P),
    # u, wl, g, g_pdf (or null), n, w, skyp, skyr, sun, ld, misc, gauss,
    # dwl (or null), partial, out, stream
    "tsk_sunsky_nee_spec_bwd": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                                _P, _P, _P, _P, _P),
    # o, d, n, tris, leaves, boxes, super_boxes, n_super, t, b1, b2, tri,
    # work (or null), stream
    "tsk_mesh_intersect": (_P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P,
                           _P, _P),
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
    nvcc = _nvcc()
    work = tempfile.mkdtemp(dir=_BUILD_DIR)
    try:
        procs = []
        for src in _SOURCES:
            obj = os.path.join(work, src + ".o")
            procs.append((obj, subprocess.Popen(
                [nvcc, *_FLAGS, "-c", "-o", obj, os.path.join(_CSRC, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = ""
        failed = []
        for (obj, proc), src in zip(procs, _SOURCES):
            log += f"== {src}\n" + proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(src)
        if not failed:
            tmp = os.path.join(work, "lib.so")
            link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", tmp,
                                   *(obj for obj, _ in procs)],
                                  capture_output=True, text=True)
            log += "== link\n" + link.stdout + link.stderr
            if link.returncode != 0:
                failed.append("link")
        with open(out[:-3] + ".log", "w") as f:
            f.write(log)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        shutil.rmtree(work, ignore_errors=True)
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


def _kernel_label(symbol: str) -> str:
    """A kernel's name from its mangled symbol, with its bool template
    arguments: `_ZN<ns>19spec_hit_bwd_kernelILb0EEEv...` ->
    `spec_hit_bwd_kernel<false>`."""
    i = 3 if symbol.startswith("_ZN") else 2
    names = []
    while i < len(symbol) and symbol[i].isdigit():
        j = i
        while symbol[j].isdigit():
            j += 1
        names.append(symbol[j:j + int(symbol[i:j])])
        i = j + int(symbol[i:j])
    if not names:
        return symbol
    args = re.match(r"I((?:Lb[01]E)+)E", symbol[i:])
    if args is None:
        return names[-1]
    flags = [("false", "true")[int(f)]
             for f in re.findall(r"Lb([01])E", args.group(1))]
    return f"{names[-1]}<{', '.join(flags)}>"


def ptxas_report() -> dict:
    """{(source, kernel): {"registers", "stack", "spill_stores",
    "spill_loads"}} from the build log of the current library."""
    with open(build()[:-3] + ".log") as f:
        log = f.read()
    out, source, kernel = {}, None, None
    for line in log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif "Compiling entry function" in line:
            kernel = _kernel_label(line.split("'")[1])
        elif "spill stores" in line and kernel is not None:
            n = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[(source, kernel)] = {"stack": n[0], "spill_stores": n[1],
                                     "spill_loads": n[2]}
        elif "Used" in line and "registers" in line and kernel is not None:
            out.setdefault((source, kernel), {})["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out
