"""The PyTorch port stands alone: no file of `tpusky_torch` imports jax or
the JAX package, and every module imports on a machine without nvcc,
triton or a CUDA device (kernels are built and loaded only when a CUDA
tensor first reaches them)."""

import ast
import importlib
import os
import pkgutil
import sys

import pytest

import tpusky_torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, "tpusky_torch")
_FORBIDDEN = ("jax", "jaxlib", "tpusky")


def _python_files():
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(_PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _python_files(),
                         ids=lambda p: os.path.relpath(p, _ROOT))
def test_no_jax_import(path):
    bad = sorted(set(_imported_roots(path)) & set(_FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        tpusky_torch.__path__, "tpusky_torch."))


@pytest.mark.parametrize("name", _modules())
def test_module_imports_without_cuda(name):
    importlib.import_module(name)
    from tpusky_torch.ops.cuda import build
    assert build.library.cache_info().currsize == 0   # nothing built
    assert "triton" not in sys.modules


def test_package_has_kernel_wrappers():
    names = set(_modules())
    assert {"tpusky_torch.ops.cuda.build",
            "tpusky_torch.ops.cuda.sunsky_kernel",
            "tpusky_torch.ops.cuda.megakernel",
            "tpusky_torch.ops.cuda.mesh_kernel",
            "tpusky_torch.render.mesh",
            "tpusky_torch.ad.optimizers",
            "tpusky_torch.parallel.render",
            "tpusky_torch.convert"} <= names
    csrc = set(os.listdir(os.path.join(_PKG, "csrc")))
    assert {"sunsky_core.cuh", "sunsky_kernels.cu", "megakernel.cu",
            "sunsky_adjoint.cu", "mesh_kernel.cu"} <= csrc
