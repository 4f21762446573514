"""The PyTorch port stands alone: no file of `tpusky_torch`, nor
chip_smoke.py or the port's tools (`tools/torch_*.py`), imports jax,
optax, scipy or the JAX package, and every module imports on a machine
without nvcc, triton or a CUDA device (kernels are built and loaded only
when a CUDA tensor first reaches them)."""

import ast
import importlib
import os
import pkgutil
import sys

import pytest

import tpusky_torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, "tpusky_torch")
_FORBIDDEN = ("jax", "jaxlib", "optax", "scipy", "tpusky")


def _python_files():
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    tools = os.path.join(_ROOT, "tools")
    files += [os.path.join(tools, n) for n in os.listdir(tools)
              if n.startswith("torch_") and n.endswith(".py")]
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
            "tpusky_torch.ad.recovery",
            "tpusky_torch.models.sunsky.astronomy",
            "tpusky_torch.utils.chi2",
            "tpusky_torch.utils.ztest",
            "tpusky_torch.parallel.render",
            "tpusky_torch.ops.mueller",
            "tpusky_torch.render.polarized",
            "tpusky_torch.ops.tensorfile",
            "tpusky_torch.render.measured",
            "tpusky_torch.render.sdf",
            "tpusky_torch.render.curve",
            "tpusky_torch.convert"} <= names
    csrc = set(os.listdir(os.path.join(_PKG, "csrc")))
    assert {"sunsky_core.cuh", "sunsky_kernels.cu", "megakernel.cu",
            "sunsky_adjoint.cu", "mesh_kernel.cu"} <= csrc


def test_ptxas_report_reads_the_build_log(tmp_path, monkeypatch):
    """`build.ptxas_report` names each kernel of nvcc's `-Xptxas -v` log
    with its bool template arguments and reads its registers and spills,
    as chip_smoke.py prints and checks them."""
    from tpusky_torch.ops.cuda import build
    sym = ("_ZN59_GLOBAL__N__8fd773c9_26_sunsky_spectral_adjoint_cu_1bf9696f"
           "19spec_nee_bwd_kernelILb1EEEvPKfS2_S2_S2_iiN3tsk6TablesEPfS5_")
    red = ("_ZN59_GLOBAL__N__8fd773c9_26_sunsky_spectral_adjoint_cu_1bf9696f"
           "15reduce_partialsEPKfiiPf")
    (tmp_path / "lib.log").write_text(
        "== sunsky_spectral_adjoint.cu\n"
        f"ptxas info    : Compiling entry function '{sym}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {sym}\n"
        "    32 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 127 registers, used 1 barriers, 32 bytes "
        "cumulative stack size, 23024 bytes smem\n"
        f"ptxas info    : Compiling entry function '{red}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {red}\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 1 barriers, 1024 bytes "
        "smem\n== link\n")
    monkeypatch.setattr(build, "build", lambda: str(tmp_path / "lib.so"))
    assert build.ptxas_report() == {
        ("sunsky_spectral_adjoint.cu", "spec_nee_bwd_kernel<true>"): {
            "stack": 32, "spill_stores": 8, "spill_loads": 4,
            "registers": 127},
        ("sunsky_spectral_adjoint.cu", "reduce_partials"): {
            "stack": 0, "spill_stores": 0, "spill_loads": 0,
            "registers": 32}}
