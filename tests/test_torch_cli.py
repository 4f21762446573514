"""The port's command line, variants and native OBJ parser on the CPU:
`python -m tpusky_torch render` of a tiny scene writes the EXR of
`bundle.render`; `config.Variant`/`resolve` parse Mitsuba variant names
as the JAX package's do; the native `load_obj` (`utils/native.py`)
equals the pure-Python one and the reference's, and its PCG32 stream the
reference's.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_loader_case as L
import tpusky_torch as tt
from tpusky import config as JC
from tpusky.utils import native as JN
from tpusky_torch import cli
from tpusky_torch import config as TC
from tpusky_torch.utils import native as TN
from tpusky_torch.utils.io import read_exr, read_png
from tpusky_torch.utils.obj import load_obj as load_obj_py

torch.set_num_threads(1)


def test_cli_writes_the_render(tmp_path, capsys):
    """`render scene.json -o out.exr --png out.png --spp 3 --seed 4
    --device cpu` (the headline scene at 16x16, matrices as lists) and
    the same for an XML file with `-D` overrides: each EXR is
    `load_file(...).render(seed, spp)` bitwise, the PNG its tone-mapped
    8-bit image, and the run prints its size and integrator."""
    d = L.headline()
    js = tmp_path / "scene.json"
    js.write_text(json.dumps(d, default=lambda a: np.asarray(a).tolist()))
    exr, png = str(tmp_path / "out.exr"), str(tmp_path / "out.png")
    assert cli.main(["render", str(js), "-o", exr, "--png", png, "--spp",
                     "3", "--seed", "4", "--device", "cpu"]) == 0
    img, names = read_exr(exr)
    want = tt.load_file(str(js), device="cpu").render(seed=4, spp=3).numpy()
    assert names == ["B", "G", "R"]
    np.testing.assert_array_equal(img[..., ::-1], want)
    tone = read_png(png)
    assert tone.shape == (16, 16, 3) and 0.0 < tone.mean() < 1.0
    assert "rendered 16x16 @ 3spp (path, depth 3, rgb)" in \
        capsys.readouterr().out
    xml = tmp_path / "scene.xml"
    xml.write_text("""<scene version="3.0.0">
    <default name="spp" value="2"/>
    <integrator type="direct"/>
    <sensor type="perspective">
        <transform name="to_world">
            <lookat origin="4, -4, 2" target="0, 0, 1" up="0, 0, 1"/>
        </transform>
        <film type="hdrfilm"><integer name="width" value="$w"/>
            <integer name="height" value="8"/></film>
        <sampler type="independent">
            <integer name="sample_count" value="$spp"/></sampler>
    </sensor>
    <emitter type="sunsky">
        <vector name="sun_direction" value="0.3, 0.2, 0.93"/></emitter>
    <shape type="sphere"/>
</scene>""")
    assert cli.main(["render", str(xml), "-o", exr, "-D", "w=12", "-D",
                     "spp=3", "--mode", "spectral", "--device", "cpu"]) == 0
    img, _ = read_exr(exr)
    want = tt.load_file(str(xml), mode="spectral", parameters={
        "w": "12", "spp": "3"}, device="cpu").render(seed=0).numpy()
    assert img.shape == (8, 12, 3)
    np.testing.assert_array_equal(img[..., ::-1], want)


def test_variants_match_reference():
    """Mitsuba variant names parse to the reference's mode, polarization,
    channel counts and (as a torch dtype) precision; bad names and modes
    raise ValueError in both; `resolve` passes a Variant through."""
    for name in ("llvm_ad_spectral_polarized", "cuda_ad_rgb",
                 "scalar_rgb_double", "tpu_ad_mono", "spectral",
                 "cuda_spectral_polarized_double", "rgb", "mono"):
        t, j = TC.resolve(name), JC.resolve(name)
        assert (t.mode, t.polarized, t.n_channels, t.n_hero) == \
            (j.mode, j.polarized, j.n_channels, j.n_hero), name
        assert (t.dtype == torch.float64) == (j.dtype == jnp.float64), name
    for bad in ("llvm_ad", "cuda_ad_cmyk", "scalar_mono_polarized"):
        with pytest.raises(ValueError):
            JC.resolve(bad)
        with pytest.raises(ValueError):
            TC.resolve(bad)
    v = TC.Variant.from_name("cuda_ad_spectral_polarized")
    assert TC.resolve(v) is v and v.name == "cuda_ad_spectral_polarized"
    with pytest.raises(TypeError):
        TC.resolve(3)


def test_native_obj_matches_python_and_reference(tmp_path, monkeypatch):
    """An OBJ with texcoords, negative indices and a quad: the port's
    native parser (which runs here), its Python parser and both of the
    reference's give the same arrays bitwise; the PCG32 streams of the
    port and the reference are equal, natively and in Python."""
    assert TN.have_native() and TN.native_path().endswith(
        "libtpusky_native.so")
    pos, idx = L.icosphere(2)
    uv = (0.5 + 0.5 * pos[:, :2]).astype(np.float32)
    path = str(tmp_path / "m.obj")
    L.write_obj(path, pos, idx, uv)
    with open(path, "a") as f:
        f.write("v 0 0 2\nv 1 0 2\nv 1 1 2\nv 0 1 2\nf -4 -3 -2 -1\n")
    got = [TN.load_obj(path), load_obj_py(path), JN.load_obj(path),
           JN._load_obj_py(path)]
    assert got[0][2].shape == (idx.shape[0] + 2, 3)
    for other in got[1:]:
        for a, b in zip(got[0], other):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TN.pcg32_uniform(7, 11, 64, skip=5),
                                  JN.pcg32_uniform(7, 11, 64, skip=5))
    monkeypatch.setattr(TN, "_lib", lambda: None)    # the Python paths
    np.testing.assert_array_equal(TN.pcg32_uniform(7, 11, 64, skip=5),
                                  JN.pcg32_uniform(7, 11, 64, skip=5))
    for a, b in zip(TN.load_obj(path), got[0]):
        np.testing.assert_array_equal(a, b)
