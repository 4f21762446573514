"""The port's Mitsuba-XML reader and writer against the JAX package's on
the CPU: `xml_to_dict` on tests/test_xml_loader.py's documents (with
`$parameter` defaults and overrides, `<ref>`/`id`, `<include>` and
spectrum pairs) gives the reference's dicts, `dict_to_xml` the
reference's text; and a scene written by the port's `write_xml` (or as
JSON) loads through `tpusky_torch.load_file` into the tables of
`load_dict` of the same dict, bitwise.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import json

import numpy as np
import pytest
import torch

import torch_loader_case as L
import tpusky_torch as tt
from test_xml_loader import SCENE_XML
from test_xml_writer import _scene_dict
from tpusky.render import xml_loader as JX
from tpusky.render import xml_writer as JW
from tpusky_torch.render import xml_loader as TX
from tpusky_torch.render import xml_writer as TW

torch.set_num_threads(1)

_INCLUDED = """
<scene version="3.0.0">
    <emitter type="constant">
        <spectrum name="radiance" value="400:0.2, 500:0.8, 600:0.4"/>
    </emitter>
</scene>"""
_MAIN = """
<scene version="3.0.0">
    <default name="depth" value="3"/>
    <include filename="common.xml"/>
    <integrator type="direct">
        <integer name="max_depth" value="$depth"/>
    </integrator>
    <shape type="sphere" id="ball">
        <bsdf type="roughconductor" id="metal">
            <float name="alpha" value="0.3"/>
            <spectrum name="eta" value="0.2, 0.4, 1.1"/>
        </bsdf>
        <boolean name="flip" value="true"/>
    </shape>
    <shape type="disk">
        <ref id="metal"/>
        <transform name="to_world">
            <matrix value="1 0 0 1  0 1 0 2  0 0 1 3  0 0 0 1"/>
        </transform>
    </shape>
    <alias id="metal" as="gold"/>
    <shape type="cube"><ref name="bsdf" id="gold"/></shape>
</scene>"""


def test_xml_to_dict_matches_reference(tmp_path):
    """The reference's documents: SCENE_XML as it is and with parameters
    overridden, a file with `<include>`, spectrum pairs and values,
    `<ref>` with and without a name, `<alias>` and a matrix; equal
    dicts. An unresolved parameter raises ValueError in both."""
    (tmp_path / "common.xml").write_text(_INCLUDED)
    main = tmp_path / "main.xml"
    main.write_text(_MAIN)
    for source, params in ((SCENE_XML, None),
                           (SCENE_XML, {"spp": 16, "turb": 7.5}),
                           (str(main), None), (str(main), {"depth": 5})):
        got = TX.xml_to_dict(source, params)
        assert got == JX.xml_to_dict(source, params)
    assert got["integrator"]["max_depth"] == 5
    assert got["emitter"]["radiance"]["type"] == "irregular"
    bad = ('<scene><integrator type="path"><integer name="max_depth" '
           'value="$nope"/></integrator></scene>')
    for xml in (JX, TX):
        with pytest.raises(ValueError, match="unresolved"):
            xml.xml_to_dict(bad)


def _outcome(fn, *args):
    """fn(*args), or the type of what it raised."""
    try:
        return fn(*args)
    except Exception as e:                    # noqa: BLE001
        return type(e)


_NAMED = ("shape", "sensor", "bsdf", "emitter", "texture")


def _nests(obj) -> bool:
    """Whether an object holds an object in a property slot that the
    writer names (a texture as `reflectance`): the port writes it with
    `name=`, the reference with `id=` (R23)."""
    for k, v in obj.items():
        if isinstance(v, dict):
            tag = TW._tag_for(k, v)
            if (tag in _NAMED and k not in (tag, "bsdf", "emitter")) \
                    or _nests(v):
                return True
    return False


def _plain(x):
    """A scene dict as its XML reads back: an `rgb` object as its value, a
    one-matrix `transforms` chain as the (4, 4) matrix, numbers as
    float32 arrays, an empty type as none."""
    if isinstance(x, dict):
        if x.get("type") == "rgb" and set(x) == {"type", "value"}:
            return _plain(x["value"])
        if set(x) == {"transforms"} and len(x["transforms"]) == 1 \
                and set(x["transforms"][0]) == {"matrix"}:
            return _plain(np.reshape(x["transforms"][0]["matrix"], (4, 4)))
        # an object written without a type reads back with type ""
        return {k: _plain(v) for k, v in x.items()
                if not (k == "type" and v == "")}
    if isinstance(x, (str, bool)):
        return x
    return np.asarray(x, np.float32)


def _same(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def test_dict_to_xml_matches_reference(tmp_path):
    """The same text from both writers for tests/test_xml_writer.py's
    scene dict and every scene of the loader tests that nests no named
    object (or the same exception, where XML cannot carry a property: an
    inline bitmap, a spectrum dict), and the same dict from both readers
    of that text. A scene that nests one (a texture in a BSDF's slot) is
    written with `name=`, where the reference writes `id=` and its reader
    loses the texture (R23): the port's reader gives the dict back."""
    p = L.assets(tmp_path)
    scenes = [_scene_dict(), L.headline(), L.render_scene(p),
              *L.table_scenes(p).values()]
    carried = nested = 0
    for d in scenes:
        text = _outcome(TW.dict_to_xml, d)
        if not isinstance(text, str):
            assert text == _outcome(JW.dict_to_xml, d)
            continue
        back = _outcome(TX.xml_to_dict, text)
        if not any(isinstance(v, dict) and _nests(v) for v in d.values()):
            assert text == _outcome(JW.dict_to_xml, d)
            assert back == _outcome(JX.xml_to_dict, text)
        elif isinstance(back, dict):
            assert _same(_plain(back), _plain(d))
            nested += 1
        else:
            assert back == _outcome(JX.xml_to_dict, text)
        carried += isinstance(back, dict)
    assert carried >= 10 and nested >= 3, (carried, nested)


def test_load_file_equals_load_dict(tmp_path):
    """`tt.load_file` of the render scene written by the port's
    `write_xml`, and of its JSON (matrices as lists), holds the tables
    of `tt.load_dict` of the dict bitwise, in RGB and spectral mode; a
    polarized variant renders Stokes vectors through either (the
    reference's `load_file` drops the polarization, R21). The cube's
    checkerboard comes back: the port's writer names a nested texture by
    its slot (the reference's gives it an id, which its reader drops,
    R23)."""
    p = L.assets(tmp_path)
    d = L.render_scene(p)
    xml = str(tmp_path / "scene.xml")
    TW.write_xml(xml, d)
    js = str(tmp_path / "scene.json")
    with open(js, "w") as f:
        json.dump(d, f, default=lambda a: np.asarray(a).tolist())
    for mode in ("rgb", "spectral"):
        want = tt.load_dict(d, mode=mode, device="cpu")
        for path in (xml, js):
            got = tt.load_file(path, mode=mode, device="cpu")
            out = []
            L.compare(got._scene_static, want._scene_static, "scene", out,
                      0.0, 0.0)
            L.compare(got.sensor, want.sensor, "sensor", out, 0.0, 0.0)
            L.compare(got.env_params, want.env_params, "emitter", out, 0.0,
                      0.0)
            assert got.film == want.film and got.spp == want.spp
    for path in (xml, js):
        assert tt.load_file(path, mode="cuda_ad_rgb_polarized",
                            device="cpu").integrator == "stokes"
    assert tt.load_dict(d, mode="llvm_ad_spectral_polarized",
                        device="cpu").integrator == "stokes"
