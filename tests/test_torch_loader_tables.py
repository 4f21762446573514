"""The port's `load_dict` against the JAX package's on the CPU, with no
JAX compile: the scene tables, sensor, film and emitter of one scene dict
per group of plugin types the port renders, field by field against
`convert.scene`/`convert.sensor` of the reference's bundle; the same
exception types from the same bad dicts; the port's refusals (R8, R13,
R15, R16, R18, R19) through the loader; and `SceneBundle.render`'s
dispatch, the arguments it passes to each renderer recorded beside the
reference's.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import jax
import numpy as np
import pytest
import torch

import torch_loader_case as L
from tpusky.render import aov as JA
from tpusky.render import integrator as JI
from tpusky.render import polarized as JP
from tpusky.render import ptracer as JPT
from tpusky_torch.render import aov as TA
from tpusky_torch.render import integrator as TI
from tpusky_torch.render import polarized as TP
from tpusky_torch.render import ptracer as TPT

torch.set_num_threads(1)

# R7: the reference's float32 Julian date moves the sun by up to 0.0195
# deg (3.4e-4 rad); the port's float64 astronomy does not
SUN_R7 = 4e-4


def test_tables_match_reference(tmp_path):
    """Every scene of `table_scenes` in RGB and spectral mode: each tensor
    of the port's scene (shapes, materials with their textures and
    measured datasets, meshes, SDF, curves, media, lights), its sensor
    and its emitter's parameters within 1e-5 relative (1e-6 absolute)
    of the reference's, its film and configuration equal. Bitwise but
    for the envmap's warp tables (built on the tensors), a cylinder's
    area and, in spectral mode, the texel fits (float64 torch, not
    numpy); the hour scene's sun within R7's bound."""
    p = L.assets(tmp_path)
    loose = set()
    for mode in ("rgb", "spectral"):
        for name, d in L.table_scenes(p).items():
            out = L.compare_bundles(
                L.port_bundle(d, mode), L.jax_bundle(d, mode), rtol=1e-5,
                atol=1e-6,
                params_tol=(1e-6, SUN_R7) if name == "hour" else None)
            loose |= {(name, path) for path, _, bit in out if not bit}
    allowed = {"scene.shapes.area", "emitter.sun_direction",
               "scene.textures.atlas_coeff", "scene.textures.color0_spec",
               "scene.textures.color1_spec"}
    assert all(path in allowed or path.startswith("emitter.warp")
               for _, path in loose), sorted(loose)


def test_bad_dicts_and_refusals(tmp_path):
    """The same exception type from both loaders for each of BAD_SCENES
    (unknown plugin, sunsky range, blender, ...); then what the port
    refuses, refused through the loader with NotImplementedError naming
    it: R8 at load, R13, R15, R16, R18 and R19 at render, and a float64
    or mono variant at render. (R14 cannot arise: the loader gives a
    medium one channel in spectral mode, as the reference's does.)"""
    for name, d in L.BAD_SCENES.items():
        with pytest.raises(Exception) as ref:
            L.jax_bundle(d)
        with pytest.raises(ref.type):
            L.port_bundle(d)
    base = L.headline()
    fog = {"type": "sphere", "interior": {"type": "homogeneous"}}
    lamp = {"type": "point", "position": [0, 0, 3]}
    strand = {"type": "linearcurve", "points": [[0, 0, 0], [0, 0, 1]]}
    checker = {"type": "diffuse", "reflectance": {"type": "checkerboard"}}
    with pytest.raises(NotImplementedError, match="R8"):
        L.port_bundle(dict(base, box={"type": "cube", "emitter": {
            "type": "area", "radiance": 1.0}}))
    cases = {
        "R13": dict(base, fog=fog, lamp=lamp),
        "R15": dict(base, integrator={"type": "ptracer"},
                    ground=dict(base["ground"], bsdf=checker)),
        "R16": dict(base, integrator={"type": "stokes", "i": {
            "type": "path"}}, sun={"type": "directional"}),
        "R18": dict(base, integrator={"type": "stokes", "i": {
            "type": "path"}}, veil={"type": "disk", "bsdf": {
                "type": "mask", "opacity": 0.5}}),
        "R19": dict(base, integrator={"type": "ptracer"}, hair=strand),
    }
    for tag, d in cases.items():
        with pytest.raises(NotImplementedError, match=tag):
            L.port_bundle(d).render(seed=0, spp=1)
    for variant in ("cuda_ad_rgb_double", "scalar_mono"):
        bundle = L.port_bundle(base, variant)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            bundle.render(seed=0)


def _recorders(monkeypatch, mods):
    """Patch each renderer of `mods` (name -> (module, attribute)) with
    one that records its arguments -> the list of records."""
    calls = []
    for name, (mod, attr) in mods.items():
        def rec(*args, _name=name, **kw):
            calls.append((_name, args, kw))
            return {"depth": None} if _name == "aov" else None
        monkeypatch.setattr(mod, attr, rec)
    return calls


def _plain(v):
    """A recorded argument as something to compare: a key as its words,
    a film or sensor as its fields, a scene not at all."""
    if hasattr(v, "dtype") and "key" in str(v.dtype):
        return tuple(np.asarray(jax.random.key_data(v)).tolist())
    if isinstance(v, np.ndarray) and v.dtype == np.uint32:
        return tuple(v.tolist())
    if hasattr(v, "dtype") and v.dtype == np.uint32:     # a raw JAX key
        return tuple(np.asarray(v).tolist())
    if type(v).__name__ == "Film":
        return tuple(v)
    if type(v).__name__ == "Scene" or hasattr(v, "to_world"):
        return type(v).__name__
    return v


def test_render_dispatch_matches_reference(monkeypatch):
    """`SceneBundle.render` of the aov, depth, moment, ptracer, stokes and
    path bundles calls the same renderer with the same arguments as the
    reference's (the scene and sensor by type, the key as its words),
    under a constant environment so that neither side precomputes; the
    key is `jax.random.key_data(PRNGKey(seed))`. The port also gives the
    aov's child that key (the reference none, R2)."""
    from tpusky_torch.render.loader import prng_key
    for seed in (0, 1, 7, 12345, 2 ** 31 - 1):
        np.testing.assert_array_equal(
            prng_key(seed),
            np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))))
    ref = _recorders(monkeypatch, {
        "aov": (JA, "render_aovs"), "moment": (JI, "render_moments"),
        "ptracer": (JPT, "render_ptracer"), "stokes": (JP, "render_stokes"),
        "render": (JI, "render")})
    port = _recorders(monkeypatch, {
        "aov": (TA, "render_aovs"), "moment": (TI, "render_moments"),
        "ptracer": (TPT, "render_ptracer"), "stokes": (TP, "render_stokes"),
        "render": (TI, "render")})
    base = dict(L.headline(), emitter={"type": "constant", "radiance": 0.5})
    child = {"type": "path", "max_depth": 3}
    for integ in ({"type": "aov", "aovs": "dd:depth", "c": child},
                  {"type": "depth"}, {"type": "moment", "max_depth": 4},
                  {"type": "ptracer", "max_depth": 3},
                  {"type": "stokes", "i": {"type": "path", "max_depth": 5,
                                           "rr_depth": 2}},
                  {"type": "prb_basic"}, {"type": "direct"}):
        d = dict(base, integrator=integ)
        for seed, spp in ((0, None), (5, 3)):
            L.jax_bundle(d).render(seed=seed, spp=spp)
            L.port_bundle(d).render(seed=seed, spp=spp)
    assert len(ref) == len(port) == 14
    for i, ((nr, ar, kr), (nt, at, kt)) in enumerate(zip(ref, port)):
        assert nr == nt
        assert [_plain(a) for a in ar] == [_plain(a) for a in at], nr
        if nt == "aov":
            # the port's child renders at the bundle's key; the
            # reference's at PRNGKey(0) whatever the seed (R2)
            assert _plain(kt.pop("child_seed")) == \
                tuple(prng_key((0, 5)[i % 2]).tolist())
        assert {k: _plain(v) for k, v in kr.items()} == \
            {k: _plain(v) for k, v in kt.items()}, nr
