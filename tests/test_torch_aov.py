"""The port's AOV integrator (`tpusky_torch/render/aov.py`) against the
JAX package's `render_aovs` on the CPU, on the textured scene of
tests/test_torch_texture_render.py (analytic shapes and two meshes) with
an untextured disk and cube, at 24x32.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import jax
import numpy as np
import pytest
import torch

from tpusky.render.aov import render_aovs as jax_render_aovs
from tpusky.render.scene import make_scene

from test_torch_texture_render import _camera, _scene_args, _state
from tpusky_torch import convert
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.render import texture as TT
from tpusky_torch.render.aov import REFERENCE_CHILD_KEY, render_aovs

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

H, W = 24, 32
CHILD = dict(spp=2, max_depth=2)
SPEC = ("dd.y:depth,nn:sh_normal,uvs:uv,pi:prim_index,si:shape_index,"
        "gn:geo_normal,pos:position,alb:albedo")


@pytest.fixture(scope="module")
def case():
    """(JAX scene, the port's scene and sensor, JAX's AOVs with the spec
    string and its path child at PRNGKey(0)), the scene with an
    untextured disk and cube added."""
    args = _scene_args(np.random.default_rng(21))
    # untextured shapes beside the textured ones: a disk and a cube
    disk = np.diag([0.5, 0.5, 1.0, 1.0]).astype(np.float32)
    disk[:3, 3] = [1.5, -1.8, 0.01]
    cube = np.diag([0.3, 0.3, 0.3, 1.0]).astype(np.float32)
    cube[:3, 3] = [-0.4, -1.6, 0.3]
    args["shapes"] += [dict(kind=2, to_world=disk, bsdf_idx=5),
                       dict(kind=3, to_world=cube, bsdf_idx=6)]
    sc = make_scene(**args, env=_state("rgb"))
    # op by op, as the reference's own tests run it (jit fuses the
    # sphere's quadratic and moves a grazing normal by 4e-5)
    out = jax_render_aovs(sc, _camera(), H, W, aovs=SPEC, child="path",
                          child_kwargs=CHILD)
    sc_t = convert.scene(jax.tree.map(np.asarray, sc), device="cpu")
    se_t = convert.sensor(jax.tree.map(np.asarray, _camera()), device="cpu")
    return sc, sc_t, se_t, {k: np.asarray(v) for k, v in out.items()}


def _within(a, b, bar):
    return np.abs(a - b).max() <= bar * max(np.abs(b).max(), 1.0)


def test_aovs_match_jax(case):
    """Every channel through the reference's `aovs` spec string (names,
    types and the child's name as the reference maps them): depth,
    position, normals and uv within 1e-5 of their scale, shape and
    primitive indices equal, albedo equal on the lanes without a texture;
    without a spec the port returns every channel, the same ones."""
    sc, sc_t, se_t, ref = case
    out = {k: v.numpy() for k, v in render_aovs(
        sc_t, se_t, H, W, aovs=SPEC, child="path",
        child_kwargs=CHILD).items()}
    assert set(out) == set(ref) == {"dd.y", "nn", "uvs", "pi", "si", "gn",
                                    "pos", "alb", "path"}
    for name in ("dd.y", "nn", "uvs", "gn", "pos"):
        assert out[name].shape == ref[name].shape
        assert _within(out[name], ref[name], 1e-5), name
    assert (out["pi"] == ref["pi"]).all() and (out["si"] == ref["si"]).all()
    assert (out["si"] == -2).mean() > 0.05 and (out["pi"] >= 0).any()
    assert ((out["si"] >= 0) & (out["si"] != 1)).any()
    mat = np.where(ref["si"] == -2, -1, np.asarray(sc.shapes.bsdf_idx)[
        np.maximum(ref["si"], 0)])
    plain = (mat >= 0) & (np.asarray(sc.bsdfs.tex_idx)[mat] < 0)
    assert plain.any() and (out["alb"][plain] == ref["alb"][plain]).all()
    full = render_aovs(sc_t, se_t, H, W)
    assert set(full) == {"depth", "normal", "sh_normal", "geo_normal",
                         "position", "albedo", "shape_idx", "uv",
                         "prim_index"}
    assert all(np.array_equal(full[k].numpy(), out[v]) for k, v in (
        ("depth", "dd.y"), ("prim_index", "pi"), ("albedo", "alb")))


def test_aov_child_seed(case):
    """The nested child: at the default seed (the reference's fixed
    PRNGKey(0)) the port's path child is the reference's image within 1e-3
    of its scale on >= 99.9% of pixels; R2: another seed is honoured, the
    child being the port's own `render` at that key; a "direct" child is
    depth 2 whatever max_depth says, and a callable child is called."""
    _sc, sc_t, se_t, ref = case
    img = render_aovs(sc_t, se_t, H, W, child="path",
                      child_kwargs=CHILD)["path"].numpy()
    scale = max(np.abs(ref["path"]).max(), 1e-3)
    off = (np.abs(img - ref["path"]) > 1e-3 * scale).any(-1)
    assert off.mean() <= 1e-3 and np.isfinite(img).all()
    film = TF.Film(H, W, 3)
    own = TI.render(sc_t, se_t, film, REFERENCE_CHILD_KEY, spp=2,
                    max_depth=2).numpy()
    assert np.array_equal(img, own)
    other = render_aovs(sc_t, se_t, H, W, child="path", child_kwargs=CHILD,
                        child_seed=5)["path"].numpy()
    assert np.array_equal(other, TI.render(sc_t, se_t, film, 5, spp=2,
                                           max_depth=2).numpy())
    assert not np.allclose(other, img)
    direct = render_aovs(sc_t, se_t, H, W, child="direct",
                         child_kwargs=dict(spp=2, max_depth=5))["direct"]
    assert np.array_equal(direct.numpy(), own)

    def flat(scene, sensor, h, w):
        return torch.full((h, w, 3), 0.25)
    assert (render_aovs(sc_t, se_t, H, W, child=flat)["flat"] == 0.25).all()


def test_aov_textured_albedo(case):
    """R11: on a textured lane the albedo channel is the material's
    texture at the hit (`eval_texture` at the hit's uv, point and vertex
    colour), as Mitsuba 3's `aov.cpp` reads `eval_diffuse_reflectance`,
    where the reference reads the untextured column; untextured lanes are
    the reference's (test_aovs_match_jax)."""
    sc, sc_t, se_t, ref = case
    out = render_aovs(sc_t, se_t, H, W)
    si = out["shape_idx"].numpy()
    mat = torch.where(out["shape_idx"] == -2, 0, sc_t.shapes.bsdf_idx[
        out["shape_idx"].clamp(min=0)])
    # the mesh lanes: the icosphere's bitmap or the vertex colours
    tri = out["prim_index"].clamp(min=0)
    mat = torch.where(out["shape_idx"] == -2, sc_t.mesh.bsdf_idx[tri], mat)
    hit = out["depth"] > 0
    tex = sc_t.bsdfs.tex_idx[mat]
    textured = (hit & (tex >= 0)).numpy()
    assert textured.mean() > 0.3
    assert TT.table_texture_kinds(sc_t.textures) == (0, 1, 2, 3)
    attr = None
    if sc_t.mesh.col is not None:
        from tpusky_torch.render.mesh import mesh_intersect, \
            mesh_interp_color
        from tpusky_torch.render.sensors import sample_ray
        y, x = torch.meshgrid(torch.arange(H), torch.arange(W),
                              indexing="ij")
        pix = torch.stack([(x.reshape(-1) + 0.5) / W,
                           (y.reshape(-1) + 0.5) / H], -1)
        _, _, _, b1, b2, tri_m, _ = mesh_intersect(sc_t.mesh,
                                                   *sample_ray(se_t, pix))
        attr = mesh_interp_color(sc_t.mesh, tri_m, b1, b2)
    val, has = TT.eval_texture(sc_t.textures, tex.reshape(-1),
                               out["uv"].reshape(-1, 2),
                               p=out["position"].reshape(-1, 3), attr=attr)
    want = val.reshape(H, W, 3).numpy()
    alb = out["albedo"].numpy()
    assert np.abs(alb[textured] - want[textured]).max() <= 1e-6
    # the reference's column differs there
    assert np.abs(ref["alb"][textured] - alb[textured]).max() > 0.05
    assert (si[~hit.numpy()] == -1).all()
