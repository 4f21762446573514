"""A textured scene through the port's path tracer and its gradient, lane
by lane against the JAX package at 16x16x2 on the CPU.

The scene holds every texture kind: a bitmap on a uv-mapped icosphere, a
checkerboard with a normal map on a rough-plastic ground, a volume on a
principled sphere, vertex colours read through a mesh attribute, a
clamped bitmap on a blend of two diffuse children (both take the blend
row's texture, as the reference hands them), under the sunsky and a
point light, at depth 3. RGB lanes come from JAX's own
`_render_rows_chunk` with its splat taken out; spectral lanes from its
`_path_sample` at the same rays and hero wavelengths (per wavelength, so
that the sRGB development's cancellations do not magnify an ulp). The
bars are tests/test_torch_render.py's: >= 99.9% of lanes within 1e-3
relative (floor 1e-3).

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky.tables import load_tables as jax_load_tables
from tpusky.ops import spectrum as JSP
from tpusky.render import film as JF
from tpusky.render import integrator as JI
from tpusky.render import sensors as JS
from tpusky.render.bsdf import table_kinds, table_normal_maps
from tpusky.render.scene import make_scene
from tpusky.render.texture import table_texture_kinds

from tpusky_torch import convert
from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.render import scene as TSC
from tpusky_torch.render import texture as TT
from tpusky_torch.utils.meshio import icosphere

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

H = W = 16
SPP = 2
DEPTH = 3
KEY = jax.random.PRNGKey(7)
WORDS = np.asarray(jax.random.key_data(KEY))
SUN = [0.3, 0.2, 0.93]


def _at(scale, xyz):
    m = np.diag(list(scale) + [1.0]).astype(np.float32)
    m[:3, 3] = xyz
    return m


def _scene_args(rng):
    """`make_scene`'s arguments (both packages') for the scene of the
    module docstring, without its environment."""
    pos, idx = icosphere(2)
    uvs = np.stack([np.arctan2(pos[:, 1], pos[:, 0]) / (2 * np.pi) + 0.5,
                    np.arccos(np.clip(pos[:, 2], -1, 1)) / np.pi],
                   -1).astype(np.float32)
    pos2, idx2 = icosphere(1)
    cols = rng.uniform(size=(len(pos2), 3)).astype(np.float32)
    tilt = rng.uniform(-0.2, 0.2, size=(8, 8, 2))
    nmap = np.concatenate([0.5 + tilt, np.full((8, 8, 1), 0.9)],
                          -1).astype(np.float32)
    textures = [
        dict(kind="bitmap", data=rng.uniform(size=(12, 16, 3)).astype(
            np.float32)),
        dict(kind="checkerboard", color0=[0.8, 0.7, 0.6],
             color1=[0.1, 0.2, 0.3], to_uv=np.diag([8.0, 8.0, 1.0])),
        dict(kind="bitmap", data=nmap, wrap="mirror"),
        dict(kind="volume", grid=rng.uniform(size=(4, 4, 4, 3)).astype(
            np.float32), to_world=_at([1.6] * 3, [0.6, -1.0, 0.0])),
        dict(kind="mesh_attribute", scale=0.9),
        dict(kind="bitmap", data=rng.uniform(size=(5, 7, 3)).astype(
            np.float32), wrap="clamp")]
    return dict(
        shapes=[dict(kind=1, to_world=_at([10, 10, 1], [0, 0, 0]),
                     bsdf_idx=1),
                dict(kind=0, to_world=_at([0.6] * 3, [0.6, -1.0, 0.6]),
                     bsdf_idx=2),
                dict(kind=4, to_world=_at([0.4, 0.4, 1.2], [-1.4, 0.8, 0]),
                     bsdf_idx=4)],
        bsdf_albedos=[[0.5] * 3, [0.4] * 3, [0.6, 0.5, 0.4], [0.3] * 3,
                      [0.5] * 3, [0.7, 0.2, 0.2], [0.2, 0.7, 0.2]],
        bsdf_kinds=[0, 8, 9, 0, 10, 0, 0],
        bsdf_alphas=[0.1, 0.3, 0.4, 0.1, 0.1, 0.1, 0.1],
        bsdf_blend_children=[[0, 0]] * 4 + [[5, 6]] + [[0, 0]] * 2,
        bsdf_blend_weights=[0, 0, 0, 0, 0.35, 0, 0],
        bsdf_tex_indices=[0, 1, 3, 4, 5, -1, -1],
        bsdf_normal_tex_indices=[-1, 2, -1, -1, -1, -1, -1],
        textures=textures,
        meshes=[dict(positions=pos, indices=idx, normals=pos.copy(),
                     uvs=uvs, to_world=_at([0.8] * 3, [0.0, 0.5, 0.8]),
                     bsdf_idx=0),
                dict(positions=pos2, indices=idx2, normals=pos2.copy(),
                     colors=cols, to_world=_at([0.5] * 3, [1.3, 0.9, 0.5]),
                     bsdf_idx=3)],
        point_lights=[[1.5, -1.5, 2.5, 6.0, 6.0, 6.0]])


def _textured_scene(env, spectral, rng):
    return make_scene(**_scene_args(rng), spectral_textures=spectral,
                      env=env)


def _camera():
    return JS.make_perspective([4.0, -4.0, 2.2], [0.0, 0.0, 0.6],
                               fov_x_deg=50)


@functools.lru_cache(maxsize=None)
def _state(mode):
    """The sunsky state, jitted (op by op it takes seconds)."""
    tables = jax_load_tables(mode)
    return jax.jit(lambda p: JM.precompute(tables, p, mode))(
        ts.make_params(turbidity=3.0, albedo=0.3, sun_direction=SUN,
                       mode=mode))


def _descriptors(sc):
    return dict(kinds=table_kinds(sc.bsdfs), nmaps=table_normal_maps(sc.bsdfs),
                tkinds=table_texture_kinds(sc.textures))


@contextlib.contextmanager
def _splat_taken_out():
    """JAX's box splat returns the lanes' radiance it was given."""
    saved = JF.splat_ordered
    JF.splat_ordered = lambda film, radiance, spp: radiance
    try:
        yield
    finally:
        JF.splat_ordered = saved


def _to_port(sc):
    return (convert.scene(jax.tree.map(np.asarray, sc), device="cpu"),
            convert.sensor(jax.tree.map(np.asarray, _camera()), device="cpu"))


def share_outside(a, b, bar=1e-3):
    rel = (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max(-1)
    return float((rel > bar).mean())


def _check_render(sc_t, se_t, mode):
    """The port's `render()` of the converted scene: finite, lit, and the
    box-filtered mean of its `_lane_radiance` at the pass's key (the path
    the lanes were held on)."""
    film = TF.Film(H, W, 3)
    img = TI.render(sc_t, se_t, film, WORDS, spp=SPP, max_depth=DEPTH,
                    mode=mode).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.0
    lanes = TI._lane_radiance(sc_t, se_t, film, TI._pass_keys(WORDS, 1)[0],
                              SPP, 0, SPP, DEPTH, 1000, mode, 0, H,
                              kinds=TB.table_kinds(sc_t.bsdfs)).numpy()
    mean = lanes.reshape(H, W, SPP, 3).mean(2)
    assert np.abs(img - mean).max() <= 1e-5 * max(np.abs(mean).max(), 1.0)


def test_textured_render_matches_jax():
    """RGB lanes of the textured scene at depth 3 through `convert.scene`
    and the port's `_lane_radiance` against JAX's: >= 99.9% within 1e-3;
    the textures and the normal map change >= 20% of the lanes (so they
    were read); its `render()` is the mean of its lanes."""
    sc = _textured_scene(_state("rgb"), False, np.random.default_rng(21))
    film = JF.Film(H, W, 3)
    desc = _descriptors(sc)
    assert desc["nmaps"] and desc["tkinds"] == (0, 1, 2, 3)
    with _splat_taken_out():
        lanes_j = np.asarray(jax.jit(
            lambda sc, se, key: JI._render_rows_chunk(
                sc, se, film, key, SPP, 0, SPP, DEPTH, 1000, "rgb", 0, H,
                **desc))(sc, _camera(), KEY))
    sc_t, se_t = _to_port(sc)
    kinds = TB.table_kinds(sc_t.bsdfs)
    lanes_t = TI._lane_radiance(sc_t, se_t, film, WORDS, SPP, 0, SPP, DEPTH,
                                1000, "rgb", 0, H, kinds=kinds).numpy()
    assert share_outside(lanes_t, lanes_j) <= 1e-3
    bare = TI._lane_radiance(sc_t._replace(textures=None), se_t, film, WORDS,
                             SPP, 0, SPP, DEPTH, 1000, "rgb", 0, H,
                             kinds=kinds).numpy()
    assert share_outside(bare, lanes_t, 1e-2) >= 0.2
    _check_render(sc_t, se_t, "rgb")


def test_textured_spectral_render_matches_jax():
    """The same scene in spectral mode (texel spectra fitted when the
    table is built, checker spectra, the attribute's channel mean): the
    port's `_path_sample` against JAX's at the same rays and 4 hero
    wavelengths a lane, per wavelength, >= 99.9% within 1e-3; the
    port's `make_scene` builds the texture table and material columns that
    `convert` carried over (coefficients within 1e-6 of the atlas's
    magnitude); the port's spectral `render()` is the mean of its
    lanes."""
    sc = _textured_scene(_state("spectral"), True, np.random.default_rng(21))
    desc = _descriptors(sc)
    n = H * W * SPP
    lane = np.arange(n, dtype=np.uint32)
    pixel, sample = lane // SPP, lane % SPP

    @jax.jit
    def run(sc, sensor, key):
        smp = JI._SamplerCtx("independent", key, jnp.asarray(pixel),
                             jnp.asarray(sample), SPP)
        u = smp.next(10_000, 2)
        uv = jnp.stack([((pixel % W).astype(np.float32) + u[:, 0]) / W,
                        ((pixel // W).astype(np.float32) + u[:, 1]) / H], -1)
        o, d = JS.sample_ray(sensor, uv)
        wl, _ = JSP.sample_rgb_spectrum(JSP.sample_shifted(
            smp.next(20_000, 1)[..., 0], 4))
        return o, d, wl, JI._path_sample(sc, o, d, smp, DEPTH, 1000,
                                         "spectral", wl, **desc)
    o, d, wl, lanes_j = (np.asarray(x) for x in run(sc, _camera(), KEY))
    sc_t, se_t = _to_port(sc)
    smp = TI._SamplerCtx("independent", WORDS,
                         torch.tensor(pixel.astype(np.int64)),
                         torch.tensor(sample.astype(np.int64)), SPP)
    lanes_t = TI._path_sample(sc_t, torch.tensor(o), torch.tensor(d), smp,
                              DEPTH, 1000, "spectral",
                              TB.table_kinds(sc_t.bsdfs),
                              wavelengths=torch.tensor(wl)).numpy()
    assert share_outside(lanes_t, lanes_j) <= 1e-3
    # the port's own make_scene builds the tables convert carried over
    own = TSC.make_scene(**_scene_args(np.random.default_rng(21)),
                         spectral_textures=True, device="cpu")
    for f in TT.TextureTable._fields[:-1]:
        a, b = getattr(own.textures, f), getattr(sc_t.textures, f)
        assert (a - b).abs().max() <= 1e-6 * b.abs().max().clamp(min=1.0), f
    assert torch.equal(own.bsdfs.tex_idx, sc_t.bsdfs.tex_idx)
    assert torch.equal(own.bsdfs.normal_tex_idx, sc_t.bsdfs.normal_tex_idx)
    assert own.bsdfs.host_normal_maps and sc_t.bsdfs.host_normal_maps
    _check_render(sc_t, se_t, "spectral")


def test_textured_gradient_matches_jax():
    """d mean(img^2) / d (the atlas, the checker's two colours) through
    render_rows at depth 3 against jax.grad (the textured scene's ground,
    with its checkerboard and normal map, and bitmapped icosphere, all
    diffuse): within
    1e-3 of each gradient's largest entry. R12: the reference's atlas
    gradient is NaN on texels of the normal map (through it the map
    reaches the continuation ray, and o + inf * d at a mesh miss makes
    0 * inf); the port's is finite, the map's influence on the ray
    stopped as the sample's, and is held where the reference's is
    finite. Then `_megakernel_rules` refuses a textured scene that it
    would take untextured, so its gradient flows through `render_rows`,
    not K4's replay."""
    args = _scene_args(np.random.default_rng(21))
    # diffuse lobes and one mesh keep JAX's compile of the gradient short
    args.update(shapes=args["shapes"][:1], meshes=args["meshes"][:1],
                bsdf_kinds=None, bsdf_alphas=None, bsdf_blend_children=None,
                bsdf_blend_weights=None)
    sc_j = make_scene(**args, env=_state("rgb"))
    desc = _descriptors(sc_j)
    film = JF.Film(H, W, 3)
    fields = ("atlas", "color0", "color1")

    @jax.jit
    def grad_j(atlas, c0, c1):
        def loss(atlas, c0, c1):
            sc = sc_j._replace(textures=sc_j.textures._replace(
                atlas=atlas, color0=c0, color1=c1))
            img = JF.develop(JI.render_rows(sc, _camera(), film, KEY, SPP,
                                            DEPTH, 1000, "rgb", 0, H,
                                            **desc))
            return jnp.mean(img ** 2)
        return jax.grad(loss, argnums=(0, 1, 2))(atlas, c0, c1)
    g_j = [np.asarray(g) for g in grad_j(
        *(getattr(sc_j.textures, f) for f in fields))]
    sc_t, se_t = _to_port(sc_j)
    leaves = [getattr(sc_t.textures, f).clone().requires_grad_()
              for f in fields]
    sc = sc_t._replace(textures=sc_t.textures._replace(
        **dict(zip(fields, leaves))))
    img = TF.develop(TI.render_rows(sc, se_t, TF.Film(H, W, 3), WORDS, SPP,
                                    DEPTH, 1000, "rgb", 0, H))
    g_t = [g.numpy() for g in torch.autograd.grad((img ** 2).mean(), leaves)]
    # the normal map's texels in the atlas (texture 2)
    off = int(sc_t.textures.offset[2])
    nmap = np.zeros(g_j[0].shape[0], bool)
    nmap[off:off + int(sc_t.textures.width[2] * sc_t.textures.height[2])] = 1
    bad = np.isnan(g_j[0]).any(-1)
    assert bad.any() and not (bad & ~nmap).any()
    for name, a, b in zip(fields, g_t, g_j):
        ok = ~np.isnan(b)
        scale = np.abs(b[ok]).max()
        assert np.isfinite(a).all() and ok.any() and scale > 0, name
        assert np.abs(a - b)[ok].max() <= 1e-3 * scale, name

    sc_d = TSC.make_scene(
        shapes=[dict(kind=1, to_world=_at([10, 10, 1], [0, 0, 0]))],
        bsdf_tex_indices=[0], textures=[dict(kind="checkerboard")],
        env=sc_t.env, device="cpu")
    args = (se_t, TF.Film(H, W, 3), 4, 2, "rgb", "independent",
            TB.table_kinds(sc_d.bsdfs), 1000)
    assert TI._megakernel_rules(sc_d._replace(textures=None), *args)
    assert not TI._megakernel_rules(sc_d, *args)
