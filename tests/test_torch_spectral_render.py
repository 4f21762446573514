"""The port's spectral render path against the JAX package: the rough
conductor BSDF, and `bench.py`'s spectral scenes rendered lane by lane.

The `independent` sampler is a counter hash, so both sides draw bitwise
the same uniforms, hero wavelengths included, and a render compares lane
by lane (as in tests/test_torch_render.py). The JAX side runs its jnp
wavefront path; the port runs its plain PyTorch path, which is what it
runs for CPU tensors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky.tables import load_tables as jax_load_tables
from tpusky.ops import spectrum as JSP
from tpusky.render import bsdf as JB
from tpusky.render import film as JF
from tpusky.render import integrator as JI
from tpusky.render import sensors as JS
from tpusky.render.scene import make_scene as jax_make_scene

from tpusky_torch import convert
from tpusky_torch.ops.cuda import build
from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

H = W = 16
SPP = 2
KEY = jax.random.PRNGKey(11)
SEED = int(np.asarray(jax.random.key_data(KEY))[-1])    # == 11
SUN = [0.3, 0.2, 0.93]


# ---------------------------------------------------------------------------
# the rough conductor
# ---------------------------------------------------------------------------


def _materials():
    """Four rows: diffuse, rough conductors of two roughnesses and IORs
    (one two-sided), and a spectral albedo that varies by channel."""
    rng = np.random.default_rng(0)
    kw = dict(kinds=[0, 1, 1, 0],
              albedos=rng.uniform(0.1, 0.9, (4, 3)).astype(np.float32),
              twosided=[False, False, True, True],
              spectral_albedos=rng.uniform(0.1, 0.9, (4, 11)).astype(
                  np.float32),
              alphas=[0.1, 0.2, 0.45, 0.3],
              etas=[[0.2, 0.9, 1.1], [0.143, 0.375, 1.442],
                    [1.5, 1.0, 0.6], [1.0, 1.0, 1.0]],
              ks=[[3.9, 2.4, 1.6], [3.983, 2.386, 1.603], [2.0, 3.0, 4.0],
                  [0.0, 0.0, 0.0]])
    jt = JB.make_material_table(**kw)
    return jt, TB.make_material_table(**kw, device="cpu")


def _bsdf_lanes(n=4096):
    rng = np.random.default_rng(1)
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    # mostly upper hemisphere, some below (two-sided rows flip them)
    wi[:, 2] = np.where(rng.random(n) < 0.8, np.abs(wi[:, 2]), wi[:, 2])
    wo[:, 2] = np.where(rng.random(n) < 0.8, np.abs(wo[:, 2]), wo[:, 2])
    mat = rng.integers(0, 4, n).astype(np.int32)
    u2 = rng.random((n, 2), dtype=np.float32)
    u1 = rng.random(n, dtype=np.float32)
    wl = rng.uniform(300.0, 760.0, (n, 4)).astype(np.float32)
    return wi, wo, mat, u2, u1, wl


def _close(a, b, name, rtol=1e-4, atol=1e-6):
    """Within rtol of each entry plus atol of the array's scale."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, name
    tol = rtol * np.abs(b) + atol * max(np.abs(b).max(), 1.0)
    assert (np.abs(a - b) <= tol).all(), (name, np.abs(a - b).max())


@pytest.mark.parametrize("spectral", [False, True], ids=["rgb", "spectral"])
@pytest.mark.parametrize("kinds", [((1,), False), ((0, 1), False)],
                         ids=["rough", "diffuse+rough"])
def test_bsdf_eval_pdf_and_sample_match_jax(kinds, spectral):
    """eval_pdf and sample of the diffuse and rough-conductor lobes, RGB
    and at hero wavelengths, against tpusky.render.bsdf within 1e-4."""
    jt, tt_ = _materials()
    wi, wo, mat, u2, u1, wl = _bsdf_lanes()
    if kinds[0] == (1,):
        mat = np.where(np.isin(mat, [1, 2]), mat, 1).astype(np.int32)
    wl_j = wl if spectral else None
    wl_t = torch.tensor(wl) if spectral else None

    val_j, pdf_j = jax.jit(lambda *a: JB.eval_pdf(*a, kinds=kinds))(
        jt, mat, wi, wo, wl_j)
    val_t, pdf_t = TB.eval_pdf(tt_, torch.tensor(mat, dtype=torch.long),
                               torch.tensor(wi), torch.tensor(wo), wl_t,
                               kinds=kinds)
    _close(val_t, val_j, "value")
    _close(pdf_t, pdf_j, "pdf")
    assert (np.asarray(pdf_j) > 0).mean() > 0.3

    wo_j, w_j, p_j, delta_j = jax.jit(lambda *a: JB.sample(*a, kinds=kinds))(
        jt, mat, wi, u2, u1, wl_j)
    wo_t, w_t, p_t, delta_t = TB.sample(
        tt_, torch.tensor(mat, dtype=torch.long), torch.tensor(wi),
        torch.tensor(u2), torch.tensor(u1), wl_t, kinds=kinds)
    _close(wo_t, wo_j, "wo", atol=1e-5)
    _close(w_t, w_j, "weight")
    _close(p_t, p_j, "pdf")
    np.testing.assert_array_equal(delta_t.numpy(), np.asarray(delta_j))
    # a sampled direction's eval/pdf gives back its weight
    ok = p_t > 1e-3
    v2, p2 = TB.eval_pdf(tt_, torch.tensor(mat, dtype=torch.long),
                         torch.tensor(wi), wo_t, wl_t, kinds=kinds)
    good = ok & (w_t.abs().sum(-1) > 0)
    _close((v2 / p2[..., None])[good], w_t[good], "weight = f cos / pdf",
           rtol=1e-3)


def test_material_table_kinds_and_defaults():
    """Kinds other than diffuse and rough conductor are refused; the
    defaults are the reference package's."""
    with pytest.raises(NotImplementedError):
        TB.make_material_table(kinds=[2], device="cpu")
    jt = JB.make_material_table(kinds=[1, 0],
                                albedos=[[0.2, 0.4, 0.6], [0.5, 0.5, 0.5]])
    tt_ = TB.make_material_table(kinds=[1, 0],
                                 albedos=[[0.2, 0.4, 0.6], [0.5, 0.5, 0.5]],
                                 device="cpu")
    conv = convert.material_table(jax.tree.map(np.asarray, jt),
                                  device="cpu")
    for f in TB.MaterialTable._fields:
        assert torch.equal(getattr(tt_, f), getattr(conv, f)), f
    assert TB.table_kinds(tt_) == ((0, 1), False)
    with pytest.raises(NotImplementedError):
        TB.eval_pdf(tt_, torch.zeros(4, dtype=torch.long), torch.ones(4, 3),
                    torch.ones(4, 3), kinds=((0, 2), False))


# ---------------------------------------------------------------------------
# bench.py's spectral scenes
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _spectral_state():
    """The spectral sunsky both scenes share (compiled once a module)."""
    return jax.jit(lambda p: JM.precompute(jax_load_tables("spectral"), p,
                                           "spectral"))(
        ts.make_params(turbidity=3.0, albedo=0.3, sun_direction=SUN,
                       mode="spectral"))


@functools.lru_cache(maxsize=None)
def _rgb_state():
    """An RGB sunsky state, for the mismatched-state refusals."""
    return convert.sunsky_state(jax.tree.map(np.asarray, jax.jit(
        lambda p: JM.precompute(jax_load_tables("rgb"), p, "rgb"))(
            ts.make_params(sun_direction=SUN))), device="cpu")


def _spectral_scene(kind):
    """bench.py::bench_spectral's scene (kind 1: a rough-conductor ground,
    alpha 0.2) or bench_spectral_grad's (kind 0: a diffuse ground), under
    the spectral sunsky; camera at [4,-4,2] looking at [0,0,0.5]."""
    state = _spectral_state()
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    kw = dict(bsdf_kinds=[1], bsdf_alphas=[0.2]) if kind == 1 else {}
    sc = jax_make_scene(shapes=[dict(kind=1, to_world=ground, bsdf_idx=0)],
                        bsdf_albedos=[[0.5, 0.5, 0.5]], env=state, **kw)
    sensor = JS.make_perspective([4, -4, 2.0], [0, 0, 0.5], fov_x_deg=45)
    return sc, sensor


def _jax_lanes(sc, sensor, key, depth):
    """Per-lane sRGB radiance of JAX's spectral render_rows before the
    splat: the body of `integrator._render_rows_chunk`
    (integrator.py:804-826, 862-881)."""
    n = H * W * SPP
    lane = jnp.arange(n, dtype=jnp.uint32)
    pixel = lane // SPP
    smp = JI._SamplerCtx("independent", key, pixel, lane % SPP, SPP)
    u = smp.next(10_000, 2)
    uv = jnp.stack([((pixel % W).astype(jnp.float32) + u[:, 0]) / W,
                    ((pixel // W).astype(jnp.float32) + u[:, 1]) / H], -1)
    o, d = JS.sample_ray(sensor, uv)
    u_wl = smp.next(20_000, 1)[..., 0]
    wl, wl_w = JSP.sample_rgb_spectrum(JSP.sample_shifted(u_wl, 4))
    r = JI._path_sample(sc, o, d, smp, depth, 1000, "spectral", wl,
                        kinds=JB.table_kinds(sc.bsdfs))
    r = JSP.spectrum_to_srgb(r * wl_w, wl)
    return jnp.where(jnp.isfinite(r), r, 0.0)


_CASES = {"bench_spectral": (1, 4), "bench_spectral_grad": (0, 2)}


@pytest.fixture(scope="module", params=sorted(_CASES))
def renders(request):
    """(case, JAX lanes and image, port lanes and image, port scene and
    sensor)."""
    kind, depth = _CASES[request.param]
    sc, sensor = _spectral_scene(kind)
    film = JF.Film(H, W, 3)

    @jax.jit
    def run(sc, sensor, key):
        # render_rows' own splat of these lanes (one spp chunk): one trace
        # of the depth-4 path instead of two keeps the file's compile short
        lanes = _jax_lanes(sc, sensor, key, depth)
        return lanes, JF.develop(JF.splat_ordered(film, lanes, SPP))
    lanes_j, img_j = (np.asarray(x) for x in run(sc, sensor, KEY))
    sc_t = convert.scene(jax.tree.map(np.asarray, sc), device="cpu")
    sensor_t = convert.perspective(jax.tree.map(np.asarray, sensor),
                                   device="cpu")
    tfilm = TF.Film(H, W, 3)
    lanes = TI._lane_radiance(sc_t, sensor_t, tfilm, SEED, SPP, 0, SPP,
                              depth, 1000, "spectral", 0, H,
                              kinds=TB.table_kinds(sc_t.bsdfs)).numpy()
    img = TI.render(sc_t, sensor_t, tfilm, SEED, spp=SPP, max_depth=depth,
                    mode="spectral").numpy()
    return (request.param, depth, (lanes_j, img_j), (lanes, img),
            (sc_t, sensor_t))


def _lane_rel(a, b):
    return (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max(-1)


def test_spectral_render_matches_jax(renders):
    """Same seed, same estimator, same hero wavelengths: per lane before
    the splat >= 99.9% of lanes within 1e-3 relative (floor 1e-3), and
    per developed image within 1e-3 of its scale (the bars of
    tests/test_torch_render.py:211-221); the image is the box splat of
    JAX's lanes, which is what its render_rows develops."""
    _, _, (lanes_j, img_j), (lanes, img), _ = renders
    assert lanes.shape == lanes_j.shape == (H * W * SPP, 3)
    assert (_lane_rel(lanes, lanes_j) > 1e-3).mean() <= 1e-3
    assert np.abs(img - img_j).max() < 1e-3 * max(img_j.max(), 1.0)
    assert img_j.max() > 0.05 and (img_j > 0).mean() > 0.5


def test_spectral_render_on_cpu_is_plain(renders):
    """On the CPU `render(mode="spectral")` takes the wavefront path with
    the plain versions: it equals `render_rows(plain=True)` and launches
    nothing."""
    _, depth, _, (_, img), (sc, sensor) = renders
    film = TF.Film(H, W, 3)
    build.reset_launches()
    kinds = TB.table_kinds(sc.bsdfs)
    assert not TI._megakernel_ok(sc, sensor, film, SPP, depth, "spectral",
                                 "independent", kinds)
    plain = TF.develop(TI.render_rows(sc, sensor, film, SEED, SPP, depth,
                                      1000, "spectral", 0, H, kinds=kinds,
                                      plain=True))
    np.testing.assert_array_equal(plain.numpy(), img)
    assert all(v == 0 for v in build.launches.values())


def test_spectral_render_refuses_a_mismatched_state(renders):
    """A spectral render needs a spectral sunsky state, and an RGB render
    an RGB one."""
    _, _, _, _, (sc, sensor) = renders
    film = TF.Film(4, 4, 3)
    with pytest.raises(ValueError, match="precomputed in rgb"):
        TI.render(sc, sensor, film, SEED, spp=1, mode="rgb")
    rgb = _rgb_state()
    with pytest.raises(ValueError, match="precomputed in spectral"):
        TI.render(sc._replace(env=rgb), sensor, film, SEED, spp=1,
                  mode="spectral")
