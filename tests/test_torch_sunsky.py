"""The port's sunsky model (`tpusky_torch`) against the JAX package.

Both run on the CPU from the same numpy-seeded inputs: the JAX side runs
its jnp path; the port runs its plain PyTorch versions, which the kernel
wrappers take for CPU tensors. Eval is tested apart from precompute by
feeding the port the very state JAX computed (`tpusky_torch.convert`).
"""

import inspect

import jax
import numpy as np
import pytest
import torch

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky import tables as JT
from tpusky.models.sunsky.astronomy import (DateTimeRecord, LocationRecord,
                                            sun_direction)
from tpusky.ops.pallas import sunsky_kernel as JK

import tpusky_torch as tt
from tpusky_torch import convert
from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.models.sunsky import tables as TT
from tpusky_torch.ops.cuda import build
from tpusky_torch.ops.cuda import sunsky_kernel as TK
from tpusky_torch.render import bsdf as TB

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

SUN = [0.3, 0.2, 0.93]
N = 4096

_STATE_FIELDS = ("sun_angles", "sun_frame_s", "sun_frame_t", "sun_frame_n",
                 "sky_params", "sky_radiance", "sun_radiance", "gaussians",
                 "sky_sampling_w")


@pytest.fixture(scope="module")
def jax_precompute():
    tables = JT.load_tables("rgb")
    return jax.jit(lambda p: JM.precompute(tables, p, "rgb"))


@pytest.fixture(scope="module")
def states(jax_precompute):
    """(JAX state, the same state converted to the port) at T = 3.8."""
    js = jax_precompute(ts.make_params(turbidity=3.8, albedo=0.3,
                                       sun_direction=SUN))
    return js, convert.sunsky_state(jax.tree.map(np.asarray, js),
                                    device="cpu")


@pytest.fixture(scope="module")
def directions(states):
    """4096 unit directions: 3840 isotropic, 256 in and around the sun disc
    (where the radiance jumps by ~1e5)."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    sun = np.asarray(states[0].sun_frame_n, np.float32)
    d[-256:] = sun + rng.normal(scale=5e-3, size=(256, 3))
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _rel(a, b, floor):
    return np.abs(np.asarray(a) - np.asarray(b)) / (np.abs(np.asarray(b))
                                                   + floor)


def test_load_tables_bitwise():
    j = JT.load_tables("rgb")
    t = TT.load_tables("rgb", device="cpu")
    for f in ("sky_params", "sky_rad", "sun_rad", "tgmm"):
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    assert t.sun_ld is None and j.sun_ld is None


@pytest.mark.parametrize("sun", [SUN, [0.8, -0.3, 0.2]])
@pytest.mark.parametrize("turbidity", [1.0, 3.0, 3.8, 7.0, 10.0])
def test_precompute_matches_jax(jax_precompute, turbidity, sun):
    """Every state array within 1e-5 of JAX's, relative to the array's
    largest magnitude (entries near zero come from cancelling lerps, so
    an entry-wise ratio would measure f32 round-off). Integer turbidity
    exercises the lerp kink."""
    js = jax.tree.map(np.asarray, jax_precompute(ts.make_params(
        turbidity=turbidity, albedo=0.3, sun_direction=sun)))
    st = TM.precompute(TT.load_tables("rgb", device="cpu"), TM.make_params(
        turbidity=turbidity, albedo=0.3, sun_direction=sun, device="cpu"))
    for f in _STATE_FIELDS:
        a, b = getattr(st, f).numpy(), getattr(js, f)
        assert a.shape == b.shape, f
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), f
    for f in ("pmf", "cdf", "total"):
        a = getattr(st.gaussian_distr, f).numpy()
        b = getattr(js.gaussian_distr, f)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max(), f


def test_kernel_table_packing_matches_jax(states):
    js, st = states
    np.testing.assert_allclose(TK._misc_row(st).numpy(),
                               np.asarray(JK._misc_row(js))[0],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(TK._gauss_rows(st).numpy(),
                               np.asarray(JK._gauss_rows(js)),
                               rtol=1e-6, atol=1e-7)


def test_eval_and_eval_pdf_match_jax(states, directions):
    js, st = states
    d = torch.tensor(directions)
    rad_j = np.asarray(jax.jit(JM._eval_rgb_jnp)(js, directions))
    pdf_j = np.asarray(jax.jit(JM.pdf_direction)(js, directions))
    rad = TM.eval(st, d)
    rad_h, pdf_h = TM.eval_pdf(st, d)
    assert _rel(rad, rad_j, 1e-3).max() <= 1e-4
    assert _rel(rad_h, rad_j, 1e-3).max() <= 1e-4
    assert _rel(pdf_h, pdf_j, 1e-3).max() <= 1e-3
    assert (rad_j[-256:] > 1e3).any()        # the disc lanes hit the sun


def test_sample_direction_matches_jax(states):
    """Directions agree to 1e-5 except where a discrete pick (TGMM
    component or sky/sun strategy) flips on a one-ulp difference."""
    js, st = states
    u2 = np.random.default_rng(1).random((N, 2), dtype=np.float32)
    d_j, pdf_j = (np.asarray(x) for x in
                  jax.jit(JM.sample_direction)(js, u2))
    d, pdf = TM.sample_direction(st, torch.tensor(u2))
    far = np.abs(d.numpy() - d_j).max(-1) > 1e-5
    assert far.sum() <= 4, far.sum()
    assert _rel(pdf, pdf_j, 1e-3)[~far].max() <= 1e-3


def test_sample_eval_matches_jax(states):
    """NEE radiance at the port's own sample, against JAX's eval there
    (the bars of tests/test_pallas.py:113-132)."""
    js, st = states
    u2 = np.random.default_rng(2).random((N, 2), dtype=np.float32)
    d, rad, pdf = TM.sample_eval(st, torch.tensor(u2), pdf_detached=True)
    rad_j = np.asarray(jax.jit(JM._eval_rgb_jnp)(js, d.numpy()))
    rel = _rel(rad, rad_j, 1e-3)
    assert np.median(rel) <= 1e-4
    assert rel.max() <= 1e-2
    d2, pdf2 = TM.sample_direction(st, torch.tensor(u2))
    assert torch.equal(d, d2) and torch.equal(pdf, pdf2)


@pytest.mark.parametrize("hour,turb,albedo,key", [
    (9.5, 2, 0.2, "sky_rgb_hour9.50_t2.000_a0.200"),
    (12.25, 5.2, 0.0, "sky_rgb_hour12.25_t5.200_a0.000"),
    (18.3, 9.8, 0.5, "sky_rgb_hour18.30_t9.800_a0.500"),
])
def test_sky_radiance_rgb_golden(golden, hour, turb, albedo, key):
    """The reference goldens at test_sunsky_golden.py's bar (mean relative
    error <= 0.017) on its lat-long directions."""
    sd = np.asarray(sun_direction(DateTimeRecord(hour=hour),
                                  LocationRecord()), np.float32)
    params = tt.make_params(turbidity=turb, albedo=albedo, sun_direction=sd,
                            sun_scale=0.0, device="cpu")
    h, w = 32, 64
    pg, tg = np.meshgrid(np.linspace(0, 2 * np.pi, w),
                         np.linspace(np.pi, 0, h))
    v = np.stack([np.cos(pg) * np.sin(tg), np.sin(pg) * np.sin(tg),
                  np.cos(tg)], -1).astype(np.float32)
    img = tt.sunsky_eval(tt.sunsky_precompute(params),
                         torch.tensor(-v)).numpy()
    ref = golden[key]
    assert np.mean(np.abs(img - ref) / (np.abs(ref) + 0.001)) <= 0.017


def test_wrappers_take_plain_versions_on_cpu(states, directions):
    _, st = states
    d = torch.tensor(directions)
    u2 = torch.rand(64, 2, generator=torch.Generator().manual_seed(0))
    build.reset_launches()
    assert torch.equal(TK.sunsky_eval_rgb(st, d), TM._eval_rgb_plain(st, d))
    for a, b in zip(TK.sunsky_hit_rgb(st, d), TM._hit_rgb_plain(st, d)):
        assert torch.equal(a, b)
    for a, b in zip(TK.sunsky_nee_rgb(st, u2),
                    TM._sample_eval_rgb_plain(st, u2)):
        assert torch.equal(a, b)
    assert all(v == 0 for v in build.launches.values())
    assert build.library.cache_info().currsize == 0


def test_wrappers_refuse_other_devices(states):
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    never silently routed to the plain version."""
    _, st = states
    with pytest.raises(ValueError, match="CUDA"):
        TK.sunsky_eval_rgb(st, torch.empty((8, 3), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        TK.sunsky_nee_rgb(st, torch.empty((8, 2), device="meta"))


_SIGNATURES = {
    "sunsky_eval": (ts.sunsky_eval, tt.sunsky_eval),
    "eval": (JM.eval, TM.eval),
    "eval_pdf": (JM.eval_pdf, TM.eval_pdf),
    "sample_eval": (JM.sample_eval, TM.sample_eval),
}


@pytest.mark.parametrize("name", sorted(_SIGNATURES))
def test_signature_binds_as_the_reference(name):
    """The reference's parameters come first, in its order, so a call
    written for it binds each positional argument to the same name; the
    port's own (`plain`) come after them."""
    ref, port = (list(inspect.signature(f).parameters.values())
                 for f in _SIGNATURES[name])
    sig = inspect.signature(_SIGNATURES[name][1])
    for k in range(1, len(ref) + 1):
        bound = sig.bind_partial(*range(k)).arguments
        assert list(bound) == [p.name for p in ref[:k]]
    for r, p in zip(ref, port):
        assert (p.name, p.kind, p.default) == (r.name, r.kind, r.default)
    assert [p.name for p in port[len(ref):]] == (
        ["plain"] if name != "sunsky_eval" else [])


def test_table_kinds_reads_host_data():
    """render()'s lobe descriptor comes from the table's host copy of its
    kinds: a `kind` tensor whose values cannot be read (on the meta
    device) is never read."""
    table = TB.make_material_table(kinds=[1, 0, 1], albedos=[[0.5] * 3] * 3,
                                   device="cpu")
    blind = table._replace(kind=torch.empty((3,), dtype=torch.int64,
                                            device="meta"))
    assert TB.table_kinds(blind) == ((0, 1), False)
    # a table built without the host copy reads `kind` on the CPU only
    bare = table._replace(host_kind=None)
    assert TB.table_kinds(bare) == ((0, 1), False)
    with pytest.raises(ValueError, match="host copy"):
        TB.table_kinds(blind._replace(host_kind=None))
