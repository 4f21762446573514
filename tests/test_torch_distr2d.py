"""The port's 2-D distributions (`tpusky_torch/ops/distr2d.py`) and its
`chi2_test_2d` against the JAX package on the CPU.

Grids hold zero rows (and a zero column): the tables of the port's
constructors within 1e-5 relative of the reference's (their running sums
round in another order: torch sums a float32 row in float64 on the CPU,
XLA in a tree), then `*_sample` and `*_pdf` on the reference's own
tables within 1e-5 relative, at the same uniforms. The reference runs
eagerly, `Bilinear2D` through the body of its chunk loop
(`_bilinear_sample_flat`) on all lanes at once: jitted, XLA rounds the
inverse in a zero column's band otherwise, up to 6.6e-4 relative on a
pdf there. `Bilinear2D` picks a column by bisection where the reference
counts over a whole lerped row: the band and the column must equal the
reference's scan on every lane, 64 lanes lying exactly on CDF
breakpoints included.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusky.ops import distr2d as JD
from tpusky.utils.chi2 import chi2_test_2d as jax_chi2_test_2d

from tpusky_torch.ops import distr2d as TD
from tpusky_torch.utils.chi2 import chi2_test_2d

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

_DISTS = {"marginal": (JD.make_marginal_2d, JD.marginal_sample,
                       JD.marginal_pdf, TD.make_marginal_2d,
                       TD.marginal_sample, TD.marginal_pdf, TD.Marginal2D),
          "hierarchical": (JD.make_hierarchical_2d, JD.hierarchical_sample,
                           JD.hierarchical_pdf, TD.make_hierarchical_2d,
                           TD.hierarchical_sample, TD.hierarchical_pdf,
                           TD.Hierarchical2D),
          "bilinear": (JD.make_bilinear_2d, JD._bilinear_sample_flat,
                       JD.bilinear_pdf, TD.make_bilinear_2d,
                       TD.bilinear_sample, TD.bilinear_pdf, TD.Bilinear2D)}


def _grid(name, seed=0):
    """16x32 cells (17x33 vertices for the bilinear one) with a hot patch,
    a zero row and a zero column."""
    rng = np.random.default_rng(seed)
    shape = (17, 33) if name == "bilinear" else (16, 32)
    v = rng.uniform(0.05, 1.0, shape) ** 2
    v[5:8, :8] *= 25.0
    v[3] = 0.0
    v[:, 9] = 0.0
    return v.astype(np.float32)


def _to_torch(d, kind):
    """The reference's tables as the port's distribution."""
    if kind is TD.Hierarchical2D:
        return kind(tuple(torch.tensor(np.asarray(lv)) for lv in d.pyramid),
                    torch.tensor(np.asarray(d.density)))
    return kind(*(torch.tensor(np.asarray(x)) for x in d))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-6)).max())


def test_distributions_match_jax():
    """For each distribution: the constructor's tables, then sample (xy
    and pdf) and pdf at the same 20,000 uniforms, within 1e-5 relative;
    Hierarchical2D refuses a grid that is not a power of two."""
    u = np.random.default_rng(1).random((20_000, 2), dtype=np.float32)
    for name, (jmake, jsample, jpdf, tmake, tsample, tpdf,
               kind) in _DISTS.items():
        v = _grid(name)
        dj = jmake(v)
        dt = tmake(v, device="cpu")
        for a, b in zip(jax.tree.leaves(dj), jax.tree.leaves(
                tuple(dt), is_leaf=lambda x: isinstance(x, torch.Tensor))):
            assert _rel(b.numpy(), a) <= 1e-5, name
        dt = _to_torch(dj, kind)
        xy_j, p_j = jsample(dj, jnp.asarray(u))
        xy_t, p_t = tsample(dt, torch.tensor(u))
        assert _rel(xy_t.numpy(), xy_j) <= 1e-5, name
        assert _rel(p_t.numpy(), p_j) <= 1e-5, name
        assert _rel(tpdf(dt, xy_t).numpy(), jpdf(dj, xy_j)) <= 1e-5, name
        assert float(p_t.min()) > 0.0
    with pytest.raises(ValueError, match="power-of-two"):
        TD.make_hierarchical_2d(np.ones((12, 16)), device="cpu")


def _reference_scan(d, u2):
    """(band, column, lerped row) of the reference's chunk body,
    `_bilinear_sample_flat` (tpusky/ops/distr2d.py:216-240), run eagerly:
    the count of lerped CDF entries <= xi2 over the whole row."""
    h = d.row_cdf.shape[0]
    w = d.vtx.shape[1] - 1
    xi1 = u2[:, 0] * d.row_cdf[-1]
    i = jnp.clip(jnp.searchsorted(d.row_cdf, xi1, side="right"), 0, h - 1)
    lo = jnp.where(i > 0, d.row_cdf[jnp.maximum(i - 1, 0)], 0.0)
    r0, r1 = d.row_edge[i], d.row_edge[i + 1]
    t = JD._inv_linear_cdf(r0, 0.5 * (r1 - r0), jnp.maximum(xi1 - lo, 0.0))
    at = ((1.0 - t)[:, None] * jnp.take(d.colcdf, i, axis=0)
          + t[:, None] * jnp.take(d.colcdf, i + 1, axis=0))
    xi2 = u2[:, 1] * jnp.maximum((1.0 - t) * r0 + t * r1, 1e-30)
    j = jnp.clip(jnp.sum((at <= xi2[:, None]).astype(jnp.int32), axis=1)
                 - 1, 0, w - 1)
    return np.asarray(i), np.asarray(j), np.asarray(at)


def _breakpoint_lanes(d, n=64):
    """Uniforms whose xi1 lands exactly on a band's lower CDF edge (so t
    = 0) and whose xi2 lands exactly on a column's CDF value, found by
    float32 search around the quotient."""
    row_cdf = np.asarray(d.row_cdf)
    colcdf = np.asarray(d.colcdf)
    total = np.float32(row_cdf[-1])
    rng = np.random.default_rng(5)
    out = []

    def hit(target, scale):
        q = np.float32(target / scale)
        for step in range(-3, 4):
            c = np.float32(q + step * np.spacing(q))
            if 0.0 <= c < 1.0 and np.float32(c * scale) == target:
                return c
        return None
    while len(out) < n:
        i = int(rng.integers(1, row_cdf.shape[0]))
        k = int(rng.integers(1, colcdf.shape[1] - 1))
        u1 = hit(np.float32(row_cdf[i - 1]), total)
        u2 = hit(np.float32(colcdf[i, k]), np.float32(colcdf[i, -1]))
        if u1 is not None and u2 is not None:
            out.append((u1, u2))
    return np.asarray(out, np.float32)


def test_bilinear_bisection_equals_reference_scan():
    """The band and the column of every lane equal the reference's, on
    20,000 random lanes and 64 lanes on CDF breakpoints, where the
    bisection must take the count's side of the tie; no lerped row of
    these lanes is out of order (the reason the two agree)."""
    dj = JD.make_bilinear_2d(_grid("bilinear", seed=2))
    dt = _to_torch(dj, TD.Bilinear2D)
    edge = _breakpoint_lanes(dj)
    u = np.concatenate([np.random.default_rng(3).random(
        (20_000, 2), dtype=np.float32), edge])
    i_j, j_j, at = _reference_scan(dj, jnp.asarray(u))
    i_t, _, j_t, _, _ = TD._bilinear_cells(dt, torch.tensor(u))
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    np.testing.assert_array_equal(j_t.numpy(), j_j)
    assert int((np.diff(at, axis=1) < 0).any(axis=1).sum()) == 0
    # the breakpoint lanes start exactly at their column
    n_edge = edge.shape[0]
    colcdf = np.asarray(dj.colcdf)
    assert (colcdf[i_j[-n_edge:], j_j[-n_edge:]]
            == edge[:, 1] * colcdf[i_j[-n_edge:], -1]).all()


def _density(xy):
    """(1 + x)(0.5 + y) / 1.5 over the unit square, in numpy float32."""
    p = np.asarray(xy, np.float32)
    return ((1.0 + p[:, 0]) * (0.5 + p[:, 1]) / np.float32(1.5)).astype(
        np.float32)


def test_chi2_test_2d():
    """`chi2_test_2d` on each distribution at N = 2e5 through the port's
    samplers: p >= 0.01. On one histogram of fixed points and one density,
    its statistic equals the reference's within 1e-6 relative."""
    for name, (_, _, _, tmake, tsample, tpdf, _) in _DISTS.items():
        d = tmake(_grid(name, seed=4), device="cpu")

        def sample_fn(batch_seed, n, d=d, tsample=tsample):
            g = torch.Generator().manual_seed(batch_seed)
            return tsample(d, torch.rand(n, 2, generator=g))[0]
        p, ok, info = chi2_test_2d(sample_fn, lambda xy, d=d, tpdf=tpdf:
                                   tpdf(d, xy), sample_count=200_000,
                                   res_x=32, res_y=16, batch=50_000)
        assert ok, (name, p, info)

    # points with the density (1 + x)(0.5 + y) / 1.5, by inverse CDFs
    rng = np.random.default_rng(9)
    r = rng.random((100_000, 2))
    x = np.sqrt(1.0 + 3.0 * r[:, 0]) - 1.0
    y = (np.sqrt(0.25 + 2.0 * r[:, 1]) - 0.5)
    pts = np.stack([x, y], -1).astype(np.float32)
    batches = iter(np.split(pts, 4))
    p_j, _, info_j = jax_chi2_test_2d(
        lambda key, n: jnp.asarray(next(batches)), _density,
        key=jax.random.PRNGKey(0), sample_count=100_000, res_x=16, res_y=8,
        batch=25_000)
    batches_t = iter(np.split(pts, 4))
    p_t, _, info_t = chi2_test_2d(
        lambda seed, n: torch.tensor(next(batches_t)),
        lambda xy: torch.tensor(_density(xy.numpy())),
        sample_count=100_000, res_x=16, res_y=8, batch=25_000)
    assert info_t["dof"] == info_j["dof"]
    assert abs(info_t["stat"] - info_j["stat"]) <= 1e-6 * info_j["stat"]
    assert abs(p_t - p_j) <= 1e-6 and p_t >= 0.01, (p_t, p_j)
