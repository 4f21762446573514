"""The port's ADIntegrator surface (`tpusky_torch.ad.integrators`) against
the JAX package's on the CPU, on tests/test_ad.py's tiny bundle (a
rectangle under the sunsky, 12x8x4, prb at depth 2): `render_primal`,
`render_forward` against `jax.jvp` and `render_backward` against
`jax.vjp`, with the same parameters, tangents, adjoint image and seed;
and the adjoint identity <dL, J t> = <J^T dL, t> of the port's own two
modes. The reference's jvp and vjp are compiled as one program, once.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusky.ad import render_backward as j_backward
from tpusky.ad import render_forward as j_forward
from tpusky.render.loader import load_dict as j_load_dict
from tpusky.utils.transform import look_at, scale
import tpusky_torch as tt
from tpusky_torch.ad import (AD_INTEGRATOR_ALIASES, render_backward,
                             render_forward, render_primal)

torch.set_num_threads(1)

SEED = 5
# the emitter parameters whose derivative sums the sun disc's ramp lanes:
# an ulp of a sampled direction moves a lane across the ramp's end, so
# they are held to the reference's off the ramp's pixels, at 3e-2 of
# their scale (PERF.md §2)
SUN_FIELDS = ("sun_direction", "sun_half_aperture", "disc_softness")


def _tiny_dict(integrator="prb"):
    """tests/test_ad.py::_tiny_bundle's scene."""
    return {
        "type": "scene",
        "integrator": {"type": integrator, "max_depth": 2},
        "sensor": {"type": "perspective", "fov": 60,
                   "to_world": look_at([0, -4, 1.5], [0, 0, 0.8]),
                   "film": {"width": 12, "height": 8},
                   "sampler": {"type": "independent", "sample_count": 4}},
        "emitter": {"type": "sunsky", "turbidity": 4.3, "albedo": 0.3,
                    "sun_direction": [0.3, 0.2, 0.93]},
        "floor": {"type": "rectangle", "to_world": scale(8)},
    }


@pytest.fixture(scope="module")
def case():
    """The port's image, tangent image and gradients at seeded tangents
    and adjoint image, and the reference's (jax.jvp and jax.vjp, one
    jitted program, run three times). The reference alone marks the disc's
    ramp (`ramp`): the pixels where its tangent in disc_softness is not
    zero, that is those with a lane in the ramp. Both sides also take the
    adjoint image zeroed there."""
    jb = j_load_dict(_tiny_dict())
    rng = np.random.default_rng(1)
    tangents = [rng.normal(size=np.shape(p)).astype(np.float32)
                for p in jb.params]
    d_l = rng.normal(size=(8, 12, 3)).astype(np.float32)
    fields = jb.params._fields
    tb = tt.load_dict(_tiny_dict(), device="cpu")
    t_tan = {f"emitter.{f}": torch.as_tensor(t)
             for f, t in zip(fields, tangents)}
    p_img, p_dimg = render_forward(tb, None, t_tan, seed=SEED)
    p_img2, p_grads = render_backward(tb, torch.as_tensor(d_l), seed=SEED)

    @jax.jit
    def ref(tg, dl):
        img, dimg = j_forward(jb, jb.params, type(jb.params)(*tg),
                              seed=SEED)
        _, grads = j_backward(jb, dl, jb.params, seed=SEED)
        return img, dimg, grads

    def run(tg, dl):
        return jax.tree.map(np.asarray, ref([jnp.asarray(t) for t in tg],
                                            jnp.asarray(dl)))
    soft = [np.full_like(t, f == "disc_softness")
            for f, t in zip(fields, tangents)]
    ramp = np.abs(run(soft, d_l)[1]).max(-1) > 0
    img, dimg, grads = run(tangents, d_l)
    d_l_off = np.where(ramp[..., None], 0.0, d_l).astype(np.float32)
    grads_off = run(tangents, d_l_off)[2]
    g_off = render_backward(tb, torch.as_tensor(d_l_off), seed=SEED)[1]

    def named(g):
        return {k.split(".", 1)[1]: v.numpy() for k, v in g.items()}
    return dict(fields=fields, tangents=t_tan, d_l=d_l, tb=tb, ramp=ramp,
                ref=(img, dimg, dict(zip(fields, grads)),
                     dict(zip(fields, grads_off))),
                port=(p_img.numpy(), p_dimg.numpy(), p_img2.numpy(),
                      named(p_grads), named(g_off)))


def test_render_primal_matches_jax(case):
    """render_primal: the reference's image (the primal of its jax.jvp)
    within 1e-4 relative (floor 1e-3), detached, at the default
    parameters; render_forward's and render_backward's image is the same
    image; `prb_basic` forces depth 2 through the loader's alias table."""
    tb = case["tb"]
    img = render_primal(tb, seed=SEED)
    ref = case["ref"][0]
    assert not img.requires_grad and img.shape == (8, 12, 3)
    rel = np.abs(img.numpy() - ref) / np.maximum(np.abs(ref), 1e-3)
    assert rel.max() <= 1e-4, rel.max()
    for got in (case["port"][0], case["port"][2]):
        np.testing.assert_array_equal(got, img.numpy())
    assert AD_INTEGRATOR_ALIASES["prb_basic"] == ("path", 2)
    b = tt.load_dict(_tiny_dict("prb_basic"), device="cpu")
    assert b.integrator == "path" and b.max_depth == 2


def test_forward_and_backward_match_jax(case):
    """render_forward's tangent image against jax.jvp's, in units of its
    scale: off the reference's ramp pixels every pixel within 1e-3; on
    them within 0.25 (a lane an ulp from the ramp's end may lie inside it
    on one side only, and then adds a quarter of the ramp's slope, 1/eps,
    to its pixel's tangent), and at most one of them beyond 1e-3.
    render_backward's gradients against jax.vjp's within 1e-3 of each
    one's scale: the sky's and sun_scale with the whole adjoint image, the
    sun's direction and aperture with it zeroed on the ramp pixels at 3e-2
    (the bar of tests/test_torch_loader_render.py), and disc_softness,
    whose gradient lives on those pixels alone, exactly zero there."""
    img, dimg, grads, grads_off = case["ref"]
    p_img, p_dimg, _, p_grads, p_off = case["port"]
    ramp = case["ramp"]
    assert 0 < ramp.sum() <= 0.3 * ramp.size, ramp.sum()
    rel = np.abs(p_img - img) / np.maximum(np.abs(img), 1e-3)
    assert rel.max() <= 1e-4, rel.max()
    err = np.abs(p_dimg - dimg).max(-1) / np.abs(dimg).max()
    assert err[~ramp].max() <= 1e-3, err[~ramp].max()
    assert err[ramp].max() <= 0.25, err[ramp].max()
    assert (err[ramp] > 1e-3).sum() <= 1, np.sort(err[ramp])[-3:]
    for f in case["fields"]:
        if f == "disc_softness":
            assert np.abs(grads_off[f]).max() == 0.0
            assert np.abs(p_off[f]).max() == 0.0
            continue
        a, b, bar = ((p_off[f], grads_off[f], 3e-2) if f in SUN_FIELDS
                     else (p_grads[f], grads[f], 1e-3))
        e = np.abs(a - b).max() / np.abs(b).max()
        assert e <= bar, (f, e)


def test_adjoint_identity_and_defaults(case):
    """<dL, J t> from render_forward equals <J^T dL, t> from
    render_backward to rtol 2e-3 (tests/test_ad.py:132-149's bar), over
    every pixel; the default tangents are all ones over the emitter's
    parameters; `traverse()` entries beyond them (the floor's
    reflectance, an instanced sphere's to_world, whose name holds dots)
    are differentiated in both modes, consistently."""
    tb, d_l = case["tb"], case["d_l"]
    dimg, grads = case["port"][1], case["port"][3]
    lhs = float((d_l.astype(np.float64) * dimg).sum())
    rhs = sum(float((grads[k.split(".", 1)[1]].astype(np.float64)
                     * t.double().numpy()).sum())
              for k, t in case["tangents"].items())
    assert np.isclose(lhs, rhs, rtol=2e-3), (lhs, rhs)
    ones = {k: torch.ones_like(v) for k, v in case["tangents"].items()}
    np.testing.assert_array_equal(
        render_forward(tb, seed=SEED)[1].numpy(),
        render_forward(tb, None, ones, seed=SEED)[1].numpy())
    name = "floor.bsdf.reflectance.value"
    params = {name: tb.traverse()[name]}
    t_r = torch.tensor([1.0, 0.5, -0.2])
    _, dimg_r = render_forward(tb, params, {name: t_r}, seed=SEED)
    _, g_r = render_backward(tb, torch.as_tensor(d_l), params, seed=SEED)
    lhs_r = float((d_l.astype(np.float64) * dimg_r.numpy()).sum())
    rhs_r = float((g_r[name] * t_r).sum())
    assert abs(lhs_r) > 0 and np.isclose(lhs_r, rhs_r, rtol=2e-3), \
        (lhs_r, rhs_r)
    # an instanced shape's entry, whose name holds dots
    d = dict(_tiny_dict(), pair={"type": "shapegroup", "a": {
        "type": "sphere", "to_world": {"translate": [0, 0, 1]}}},
        i1={"type": "instance", "group": "pair"})
    tb_i = tt.load_dict(d, device="cpu")
    name = "i1.a.0.to_world"
    params = {name: tb_i.traverse()[name]}
    t_w = torch.zeros(4, 4)
    t_w[0, 3] = 1.0                                  # slide it along x
    _, dimg_w = render_forward(tb_i, params, {name: t_w}, seed=SEED)
    _, g_w = render_backward(tb_i, torch.as_tensor(d_l), params, seed=SEED)
    lhs_w = float((d_l.astype(np.float64) * dimg_w.numpy()).sum())
    assert abs(lhs_w) > 0 and np.isclose(lhs_w, float(g_w[name][0, 3]),
                                         rtol=2e-3)
