"""A loaded AOV render's child integrator renders at the bundle's seed
(the reference's renders at PRNGKey(0) whatever the seed, R2): two seeds
give two child images, each `render_aovs(child_seed=prng_key(seed))`'s;
seed 0's key is the reference's fixed child key, at which
tests/test_torch_aov.py holds the child against the reference's image.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import numpy as np
import torch

import torch_loader_case as L
from tpusky_torch.render.aov import REFERENCE_CHILD_KEY, render_aovs
from tpusky_torch.render.loader import prng_key

torch.set_num_threads(1)


def test_loaded_aov_child_follows_the_seed():
    """The headline scene (16x16) with an aov integrator around a path
    child (2 spp, depth 2): the child's image at seeds 0 and 1 differ,
    each bitwise render_aovs at the seed's key (the depth channel too);
    seed 0's is render_aovs' at the reference's child key."""
    d = dict(L.headline(), integrator={
        "type": "aov", "aovs": "dd:depth",
        "c": {"type": "path", "max_depth": 2}})
    tb = L.port_bundle(d)
    kw = dict(spp=2, max_depth=2, mode="rgb")
    imgs = {}
    for seed in (0, 1):
        got = tb.render(seed=seed, spp=2)
        want = render_aovs(tb.build_scene(), tb.sensor, tb.film.height,
                           tb.film.width, aovs="dd:depth", child="path",
                           child_kwargs=kw, child_seed=prng_key(seed))
        assert torch.equal(got["path"], want["path"])
        assert torch.equal(got["dd"], want["dd"])
        imgs[seed] = got["path"]
    assert float((imgs[0] - imgs[1]).abs().max()) > 1e-3
    assert tuple(prng_key(0).tolist()) == REFERENCE_CHILD_KEY
    default = render_aovs(tb.build_scene(), tb.sensor, tb.film.height,
                          tb.film.width, child="path", child_kwargs=kw)
    assert torch.equal(default["path"], imgs[0])
    assert np.isfinite(imgs[0].numpy()).all() and float(imgs[0].mean()) > 0
