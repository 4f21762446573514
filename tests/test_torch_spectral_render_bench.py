"""The port's spectral render of bench.py::bench_spectral's scene (a
rough-conductor ground, depth 4) against the JAX package's, lane by lane
at 16x16x2 on the CPU (`torch_spectral_render_case.py`).

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and its JAX compile adds nothing
to the wall.
"""

import pytest
import torch

from torch_spectral_render_case import (  # noqa: F401 (collected tests)
    build_renders, test_spectral_render_matches_jax,
    test_spectral_render_on_cpu_is_plain,
    test_spectral_render_refuses_a_mismatched_state)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module", params=["bench_spectral"])
def renders(request):
    return build_renders(request.param)
