"""Count the tensor ops one `render_stokes` call dispatches, beside the
scalar `render()` of the same scene: chip_smoke's Stokes frame (phase
22) at a small size on the CPU, its mesh at a coarse subdivision (the
plain mesh intersection, whose ops K14 replaces on the card). Every op
that reaches the dispatcher is counted, views included.

    python3 tools/torch_stokes_ops.py [size] [spp] [subdiv]
"""

import os
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as C  # noqa: E402
import tpusky_torch as tt  # noqa: E402
from tpusky_torch.render import integrator  # noqa: E402
from tpusky_torch.render.film import Film  # noqa: E402
from tpusky_torch.render.polarized import render_stokes  # noqa: E402


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def main():
    size, spp, subdiv = (int(a) for a in (sys.argv[1:] + ["16", "8",
                                                          "2"])[:3])
    C.FRAME_SUBDIV = subdiv
    film = Film(size, size, 3)
    for mode in ("rgb", "spectral"):
        state = tt.sunsky_precompute(tt.make_params(
            turbidity=3.0, albedo=0.3, sun_direction=C.SUN, mode=mode,
            device="cpu"), mode=mode)
        scene, sensor = C._stokes_scene(state, "cpu")
        with _Count() as stokes:
            render_stokes(scene, sensor, film, 1, spp=spp,
                          max_depth=C.STOKES_DEPTH, mode=mode)
        with _Count() as scalar:
            integrator.render(scene, sensor, film, 1, spp=spp,
                              max_depth=C.STOKES_DEPTH, mode=mode)
        print(f"{mode} {size}x{size}x{spp}, depth {C.STOKES_DEPTH}, "
              f"icosphere({subdiv}): render_stokes {stokes.n} ops, "
              f"render {scalar.n} ops")


if __name__ == "__main__":
    main()
