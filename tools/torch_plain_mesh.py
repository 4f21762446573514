"""Time the port's plain mesh path on the card in turns, in one call: the
dense scan (every ray against every 128-triangle tile, as the plain path
was before PR 20) and the path as it stands (`render/mesh.py`: a tile
tested on the rays `_near_tile` keeps), each the closest hit and the
any-hit test of 262,144 rays of bench_mesh's coherent and incoherent
wavefronts against icosphere(6) (81,920 triangles), in the order dense,
selected, selected, dense, dense, selected; the two results compared
bitwise.

    python3 tools/torch_plain_mesh.py
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as C                                    # noqa: E402
from tpusky_torch.render import mesh as TM                # noqa: E402
from tpusky_torch.utils.meshio import icosphere           # noqa: E402

N_RAYS = 1 << 18


def _dense_closest(mesh, o, d):
    """The dense scan (the plain path before PR 20): every tile on every
    ray, in chunks of the plain path's size."""
    out, step = [], TM._PLAIN_RAYS[o.device.type]
    for r0 in range(0, o.shape[0], step):
        oc, dc = o[r0:r0 + step], d[r0:r0 + step]
        bt = torch.full(oc.shape[:1], torch.inf, device=o.device)
        bb1, bb2 = torch.zeros_like(bt), torch.zeros_like(bt)
        btri = torch.full(oc.shape[:1], -1, dtype=torch.int64,
                          device=o.device)
        for tile in range(mesh.v0.shape[0] // TM._TILE):
            t, b1, b2, local = TM._tile_hits(mesh, tile, oc, dc)
            closer = t < bt
            bt = torch.where(closer, t, bt)
            bb1 = torch.where(closer, b1, bb1)
            bb2 = torch.where(closer, b2, bb2)
            btri = torch.where(closer, tile * TM._TILE + local, btri)
        out.append((bt, bb1, bb2, btri))
    return tuple(torch.cat(x) for x in zip(*out))


def _dense_occluded(mesh, o, d, maxt):
    out, step = [], TM._PLAIN_RAYS[o.device.type]
    for r0 in range(0, o.shape[0], step):
        oc, dc = o[r0:r0 + step], d[r0:r0 + step]
        mt = maxt[r0:r0 + step, None]
        occ = torch.zeros(oc.shape[:1], dtype=torch.bool, device=o.device)
        for tile in range(mesh.v0.shape[0] // TM._TILE):
            occ = occ | (TM._tile_mt(mesh, tile, oc, dc)[0] < mt).any(-1)
        out.append(occ)
    return torch.cat(out)


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("torch_plain_mesh needs a CUDA device")
    print("card:", C._card_line())
    dev = torch.device("cuda", 0)
    pos, idx = icosphere(6)
    mesh = TM.make_mesh_table([dict(positions=pos, indices=idx,
                                    normals=pos, bsdf_idx=0)], device=dev)
    paths = {"dense": (_dense_closest, _dense_occluded),
             "selected": (TM._closest_plain, TM._occluded_plain)}
    for kind, (o, d) in C._mesh_wavefronts(np.random.default_rng(0),
                                           dev).items():
        o, d = o[:N_RAYS].contiguous(), d[:N_RAYS].contiguous()
        maxt = torch.full((N_RAYS,), 2.0, device=dev)
        res, times = {}, {"dense": [], "selected": []}
        for turn in ("dense", "selected", "selected", "dense", "dense",
                     "selected"):
            closest, occluded = paths[turn]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[turn] = (closest(mesh, o, d), occluded(mesh, o, d, maxt))
            torch.cuda.synchronize()
            times[turn].append(1e3 * (time.perf_counter() - t0))
        same = (all(torch.equal(a, b) for a, b in zip(res["dense"][0],
                                                      res["selected"][0]))
                and torch.equal(res["dense"][1], res["selected"][1]))
        print(f"{kind} {N_RAYS} rays, closest + occluded: dense "
              f"{', '.join(f'{t:.1f}' for t in times['dense'])} ms; "
              f"selected {', '.join(f'{t:.1f}' for t in times['selected'])}"
              f" ms; bitwise equal {same}")


if __name__ == "__main__":
    main()
