"""Time one checkout of the port on the card, for A/B comparisons of two
checkouts in one call (run each in turns: A, B, B, A).

    python3 tools/torch_ab.py k14 <checkout>    # K14 alone
    python3 tools/torch_ab.py host <checkout>   # host-bound frames

`k14`: K14 alone on bench_mesh's two wavefronts (1,048,576 rays) at
icosphere(4-7), direct and sorted (the sort not timed), median of 7 CUDA
event times, with a checksum of the hits (equal checksums, equal hits).
`host`: medians and quartiles of 7 host-clock times, each ending in a
synchronise, of the bench_spectral frame, bench_grad's fwd+bwd through
render_rows and the mesh frame. Each imports the checkout's own
`tpusky_torch` and `chip_smoke.py`, so the two sides build and run their
own kernels. Prints one line per case with the card's name and power
limit.
"""

import os
import sys
import time

import numpy as np


def k14(C, card):
    import torch
    from tpusky_torch.ops.cuda import mesh_kernel as MKT
    from tpusky_torch.render import mesh as TM
    from tpusky_torch.utils.meshio import icosphere
    waves = C._mesh_wavefronts(np.random.default_rng(14), "cuda")
    out = []
    for n_subdiv in (4, 5, 6, 7):
        pos, idx = icosphere(n_subdiv)
        mesh = TM.make_mesh_table([dict(positions=pos, indices=idx,
                                        normals=pos.copy(), bsdf_idx=0)],
                                  device="cuda")
        tables = MKT.mesh_tables(mesh)
        for kind, (o, d) in waves.items():
            order, _ = TM._ray_sort_order(mesh, o, d)
            o_s, d_s = o[order].contiguous(), d[order].contiguous()
            ref = MKT.launch(tables, o, d)
            ms = C._median_ms(lambda: MKT.launch(tables, o, d), reps=7)
            ms_s = C._median_ms(lambda: MKT.launch(tables, o_s, d_s), reps=7)
            hit_t = ref[0][torch.isfinite(ref[0])]
            out.append(f"{len(idx)} {kind}: direct {ms:.4f} sorted "
                       f"{ms_s:.4f} checksum {float(hit_t.sum()):.6e} "
                       f"{int(ref[3].long().sum())}")
    return out


def host(C, card):
    import torch
    import tpusky_torch as tt
    from tpusky_torch.render import integrator
    from tpusky_torch.render.film import Film
    dev = torch.device("cuda", 0)
    film = Film(C.H, C.W, 3)

    def med(fn, n=7):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        return (float(np.median(ts)), float(np.percentile(ts, 25)),
                float(np.percentile(ts, 75)))
    p = dict(turbidity=3.0, albedo=0.3, sun_direction=C.SUN)
    spec = tt.sunsky_precompute(tt.make_params(**p, mode="spectral",
                                               device=dev), mode="spectral")
    sc_s, se_s = C._spectral_scene(spec, dev)
    rgb = tt.sunsky_precompute(tt.make_params(**p, device=dev))
    sc_h, se_h = C._headline_scene(rgb, dev)
    tables = tt.load_tables("rgb", device=dev)
    sc_m, se_m = C._mesh_scene(rgb, C.FRAME_SUBDIV, dev)
    out = {
        "spectral frame": med(lambda: integrator.render(
            sc_s, se_s, film, C.SEED, spp=C.SPP, max_depth=C.SPEC_DEPTH,
            mode="spectral")),
        "bench_grad rows": med(lambda: C.grad_case(
            "rows", sc_h, se_h, film, tables, dev)),
        "mesh frame": med(lambda: integrator.render(
            sc_m, se_m, film, C.SEED, spp=C.SPP, max_depth=C.MESH_DEPTH)),
    }
    return [f"{k}: median {m:.3f} ms (quartiles {q1:.3f}-{q3:.3f})"
            for k, (m, q1, q3) in out.items()]


def main():
    mode, tree = sys.argv[1], os.path.abspath(sys.argv[2])
    sys.path.insert(0, tree)
    import chip_smoke as C
    from tpusky_torch.ops.cuda import build
    card = C._card_line()
    build.library()
    for line in {"k14": k14, "host": host}[mode](C, card):
        print(f"{mode.upper()} {os.path.relpath(tree)} {line} [{card}]")


if __name__ == "__main__":
    main()
