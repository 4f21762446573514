"""Time one checkout of the port on the card, for A/B comparisons of two
checkouts in one call (run each in turns: A, B, B, A).

    python3 tools/torch_ab.py k14 <checkout>       # K14 alone
    python3 tools/torch_ab.py spec_bwd <checkout>  # K12 and K13 alone
    python3 tools/torch_ab.py spec_fwd <checkout>  # K9, K10 and K11 alone
    python3 tools/torch_ab.py rgb_fwd <checkout>   # K1, K2 and K3 alone
    python3 tools/torch_ab.py rgb_bwd <checkout>   # K5, K6, K7 and K8 alone
    python3 tools/torch_ab.py host <checkout>      # host-bound frames

`k14`: K14 alone on bench_mesh's two wavefronts (1,048,576 rays) at
icosphere(4-7), direct and sorted (the sort not timed), median of 7 CUDA
event times, with a checksum of the hits (equal checksums, equal hits).
`spec_bwd`: K12 and K13 alone at 2,097,152 lanes, without and with the
pdf, by lane mix (K12: chip_smoke's phase 6 directions at 4 and 10
wavelengths, and every lane in the sun's disc; K13: the headline sky
weight, every lane a TGMM sky sample, every lane a sun-cone sample),
median of 7 CUDA-event times with a checksum of the cotangent row (sums
taken by shared atomics in no fixed order agree to ~1e-6), then each
case's device time split between pass 1 and `reduce_partials` by
torch.profiler, and the ptxas report of the spectral adjoint's kernels.
`spec_fwd`: K9, K10 and K11 alone at 2,097,152 lanes x 4 hero
wavelengths (phase 6's lane mix) and at 64K lanes x 10 wavelengths, K10
with every direction in the sun's disc, K11 with every lane a TGMM sky
sample and with every lane a sun-cone sample, the median of 9 CUDA-event
times of 10 launches each (a launch's own time, as chip_smoke.py takes
it; one launch between two events reads ~0.03 ms more), with checksums
of the outputs (radiance, pdf, direction, in the wrapper's order; each
the float64 sum of its values and the integer sum of its float32 bit
patterns, so bitwise equal outputs print equal pairs), and the ptxas
report of the spectral forward kernels.
`rgb_fwd`: K1, K2 and K3 alone at 2,097,152 lanes, the median of 9
CUDA-event times of 10 launches each, on chip_smoke.py phase 3's lanes
(directions over the upper hemisphere, uniform in cos theta, and the
uniforms u2, both from default_rng(0)), K1 and K2 with every direction in
the sun's disc (the plain sampler's sun-cone samples), K3 with every lane
a TGMM sky sample (u0 < w) and with every lane a sun-cone sample. Each
case prints, for each output (radiance, pdf, direction), the checksums
of `spec_fwd`: a pdf that moved by an ulp changes the second number
(the staged pdf multiplies by 1/sigma where the global-memory one
divides by sigma, within ~1e-6: compare its float sums).
Then the ptxas report of the RGB forward kernels.
`rgb_bwd`: the RGB adjoints K5, K6, K7 and K8 alone at 2,097,152 lanes,
as `spec_bwd` times K12 and K13: K5 and K7 on rgb_fwd's directions with
1% of them moved to the sun disc's edge, and with every direction in
the disc (1% of them at its edge); K6 and K8 on the headline uniforms,
every lane a TGMM sky sample and every lane a sun-cone sample; the
cotangents normal draws, on the radiance and (K7, K8) on the pdf. Each
case prints the median of 7 CUDA-event times, its device time split
between pass 1 and `reduce_partials` by torch.profiler, and checksums:
the float64 sum and absolute sum of the cotangent row (sun, skyp, skyr,
misc, and the gaussian table for K7/K8) and, for K5/K7, of the direction
cotangent dd. The row is summed in another order by another design (and
the sun table by shared atomics in no fixed order), so two trees agree
to ~1e-6 of the absolute sum, not bitwise. Then K6's and K8's rows (K8
without a pdf cotangent) against K5's at the directions K3 draws from
the same uniforms, with a radiance cotangent on one of 64 headline lanes
at a time (every sum exact: the rows are equal bitwise where the redrawn
direction is K3's and the radiance's reverse rounds alike in the two
kernels), and the ptxas report of the RGB adjoint kernels.
`host`: medians and quartiles of 7 host-clock times, each ending in a
synchronise, of the headline frame through render_rows (K2, K3), the
bench_spectral frame, bench_grad's and bench_spectral_grad's fwd+bwd
through render_rows and the mesh frame.
Each imports the checkout's own `tpusky_torch` and `chip_smoke.py`, so
the two sides build and run their own kernels. Prints one line per case
with the card's name and power limit.
"""

import os
import sys
import time

import numpy as np


def _checksums(outputs):
    """Each output's float64 sum and the integer sum of its float32 bit
    patterns: bitwise equal outputs print equal pairs."""
    import torch
    return " | ".join(
        f"{float(x.double().sum()):.9e} "
        f"{int(x.contiguous().view(torch.int32).long().sum())}"
        for x in outputs)


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


def spec_bwd(C, card):
    import torch
    import tpusky_torch as tt
    from torch.profiler import ProfilerActivity, profile
    from tpusky_torch.ops import spectrum
    from tpusky_torch.ops.cuda import build
    from tpusky_torch.ops.cuda import sunsky_kernel as K
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(12)
    n = C.N_LANES
    state = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=C.SUN, mode="spectral",
        device=dev), mode="spectral")
    tables = K.pack_tables_spec(state, dev)

    def tensor(x):
        return torch.tensor(x.astype(np.float32), device=dev)
    u = rng.random((n, 2), dtype=np.float32)
    st = np.sqrt(1.0 - u[:, 0] ** 2)
    phi = 2.0 * np.pi * u[:, 1]
    d = tensor(np.stack([st * np.cos(phi), st * np.sin(phi), u[:, 0]], -1))
    d[: n // 8, 2] = -d[: n // 8, 2]
    d = C._with_disc_edge(d, state, rng)
    wl = spectrum.sample_rgb_spectrum(spectrum.sample_shifted(
        tensor(rng.random(n)), C.N_HERO))[0].contiguous()
    m = 1 << 16
    wl10 = tensor(rng.uniform(300.0, 760.0, (m, 10)))
    u2 = tensor(rng.random((n, 2)))
    w_sky = float(state.sky_sampling_w)
    u_sky = torch.stack([u2[:, 0] * w_sky, u2[:, 1]], -1).contiguous()
    u_sun = torch.stack([w_sky + (1.0 - w_sky) * u2[:, 0], u2[:, 1]],
                        -1).contiguous()
    # every lane in the disc: the sun-cone samples' directions
    d_disc = K.launch_nee_spec(tables, u_sun, wl)[0].contiguous()
    g, g10 = tensor(rng.normal(size=(n, C.N_HERO))), tensor(
        rng.normal(size=(m, 10)))
    g_pdf = tensor(rng.normal(size=n))
    cases = {}
    for pdf in (None, g_pdf):
        tag = "" if pdf is None else " with the pdf"
        cases[f"K12{tag} headline"] = lambda p=pdf: K.launch_hit_spec_bwd(
            tables, d, wl, g, p)
        cases[f"K12{tag} 64K lanes x 10 wavelengths"] = (
            lambda p=pdf: K.launch_hit_spec_bwd(
                tables, d[n - m:], wl10, g10, None if p is None else p[:m]))
        cases[f"K12{tag} all disc"] = lambda p=pdf: K.launch_hit_spec_bwd(
            tables, d_disc, wl, g, p)
        for mix, uu in (("headline", u2), ("all sky", u_sky),
                        ("all sun-cone", u_sun)):
            cases[f"K13{tag} {mix}"] = (
                lambda p=pdf, uu=uu: K.launch_nee_spec_bwd(
                    tables, uu, wl, g, p))
    out = []
    for name, fn in cases.items():
        row = torch.cat([x.reshape(-1) for x in fn()
                         if x is not None][-6:]).double()
        ms = C._median_ms(fn, reps=7)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        split = {"pass 1": 0.0, "reduce_partials": 0.0}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = ("reduce_partials" if "reduce_partials" in e.name
                       else "pass 1" if "bwd_kernel" in e.name else None)
                if key is not None:
                    split[key] += e.device_time_total / 3e3
        out.append(f"{name}: {ms:.4f} ms (profiled: pass 1 "
                   f"{split['pass 1']:.4f} ms, reduce_partials "
                   f"{split['reduce_partials']:.4f} ms) checksum "
                   f"{float(row.sum()):.6e} {float(row.abs().sum()):.6e}")
    # the log itself, so that a checkout without build.ptxas_report
    # prints it too
    with open(build.build()[:-3] + ".log") as f:
        log = f.read().split("== sunsky_spectral_adjoint.cu")[1].split(
            "\n== ")[0]
    out += [" ".join(line.split()) for line in log.splitlines()
            if "spill" in line or "registers" in line
            or "Compiling entry" in line]
    return out


def spec_fwd(C, card):
    import torch
    import tpusky_torch as tt
    from tpusky_torch.ops import spectrum
    from tpusky_torch.ops.cuda import build
    from tpusky_torch.ops.cuda import sunsky_kernel as K
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(10)
    n = C.N_LANES
    state = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=C.SUN, mode="spectral",
        device=dev), mode="spectral")
    tables = K.pack_tables_spec(state, dev)

    def tensor(x):
        return torch.tensor(x.astype(np.float32), device=dev)
    # phase 6's lanes: uniform directions, the first eighth below the
    # horizon, hero wavelengths as the render draws them
    u = rng.random((n, 2), dtype=np.float32)
    st = np.sqrt(1.0 - u[:, 0] ** 2)
    phi = 2.0 * np.pi * u[:, 1]
    d = tensor(np.stack([st * np.cos(phi), st * np.sin(phi), u[:, 0]], -1))
    d[: n // 8, 2] = -d[: n // 8, 2]
    wl = spectrum.sample_rgb_spectrum(spectrum.sample_shifted(
        tensor(rng.random(n)), C.N_HERO))[0].contiguous()
    m = 1 << 16
    wl10 = tensor(rng.uniform(300.0, 760.0, (m, 10)))
    u2 = tensor(rng.random((n, 2)))
    w_sky = float(state.sky_sampling_w)
    u_sky = torch.stack([u2[:, 0] * w_sky, u2[:, 1]], -1).contiguous()
    u_sun = torch.stack([w_sky + (1.0 - w_sky) * u2[:, 0], u2[:, 1]],
                        -1).contiguous()
    # every lane in the disc: the sun-cone samples' directions
    d_disc = K.launch_nee_spec(tables, u_sun, wl)[0].contiguous()
    cases = {
        "K9 headline": lambda: K.launch_eval_spec(tables, d, wl),
        "K9 64K lanes x 10 wavelengths": lambda: K.launch_eval_spec(
            tables, d[n - m:], wl10),
        "K10 headline": lambda: K.launch_hit_spec(tables, d, wl),
        "K10 all disc": lambda: K.launch_hit_spec(tables, d_disc, wl),
        "K10 64K lanes x 10 wavelengths": lambda: K.launch_hit_spec(
            tables, d[n - m:], wl10),
        "K11 headline": lambda: K.launch_nee_spec(tables, u2, wl),
        "K11 all sky": lambda: K.launch_nee_spec(tables, u_sky, wl),
        "K11 all sun-cone": lambda: K.launch_nee_spec(tables, u_sun, wl),
        "K11 64K lanes x 10 wavelengths": lambda: K.launch_nee_spec(
            tables, u2[n - m:], wl10),
    }
    out = []
    for name, fn in cases.items():
        res = fn()
        res = res if isinstance(res, tuple) else (res,)
        ms = float(np.median([C._time_ms(fn, reps=10, warmup=1)
                              for _ in range(9)]))
        out.append(f"{name}: {ms:.4f} ms checksum {_checksums(res)}")
    with open(build.build()[:-3] + ".log") as f:
        log = f.read().split("== sunsky_spectral.cu")[1].split("\n== ")[0]
    out += [" ".join(line.split()) for line in log.splitlines()
            if "spill" in line or "registers" in line
            or "Compiling entry" in line]
    return out


def rgb_fwd(C, card):
    import torch
    import tpusky_torch as tt
    from tpusky_torch.models.sunsky import model as M
    from tpusky_torch.ops.cuda import build
    from tpusky_torch.ops.cuda import sunsky_kernel as K
    dev = torch.device("cuda", 0)
    n = C.N_LANES
    state = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=C.SUN, device=dev))
    tables = K.pack_tables(state, dev)
    # chip_smoke.py phase 3's lanes
    rng = np.random.default_rng(0)
    u = rng.random((n, 2), dtype=np.float32)
    ct = u[:, 0]
    st = np.sqrt(1.0 - ct * ct)
    phi = 2.0 * np.pi * u[:, 1]
    d = torch.tensor(np.stack([st * np.cos(phi), st * np.sin(phi), ct],
                              -1).astype(np.float32), device=dev)
    u2 = torch.tensor(rng.random((n, 2), dtype=np.float32), device=dev)
    w_sky = float(state.sky_sampling_w)
    u_sky = torch.stack([u2[:, 0] * w_sky, u2[:, 1]], -1).contiguous()
    u_sun = torch.stack([w_sky + (1.0 - w_sky) * u2[:, 0], u2[:, 1]],
                        -1).contiguous()
    # every direction in the disc: the plain sampler's sun-cone samples
    with torch.no_grad():
        d_disc = M._sample_eval_rgb_plain(state, u_sun)[0].contiguous()
    cases = {
        "K1 headline": lambda: K.launch_eval(tables, d),
        "K1 all disc": lambda: K.launch_eval(tables, d_disc),
        "K2 headline": lambda: K.launch_hit(tables, d),
        "K2 all disc": lambda: K.launch_hit(tables, d_disc),
        "K3 headline": lambda: K.launch_nee(tables, u2),
        "K3 all sky": lambda: K.launch_nee(tables, u_sky),
        "K3 all sun-cone": lambda: K.launch_nee(tables, u_sun),
    }
    out = []
    for name, fn in cases.items():
        res = fn()
        res = res if isinstance(res, tuple) else (res,)
        # K3 returns (d, rad, pdf): print radiance, pdf, direction
        res = (res[1], res[2], res[0]) if len(res) == 3 else res
        ms = float(np.median([C._time_ms(fn, reps=10, warmup=1)
                              for _ in range(9)]))
        out.append(f"{name}: {ms:.4f} ms checksum {_checksums(res)}")
    with open(build.build()[:-3] + ".log") as f:
        log = f.read().split("== sunsky_kernels.cu")[1].split("\n== ")[0]
    out += [" ".join(line.split()) for line in log.splitlines()
            if "spill" in line or "registers" in line
            or "Compiling entry" in line]
    return out


def rgb_bwd(C, card):
    import torch
    import tpusky_torch as tt
    from torch.profiler import ProfilerActivity, profile
    from tpusky_torch.models.sunsky import model as M
    from tpusky_torch.ops.cuda import build
    from tpusky_torch.ops.cuda import sunsky_kernel as K
    dev = torch.device("cuda", 0)
    n = C.N_LANES
    state = tt.sunsky_precompute(tt.make_params(
        turbidity=3.0, albedo=0.3, sun_direction=C.SUN, device=dev))
    tables = K.pack_tables(state, dev)
    # chip_smoke.py phase 3's lanes, 1% of the directions at the disc edge
    rng = np.random.default_rng(0)
    u = rng.random((n, 2), dtype=np.float32)
    ct = u[:, 0]
    st = np.sqrt(1.0 - ct * ct)
    phi = 2.0 * np.pi * u[:, 1]
    d = torch.tensor(np.stack([st * np.cos(phi), st * np.sin(phi), ct],
                              -1).astype(np.float32), device=dev)
    u2 = torch.tensor(rng.random((n, 2), dtype=np.float32), device=dev)
    d = C._with_disc_edge(d, state, np.random.default_rng(5))
    w_sky = float(state.sky_sampling_w)
    u_sky = torch.stack([u2[:, 0] * w_sky, u2[:, 1]], -1).contiguous()
    u_sun = torch.stack([w_sky + (1.0 - w_sky) * u2[:, 0], u2[:, 1]],
                        -1).contiguous()
    # every direction in the disc: the plain sampler's sun-cone samples,
    # 1% of them at the disc edge (chip_smoke.py phase 3's K2 lanes)
    with torch.no_grad():
        d_disc = C._with_disc_edge(M._sample_eval_rgb_plain(
            state, u_sun)[0].contiguous(), state, np.random.default_rng(2))
    # cotangents drawn as attached_pdf_phase draws them
    g_rng = np.random.default_rng(8)
    g_rad = torch.tensor(g_rng.normal(size=(n, 3)).astype(np.float32),
                         device=dev)
    g_pdf = torch.tensor(g_rng.normal(size=n).astype(np.float32),
                         device=dev)
    cases = {
        "K5 headline": lambda: K.launch_eval_bwd(tables, d, g_rad),
        "K5 all disc": lambda: K.launch_eval_bwd(tables, d_disc, g_rad),
        "K7 headline": lambda: K.launch_hit_bwd(tables, d, g_rad, g_pdf),
        "K7 all disc": lambda: K.launch_hit_bwd(tables, d_disc, g_rad,
                                                g_pdf),
    }
    for mix, uu in (("headline", u2), ("all sky", u_sky),
                    ("all sun-cone", u_sun)):
        cases[f"K6 {mix}"] = lambda uu=uu: K.launch_nee_bwd(tables, uu,
                                                           g_rad)
        cases[f"K8 {mix}"] = lambda uu=uu: K.launch_nee_pdf_bwd(
            tables, uu, g_rad, g_pdf)
    out = []
    for name, fn in cases.items():
        res = fn()
        per_lane = name[:2] in ("K5", "K7")    # (dd, *tables)
        row = torch.cat([x.reshape(-1)
                         for x in res[per_lane:]]).double()
        dd = (f" dd {float(res[0].double().sum()):.6e} "
              f"{float(res[0].double().abs().sum()):.6e}"
              if per_lane else "")
        ms = C._median_ms(fn, reps=7)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        split = {"pass 1": 0.0, "reduce_partials": 0.0}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = ("reduce_partials" if "reduce_partials" in e.name
                       else "pass 1" if "bwd_kernel" in e.name else None)
                if key is not None:
                    split[key] += e.device_time_total / 3e3
        out.append(f"{name}: {ms:.4f} ms (profiled: pass 1 "
                   f"{split['pass 1']:.4f} ms, reduce_partials "
                   f"{split['reduce_partials']:.4f} ms) checksum "
                   f"{float(row.sum()):.6e} {float(row.abs().sum()):.6e}"
                   f"{dd}")
    # K6 and K8 redraw K3's samples: with a radiance cotangent on one lane
    # alone every sum is exact, so their rows are K5's at K3's direction
    # bitwise where the redrawn direction is K3's and the radiance's
    # reverse rounds alike in the kernels
    d3 = K.launch_nee(tables, u2)[0].contiguous()
    probes = np.random.default_rng(6).choice(n, 64, replace=False)
    equal = {"K6": 0, "K8": 0}
    no_pdf = torch.zeros_like(g_pdf)
    for j in probes.tolist():
        g1 = torch.zeros_like(g_rad)
        g1[j] = g_rad[j]
        r5 = torch.cat([x.reshape(-1) for x in K.launch_eval_bwd(
            tables, d3, g1)[1:]])
        r6 = torch.cat([x.reshape(-1) for x in K.launch_nee_bwd(
            tables, u2, g1)])
        r8 = torch.cat([x.reshape(-1) for x in K.launch_nee_pdf_bwd(
            tables, u2, g1, no_pdf)[:4]])
        equal["K6"] += bool(torch.equal(r6, r5))
        equal["K8"] += bool(torch.equal(r8, r5))
    out.append(f"K6 and K8 against K5 at K3's directions, a radiance "
               f"cotangent on one headline lane: {equal['K6']} and "
               f"{equal['K8']} of {len(probes)} rows bitwise equal "
               f"({int((u2[probes, 0] < w_sky).sum())} of the lanes sky "
               f"samples)")
    with open(build.build()[:-3] + ".log") as f:
        log = f.read().split("== sunsky_adjoint.cu")[1].split("\n== ")[0]
    out += [" ".join(line.split()) for line in log.splitlines()
            if "spill" in line or "registers" in line
            or "Compiling entry" in line]
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
    sc_g, se_g = C._spectral_grad_scene(spec, dev)
    tables_s = tt.load_tables("spectral", device=dev)
    out = {
        "headline rows": med(lambda: integrator.render_rows(
            sc_h, se_h, film, C.SEED, C.SPP, C.MAX_DEPTH, 1000, "rgb", 0,
            C.H)),
        "spectral frame": med(lambda: integrator.render(
            sc_s, se_s, film, C.SEED, spp=C.SPP, max_depth=C.SPEC_DEPTH,
            mode="spectral")),
        "bench_grad rows": med(lambda: C.grad_case(
            "rows", sc_h, se_h, film, tables, dev)),
        "bench_spectral_grad rows": med(lambda: C.spectral_grad_case(
            "rows", sc_g, se_g, film, tables_s, dev)),
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
    modes = {"k14": k14, "spec_bwd": spec_bwd, "spec_fwd": spec_fwd,
             "rgb_fwd": rgb_fwd, "rgb_bwd": rgb_bwd, "host": host}
    for line in modes[mode](C, card):
        print(f"{mode.upper()} {os.path.relpath(tree)} {line} [{card}]")


if __name__ == "__main__":
    main()
