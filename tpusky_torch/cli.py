"""Command-line renderer (`tpusky/cli.py`, the counterpart of Mitsuba's
`mitsuba` binary), on the card unless `--device` names another:

    python -m tpusky_torch render scene.xml -o out.exr --spp 64 --seed 0
    python -m tpusky_torch render scene.json --mode spectral --png out.png
    python -m tpusky_torch render scene.xml -D spp=16 --device cpu

A scene file is Mitsuba XML or a JSON version of the `load_dict`
dictionary, read by `tpusky_torch.load_file`; `"to_world"` may be a
matrix, {"look_at": {origin, target, up}} or a {"transforms": [...]}
chain, applied first to last as XML's `<transform>` (the reference's CLI
composes a JSON chain the other way round, R22). The image is written as
a float32 EXR; `--png` also writes it tone-mapped (the 99.5th percentile
to 1, then the sRGB curve) through `utils/io.write_png`. The reference's
`bench` subcommand is not ported (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def cmd_render(args) -> int:
    import torch
    from . import load_file
    from .ops.spectrum import srgb_gamma
    from .utils.io import write_exr, write_png

    device = torch.device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}")
    t0 = time.perf_counter()
    overrides = dict(kv.split("=", 1) for kv in (args.define or []))
    bundle = load_file(args.scene, mode=args.mode, parameters=overrides,
                       device=device)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    img = bundle.render(seed=args.seed, spp=args.spp).cpu().numpy()
    render_s = time.perf_counter() - t0
    h, w = img.shape[:2]
    print(f"rendered {w}x{h} @ {args.spp or bundle.spp}spp "
          f"({bundle.integrator}, depth {bundle.max_depth}, {bundle.mode}) "
          f"in {render_s:.2f}s (loaded in {load_s:.2f}s)")
    path = args.output or "output.exr"
    write_exr(path, img, ["R", "G", "B"] if img.shape[-1] == 3 else None)
    print(f"wrote {path}")
    if args.png:
        scale_v = float(np.percentile(img, 99.5)) or 1.0
        tone = srgb_gamma(torch.from_numpy(
            np.ascontiguousarray(img[..., :3] / scale_v))).numpy()
        write_png(args.png, np.clip(tone, 0.0, 1.0))
        print(f"wrote {args.png}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpusky_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("render",
                        help="render a JSON or Mitsuba-XML scene file")
    rp.add_argument("scene")
    rp.add_argument("-D", "--define", action="append", metavar="KEY=VALUE",
                    help="override a scene $parameter (XML scenes)")
    rp.add_argument("-o", "--output", default=None, help="output EXR path")
    rp.add_argument("--png", default=None, help="also write a tonemapped PNG")
    rp.add_argument("--spp", type=int, default=None)
    rp.add_argument("--seed", type=int, default=0)
    rp.add_argument("--mode", default="rgb",
                    help="rgb, spectral or a Mitsuba variant name")
    rp.add_argument("--device", default="cuda",
                    help="torch device to render on (default: the card)")
    rp.set_defaults(fn=cmd_render)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
