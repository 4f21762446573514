"""`python -m tpusky_torch render scene.xml`: see `tpusky_torch.cli`."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
