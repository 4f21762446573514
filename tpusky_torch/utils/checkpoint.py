"""Checkpoint and resume of inverse-rendering loops
(`tpusky/utils/checkpoint.py`).

An atomic pickle of a nested structure (dicts, lists, tuples, NamedTuples)
whose tensors are moved to the host as numpy arrays first, so a checkpoint
does not depend on the device that wrote it. `load_checkpoint` gives the
arrays back; `torch.as_tensor(a, device=...)` puts each where it is
needed.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return type(x)((k, _to_host(v)) for k, v in x.items())
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return np.asarray(x) if isinstance(x, (int, float, np.number)) else x


def save_checkpoint(path: str, state) -> None:
    """Save `state` (atomic rename: a crash leaves the old file whole)."""
    host = _to_host(state)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(host, f)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """A checkpoint saved by `save_checkpoint`, None if there is none."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return pickle.load(f)
