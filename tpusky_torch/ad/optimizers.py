"""Gradient-based optimizers for inverse rendering.

The PyTorch counterpart of `tpusky/ad/optimizers.py` (reference Mitsuba
`src/python/python/ad/optimizers.py`): `SGD` with optional momentum and
`Adam` with the reference's `mask_updates` and `uniform` variants, on
dicts of tensors with the reference package's functional protocol:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = {k: params[k] + updates[k] for k in params}

Per-parameter learning rates are set by name with `set_learning_rate`
(reference `optimizers.py:71-86`). Updates are computed without autograd.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _check_dict(tree, what: str):
    if not isinstance(tree, dict):
        raise TypeError(f"{what}: expected a dict of tensors, got "
                        f"{type(tree).__name__}")


class Optimizer:
    """Base class: learning-rate bookkeeping shared by SGD and Adam."""

    def __init__(self, lr: float):
        if lr < 0:
            raise ValueError("learning rate must be >= 0")
        self.lr = float(lr)
        self.lr_per_param: Dict[str, float] = {}

    def set_learning_rate(self, lr=None, **kwargs) -> None:
        """Set the default rate (float arg) and/or per-parameter rates by
        name (keyword args)."""
        if lr is not None:
            self.lr = float(lr)
        for k, v in kwargs.items():
            self.lr_per_param[k] = float(v)

    def _leaf_lr(self, name: Optional[str]) -> float:
        return self.lr_per_param.get(name, self.lr)

    def step(self, params, grads, state=None):
        """(params + update, new state); the stateful convenience form."""
        state = self.init(params) if state is None else state
        updates, state = self.update(grads, state, params)
        return {k: params[k] + updates[k] for k in params}, state


class SGD(Optimizer):
    """Stochastic gradient descent with optional momentum
    (reference `optimizers.py:168-186`):
        v <- momentum * v + g;  p <- p - lr * v."""

    def __init__(self, lr: float, momentum: float = 0.0):
        super().__init__(lr)
        if not (0.0 <= momentum < 1.0):
            raise ValueError("momentum must be in [0, 1)")
        self.momentum = float(momentum)

    def init(self, params):
        _check_dict(params, "SGD.init")
        return {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, grads, state, params=None):
        """Returns (updates, new_state); apply with p + u."""
        _check_dict(grads, "SGD.update")
        if self.momentum == 0.0:
            return {k: -self._leaf_lr(k) * g for k, g in grads.items()}, state
        new_s = {k: self.momentum * state[k] + g for k, g in grads.items()}
        return {k: -self._leaf_lr(k) * v for k, v in new_s.items()}, new_s


class Adam(Optimizer):
    """Adam (Kingma & Ba 2015) with the reference's two extensions
    (`optimizers.py:204-300`):

    - `mask_updates`: moments and the bias-correction step count advance
      only where the gradient is nonzero;
    - `uniform`: the per-tensor max of the second moment replaces the
      per-element one (UniformAdam, Nicolet et al. 2021).
    """

    def __init__(self, lr: float, beta_1: float = 0.9, beta_2: float = 0.999,
                 epsilon: float = 1e-8, mask_updates: bool = False,
                 uniform: bool = False):
        super().__init__(lr)
        if not (0 <= beta_1 < 1 and 0 <= beta_2 < 1):
            raise ValueError("betas must be in [0, 1)")
        self.beta_1, self.beta_2 = float(beta_1), float(beta_2)
        self.epsilon = float(epsilon)
        self.mask_updates = bool(mask_updates)
        self.uniform = bool(uniform)

    def init(self, params):
        """Per-parameter (m, v, t); t is per-element under mask_updates,
        else a scalar."""
        _check_dict(params, "Adam.init")
        return {k: (torch.zeros_like(p), torch.zeros_like(p),
                    torch.zeros(p.shape if self.mask_updates else (),
                                dtype=torch.float32, device=p.device))
                for k, p in params.items()}

    def _leaf_update(self, g, st, lr):
        m, v, t = st
        b1, b2, eps = self.beta_1, self.beta_2, self.epsilon
        if self.mask_updates:
            nz = g != 0
            t = t + nz.to(t.dtype)
            m = torch.where(nz, b1 * m + (1 - b1) * g, m)
            v = torch.where(nz, b2 * v + (1 - b2) * g * g, v)
            tc = t.clamp(min=1.0)
        else:
            t = t + 1.0
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            tc = t
        m_hat = m / (1 - b1 ** tc)
        v_hat = v / (1 - b2 ** tc)
        if self.uniform:
            denom = torch.sqrt(v_hat.max()) + eps
        else:
            denom = torch.sqrt(v_hat) + eps
        u = -lr * m_hat / denom
        if self.mask_updates:
            u = torch.where(g != 0, u, 0.0)
        return u, (m, v, t)

    @torch.no_grad()
    def update(self, grads, state, params=None):
        """Returns (updates, new_state); apply with p + u."""
        _check_dict(grads, "Adam.update")
        out = {k: self._leaf_update(g, state[k], self._leaf_lr(k))
               for k, g in grads.items()}
        return ({k: u for k, (u, _) in out.items()},
                {k: s for k, (_, s) in out.items()})
