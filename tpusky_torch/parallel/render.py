"""Inverse-rendering training step on one device.

The single-device part of `tpusky/parallel/render.py`:
`make_train_step_single` builds a step that re-derives the scene from the
parameters (the sunsky precompute included), renders it through the
wavefront path, takes the loss against a target image, differentiates it
with torch autograd (K2/K3 forward and K5/K6 backward on the card) and
applies the port's own optimizer (`tpusky_torch.ad.optimizers`).
Sharding over several devices is not ported.
"""

from __future__ import annotations

import torch

from ..render import film as film_mod
from ..render import integrator
from ..render.bsdf import table_kinds

LOSS_KINDS = ("l2", "rel_l2", "log_l2", "log_l2_blur", "log_l2_nodisc")


def _loss_kind(loss) -> str:
    kind = loss[0] if isinstance(loss, tuple) else loss
    if kind not in LOSS_KINDS:
        raise ValueError(f"unknown loss kind {kind!r}; expected one of "
                         f"{', '.join(LOSS_KINDS)}")
    return kind


def _blur_matrix(m: int, sigma: float, like):
    """Row-normalised (m, m) gaussian of `sigma` pixels."""
    r = torch.arange(m, dtype=torch.float32, device=like.device)
    b = torch.exp(-0.5 * ((r[:, None] - r[None, :]) / sigma) ** 2)
    return b / b.sum(1, keepdim=True)


def _blur(x, bh, bw):
    """Separable blur of an (H, W, C) image by two float32 products."""
    h, w, c = x.shape
    x = torch.matmul(bh, x.reshape(h, w * c)).reshape(h, w, c)
    return torch.matmul(bw, x)


def image_loss(img, target, loss="l2"):
    """The loss kinds of the reference package's `make_train_step_single`
    (`tpusky/parallel/render.py:178-259`); `loss` is a kind or the tuple
    ("log_l2_blur", sigma_px, weight)."""
    kind = _loss_kind(loss)
    if kind == "log_l2_nodisc":
        # log-space MSE with the target's sun-disc neighbourhood (its hot
        # pixels, dilated by a sigma = H/64 blur) masked out
        li = torch.log1p(img.clamp(min=0.0))
        lt = torch.log1p(target.clamp(min=0.0))
        hot = (target.detach().sum(-1) > 200.0).to(li.dtype)
        b = _blur_matrix(li.shape[0], li.shape[0] / 64.0, li)
        spread = torch.matmul(b, torch.matmul(hot, b.T))
        keep = (spread <= 1e-4 * spread.max()).to(li.dtype)[..., None]
        return ((keep * (li - lt) ** 2).sum()
                / (keep.sum() * li.shape[-1]).clamp(min=1.0))
    if kind == "rel_l2":
        den = target.detach() ** 2 + 1e-3
        return ((img - target) ** 2 / den).mean()
    if kind in ("log_l2", "log_l2_blur"):
        li = torch.log1p(img.clamp(min=0.0))
        lt = torch.log1p(target.clamp(min=0.0))
        out = ((li - lt) ** 2).mean()
        if kind == "log_l2_blur":
            if isinstance(loss, tuple):
                _, sigma, weight = loss
            else:
                sigma, weight = None, 16.0
            sigma = sigma if sigma is not None else li.shape[0] / 32.0
            bh = _blur_matrix(li.shape[0], sigma, li)
            bw = _blur_matrix(li.shape[1], sigma, li)
            out = out + weight * ((_blur(li, bh, bw)
                                   - _blur(lt, bh, bw)) ** 2).mean()
        return out
    return ((img - target) ** 2).mean()


def make_train_step_single(scene_builder, sensor, film_cfg, spp, optimizer,
                           max_depth: int = 2, mode: str = "rgb",
                           project=None, loss="l2"):
    """Single-device inverse-rendering step.

    `scene_builder(params) -> Scene` re-derives the scene from a dict of
    parameter tensors; `optimizer` follows the init/update protocol of
    `tpusky_torch.ad.optimizers`. Returns
    step(opt_state, params, target, seed) -> (opt_state, params, loss),
    where `seed` is the sampler's integer seed.
    """
    _loss_kind(loss)
    # the blur is two float32 products; TF32 (about three decimal digits)
    # would differ from the reference package's HIGHEST-precision einsums
    torch.backends.cuda.matmul.allow_tf32 = False

    def loss_fn(params, target, seed):
        scene = scene_builder(params)
        img = film_mod.develop(integrator.render_rows(
            scene, sensor, film_cfg, seed, spp, max_depth, 1000, mode, 0,
            film_cfg.height, kinds=table_kinds(scene.bsdfs)))
        return image_loss(img, target, loss)

    def step(opt_state, params, target, seed):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        value = loss_fn(leaves, target, seed)
        grads = torch.autograd.grad(value, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), grads)}
        updates, opt_state = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            params = {k: params[k] + updates[k] for k in params}
        if project is not None:
            params = project(params)
        return opt_state, params, value.detach()

    return step
