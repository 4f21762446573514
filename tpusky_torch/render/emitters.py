"""Environment emitter: the sunsky sky dome (the sunsky part of
`tpusky/render/emitters.py`).

Directions here are world-space; the sunsky state's local frame is
reached through the scene's `env_to_world` rotation. In spectral mode
every call takes the lanes' hero `wavelengths` (..., W) in nm, a keyword
so that positional RGB callers are unchanged. `plain=True` runs the
sunsky model's plain versions instead of kernels K1-K3 (K9-K11 in
spectral mode), the reference the kernels and the megakernel are held
against.
"""

from __future__ import annotations

from ..models.sunsky import model as sunsky
from ..ops.math import mat3_apply, mat3_apply_t


def _check(env):
    if not isinstance(env, sunsky.SunskyState):
        raise NotImplementedError(f"environment {type(env).__name__}")


def env_eval(env, d_world, env_to_world, mode="rgb", plain=False,
             wavelengths=None):
    """Environment radiance toward world direction d (pointing at the sky)."""
    _check(env)
    return sunsky.eval(env, mat3_apply_t(env_to_world, d_world), mode=mode,
                       plain=plain, wavelengths=wavelengths)


def env_eval_pdf(env, d_world, env_to_world, mode="rgb",
                 pdf_detached=False, plain=False, wavelengths=None):
    """(radiance, solid-angle pdf) toward d_world: the emitter-hit MIS
    block (kernel K2, or K10 in spectral mode, for CUDA tensors)."""
    _check(env)
    return sunsky.eval_pdf(env, mat3_apply_t(env_to_world, d_world),
                           mode=mode, pdf_detached=pdf_detached, plain=plain,
                           wavelengths=wavelengths)


def env_sample_eval(env, env_to_world, sample2, mode="rgb",
                    pdf_detached=False, plain=False, wavelengths=None):
    """Importance-sample a world direction and evaluate its radiance + pdf:
    the NEE block (kernel K3, or K11 in spectral mode, for CUDA tensors).
    The direction comes back detached (sample placement)."""
    _check(env)
    d_local, rad, pdf = sunsky.sample_eval(env, sample2, mode=mode,
                                           pdf_detached=pdf_detached,
                                           plain=plain,
                                           wavelengths=wavelengths)
    return mat3_apply(env_to_world, d_local).detach(), rad, pdf
