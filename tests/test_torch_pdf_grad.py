"""The wrappers' routing with the attached pdf (the adjoints K7 and K8):
on the CPU the plain versions, on another device a refusal.

The adjoints' plain versions against the JAX package are in
tests/test_torch_pdf_grad_{hit,nee}.py (shared code in
`torch_pdf_grad_case.py`), files of at most 3 items that pytest-xdist's
`--dist loadfile` hands out after tests/test_multihost.py.
"""

import pytest
import torch

import tpusky_torch as tt
from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.ops.cuda import build
from tpusky_torch.ops.cuda import sunsky_kernel as TK

from torch_pdf_grad_case import SUN, _leaf_state, case  # noqa: F401

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the wrappers with the pdf attached
# ---------------------------------------------------------------------------


def test_wrappers_with_attached_pdf_take_plain_versions_on_cpu(case):
    """On the CPU the wrappers run the plain versions with the pdf
    attached (RGB and spectral): the same values and the same gradients,
    nothing launched, the kernel library never built."""
    _js, st, d, u2, g_rad, g_pdf = case
    build.reset_launches()
    leaf = _leaf_state(st)
    d_t = torch.tensor(d)
    rad, pdf = TK.sunsky_hit_rgb(leaf, d_t, pdf_detached=False)
    rad_p, pdf_p = TM._hit_rgb_plain(leaf, d_t)
    assert torch.equal(rad, rad_p) and torch.equal(pdf, pdf_p)
    gw = torch.autograd.grad((pdf * torch.tensor(g_pdf)).sum(),
                             [leaf.gaussians, leaf.sky_sampling_w])
    gw_p = torch.autograd.grad((pdf_p * torch.tensor(g_pdf)).sum(),
                               [leaf.gaussians, leaf.sky_sampling_w])
    assert all(torch.equal(a, b) for a, b in zip(gw, gw_p))
    u_t = torch.tensor(u2)
    for a, b in zip(TK.sunsky_nee_rgb(leaf, u_t, pdf_detached=False),
                    TM._sample_eval_rgb_plain(leaf, u_t)):
        assert torch.equal(a, b)
    spec = tt.sunsky_precompute(tt.make_params(
        sun_direction=SUN, mode="spectral", device="cpu"), mode="spectral")
    wl = torch.full((400, 4), 550.0)
    for a, b in zip(TK.sunsky_hit_spec(spec, d_t, wl, pdf_detached=False),
                    TM._hit_spec_plain(spec, d_t, wl)):
        assert torch.equal(a, b)
    for a, b in zip(TK.sunsky_nee_spec(spec, u_t, wl, pdf_detached=False),
                    TM._sample_eval_spec_plain(spec, u_t, wl)):
        assert torch.equal(a, b)
    # the emitter API keeps the pdf attached unless asked to detach it
    assert TM.eval_pdf(leaf, d_t)[1].requires_grad
    assert not TM.eval_pdf(leaf, d_t, pdf_detached=True)[1].requires_grad
    assert TM.sample_eval(spec._replace(
        gaussians=spec.gaussians.clone().requires_grad_()), u_t,
        mode="spectral", wavelengths=wl)[2].requires_grad
    assert all(v == 0 for v in build.launches.values())
    assert build.library.cache_info().currsize == 0


@pytest.mark.parametrize("call", ["hit_rgb", "nee_rgb", "hit_spec",
                                  "nee_spec"])
def test_wrappers_with_attached_pdf_refuse_other_devices(case, call):
    """A tensor that is neither on the CPU nor on a CUDA device is refused
    with the pdf attached too, never routed to the plain version."""
    _js, st, *_ = case
    d, u2 = torch.empty((8, 3), device="meta"), torch.empty((8, 2),
                                                            device="meta")
    wl = torch.empty((8, 4), device="meta")
    run = {"hit_rgb": lambda: TK.sunsky_hit_rgb(st, d, pdf_detached=False),
           "nee_rgb": lambda: TK.sunsky_nee_rgb(st, u2, pdf_detached=False),
           "hit_spec": lambda: TK.sunsky_hit_spec(st, d, wl,
                                                  pdf_detached=False),
           "nee_spec": lambda: TK.sunsky_nee_spec(st, u2, wl,
                                                  pdf_detached=False)}
    with pytest.raises(ValueError, match="CUDA"):
        run[call]()
