"""Loss objectives for the primal-dual solvers (counterpart of
cocoa_tpu/ops/losses.py: hinge, smooth_hinge, logistic).

Each loss acts on the margin z = y*(x.w):

- ``primal(z)``: the loss value;
- ``dual_term(a)``: -l*(-a), so the dual is -(lam/2)|w|^2 + sum/n;
- ``alpha_step(a, z, qii, lam_n)``: the SDCA single-coordinate update,
  with qii already sigma'-scaled by the caller.

All functions are elementwise on tensors; scalars arrive as Python floats
or 0-d tensors of the working dtype.
"""

from __future__ import annotations

import torch

LOSSES = ("hinge", "smooth_hinge", "logistic")

# logistic: the entropy dual needs a in (0, 1) strictly
_EPS = 1e-12
_U_MAX = 35.0  # |logit| cap: sigmoid(+-35) is exactly 0/1 in float32
_NEWTON_ITERS = 10


def validate(loss: str, smoothing=None) -> str:
    if loss not in LOSSES:
        raise ValueError(f"loss must be one of {LOSSES}, got {loss!r}")
    if loss == "smooth_hinge" and smoothing is not None and smoothing <= 0.0:
        raise ValueError(f"smooth_hinge needs smoothing > 0, got {smoothing}")
    return loss


def primal(loss: str, z, smoothing: float = 1.0):
    if loss == "hinge":
        return torch.clamp(1.0 - z, min=0.0)
    if loss == "smooth_hinge":
        s = smoothing
        gap = 1.0 - z
        return torch.where(
            gap <= 0.0, torch.zeros_like(z),
            torch.where(gap >= s, gap - 0.5 * s, 0.5 * gap * gap / s))
    if loss == "logistic":
        return torch.logaddexp(torch.zeros_like(z), -z)
    raise ValueError(f"unknown loss {loss!r}")


def dual_term(loss: str, a, smoothing: float = 1.0):
    if loss == "hinge":
        return a
    if loss == "smooth_hinge":
        return a - 0.5 * smoothing * a * a
    if loss == "logistic":
        # xlogy gives 0*log0 = 0 at the box corners
        ac = torch.clamp(a, 0.0, 1.0)
        return -(torch.special.xlogy(ac, ac)
                 + torch.special.xlogy(1.0 - ac, 1.0 - ac))
    raise ValueError(f"unknown loss {loss!r}")


def alpha_step(loss: str, a, z, qii, lam_n, smoothing: float = 1.0):
    """New a in [0, 1] (CoCoA.scala:166-178 generalised).

    - hinge: projected gradient against the box's active face; a
      vanishing projected gradient is a no-op; qii == 0 gives 1.
    - smooth_hinge: a <- clip(a - (z - 1 + s*a)*lam_n / (qii + s*lam_n)).
    - logistic: Newton on g(u) = u + z + q*(sigmoid(u) - a) = 0 in logit
      space u, q = qii/lam_n; g' >= 1, and the sigmoid keeps the box.
    """
    if loss == "hinge":
        grad = (z - 1.0) * lam_n
        zero = torch.zeros_like(grad)
        proj_grad = torch.where(
            a <= 0.0, torch.minimum(grad, zero),
            torch.where(a >= 1.0, torch.maximum(grad, zero), grad))
        safe_qii = torch.where(qii != 0.0, qii, torch.ones_like(qii))
        new_a = torch.where(qii != 0.0,
                            torch.clamp(a - grad / safe_qii, 0.0, 1.0),
                            torch.ones_like(a))
        return torch.where(proj_grad != 0.0, new_a, a)
    if loss == "smooth_hinge":
        s = smoothing
        grad = (z - 1.0 + s * a) * lam_n
        return torch.clamp(a - grad / (qii + s * lam_n), 0.0, 1.0)
    if loss == "logistic":
        ac = torch.clamp(a, _EPS, 1.0 - _EPS)
        q = qii / lam_n
        u = torch.clamp(torch.log(ac / (1.0 - ac)), -_U_MAX, _U_MAX)
        for _ in range(_NEWTON_ITERS):
            sig = 1.0 / (1.0 + torch.exp(-u))
            g = u + z + q * (sig - ac)
            gp = 1.0 + q * sig * (1.0 - sig)
            u = torch.clamp(u - g / gp, -_U_MAX, _U_MAX)
        return 1.0 / (1.0 + torch.exp(-u))
    raise ValueError(f"unknown loss {loss!r}")
