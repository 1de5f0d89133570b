"""Loss objectives for the primal-dual solvers (counterpart of
cocoa_tpu/ops/losses.py: hinge, smooth_hinge, logistic, and the ``lasso``
prox rule of ProxCoCoA+).

Each loss acts on the margin z = y*(x.w):

- ``primal(z)``: the loss value;
- ``dual_term(a)``: -l*(-a), so the dual is -(lam/2)|w|^2 + sum/n;
- ``grad_factor(z)``: g(z) = -l'(z) in [0, 1], the factor the SGD and
  subgradient baselines accumulate as y*g*x;
- ``alpha_step(a, z, qii, lam_n)``: the SDCA single-coordinate update,
  with qii already sigma'-scaled by the caller.

``lasso`` is a prox rule, not a classification loss: it has an
``alpha_step`` only (no primal, dual term or gradient factor).

All functions are elementwise on tensors; scalars arrive as Python floats
or 0-d tensors of the working dtype.
"""

from __future__ import annotations

import torch

LOSSES = ("hinge", "smooth_hinge", "logistic")
# scalar prox rules of the primal (ProxCoCoA+) solver: alpha_step only
PROX_RULES = ("lasso",)
# the loss codes of the CUDA kernels (csrc/sdca_common.cuh)
LOSS_CODES = {"hinge": 0, "smooth_hinge": 1, "logistic": 2, "lasso": 3}

# logistic: the entropy dual needs a in (0, 1) strictly
_EPS = 1e-12
_U_MAX = 35.0  # |logit| cap: sigmoid(+-35) is exactly 0/1 in float32
_NEWTON_ITERS = 10


def validate(loss: str, smoothing=None) -> str:
    if loss not in LOSSES + PROX_RULES:
        raise ValueError(
            f"loss must be one of {LOSSES + PROX_RULES}, got {loss!r}")
    if loss == "smooth_hinge" and smoothing is not None and smoothing <= 0.0:
        raise ValueError(f"smooth_hinge needs smoothing > 0, got {smoothing}")
    if loss == "lasso" and smoothing is not None and smoothing < 0.0:
        raise ValueError(f"lasso's smoothing is the elastic-net l2 weight, "
                         f"needs >= 0, got {smoothing}")
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


def grad_factor(loss: str, z, smoothing: float = 1.0):
    """g(z) = -l'(z) in [0, 1]; hinge is active iff 1 - z > 0, as the
    reference's subgradient (SGD.scala:115,124: 0 at z = 1)."""
    if loss == "hinge":
        return torch.where(1.0 - z > 0.0, torch.ones_like(z),
                           torch.zeros_like(z))
    if loss == "smooth_hinge":
        return torch.clamp((1.0 - z) / smoothing, 0.0, 1.0)
    if loss == "logistic":
        # sigmoid(-z), stable in both tails
        return torch.where(z >= 0.0, torch.exp(-z) / (1.0 + torch.exp(-z)),
                           1.0 / (1.0 + torch.exp(z)))
    raise ValueError(f"unknown loss {loss!r}")


def alpha_step(loss: str, a, z, qii, lam_n, smoothing: float = 1.0):
    """New a in [0, 1] (CoCoA.scala:166-178 generalised), or for the
    ``lasso`` prox rule the new, unbounded coordinate value.

    - hinge: projected gradient against the box's active face; a
      vanishing projected gradient is a no-op; qii == 0 gives 1.
    - smooth_hinge: a <- clip(a - (z - 1 + s*a)*lam_n / (qii + s*lam_n)).
    - logistic: Newton on g(u) = u + z + q*(sigmoid(u) - a) = 0 in logit
      space u, q = qii/lam_n; g' >= 1, and the sigmoid keeps the box.
    - lasso (mode ``prox``): ``a`` is the coordinate x_j + dx_j, ``z`` the
      sigma'-corrected gradient a_j.(r0 + sigma'*dv), ``qii`` =
      sigma'*|a_j|^2, ``lam_n`` the L1 weight and ``smoothing`` the
      elastic-net l2 weight s; the soft-threshold step
      t* = S_{lam/(qii+s)}((qii*a - z)/(qii+s)), no box, and a zero column
      with s = 0 is a no-op.
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
    if loss == "lasso":
        denom = qii + smoothing
        live = denom > 0.0
        safe = torch.where(live, denom, torch.ones_like(denom))
        u = (qii * a - z) / safe
        t = torch.sign(u) * torch.clamp(u.abs() - lam_n / safe, min=0.0)
        return torch.where(live, t, a)
    raise ValueError(f"unknown loss {loss!r}")
