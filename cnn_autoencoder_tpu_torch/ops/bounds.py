"""Straight-through bounds and the non-negative reparameterization of the
GDN parameters.

``lower_bound(x, b)`` is ``max(x, b)`` whose gradient passes wherever
``x >= b`` or the incoming gradient is negative (it would push ``x`` up),
so a parameter at its bound is never stuck there; ``upper_bound`` mirrors
it.  ``torch.clamp_min`` would zero the gradient below the bound, which is
a different training rule.  Counterparts of the JAX package's
``ops/bounds.py:19-83``.

A parameter ``v`` is stored as ``s = sqrt(max(v + pedestal, pedestal))`` and
recovered as ``lower_bound(s, bound)**2 - pedestal`` with
``bound = sqrt(minimum + pedestal)``, the same form the JAX package and the
reference use, so stored checkpoint values evaluate identically.
"""

import torch

REPARAM_OFFSET = 2.0 ** -18


class _LowerBound(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x >= ctx.bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


class _UpperBound(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_max(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        pass_through = (x <= ctx.bound) | (g > 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``max(x, bound)`` with the straight-through gradient."""
    return _LowerBound.apply(x, bound)


def upper_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``min(x, bound)`` with the mirrored straight-through gradient."""
    return _UpperBound.apply(x, bound)


def nonneg_init(value: torch.Tensor) -> torch.Tensor:
    """Map a desired (non-negative) value to its stored form."""
    pedestal = REPARAM_OFFSET ** 2
    return torch.sqrt(torch.clamp_min(value + pedestal, pedestal))


def nonneg_param(stored: torch.Tensor, minimum: float = 0.0) -> torch.Tensor:
    """Recover the effective non-negative value from its stored form."""
    pedestal = REPARAM_OFFSET ** 2
    bound = (minimum + pedestal) ** 0.5
    out = lower_bound(stored, bound)
    return out * out - pedestal
