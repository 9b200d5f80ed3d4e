"""Non-negative reparameterization of the GDN parameters (forward only).

A parameter ``v`` is stored as ``s = sqrt(max(v + pedestal, pedestal))`` and
recovered as ``max(s, bound)**2 - pedestal`` with
``bound = sqrt(minimum + pedestal)``, the same form the JAX package and the
reference use, so stored checkpoint values evaluate identically.  The
straight-through gradient of ``max`` waits for the training slice.
"""

import torch

REPARAM_OFFSET = 2.0 ** -18


def nonneg_init(value: torch.Tensor) -> torch.Tensor:
    """Map a desired (non-negative) value to its stored form."""
    pedestal = REPARAM_OFFSET ** 2
    return torch.sqrt(torch.clamp_min(value + pedestal, pedestal))


def nonneg_param(stored: torch.Tensor, minimum: float = 0.0) -> torch.Tensor:
    """Recover the effective non-negative value from its stored form."""
    pedestal = REPARAM_OFFSET ** 2
    bound = (minimum + pedestal) ** 0.5
    out = torch.clamp_min(stored, bound)
    return out * out - pedestal
