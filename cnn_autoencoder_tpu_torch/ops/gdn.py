"""Generalized Divisive Normalization (GDN / IGDN) on channel-last tensors.

``y[c] = x[c] / sqrt(beta[c] + sum_k gamma[c, k] x[k]^2)`` (inverse:
multiply).  Parameters are stored reparameterized (``ops.bounds``), as in the
JAX package, so checkpoint values carry over as stored.

The layer routes by the activations' dtype, which is how the port states
the JAX package's compute mode (``convops.set_default_precision``), and by
whether a gradient is wanted:

* float32: ``fused_gdn`` (K1 forward; the backward differentiates the
  recomputed plain GDN), the norm pool in full float32;
* bf16, no gradient wanted (bf16 serving): ``fused_gdn`` on bf16 rows (K1
  on bf16 rows), the pool at ``norm_pool_precision``, as the JAX package
  serves bf16 through its ``fused_gdn`` (``ops/gdn.py:172-180`` there);
* bf16 with a gradient (bf16 training): ``gdn_mixed`` (K2 forward, K3
  backward), the JAX package's ``ops/gdn.py:gdn_mixed`` with the training
  kernels on: bf16 residuals, the pool at ``norm_pool_precision``,
  ``dgamma`` and ``dbeta`` as contractions over the kernel's bf16 ``dnb``.
"""

import torch
from torch import nn

from ..utils.device import full_f32
from .bounds import nonneg_init, nonneg_param
from .kernels.gdn_kernel import (fused_gdn, gdn_train_bwd, gdn_train_fwd,
                                 norm_pool_precision)

__all__ = ["GDN", "gdn_mixed", "norm_pool_precision"]


class _GDNMixed(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2d, gamma, beta, inverse):
        y, rb = gdn_train_fwd(x2d, gamma, beta, inverse)
        # bf16 residuals: the backward reads half the bytes
        ctx.save_for_backward(x2d.to(torch.bfloat16), gamma, rb)
        ctx.inverse = inverse
        return y

    @staticmethod
    def backward(ctx, g):
        xb, gamma, rb = ctx.saved_tensors
        dx, dnb = gdn_train_bwd(g.contiguous(), xb, rb, gamma, ctx.inverse)
        dnb32 = dnb.float()
        # dbeta from the kernel's dnb (the JAX kernel path, ops/gdn.py:103
        # there); dgamma over dnb and bf16(xb * xb), float32 sums
        dbeta = dnb32.sum(0)
        with full_f32():
            dgamma = torch.matmul(dnb32.t(), (xb * xb).float())
        return dx, dgamma, dbeta, None


def gdn_mixed(x2d: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              inverse: bool = False) -> torch.Tensor:
    """GDN over (N, C) rows with the analytic mixed-precision backward; the
    output and the input's gradient keep the rows' dtype."""
    return _GDNMixed.apply(x2d, gamma, beta, inverse)


class GDN(nn.Module):

    def __init__(self, channels: int, inverse: bool = False,
                 beta_min: float = 1e-6, gamma_init: float = 0.1):
        super().__init__()
        self.inverse = inverse
        self.beta_min = beta_min
        self.beta = nn.Parameter(nonneg_init(torch.ones(channels)))
        # gamma[out, in], the orientation of the reference's 1x1 conv weight
        self.gamma = nn.Parameter(nonneg_init(gamma_init
                                              * torch.eye(channels)))

    def effective_params(self):
        """(gamma, beta) after the non-negative reparameterization."""
        return (nonneg_param(self.gamma, 0.0),
                nonneg_param(self.beta, self.beta_min))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.effective_params()
        c = x.shape[-1]
        rows = x.reshape(-1, c).contiguous()
        wants_grad = torch.is_grad_enabled() and (
            rows.requires_grad or gamma.requires_grad or beta.requires_grad)
        if x.dtype == torch.bfloat16 and wants_grad:
            out = gdn_mixed(rows, gamma, beta, self.inverse)
        else:
            out = fused_gdn(rows, gamma, beta, self.inverse)
        return out.reshape(x.shape)
