"""Generalized Divisive Normalization (GDN / IGDN) on channel-last tensors.

``y[c] = x[c] / sqrt(beta[c] + sum_k gamma[c, k] x[k]^2)`` (inverse:
multiply).  Parameters are stored reparameterized (``ops.bounds``), as in the
JAX package, so checkpoint values carry over as stored.  The f32 rule of the
JAX package's ``norm_pool_precision`` is full float32 for the norm pool: the
kernel uses CUDA-core float32 FMAs and the plain version runs with TF32 off.
"""

import torch
from torch import nn

from .bounds import nonneg_init, nonneg_param
from .kernels.gdn_kernel import fused_gdn


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
        return fused_gdn(rows, gamma, beta, self.inverse).reshape(x.shape)
