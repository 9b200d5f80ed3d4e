"""Batch normalization over the channels of NHWC tensors: flax's
``nn.BatchNorm`` as the JAX package's units configure it
(``models/autoencoder.py``: ``momentum=0.9, epsilon=1e-5``, the last axis
the features).

* Train mode normalizes by the batch's statistics over (N, H, W), taken in
  float32: the mean and the biased variance as E[x^2] - E[x]^2, clipped at
  0 (flax 0.12's ``use_fast_variance``).
* Eval mode normalizes by the running statistics.
* ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, whatever
  x's type: flax promotes x with its float32 parameters, so a bf16 input
  gives a float32 output.
* The running statistics move as flax moves them, keeping ``momentum`` of
  the old value: ``mean <- 0.9 mean + 0.1 batch mean`` and the same for
  the (biased) variance.  torch's ``F.batch_norm`` weighs the other way and
  updates the variance with the unbiased estimate, so it is not used.

``scale`` and ``bias`` are parameters, ``mean`` and ``var`` buffers.  The
layer never writes its buffers in its forward: in train mode it records the
new running values in the caller's ``batch_stats`` dict (keyed by the
layer), and the train step folds them in once after the forward, as the
JAX step folds the ``batch_stats`` collection that ``apply`` returns
mutated.  A forward recomputed under ``torch.utils.checkpoint`` records
them again into the same dict, which is read only once.
"""

from typing import Dict, Optional

import torch
from torch import nn

MOMENTUM, EPSILON = 0.9, 1e-5


def batch_statistics(x: torch.Tensor):
    """(mean, biased variance) over every axis but the last, in float32."""
    x32 = x.float()
    dims = tuple(range(x.dim() - 1))
    mean = x32.mean(dims)
    mean2 = (x32 * x32).mean(dims)
    return mean, torch.clamp_min(mean2 - mean * mean, 0.0)


def normalize(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
              scale: torch.Tensor, bias: torch.Tensor,
              epsilon: float = EPSILON) -> torch.Tensor:
    """flax's ``_normalize``: float32 out."""
    return (x.float() - mean) * (torch.rsqrt(var + epsilon) * scale) + bias


class BatchNorm(nn.Module):

    def __init__(self, channels: int, momentum: float = MOMENTUM,
                 epsilon: float = EPSILON):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("mean", torch.empty(channels))
        self.register_buffer("var", torch.empty(channels))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        """flax's initial values: scale 1, bias 0, mean 0, var 1."""
        del generator  # nothing is drawn
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False,
                batch_stats: Optional[Dict] = None) -> torch.Tensor:
        if not train:
            return normalize(x, self.mean, self.var, self.scale, self.bias,
                             self.epsilon)
        mean, var = batch_statistics(x)
        if batch_stats is not None:
            m = self.momentum
            batch_stats[self] = (
                (m * self.mean + (1 - m) * mean).detach(),
                (m * self.var + (1 - m) * var).detach())
        return normalize(x, mean, var, self.scale, self.bias, self.epsilon)
