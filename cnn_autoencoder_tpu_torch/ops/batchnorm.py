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

Data-parallel training (``training/loop.py:make_train_step(group=)``) sets
``group`` on every batch norm of the model: the train-mode statistics are
then the global batch's, as under a JAX mesh, from sums and sums of squares
all-reduced over the group's ranks with a differentiable all-reduce, so
the backward sums across ranks too; every rank folds the same running
statistics.

Under the model mesh axis (``parallel/mesh.py:shard_model``) ``scale``,
``bias``, ``mean`` and ``var`` may be held as the rank's channel slices.
The layer's input is whole (the convolution before it gathers its
channels), so it gathers ``scale`` and ``bias`` (and in eval mode the
running statistics) and normalizes every channel as one process does;
``group`` is then the data group, so the batch's statistics are the
global batch's and the same on every rank of a model group, and the new
running values the layer records are the rank's slice of them.
"""

from typing import Dict, Optional

import torch
from torch import nn

from ..parallel.distributed import all_sum, full_param, param_shard

MOMENTUM, EPSILON = 0.9, 1e-5


def batch_statistics(x: torch.Tensor, group=None):
    """(mean, biased variance) over every axis but the last, in float32;
    with a process group, over every rank's ``x`` (equal shares)."""
    x32 = x.float()
    dims = tuple(range(x.dim() - 1))
    if group is None:
        mean = x32.mean(dims)
        mean2 = (x32 * x32).mean(dims)
    else:
        sums = all_sum(torch.stack([x32.sum(dims), (x32 * x32).sum(dims)]),
                       group)
        count = x32.numel() // x32.shape[-1] * torch.distributed \
            .get_world_size(group)
        mean, mean2 = sums[0] / count, sums[1] / count
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
        self.group = None  # the data-parallel process group, if any
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
        scale, bias = full_param(self, "scale"), full_param(self, "bias")
        if not train:
            return normalize(x, full_param(self, "mean"),
                             full_param(self, "var"), scale, bias,
                             self.epsilon)
        mean, var = batch_statistics(x, self.group)
        if batch_stats is not None:
            m, shard = self.momentum, param_shard(self, "mean")
            own = ((mean, var) if shard is None
                   else (shard.narrow(mean), shard.narrow(var)))
            batch_stats[self] = (
                (m * self.mean + (1 - m) * own[0]).detach(),
                (m * self.var + (1 - m) * own[1]).detach())
        return normalize(x, mean, var, scale, bias, self.epsilon)
