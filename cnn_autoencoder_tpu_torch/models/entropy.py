"""Factorized entropy bottleneck: parameters and the cumulative-logit chain.

This slice needs the chain only to bake coding tables
(``coding.device_rans.bake_device_tables``), so it carries the parameters,
``logits_cumulative`` and ``medians_fn``; the likelihood and the quantile
fit wait for the training slice.  Parameters mirror the JAX package's
``fact_ent`` exactly: per channel, K+1 layers of (matrix, bias, factor) and
``quantiles`` (C, 1, 3).
"""

import math
from typing import Dict, Sequence

import torch
from torch import nn


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|));
    # torch's softplus (log1p(exp(x)) below a threshold) rounds differently
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def logits_cumulative(params: Dict[str, torch.Tensor], v: torch.Tensor,
                      num_filters: int) -> torch.Tensor:
    """The per-channel cumulative-logit chain on channel-last ``v``
    (..., C); returns the same shape."""
    x = v[..., None]  # (..., C, 1)
    for i in range(num_filters + 1):
        m = _softplus(params[f"matrix_{i}"])   # (C, f_out, f_in)
        b = params[f"bias_{i}"][:, :, 0]       # (C, f_out)
        x = torch.einsum("cof,...cf->...co", m, x) + b
        if i < num_filters:
            f = torch.tanh(params[f"factor_{i}"][:, :, 0])
            x = x + f * torch.tanh(x)
    return x[..., 0]


def medians_fn(params):
    """Per-channel medians (the middle quantile) of tensor or numpy
    parameters."""
    return params["quantiles"][:, 0, 1]


class EntropyParams(nn.Module):
    """Parameter holder of the factorized bottleneck (``fact_ent``)."""

    def __init__(self, channels: int, filters: Sequence[int] = (3, 3, 3, 3),
                 init_scale: float = 10.0):
        super().__init__()
        ext = (1,) + tuple(filters) + (1,)
        k = len(filters)
        scale = init_scale ** (1.0 / (k + 1))
        for i in range(k + 1):
            init_v = math.log(math.expm1(1.0 / scale / ext[i + 1]))
            self.register_parameter(f"matrix_{i}", nn.Parameter(torch.full(
                (channels, ext[i + 1], ext[i]), init_v)))
            self.register_parameter(f"bias_{i}", nn.Parameter(
                torch.empty(channels, ext[i + 1], 1).uniform_(-0.5, 0.5)))
            if i < k:
                self.register_parameter(f"factor_{i}", nn.Parameter(
                    torch.zeros(channels, ext[i + 1], 1)))
        init_q = torch.tensor([-init_scale, 0.0, init_scale])
        self.quantiles = nn.Parameter(init_q.repeat(channels, 1, 1))

    def params(self) -> Dict[str, torch.Tensor]:
        return {name: p for name, p in self.named_parameters()}
