"""Factorized entropy bottleneck (``fact_ent``): parameters, the
cumulative-logit chain, the likelihood, the auxiliary quantile loss and the
bisection quantile fit.

Parameters mirror the JAX package's ``models/entropy.py`` exactly: per
channel, K+1 layers of (matrix, bias, factor) and ``quantiles`` (C, 1, 3).
Two forms of the chain, as there: ``logits_cumulative`` (einsum over the
filter axis; CDF baking, the auxiliary loss and the quantile fit) and
``logits_cumulative_unrolled`` (per-(out, in) multiply-adds; the
likelihood), which round differently at about 1e-7.

Training quantizes with additive uniform noise.  The JAX package draws it
from ``jax.random``; the port draws it from an explicit ``torch.Generator``
or takes it from the caller, so a test can give both packages the same
noise.

``update_cdf_tables`` bakes the host coder's 16-bit tables on the host, as
the JAX package's does, bit for bit (``coding/xla_f32.py``).
"""

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..coding import xla_f32
from ..coding.cdf import pmf_to_quantized_cdf
from ..ops.bounds import lower_bound


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


def logits_cumulative_unrolled(params: Dict[str, torch.Tensor],
                               v: torch.Tensor,
                               num_filters: int) -> torch.Tensor:
    """The same chain unrolled over the filter axes into elementwise
    multiply-adds on (..., C) tensors (``_logits_cumulative_unrolled``
    there).  A bf16 ``v`` is promoted to float32 by the float32
    parameters."""
    xs = [v]
    for i in range(num_filters + 1):
        m = _softplus(params[f"matrix_{i}"])   # (C, f_out, f_in)
        b = params[f"bias_{i}"][:, :, 0]       # (C, f_out)
        outs = []
        for o in range(m.shape[1]):
            acc = b[:, o]
            for f, xf in enumerate(xs):
                acc = acc + m[:, o, f] * xf
            outs.append(acc)
        if i < num_filters:
            fac = torch.tanh(params[f"factor_{i}"][:, :, 0])
            outs = [y + fac[:, o] * torch.tanh(y) for o, y in enumerate(outs)]
        xs = outs
    return xs[0]


def likelihood_fn(params: Dict[str, torch.Tensor], v: torch.Tensor,
                  num_filters: int,
                  likelihood_bound: float = 1e-9) -> torch.Tensor:
    """P(round(v)) under the factorized density; ``v`` channel-last.  The
    interval's sign is a constant of the gradient, and the likelihood is
    held above ``likelihood_bound`` with the straight-through bound."""
    # both interval edges in one chain evaluation, in v's dtype as there
    both = logits_cumulative_unrolled(
        params, torch.stack([v - 0.5, v + 0.5]), num_filters)
    lower, upper = both[0], both[1]
    sign = -torch.sign(lower + upper).detach()
    likelihood = torch.abs(torch.sigmoid(sign * upper)
                           - torch.sigmoid(sign * lower))
    if likelihood_bound > 0:
        likelihood = lower_bound(likelihood, likelihood_bound)
    return likelihood


def aux_loss_fn(params: Dict[str, torch.Tensor], num_filters: int,
                tail_mass: float = 1e-9) -> torch.Tensor:
    """Quantile-fitting auxiliary loss (the reference's ``fact_ent.loss()``):
    the chain's parameters are held constant, only ``quantiles`` moves."""
    target = math.log(2.0 / tail_mass - 1.0)
    q = params["quantiles"][:, 0, :]            # (C, 3)
    targets = torch.tensor([-target, 0.0, target], dtype=torch.float32,
                           device=q.device)
    held = {k: v.detach() for k, v in params.items() if k != "quantiles"}
    logits = logits_cumulative(held, q.t(), num_filters)
    return torch.abs(logits - targets[:, None]).sum()


def medians_fn(params):
    """Per-channel medians (the middle quantile) of tensor or numpy
    parameters."""
    return params["quantiles"][:, 0, 1]


def fit_quantiles_bisect(params: Dict[str, torch.Tensor], num_filters: int,
                         tail_mass: float = 1e-9, lo: float = -256.0,
                         hi: float = 256.0, iters: int = 60) -> torch.Tensor:
    """Solve the (C, 1, 3) quantiles by per-channel bisection on the host
    (the chain is strictly increasing in v).  The bracket is [lo, hi]: a
    quantile outside it comes back clamped to the bracket's end, as in the
    JAX package.  Returns a float32 CPU tensor."""
    target = math.log(2.0 / tail_mass - 1.0)
    targets = np.array([-target, 0.0, target], np.float64)[:, None]
    host = {k: v.detach().float().cpu() for k, v in params.items()}
    c = host["matrix_0"].shape[0]

    def f(v):  # (3, C) -> (3, C)
        with torch.no_grad():
            out = logits_cumulative(host, torch.from_numpy(
                v.astype(np.float32)), num_filters)
        return out.numpy().astype(np.float64)

    lo_a = np.full((3, c), lo)
    hi_a = np.full((3, c), hi)
    for _ in range(iters):
        mid = 0.5 * (lo_a + hi_a)
        go_hi = f(mid) < targets
        lo_a = np.where(go_hi, mid, lo_a)
        hi_a = np.where(go_hi, hi_a, mid)
    q = 0.5 * (lo_a + hi_a)                      # (3, C)
    return torch.from_numpy(q.T[:, None, :].astype(np.float32))


class FactorizedEntropyBottleneck(nn.Module):
    """``fact_ent``: ``forward(y, training)`` returns ``(y_q, p_y)``, with
    additive uniform noise in training and round-to-median in eval, and the
    likelihood of ``y_q``.  ``y`` is NHWC."""

    def __init__(self, channels: int, filters: Sequence[int] = (3, 3, 3, 3),
                 init_scale: float = 10.0, likelihood_bound: float = 1e-9):
        super().__init__()
        self.init_scale = init_scale
        self.likelihood_bound = likelihood_bound
        self.ext = (1,) + tuple(filters) + (1,)
        self.num_filters = len(filters)
        for i in range(self.num_filters + 1):
            self.register_parameter(f"matrix_{i}", nn.Parameter(torch.empty(
                (channels, self.ext[i + 1], self.ext[i]))))
            self.register_parameter(f"bias_{i}", nn.Parameter(
                torch.empty(channels, self.ext[i + 1], 1)))
            if i < self.num_filters:
                self.register_parameter(f"factor_{i}", nn.Parameter(
                    torch.empty(channels, self.ext[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.empty(channels, 1, 3))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        """The JAX package's init: constant matrices, biases U(-0.5, 0.5)
        drawn from ``generator``, zero factors, quantiles (-s, 0, s)."""
        k = self.num_filters
        scale = self.init_scale ** (1.0 / (k + 1))
        with torch.no_grad():
            for i in range(k + 1):
                init_v = math.log(math.expm1(1.0 / scale / self.ext[i + 1]))
                getattr(self, f"matrix_{i}").fill_(init_v)
                getattr(self, f"bias_{i}").uniform_(-0.5, 0.5,
                                                    generator=generator)
                if i < k:
                    getattr(self, f"factor_{i}").zero_()
            self.quantiles.copy_(torch.tensor(
                [-self.init_scale, 0.0, self.init_scale]).expand_as(
                    self.quantiles))

    def params(self) -> Dict[str, torch.Tensor]:
        return {name: p for name, p in self.named_parameters()}

    def quantize(self, y: torch.Tensor, mode: str,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if mode == "noise":
            if noise is None:
                noise = torch.rand(y.shape, generator=generator,
                                   dtype=y.dtype, device=y.device) - 0.5
            return y + noise.to(y.dtype)
        if mode == "dequantize":
            medians = medians_fn(self.params())
            return torch.round(y - medians) + medians
        raise ValueError(f"Invalid quantization mode: {mode}")

    def forward(self, y: torch.Tensor, training: bool = False,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        y_q = self.quantize(y, "noise" if training else "dequantize", noise,
                            generator)
        p_y = likelihood_fn(self.params(), y_q, self.num_filters,
                            self.likelihood_bound)
        return y_q, p_y


def update_cdf_tables(params, filters: Sequence[int],
                      precision: int = 16) -> Dict[str, np.ndarray]:
    """16-bit quantized CDF tables of the host rANS coder ('cae', 'cae_bn'
    and the 'cae_tpu' escape fallback) from the bottleneck's parameters
    (numpy arrays or tensors).

    The JAX package's ``update_cdf_tables``: integer support from the
    learned quantiles, the pmf on it, the tail mass
    ``σ(lower[0]) + σ(−upper[−1])`` in a last bucket, quantized to
    ``2**precision``.  The chain and the logistic run through
    ``coding/xla_f32.py`` in float32 as XLA's CPU backend and numpy compute
    them there, so the tables are element-equal to the JAX package's.

    Returns ``quantized_cdf`` (C, max_len + 2) int32 (zero padded),
    ``cdf_length`` (C,) int32 and ``offset`` (C,) int32.
    """
    params = {k: (v.detach().cpu().numpy() if torch.is_tensor(v)
                  else np.asarray(v)) for k, v in params.items()}
    quantiles = params["quantiles"]                      # (C, 1, 3)
    medians = quantiles[:, 0, 1]
    minima = np.clip(np.ceil(medians - quantiles[:, 0, 0]).astype(np.int32),
                     0, None)
    maxima = np.clip(np.ceil(quantiles[:, 0, 2] - medians).astype(np.int32),
                     0, None)
    pmf_start = medians - minima
    pmf_length = maxima + minima + 1
    max_length = int(pmf_length.max())
    samples = (np.arange(max_length, dtype=np.float32)[:, None]
               + pmf_start[None, :])                     # (L, C)
    num_filters = len(filters)
    lower = xla_f32.logits_cumulative(params, samples - 0.5, num_filters)
    upper = xla_f32.logits_cumulative(params, samples + 0.5, num_filters)
    pmf = xla_f32.interval_pmf(lower, upper).T           # (C, L)
    tail_mass = (xla_f32.logistic(lower[0, :])
                 + xla_f32.logistic(-upper[-1, :]))      # (C,) float32

    channels = pmf.shape[0]
    quantized_cdf = np.zeros((channels, max_length + 2), np.int32)
    for c in range(channels):
        n = int(pmf_length[c])
        prob = np.concatenate([pmf[c, :n], [tail_mass[c]]]).astype(np.float64)
        cdf = pmf_to_quantized_cdf(prob, precision)
        quantized_cdf[c, :len(cdf)] = cdf
    return {"quantized_cdf": quantized_cdf,
            "cdf_length": (pmf_length + 2).astype(np.int32),
            "offset": (-minima).astype(np.int32)}
