"""flax's layers as the JAX package's heads use them, on NHWC tensors in
float32 (``models/classifiers.py``, ``models/segmenters.py``).

Parameters keep flax's names with PyTorch's layouts where PyTorch has one:
a convolution's or a dense layer's ``kernel`` is a ``weight`` (OIHW, or
(out, in)); ``bias``, the norms' ``scale`` and the attention's kernels
(``(D, H, D/H)`` for query, key and value, ``(H, D/H, D)`` for its output)
are as flax stores them.  ``utils/weights.py`` maps the JAX package's
variables one to one by these rules.

* ``Conv``: flax's ``nn.Conv`` padding, "SAME" by default (the low side
  gets the smaller half), an int or a pair per side; products in full
  float32 (``utils/device.py:full_f32``).
* ``ConvTranspose2x2``: flax's ``nn.ConvTranspose((2, 2), strides=(2, 2))``
  with its default "SAME" padding, where output pixel (2i + a, 2j + b)
  takes input pixel (i, j) times kernel tap (1 - a, 1 - b): the taps do
  not overlap, so it is one product and an interleave, which adds in a
  fixed order on every device.
* ``Dense`` is ``nn.Linear`` with flax's init and full float32 products.
  ``LayerNorm`` and ``GroupNorm`` (one group per channel, NHWC) are
  ``F.layer_norm`` and ``F.group_norm`` with flax's epsilons; they hold
  their own ``scale`` and ``bias`` rather than subclass the built-ins,
  whose ``weight`` would need a second renaming rule: the port's
  ``BatchNorm`` (Inception) also holds a ``scale``, and a gradient tree
  or an importer's tree says nothing of which norm a ``scale`` belongs
  to, so ``kernel`` <-> ``weight`` stays the one rule for every head.
  torch's two-pass variance is not flax's E[x^2] - E[x]^2, but that
  formula written in torch sums in another order than XLA's and comes no
  closer; ``tests/test_torch_heads.py`` holds every head to flax's at
  1e-5 relative with the built-ins.
* Initial values are flax's: kernels LeCun normal (truncated at two
  standard deviations), biases 0, scales 1, drawn from the caller's
  generator.

Under the model mesh axis (``parallel/mesh.py:shard_model``) a
convolution's kernel and bias may be held as the rank's output channels:
``Conv`` and ``ConvTranspose2x2`` are then column-parallel
(``distributed.column_parallel``: the rank's channels, gathered).  A
``Dense`` kernel is never sharded, its bias may be, and the norms'
``scale`` and ``bias`` may be: those are gathered before use
(``distributed.full_param``).
"""

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.distributed import column_parallel, full_param
from ..utils.device import full_f32

# flax's truncated normal keeps the variance of the untruncated one
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)


Padding = Union[str, int, Tuple[int, int]]


def _pads(size: int, k: int, s: int, padding) -> Tuple[int, int]:
    """(low, high) padding of one spatial axis by flax's rules."""
    if padding == "SAME":
        total = max((-(-size // s) - 1) * s + k - size, 0)
        return total // 2, total - total // 2
    if padding == "VALID":
        return 0, 0
    return padding, padding


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC tensors."""

    def __init__(self, channels_in: int, channels_out: int,
                 kernel: Union[int, Tuple[int, int]] = 1,
                 strides: Union[int, Tuple[int, int]] = 1,
                 padding: Padding = "SAME", use_bias: bool = True):
        super().__init__()
        self.kernel = (kernel, kernel) if isinstance(kernel, int) else \
            tuple(kernel)
        self.strides = (strides, strides) if isinstance(strides, int) else \
            tuple(strides)
        self.padding = ((padding, padding) if isinstance(padding, (int, str))
                        else tuple(padding))
        self.weight = nn.Parameter(torch.empty(channels_out, channels_in,
                                               *self.kernel))
        self.bias = (nn.Parameter(torch.empty(channels_out)) if use_bias
                     else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        fan_in = self.weight.shape[1] * self.kernel[0] * self.kernel[1]
        lecun_normal_(self.weight, fan_in, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return column_parallel(self, x, self._forward)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        (ph0, ph1), (pw0, pw1) = (
            _pads(x.shape[1], self.kernel[0], self.strides[0],
                  self.padding[0]),
            _pads(x.shape[2], self.kernel[1], self.strides[1],
                  self.padding[1]))
        xc = x.permute(0, 3, 1, 2)
        if ph0 == ph1 and pw0 == pw1:
            pad = (ph0, pw0)
        else:
            xc, pad = F.pad(xc, (pw0, pw1, ph0, ph1)), (0, 0)
        with full_f32():
            y = F.conv2d(xc, self.weight, self.bias, self.strides, pad)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2x2(nn.Module):
    """flax ``nn.ConvTranspose(features, (2, 2), strides=(2, 2))``; the
    ``weight`` is (out, in, 2, 2), flax's kernel ``[kh, kw, in, out]``."""

    def __init__(self, channels_in: int, channels_out: int,
                 use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels_out, channels_in,
                                               2, 2))
        self.bias = (nn.Parameter(torch.empty(channels_out)) if use_bias
                     else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        # flax's ConvTranspose takes the fan-in of its (2, 2, in, out)
        # kernel: 2 * 2 * in
        lecun_normal_(self.weight, 4 * self.weight.shape[1], generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return column_parallel(self, x, self._forward)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        cout = self.weight.shape[0]
        # (in, a, b, out) with tap (1 - a, 1 - b) at output phase (a, b)
        taps = self.weight.flip(2, 3).permute(1, 2, 3, 0).reshape(c, -1)
        with full_f32():
            y = x.reshape(-1, c) @ taps
        y = y.reshape(n, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(n, 2 * h, 2 * w, cout)
        return y if self.bias is None else y + self.bias


class Dense(nn.Linear):
    """flax ``nn.Dense``: ``weight`` (out, in)."""

    def __init__(self, channels_in: int, channels_out: int,
                 use_bias: bool = True):
        super().__init__(channels_in, channels_out, bias=use_bias)

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with full_f32():
            return F.linear(x, self.weight, full_param(self, "bias"))


class _Norm(nn.Module):
    """A norm's ``scale`` (1) and ``bias`` (0) over ``channels``."""

    def __init__(self, channels: int, epsilon: float):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        del generator  # nothing is drawn
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()


class LayerNorm(_Norm):
    """flax ``nn.LayerNorm`` over the last axis."""

    def __init__(self, channels: int, epsilon: float = 1e-6):
        super().__init__(channels, epsilon)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], full_param(self, "scale"),
                            full_param(self, "bias"), self.epsilon)


class GroupNorm(_Norm):
    """flax ``nn.GroupNorm(num_groups=C)`` on NHWC: statistics over (H, W)
    per sample and channel."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__(channels, epsilon)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.permute(0, 3, 1, 2), x.shape[-1],
                         full_param(self, "scale"), full_param(self, "bias"),
                         self.epsilon)
        return y.permute(0, 2, 3, 1)


def widen(x: torch.Tensor) -> torch.Tensor:
    """A head's input in float32 (bf16 and half widened; float32 and
    float64 as they are), as flax's float32 parameters promote it."""
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def max_pool(x: torch.Tensor, k: int, stride: int, padding: int = 0
             ) -> torch.Tensor:
    """flax ``nn.max_pool`` on NHWC (padding by -inf)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, stride, padding)
    return y.permute(0, 2, 3, 1)


def avg_pool(x: torch.Tensor, k: int, stride: int, padding: int = 0
             ) -> torch.Tensor:
    """flax ``nn.avg_pool`` on NHWC, the padded zeros counted."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), k, stride, padding,
                     count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def dropout(x: torch.Tensor, rate: float, train: bool) -> torch.Tensor:
    """flax ``nn.Dropout``: scaled keep-mask in train mode, identity else
    (the masks are torch's draws, not JAX's)."""
    if not train or rate == 0.0:
        return x
    return F.dropout(x, rate, training=True)
