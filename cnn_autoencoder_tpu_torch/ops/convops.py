"""Convolutions with the reference's geometry, on channel-last tensors.

Modules take and return NHWC tensors like the JAX package.  Inside, the
tensor is viewed as NCHW with channels-last strides (no copy), which is the
layout cuDNN prefers and keeps the output channel-last for the GDN that
follows.  Weights use PyTorch's layouts: OIHW for ``Conv2dReflect`` and
(in, out, kh, kw) for ``ConvTranspose2dTorch``; ``utils.weights`` converts
the JAX package's HWIO kernels once at load time.

The compute type follows the input, which is how the port states the JAX
package's compute mode: float32 inputs convolve in full float32 (TF32 off,
the JAX package's HIGHEST); bf16 inputs convolve bf16 operands (the
float32 weights rounded to bf16) with float32 accumulation and store the
output as bf16, and autograd then carries bf16 cotangents and float32
weight gradients, the rule of ``conv_mixed`` (``ops/convops.py:105-164``
there).

The JAX package's polyphase and border-corrected strided convs
(``ops/convops.py:262-396`` there) are TPU lowering choices for the same
function and are not ported.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import full_f32

DEFAULT_GAIN = math.sqrt(2.0 / 1.01)


def xavier_uniform_torchlike_(weight: torch.Tensor, fan_in: int,
                              fan_out: int, gain: float = DEFAULT_GAIN,
                              generator=None) -> torch.Tensor:
    """U(-a, a) with ``a = gain * sqrt(6 / (fan_in + fan_out))``, in place
    (the JAX package's ``xavier_uniform_torchlike``; for a 3x3 kernel
    ``fan_in = Cin * 9`` and ``fan_out = Cout * 9``)."""
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return weight.uniform_(-a, a, generator=generator)


def _init_conv(weight: torch.Tensor, bias, cin: int, cout: int,
               generator=None) -> None:
    # the reference's init: xavier-uniform with gain sqrt(2/1.01), bias 0.01
    k2 = weight.shape[2] * weight.shape[3]
    xavier_uniform_torchlike_(weight, cin * k2, cout * k2,
                              generator=generator)
    if bias is not None:
        with torch.no_grad():
            bias.fill_(0.01)


def _conv_operands(x: torch.Tensor, weight: torch.Tensor, bias):
    """The weight and bias in x's compute type."""
    return (weight.to(x.dtype),
            None if bias is None else bias.to(x.dtype))


class Conv2dReflect(nn.Module):
    """Reflect pad by k//2, then a VALID convolution (torch Conv2d with
    ``padding_mode='reflect'``)."""

    def __init__(self, channels_in: int, channels_out: int,
                 kernel_size: int = 3, stride: int = 1, bias: bool = False):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.pad = k // 2
        self.weight = nn.Parameter(torch.empty(channels_out, channels_in,
                                               k, k))
        self.bias = (nn.Parameter(torch.empty(channels_out)) if bias
                     else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        cout, cin = self.weight.shape[:2]
        _init_conv(self.weight, self.bias, cin, cout, generator)

    def kernel_hwio(self) -> torch.Tensor:
        """The weight in the JAX package's HWIO layout (contiguous)."""
        return self.weight.permute(2, 3, 1, 0).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if self.pad:
            x = F.pad(x, (self.pad,) * 4, mode="reflect")
        weight, bias = _conv_operands(x, self.weight, self.bias)
        with full_f32():
            y = F.conv2d(x, weight, bias, stride=self.stride)
        return y.permute(0, 2, 3, 1)


class ConvTranspose2dTorch(nn.Module):
    """torch ``ConvTranspose2d`` geometry: output size
    ``(in - 1) * s - 2p + k + output_padding``."""

    def __init__(self, channels_in: int, channels_out: int,
                 kernel_size: int = 3, stride: int = 2, padding: int = 1,
                 output_padding: int = 1, bias: bool = True):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.weight = nn.Parameter(torch.empty(channels_in, channels_out,
                                               k, k))
        self.bias = (nn.Parameter(torch.empty(channels_out)) if bias
                     else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        cin, cout = self.weight.shape[:2]
        _init_conv(self.weight, self.bias, cin, cout, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        weight, bias = _conv_operands(x, self.weight, self.bias)
        with full_f32():
            y = F.conv_transpose2d(x, weight, bias,
                                   stride=self.stride, padding=self.padding,
                                   output_padding=self.output_padding)
        return y.permute(0, 2, 3, 1)
