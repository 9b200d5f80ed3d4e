"""Convolutions with the reference's geometry, on channel-last tensors.

Modules take and return NHWC tensors like the JAX package.  Inside, the
tensor is viewed as NCHW with channels-last strides (no copy), which is the
layout cuDNN prefers and keeps the output channel-last for the GDN that
follows.  Weights use PyTorch's layouts: OIHW for ``Conv2dReflect`` and
(in, out, kh, kw) for ``ConvTranspose2dTorch``; ``utils.weights`` converts
the JAX package's HWIO kernels once at load time.

The JAX package's polyphase and border-corrected strided convs
(``ops/convops.py:262-396`` there) are TPU lowering choices and are not
ported.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import full_f32

DEFAULT_GAIN = math.sqrt(2.0 / 1.01)


def _init_conv(weight: torch.Tensor, bias) -> None:
    # the reference's init: xavier-uniform with gain sqrt(2/1.01), bias 0.01
    nn.init.xavier_uniform_(weight, gain=DEFAULT_GAIN)
    if bias is not None:
        nn.init.constant_(bias, 0.01)


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
        _init_conv(self.weight, self.bias)

    def kernel_hwio(self) -> torch.Tensor:
        """The weight in the JAX package's HWIO layout (contiguous)."""
        return self.weight.permute(2, 3, 1, 0).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if self.pad:
            x = F.pad(x, (self.pad,) * 4, mode="reflect")
        with full_f32():
            y = F.conv2d(x, self.weight, self.bias, stride=self.stride)
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
        _init_conv(self.weight, self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        with full_f32():
            y = F.conv_transpose2d(x, self.weight, self.bias,
                                   stride=self.stride, padding=self.padding,
                                   output_padding=self.output_padding)
        return y.permute(0, 2, 3, 1)
