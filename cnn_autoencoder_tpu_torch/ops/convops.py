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
there).  Serving picks the activations' type with ``set_default_precision``
(below); training passes its ``compute_dtype`` and ignores it.

Transposed convolutions add in a fixed order on every device, so a decode
is bit-reproducible on the card (cuDNN's default algorithms for them add
in a varying order).  The 3x3 stride-2 geometry of every ``deconv_up`` is
the JAX package's polyphase form (``deconv2x_polyphase``,
``ops/convops.py:343-387`` there): each output parity phase sums its taps
of the input's shifted rows, on cuBLAS products.  Its gradient is the
transposed convolution's own backward, one ATen call, as autograd of
``F.conv_transpose2d`` computes it (the polyphase form's own graph would
record some twenty operations a layer, which the host-bound train step
pays for).  Any other geometry takes the JAX package's own dilated form:
zero-dilate, pad, and a forward convolution with the flipped weight (the
``lhs_dilation`` lowering, ``ops/convops.py:405-460`` there).  The JAX
package's border-corrected strided convs (``ops/convops.py:262-342``
there) are TPU lowering choices and are not ported.
"""

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import full_f32

DEFAULT_GAIN = math.sqrt(2.0 / 1.01)

# The serving precision, by name, as the JAX package's
# ``set_default_precision`` takes it; its start value comes from
# CAE_TPU_PRECISION.  "highest" serves float32 activations, "bf16" bf16
# activations end to end (bf16 operands, float32 sums).  The JAX package's
# "default" and "high" (bf16 multiplies on float32 activations) and its TPU
# tuning switches CAE_TPU_BF16_ACTIVATIONS and CAE_TPU_GDN_FAST are not
# ported.
PRECISIONS = {"highest": torch.float32, "bf16": torch.bfloat16}
_NOT_PORTED = ("default", "high")


def _precision_name(name: str) -> str:
    key = name.lower()
    if key in _NOT_PORTED:
        raise ValueError(f"precision {name!r} is not ported; the port serves "
                         f"{sorted(PRECISIONS)}")
    if key not in PRECISIONS:
        raise ValueError(f"unknown precision {name!r}; the port serves "
                         f"{sorted(PRECISIONS)}")
    return key


_DEFAULT_PRECISION = _precision_name(
    os.environ.get("CAE_TPU_PRECISION", "highest"))


def set_default_precision(name: str) -> None:
    """Serve at ``name``: "highest" (float32) or "bf16".  Codec cores built
    after the call take it."""
    global _DEFAULT_PRECISION
    _DEFAULT_PRECISION = _precision_name(name)


def get_default_precision() -> str:
    return _DEFAULT_PRECISION


def get_activations_dtype() -> torch.dtype:
    """The type serving casts normalized pixels and latents to at the
    model's boundary: bf16 in the bf16 mode, else float32."""
    return PRECISIONS[_DEFAULT_PRECISION]


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


def _deconv2x_polyphase(x: torch.Tensor, weight: torch.Tensor,
                        bias) -> torch.Tensor:
    """3x3, stride 2, padding 1, output padding 1, NHWC, weight (in, out,
    kh, kw) and bias already in x's type.  With x zero past the bottom and
    right edges, the four output parity phases are

      out[2i,   2j  ] = x[i,j] W[1,1]
      out[2i,   2j+1] = x[i,j] W[1,2] + x[i,j+1] W[1,0]
      out[2i+1, 2j  ] = x[i,j] W[2,1] + x[i+1,j] W[0,1]
      out[2i+1, 2j+1] = x[i,j] W[2,2] + x[i,j+1] W[2,0]
                      + x[i+1,j] W[0,2] + x[i+1,j+1] W[0,0]

    plus the bias once, with float32 sums (TF32 off; bf16 products are
    exact in float32) and one rounding to x's type.  Two forms of it, by
    which moves fewer bytes (``scripts/torch_deconv_forms.py`` times
    them): one product per phase where the outputs are wide, one product
    against all nine taps where they are narrow (9 Cout <= 4 Cin, as in a
    decoder's last layer)."""
    with full_f32():
        if 9 * weight.shape[1] <= 4 * x.shape[-1]:
            return _deconv2x_one_product(x, weight, bias)
        return _deconv2x_phase_products(x, weight, bias)


class _Deconv2xPolyphase(torch.autograd.Function):
    """The polyphase forward; the backward by
    ``aten::convolution_backward`` of the same transposed convolution."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return _deconv2x_polyphase(x, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        mask = list(ctx.needs_input_grad[:2]) + [
            ctx.has_bias and ctx.needs_input_grad[2]]
        with full_f32():
            dx, dw, db = torch.ops.aten.convolution_backward(
                g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), weight,
                [weight.shape[1]] if ctx.has_bias else None, [2, 2], [1, 1],
                [1, 1], True, [1, 1], 1, mask)
        return (None if dx is None else dx.permute(0, 2, 3, 1), dw, db)


def _deconv2x_one_product(x, weight, bias):
    """One float32 product of the rows, padded by a zero row and column,
    against all nine taps; each phase adds its taps left to right over
    shifted slices into its place in the output, then the bias; one
    rounding.  Runs without autograd (``_Deconv2xPolyphase``)."""
    b, h, w, cin = x.shape
    cout = weight.shape[1]
    rows = x.new_zeros(b, h + 1, w + 1, cin, dtype=torch.float32)
    rows[:, :h, :w] = x
    taps = weight.permute(0, 2, 3, 1).reshape(cin, 9 * cout).float()
    prod = torch.matmul(rows.view(-1, cin), taps).view(b, h + 1, w + 1, 3,
                                                       3, cout)

    def tap(ky, kx, di, dj):  # x[i + di, j + dj] W[ky, kx]
        return prod[:, di:di + h, dj:dj + w, ky, kx]

    out = x.new_empty(b, h, 2, w, 2, cout, dtype=torch.float32)
    out[:, :, 0, :, 0] = tap(1, 1, 0, 0)
    torch.add(tap(1, 2, 0, 0), tap(1, 0, 0, 1), out=out[:, :, 0, :, 1])
    torch.add(tap(2, 1, 0, 0), tap(0, 1, 1, 0), out=out[:, :, 1, :, 0])
    oo = torch.add(tap(2, 2, 0, 0), tap(2, 0, 0, 1), out=out[:, :, 1, :, 1])
    oo.add_(tap(0, 2, 1, 0)).add_(tap(0, 0, 1, 1))
    if bias is not None:
        out.add_(bias.float())
    return out.view(b, 2 * h, 2 * w, cout).to(x.dtype)


def _deconv2x_phase_products(x, weight, bias):
    """One product per phase, in x's type with float32 sums, rounded once.
    The columns [x[i,j+1] | x[i,j] | 1 | x[i+1,j] | x[i+1,j+1]] (zero past
    the edges) hold every phase's operands as one window of adjacent
    blocks; each phase multiplies its window by its taps stacked (the bias
    against the ones column, padded to 8 so every block starts 16-byte
    aligned), so its sums run inside the product.  Runs without autograd
    (``_Deconv2xPolyphase``)."""
    b, h, w, cin = x.shape
    cout = weight.shape[1]
    nb = 0 if bias is None else 8
    r = 2 * cin + nb  # where x[i+1, j] starts
    cols = x.new_zeros(b, h, w, 4 * cin + nb)
    cols[:, :, :-1, :cin] = x[:, :, 1:]
    cols[..., cin:2 * cin] = x
    cols[:, :-1, :, r:r + cin] = x[:, 1:]
    cols[:, :-1, :-1, r + cin:] = x[:, 1:, 1:]
    t = weight.permute(2, 3, 0, 1)  # t[ky, kx] is (in, out)
    bias_rows = []
    if bias is not None:
        cols[..., 2 * cin] = 1
        bias_rows = [F.pad(bias[None], (0, 0, 0, nb - 1))]
    # each phase's column window and its taps, in the columns' order
    phases = (((cin, r), [t[1, 1]] + bias_rows),
              ((0, r), [t[1, 0], t[1, 2]] + bias_rows),
              ((cin, r + cin), [t[2, 1]] + bias_rows + [t[0, 1]]),
              ((0, r + 2 * cin),
               [t[2, 0], t[2, 2]] + bias_rows + [t[0, 2], t[0, 0]]))
    stacked = torch.cat([blk for _, taps in phases for blk in taps], 0)
    cols = cols.view(-1, 4 * cin + nb)
    sums = x.new_empty(4, cols.shape[0], cout)
    k0 = 0
    for i, ((lo, hi), _) in enumerate(phases):
        torch.matmul(cols[:, lo:hi], stacked[k0:k0 + hi - lo], out=sums[i])
        k0 += hi - lo
    out = x.new_empty(b, h, 2, w, 2, cout)
    out.permute(2, 4, 0, 1, 3, 5).copy_(sums.view(2, 2, b, h, w, cout))
    return out.view(b, 2 * h, 2 * w, cout)


def _deconv_dilated(x: torch.Tensor, weight: torch.Tensor, bias, stride: int,
                    padding: int, output_padding: int) -> torch.Tensor:
    """Any geometry, NCHW view: x zero-dilated by ``stride``, padded by
    (k-1-p, k-1-p+op), then a forward convolution with the flipped,
    transposed weight."""
    k = weight.shape[-1]
    if stride > 1:
        b, c, h, w = x.shape
        dil = x.new_zeros(b, c, (h - 1) * stride + 1, (w - 1) * stride + 1)
        dil[:, :, ::stride, ::stride] = x
        x = dil
    lo, hi = k - 1 - padding, k - 1 - padding + output_padding
    x = F.pad(x, (lo, hi, lo, hi))
    with full_f32():
        return F.conv2d(x, weight.flip(2, 3).transpose(0, 1), bias)


class ConvTranspose2dTorch(nn.Module):
    """torch ``ConvTranspose2d`` geometry: output size
    ``(in - 1) * s - 2p + k + output_padding``, summed in a fixed order
    (the polyphase form for 3x3 / stride 2 / padding 1 / output padding 1,
    the dilated form for any other)."""

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
        weight, bias = _conv_operands(x, self.weight, self.bias)
        if (weight.shape[-1], self.stride, self.padding,
                self.output_padding) == (3, 2, 1, 1):
            return _Deconv2xPolyphase.apply(x, weight, bias)
        y = _deconv_dilated(x.permute(0, 3, 1, 2), weight, bias, self.stride,
                            self.padding, self.output_padding)
        return y.permute(0, 2, 3, 1)
