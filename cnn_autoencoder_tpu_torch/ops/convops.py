"""Convolutions with the reference's geometry, on channel-last tensors.

Modules take and return NHWC tensors like the JAX package.  Inside, the
tensor is viewed as NCHW with channels-last strides (no copy), which is the
layout cuDNN prefers and keeps the output channel-last for the GDN that
follows.  Weights use PyTorch's layouts: OIHW for ``Conv2dReflect`` and
(in, out, kh, kw) for ``ConvTranspose2dTorch``; ``utils.weights`` converts
the JAX package's HWIO kernels once at load time.

The compute type follows the input, which is how the port states the JAX
package's compute mode.  Float32 inputs convolve in full float32 (TF32
off, the JAX package's HIGHEST), or, at the serving precisions "default"
and "high" (``layer_precision``), on bf16-rounded operands in one pass or
on their bf16 hi/lo parts in three (hi hi + hi lo + lo hi, the TPU's
bf16_3x), with float32 sums and outputs, and a backward that transposes
each convolution at the same precision (``_LowPrecision``, as XLA's
transpose rules differentiate the JAX package's DEFAULT and HIGH
convolutions).  bf16 inputs take the JAX
package's default route in the bf16 mode: bf16 operands (the float32
weights rounded to bf16) with float32 sums, the sums stored as bf16, then
the bias added in bf16 with a second rounding (``_native_conv_out``,
``ops/convops.py:175-186`` there); the 3x3 stride-2 convs take its border
form's roundings (``conv_s2_reflect_border``, ``:302-342``).
``CAE_TPU_NATIVE_CONV_OUT=0`` (and ``CAE_TPU_POLYPHASE_DECONV=1`` for the
3x3 stride-2 deconvs) keeps the sums and the bias in float32 and rounds
once; ``CAE_TPU_BORDER_CONV=0`` takes reflect + VALID; the switches are
read at call time (``ops/switches.py``).  Autograd carries bf16 cotangents
and float32 weight gradients, the rule of ``conv_mixed``
(``ops/convops.py:105-164`` there).  Serving picks the activations' type
with ``set_default_precision`` (below); training passes its
``compute_dtype`` and ignores it.  A layer's ``compute_dtype`` argument
names the mode where it can differ from the input's type
(``layer_precision``): a dtype (training), or a precision's name (a codec
core passes the one it was built at).  Float32 rows in the bf16 mode
(after a batch norm, whose output is float32 as flax's, or serving with
``CAE_TPU_BF16_ACTIVATIONS=0``) take ``conv_mixed``'s rule for float32
inputs (``_ConvMixed``): bf16-rounded operands, float32 sums and output,
and a backward that rounds the cotangent to bf16 first.

Both layers take ``groups`` (the JAX package's ``feature_group_count``):
``Conv2dReflect`` as a grouped cuDNN forward convolution, and
``ConvTranspose2dTorch`` in the dilated form with a grouped forward
convolution, which sums in a fixed order as the polyphase form does.

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
package's polyphase strided conv (``CAE_TPU_POLYPHASE_CONV=1``,
``:262-299`` there) takes the place of the border form in the bf16 mode
(``polyphase_form``: four convs, three more bf16 roundings); on float32
rows it changes only the order of float32 sums and is not read.
"""

import functools
import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import full_f32
from . import switches

DEFAULT_GAIN = math.sqrt(2.0 / 1.01)
BF16 = torch.bfloat16

# The serving precision, by name, as the JAX package's
# ``set_default_precision`` takes it, with its activations' type; its start
# value comes from CAE_TPU_PRECISION.  "highest" serves float32 activations
# and convolutions; "default" and "high" float32 activations whose
# convolutions multiply in one bf16 pass or in bf16_3x (the TPU's DEFAULT
# and HIGH), the GDN pool staying float32; "bf16" bf16 activations end to
# end (bf16 operands, float32 sums).
PRECISIONS = {"highest": torch.float32, "high": torch.float32,
              "default": torch.float32, "bf16": BF16}


def _precision_name(name: str) -> str:
    key = name.lower()
    if key not in PRECISIONS:
        raise ValueError(f"unknown precision {name!r}; the port serves "
                         f"{sorted(PRECISIONS)}")
    return key


_DEFAULT_PRECISION = _precision_name(
    os.environ.get("CAE_TPU_PRECISION", "highest"))


def set_default_precision(name: str) -> None:
    """Serve and train at ``name``: "highest", "high", "default" or
    "bf16".  Codec cores built after the call take it."""
    global _DEFAULT_PRECISION
    _DEFAULT_PRECISION = _precision_name(name)


def get_default_precision() -> str:
    return _DEFAULT_PRECISION


def get_activations_dtype() -> torch.dtype:
    """The type serving casts normalized pixels and latents to at the
    model's boundary: bf16 in the bf16 mode, else float32.  In the bf16
    mode ``CAE_TPU_BF16_ACTIVATIONS=0`` (read now, as the JAX package reads
    it) asks for float32 activations between the bf16 layers: the layers
    then take float32 rows in the bf16 mode (``_ConvMixed``)."""
    if _DEFAULT_PRECISION == "bf16" and not switches.bf16_activations():
        return torch.float32
    return PRECISIONS[_DEFAULT_PRECISION]


def core_precision(compute_dtype=None) -> str:
    """The precision a codec core built now serves at: the serving
    precision, or, where the core is given its activations' type, "bf16"
    for bf16 and the serving precision's float32 form for float32
    ("highest" in the bf16 mode)."""
    if compute_dtype is None:
        return _DEFAULT_PRECISION
    return layer_precision(compute_dtype)


def layer_precision(compute_dtype=None) -> str:
    """The precision a layer computes at, from its ``compute_dtype``
    argument: a precision's name as it is; bf16 the bf16 mode; float32 or
    None the serving precision's float32 form ("highest" in the bf16
    mode, where float32 rows come from a layer that asked for them)."""
    if isinstance(compute_dtype, str):
        return _precision_name(compute_dtype)
    if compute_dtype == BF16:
        return "bf16"
    return "highest" if _DEFAULT_PRECISION == "bf16" else _DEFAULT_PRECISION


def _float32_product(precision: str) -> str:
    """How float32 rows' convolutions multiply at ``precision``: "bf16x1"
    in the bf16 mode (``conv_mixed``'s rule) and at "default", "bf16x3" at
    "high", else "float32"."""
    return {"bf16": "bf16x1", "default": "bf16x1",
            "high": "bf16x3"}.get(precision, "float32")


def _bf16_parts(t: torch.Tensor):
    """t as hi + lo, both bf16 values held in float32."""
    hi = t.to(BF16).float()
    return hi, (t - hi).to(BF16).float()


def _conv_grads(g, x, weight, geometry, mask, product):
    """(dx, dw) of the NCHW convolution ``geometry`` = (stride, padding,
    transposed, output_padding, groups) at the cotangent g, each transposed
    product at ``product``, as XLA's transpose rules carry a precision into
    both transposed convolutions: "float32" (TF32 off), "bf16x1" (g, x and
    the weight rounded to bf16, float32 sums), "bf16x3" (the bf16_3x
    products of the hi/lo parts of each transpose's two operands, small
    terms first), or "bf16" (bf16 operands and gradients, ``conv_mixed``'s
    ``raw_same``).  ``mask``: which of dx and dw to compute."""
    stride, padding, transposed, output_padding, groups = geometry

    def grads(gg, xx, ww):
        with full_f32():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                gg, xx, ww, None, [stride] * 2, [padding] * 2, [1, 1],
                transposed, [output_padding] * 2, groups, list(mask) + [False])
        return dx, dw

    if product == "float32":
        return grads(g, x, weight)
    if product == "bf16":
        return grads(g.to(BF16), x.to(BF16), weight.to(BF16))
    if product == "bf16x1":
        return grads(*(t.to(BF16).float() for t in (g, x, weight)))
    (gh, gl), (xh, xl), (wh, wl) = map(_bf16_parts, (g, x, weight))
    dx_hh, dw_hh = grads(gh, xh, wh)
    dx_lh, dw_hl = grads(gl, xh, wh)  # dx: g lo w hi; dw: x hi g lo
    dx_hl, dw_lh = grads(gh, xl, wl)  # dx: g hi w lo; dw: x lo g hi
    return (None if dx_hh is None else dx_lh + dx_hl + dx_hh,
            None if dw_hh is None else dw_lh + dw_hl + dw_hh)


class _LowPrecision(torch.autograd.Function):
    """A float32 convolution ``conv(x, w)`` (NCHW, float32 sums) at the
    default or high precision: bf16-rounded operands, or the bf16_3x
    products lo hi + hi lo + hi hi, small terms first (the caller adds the
    bias in float32, so its gradient is the float32 sum of g).  bf16 values
    are exact in TF32, so cuDNN and cuBLAS may take their tensor cores.
    The backward transposes the convolution of ``geometry`` at the same
    precision (``_conv_grads``), as XLA differentiates the JAX package's
    DEFAULT and HIGH convolutions."""

    @staticmethod
    def forward(ctx, x, weight, product, geometry, conv):
        ctx.save_for_backward(x, weight)
        ctx.product, ctx.geometry = product, geometry
        weight = weight.float()
        if product == "bf16x1":
            return conv(x.to(BF16).float(), weight.to(BF16).float())
        (xh, xl), (wh, wl) = _bf16_parts(x), _bf16_parts(weight)
        return conv(xl, wh) + conv(xh, wl) + conv(xh, wh)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = _conv_grads(g, x, weight, ctx.geometry,
                             ctx.needs_input_grad[:2], ctx.product)
        return dx, dw, None, None, None


def _low_precision(conv, x, weight, precision, geometry):
    """``_LowPrecision`` at ``precision``'s product."""
    return _LowPrecision.apply(x, weight, _float32_product(precision),
                               geometry, conv)


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
    # the reference's init: xavier-uniform with gain sqrt(2/1.01), bias 0.01;
    # a grouped layer's fans as the JAX package counts them on its
    # (k, k, cin / groups, cout) kernel
    k2 = weight.shape[2] * weight.shape[3]
    xavier_uniform_torchlike_(weight, cin * k2, cout * k2,
                              generator=generator)
    if bias is not None:
        with torch.no_grad():
            bias.fill_(0.01)


def _check_groups(channels_in: int, channels_out: int, groups: int) -> None:
    # the JAX package's convolutions raise on the same widths
    for n in (channels_in, channels_out):
        if n % groups:
            raise ValueError(f"{n} channels are not a multiple of "
                             f"{groups} groups")


def _conv_operands(x: torch.Tensor, weight: torch.Tensor, bias):
    """The weight and bias in x's compute type."""
    return (weight.to(x.dtype),
            None if bias is None else bias.to(x.dtype))


def _mixed(x: torch.Tensor, precision: str) -> bool:
    """Float32 rows in the bf16 mode (a batch norm's output, or float32
    activations in serving)."""
    return precision == "bf16" and x.dtype == torch.float32


class _ConvMixed(torch.autograd.Function):
    """The JAX package's ``conv_mixed`` on float32 rows in the bf16 mode,
    NCHW views: x and the weight rounded to bf16, their products summed in
    float32 to a float32 output.  The products are exact in TF32 too, so
    this runs outside ``full_f32`` and cuDNN may take its tensor cores.
    The backward rounds the cotangent to bf16 and transposes the bf16
    convolution (dx and the weight's gradient from bf16 operands with
    float32 sums, rounded to bf16 and widened, as ``conv_mixed``'s
    ``raw_same``); the bias's gradient is summed in float32.  With
    ``transposed`` it is the 3x3 stride-2 deconv of
    ``_deconv2x_polyphase``."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, groups, transposed):
        xb, wb = x.to(torch.bfloat16), weight.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.geometry = (stride, groups, transposed)
        ctx.has_bias = bias is not None
        xw, ww = xb.to(x.dtype), wb.to(x.dtype)
        if transposed:
            return _deconv2x_polyphase(xw.permute(0, 2, 3, 1), ww,
                                       bias).permute(0, 3, 1, 2)
        return F.conv2d(xw, ww, bias, stride=stride, groups=groups)

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        stride, groups, transposed = ctx.geometry
        p = 1 if transposed else 0
        dx, dw = _conv_grads(g, xb, wb, (stride, p, transposed, p, groups),
                             ctx.needs_input_grad[:2], "bf16")
        db = (g.sum((0, 2, 3)) if ctx.has_bias and ctx.needs_input_grad[2]
              else None)
        return (None if dx is None else dx.to(g.dtype),
                None if dw is None else dw.float(), db, None, None, None)


class _ReflectPad(torch.autograd.Function):
    """Reflect padding by ``p`` on H and W of an NCHW view: ``F.pad``'s
    values, and a backward that folds the border's gradient back onto the
    rows and columns it copies in a fixed order (the CUDA backward of
    ``F.pad``'s reflect mode adds it with atomics, so a training step's
    gradients would change from run to run)."""

    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        ctx.fmt = (torch.channels_last
                   if x.is_contiguous(memory_format=torch.channels_last)
                   else torch.contiguous_format)
        return F.pad(x, (p,) * 4, mode="reflect")

    @staticmethod
    def backward(ctx, g):
        p = ctx.p
        h, w = g.shape[2] - 2 * p, g.shape[3] - 2 * p
        cols = g[..., p:w + p].clone(memory_format=ctx.fmt)
        cols[..., 1:p + 1] += g[..., :p].flip(3)
        cols[..., w - p - 1:w - 1] += g[..., w + p:].flip(3)
        dx = cols[:, :, p:h + p].clone(memory_format=ctx.fmt)
        dx[:, :, 1:p + 1] += cols[:, :, :p].flip(2)
        dx[:, :, h - p - 1:h - 1] += cols[:, :, h + p:].flip(2)
        return dx, None


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Reflect-pad H and W of an NCHW view by ``p``, with a backward that
    sums in a fixed order."""
    return _ReflectPad.apply(x, p)


class Conv2dReflect(nn.Module):
    """Reflect pad by k//2, then a VALID convolution (torch Conv2d with
    ``padding_mode='reflect'``)."""

    def __init__(self, channels_in: int, channels_out: int,
                 kernel_size: int = 3, stride: int = 1, bias: bool = False,
                 groups: int = 1):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.pad = k // 2
        _check_groups(channels_in, channels_out, groups)
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(channels_out,
                                               channels_in // groups, k, k))
        self.bias = (nn.Parameter(torch.empty(channels_out)) if bias
                     else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        cout, cin = self.weight.shape[:2]
        _init_conv(self.weight, self.bias, cin, cout, generator)

    def kernel_hwio(self) -> torch.Tensor:
        """The weight in the JAX package's HWIO layout (contiguous)."""
        return self.weight.permute(2, 3, 1, 0).contiguous()

    def _padded(self, x: torch.Tensor) -> torch.Tensor:
        return reflect_pad(x, self.pad) if self.pad else x

    def forward(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        if x.dtype == BF16:
            return self._bf16(x).permute(0, 2, 3, 1)
        precision = layer_precision(compute_dtype)
        if _mixed(x, precision):
            y = _ConvMixed.apply(self._padded(x), self.weight, self.bias,
                                 self.stride, self.groups, False)
        elif _float32_product(precision) != "float32":
            y = _low_precision(
                functools.partial(F.conv2d, stride=self.stride,
                                  groups=self.groups),
                self._padded(x), self.weight, precision,
                (self.stride, 0, False, 0, self.groups))
            if self.bias is not None:
                y = y + self.bias.float()[:, None, None]
        else:
            weight, bias = _conv_operands(x, self.weight, self.bias)
            with full_f32():
                y = F.conv2d(self._padded(x), weight, bias,
                             stride=self.stride, groups=self.groups)
        return y.permute(0, 2, 3, 1)

    def _bf16(self, x: torch.Tensor) -> torch.Tensor:
        """bf16 NCHW rows, the JAX default route (module docstring)."""
        k, (h, w) = self.weight.shape[-1], x.shape[2:]
        s2 = (k == 3 and self.stride == 2 and h % 2 == 0 and w % 2 == 0
              and min(h, w) >= 2)
        native = switches.native_conv_out()
        if s2 and switches.polyphase_conv():
            return self._polyphase(x, native)
        if not native:
            # float32 sums with the bias, one rounding
            return _ConvMixed.apply(self._padded(x).float(), self.weight,
                                    self.bias, self.stride, self.groups,
                                    False).to(BF16)
        weight = self.weight.to(BF16)
        with full_f32():
            if s2 and switches.border_conv():
                y = border_form(x, weight, functools.partial(
                    F.conv2d, groups=self.groups))
            else:
                y = F.conv2d(self._padded(x), weight, stride=self.stride,
                             groups=self.groups)
        return y if self.bias is None else y + self.bias.to(BF16)[:, None,
                                                                   None]

    def _polyphase(self, x: torch.Tensor, native: bool) -> torch.Tensor:
        """``CAE_TPU_POLYPHASE_CONV=1`` on bf16 NCHW rows, the 3x3 stride-2
        reflect conv as four stride-1 convs (``polyphase_form``), each
        differentiated by ``conv_mixed``'s rule.  With ``native`` each
        conv's sums are stored as bf16, the three adds and then the bias
        round in bf16; else the convs give float32, summed with the bias
        and rounded once."""
        if native:
            y = polyphase_form(x, self.weight, lambda a, w: F.conv2d(
                a, w.to(BF16), groups=self.groups))
            return y if self.bias is None else y + self.bias.to(BF16)[
                :, None, None]
        y = polyphase_form(x, self.weight, lambda a, w: _ConvMixed.apply(
            a.float(), w, None, 1, self.groups, False))
        if self.bias is not None:
            y = y + self.bias.float()[:, None, None]
        return y.to(BF16)


def polyphase_form(x: torch.Tensor, weight: torch.Tensor, conv
                   ) -> torch.Tensor:
    """The JAX package's ``conv_s2_reflect_polyphase`` on NCHW x (even H
    and W): a 3x3 stride-2 reflect conv as four VALID stride-1 convs over
    the parity phases, tap (a, b) multiplying x[2i + a - 1, 2j + b - 1].
    Reflected row -1 is row 1, the odd rows' first, so the odd phases are
    edge-padded by one row or column.  ``conv(inp, w)`` returns a conv's
    output as it is stored; the adds run in that type, in JAX's order."""
    ev, od = x[:, :, 0::2], x[:, :, 1::2]
    od = torch.cat([od[:, :, :1], od], 2)
    xee, xeo = ev[..., 0::2], ev[..., 1::2]
    xoe, xoo = od[..., 0::2], od[..., 1::2]
    xeo = torch.cat([xeo[..., :1], xeo], 3)
    xoo = torch.cat([xoo[..., :1], xoo], 3)
    with full_f32():
        y = conv(xee, weight[:, :, 1:2, 1:2])
        y = y + conv(xoe, weight[:, :, 0::2, 1:2])
        y = y + conv(xeo, weight[:, :, 1:2, 0::2])
        return y + conv(xoo, weight[:, :, 0::2, 0::2])


def border_form(x: torch.Tensor, weight: torch.Tensor, conv) -> torch.Tensor:
    """The JAX package's ``conv_s2_reflect_border`` on NCHW x (even H and
    W): a 3x3 stride-2 reflect conv as the zero-padded conv, then output
    row 0's correction (the taps of kernel row 0 over input row 1, its
    column -1 reflected) added, then output column 0's (the taps of kernel
    column 0 over input column 1, row -1 zero).  ``conv(inp, w, stride=,
    padding=)`` returns a conv's output as it is stored (bf16: its float32
    sums rounded once); each add rounds in that type too."""
    y = conv(x, weight, stride=2, padding=1)
    row = torch.cat([x[:, :, 1:2, 1:2], x[:, :, 1:2]], 3)
    col = F.pad(x[:, :, :, 1:2], (0, 0, 1, 0))
    y[:, :, :1] += conv(row, weight[:, :, :1], stride=(1, 2), padding=0)
    y[:, :, :, :1] += conv(col, weight[:, :, :, :1], stride=(2, 1),
                           padding=0)
    return y


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
                    padding: int, output_padding: int, groups: int = 1,
                    mixed: bool = False) -> torch.Tensor:
    """Any geometry and group count, NCHW view: x zero-dilated by
    ``stride``, padded by (k-1-p, k-1-p+op), then a forward convolution
    with the flipped weight, each group's (in, out) block transposed
    (``_ConvMixed`` with ``mixed``)."""
    cin, cout_g, k, _ = weight.shape
    weight = (weight.view(groups, cin // groups, cout_g, k, k).transpose(1, 2)
              .reshape(groups * cout_g, cin // groups, k, k))
    if stride > 1:
        b, c, h, w = x.shape
        dil = x.new_zeros(b, c, (h - 1) * stride + 1, (w - 1) * stride + 1)
        dil[:, :, ::stride, ::stride] = x
        x = dil
    lo, hi = k - 1 - padding, k - 1 - padding + output_padding
    x = F.pad(x, (lo, hi, lo, hi))
    if mixed:
        return _ConvMixed.apply(x, weight.flip(2, 3), bias, 1, groups, False)
    with full_f32():
        return F.conv2d(x, weight.flip(2, 3), bias, groups=groups)


class ConvTranspose2dTorch(nn.Module):
    """torch ``ConvTranspose2d`` geometry: output size
    ``(in - 1) * s - 2p + k + output_padding``, summed in a fixed order
    (the polyphase form for 3x3 / stride 2 / padding 1 / output padding 1
    without groups, the dilated form for any other).  The weight is
    torch's (in, out / groups, kh, kw)."""

    def __init__(self, channels_in: int, channels_out: int,
                 kernel_size: int = 3, stride: int = 2, padding: int = 1,
                 output_padding: int = 1, bias: bool = True,
                 groups: int = 1):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        _check_groups(channels_in, channels_out, groups)
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(channels_in,
                                               channels_out // groups, k, k))
        self.bias = (nn.Parameter(torch.empty(channels_out)) if bias
                     else None)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        cin, cout_g = self.weight.shape[:2]
        _init_conv(self.weight, self.bias, cin // self.groups,
                   cout_g * self.groups, generator)

    def forward(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        polyphase = (self.weight.shape[-1], self.stride, self.padding,
                     self.output_padding, self.groups) == (3, 2, 1, 1, 1)
        if x.dtype == BF16:
            if switches.native_conv_out() and not (
                    polyphase and switches.polyphase_deconv()):
                # the sums stored as bf16, then the bias added in bf16
                y = self._transposed(x, self.weight.to(BF16), None,
                                     polyphase, False)
                return y if self.bias is None else y + self.bias.to(BF16)
            # float32 sums with the float32 bias, one rounding
            return self._transposed(x.float(), self.weight, self.bias,
                                    polyphase, True).to(BF16)
        precision = layer_precision(compute_dtype)
        mixed = _mixed(x, precision)
        if not mixed and _float32_product(precision) != "float32":
            y = _low_precision(
                lambda a, w: self._transposed(a.permute(0, 2, 3, 1), w, None,
                                              polyphase, False)
                .permute(0, 3, 1, 2),
                x.permute(0, 3, 1, 2), self.weight, precision,
                (self.stride, self.padding, True, self.output_padding,
                 self.groups)).permute(0, 2, 3, 1)
            return y if self.bias is None else y + self.bias.float()
        weight, bias = _conv_operands(x, self.weight, self.bias)
        return self._transposed(x, weight, bias, polyphase, mixed)

    def _transposed(self, x, weight, bias, polyphase, mixed):
        """NHWC in and out; the polyphase form or the dilated one, through
        ``_ConvMixed`` where ``mixed``."""
        if polyphase:
            if mixed:
                return _ConvMixed.apply(x.permute(0, 3, 1, 2), weight, bias,
                                        2, 1, True).permute(0, 2, 3, 1)
            return _Deconv2xPolyphase.apply(x, weight, bias)
        y = _deconv_dilated(x.permute(0, 3, 1, 2), weight, bias, self.stride,
                            self.padding, self.output_padding, self.groups,
                            mixed)
        return y.permute(0, 2, 3, 1)
