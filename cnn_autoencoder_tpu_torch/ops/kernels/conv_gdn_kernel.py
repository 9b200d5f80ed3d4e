"""Fused reflect-pad + 3x3 stride-2 conv + GDN: the CUDA kernel
``csrc/conv_gdn.cu`` (K4) and its plain PyTorch versions.

Replaces ``cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:_kernel`` in
both variants: serving (the output only) and training (the TPU kernel's
``want_y``: the output and the pre-GDN conv output ``y``, the backward's
residual).  Layouts are the JAX package's: NHWC input, HWIO kernel (3, 3,
Cin, Cout), ``gamma``/``beta`` already reparameterized, whole (under the
model mesh axis the fused stage gathers them first: the JAX kernel's
``custom_partitioning`` rule splits rows and replicates the parameters,
so a rank launches the kernel on its rows as one process does).  The
kernel takes
any Cin and Cout and even H and W (it raises otherwise), and computes on
the tensor cores in one of six modes, each a function of the JAX package
(``csrc/conv_gdn.cu`` sets out their arithmetic):

* 0 (``F32``): float32 x, float32-accurate conv and pool: the highest
  precision on either JAX route;
* 1 (``PALLAS_BF16``): bf16 x, bf16 multiplicands with float32 sums, the
  float32 y and pool: the JAX Pallas kernel in the bf16 mode
  (``CAE_TPU_PALLAS=1``);
* 2 and 3 (``ROUND_BF16``, ``BORDER_BF16``): bf16 x, the JAX default
  route in the bf16 mode (``Conv2dReflect`` then ``GDN``, its Pallas
  kernels being opt-in): the conv's sums stored as bf16 (3: with the border
  form's roundings, ``ops/convops.py:border_form``), the pool over
  bf16(y^2) and bf16(gamma) with float32 sums, out = bf16(y r); training
  saves y and r as bf16, as K2 does;
* 4 (``F32_BF16X1``): float32 x and w rounded to bf16, float32 sums, the
  float32 y and pool: the default precision, and the bf16 mode's float32
  rows (``CAE_TPU_BF16_ACTIVATIONS=0``); the JAX XLA route
  ``_conv_gdn_xla``;
* 5 (``F32_BF16X3``): the high precision's bf16_3x conv, the float32 y and
  pool.

``conv_gdn_mode`` picks the mode from the rows' type, the compute mode and
the switches, read at call time as the JAX package reads them.  Under
``CAE_TPU_GDN_FAST=0`` the bf16 mode's default route has a float32 pool on
bf16 y, and under ``CAE_TPU_POLYPHASE_CONV=1`` the polyphase conv's
roundings, which no mode computes: ``conv_gdn_mode`` returns None and the
stage runs unfused (``Conv2dReflect``, then K1, or K2 and K3, on bf16
rows).  ``conv_gdn_cuda`` serves in every mode and counts its
launches under the mode's kernel name (``SERVING_NAMES``: modes 2 and 3
share ``conv_gdn_fwd_bf16``); ``conv_gdn_train_cuda``, the training
variant, takes every mode but 1 and counts them likewise
(``TRAIN_NAMES``).

``fused_conv_gdn`` is the differentiable entry (the JAX ``fused_conv_gdn``
custom VJP).  In modes 0, 4 and 5 its backward is JAX's ``_fused_bwd``
(mode 0) or the default route's float32 GDN and conv (modes 4 and 5): the
norm recomputed from y in full float32, ``dnorm``, ``dy``, ``dgamma`` and
``dbeta`` as torch ops, then the reflect-pad conv's own gradients at the
float32 precision in force ("highest", "default" or "high").  In
modes 2 and 3 it is the default route's: ``gdn_mixed``'s
(``gdn_mixed_bwd``: K3, ``dgamma`` over its bf16 ``dnb`` and ``dbeta``
over the float32 ``dnorm``), then ``conv_mixed``'s.
bf16 training under ``CAE_TPU_PALLAS=1`` raises, as the JAX package's
``jax.grad`` of its Pallas stage does (ROADMAP.md §3).
"""

from typing import Optional

import torch
import torch.nn.functional as F

from ...utils.device import full_f32
from .. import switches
from ..convops import (_conv_grads, _float32_product, border_form,
                       layer_precision, reflect_pad)
from .build import check_launch, load_library, stream_handle
from .gdn_kernel import _norm, gdn_mixed_bwd, gdn_plain

F32, PALLAS_BF16, ROUND_BF16, BORDER_BF16, F32_BF16X1, F32_BF16X3 = range(6)
BF16_X = (PALLAS_BF16, ROUND_BF16, BORDER_BF16)
ROUNDED = (ROUND_BF16, BORDER_BF16)
BF16 = torch.bfloat16


def conv_gdn_mode(dtype: torch.dtype, compute_dtype=None) -> Optional[int]:
    """The mode the down stage takes now for rows of ``dtype`` in the
    compute mode ``compute_dtype`` (``convops.layer_precision``), or None
    where it runs unfused (the bf16 mode's default route under
    ``CAE_TPU_GDN_FAST=0`` or ``CAE_TPU_POLYPHASE_CONV=1``)."""
    pallas = switches.pallas_fused_conv()
    precision = layer_precision(compute_dtype)
    if dtype == BF16:
        if pallas:
            return PALLAS_BF16
        if switches.polyphase_conv() or not switches.gdn_fast():
            return None
        if switches.border_conv() and switches.native_conv_out():
            return BORDER_BF16
        return ROUND_BF16
    if precision == "bf16":
        return F32_BF16X1
    if pallas:
        return F32
    return {"default": F32_BF16X1, "high": F32_BF16X3}.get(precision, F32)


def _conv_sums(x: torch.Tensor, kernel: torch.Tensor, mode: int
               ) -> torch.Tensor:
    """The conv at the mode's arithmetic with float32 sums, NCHW float32
    (bf16 values are exact in float32, so float32 convs with TF32 off
    multiply them exactly)."""
    w = kernel.permute(3, 2, 0, 1).float()
    xp = reflect_pad(x.permute(0, 3, 1, 2).float(), 1)

    def conv(a, b):
        with full_f32():
            return F.conv2d(a, b, stride=2)

    if mode == F32:
        return conv(xp, w)
    if mode == F32_BF16X3:
        parts = []
        for t in (xp, w):
            hi = t.to(BF16).float()
            parts.append((hi, (t - hi).to(BF16).float()))
        (xh, xl), (wh, wl) = parts
        return conv(xl, wh) + conv(xh, wl) + conv(xh, wh)
    return conv(xp.to(BF16).float(), w.to(BF16).float())


def _rounded_y(x: torch.Tensor, kernel: torch.Tensor, mode: int
               ) -> torch.Tensor:
    """Modes 2 and 3's y, NHWC bf16: the conv's float32 sums rounded once,
    or the border form's roundings."""
    if mode == ROUND_BF16:
        return _conv_sums(x, kernel, mode).to(BF16).permute(0, 2, 3, 1)

    def conv(inp, w, stride, padding):
        with full_f32():
            return F.conv2d(inp.float(), w.float(), stride=stride,
                            padding=padding).to(BF16)

    w = kernel.permute(3, 2, 0, 1).float().to(BF16)
    return border_form(x.permute(0, 3, 1, 2), w, conv).permute(0, 2, 3, 1)


def rounded_gdn_plain(yb: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor):
    """Modes 2 and 3's GDN of their bf16 y (..., C): (out, r), both bf16,
    the pool over bf16(y^2) and bf16(gamma) with float32 sums, out =
    bf16(y r) from the float32 r."""
    y32 = yb.float().reshape(-1, yb.shape[-1])
    r = torch.rsqrt(_norm(y32, gamma, beta, BF16))
    return ((y32 * r).to(BF16).reshape(yb.shape),
            r.to(BF16).reshape(yb.shape))


def conv_gdn_train_plain(x: torch.Tensor, kernel: torch.Tensor,
                         gamma: torch.Tensor, beta: torch.Tensor,
                         mode: Optional[int] = None):
    """The training variant's function: (out in x's dtype, y, r).  y is
    the float32 pre-GDN conv output and r None, but in modes 2 and 3 y and
    r = norm^(-1/2) are bf16.  ``mode`` None: ``conv_gdn_mode(x.dtype)``."""
    mode = conv_gdn_mode(x.dtype) if mode is None else mode
    cout = kernel.shape[3]
    if mode in ROUNDED:
        yb = _rounded_y(x, kernel, mode).contiguous()
        out, r = rounded_gdn_plain(yb, gamma, beta)
        return out, yb, r
    y = _conv_sums(x, kernel, mode).permute(0, 2, 3, 1).contiguous()
    out = gdn_plain(y.reshape(-1, cout), gamma, beta).reshape(y.shape)
    return out.to(x.dtype), y, None


def conv_gdn_plain(x: torch.Tensor, kernel: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, mode: Optional[int] = None
                   ) -> torch.Tensor:
    """The serving variant's function: the output alone."""
    return conv_gdn_train_plain(x, kernel, gamma, beta, mode)[0]


def _launch(x, kernel, gamma, beta, mode, want_y):
    if (x.dtype not in (torch.float32, BF16) or x.dim() != 4
            or not x.is_contiguous()):
        raise ValueError("conv_gdn kernel takes a contiguous float32 or bf16 "
                         f"NHWC tensor, got {tuple(x.shape)} {x.dtype}")
    if (x.dtype == BF16) != (mode in BF16_X):
        raise ValueError(f"conv_gdn kernel: mode {mode} does not take "
                         f"{x.dtype} x")
    b, h, w, cin = x.shape
    if h % 2 or w % 2 or h < 2 or w < 2:
        raise ValueError(f"conv_gdn kernel takes even H, W >= 2, got {h}x{w}")
    if kernel.shape[:3] != (3, 3, cin):
        raise ValueError(f"conv_gdn kernel takes a (3, 3, {cin}, Cout) "
                         f"kernel, got {tuple(kernel.shape)}")
    cout = kernel.shape[3]
    if gamma.shape != (cout, cout) or beta.shape != (cout,):
        raise ValueError("conv_gdn kernel: gamma/beta do not match Cout")
    if x.device.type != "cuda":
        raise ValueError(f"conv_gdn kernel takes CUDA tensors, got "
                         f"{x.device}")
    for name, t in (("kernel", kernel), ("gamma", gamma), ("beta", beta)):
        if t.device != x.device:
            raise ValueError(f"conv_gdn kernel: {name} is on {t.device}, "
                             f"x on {x.device}")
    kernel = kernel.detach().float().contiguous()
    gamma = gamma.detach().float().contiguous()
    beta = beta.detach().float().contiguous()
    shape = (b, h // 2, w // 2, cout)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    y = r = None
    if want_y:
        rounded = mode in ROUNDED
        y = torch.empty(shape, dtype=BF16 if rounded else torch.float32,
                        device=x.device)
        r = torch.empty(shape, dtype=BF16, device=x.device) if rounded \
            else None
    lib = load_library()
    work = torch.empty(
        lib.cae_conv_gdn_workspace(b, h, w, cin, cout, mode, int(want_y)),
        dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.cae_conv_gdn_fwd(
            x.data_ptr(), kernel.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), out.data_ptr(),
            None if y is None else y.data_ptr(),
            None if r is None else r.data_ptr(), work.data_ptr(), b, h, w,
            cin, cout, mode, stream_handle(x))
    return err, out, y, r


# the serving variant's kernel name in each mode, under which its launches
# count
SERVING_NAMES = {F32: "conv_gdn_fwd", PALLAS_BF16: "conv_gdn_fwd_pallas_bf16",
                 ROUND_BF16: "conv_gdn_fwd_bf16",
                 BORDER_BF16: "conv_gdn_fwd_bf16",
                 F32_BF16X1: "conv_gdn_fwd_bf16x1",
                 F32_BF16X3: "conv_gdn_fwd_bf16x3"}


class _Launches:
    """The launches of one of the serving variant's kernel names."""

    def __init__(self, kernel_name: str):
        self.kernel_name = kernel_name
        self.launches = 0


SERVING = {name: _Launches(name) for name in SERVING_NAMES.values()}
# the training variant's, in the modes that train
TRAIN_NAMES = {F32: "conv_gdn_train_fwd", ROUND_BF16: "conv_gdn_train_fwd_bf16",
               BORDER_BF16: "conv_gdn_train_fwd_bf16",
               F32_BF16X1: "conv_gdn_train_fwd_bf16x1",
               F32_BF16X3: "conv_gdn_train_fwd_bf16x3"}
TRAIN = {name: _Launches(name) for name in TRAIN_NAMES.values()}


def conv_gdn_cuda(x: torch.Tensor, kernel: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, mode: Optional[int] = None
                  ) -> torch.Tensor:
    """K4, serving variant, in ``mode`` (None: the mode now for x's type),
    counted under ``SERVING_NAMES[mode]``; raises on what it does not
    take."""
    mode = conv_gdn_mode(x.dtype) if mode is None else mode
    if mode not in SERVING_NAMES:
        raise ValueError(f"conv_gdn_cuda takes modes {sorted(SERVING_NAMES)},"
                         f" got {mode}")
    err, out, _, _ = _launch(x, kernel, gamma, beta, mode, want_y=False)
    counter = SERVING[SERVING_NAMES[mode]]
    check_launch(err, counter.kernel_name)
    counter.launches += 1
    return out


def conv_gdn_train_cuda(x: torch.Tensor, kernel: torch.Tensor,
                        gamma: torch.Tensor, beta: torch.Tensor,
                        mode: Optional[int] = None):
    """K4, training (want_y) variant in modes 0, 2, 3, 4 and 5 (None: the
    mode now), counted under ``TRAIN_NAMES[mode]``: (out, y, r) as
    ``conv_gdn_train_plain`` returns them; raises on what it does not
    take."""
    mode = conv_gdn_mode(x.dtype) if mode is None else mode
    if mode not in TRAIN_NAMES:
        raise ValueError(f"conv_gdn_train_cuda: mode {mode} has no training "
                         "variant")
    err, out, y, r = _launch(x, kernel, gamma, beta, mode, want_y=True)
    counter = TRAIN[TRAIN_NAMES[mode]]
    check_launch(err, counter.kernel_name)
    counter.launches += 1
    return out, y, r


def conv_gdn(x, kernel, gamma, beta, mode: Optional[int] = None):
    """The serving variant: the plain version for CPU tensors, the mode's
    kernel for CUDA tensors."""
    mode = conv_gdn_mode(x.dtype) if mode is None else mode
    if x.device.type == "cpu":
        return conv_gdn_plain(x, kernel, gamma, beta, mode)
    return conv_gdn_cuda(x, kernel, gamma, beta, mode)


def conv_gdn_train(x, kernel, gamma, beta, mode: Optional[int] = None):
    """The training variant: the plain version for CPU tensors, the kernel
    for CUDA tensors."""
    if x.device.type == "cpu":
        return conv_gdn_train_plain(x, kernel, gamma, beta, mode)
    return conv_gdn_train_cuda(x, kernel, gamma, beta, mode)


def _reflect_conv_grads(x, kernel, dy, need_x, need_kernel, product):
    """(dx, dkernel) of the reflect-pad 3x3/s2 conv at the cotangent dy
    (NHWC), each transposed product at ``product`` (``convops.
    _conv_grads``): "bf16" for bf16 x (``conv_mixed``'s rule: the cotangent
    rounded to bf16, the kernel's gradient widened to float32), else the
    float32 precision's.  The pad's own backward folds the reflected border
    into dx, in a fixed order (``convops.reflect_pad``)."""
    w = kernel.detach().permute(3, 2, 0, 1)
    with torch.enable_grad():
        xd = x.detach().requires_grad_(need_x)
        xp = reflect_pad(xd.permute(0, 3, 1, 2), 1)
    dxp, dw = _conv_grads(dy.permute(0, 3, 1, 2), xp.detach(), w,
                          (2, 0, False, 0, 1), (need_x, need_kernel),
                          product)
    dx = dkernel = None
    if need_x:
        (dx,) = torch.autograd.grad(xp, xd, dxp.to(x.dtype))
    if need_kernel:
        dkernel = dw.float().permute(2, 3, 1, 0)
    return dx, dkernel


class _FusedConvGDN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, kernel, gamma, beta, mode, product):
        out, y, r = conv_gdn_train(x, kernel, gamma, beta, mode)
        ctx.save_for_backward(x, kernel, gamma, beta, y, r)
        ctx.product = product
        return out

    @staticmethod
    def backward(ctx, g):
        x, kernel, gamma, beta, y, r = ctx.saved_tensors
        need_x, need_k, need_g, need_b = ctx.needs_input_grad[:4]
        c = y.shape[-1]
        if r is not None:  # the default route: gdn_mixed's, conv_mixed's
            dy, dgamma, dbeta = gdn_mixed_bwd(
                g.contiguous().view(-1, c), y.view(-1, c), r.view(-1, c),
                gamma, False, need_g, need_b)
            dx, dkernel = _reflect_conv_grads(x, kernel, dy.view(y.shape),
                                              need_x, need_k, "bf16")
            return dx, dkernel, dgamma, dbeta, None, None
        with full_f32():
            y2 = y * y
            norm = torch.matmul(y2, gamma.t()) + beta
            r = torch.rsqrt(norm)
            g = g.float()
            dnorm = (-0.5 * g * y) * (r * r * r)
            dy = g * r + 2.0 * y * torch.matmul(dnorm, gamma)
            dgamma = (torch.matmul(dnorm.reshape(-1, c).t(), y2.reshape(-1, c))
                      if need_g else None)
            dbeta = dnorm.sum((0, 1, 2)) if need_b else None
        dx, dkernel = _reflect_conv_grads(x, kernel, dy, need_x, need_k,
                                          ctx.product)
        return dx, dkernel, dgamma, dbeta, None, None


def fused_conv_gdn(x: torch.Tensor, kernel: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, mode: Optional[int] = None,
                   compute_dtype=None) -> torch.Tensor:
    """reflect-pad -> 3x3/s2 conv -> GDN in ``mode`` (None: the mode now
    for x's type in the compute mode ``compute_dtype``).  When a gradient
    is wanted, the training variant with its backward, whose conv
    transposes run at the precision of ``compute_dtype``
    (``convops.layer_precision``), not at the forward's mode: under
    ``CAE_TPU_PALLAS=1`` at "default" or "high" the JAX package's forward
    is its HIGHEST kernel (mode 0) and its ``_fused_bwd`` transposes
    ``_reflect_conv`` at DEFAULT or HIGH.  Otherwise the serving variant.
    CPU tensors take the plain versions, CUDA tensors the kernel."""
    mode = conv_gdn_mode(x.dtype, compute_dtype) if mode is None else mode
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, kernel, gamma, beta)):
        if mode == PALLAS_BF16:
            raise ValueError(
                "bf16 training under CAE_TPU_PALLAS=1: the JAX package's "
                "jax.grad of its fused conv + GDN stage raises a TypeError "
                "there (ROADMAP.md §3, found in the reference)")
        precision = layer_precision(compute_dtype)
        if mode in ROUNDED:
            product = "bf16"
        elif precision == "bf16":
            raise ValueError(
                "the fused stage does not train float32 rows in the bf16 "
                "mode (the JAX package's GDN there is gdn_mixed); no unit "
                "sends them to it, a batch norm's output never meets it")
        else:
            product = _float32_product(precision)
        return _FusedConvGDN.apply(x, kernel, gamma, beta, mode, product)
    return conv_gdn(x, kernel, gamma, beta, mode)
