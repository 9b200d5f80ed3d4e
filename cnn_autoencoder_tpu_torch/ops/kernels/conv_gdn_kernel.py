"""Fused reflect-pad + 3x3 stride-2 conv + GDN: the CUDA kernel
``csrc/conv_gdn.cu`` (K4) and its plain PyTorch versions.

Replaces ``cnn_autoencoder_tpu/ops/pallas/conv_gdn_kernel.py:_kernel`` in
both variants: serving (``conv_gdn_cuda``, the output only) and training
(``conv_gdn_train_cuda``, the TPU kernel's ``want_y``: the output and the
float32 pre-GDN conv output ``y``, the backward's residual).  Layouts are
the JAX package's: NHWC input, HWIO kernel (3, 3, Cin, Cout),
``gamma``/``beta`` already reparameterized.  The compute type follows x:
float32 x multiplies in float32, bf16 x multiplies bf16 values (the
kernel's weights rounded to bf16); the sums, ``y`` and the GDN epilogue are
float32 either way, and the output is stored in x's type.  The kernel
computes on the tensor cores (three TF32 passes for a float32 product, one
for a bf16 one) and takes any Cin and Cout; it takes even H and W and
raises otherwise.  Each launch gets a scratch buffer of the size the
kernel asks for (the weights split in TF32 parts, and where Cout > 128
and ``y`` is not wanted, a row store for ``y`` between the conv and the
pool).

``fused_conv_gdn`` is the differentiable entry (the JAX ``fused_conv_gdn``
custom VJP): when a gradient is wanted it runs the training variant and
its backward is ``_fused_bwd`` there: the norm recomputed from ``y`` in
full float32, ``dnorm``, ``dy``, ``dgamma`` and ``dbeta`` as torch ops, and
``dx``/``dkernel`` from the reflect-pad conv's own gradients (outside any
kernel in the JAX package too).
"""

from typing import Tuple

import torch
import torch.nn.functional as F

from ...utils.device import full_f32
from .build import check_launch, load_library, stream_handle
from .gdn_kernel import gdn_plain


def _reflect_conv_plain(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Reflect pad 1, 3x3/s2 VALID conv in x's compute type with float32
    sums; returns float32 NHWC.  bf16 operands are widened exactly, so the
    float32 conv with TF32 off multiplies the bf16 values."""
    xp = F.pad(x.permute(0, 3, 1, 2).float(), (1, 1, 1, 1), mode="reflect")
    w = kernel.permute(3, 2, 0, 1).float().to(x.dtype).float()
    with full_f32():
        y = F.conv2d(xp, w, stride=2)
    return y.permute(0, 2, 3, 1)


def conv_gdn_train_plain(x: torch.Tensor, kernel: torch.Tensor,
                         gamma: torch.Tensor, beta: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out in x's dtype, float32 pre-GDN y): the training variant's
    function."""
    y = _reflect_conv_plain(x, kernel)
    cout = y.shape[-1]
    out = gdn_plain(y.reshape(-1, cout), gamma, beta).reshape(y.shape)
    return out.to(x.dtype), y


def conv_gdn_plain(x: torch.Tensor, kernel: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor) -> torch.Tensor:
    """The serving variant's function: the output alone."""
    return conv_gdn_train_plain(x, kernel, gamma, beta)[0]


def _launch(x, kernel, gamma, beta, want_y):
    if (x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4
            or not x.is_contiguous()):
        raise ValueError("conv_gdn kernel takes a contiguous float32 or bf16 "
                         f"NHWC tensor, got {tuple(x.shape)} {x.dtype}")
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
    bf16 = int(x.dtype == torch.bfloat16)
    shape = (b, h // 2, w // 2, cout)
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    y = (torch.empty(shape, dtype=torch.float32, device=x.device) if want_y
         else None)
    lib = load_library()
    npix = b * (h // 2) * (w // 2)
    work = torch.empty(
        lib.cae_conv_gdn_workspace(npix, cin, cout, bf16, int(want_y)),
        dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.cae_conv_gdn_fwd(
            x.data_ptr(), kernel.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), out.data_ptr(),
            None if y is None else y.data_ptr(), work.data_ptr(), b, h, w,
            cin, cout, bf16, stream_handle(x))
    return err, out, y


def conv_gdn_cuda(x: torch.Tensor, kernel: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor) -> torch.Tensor:
    """K4, serving variant; raises on what it does not take."""
    err, out, _ = _launch(x, kernel, gamma, beta, want_y=False)
    check_launch(err, "conv_gdn_fwd")
    conv_gdn_cuda.launches += 1
    return out


conv_gdn_cuda.launches = 0
conv_gdn_cuda.kernel_name = "conv_gdn_fwd"


def conv_gdn_train_cuda(x: torch.Tensor, kernel: torch.Tensor,
                        gamma: torch.Tensor, beta: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4, training (want_y) variant: (out, float32 y); raises on what it
    does not take."""
    err, out, y = _launch(x, kernel, gamma, beta, want_y=True)
    check_launch(err, "conv_gdn_train_fwd")
    conv_gdn_train_cuda.launches += 1
    return out, y


conv_gdn_train_cuda.launches = 0
conv_gdn_train_cuda.kernel_name = "conv_gdn_train_fwd"


def conv_gdn_train(x, kernel, gamma, beta):
    """The training variant: the plain version for CPU tensors, the kernel
    for CUDA tensors."""
    if x.device.type == "cpu":
        return conv_gdn_train_plain(x, kernel, gamma, beta)
    return conv_gdn_train_cuda(x, kernel, gamma, beta)


def _reflect_conv_grads(x, kernel, dy, need_x, need_kernel):
    """(dx, dkernel) of the reflect-pad 3x3/s2 conv at the cotangent dy
    (float32 NHWC), in x's compute type: for bf16 x the cotangent is
    rounded to bf16 and the kernel's gradient widened to float32 (the
    mixed-precision rule of the JAX package's ``conv_mixed``).  The pad's
    own backward folds the reflected border into dx."""
    cd = x.dtype
    w = kernel.detach().permute(3, 2, 0, 1).to(cd)
    d = dy.permute(0, 3, 1, 2).to(cd)
    with torch.enable_grad():
        xd = x.detach().requires_grad_(need_x)
        xp = F.pad(xd.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    dx = dkernel = None
    if need_x:
        dxp = torch.nn.grad.conv2d_input(xp.shape, w, d, stride=2)
        (dx,) = torch.autograd.grad(xp, xd, dxp)
    if need_kernel:
        dw = torch.nn.grad.conv2d_weight(xp.detach(), w.shape, d, stride=2)
        dkernel = dw.float().permute(2, 3, 1, 0)
    return dx, dkernel


class _FusedConvGDN(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, kernel, gamma, beta):
        out, y = conv_gdn_train(x, kernel, gamma, beta)
        ctx.save_for_backward(x, kernel, gamma, beta, y)
        return out

    @staticmethod
    def backward(ctx, g):
        x, kernel, gamma, beta, y = ctx.saved_tensors
        need_x, need_k, need_g, need_b = ctx.needs_input_grad
        c = y.shape[-1]
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
            dx, dkernel = _reflect_conv_grads(x, kernel, dy, need_x, need_k)
        return dx, dkernel, dgamma, dbeta


def fused_conv_gdn(x: torch.Tensor, kernel: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor) -> torch.Tensor:
    """reflect-pad -> 3x3/s2 conv -> GDN.  When a gradient is wanted, the
    training variant with its analytic backward; otherwise the serving
    variant.  CPU tensors take the plain versions, CUDA tensors the
    kernel."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, kernel, gamma, beta)):
        return _FusedConvGDN.apply(x, kernel, gamma, beta)
    if x.device.type == "cpu":
        return conv_gdn_plain(x, kernel, gamma, beta)
    return conv_gdn_cuda(x, kernel, gamma, beta)
